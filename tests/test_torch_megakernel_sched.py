"""The megakernels K3 and K4's launch design, on the CPU: a model of their
warp-aggregated slot queue, the invariant it relies on (a slot's sums do
not depend on the lane, the order or the company it runs in), and the
wrapper's grid and queue.  The kernels themselves are held against their
plain twins on the card (test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

from rustraytrace_tpu_torch import models  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402
from rustraytrace_tpu_torch.ops.rng import seed_key  # noqa: E402

WARP = 32


class _Warp:
    """One warp of the model: each lane's slot (-1 before one is taken,
    >= R once the queue is dry for it) and the steps its slot has left."""

    def __init__(self):
        self.slot = [-1] * WARP
        self.left = [0] * WARP


def _refill(w, R, work, queue, taken, written, per_warp):
    """The refill loop of csrc/megakernel.cu's per-lane instance (K3), or
    with ``per_warp`` that of its cooperative instance and of
    csrc/mono.cu (K4): write every finished slot, then take new ones with
    one add to the queue per round, until every lane has work or is
    dry."""
    while True:
        for k in range(WARP):
            s = w.slot[k]
            if 0 <= s < R and w.left[k] == 0:
                written.append(s)
                w.slot[k] = -1
        need = [s < 0 for s in w.slot]
        if per_warp:
            if not all(need):
                return
            n = WARP
        else:
            if not any(need):
                return
            n = sum(need)
        base = queue[0]
        queue[0] += n  # the leader's atomicAdd
        rank = 0
        for k in range(WARP):
            if need[k]:
                s = base + (k if per_warp else rank)
                rank += 1
                w.slot[k] = s
                if s < R:
                    taken[s] += 1
                    w.left[k] = int(work[s])


def _run_queue(R, work, n_warps, per_warp, rng):
    """Warps of the persistent grid, advanced one iteration at a time in a
    random interleaving (the device serialises their atomics in some
    order): each refills, then the lanes that hold a slot with work take a
    step; a warp leaves when none of its lanes acts.  Returns (times each
    slot was taken, slots in the order they were written, the final
    queue count)."""
    queue = [0]
    taken = np.zeros(R, dtype=np.int64)
    written = []
    warps = [_Warp() for _ in range(n_warps)]
    running = list(range(n_warps))
    while running:
        i = running[int(rng.integers(len(running)))]
        w = warps[i]
        _refill(w, R, work, queue, taken, written, per_warp)
        act = [0 <= s < R for s in w.slot]
        if not any(act):
            running.remove(i)
            continue
        for k in range(WARP):
            if act[k]:
                w.left[k] -= 1
    return taken, written, queue[0]


@pytest.mark.parametrize("per_warp", [False, True])
@pytest.mark.parametrize("R,n_warps", [(1, 4), (5, 1), (31, 2), (32, 4),
                                       (33, 1), (100, 3), (1000, 8),
                                       (4097, 16)])
def test_slot_queue_takes_every_slot_once(R, n_warps, per_warp):
    """Random per-slot work (zero steps too, as with spp = 0): every slot
    is taken exactly once and its sums written exactly once, under both
    refill granularities, for R below, at and off multiples of 32."""
    rng = np.random.default_rng(R * 7 + n_warps + per_warp)
    work = rng.integers(0, 40, R)
    work[rng.uniform(size=R) < 0.1] = 0
    taken, written, count = _run_queue(R, work, n_warps, per_warp, rng)
    assert np.all(taken == 1)
    assert sorted(written) == list(range(R))
    assert count >= R


def test_warp_refill_takes_consecutive_slots():
    """With the warp refill (K4, and K3's cooperative instance) a warp's
    lanes hold 32 consecutive slots, lane k slot base + k, so they finish
    their last samples together and keep the screen order of primary
    rays."""
    R = 200
    queue, taken, written = [0], np.zeros(R, dtype=np.int64), []
    w = _Warp()
    for _ in range(3):
        _refill(w, R, np.ones(R, dtype=np.int64), queue, taken, written,
                True)
        base = w.slot[0]
        assert base % WARP == 0
        assert w.slot == [base + k for k in range(WARP)]
        w.left = [0] * WARP
    assert queue[0] == 3 * WARP and len(written) == 2 * WARP


def _tables(name, width=16, spp=4):
    scene, cfg, integ = models.get_scene(
        name, dict(image_width=width, samples_per_pixel=spp))
    n = int(np.sqrt(spp)) if cfg.stratified else 0
    return mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=width,
        height=cfg.image_height, mis=integ == "mis",
        stratified=cfg.stratified, sqrt_spp=n, device="cpu")


def _chunks(n, rng):
    """A random permutation of range(n) cut into random runs: the slots
    that lanes of different warps take, in the order they take them."""
    perm = torch.from_numpy(rng.permutation(n))
    cuts = np.sort(rng.choice(np.arange(1, n), size=4, replace=False))
    return torch.tensor_split(perm, torch.from_numpy(cuts))


def _respawn_over(tables, slots, seed, off, spp, depth):
    """respawn_pass_plain's loop over the slots ``slots`` only, in that
    order: the sums [len(slots), 3]."""
    state = torch.zeros((wf.N_STATE, slots.numel()), dtype=torch.float32)
    wf.persist_step_plain(state, slots.to(torch.int32), tables, seed,
                          persist_iters=spp * (depth + 1) + 1, spp=spp,
                          max_depth=depth, sample_offset=off)
    return state[wf.R_SX:wf.R_SX + 3].T


def _mono_over(tables, slots, seed, off, spp, depth):
    """mono_pass_plain's loop over the slots ``slots`` only, in that
    order: the sums [len(slots), 3]."""
    key = seed_key(seed)
    slots = slots.to(torch.int64)
    sums = torch.zeros((3, slots.numel()), dtype=torch.float32)
    for k in range(spp):
        sample = torch.full_like(slots, k + off)
        v = wf.spawn_lanes(tables, slots, sample, key)
        zero = torch.zeros_like(v["b"])
        v.update(rx=zero, ry=zero, rz=zero)
        while wf.bounce_live(tables, v, slots, sample, key, depth):
            pass
        sums = sums + torch.stack([v["rx"], v["ry"], v["rz"]])
    return sums.T


@pytest.mark.parametrize("name", ["book1_three_spheres", "book2_cornell_smoke",
                                  "book3_cornell_box"])
@pytest.mark.parametrize("kernel", ["respawn", "mono"])
def test_slot_sums_do_not_depend_on_order_or_company(name, kernel):
    """The invariant the queue relies on: the twins' loops run over the
    slots in a permuted order, cut into runs as lanes of different warps
    would take them, give every slot's sums bitwise equal to the twin in
    slot order."""
    tables = _tables(name)
    seed, off, spp, depth = 13, 3, 4, 8
    if kernel == "respawn":
        want, over = mk.respawn_pass_plain(tables, seed, off, spp,
                                           depth), _respawn_over
    else:
        want, over = mk.mono_pass_plain(tables, seed, off, spp,
                                        depth), _mono_over
    got = torch.zeros_like(want)
    rng = np.random.default_rng(len(name))
    for run in _chunks(tables.n_lanes, rng):
        got[run] = over(tables, run, seed, off, spp, depth)
    assert float(want.abs().sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("R", [1, 31, 33, 127, 128, 129, 4097, 8355840])
def test_grid_is_one_wave_and_never_more_than_the_slots_need(R):
    """megakernel_grid: at most one resident wave, never more blocks than
    the slots need at one a thread, at least one, and ``max_blocks`` caps
    it."""
    for block in (128, 256):
        for resident in (1, 4 * 132, 6 * 132):
            g = mk.megakernel_grid(R, block, resident)
            assert 1 <= g <= resident
            assert g <= -(-R // block)
            assert (g - 1) * block < R  # every block gets a slot
            assert mk.megakernel_grid(R, block, resident, max_blocks=1) == 1
            assert mk.megakernel_grid(R, block, resident,
                                      max_blocks=3) == min(g, 3)
    assert mk.megakernel_grid(0, 128, 528) == 0
    with pytest.raises(ValueError):
        mk.megakernel_grid(R, 128, 528, max_blocks=0)


def test_slot_queue_starts_at_zero_for_every_launch():
    """Each launch gets its own int32 counter, zero on the device, so no
    stale count carries over from a launch before it."""
    q1 = mk.slot_queue("cpu")
    assert q1.dtype == torch.int32 and q1.shape == (1,) and int(q1) == 0
    q1 += 1234  # what a launch leaves behind
    q2 = mk.slot_queue("cpu")
    assert int(q2) == 0 and q2.data_ptr() != q1.data_ptr()


def test_warp_times_need_the_counting_instance():
    """The warp record is kept by the counting instances only, so the
    wrapper refuses it without ``work``; tail_share reads it."""
    tables = _tables("book1_three_spheres")
    wt = mk.warp_times_buffer(tables.n_lanes, "cpu")
    assert wt.shape == (-(-tables.n_lanes // 256) * 8, 2)
    assert bool((wt[:, 0] == -1).all()) and bool((wt[:, 1] == 0).all())
    with pytest.raises(ValueError):
        mk.path_params(tables, 1, spp=1, max_depth=2, warp_times=wt)
    # a persistent grid: every warp starts at once, the first runs dry at
    # 300, the last at 500
    wt[0] = torch.tensor([100, 400])
    wt[1] = torch.tensor([102, 300])
    wt[2] = torch.tensor([101, 500])
    t = mk.tail_share(wt)
    assert t["warps"] == 3 and t["span_ns"] == 400
    assert t["first_finish_share"] == 0.5 and t["tail_share"] == 0.5
    # a grid of short blocks: warps finish early, but the card stays full
    # until the last one starts at 420
    wt[3] = torch.tensor([420, 480])
    t = mk.tail_share(wt)
    assert t["last_start_share"] == 0.8 and t["tail_share"] == 0.2


def test_cooperative_instance_follows_the_cluster_cull():
    """The megakernels take their cooperative instance (K3: 32 slots a
    warp) where a sphere or box cluster cull runs, the per-lane one (K3: a
    slot a lane) elsewhere."""
    flagship = _tables("book1_random_spheres", width=32)
    box = _tables("book3_cornell_box")
    final = _tables("book2_final_scene")
    assert flagship.n_clusters > 0 and mk.cluster_cull(flagship)
    assert box.n_clusters == 0 and not mk.cluster_cull(box)
    assert final.n_bclusters > 1 and mk.cluster_cull(final)

"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs an NVIDIA GPU: every test is marked ``cuda`` and skips without one.
Imports nothing of JAX, so it also runs where only the port is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

from rustraytrace_tpu_torch import RenderConfig, SceneBuilder, models  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import _cuda, hit  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402
from torch_scenes import (FIELD_INSIDE_CFG, SMOKE_CFG, quad_field,  # noqa: E402
                          smoke_mis_scene)

WORK_INDEX = {n: k for k, n in enumerate(mk.WORK_NAMES)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)) + np.asarray([13.0, 2.0, 3.0])
    d = rng.uniform(-4, 4, (n, 3)) - o
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(rng.uniform(size=n).astype(np.float32)))


@pytest.mark.cuda
def test_sphere_hit_kernel_matches_plain(cuda):
    scene, _, _ = models.book1_random_spheres(dict(image_width=64))
    sph = hit.pack_sphere_table(scene).to(cuda)
    quad = torch.zeros((0, hit.Q_COLS), device=cuda)
    o, d, t = (x.to(cuda) for x in _rays(16384, seed=3))
    before = _cuda.launch_counts()["sphere_hit"]
    tk, ik = hit.sphere_hit(o, d, t, sph, quad, False)
    assert _cuda.launch_counts()["sphere_hit"] == before + 1
    tp, ip = hit.sphere_hit_plain(o, d, t, sph, quad, False)
    # built without contracted multiply-adds, kernel and plain round alike
    assert int((ik >= 0).sum()) > 8000
    assert torch.equal(ik, ip)
    assert torch.equal(tk, tp)


@pytest.mark.cuda
def test_persist_launch_matches_plain_step(cuda):
    scene, cfg, _ = models.book1_random_spheres(dict(image_width=160))
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=160,
                                   height=cfg.image_height, device=cuda)
    st_k = torch.zeros((wf.N_STATE, tables.n_lanes), device=cuda)
    st_p = st_k.clone()
    slot = torch.arange(tables.n_lanes, dtype=torch.int32, device=cuda)
    kw = dict(persist_iters=8, spp=4, max_depth=50)
    before = _cuda.launch_counts()["persist"]
    wf.persist_step(st_k, slot, tables, 11, **kw)
    assert _cuda.launch_counts()["persist"] == before + 1
    wf.persist_step_plain(st_p, slot, tables, 11, **kw)
    assert torch.equal(st_k, st_p)


@pytest.mark.cuda
def test_kernel_render_bitwise_invariant_to_sort(cuda):
    scene, cfg, _ = models.book1_random_spheres(dict(image_width=96))
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=96,
                                   height=cfg.image_height, device=cuda)
    kw = dict(spp=8, max_depth=50, persist_iters=4)
    on = wf._wavefront_pass_persist(tables, 5, 0, sort_rays=True, **kw)
    off = wf._wavefront_pass_persist(tables, 5, 0, sort_rays=False, **kw)
    assert torch.equal(on, off)


@pytest.mark.cuda
def test_sphere_hit_quads_kernel_matches_plain(cuda):
    """K1 after its quad test moved to rtt_common.cuh: the Cornell box's
    sphere and 12 quads, rays from inside the box."""
    scene, _, _ = models.book3_cornell_box(dict(image_width=32))
    sph = hit.pack_sphere_table(scene).to(cuda)
    quad = hit.pack_quad_table(scene).to(cuda)
    rng = np.random.default_rng(5)
    o = torch.from_numpy(rng.uniform(50, 500, (16384, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(16384, 3)).astype(np.float32))
    t = torch.zeros(16384)
    o, d, t = o.to(cuda), d.to(cuda), t.to(cuda)
    tk, ik = hit.sphere_hit(o, d, t, sph, quad, False)
    tp, ip = hit.sphere_hit_plain(o, d, t, sph, quad, False)
    assert int((ik >= sph.shape[0]).sum()) > 8000  # quad winners
    assert torch.equal(ik, ip)
    assert torch.equal(tk, tp)


def _cornell_tables(cuda, width, spp):
    scene, cfg, _ = models.book3_cornell_box(
        dict(image_width=width, samples_per_pixel=spp))
    n = int(np.sqrt(spp))
    return mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=width,
                                 height=cfg.image_height, mis=True,
                                 stratified=True, sqrt_spp=n, device=cuda)


@pytest.mark.cuda
def test_persist_launch_mis_quads_matches_plain_step(cuda):
    tables = _cornell_tables(cuda, 64, 4)
    st_k = torch.zeros((wf.N_STATE, tables.n_lanes), device=cuda)
    st_p = st_k.clone()
    slot = torch.arange(tables.n_lanes, dtype=torch.int32, device=cuda)
    kw = dict(persist_iters=8, spp=4, max_depth=50, sample_offset=2)
    wf.persist_step(st_k, slot, tables, 11, **kw)
    wf.persist_step_plain(st_p, slot, tables, 11, **kw)
    assert float(st_p[wf.R_DONE].sum()) > 0
    assert torch.equal(st_k, st_p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["book3_cornell_box", "book2_cornell_box",
                                  "book1_three_spheres"])
def test_respawn_pass_kernel_matches_plain(cuda, name):
    """K3 against its plain twin, bitwise, and against the unsorted K2 loop
    on the same tables; the work counters see every bounce."""
    scene, cfg, integ = models.get_scene(name, dict(image_width=64))
    mis = integ == "mis"
    tables = mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=64, height=cfg.image_height,
        mis=mis, stratified=cfg.stratified, sqrt_spp=2 if mis else 0,
        device=cuda)
    before = _cuda.launch_counts()["megakernel"]
    k3 = mk.respawn_pass(tables, 9, 4, 4, 50)
    assert _cuda.launch_counts()["megakernel"] == before + 1
    # the counting instance computes the same sums
    work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64,
                       device=cuda)
    k3_counted = mk.respawn_pass(tables, 9, 4, 4, 50, work=work)
    plain = mk.respawn_pass_plain(tables, 9, 4, 4, 50)
    k2 = wf._wavefront_pass_persist(tables, 9, 4, spp=4, max_depth=50,
                                    persist_iters=16, sort_rays=False)
    assert float(plain.sum()) > 0
    assert torch.equal(k3, plain)
    assert torch.equal(k3, k2)
    assert torch.equal(k3, k3_counted)
    assert int(work[0]) >= tables.n_lanes * 4  # at least a bounce a path


@pytest.mark.cuda
def test_respawn_pass_two_level_cull_matches_plain(cuda):
    """K3 under the two-level cull (>= 16 SAH clusters), which no ported
    reference scene reaches: 1500 spheres over the ground sphere."""
    from rustraytrace_tpu_torch import RenderConfig, SceneBuilder

    rng = np.random.default_rng(4)
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    mat = b.metal((0.7, 0.6, 0.5), 0.1)
    for x, z, r in zip(rng.uniform(-15, 15, 1500), rng.uniform(-15, 15, 1500),
                       rng.uniform(0.1, 0.3, 1500)):
        b.add_sphere((float(x), float(r), float(z)), float(r), mat)
    cfg = RenderConfig(image_width=96)
    tables = mk.prepare_megakernel(b.build(), derive_camera(cfg, "cpu"), width=96,
                                   height=cfg.image_height, device=cuda)
    assert tables.n_sclusters > 1
    k3 = mk.respawn_pass(tables, 3, 0, 4, 50)
    plain = mk.respawn_pass_plain(tables, 3, 0, 4, 50)
    assert float(plain.sum()) > 0
    assert torch.equal(k3, plain)


@pytest.mark.cuda
def test_wrappers_reject_bad_tensors(cuda):
    scene, _, _ = models.book1_random_spheres(dict(image_width=64))
    sph = hit.pack_sphere_table(scene).to(cuda)
    quad = torch.zeros((0, hit.Q_COLS), device=cuda)
    o, d, t = (x.to(cuda) for x in _rays(256, seed=4))
    with pytest.raises(ValueError, match="float32"):
        hit.sphere_hit(o.double(), d, t, sph, quad, False)
    with pytest.raises(ValueError, match="CUDA"):
        hit.sphere_hit(o, d, t, sph.cpu(), quad, False)
    with pytest.raises(ValueError, match="shape"):
        hit.sphere_hit(o, d, t[:10], sph, quad, False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["the_next_week", "book2_cornell_smoke",
                                  "book2_earth", "book2_bouncing_spheres",
                                  "book2_perlin_spheres"])
def test_book2_persist_launch_matches_plain_step(cuda, name):
    """One K2 launch over the Book-2 features (motion, checker, boxes,
    media, Perlin marble, image texels) against the plain step, bitwise,
    with per-tile launch bounds."""
    scene, cfg, _ = models.get_scene(name, dict(image_width=96))
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"),
                                   width=96, height=cfg.image_height,
                                   tile_rows=8, device=cuda)
    assert tables.book2
    R = tables.n_lanes
    st_k = torch.zeros((wf.N_STATE, R), device=cuda)
    st_p = st_k.clone()
    slot = torch.arange(R, dtype=torch.int32, device=cuda)
    tb = torch.tensor([2 + 3 * (k % 3) for k in range(R // 1024)],
                      dtype=torch.int32, device=cuda)
    kw = dict(persist_iters=8, spp=4, max_depth=min(cfg.max_depth, 12),
              sample_offset=1)
    for bounds in (None, tb):
        wf.persist_step(st_k, slot, tables, 11, tile_bounds=bounds,
                        tile_lanes=1024, **kw)
        wf.persist_step_plain(st_p, slot, tables, 11, tile_bounds=bounds,
                              tile_lanes=1024, **kw)
    assert float(st_p[wf.R_DONE].sum()) > 0
    assert torch.equal(st_k, st_p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["book2_cornell_smoke", "book2_simple_light",
                                  "book2_checkered_spheres"])
def test_book2_respawn_pass_kernel_matches_plain(cuda, name):
    """K3 with the Book-2 features against its plain twin and the unsorted
    K2 loop, bitwise."""
    scene, cfg, _ = models.get_scene(name, dict(image_width=64))
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"),
                                   width=64, height=cfg.image_height,
                                   device=cuda)
    k3 = mk.respawn_pass(tables, 9, 4, 4, 12)
    plain = mk.respawn_pass_plain(tables, 9, 4, 4, 12)
    k2 = wf._wavefront_pass_persist(tables, 9, 4, spp=4, max_depth=12,
                                    persist_iters=5, sort_rays=False)
    assert float(plain.sum()) > 0
    assert torch.equal(k3, plain)
    assert torch.equal(k3, k2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["book3_cornell_box", "book2_cornell_smoke",
                                  "book1_three_spheres"])
def test_mono_pass_kernel_matches_plain_and_k3(cuda, name):
    """K4 against its plain twin and against K3 on the same tables and
    seed, bitwise; the counting instance computes the same sums."""
    scene, cfg, integ = models.get_scene(name, dict(image_width=64))
    mis = integ == "mis"
    tables = mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=64, height=cfg.image_height,
        mis=mis, stratified=cfg.stratified, sqrt_spp=2 if mis else 0,
        device=cuda)
    before = _cuda.launch_counts()["mono"]
    k4 = mk.mono_pass(tables, 9, 4, 4, 50)
    assert _cuda.launch_counts()["mono"] == before + 1
    work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64, device=cuda)
    k4_counted = mk.mono_pass(tables, 9, 4, 4, 50, work=work)
    plain = mk.mono_pass_plain(tables, 9, 4, 4, 50)
    k3 = mk.respawn_pass(tables, 9, 4, 4, 50)
    assert float(plain.sum()) > 0
    assert torch.equal(k4, plain)
    assert torch.equal(k4, k3)
    assert torch.equal(k4, k4_counted)
    assert int(work[0]) >= tables.n_lanes * 4


def _segment_tables(name, cuda, width=96):
    scene, cfg, _ = models.get_scene(name, dict(image_width=width))
    return mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=width,
        height=cfg.image_height, tile_rows=wf.wavefront_tile_rows(scene),
        device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["the_next_week", "book2_earth"])
def test_segment_launch_matches_plain_step(cuda, name):
    """Three fused K5 launches against the plain step on a spawned state
    with every third lane dead and done, bitwise (state, sums, done,
    sample, alive counts); then the segment loop == K3, bitwise."""
    tables = _segment_tables(name, cuda)
    kw = dict(spp=2, max_depth=4, sample_offset=3)
    st_k, sums_k, done_k, smp_k = wf.segment_start(tables, 11, 3)
    st_k[wf.R_ALIVE, ::3] = 0.0
    done_k[::3] = 2.0
    plain = [t.clone() for t in (st_k, sums_k, done_k, smp_k)]
    alive_k = torch.zeros(3, dtype=torch.int32, device=cuda)
    alive_p = alive_k.clone()
    before = _cuda.launch_counts()["segment"]
    for g in range(3):
        wf.segment_step(st_k, sums_k, done_k, smp_k, tables, 11,
                        alive=alive_k[g:], **kw)
        wf.segment_step_plain(*plain, tables, 11, alive=alive_p[g:], **kw)
    assert _cuda.launch_counts()["segment"] == before + 3
    for k, p in zip((st_k, sums_k, done_k, smp_k), plain):
        assert torch.equal(k, p)
    assert torch.equal(alive_k, alive_p) and int(alive_k[0]) > 0
    assert float(sums_k.sum()) > 0
    seg = wf._wavefront_pass_segments(tables, 11, 1, spp=2, max_depth=4)
    k3 = mk.respawn_pass(tables, 11, 1, 2, 4)
    assert float(seg.sum()) > 0
    assert torch.equal(seg, k3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["the_next_week", "book2_earth"])
def test_segment_instances_match_plain_over_a_pass(cuda, name):
    """Both K5 instances (cooperative on the final scene, per-lane on
    earth) against the twin segment by segment through the first ten
    segments of a pass, where lanes bank and respawn; the counting
    instance gives the same state; every chunking banks the same sums as
    K3 with the same segment count."""
    tables = _segment_tables(name, cuda)
    assert mk.cluster_cull(tables) == (name == "the_next_week")
    kw = dict(spp=3, max_depth=4, sample_offset=2)
    kern = list(wf.segment_start(tables, 5, 2))
    plain = [t.clone() for t in kern]
    counted = [t.clone() for t in kern]
    work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64, device=cuda)
    for g in range(10):
        ak = torch.zeros(1, dtype=torch.int32, device=cuda)
        ap = ak.clone()
        wf.segment_step(*kern, tables, 5, alive=ak, **kw)
        wf.segment_step(*counted, tables, 5, work=work, **kw)
        wf.segment_step_plain(*plain, tables, 5, alive=ap, **kw)
        for k, p, c in zip(kern, plain, counted):
            assert torch.equal(k, p), g
            assert torch.equal(k, c), g
        assert torch.equal(ak, ap)
    assert int(work[0]) > 0 and float(kern[1].sum()) > 0
    k3 = mk.respawn_pass(tables, 5, 2, 3, 4)
    segments = None
    for chunk in (1, 8, 16, 64):
        stats = {}
        before = _cuda.launch_counts()["segment"]
        sums = wf._wavefront_pass_segments(tables, 5, 2, chunk=chunk,
                                           stats=stats, **{
                                               k: kw[k] for k in
                                               ("spp", "max_depth")})
        assert torch.equal(sums, k3), chunk
        segments = segments or stats["launches"]
        assert stats["launches"] == segments
        assert (_cuda.launch_counts()["segment"] - before
                == stats["kernel_launches"] >= segments)
        assert stats["host_syncs"] <= -(-segments // chunk) + 2


@pytest.mark.cuda
def test_quad_cluster_kernels_match_plain(cuda):
    """K2 and K3 under the SAH quad-cluster cull (256 quads, the camera
    inside the field) against the plain twin, bitwise."""
    scene = quad_field(SceneBuilder, 256)
    cfg = RenderConfig(image_width=96, **FIELD_INSIDE_CFG)
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"),
                                   width=96, height=96, device=cuda)
    assert tables.n_qclusters > 1
    k3 = mk.respawn_pass(tables, 5, 0, 4, 8)
    plain = mk.respawn_pass_plain(tables, 5, 0, 4, 8)
    assert float(plain.sum()) > 0
    assert torch.equal(k3, plain)
    st_k = torch.zeros((wf.N_STATE, tables.n_lanes), device=cuda)
    st_p = st_k.clone()
    slot = torch.arange(tables.n_lanes, dtype=torch.int32, device=cuda)
    kw = dict(persist_iters=6, spp=4, max_depth=8)
    wf.persist_step(st_k, slot, tables, 5, **kw)
    wf.persist_step_plain(st_p, slot, tables, 5, **kw)
    assert torch.equal(st_k, st_p)


@pytest.mark.cuda
@pytest.mark.parametrize("smoke", [(0.0, 0.0, 0.0), (0.73, 0.73, 0.73)])
def test_smoke_mis_kernels_match_plain(cuda, smoke):
    """The MIS isotropic branch: K3 and K4 on the smoke scene against the
    plain twin, bitwise."""
    scene = smoke_mis_scene(SceneBuilder, smoke)
    cfg = RenderConfig(image_width=64, **SMOKE_CFG)
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"),
                                   width=64, height=64, mis=True,
                                   device=cuda)
    k3 = mk.respawn_pass(tables, 2, 0, 4, 12)
    k4 = mk.mono_pass(tables, 2, 0, 4, 12)
    plain = mk.respawn_pass_plain(tables, 2, 0, 4, 12)
    assert float(plain.sum()) > 0
    assert torch.equal(k3, plain)
    assert torch.equal(k4, plain)


def _spike_rays(ns, n_rays, cuda, seed=0):
    """The spike's tables and rays (ops: scripts.spike_dense_mxu), with
    ``n_rays`` rays drawn as the spike draws its 4,096."""
    from rustraytrace_tpu_torch.scripts.spike_dense_mxu import spike_inputs

    dtab, stab, _, _ = spike_inputs(ns, seed)
    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-100, 100, (3, n_rays)).astype(np.float32)
    d = rng.normal(size=(3, n_rays)).astype(np.float32)
    rays = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
            for x in (*o, *d)]
    return (torch.from_numpy(dtab).to(cuda), torch.from_numpy(stab).to(cuda),
            rays)


@pytest.mark.cuda
@pytest.mark.parametrize("ns,n_rays", [(512, 4096), (1024, 65536)])
def test_scalar_hit_kernel_matches_plain(cuda, ns, n_rays):
    """S1's scalar loop against its twin: bitwise (-fmad=false), for one
    scan and for three (the repeat changes nothing), at the split the
    wrapper picks."""
    from rustraytrace_tpu_torch.ops import dense_hit as dh

    _, stab, rays = _spike_rays(ns, n_rays, cuda)
    before = _cuda.launch_counts()["scalar_hit"]
    tk, ik = dh.scalar_hit(stab, *rays, iters=1)
    t3, i3 = dh.scalar_hit(stab, *rays, iters=3)
    assert _cuda.launch_counts()["scalar_hit"] == before + 2
    tp, ip = dh.scalar_hit_plain(stab, *rays)
    assert int((ip >= 0).sum()) > n_rays // 8
    assert torch.equal(ik, ip) and torch.equal(tk, tp)
    assert torch.equal(i3, ip) and torch.equal(t3, tp)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("ns,n_rays", [(1024, 4096), (1500, 8192)])
def test_scalar_hit_every_split_matches_plain(cuda, split, ns, n_rays):
    """Every split of S1b against the twin, bitwise: 1,024 spheres (one
    shared-memory tile) and 1,500 (two, the second ragged), with a winning
    sphere copied to a later row so that shares tie; the default split of
    4,096 rays is 32 (too few rays to fill the card otherwise)."""
    from rustraytrace_tpu_torch.ops import dense_hit as dh

    _, stab, rays = _spike_rays(ns, n_rays, cuda, seed=2)
    _, first = dh.scalar_hit_plain(stab, *rays)
    k = int(torch.bincount(first[first >= 0].long()).argmax())
    stab[:, ns - 3] = stab[:, k]
    tp, ip = dh.scalar_hit_plain(stab, *rays)
    tk, ik = dh.scalar_hit(stab, *rays, iters=2, split=split)
    assert torch.equal(ik, ip) and torch.equal(tk, tp)
    assert int((ik == k).sum()) > 0 and int((ik == ns - 3).sum()) == 0
    assert _cuda.scalar_split(4096) == 32
    assert _cuda.scalar_split(1 << 20) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 4, None, 64])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("ns,n_rays", [(1024, 4096), (1024, 65536),
                                       (1040, 8192)])
def test_dense_hit_kernel_matches_plain(cuda, split, precision, ns, n_rays):
    """S1's tensor-core kernel against its twin (float32 matmul, TF32 off;
    operands rounded to TF32 for 'default') at every forced split of the
    sphere axis (1, 4, the default, the largest) and at 1,040 spheres (a
    multiple of 16 but not of a product's 32 or of the 256-sphere tile):
    winner index and hit mask equal on >= 99.9% of rays; |dt| <= 1e-2
    where both hit, on every ray at the spike's 4,096 and on >= 99.9% of
    them at more (there even exactly rounded products differ from the
    twin by more on near-tangent rays: 1.1e-2 at 262,144 rays in a float64
    emulation); and the first index on a tie (a winning sphere copied to
    the next row and to the last, which is in another range at every
    split above 1).  One launch of the kernel, and one of the merge
    above one range."""
    from rustraytrace_tpu_torch.ops import dense_hit as dh

    dtab, _, rays = _spike_rays(ns, n_rays, cuda)
    before = _cuda.launch_counts()
    tk, ik = dh.dense_hit(dtab, *rays, iters=2, precision=precision,
                          split=split)
    after = _cuda.launch_counts()
    used = split or dh.default_split(
        n_rays, ns, _cuda.dense_wave(precision == "highest"))
    assert after["dense_hit"] == before["dense_hit"] + 1
    # the ranges' merge is a launch of its own, above one range
    assert after["dense_merge"] == before["dense_merge"] + (used > 1)
    tp, ip = dh.dense_hit_plain(dtab, *rays, precision=precision)
    both = (ik >= 0) & (ip >= 0)
    assert int(both.sum()) > n_rays // 8
    assert ((ik >= 0) == (ip >= 0)).float().mean().item() >= 0.999
    assert (ik == ip).float().mean().item() >= 0.999
    dt = torch.abs(tk - tp)[both]
    if n_rays == 4096:
        assert dt.max().item() <= 1e-2
    else:
        assert (dt <= 1e-2).float().mean().item() >= 0.999
    wins = torch.bincount(ip[ip >= 0].long(), minlength=ns)
    k = int(torch.argmax(wins[:ns // 2]))  # a sphere that wins many rays
    tie = dtab.clone()
    tie[:, k + 1] = tie[:, k]
    tie[:, ns - 1] = tie[:, k]
    _, ik = dh.dense_hit(tie, *rays, precision=precision, split=split)
    assert int((ik == k).sum()) > 0
    assert int(((ik == k + 1) | (ik == ns - 1)).sum()) == 0
    wave = _cuda.dense_wave(precision == "highest")
    assert dh.default_split(4096, 1024, wave) in dh.DENSE_SPLITS


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["book1_random_spheres",
                                  "book2_bouncing_spheres",
                                  "book2_cornell_smoke", "book2_earth"])
def test_closest_hit_spheres_kernel_matches_twin(cuda, name):
    """The sphere_kernel route's closest hit with K1 against the same
    function with K1's twin: every record field bitwise equal."""
    from rustraytrace_tpu_torch import render

    scene = render._scene_on(models.get_scene(name)[0], cuda)
    o, d, t = (x.to(cuda) for x in _rays(8192, seed=4))
    um = torch.rand((8192, 4), generator=torch.Generator().manual_seed(1))
    um = um.to(cuda)
    before = _cuda.launch_counts()["sphere_hit"]
    rk, mk_ = hit.closest_hit_spheres(o, d, t, scene, u_media=um)
    assert _cuda.launch_counts()["sphere_hit"] == before + 1
    rp, mp = hit.closest_hit_spheres(o, d, t, scene, u_media=um,
                                     hit_fn=hit.sphere_hit_plain)
    for f in ("valid", "t", "p", "normal", "front_face", "mat", "u", "v"):
        assert torch.equal(getattr(rk, f), getattr(rp, f)), f
    for f in ("kind", "albedo", "fuzz", "ior"):
        assert torch.equal(getattr(mk_, f), getattr(mp, f)), f


@pytest.mark.cuda
def test_sphere_kernel_route_matches_its_twin(cuda):
    """A sphere_kernel pass with K1 == the same pass with K1's twin,
    bitwise; K1 launched max_depth times per chunk (a chunk traces every
    sample of the pass at once)."""
    from rustraytrace_tpu_torch import render

    scene, cfg, _ = models.book1_random_spheres(dict(image_width=64))
    cam = derive_camera(cfg, cuda)
    kw = dict(width=64, height=cfg.image_height, spp=2, max_depth=8,
              chunk=1024, device=cuda)
    _cuda.reset_launch_counts()
    k = render.render_pass(scene, cam, 3, backend="sphere_kernel", **kw)
    n_chunks = -(-64 * cfg.image_height // 1024)
    assert _cuda.launch_counts()["sphere_hit"] == 8 * n_chunks
    p = render._render_pass_reference(scene, cam, 3, backend="sphere_kernel",
                                      hit_fn=hit.sphere_hit_plain, **kw)
    assert torch.equal(k, p)


class _Stop(Exception):
    pass


def _loop_state(tables, seed, spp, depth, iters, launch, adaptive=()):
    """The input of launch ``launch`` (from 1) of the sorted persist loop
    ``wavefront._wavefront_pass_persist``, taken by a step that runs K2 for
    the launches before it and stops the loop there: lanes mid-sample at
    different depths, some finished, in sorted order, with the loop's tile
    bounds."""
    got = []

    def step(state, slot, tables, seed, **kw):
        if len(got) + 1 == launch:
            got.append((state.clone(), slot.clone(), kw["tile_bounds"],
                        kw["tile_lanes"]))
            raise _Stop
        got.append(None)
        wf.persist_step(state, slot, tables, seed, **kw)

    with pytest.raises(_Stop):
        wf._wavefront_pass_persist(
            tables, seed, 0, spp=spp, max_depth=depth, persist_iters=iters,
            sort_rays=True, adaptive_bounds=adaptive, step=step)
    return got[-1]


@pytest.mark.cuda
@pytest.mark.parametrize("name,spp", [
    ("book1_random_spheres", 1), ("book1_random_spheres", 4),
    ("the_next_week", 1), ("the_next_week", 2), ("sphere_field_10k", 1)])
def test_warp_persist_launch_matches_plain_step(cuda, name, spp):
    """K2's converged warps from a mid-loop state: lanes that finish
    mid-launch (spp 1), ragged warps of lanes at other depths, tiles with
    other bounds, against the plain step bitwise."""
    scene, cfg, _ = models.get_scene(name, dict(image_width=96))
    image = "image" in scene.features
    tables = mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=96, height=cfg.image_height,
        tile_rows=2 if image else 8, device=cuda)
    depth = min(cfg.max_depth, 12)
    state, slot, tb, tl = _loop_state(tables, 5, spp, depth, 3, 3,
                                      (1, 3, 0.25) if image else ())
    if tb is None:
        tb = torch.tensor([1 + k % 5 for k in range(tables.n_lanes // tl)],
                          dtype=torch.int32, device=cuda)
    for bounds in (None, tb):
        k, p = state.clone(), state.clone()
        kw = dict(persist_iters=6, spp=spp, max_depth=depth,
                  tile_bounds=bounds, tile_lanes=tl)
        wf.persist_step(k, slot, tables, 5, **kw)
        wf.persist_step_plain(p, slot, tables, 5, **kw)
        assert torch.equal(k, p)
        if spp == 1:  # lanes finish their sample during the launch
            assert bool((p[wf.R_DONE] > state[wf.R_DONE]).any())


def _hit_case(case, cuda):
    """(o, d, time, sph_tab, quad_tab, moving) of a K1 case."""
    n = {"ragged": 4097, "ragged_small": 1000}.get(case, 65536)
    o, d, t = (x.to(cuda) for x in _rays(n, seed=7))
    quad = torch.zeros((0, hit.Q_COLS), device=cuda)
    moving = False
    if case == "tiles":  # 10,001 spheres: ten ring tiles
        scene = models.sphere_field_10k()[0]
    elif case == "moving":
        scene = models.book2_bouncing_spheres()[0]
        moving = True
    elif case == "quads":
        scene = models.book2_cornell_smoke()[0]
        quad = hit.pack_quad_table(scene).to(cuda)
        rng = np.random.default_rng(7)
        ob = rng.uniform(-50, 50, (n, 3)) + np.asarray([278, 278, -800])
        db = rng.uniform(0, 555, (n, 3)) - ob
        o, d = (torch.from_numpy(x.astype(np.float32)).to(cuda)
                for x in (ob, db))
    else:
        scene = models.book1_random_spheres()[0]
    sph = hit.pack_sphere_table(scene).to(cuda)
    if case == "ties":
        # every row again at a later index: each hit ties exactly with
        # its copy, and the first must win
        sph = torch.cat([sph, sph])
    return o, d, t, sph, quad, moving


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship", "tiles", "moving", "quads",
                                  "ragged", "ragged_small", "ties"])
def test_sphere_hit_ring_kernel_matches_plain(cuda, case):
    """K1 against its twin, t and idx bitwise: a table of ten ring tiles,
    moving spheres, quads, ray counts that are not a multiple of a block's
    512 rays, and exact ties (the first row wins)."""
    o, d, t, sph, quad, moving = _hit_case(case, cuda)
    tk, ik = hit.sphere_hit(o, d, t, sph, quad, moving)
    tp, ip = hit.sphere_hit_plain(o, d, t, sph, quad, moving)
    assert int((ik >= 0).sum()) > o.shape[0] // 10
    assert torch.equal(ik, ip) and torch.equal(tk, tp)
    if case == "ties":
        assert int(ik.max()) < sph.shape[0] // 2
    if case == "quads":
        assert int((ik >= sph.shape[0]).sum()) > 0


@pytest.mark.cuda
def test_render_image_on_pass_gets_a_host_copy(cuda):
    """On the card, on_pass receives a CPU copy that np.asarray reads."""
    from rustraytrace_tpu_torch import render

    scene, cfg, _ = models.book1_random_spheres(dict(
        image_width=64, samples_per_pixel=4, spp_per_pass=2, max_depth=8))
    seen = []

    def grab(state):
        assert state["accum"].device.type == "cpu"
        seen.append(np.asarray(state["accum"]))

    _, full = render.render_image(scene, cfg, on_pass=grab, device=cuda)
    assert len(seen) == 2
    np.testing.assert_array_equal(seen[-1], full["accum"])


def _megakernel_tables(name, cuda):
    """Tables of a small render of ``name``: "the_next_week" (motion,
    boxes, media, Perlin, image texels), "book3_cornell_box" (MIS, quads,
    strata) or "smoke_mis" (a medium under MIS)."""
    if name == "smoke_mis":
        scene = smoke_mis_scene(SceneBuilder, (0.73, 0.73, 0.73))
        cfg = RenderConfig(image_width=48, **SMOKE_CFG)
        return mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"),
                                     width=48, height=48, mis=True,
                                     device=cuda)
    scene, cfg, integ = models.get_scene(name, dict(image_width=48))
    mis = integ == "mis"
    return mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=48, height=cfg.image_height,
        mis=mis, stratified=cfg.stratified, sqrt_spp=2 if mis else 0,
        device=cuda)


def _first_slots(tables, n):
    """The tables restricted to their first ``n`` slots (``n_lanes`` =
    n), which kernels and twins both read."""
    import dataclasses

    @dataclasses.dataclass
    class FirstSlots(mk.Prepared):
        cut: int = 0

        @property
        def n_lanes(self):
            return self.cut

    return FirstSlots(**{f.name: getattr(tables, f.name)
                         for f in dataclasses.fields(tables)}, cut=n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["the_next_week", "book3_cornell_box",
                                  "smoke_mis"])
@pytest.mark.parametrize("R", [1, 31, 33, 4097])
def test_megakernels_match_plain_on_ragged_slot_counts(cuda, name, R):
    """K3 and K4 over R slots (one lane, partial warps, a partial block)
    against their plain twins, bitwise: every slot taken from the queue
    once and written once, with motion, media and MIS, in the cooperative
    instance (the final scene's cluster cull) and the per-lane one."""
    tables = _first_slots(_megakernel_tables(name, cuda), R)
    assert mk.cluster_cull(tables) == (name == "the_next_week")
    for kern, plain in ((mk.respawn_pass, mk.respawn_pass_plain),
                        (mk.mono_pass, mk.mono_pass_plain)):
        k = kern(tables, 5, 2, 2, 12)
        p = plain(tables, 5, 2, 2, 12)
        assert k.shape == (R, 3)
        assert torch.equal(k, p)
        # every slot's two paths ran (the first slots may see only black)
        work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64,
                           device=cuda)
        assert torch.equal(kern(tables, 5, 2, 2, 12, work=work), p)
        assert int(work[WORK_INDEX["bounces"]]) >= 2 * R
    if R > 4096:
        assert float(p.abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["book1_random_spheres", "book3_cornell_box",
                                  "the_next_week"])
def test_megakernels_one_block_grid_matches_full_grid(cuda, name):
    """The sums do not depend on the grid: one block walking every slot of
    the queue gives the resident wave's sums bitwise, for K3, K4 and their
    counting instances, cooperative (random spheres, the final scene) and
    per-lane (the Book-3 box)."""
    tables = _megakernel_tables(name, cuda)
    full = mk.respawn_pass(tables, 3, 0, 4, 50)
    assert float(full.abs().sum()) > 0
    for kern in (mk.respawn_pass, mk.mono_pass):
        work = torch.zeros(len(mk.WORK_NAMES), dtype=torch.int64,
                           device=cuda)
        assert torch.equal(kern(tables, 3, 0, 4, 50), full)
        assert torch.equal(kern(tables, 3, 0, 4, 50, max_blocks=1), full)
        assert torch.equal(kern(tables, 3, 0, 4, 50, work=work,
                                max_blocks=1), full)
        assert int(work[WORK_INDEX["lane_steps"]]) > 0

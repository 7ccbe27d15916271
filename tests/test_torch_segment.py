"""The per-bounce segment kernel K5 and its host loop (plain twin on the
CPU): a segmented pass equals the unsorted persist loop and K3's twin
bitwise on the Book-2 final scene and on earth; one step bounces the live
lanes only and banks and respawns those that die; the routing of
``per_bounce_segments``; and the segmented earth against the JAX
package's XLA backend.  The CUDA kernel is held
against its twin in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu import render as jrender  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu_torch import models  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402


def _image_tables(name, width=24):
    scene, cfg, _ = models.get_scene(name, dict(image_width=width))
    return scene, cfg, mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=width,
        height=cfg.image_height, tile_rows=wf.wavefront_tile_rows(scene),
        device="cpu")


@pytest.mark.parametrize("name", ["the_next_week", "book2_earth"])
def test_segmented_pass_equals_persist_loop_and_k3(name):
    """Same tables, seed and sample offset: the segment loop (one bounce a
    launch, bank and respawn between launches), the unsorted persist loop
    and K3's twin bank bitwise equal sums."""
    _, _, tables = _image_tables(name)
    kw = dict(spp=3, max_depth=4)
    stats = {}
    seg = wf._wavefront_pass_segments(tables, 7, 2, stats=stats, **kw)
    k2 = wf._wavefront_pass_persist(tables, 7, 2, persist_iters=3,
                                    sort_rays=False, **kw)
    k3 = mk.respawn_pass_plain(tables, 7, 2, 3, 4)
    assert torch.all(torch.isfinite(seg)) and float(seg.sum()) > 0
    assert torch.equal(seg, k2)
    assert torch.equal(seg, k3)
    # at least a bounce a sample, at most the JAX segment loop's bound
    assert 3 <= stats["launches"] <= 3 * 4 + 1


def test_segment_step_bounces_live_lanes_only():
    """One fused segment: a dead lane with no samples left is untouched; a
    live lane bounces once; a lane that dies in the bounce banks its
    radiance, counts the sample and, with samples left, respawns the
    camera ray of its next sample (bounce count 0, alive)."""
    _, _, tables = _image_tables("the_next_week")
    R = tables.n_lanes
    state, sums, done, sample = wf.segment_start(tables, 3, 5)
    state[wf.R_ALIVE, ::2] = 0.0  # every other lane dead, samples all done
    done[::2] = 4.0
    before = [t.clone() for t in (state, sums, done, sample)]
    # the bare bounce, for the radiance that the dying lanes bank
    v = {k: state[r].clone() for r, k in enumerate(wf._SEG_NAMES)}
    slot = torch.arange(R, dtype=torch.int64)
    wf.bounce_live(tables, v, slot, sample.long(), wf.seed_key(3), 4)
    alive = torch.zeros(1, dtype=torch.int32)
    wf.segment_step(state, sums, done, sample, tables, 3, spp=4,
                    max_depth=4, sample_offset=5, alive=alive)
    for t, b in zip((state, sums, done, sample), before):
        assert torch.equal(t[..., ::2], b[..., ::2])
    odd = torch.arange(1, R, 2)
    died = odd[v["alive"][odd] <= 0.0]
    live = odd[v["alive"][odd] > 0.0]
    assert died.numel() > 0 and live.numel() > 0
    # survivors: one bounce, nothing banked
    assert torch.equal(state[14, live], torch.ones(live.numel()))
    assert not torch.equal(state[1:4, live], before[0][1:4, live])
    assert torch.equal(done[live], torch.zeros(live.numel()))
    assert torch.equal(sample[live], before[3][live])
    # the dying lanes: banked, counted, respawned with sample 6
    rad = torch.stack([v["rx"], v["ry"], v["rz"]])
    assert torch.equal(sums[:, died], rad[:, died])
    assert torch.equal(done[died], torch.ones(died.numel()))
    assert torch.equal(sample[died], torch.full((died.numel(),), 6,
                                                dtype=torch.int32))
    assert torch.equal(state[wf.R_ALIVE, died], torch.ones(died.numel()))
    assert torch.equal(state[14, died], torch.zeros(died.numel()))
    assert int(alive) == live.numel() + died.numel()


def test_per_bounce_segments_routes():
    """An image scene runs the segment loop (``stats["launches"]`` counts
    its segments) and raises with ``mis``; a non-image scene goes to K3,
    skipping the sorted route, as pallas_wavefront.py:1001-1038 does."""
    earth, ecfg, _ = models.book2_earth(dict(image_width=16))
    kw = dict(width=16, height=ecfg.image_height, spp=2, max_depth=4,
              per_bounce_segments=True, device="cpu")
    stats = {}
    img = wf.render_pass_wavefront(earth, derive_camera(ecfg, "cpu"), 1,
                                   stats=stats, **kw)
    assert img.shape == (ecfg.image_height, 16, 3) and stats["launches"] > 0
    with pytest.raises(ValueError, match="MIS"):
        wf.render_pass_wavefront(earth, derive_camera(ecfg, "cpu"), 1,
                                 mis=True, **kw)
    flag, fcfg, _ = models.book1_random_spheres(dict(image_width=16))
    assert wf.sorted_persist_route(flag, 16, fcfg.image_height)
    calls = []

    def respawn_step(*args):
        calls.append(args[3])
        return mk.respawn_pass_plain(*args)

    kw.update(height=fcfg.image_height, spp=1)
    wf.render_pass_wavefront(flag, derive_camera(fcfg, "cpu"), 1,
                             respawn_step=respawn_step, **kw)
    assert calls == [1]


def test_segmented_earth_matches_jax_xla():
    """The segmented earth (plain K5 loop) against JAX ``render_pass`` on
    the XLA backend at 32 px wide, 16 spp, depth 8: each channel's image
    mean within 5 standard errors of the per-pixel differences' mean.
    Independent random streams."""
    w, spp, depth = 32, 16, 8
    over = dict(image_width=w)
    jscene, jcfg, _ = jmodels.book2_earth(over)
    scene, cfg, _ = models.book2_earth(over)
    h = cfg.image_height
    ref = np.asarray(jrender.render_pass(
        jscene, jax_derive_camera(jcfg), jax.random.key(0), width=w,
        height=h, spp=spp, max_depth=depth, backend="xla",
        chunk=w * h)) / spp
    got = wf.render_pass_wavefront(
        scene, derive_camera(cfg, "cpu"), 4, width=w, height=h, spp=spp,
        max_depth=depth, per_bounce_segments=True,
        device="cpu").numpy() / spp
    assert np.all(np.isfinite(got)) and got.mean() > 0.05
    diff = (got - ref).reshape(-1, 3)
    se = diff.std(axis=0, ddof=1) / np.sqrt(diff.shape[0])
    assert np.all(np.abs(diff.mean(axis=0)) < 5 * se), (
        diff.mean(axis=0), se)

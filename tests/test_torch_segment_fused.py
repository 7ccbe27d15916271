"""The fused segment step of K5 (one bounce, then the bank and respawn of
the lanes that die in it) and its chunked loop, on the plain twin (CPU):
the fused loop equals the loop that banks and respawns in torch between
bare bounces, bitwise; the chunk size changes neither the sums nor the
segment count; a lane that dies with no samples left is never touched
again; and the segmented earth agrees with the JAX package's XLA backend.
The CUDA kernel is held against the twin in test_torch_cuda.py."""

import math

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

SPP, DEPTH, OFFSET, SEED = 3, 4, 2, 7


def _tables(name, width=24):
    scene, cfg, _ = models.get_scene(name, dict(image_width=width))
    return mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=width,
        height=cfg.image_height, tile_rows=wf.wavefront_tile_rows(scene),
        device="cpu")


def _unfused_loop(tables, seed, sample_offset, spp, max_depth):
    """The segment loop with the bank and respawn in torch between bare
    bounces (``bounce_live``), one host check a segment: the JAX loop's
    order (pallas_wavefront.py:888-950)."""
    R = tables.n_lanes
    key = wf.seed_key(seed)
    slot = torch.arange(R, dtype=torch.int64)
    sample = torch.full((R,), sample_offset, dtype=torch.int64)
    v = wf.spawn_lanes(tables, slot, sample, key)
    zero = torch.zeros(R)
    v = {k: v.get(k, zero) for k in wf._SEG_NAMES}
    done = zero
    sums = torch.zeros((3, R))
    g = 0
    while g < spp * max_depth + 1 and bool((v["alive"] > 0.0).any()):
        was = v["alive"] > 0.0
        wf.bounce_live(tables, v, slot, sample, key, max_depth)
        fin = was & (v["alive"] <= 0.0)
        sums = sums + torch.where(
            fin, torch.stack([v["rx"], v["ry"], v["rz"]]), 0.0)
        done = done + torch.where(fin, 1.0, 0.0)
        nxt = fin & (done < float(spp))
        sample = done.to(torch.int64) + sample_offset
        new = wf.spawn_lanes(tables, slot, sample, key)
        finz = torch.where(fin, 0.0, 1.0)
        v = {k: (v[k] * finz if k in ("rx", "ry", "rz")
                 else torch.where(nxt, new[k], v[k]))
             for k in wf._SEG_NAMES}
        g += 1
    return sums.T.contiguous(), g


@pytest.mark.parametrize("name", ["the_next_week", "book2_earth"])
def test_fused_pass_equals_the_unfused_loop(name):
    tables = _tables(name)
    stats = {}
    got = wf._wavefront_pass_segments(tables, SEED, OFFSET, spp=SPP,
                                      max_depth=DEPTH, stats=stats)
    ref, segments = _unfused_loop(tables, SEED, OFFSET, SPP, DEPTH)
    assert torch.all(torch.isfinite(got)) and float(got.sum()) > 0
    assert torch.equal(got, ref)
    assert stats["launches"] == segments
    # the cooperative instance on the final scene, the per-lane one on earth
    assert mk.cluster_cull(tables) == (name == "the_next_week")


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunking_changes_nothing_but_the_syncs(chunk):
    tables = _tables("the_next_week")
    ref_stats = {}
    ref = wf._wavefront_pass_segments(tables, SEED, OFFSET, spp=SPP,
                                      max_depth=DEPTH, chunk=1,
                                      stats=ref_stats)
    stats = {}
    got = wf._wavefront_pass_segments(tables, SEED, OFFSET, spp=SPP,
                                      max_depth=DEPTH, chunk=chunk,
                                      stats=stats)
    assert torch.equal(got, ref)
    n = stats["launches"]
    assert n == ref_stats["launches"] and SPP <= n <= SPP * DEPTH + 1
    assert n <= stats["kernel_launches"] <= SPP * DEPTH + 1
    assert stats["kernel_launches"] < n + chunk
    assert stats["host_syncs"] <= math.ceil(n / chunk) + 2
    assert stats["chunk"] == chunk
    # one sync per segment until the first with no live lane after it
    assert ref_stats["host_syncs"] == ref_stats["launches"]


def test_a_lane_done_with_its_samples_is_never_touched_again():
    tables = _tables("the_next_week")
    state, sums, done, sample = wf.segment_start(tables, SEED, OFFSET)
    seen = {}
    for g in range(SPP * DEPTH + 1):
        alive = torch.zeros(1, dtype=torch.int32)
        wf.segment_step(state, sums, done, sample, tables, SEED, spp=SPP,
                        max_depth=DEPTH, sample_offset=OFFSET, alive=alive)
        assert int(alive) == int((state[wf.R_ALIVE] > 0.0).sum())
        for lane, snap in seen.items():
            now = (state[:, lane], sums[:, lane], done[lane], sample[lane])
            assert all(torch.equal(a, b) for a, b in zip(now, snap)), lane
        finished = ((done >= SPP) & (state[wf.R_ALIVE] <= 0.0)).nonzero()
        for lane in finished.squeeze(1).tolist():
            seen.setdefault(lane, (state[:, lane].clone(),
                                   sums[:, lane].clone(), done[lane].clone(),
                                   sample[lane].clone()))
        if int(alive) == 0:
            break
    assert int(alive) == 0 and len(seen) == tables.n_lanes
    assert torch.all(done == SPP)
    assert torch.all(sample == OFFSET + SPP)


def test_segment_arguments_are_checked():
    tables = _tables("book2_earth")
    state, sums, done, sample = wf.segment_start(tables, SEED, 0)
    with pytest.raises(ValueError, match="sample"):
        wf.segment_step(state, sums, done, sample.long(), tables, SEED,
                        spp=1, max_depth=4)
    with pytest.raises(ValueError, match="sums"):
        wf.segment_step(state, sums.T.contiguous(), done, sample, tables,
                        SEED, spp=1, max_depth=4)
    with pytest.raises(ValueError, match="chunk"):
        wf._wavefront_pass_segments(tables, SEED, 0, spp=1, max_depth=4,
                                    chunk=0)


def test_segmented_earth_in_chunks_matches_jax_xla():
    """The segmented earth (plain K5 loop, chunks of 5) against JAX
    ``render_pass`` on the XLA backend at 32 px wide, 16 spp, depth 8:
    each channel's image mean within 5 standard errors of the per-pixel
    differences' mean (test_torch_segment.py's tolerance).  Independent
    random streams."""
    w, spp, depth = 32, 16, 8
    over = dict(image_width=w)
    jscene, jcfg, _ = jmodels.book2_earth(over)
    scene, cfg, _ = models.book2_earth(over)
    h = cfg.image_height
    ref = np.asarray(jrender.render_pass(
        jscene, jax_derive_camera(jcfg), jax.random.key(3), width=w,
        height=h, spp=spp, max_depth=depth, backend="xla",
        chunk=w * h)) / spp
    tables = mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=w, height=h,
        tile_rows=wf.wavefront_tile_rows(scene), device="cpu")
    sums = wf._wavefront_pass_segments(tables, 9, 0, spp=spp,
                                       max_depth=depth, chunk=5)
    idx = mk.unswizzle_index_on(w, h, sums.device)
    got = sums[idx].reshape(h, w, 3).numpy() / spp
    assert np.all(np.isfinite(got)) and got.mean() > 0.05
    diff = (got - ref).reshape(-1, 3)
    se = diff.std(axis=0, ddof=1) / np.sqrt(diff.shape[0])
    assert np.all(np.abs(diff.mean(axis=0)) < 5 * se), (
        diff.mean(axis=0), se)

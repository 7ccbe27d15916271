"""The port's flagship slice end to end against the JAX package:
``render_image`` (plain persist step on the CPU) vs JAX ``render_pass``
on the XLA backend, statistically; ``finalize_image`` bit-equal."""

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
from rustraytrace_tpu_torch import models, render  # noqa: E402

W, SPP, DEPTH = 64, 32, 8


@pytest.mark.parametrize("name", ["book1_random_spheres",
                                  "book1_three_spheres"])
def test_render_image_matches_jax_xla(name):
    """Per-channel image means within 0.02 (the bound of
    test_pallas_hit.py::test_render_pass_kernel_backend_statistics), and
    the means of a 4x4 grid of blocks within 5 standard errors.  The two
    renders draw independent random streams; each block's standard error
    comes from the spread of its per-pixel differences, which are
    independent across pixels and share the scene's structure, so it
    cancels."""
    over = dict(image_width=W, samples_per_pixel=SPP, max_depth=DEPTH)
    jscene, jcfg, _ = getattr(jmodels, name)(over)
    scene, cfg, _ = getattr(models, name)(over)
    h = cfg.image_height
    ref = np.asarray(jrender.render_pass(
        jscene, jax_derive_camera(jcfg), jax.random.key(0), width=W,
        height=h, spp=SPP, max_depth=DEPTH, backend="xla",
        chunk=4096)) / SPP
    img_u8, state = render.render_image(scene, cfg, device="cpu")
    assert state["spp_done"] == SPP and img_u8.shape == (h, W, 3)
    got = state["accum"] / SPP
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(
        img_u8, render.finalize_image(state["accum"], SPP))
    err = np.abs(got.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
    assert err.max() < 0.02, (got.mean(axis=(0, 1)), ref.mean(axis=(0, 1)))
    diff = got - ref
    for ys in np.array_split(np.arange(h), 4):
        for xs in np.array_split(np.arange(W), 4):
            blk = diff[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1].reshape(-1, 3)
            se = blk.std(axis=0, ddof=1) / np.sqrt(blk.shape[0])
            assert np.all(np.abs(blk.mean(axis=0)) < 5 * se + 1e-6), (
                ys[0], xs[0], blk.mean(axis=0), se)


def test_finalize_image_bit_equal_jax():
    rng = np.random.default_rng(0)
    acc = rng.uniform(-0.5, 40.0, (9, 11, 3)).astype(np.float32)
    acc[0, 0] = [np.inf, -np.inf, np.nan]
    acc[1, 1] = [0.0, 1e30, -0.0]
    for spp in (0, 1, 7, 32):
        np.testing.assert_array_equal(render.finalize_image(acc, spp),
                                      jrender.finalize_image(acc, spp))


def test_passes_resume_and_route():
    scene, cfg, _ = models.book1_three_spheres(
        dict(image_width=32, samples_per_pixel=8, max_depth=4,
             spp_per_pass=4))
    assert render.resolve_backend(scene, "path", device="cpu") == "plain"
    # 'mis' runs in-kernel (K3 / K2(d)) with the scene's NEE lights; a
    # scene without them takes the reference route, and the kernel routes
    # asked for by name raise
    cornell, _, _ = models.book3_cornell_box()
    assert render.resolve_backend(cornell, "mis", device="cpu") == "plain"
    assert render.resolve_backend(scene, "mis") == "reference"
    with pytest.raises(NotImplementedError, match="NEE lights"):
        render.resolve_backend(scene, "mis", "plain")
    seen = []
    _, full = render.render_image(scene, cfg, on_pass=seen.append, device="cpu")
    assert [s["spp_done"] for s in seen] == [4, 8]
    # resuming from the first pass boundary gives the same sums: the second
    # pass draws the same samples (absolute indices 4..7) either way
    _, resumed = render.render_image(
        scene, cfg, accum_state={"accum": seen[0]["accum"].numpy(),
                                 "spp_done": 4}, device="cpu")
    np.testing.assert_array_equal(resumed["accum"], full["accum"])


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    scene, cfg, _ = models.book1_three_spheres(dict(image_width=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render.render_image(scene, cfg, device="cuda")

"""Silhouette (visibility) gradients of the port's warped-area estimator
(``ops/warp.py``): the twins of ``tests/test_silhouette.py``, on the CPU.

A diffuse sphere against the sky: moving its center or growing its radius
changes pixel coverage, a boundary term interior autodiff cannot see.
With the warp, autograd of the image loss must match central finite
differences taken with the same seed (the same draws on both sides);
without it, AD misses most of the gradient.  The warp is value-
transparent: the warped forward is bit-identical to the tent forward.
Sizes, steps and bands are the JAX tests' (the draws are the port's
Philox, so each realization differs from the JAX package's).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rustraytrace_tpu_torch import RenderConfig, SceneBuilder  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.diff import render_mean  # noqa: E402
from rustraytrace_tpu_torch.ops.warp import splat_weights  # noqa: E402

CFG = RenderConfig(aspect_ratio=1.0, image_width=24, samples_per_pixel=64,
                   max_depth=3, vfov=45.0, lookfrom=(0.0, 0.0, 0.0),
                   lookat=(0.0, 0.0, -1.0), focus_dist=1.0)
CAM = derive_camera(CFG, "cpu")
KW = dict(width=24, height=24, max_depth=3, chunk=576, device="cpu")


def _scene(cx: float = 0.0):
    b = SceneBuilder()
    b.add_sphere((cx, 0.0, -2.0), 0.5, b.lambertian((0.8, 0.2, 0.1)))
    return b.build()


def _with(scene, name, value):
    return dataclasses.replace(scene, **{name: value})


def _loss(scene, seed, spp, warp=True):
    return torch.sum(render_mean(scene, CAM, seed, spp=spp,
                                 warp_primary=warp, **KW))


def _ad_fd(base, name, index, x0, eps, seed, spp, warp=True):
    """(autograd, central difference) of the summed image in one entry."""
    def with_x(x):
        t = getattr(base, name).clone()
        t[index] = x
        return _with(base, name, t)

    x = torch.tensor(x0, requires_grad=True)
    ad, = torch.autograd.grad(_loss(with_x(x), seed, spp, warp), x)
    with torch.no_grad():
        fd = (_loss(with_x(x0 + eps), seed, spp, "tent")
              - _loss(with_x(x0 - eps), seed, spp, "tent")) / (2 * eps)
    return float(ad), float(fd)


def test_warp_forward_values_bit_identical():
    a = _loss(_scene(), 3, 8, warp=True)
    b = _loss(_scene(), 3, 8, warp="tent")
    assert torch.equal(a, b)


def test_splat_weights_partition_of_unity():
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.uniform(-0.5, 0.5, (257, 2)).astype(np.float32))
    dx, dy, w00, w10, w01, w11 = splat_weights(u)
    np.testing.assert_allclose((w00 + w10 + w01 + w11).numpy(), 1.0,
                               atol=1e-6)
    assert torch.all(w00 >= 0) and torch.all(w11 >= 0)
    np.testing.assert_array_equal(dx.numpy(),
                                  np.where(u[:, 0].numpy() >= 0, 1, -1))
    np.testing.assert_array_equal(dy.numpy(),
                                  np.where(u[:, 1].numpy() >= 0, 1, -1))
    _, _, c00, c10, c01, c11 = splat_weights(torch.zeros((1, 2)))
    assert float(c00[0]) == 1.0 and float(c10[0] + c01[0] + c11[0]) == 0.0


def test_silhouette_center_fd_vs_ad():
    """The center moved vertically (the sky's gradient is vertical, so the
    coverage change is nonzero in expectation), AD and FD each the mean
    over seeds 0 and 1.  The JAX test moves the centered sphere sideways,
    where both are zero in expectation by symmetry and a single seed
    compares two noises (the port's seed 3: ad 1.0, fd -4.5)."""
    base = _scene()
    pairs = [_ad_fd(base, "sph_center", (0, 1), 0.0, 0.02, s, 256)
             for s in (0, 1)]
    ad, fd = np.mean(pairs, axis=0)
    assert abs(fd) > 1e-3  # the coverage term is real on this setup
    assert abs(ad - fd) <= 0.15 * abs(fd), (ad, fd)
    # interior-only AD misses most of the boundary term
    ad_interior = np.mean([
        _ad_fd(base, "sph_center", (0, 1), 0.0, 0.02, s, 256,
               warp=False)[0] for s in (0, 1)])
    assert abs(ad_interior - fd) > 2.0 * abs(ad - fd), (ad_interior, ad, fd)


def test_silhouette_lateral_bias_off_center_quantified():
    """SCOPE PIN: with the sphere moved off the axis (cx = 0.3), AD of the
    image sum in cx is 3-4x its finite difference, in the JAX package too
    (measured on the CPU, keys 0-2: ad 213-235, fd 56-64; the port, seeds
    0-5: ad 206-223, fd 50-75), while y, z and the radius agree within
    20% there.  The port keeps the JAX package's estimator; if AD catches
    up here, the estimator changed: move the bound."""
    ad, fd = _ad_fd(_scene(0.3), "sph_center", (0, 0), 0.3, 0.02, 3, 256)
    assert fd > 10.0, fd
    assert ad > 2.0 * fd, (ad, fd)


def test_silhouette_radius_fd_vs_ad():
    ad, fd = _ad_fd(_scene(), "sph_radius", (0,), 0.5, 0.01, 9, 256)
    assert abs(fd) > 1e-3
    assert abs(ad - fd) <= 0.15 * abs(fd), (ad, fd)


@pytest.mark.parametrize("axis,rel_band", [(0, 0.35), (2, None)])
def test_mse_offset_state_fd_vs_ad(axis, rel_band):
    """A per-pixel (MSE) loss at an offset state: the tent splat leaves no
    pixel-edge flux in the gradient, so AD matches FD in sign and, for the
    lateral axis, within 35% (the mean over 8 seeds; the band is the JAX
    test's, for its secondary-silhouette scope bias and the noise)."""
    spp = 64
    with torch.no_grad():
        target = render_mean(_scene(), CAM, 42, spp=spp, **KW)
    base = _with(_scene(), "sph_center",
                 torch.tensor([[0.08, -0.05, -1.9]]))

    def loss_with(delta, seed, warp):
        c = base.sph_center.clone()
        c = c + torch.nn.functional.one_hot(
            torch.tensor(axis), 3).to(torch.float32)[None] * delta
        img = render_mean(_with(base, "sph_center", c), CAM, seed, spp=spp,
                          warp_primary=warp, **KW)
        return torch.mean((img - target) ** 2)

    ads, fds = [], []
    eps = 0.02
    for k in range(8):
        d = torch.tensor(0.0, requires_grad=True)
        g, = torch.autograd.grad(loss_with(d, 100 + k, True), d)
        ads.append(float(g))
        with torch.no_grad():
            fds.append((float(loss_with(eps, 100 + k, "tent"))
                        - float(loss_with(-eps, 100 + k, "tent")))
                       / (2 * eps))
    ad, fd = np.mean(ads), np.mean(fds)
    assert ad * fd > 0, (axis, ad, fd)
    if rel_band is not None:
        assert abs(ad - fd) <= rel_band * abs(fd), (axis, ad, fd)


def test_splat_energy_conserved_flat_background():
    """The four weights sum to 1 and out-of-image neighbors clamp inside,
    so on a flat background the image mean equals the background exactly
    per realization; per pixel it moves with the realized weight sum."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 50.0), 0.5, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.build()
    cfg = RenderConfig(aspect_ratio=1.0, image_width=16, samples_per_pixel=8,
                       max_depth=3, vfov=40.0, lookfrom=(0, 0, 0),
                       lookat=(0, 0, -1), background=(0.3, 0.5, 0.7),
                       focus_dist=1.0)
    cam = derive_camera(cfg, "cpu")
    for warp in (True, "tent"):
        with torch.no_grad():
            img = render_mean(scene, cam, 2, width=16, height=16, spp=8,
                              max_depth=3, chunk=256, warp_primary=warp,
                              device="cpu").numpy()
        np.testing.assert_allclose(img.mean(axis=(0, 1)), [0.3, 0.5, 0.7],
                                   rtol=1e-6)
        ratio = img / np.asarray([0.3, 0.5, 0.7])
        assert ratio.min() > 0.5 and ratio.max() < 1.6, (ratio.min(),
                                                         ratio.max())

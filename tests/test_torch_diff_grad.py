"""Gradients of the port's reference integrators against ``jax.grad`` of
the JAX package's, on the CPU, with the JAX package's own uniforms
injected (the draw source of ``test_torch_reference.py``).

The integrators detach their sampling decisions as the JAX package does:
the Russian-roulette survival probability of ``trace_path``, ``p_rr`` of
``trace_mis`` and the mixture ``pdf_value`` of ``trace_mis``.  Values do not
depend on that, gradients do: with any of them attached, the depth-10
``trace_path`` gradient of the inverse-rendering scene moves by up to 4%.

Tolerance: the gradients of the summed radiance with respect to
``tex_color1`` and ``sph_center`` within rtol 1e-4 of the JAX ones, plus an
atol of 1e-4 of the array's largest entry: an entry that is a sum over
thousands of rays of both signs (the ground's y) keeps the rounding of
its terms, measured here at 6e-4 of itself and 5e-5 of the largest entry;
the sums within rtol 1e-5.  A ray whose path turns another way after a
last-bit difference in t carries another gradient, so the sum runs over
the rays whose radiance agrees within 1e-4 (at least 99% of them).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu.ops import integrator as jinteg  # noqa: E402
from rustraytrace_tpu.ops import rng as jrng  # noqa: E402
from rustraytrace_tpu.scene import SceneBuilder as JaxSceneBuilder  # noqa: E402
from rustraytrace_tpu_torch import RenderConfig, camera, scene_from_numpy  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import integrator  # noqa: E402

NAMES = ("tex_color1", "sph_center")


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_scene(jscene):
    fields = {f: np.asarray(getattr(jscene, f))
              for f in jscene.__dataclass_fields__ if f != "features"}
    fields["features"] = tuple(jscene.features)
    return scene_from_numpy(fields)


def _example_scene():
    """The three spheres of BASELINE config 4's example, at its truth."""
    b = JaxSceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.6, 0.6, 0.6)))
    b.add_sphere((-0.1, 0.05, -1.2), 0.5, b.lambertian((0.75, 0.25, 0.15)))
    b.add_sphere((1.2, 0.0, -1.4), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.build()


def _camera_rays(cfg, n, seed):
    """n camera rays through random pixels of ``cfg`` (NumPy draws)."""
    r = np.random.default_rng(seed)
    cam = derive_camera(cfg, device="cpu")
    px = r.integers(0, cfg.image_width, n).astype(np.float32)
    py = r.integers(0, cfg.image_height, n).astype(np.float32)
    draws = r.uniform(size=(n, 5)).astype(np.float32)
    o, d, tm = camera.generate_rays(cam, _t(px), _t(py), _t(draws))
    return (o.numpy().copy(), d.numpy().copy(), tm.numpy().copy(),
            cam.background.numpy(), cam.bg_mode)


def _jax_draws(key, R):
    def draws(bounce, n):
        return _t(jrng.uniforms(jax.random.fold_in(key, bounce), (R,), n))
    return draws


def _grads(trace, jtrace, jscene, o, d, tm, bg, bg_mode, depth,
           nan_in_both=(), names=NAMES):
    key = jax.random.key(21)
    R = o.shape[0]
    scene = _port_scene(jscene)
    params = {n: getattr(scene, n).clone().requires_grad_(True)
              for n in names}
    opts = integrator.IntegratorOptions(max_depth=depth, bg_mode=bg_mode)
    rad = trace(_jax_draws(key, R), _t(o), _t(d), _t(tm),
                dataclasses.replace(scene, **params), _t(bg), opts)
    jopts = jinteg.IntegratorOptions(max_depth=depth, bg_mode=bg_mode)

    def jrad(p):
        return jtrace(key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                      dataclasses.replace(jscene, **p), jnp.asarray(bg),
                      jopts)

    jp = {n: getattr(jscene, n) for n in names}
    want_rad = np.asarray(jax.jit(jrad)(jp))
    # a ray whose path turns another way after a last-bit difference in t
    # (as in test_torch_reference.py) carries another gradient: hold the
    # sum over the rays whose radiance agrees
    ok = np.all(np.abs(rad.detach().numpy() - want_rad)
                <= 1e-4 * (1.0 + np.abs(want_rad)), axis=-1)
    assert ok.mean() >= 0.99, ok.mean()
    mask = ok.astype(np.float32)[:, None]
    total = (rad * _t(mask)).sum()
    total.backward()
    jval, jg = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(jrad(p) * mask)))(jp)
    np.testing.assert_allclose(total.item(), float(jval), rtol=1e-5)
    for n in names:
        got = params[n].grad.numpy()
        want = np.asarray(jg[n])
        if n in nan_in_both:
            # the JAX package's gradient is NaN here, and so is the port's
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            assert np.isnan(want).all(), n
            continue
        assert np.abs(want).max() > 0.0, n
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=n)


def test_trace_path_gradient_matches_jax_at_depth_10():
    """BASELINE config 4's scene and camera at depth 10, roulette from
    bounce 5: the survival probability must be detached (measured with it
    attached: up to 4.2% off, on the metal texture's red channel)."""
    cfg = RenderConfig(aspect_ratio=16 / 9, image_width=64, max_depth=10,
                       vfov=60.0, lookfrom=(0, 0.3, 0.6), lookat=(0, 0, -1))
    o, d, tm, bg, bg_mode = _camera_rays(cfg, 4096, 3)
    _grads(integrator.trace_path, jinteg.trace_path, _example_scene(), o, d,
           tm, bg, bg_mode, 10)


def test_trace_mis_gradient_matches_jax_on_a_cornell_box():
    """Book 3's estimator at depth 10 on a 32-px Cornell box: ``p_rr`` and
    the mixture pdf are detached, the scattering pdf stays attached
    (measured with them attached: 31% off on the red wall's albedo).

    The ``sph_center`` gradient of ``trace_mis`` is NaN in the JAX package
    on every scene with a light list: the light sample computes a sphere
    cone for every light, and where the cone is degenerate (a quad light's
    zero radius; a hit point on a light sphere) ``sqrt(max(1 - z^2, 0))``
    meets sqrt'(0) = inf.  The port keeps the JAX package's gradient, so
    it is NaN on the same entries."""
    jscene, jcfg, _ = jmodels.book3_cornell_box(dict(image_width=32))
    cfg = RenderConfig(**{f: getattr(jcfg, f)
                          for f in jcfg.__dataclass_fields__})
    o, d, tm, bg, bg_mode = _camera_rays(cfg, 1024, 5)
    _grads(integrator.trace_mis, jinteg.trace_mis, jscene, o, d, tm, bg,
           bg_mode, 10, nan_in_both=("sph_center",))


def test_trace_path_quad_geometry_gradient_matches_jax():
    """A view-filling Perlin-marble quad (the geometry case of
    test_diff.py): the gradient in the quad's frame and the marble's
    color through the hit point, at depth 3."""
    b = JaxSceneBuilder()
    wall = b.lambertian(tex=b.noise(0.7))
    b.add_quad((-60.0, -60.0, -3.0), (120.0, 0.0, 0.0), (0.0, 120.0, 0.0),
               wall)
    cfg = RenderConfig(aspect_ratio=2.0, image_width=24, max_depth=3,
                       vfov=90.0, lookfrom=(0, 0, 0), lookat=(0, 0, -1))
    o, d, tm, bg, bg_mode = _camera_rays(cfg, 1024, 9)
    _grads(integrator.trace_path, jinteg.trace_path, b.build(), o, d, tm, bg,
           bg_mode, 3, names=("quad_q",))

"""The port's silhouette warp (``ops/warp.py``) and the differentiable
path's inner unit (``render.trace_rays_diff`` + ``render.splat_terms``)
against the JAX package on the CPU, with the same inputs: jitter draws
and pixels made with NumPy, or the JAX package's own uniforms injected.

Tolerances: the splat weights and the warped rays' values bitwise (the
same float32 ops; the warp is 0 and det 1 in value); gradients in theta
within rtol 1e-3 plus an atol of 1e-4 of the array's largest entry (the
discriminant's products run in another order: the JAX package's HIGHEST
dots against the port's written-out multiply-adds; an entry that is a sum
over many rays of both signs keeps its terms' rounding).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import render as jrender  # noqa: E402
from rustraytrace_tpu.config import RenderConfig as JaxRenderConfig  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.ops import rng as jrng  # noqa: E402
from rustraytrace_tpu.ops import warp as jwarp  # noqa: E402
from rustraytrace_tpu.scene import SceneBuilder as JaxSceneBuilder  # noqa: E402
from rustraytrace_tpu_torch import RenderConfig, camera, render  # noqa: E402
from rustraytrace_tpu_torch import scene_from_numpy  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import warp  # noqa: E402

NAMES = ("sph_center", "tex_color1")
EXAMPLE = dict(aspect_ratio=16 / 9, image_width=64, max_depth=4, vfov=60.0,
               lookfrom=(0, 0.3, 0.6), lookat=(0, 0, -1))
# a defocused camera (the disk origin) for the stratified case
DEFOCUS = dict(EXAMPLE, defocus_angle=2.0, focus_dist=1.5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _example_jscene():
    b = JaxSceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.6, 0.6, 0.6)))
    b.add_sphere((0.12, -0.1, -1.25), 0.5, b.lambertian((0.2, 0.5, 0.7)))
    b.add_sphere((1.2, 0.0, -1.4), 0.4, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.build()


def _port_scene(jscene):
    fields = {f: np.asarray(getattr(jscene, f))
              for f in jscene.__dataclass_fields__ if f != "features"}
    fields["features"] = tuple(jscene.features)
    return scene_from_numpy(fields)


def _cams(kw):
    return jax_derive_camera(JaxRenderConfig(**kw)), derive_camera(
        RenderConfig(**kw), "cpu")


def _close_grad(got, want, name):
    assert np.all(np.isfinite(want)) and np.abs(want).max() > 0.0, name
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max(), err_msg=name)


def test_splat_weights_match_jax_bitwise():
    r = np.random.default_rng(5)
    u = r.uniform(-0.5, 0.5, (513, 2)).astype(np.float32)
    u[:4] = [[0.0, 0.0], [-0.0, 0.25], [0.5, -0.5], [-0.5, 0.0]]
    got = warp.splat_weights(_t(u))
    want = jwarp.splat_weights(jnp.asarray(u))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["box", "defocus_strata"])
def test_warped_primary_rays_match_jax(case):
    """Values bitwise (origin, direction, time, det, u_w), and the theta-
    gradient of a fixed contraction of det and u_w within the stated
    tolerance (the defocused case's values to 1e-6: the disk's sin and
    cos differ in the last bit); the no-warp rays equal the warped ones
    in value."""
    kw = EXAMPLE if case == "box" else DEFOCUS
    jcam, cam = _cams(kw)
    jscene = _example_jscene()
    scene = _port_scene(jscene)
    r = np.random.default_rng(11)
    R = 2048
    px = r.integers(0, 64, R).astype(np.float32)
    py = r.integers(0, 36, R).astype(np.float32)
    draws = r.uniform(size=(R, 5)).astype(np.float32)
    wdet = r.normal(size=R).astype(np.float32)
    wuw = r.normal(size=(R, 2)).astype(np.float32)
    s_idx = r.integers(0, 16, R)
    strat = camera.strata(_t(s_idx), case != "box", 4)
    jstrat = None if case == "box" else jrender._strat_tuple(
        jnp.asarray(s_idx), True, 4)

    def jrays(p):
        return jwarp.warped_primary_rays(
            dataclasses.replace(jscene, **p), jcam, jnp.asarray(px),
            jnp.asarray(py), jnp.asarray(draws), jstrat)

    jp = {n: getattr(jscene, n) for n in NAMES}
    want = jrays(jp)
    params = {n: getattr(scene, n).clone().requires_grad_(True)
              for n in NAMES}
    got = warp.warped_primary_rays(dataclasses.replace(scene, **params), cam,
                                   _t(px), _t(py), _t(draws), strat)
    for g, w in zip(got, want):
        if case == "box":
            np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
        else:  # the disk origin's sin and cos differ in the last bit
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
    plain = warp.warped_primary_rays(scene, cam, _t(px), _t(py), _t(draws),
                                     strat, warp=False)
    for g, p in zip(got, plain):
        assert torch.equal(g.detach(), p)

    (got[3] * _t(wdet)).sum().backward(retain_graph=True)
    (got[4] * _t(wuw)).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jrays(p)[3] * wdet)
                  + jnp.sum(jrays(p)[4] * wuw))(jp)
    _close_grad(params["sph_center"].grad.numpy(),
                np.asarray(jg["sph_center"]), "sph_center")
    # texture colors do not enter the warp
    assert params["tex_color1"].grad is None or not torch.any(
        params["tex_color1"].grad)


def test_chunk_contraction_matches_jax_gradient():
    """The slice as a whole, deterministic: one chunk's contraction
    sum(rad * sum_4 w_i ct[p_i]) through ``trace_rays_diff`` and
    ``splat_terms`` with the JAX package's uniforms (camera and bounces),
    at BASELINE config 4's scene, camera and depth 4; its value and its
    gradient in ``sph_center`` and ``tex_color1`` against the same
    contraction in JAX."""
    jcam, cam = _cams(EXAMPLE)
    jscene = _example_jscene()
    scene = _port_scene(jscene)
    width, height, R = 64, 36, 2304
    r = np.random.default_rng(3)
    ct = r.normal(size=(height, width, 3)).astype(np.float32)
    pix = np.arange(R)
    px = (pix % width).astype(np.float32)
    py = (pix // width).astype(np.float32)
    valid = np.ones(R, np.float32)
    key_sc = jax.random.key(17)
    k_cam, k_path = jax.random.split(key_sc)
    cam_draws = _t(jax.random.uniform(k_cam, (R, 5), dtype=jnp.float32))

    def draws(bounce, n):
        return _t(jrng.uniforms(jax.random.fold_in(k_path, bounce), (R,), n))

    def jcontr(p):
        rad, u_w = jrender.trace_rays_diff(
            dataclasses.replace(jscene, **p), jcam, key_sc, 0,
            jnp.asarray(px), jnp.asarray(py), max_depth=4)
        ct_flat = jnp.asarray(ct).reshape(-1, 3)
        ct_eff = sum(w[:, None] * ct_flat[idx] for idx, w in
                     jrender.splat_terms(jnp.asarray(px), jnp.asarray(py),
                                         u_w, jnp.asarray(valid), width,
                                         height))
        return jnp.sum(rad * ct_eff)

    jp = {n: getattr(jscene, n) for n in NAMES}
    jval, jg = jax.value_and_grad(jcontr)(jp)
    params = {n: getattr(scene, n).clone().requires_grad_(True)
              for n in NAMES}
    rad, u_w = render.trace_rays_diff(
        dataclasses.replace(scene, **params), cam, 0, 0, _t(pix), _t(px),
        _t(py), max_depth=4, cam_draws=cam_draws, draws=draws)
    ct_flat = _t(ct).reshape(-1, 3)
    terms = render.splat_terms(_t(px), _t(py), u_w, _t(valid), width, height)
    jterms = jrender.splat_terms(jnp.asarray(px), jnp.asarray(py),
                                 jnp.asarray(u_w.detach().numpy()),
                                 jnp.asarray(valid), width, height)
    for (i, w), (ji, jw) in zip(terms, jterms):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(w.detach().numpy(), np.asarray(jw))
    val = sum((rad * w[:, None] * ct_flat[i]).sum() for i, w in terms)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-4)
    for n in NAMES:
        _close_grad(params[n].grad.numpy(), np.asarray(jg[n]), n)


def test_box_unit_matches_jax_gradient():
    """The box-filtered unit (``render.trace_rays``, the contraction with
    ``warp_primary=False``) with the JAX package's uniforms: >= 99% of
    rays within 1e-4 (the integrators' tolerance; measured: all but 1 of
    2,304), and the gradient of sum(rad * ct) over those rays against
    JAX's."""
    jcam, cam = _cams(EXAMPLE)
    jscene = _example_jscene()
    scene = _port_scene(jscene)
    R = 2304
    r = np.random.default_rng(4)
    ct = r.normal(size=(R, 3)).astype(np.float32)
    pix = np.arange(R)
    px = (pix % 64).astype(np.float32)
    py = (pix // 64).astype(np.float32)
    key_sc = jax.random.key(23)
    k_cam, k_path = jax.random.split(key_sc)
    cam_draws = _t(jax.random.uniform(k_cam, (R, 5), dtype=jnp.float32))

    def draws(bounce, n):
        return _t(jrng.uniforms(jax.random.fold_in(k_path, bounce), (R,), n))

    def jrad(p):
        return jrender.trace_rays(dataclasses.replace(jscene, **p), jcam,
                                  key_sc, 0, jnp.asarray(px),
                                  jnp.asarray(py), max_depth=4)

    jp = {n: getattr(jscene, n) for n in NAMES}
    params = {n: getattr(scene, n).clone().requires_grad_(True)
              for n in NAMES}
    rad = render.trace_rays(dataclasses.replace(scene, **params), cam, 0, 0,
                            _t(pix), _t(px), _t(py), max_depth=4,
                            cam_draws=cam_draws, draws=draws)
    want = np.asarray(jrad(jp))
    # as in test_torch_reference.py: a ray may turn another way after a
    # last-bit difference in t; the contraction runs over the rest
    ok = np.all(np.abs(rad.detach().numpy() - want)
                <= 1e-4 * (1.0 + np.abs(want)), axis=-1)
    assert ok.mean() >= 0.99, ok.mean()
    ct = ct * ok[:, None]
    jval, jg = jax.value_and_grad(lambda p: jnp.sum(jrad(p) * ct))(jp)
    val = (rad * _t(ct)).sum()
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-4)
    for n in NAMES:
        _close_grad(params[n].grad.numpy(), np.asarray(jg[n]), n)

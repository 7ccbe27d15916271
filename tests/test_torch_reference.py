"""The port's reference render path against the JAX package on the CPU:
rng transforms, camera, Perlin, textures, intersection, materials, the
light pdf and sample, ``trace_path`` and ``trace_mis`` with the JAX
package's own uniforms injected, and whole renders on the reference route
against JAX ``render_pass(backend="xla")``.  Inputs are made from a seed
with NumPy and handed to both packages.

Tolerances: rtol 1e-5 / atol 1e-6 for the smooth functions (float32 ops
in another order); closest hit: class and index equal on >= 99.9% of rays
and |dt| <= 1e-2 (the expanded quadric cancels on the r = 1000 ground);
integrators: >= 99% of rays within 1e-4 (absolute plus relative) and the
means within 1e-3 relative (a ray may take another branch after a
last-bit difference in t); renders: channel means within 0.02 and a 4x4
block grid within 5 standard errors (independent random streams).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import camera as jcamera  # noqa: E402
from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu import render as jrender  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.ops import integrator as jinteg  # noqa: E402
from rustraytrace_tpu.ops import intersect as jisect  # noqa: E402
from rustraytrace_tpu.ops import materials as jmat  # noqa: E402
from rustraytrace_tpu.ops import perlin as jperlin  # noqa: E402
from rustraytrace_tpu.ops import rng as jrng  # noqa: E402
from rustraytrace_tpu.ops import textures as jtex  # noqa: E402
from rustraytrace_tpu.scene import SceneBuilder as JaxSceneBuilder  # noqa: E402
from rustraytrace_tpu_torch import (RenderConfig, SceneBuilder, camera,  # noqa: E402
                                    models, render, scene_from_numpy)
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import integrator, intersect, materials  # noqa: E402
from rustraytrace_tpu_torch.ops import perlin, rng, textures  # noqa: E402
from torch_scenes import (IMAGE_MEDIUM_CFG, image_medium_scene,  # noqa: E402
                          smoke_mis_scene)

SMOOTH = dict(rtol=1e-5, atol=1e-6)
HIT_SCENES = ["book1_random_spheres", "book2_cornell_smoke",
              "book2_perlin_spheres", "book2_earth", "book3_cornell_box",
              "book2_final_scene"]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or SMOOTH))


def _scenes(name):
    """(JAX scene, port scene converted from its arrays, JAX config)."""
    jscene, jcfg, _ = jmodels.get_scene(name, dict(image_width=32))
    fields = {f: np.asarray(getattr(jscene, f))
              for f in jscene.__dataclass_fields__ if f != "features"}
    fields["features"] = tuple(jscene.features)
    return jscene, scene_from_numpy(fields), jcfg


def _rays(name, n, seed):
    """Seeded rays aimed into each scene's view (NumPy, float32)."""
    rng_ = np.random.default_rng(seed)
    _, _, jcfg = _scenes(name)
    eye = np.asarray(jcfg.lookfrom, np.float64)
    at = np.asarray(jcfg.lookat, np.float64)
    span = max(np.linalg.norm(at - eye), 1.0)
    o = eye + rng_.uniform(-0.05, 0.05, (n, 3)) * span
    d = (at + rng_.uniform(-0.3, 0.3, (n, 3)) * span) - o
    t = rng_.uniform(size=n)
    return o.astype(np.float32), d.astype(np.float32), t.astype(np.float32)


# ---------------------------------------------------------------- module 1


def test_rng_transforms_match_jax():
    r = np.random.default_rng(0)
    u1, u2 = (r.uniform(size=4096).astype(np.float32) for _ in range(2))
    rad = r.uniform(0.1, 2.0, 4096).astype(np.float32)
    dist2 = (rad * rad * r.uniform(1.1, 50.0, 4096)).astype(np.float32)
    n = r.normal(size=(4096, 3)).astype(np.float32)
    n[:8] = [[1, 0, 0], [0.95, 0.1, 0.0], [-1, 0, 0], [0, 1, 0],
             [0, 0, -1], [0.9, 0.43, 0.0], [0.91, 0, 0.4], [0.5, 0.5, 0.5]]
    loc = r.normal(size=(4096, 3)).astype(np.float32)
    for name, args in (("unit_vector", (u1, u2)), ("in_unit_disk", (u1, u2)),
                       ("cosine_direction", (u1, u2)),
                       ("to_sphere", (u1, u2, rad, dist2))):
        _close(getattr(rng, name)(*map(_t, args)),
               getattr(jrng, name)(*map(jnp.asarray, args)))
    basis = rng.onb_from_w(_t(n))
    jbasis = jrng.onb_from_w(jnp.asarray(n))
    for got, want in zip(basis, jbasis):
        _close(got, want)
    _close(rng.onb_transform(*basis, _t(loc)),
           jrng.onb_transform(*jbasis, jnp.asarray(loc)))


def test_uniforms_are_keyed_by_pixel_and_stream():
    """The reference route's draws: a ray's columns depend only on its
    pixel (any subset gives the same values), in [0, 1), and column c is
    word c % 4 of stream streams[c // 4]."""
    key = rng.seed_key(7)
    pix = torch.arange(1000)
    streams = (rng.STREAM_BOUNCE, rng.STREAM_MEDIA, rng.STREAM_MEDIA + 1)
    full = rng.uniforms(pix, 3, 2, streams, 10, key)
    assert full.shape == (1000, 10)
    assert float(full.min()) >= 0.0 and float(full.max()) < 1.0
    part = rng.uniforms(pix[123:456], 3, 2, streams, 10, key)
    assert torch.equal(part, full[123:456])
    words = rng.uniforms4(pix, 3, 2, rng.STREAM_MEDIA + 1, key)
    assert torch.equal(full[:, 8], words[0]) and torch.equal(full[:, 9],
                                                             words[1])
    assert not torch.equal(full, rng.uniforms(pix, 4, 2, streams, 10, key))


# ---------------------------------------------------------------- module 2


@pytest.mark.parametrize("stratified", [False, True])
def test_generate_rays_matches_jax(stratified):
    """book1_random_spheres has a defocus disk; strata of sample 11 on a
    4x4 grid."""
    over = dict(image_width=48)
    _, jcfg, _ = jmodels.book1_random_spheres(over)
    _, cfg, _ = models.book1_random_spheres(over)
    r = np.random.default_rng(3)
    n = 48 * 27
    px = (np.arange(n) % 48).astype(np.float32)
    py = (np.arange(n) // 48).astype(np.float32)
    draws = r.uniform(size=(n, 5)).astype(np.float32)
    jstrat = jrender._strat_tuple(jnp.int32(11), stratified, 4)
    want = jcamera.generate_rays(jax_derive_camera(jcfg), jnp.asarray(px),
                                 jnp.asarray(py), jnp.asarray(draws), jstrat)
    got = camera.generate_rays(derive_camera(cfg, "cpu"), _t(px), _t(py),
                               _t(draws), camera.strata(11, stratified, 4))
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------ modules 3, 4


def test_perlin_noise_and_turb_match_jax():
    jscene, scene, _ = _scenes("book2_perlin_spheres")
    p = np.random.default_rng(4).uniform(-20, 20, (4096, 3)).astype(
        np.float32)
    _close(perlin.noise(_t(p), scene.perlin_randvec, scene.perlin_perm),
           jperlin.noise(jnp.asarray(p), jscene.perlin_randvec,
                         jscene.perlin_perm))
    _close(perlin.turb(_t(p), scene.perlin_randvec, scene.perlin_perm),
           jperlin.turb(jnp.asarray(p), jscene.perlin_randvec,
                        jscene.perlin_perm), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["book2_perlin_spheres", "book2_earth",
                                  "book2_checkered_spheres",
                                  "book2_final_scene"])
def test_texture_value_matches_jax(name):
    """Every texture of the scene at seeded (u, v, p); checker parity
    equal unless p lies within 1e-4 of a cell face."""
    jscene, scene, _ = _scenes(name)
    r = np.random.default_rng(5)
    n = 4096
    tex = r.integers(0, scene.tex_kind.shape[0], n).astype(np.int32)
    u, v = (r.uniform(-0.1, 1.1, n).astype(np.float32) for _ in range(2))
    p = r.uniform(-8, 8, (n, 3)).astype(np.float32)
    got = textures.texture_value(_t(tex), _t(u), _t(v), _t(p), scene)
    want = jtex.texture_value(jnp.asarray(tex), jnp.asarray(u),
                              jnp.asarray(v), jnp.asarray(p), jscene)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    texel = textures.image_texel(scene, torch.zeros(n, dtype=torch.int32),
                                 _t(u), _t(v))
    np.testing.assert_array_equal(texel.numpy(), np.asarray(jtex.image_texel(
        jscene, jnp.zeros(n, jnp.int32), jnp.asarray(u), jnp.asarray(v))))


# ---------------------------------------------------------------- module 5


def test_sphere_uv_and_refine_match_jax():
    r = np.random.default_rng(6)
    n = r.normal(size=(4096, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]
    n = n.astype(np.float32)
    for g, w in zip(intersect.sphere_uv(_t(n)),
                    jisect.sphere_uv(jnp.asarray(n))):
        _close(g, w)


@pytest.mark.parametrize("name", HIT_SCENES)
def test_closest_hit_matches_jax(name):
    """Per class (spheres, quads, boxes): hit flag and winner index equal
    on >= 99.9% of rays; the merged record: valid, material and front face
    equal and |dt| <= 1e-2 on >= 99.9%, the normal within 1e-3 there;
    media with the same free-flight uniforms."""
    jscene, scene, _ = _scenes(name)
    o, d, tm = _rays(name, 2048, 8)
    nm = integrator.n_media(scene)
    um = np.random.default_rng(9).uniform(size=(2048, nm)).astype(np.float32)
    tmin = np.full(2048, intersect.T_MIN, np.float32)
    tmax = np.full(2048, intersect.T_MAX, np.float32)
    J = [jnp.asarray(x) for x in (o, d, tm, tmin, tmax)]
    T = [_t(x) for x in (o, d, tm, tmin, tmax)]
    pairs = [(intersect.hit_spheres(T[0], T[1], T[2], scene, T[3], T[4]),
              jisect.hit_spheres(J[0], J[1], J[2], jscene, J[3], J[4])),
             (intersect.hit_quads(T[0], T[1], scene, T[3], T[4]),
              jisect.hit_quads(J[0], J[1], jscene, J[3], J[4])),
             (intersect.hit_boxes(T[0], T[1], scene, T[3], T[4]),
              jisect.hit_boxes(J[0], J[1], jscene, J[3], J[4]))]
    for (tg, ig, ag), (tw, iw, aw) in pairs:
        ag, aw = ag.numpy(), np.asarray(aw)
        assert (ag == aw).mean() >= 0.999
        both = ag & aw
        if both.any():
            assert (ig.numpy()[both] == np.asarray(iw)[both]).mean() >= 0.999
    got = intersect.closest_hit(T[0], T[1], T[2], scene, _t(um))
    want = jisect.closest_hit(J[0], J[1], J[2], jscene, jnp.asarray(um))
    valid = got.valid.numpy()
    assert valid.mean() > 0.2
    assert (valid == np.asarray(want.valid)).mean() >= 0.999
    same = ((valid == np.asarray(want.valid))
            & (got.mat.numpy() == np.asarray(want.mat))
            & (got.front_face.numpy() == np.asarray(want.front_face))
            & (np.abs(got.t.numpy() - np.asarray(want.t)) <= 1e-2))
    assert same.mean() >= 0.999, same.mean()
    hits = same & valid
    np.testing.assert_allclose(got.normal.numpy()[hits],
                               np.asarray(want.normal)[hits], atol=1e-3)


def test_hit_media_matches_jax():
    jscene, scene, _ = _scenes("book2_cornell_smoke")
    o, d, _ = _rays("book2_cornell_smoke", 4096, 10)
    nm = integrator.n_media(scene)
    um = np.random.default_rng(11).uniform(size=(4096, nm)).astype(
        np.float32)
    tb = np.random.default_rng(12).uniform(100, 2000, 4096).astype(
        np.float32)
    tmin = np.full(4096, intersect.T_MIN, np.float32)
    tg, mg, hg = intersect.hit_media(_t(o), _t(d), scene, _t(tmin), _t(tb),
                                     _t(um))
    tw, mw, hw = jisect.hit_media(jnp.asarray(o), jnp.asarray(d), jscene,
                                  jnp.asarray(tmin), jnp.asarray(tb),
                                  jnp.asarray(um))
    assert hg.numpy().mean() > 0.1
    assert (hg.numpy() == np.asarray(hw)).mean() >= 0.999
    assert (mg.numpy() == np.asarray(mw)).mean() >= 0.999
    assert np.abs(tg.numpy() - np.asarray(tw)).max() <= 1e-2


# ---------------------------------------------------------------- module 6


@pytest.mark.parametrize("name,front_only", [
    ("book1_random_spheres", False), ("book2_cornell_smoke", False),
    ("book3_cornell_box", True), ("book2_simple_light", False)])
def test_scatter_matches_jax(name, front_only):
    """Lambertian, metal, dielectric, light and isotropic on one hit
    record (the JAX package's), the same draws."""
    jscene, scene, _ = _scenes(name)
    o, d, tm = _rays(name, 4096, 13)
    nm = integrator.n_media(scene)
    um = np.random.default_rng(14).uniform(size=(4096, nm)).astype(
        np.float32)
    jrec = jisect.closest_hit(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tm), jscene, jnp.asarray(um))
    rec = intersect.HitRecord(**{
        f: _t(getattr(jrec, f)) for f in ("valid", "t", "p", "normal",
                                          "front_face", "mat", "u", "v")})
    jm = jmat.gather_mat(jscene, jrec)
    m = materials.gather_mat(scene, rec)
    for f in ("kind", "albedo", "fuzz", "ior"):
        _close(getattr(m, f), getattr(jm, f))
    draws = np.random.default_rng(15).uniform(size=(4096, 3)).astype(
        np.float32)
    for absorb in (True, False):
        got = materials.scatter(_t(d), rec, m, _t(draws), front_only, absorb)
        want = jmat.scatter(jnp.asarray(d), jrec, jm, jnp.asarray(draws),
                            front_only, absorb)
        for f in ("direction", "attenuation", "emitted"):
            _close(getattr(got, f), getattr(want, f), rtol=1e-5, atol=1e-5)
        for f in ("scattered", "specular", "is_lambertian"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


# ---------------------------------------------------------------- module 8


def _sphere_light_scene(builder_cls):
    """Two NEE lights, a quad and a sphere, over a lambertian floor."""
    b = builder_cls()
    b.add_quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian((.6,) * 3))
    b.add_quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((5,) * 3))
    b.add_sphere((2, 2, 0), 0.5, b.diffuse_light((8,) * 3))
    b.add_sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.add_light_quad((-1, 4, -1), (2, 0, 0), (0, 0, 2))
    b.add_light_sphere((2, 2, 0), 0.5)
    return b.build()


def test_light_pdf_and_sample_match_jax():
    jscene = _sphere_light_scene(JaxSceneBuilder)
    scene = _sphere_light_scene(SceneBuilder)
    r = np.random.default_rng(16)
    p = (r.uniform(-3, 3, (4096, 3)) * [1, 0, 1] + [0, 0.01, 0]).astype(
        np.float32)
    draws = r.uniform(size=(4096, 3)).astype(np.float32)
    got = integrator._light_sample(_t(p), scene, _t(draws))
    want = jinteg._light_sample(jnp.asarray(p), jscene, jnp.asarray(draws))
    _close(got, want, rtol=1e-5, atol=1e-5)
    d = np.concatenate([np.asarray(want)[:2048],
                        r.normal(size=(2048, 3))]).astype(np.float32)
    pg = integrator._light_pdf_value(_t(p), _t(d), scene)
    pw = jinteg._light_pdf_value(jnp.asarray(p), jnp.asarray(d), jscene)
    assert (pg.numpy() > 0).mean() > 0.4
    _close(pg, pw, rtol=1e-5, atol=1e-6)


def _jax_draws(key, R):
    """The JAX integrators' per-bounce uniforms as a port draw source."""
    def draws(bounce, n):
        return _t(jrng.uniforms(jax.random.fold_in(key, bounce), (R,), n))
    return draws


def _integrator_case(trace, jtrace, jscene, scene, o, d, tm, bg, bg_mode,
                     depth, backend="reference"):
    key = jax.random.key(21)
    R = o.shape[0]
    opts = integrator.IntegratorOptions(max_depth=depth, bg_mode=bg_mode,
                                        backend=backend)
    got = trace(_jax_draws(key, R), _t(o), _t(d), _t(tm), scene, _t(bg),
                opts).numpy()
    jopts = jinteg.IntegratorOptions(
        max_depth=depth, bg_mode=bg_mode,
        backend="xla" if backend == "reference" else backend)
    # a Perlin scene op by op: XLA's fused sin loses accuracy at large
    # arguments (4.8e-4 at |x| ~ 5000 on the CPU), which the marble
    # reaches on the far ground; each op alone is accurate
    with jax.disable_jit("noise" in scene.features):
        want = np.asarray(jtrace(key, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tm), jscene, jnp.asarray(bg),
                                 jopts))
    ok = np.all(np.abs(got - want) <= 1e-4 * (1.0 + np.abs(want)), axis=-1)
    return got, want, ok


def _assert_integrator(got, want, ok):
    print(f"rays within 1e-4: {ok.mean():.4f}; mean ratio "
          f"{got.mean() / want.mean() - 1.0:.2e}")
    assert ok.mean() >= 0.99, ok.mean()
    assert want.mean() > 0.0
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0),
                               rtol=1e-3)


@pytest.mark.parametrize("name,depth", [
    ("book1_random_spheres", 6), ("book2_cornell_smoke", 6),
    ("book2_perlin_spheres", 2), ("book2_earth", 6)])
def test_trace_path_matches_jax_with_its_uniforms(name, depth):
    """Measured here at 512 rays: 100% of rays within 1e-4 on every scene
    (the Perlin scene at depth 2: its JAX reference runs op by op, see
    _integrator_case)."""
    jscene, scene, jcfg = _scenes(name)
    o, d, tm = _rays(name, 512, 17)
    jcam = jax_derive_camera(jcfg)
    got, want, ok = _integrator_case(
        integrator.trace_path, jinteg.trace_path, jscene, scene, o, d, tm,
        np.asarray(jcam.background), jcam.bg_mode, depth)
    _assert_integrator(got, want, ok)


@pytest.mark.parametrize("case", ["book3_cornell_box", "smoke",
                                  "sphere_light"])
def test_trace_mis_matches_jax_with_its_uniforms(case):
    """Quad lights, the isotropic branch and a sphere light; measured
    here at 512 rays, depth 6: 100% of rays within 1e-4."""
    if case == "book3_cornell_box":
        jscene, scene, jcfg = _scenes(case)
        o, d, tm = _rays(case, 512, 18)
    else:
        build = (smoke_mis_scene if case == "smoke"
                 else _sphere_light_scene)
        jscene, scene = build(JaxSceneBuilder), build(SceneBuilder)
        r = np.random.default_rng(19)
        eye = np.asarray([278.0, 278.0, -800.0] if case == "smoke"
                         else [0.0, 2.0, 8.0])
        at = np.asarray([278.0, 278.0, 0.0] if case == "smoke"
                        else [0.0, 1.0, 0.0])
        o = np.broadcast_to(eye, (512, 3)).astype(np.float32)
        d = (at + r.uniform(-0.5, 0.5, (512, 3)) * np.linalg.norm(at - eye)
             - eye).astype(np.float32)
        tm = r.uniform(size=512).astype(np.float32)
    got, want, ok = _integrator_case(
        integrator.trace_mis, jinteg.trace_mis, jscene, scene, o, d, tm,
        np.zeros(3, np.float32), 1, 6)
    _assert_integrator(got, want, ok)


def test_sky_color_and_n_media_match_jax():
    d = np.random.default_rng(20).normal(size=(512, 3)).astype(np.float32)
    _close(integrator.sky_color(_t(d)), jinteg.sky_color(jnp.asarray(d)))
    for name in ("book2_cornell_smoke", "book2_final_scene"):
        jscene, scene, _ = _scenes(name)
        assert integrator.n_media(scene) == jinteg.n_media(jscene)


# ---------------------------------------------------------------- module 9


def _block_agreement(got, ref):
    h, w = got.shape[:2]
    err = np.abs(got.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
    assert err.max() < 0.02, (got.mean(axis=(0, 1)), ref.mean(axis=(0, 1)))
    diff = got - ref
    for ys in np.array_split(np.arange(h), 4):
        for xs in np.array_split(np.arange(w), 4):
            blk = diff[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1].reshape(-1, 3)
            se = blk.std(axis=0, ddof=1) / np.sqrt(blk.shape[0])
            assert np.all(np.abs(blk.mean(axis=0)) < 5 * se + 1e-6), (
                ys[0], xs[0], blk.mean(axis=0), se)


@pytest.mark.parametrize("name,width,spp,depth", [
    ("book1_three_spheres", 40, 8, 6), ("book3_cornell_box", 24, 4, 6)])
def test_render_image_reference_matches_jax_xla(name, width, spp, depth):
    over = dict(image_width=width, samples_per_pixel=spp, max_depth=depth,
                stratified=False)
    jscene, jcfg, integ = jmodels.get_scene(name, over)
    scene, cfg, _ = models.get_scene(name, over)
    h = cfg.image_height
    ref = np.asarray(jrender.render_pass(
        jscene, jax_derive_camera(jcfg), jax.random.key(0), width=width,
        height=h, spp=spp, max_depth=depth, integrator=integ,
        backend="xla", chunk=4096)) / spp
    assert render.resolve_backend(scene, integ, "xla") == "reference"
    img, state = render.render_image(scene, cfg, integrator=integ,
                                     backend="xla", device="cpu")
    assert state["spp_done"] == spp and img.shape == (h, width, 3)
    got = state["accum"] / spp
    assert np.all(np.isfinite(got))
    _block_agreement(got, ref)


def test_reference_route_does_not_depend_on_chunk_size():
    """Bitwise, on the textured, media and motion scene (the draws are
    keyed by pixel; every sum runs in one order)."""
    scene, cfg, _ = models.get_scene("book2_final_scene", dict(
        image_width=20, samples_per_pixel=2, max_depth=4))
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=20, height=20, spp=2, max_depth=4, device="cpu",
              backend="reference")
    a = render.render_pass(scene, cam, 3, chunk=400, **kw)
    b = render.render_pass(scene, cam, 3, chunk=128, **kw)
    assert float(a.sum()) > 0
    assert torch.equal(a, b)


def test_reference_route_resumes():
    scene, cfg, _ = models.book1_three_spheres(dict(
        image_width=24, samples_per_pixel=6, max_depth=4, spp_per_pass=2))
    seen = []
    _, full = render.render_image(scene, cfg, backend="reference",
                                  on_pass=seen.append, device="cpu")
    assert [s["spp_done"] for s in seen] == [2, 4, 6]
    _, resumed = render.render_image(
        scene, cfg, backend="reference", device="cpu",
        accum_state={"accum": seen[0]["accum"].numpy(), "spp_done": 2})
    np.testing.assert_array_equal(resumed["accum"], full["accum"])


def test_on_pass_gets_a_host_copy():
    """render_image hands on_pass a CPU copy of the running sum, which
    np.asarray reads as it reads the JAX package's array; changing it
    leaves the render alone."""
    scene, cfg, _ = models.book1_three_spheres(dict(
        image_width=16, samples_per_pixel=4, max_depth=4, spp_per_pass=2))
    seen = []

    def grab(state):
        seen.append(np.asarray(state["accum"]).copy())
        assert state["accum"].device.type == "cpu"
        state["accum"].zero_()

    _, full = render.render_image(scene, cfg, backend="reference",
                                  on_pass=grab, device="cpu")
    assert len(seen) == 2 and seen[1].shape == (9, 16, 3)
    np.testing.assert_array_equal(seen[1], full["accum"])
    assert float(seen[0].sum()) > 0


def test_formerly_raising_scenes_route_and_render_on_auto():
    """An image-textured medium (path) takes the sphere_kernel route and a
    'mis' scene without NEE lights the reference route, as the JAX package
    sends them off the TPU; both render.  The kernel routes, asked for by
    name, still raise."""
    med = image_medium_scene(SceneBuilder)
    jmed = image_medium_scene(JaxSceneBuilder)
    box, bcfg, _ = models.book2_cornell_box(dict(
        image_width=16, samples_per_pixel=2, max_depth=4))
    jbox, _, _ = jmodels.book2_cornell_box()
    assert render.resolve_backend(med, "path") == "sphere_kernel"
    assert jrender.resolve_backend(jmed, "path") == "sphere_kernel"
    assert render.resolve_backend(box, "mis") == "reference"
    assert jrender.resolve_backend(jbox, "mis") == "xla"
    for backend in ("wavefront", "megakernel", "plain"):
        with pytest.raises(NotImplementedError, match="image-textured"):
            render.resolve_backend(med, "path", backend)
    cfg = RenderConfig(image_width=16, samples_per_pixel=2, max_depth=4,
                       **IMAGE_MEDIUM_CFG)
    for scene, c, integ in ((med, cfg, "path"), (box, bcfg, "mis")):
        img, st = render.render_image(scene, c, integrator=integ,
                                      device="cpu")
        acc = st["accum"] / st["spp_done"]
        assert np.isfinite(acc).all() and acc.mean() > 0.0

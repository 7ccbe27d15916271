"""The sphere_kernel route against the JAX package on the CPU:
``hit.closest_hit_spheres`` (K1's plain twin on CPU tensors) against JAX
``closest_hit_spheres_pallas(..., interpret=True)``, ``trace_path`` on the
route with the JAX package's uniforms, whole renders against JAX
``render_pass(backend="xla")``, and the routing rule of ``resolve_backend``
against the JAX package's off the TPU.

Tolerances: hit flag, material and front face equal on >= 99.9% of rays
and |dt| <= 1e-2 (the JAX side adds the expanded quadric's rounding);
integrator >= 99% of rays within 1e-4 (absolute plus relative), means
within 1e-3 relative; renders: channel means within 0.02, a 4x4 block
grid within 5 standard errors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu import render as jrender  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.ops import integrator as jinteg  # noqa: E402
from rustraytrace_tpu.ops import pallas_hit as jhit  # noqa: E402
from rustraytrace_tpu.ops import rng as jrng  # noqa: E402
from rustraytrace_tpu_torch import models, render, scene_from_numpy  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import _cuda, hit, integrator, intersect  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _scenes(name):
    jscene, jcfg, _ = jmodels.get_scene(name, dict(image_width=32))
    fields = {f: np.asarray(getattr(jscene, f))
              for f in jscene.__dataclass_fields__ if f != "features"}
    fields["features"] = tuple(jscene.features)
    return jscene, scene_from_numpy(fields), jcfg


def _rays(jcfg, n, seed):
    r = np.random.default_rng(seed)
    eye = np.asarray(jcfg.lookfrom, np.float64)
    at = np.asarray(jcfg.lookat, np.float64)
    span = max(np.linalg.norm(at - eye), 1.0)
    o = eye + r.uniform(-0.05, 0.05, (n, 3)) * span
    d = (at + r.uniform(-0.3, 0.3, (n, 3)) * span) - o
    return (o.astype(np.float32), d.astype(np.float32),
            r.uniform(size=n).astype(np.float32))


@pytest.mark.parametrize("name", ["book1_random_spheres",
                                  "book2_bouncing_spheres",
                                  "book2_cornell_smoke", "book2_earth"])
def test_closest_hit_spheres_matches_jax_pallas(name):
    """Spheres; motion and checker; quads and media (the same free-flight
    uniforms); an image texture."""
    jscene, scene, jcfg = _scenes(name)
    n = 1024
    o, d, tm = _rays(jcfg, n, 3)
    nm = integrator.n_media(scene)
    um = np.random.default_rng(4).uniform(size=(n, nm)).astype(np.float32)
    assert hit.sphere_kernel_eligible(scene) == jhit.sphere_kernel_eligible(
        jscene)
    rec, mat = hit.closest_hit_spheres(_t(o), _t(d), _t(tm), scene,
                                       u_media=_t(um))
    jrec, jmat = jhit.closest_hit_spheres_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jscene,
        u_media=jnp.asarray(um), interpret=True)
    valid = rec.valid.numpy()
    assert valid.mean() > 0.2
    same = ((valid == np.asarray(jrec.valid))
            & (rec.mat.numpy() == np.asarray(jrec.mat))
            & (rec.front_face.numpy() == np.asarray(jrec.front_face))
            & (np.abs(rec.t.numpy() - np.asarray(jrec.t)) <= 1e-2))
    assert same.mean() >= 0.999, same.mean()
    h = same & valid
    np.testing.assert_array_equal(mat.kind.numpy()[h],
                                  np.asarray(jmat.kind)[h])
    for got, want in ((rec.normal, jrec.normal), (mat.albedo, jmat.albedo)):
        # t within 1e-2 moves p by |d| dt, the normal and a checker's
        # parity with it (measured here: >= 97.7% within 1e-3)
        near = np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-3,
                      axis=-1)[h]
        assert near.mean() >= 0.97, near.mean()


def test_closest_hit_spheres_takes_the_hit_function():
    """The route's closest-hit step is the argument: the twin by name
    gives the same records as the default (K1's twin on the CPU), and the
    default counts no kernel launch on CPU tensors."""
    _, scene, jcfg = _scenes("book1_random_spheres")
    o, d, tm = (_t(x) for x in _rays(jcfg, 512, 5))
    before = _cuda.launch_counts()["sphere_hit"]
    a, _ = hit.closest_hit_spheres(o, d, tm, scene)
    b, _ = hit.closest_hit_spheres(o, d, tm, scene,
                                   hit_fn=hit.sphere_hit_plain)
    assert _cuda.launch_counts()["sphere_hit"] == before
    assert torch.equal(a.t, b.t) and torch.equal(a.normal, b.normal)


def test_trace_path_sphere_kernel_matches_jax_with_its_uniforms():
    """The route against JAX trace_path(backend='sphere_kernel') in Pallas
    interpret mode, the JAX package's uniforms injected; measured here:
    100% of 512 rays within 1e-4 at depth 4."""
    jscene, scene, jcfg = _scenes("book1_random_spheres")
    o, d, tm = _rays(jcfg, 512, 6)
    key = jax.random.key(8)
    jcam = jax_derive_camera(jcfg)

    def draws(bounce, n):
        return _t(jrng.uniforms(jax.random.fold_in(key, bounce), (512,), n))

    opts = integrator.IntegratorOptions(max_depth=4, bg_mode=jcam.bg_mode,
                                        backend="sphere_kernel")
    got = integrator.trace_path(draws, _t(o), _t(d), _t(tm), scene,
                                _t(jcam.background), opts).numpy()
    want = np.asarray(jinteg.trace_path(
        key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jscene,
        jcam.background, jinteg.IntegratorOptions(
            max_depth=4, bg_mode=jcam.bg_mode, backend="sphere_kernel")))
    ok = np.all(np.abs(got - want) <= 1e-4 * (1.0 + np.abs(want)), axis=-1)
    assert ok.mean() >= 0.99, ok.mean()
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0),
                               rtol=1e-3)


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


@pytest.mark.parametrize("name", ["book1_three_spheres", "book2_earth"])
def test_render_image_sphere_kernel_matches_jax_xla(name):
    over = dict(image_width=40, samples_per_pixel=8, max_depth=6)
    jscene, jcfg, _ = jmodels.get_scene(name, over)
    scene, cfg, _ = models.get_scene(name, over)
    h = cfg.image_height
    ref = np.asarray(jrender.render_pass(
        jscene, jax_derive_camera(jcfg), jax.random.key(0), width=40,
        height=h, spp=8, max_depth=6, backend="xla", chunk=4096)) / 8
    img, state = render.render_image(scene, cfg, backend="sphere_kernel",
                                     device="cpu")
    assert state["spp_done"] == 8 and img.shape == (h, 40, 3)
    got = state["accum"] / 8
    assert np.all(np.isfinite(got))
    _block_agreement(got, ref)


def test_sphere_kernel_and_reference_routes_share_their_draws():
    """Both routes key their draws by (pixel, sample, bounce, stream), so
    on a sphere scene they trace the same paths: pixels equal to 1e-4 but
    for rays whose t differs in the last bits (the reference route refines
    t by a Newton step), at depth 2 (measured here: 98.6% of pixels)."""
    scene, cfg, _ = models.book1_random_spheres(dict(
        image_width=32, samples_per_pixel=2, max_depth=2))
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=32, height=cfg.image_height, spp=2, max_depth=2,
              device="cpu")
    a = render.render_pass(scene, cam, 1, backend="sphere_kernel",
                           **kw).numpy()
    b = render.render_pass(scene, cam, 1, backend="reference", **kw).numpy()
    close = np.all(np.abs(a - b) <= 1e-4 * (1.0 + np.abs(b)), axis=-1)
    assert close.mean() >= 0.97, close.mean()


def test_auto_routes_as_the_jax_package_off_the_tpu(monkeypatch):
    """Scenes the kernels cover stay on them (a CUDA device: kernels; the
    CPU: their twins); the rest route as JAX resolve_backend does off the
    TPU: sphere_kernel for path when eligible, else the reference route
    (JAX 'xla')."""
    from rustraytrace_tpu.scene import SceneBuilder as JaxSceneBuilder
    from rustraytrace_tpu_torch import SceneBuilder
    from torch_scenes import image_medium_scene

    cornell, _, _ = models.book3_cornell_box()
    assert render.resolve_backend(cornell, "mis", device="cpu") == "plain"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert render.resolve_backend(cornell, "mis") == "megakernel"
    three, _, _ = models.book1_three_spheres()
    assert render.resolve_backend(three, "path") == "wavefront"
    # not covered by the kernels: the JAX package's own choice
    med, jmed = image_medium_scene(SceneBuilder), image_medium_scene(
        JaxSceneBuilder)
    box, _, _ = models.book2_cornell_box()
    jbox, _, _ = jmodels.book2_cornell_box()
    for s, js, integ in ((med, jmed, "path"), (box, jbox, "mis"),
                         (med, jmed, "mis")):
        want = jrender.resolve_backend(js, integ)
        assert render.resolve_backend(s, integ) == (
            "reference" if want == "xla" else want)
    assert render.resolve_backend(three, "path", "xla") == "reference"
    with pytest.raises(ValueError, match="sphere_kernel"):
        render.resolve_backend(cornell, "mis", "sphere_kernel")


def test_routes_differ_in_ground_self_hits():
    """Rays leaving the r = 1000 ground in Lambertian directions, from
    points rounded onto its surface: K1's direct-form quadric (the
    sphere_kernel route, as the JAX package's Pallas kernel) hits the
    ground again on ~0.4% of them past T_MIN, the reference route's
    expanded quadric (as the JAX package's XLA route) on none.  Both
    cancel in f32 at |c| ~ 1e6; the two routes' images differ by that
    much (measured on the card: channel means within 5e-4)."""
    scene, _, _ = models.book1_random_spheres()
    r = np.random.default_rng(0)
    n = 20000
    x, z = r.uniform(-12, 12, n), r.uniform(-12, 12, n)
    o = np.stack([x, -1000 + np.sqrt(1000.0 ** 2 - x * x - z * z), z], -1)
    u = r.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    d = (o - [0.0, -1000.0, 0.0]) / 1000.0 + u
    o, d = _t(o.astype(np.float32)), _t(d.astype(np.float32))
    t = torch.zeros(n)
    _, idx, hits = intersect.hit_spheres(
        o, d, t, scene, torch.full((n,), intersect.T_MIN),
        torch.full((n,), intersect.T_MAX))
    _, ik = hit.sphere_hit_plain(o, d, t, hit.pack_sphere_table(scene),
                                 torch.zeros((0, hit.Q_COLS)), False)
    direct = (ik == 0).float().mean().item()
    expanded = (hits & (idx == 0)).float().mean().item()
    assert 0.001 < direct < 0.01 and expanded < 0.2 * direct


def test_routes_differ_in_glass_sphere_self_hits():
    """The other way round on the Book-3 Cornell box's glass sphere (r =
    90): rays leaving its surface outward hit it again past T_MIN under the
    reference route's expanded quadric on ~0.5%, under K1's direct form on
    ~0.1% (the kernel routes K2-K5 share K1's form)."""
    scene, _, _ = models.book3_cornell_box()
    c = scene.sph_center[0].double().numpy()
    r = np.random.default_rng(1)
    n = 20000
    u = r.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = r.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    o = _t((c + float(scene.sph_radius[0]) * u).astype(np.float32))
    d = _t((u + v).astype(np.float32))
    t = torch.zeros(n)
    _, _, hits = intersect.hit_spheres(
        o, d, t, scene, torch.full((n,), intersect.T_MIN),
        torch.full((n,), intersect.T_MAX))
    _, ik = hit.sphere_hit_plain(o, d, t, hit.pack_sphere_table(scene),
                                 torch.zeros((0, hit.Q_COLS)), False)
    expanded = hits.float().mean().item()
    direct = (ik >= 0).float().mean().item()
    assert 0.002 < expanded < 0.02 and direct < 0.5 * expanded

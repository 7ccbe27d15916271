"""The port's quads, NEE/MIS pieces and stratified camera against the JAX
package: light and quad tables bit-equal, the new scene builders bit-equal,
and the plain quad intersector, light pdf, light samples and stratified
spawn against JAX's XLA functions on the same seeded inputs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu import native as jnative  # noqa: E402
from rustraytrace_tpu.camera import generate_rays  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.ops import integrator as jint  # noqa: E402
from rustraytrace_tpu.ops import intersect as jinter  # noqa: E402
from rustraytrace_tpu.ops import pallas_megakernel as jmk  # noqa: E402
from rustraytrace_tpu.render import _strat_tuple  # noqa: E402
from rustraytrace_tpu.scene import SceneBuilder as JaxSceneBuilder  # noqa: E402
from rustraytrace_tpu_torch import SceneBuilder, models  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import hit  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402

NEW_SCENES = ["book2_quads", "book2_cornell_box", "book3_cornell_box",
              "the_rest_of_your_life"]


def _jax_fields(scene) -> dict:
    out = {f.name: np.asarray(getattr(scene, f.name))
           for f in dataclasses.fields(scene) if f.name != "features"}
    out["features"] = tuple(scene.features)
    return out


@pytest.mark.parametrize("name", NEW_SCENES)
def test_new_scene_builders_bit_equal_jax(name):
    jscene, jcfg, jinteg = jmodels.get_scene(name)
    scene, cfg, integ = models.get_scene(name)
    assert integ == jinteg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ref = _jax_fields(jscene)
    got = scene.to_numpy()
    assert got["features"] == ref["features"]
    for key, want in ref.items():
        if key != "features":
            assert got[key].dtype == want.dtype, key
            np.testing.assert_array_equal(got[key], want, err_msg=key)


def test_light_table_bit_equal_jax():
    jscene, _, _ = jmodels.book3_cornell_box()
    scene, _, _ = models.book3_cornell_box()
    ref, n_ref = jmk.pack_light_table(jscene)
    got, n = mk.pack_light_table(scene)
    assert n == n_ref == 2
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["book3_cornell_box", "book2_cornell_box",
                                  "book2_quads"])
def test_quad_prepared_tables_equal_jax(name):
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load")
    jscene, jcfg, integ = jmodels.get_scene(name, dict(image_width=48))
    scene, cfg, _ = models.get_scene(name, dict(image_width=48))
    mis = integ == "mis"
    w, h = 48, cfg.image_height
    arrays, st = jmk.prepare_megakernel(
        jscene, jax_derive_camera(jcfg), width=w, height=h, spp=16,
        max_depth=8, interpret=True, segment=True, mis=mis,
        stratified=cfg.stratified, sqrt_spp=4 if cfg.stratified else 0)
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=w,
                                 height=h, mis=mis,
                                 stratified=cfg.stratified,
                                 sqrt_spp=4 if cfg.stratified else 0, device="cpu")
    np.testing.assert_array_equal(prep.geom.numpy(),
                                  np.asarray(arrays["tab"]).T)
    for k in ("qtab", "ltab", "cam_u", "bg", "clb", "cls"):
        np.testing.assert_array_equal(getattr(prep, k).numpy(),
                                      np.asarray(arrays[k]), k)
    assert (prep.n_quads, prep.n_lights, prep.unroll, prep.rows) == (
        st["n_quads"], st["n_lights"], st["unroll"], st["rows"])
    assert (prep.mis, prep.stratified, prep.sqrt_spp) == (
        st["mis"], st["stratified"], st["sqrt_spp"])


def _rays_in_box(n, seed):
    """Origins inside the Cornell box, directions all over the sphere."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(20.0, 535.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def test_quad_closest_hit_matches_jax_hit_quads():
    """Winners equal on every ray that hits; t within 1e-5 relative (JAX
    builds the frames in its own float order inside hit_quads)."""
    jscene, _, _ = jmodels.book2_cornell_box()
    scene, cfg, _ = models.book2_cornell_box(dict(image_width=32))
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=32,
                                 height=32, device="cpu")
    o, d = _rays_in_box(4096, 1)
    n = o.shape[0]
    t_ref, i_ref, any_ref = (np.asarray(x) for x in jinter.hit_quads(
        jnp.asarray(o), jnp.asarray(d), jscene, jnp.full(n, 1e-3),
        jnp.full(n, 1e9)))
    tq, okq = hit.quad_hits(prep.qtab[:prep.n_quads],
                            *(torch.from_numpy(np.ascontiguousarray(x))
                              for x in (*o.T[:, :, None], *d.T[:, :, None])))
    qt, qi = torch.min(torch.where(okq, tq, 1e30), dim=1)
    hits = qt.numpy() < 1e30
    assert hits.mean() > 0.8  # rays from inside a box open at the front
    np.testing.assert_array_equal(hits, any_ref)
    np.testing.assert_array_equal(qi.numpy()[hits], i_ref[hits])
    np.testing.assert_allclose(qt.numpy()[hits], t_ref[hits], rtol=1e-5)


def _points_and_dirs(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(20.0, 535.0, (n, 3)).astype(np.float32)
    target = np.where(rng.uniform(size=(n, 1)) < 0.5,
                      rng.uniform([213, 554, 227], [343, 554, 332], (n, 3)),
                      rng.normal([190, 90, 190], 60.0, (n, 3)))
    d = (target - p).astype(np.float32)
    return p, d


def _cols(a):
    return [torch.from_numpy(np.ascontiguousarray(a[:, k]))
            for k in range(a.shape[1])]


def test_light_pdf_matches_jax():
    """The mixture's light pdf (quad area and sphere solid-angle pdfs) on
    seeded (p, d), half aimed at the light quad and half at the sphere;
    1e-5 relative (JAX normalises d with sqrt, the port with 1/sqrt)."""
    jscene, _, _ = jmodels.book3_cornell_box()
    scene, cfg, _ = models.book3_cornell_box(dict(image_width=32))
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=32,
                                 height=32, mis=True, device="cpu")
    p, d = _points_and_dirs(4096, 2)
    ref = np.asarray(jint._light_pdf_value(jnp.asarray(p), jnp.asarray(d),
                                           jscene))
    gx, gy, gz = _cols(d)
    g2 = torch.clamp(gx * gx + gy * gy + gz * gz, min=1e-30)
    got = wf.light_pdf(prep, *_cols(p), gx, gy, gz, g2,
                       1.0 / torch.sqrt(g2)).numpy()
    assert (ref > 0).mean() > 0.3
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)


def test_quad_light_samples_match_jax():
    """Quad-light directions q + u1 u + u2 v - p on the same draws, equal
    to within 1 ulp of the 555-unit coordinates."""
    jscene, _, _ = jmodels.book3_cornell_box()
    scene, cfg, _ = models.book3_cornell_box(dict(image_width=32))
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=32,
                                 height=32, mis=True, device="cpu")
    rng = np.random.default_rng(3)
    n = 2048
    p = rng.uniform(20.0, 535.0, (n, 3)).astype(np.float32)
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    draws = np.concatenate([np.zeros((n, 1), np.float32), u], axis=1)
    ref = np.asarray(jint._light_sample(jnp.asarray(p), jscene,
                                        jnp.asarray(draws)))
    got = wf._light_samples(prep, *_cols(p), *_cols(u))[0]
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), ref, rtol=0,
                               atol=1e-4)


def test_sphere_light_samples_inside_the_cone():
    """Every sampled direction toward a sphere light hits that sphere, so
    JAX's pdf of it is > 0."""
    jb, b = JaxSceneBuilder(), SceneBuilder()
    for builder in (jb, b):
        builder.add_sphere((0.0, 0.0, 0.0), 1.0, builder.lambertian((.5,) * 3))
        builder.add_light_sphere((190.0, 90.0, 190.0), 90.0)
    jscene = jb.build()
    scene = b.build()
    _, cfg, _ = models.book3_cornell_box(dict(image_width=32))
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=32,
                                 height=32, mis=True, device="cpu")
    rng = np.random.default_rng(4)
    n = 4096
    p = rng.uniform(20.0, 535.0, (n, 3)).astype(np.float32)
    far = np.linalg.norm(p - np.float32([190, 90, 190]), axis=1) > 95.0
    p = p[far]
    u = rng.uniform(size=(p.shape[0], 2)).astype(np.float32)
    (dirs,) = wf._light_samples(prep, *_cols(p), *_cols(u))
    d = torch.stack(dirs, 1).numpy()
    pdf = np.asarray(jint._light_pdf_value(jnp.asarray(p), jnp.asarray(d),
                                           jscene))
    assert np.all(pdf > 0), np.sum(pdf <= 0)


def test_stratified_spawn_matches_jax_generate_rays():
    """Stratified camera rays from absolute sample indices (strata wrapped
    to the n x n grid) vs JAX generate_rays with _strat_tuple; 1e-5."""
    jscene, jcfg, _ = jmodels.book3_cornell_box(dict(image_width=48))
    scene, cfg, _ = models.book3_cornell_box(dict(image_width=48))
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=48,
                                 height=48, mis=True, stratified=True,
                                 sqrt_spp=10, device="cpu")
    rng = np.random.default_rng(5)
    n = 4096
    px = rng.integers(0, 48, n).astype(np.float32)
    py = rng.integers(0, 48, n).astype(np.float32)
    s_idx = rng.integers(0, 300, n)
    u = rng.uniform(size=(n, 5)).astype(np.float32)
    u[:, 4] = 0.0
    o_ref, d_ref, _ = generate_rays(
        jax_derive_camera(jcfg), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(u), _strat_tuple(jnp.asarray(s_idx), True, 10))
    o, d = wf.spawn_rays(prep.cam_u, torch.from_numpy(px),
                         torch.from_numpy(py),
                         *(torch.from_numpy(u[:, k]) for k in range(4)),
                         defocus=False, sample=torch.from_numpy(s_idx),
                         sqrt_spp=10)
    np.testing.assert_allclose(torch.stack(o, 1).numpy(), np.asarray(o_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.stack(d, 1).numpy(), np.asarray(d_ref),
                               rtol=1e-5, atol=1e-5)

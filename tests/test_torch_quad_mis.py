"""The port's SAH quad clusters and the NEE/MIS estimator's isotropic branch
against the JAX package: ``cluster_quad_table`` and the prepared quad
tables bit-equal, the plain twin's culled closest quad exact against a
brute-force scan, and a volumetric MIS scene (a smoke box in a Cornell box)
bit-equal, eligible and statistically equal to JAX's XLA MIS estimator.
The CUDA kernels are held against the twin in test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax  # noqa: E402

from rustraytrace_tpu import native as jnative  # noqa: E402
from rustraytrace_tpu import render as jrender  # noqa: E402
from rustraytrace_tpu.config import RenderConfig as JaxRenderConfig  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.ops import pallas_megakernel as jmk  # noqa: E402
from rustraytrace_tpu.scene import SceneBuilder as JaxSceneBuilder  # noqa: E402
from rustraytrace_tpu_torch import RenderConfig, SceneBuilder, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import hit  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402
from torch_scenes import (FIELD_CFG, SMOKE_CFG, quad_field,  # noqa: E402
                          smoke_mis_scene)


def _needs_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load")


def _jax_fields(scene) -> dict:
    out = {f.name: np.asarray(getattr(scene, f.name))
           for f in dataclasses.fields(scene) if f.name != "features"}
    out["features"] = tuple(scene.features)
    return out


@pytest.mark.parametrize("n", [64, 96])
def test_cluster_quad_table_bit_equal_jax(n):
    _needs_native()
    jscene = quad_field(JaxSceneBuilder, n)
    scene = quad_field(SceneBuilder, n)
    ref, n_q_ref, n_qc_ref = jmk.cluster_quad_table(
        jscene, jmk.pack_quad_table(jscene))
    got, n_q, n_qc = mk.cluster_quad_table(
        scene, hit.pack_quad_table(scene).numpy())
    assert n_qc == n_qc_ref > 1 and n_q == n_q_ref
    assert got.dtype == np.float32 and got.shape == (n_q + n_qc, mk.Q_COLS)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_small_quad_scene_keeps_linear_scan():
    b = SceneBuilder()
    b.add_quad((0, 0, -5), (1, 0, 0), (0, 1, 0), b.lambertian((.5,) * 3))
    scene = b.build()
    qtab = hit.pack_quad_table(scene).numpy()
    got, n_q, n_qc = mk.cluster_quad_table(scene, qtab)
    assert got is qtab and n_qc == 0 and n_q == qtab.shape[0]


def test_prepared_quad_tables_equal_jax():
    _needs_native()
    jscene = quad_field(JaxSceneBuilder, 64)
    scene = quad_field(SceneBuilder, 64)
    jcfg = JaxRenderConfig(image_width=32, samples_per_pixel=2, max_depth=4,
                           **FIELD_CFG)
    cfg = RenderConfig(image_width=32, samples_per_pixel=2, max_depth=4,
                       **FIELD_CFG)
    arrays, st = jmk.prepare_megakernel(
        jscene, jax_derive_camera(jcfg), width=32, height=32, spp=2,
        max_depth=4, interpret=True, segment=True)
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=32,
                                 height=32, device="cpu")
    assert (prep.n_quads, prep.n_qclusters) == (st["n_quads"],
                                                st["n_qclusters"])
    assert prep.n_qclusters > 1
    np.testing.assert_array_equal(prep.qtab.numpy(), np.asarray(arrays["qtab"]))


def test_culled_closest_quad_exact_against_brute_force():
    """The twin's quad-cluster cull (csrc/path.cuh ``intersect``) finds the
    brute-force scan's closest quad of the unclustered table, with the same
    t to the bit, on 50 fixed rays inside and outside the field."""
    _needs_native()
    scene = quad_field(SceneBuilder, 96)
    cfg = RenderConfig(image_width=16, **FIELD_CFG)
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=16,
                                 height=16, device="cpu")
    assert prep.n_qclusters > 1
    # 35 rays aimed at quad centers, 15 in random directions
    rng = np.random.default_rng(7)
    o = rng.uniform(-30, 30, (50, 3))
    qtab0 = hit.pack_quad_table(scene)
    q = qtab0.numpy()[rng.integers(0, 96, 35)]
    aim = q[:, 0:3] + 0.5 * q[:, 3:6] + 0.5 * q[:, 6:9] - o[:35]
    d = np.concatenate([aim, rng.normal(size=(15, 3))])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    o = torch.from_numpy(o.astype(np.float32))
    d = torch.from_numpy(d.astype(np.float32))
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    a = dx * dx + dy * dy + dz * dz
    t, _, qi, _, _ = wf._intersect_plain(prep, ox, oy, oz, dx, dy, dz, a,
                                         1.0 / a)
    tb, ib = wf._quad_rows_min(qtab0, ox, oy, oz, dx, dy, dz)
    hit_b = tb < hit.T_MAX
    assert 30 <= int(hit_b.sum()) < 50
    assert torch.equal(torch.where(hit_b, tb, wf._BIG), t)
    assert torch.equal(qi >= 0, hit_b)
    np.testing.assert_array_equal(prep.qtab[qi[hit_b]].numpy(),
                                  qtab0[ib[hit_b]].numpy())


def test_smoke_mis_scene_bit_equal_and_eligible():
    jscene = smoke_mis_scene(JaxSceneBuilder)
    scene = smoke_mis_scene(SceneBuilder)
    ref = _jax_fields(jscene)
    got = scene.to_numpy()
    assert got["features"] == ref["features"]
    for key, want in ref.items():
        if key != "features":
            assert got[key].dtype == want.dtype, key
            np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert jmk.megakernel_mis_eligible(jscene)
    assert mk.megakernel_mis_eligible(scene)
    prep = mk.prepare_megakernel(
        scene, derive_camera(RenderConfig(image_width=16, **SMOKE_CFG),
                             "cpu"), width=16, height=16, mis=True,
        device="cpu")
    assert (prep.n_media, prep.n_lights, prep.mis, prep.book2) == (
        1, 1, True, True)


@pytest.mark.parametrize("smoke", [(0.0, 0.0, 0.0), (0.73, 0.73, 0.73)])
def test_smoke_mis_render_matches_jax_xla(smoke):
    """The plain MIS render of the smoke scene (K3's twin, the isotropic
    branch on every medium scatter) against JAX ``render_pass`` with
    ``integrator="mis"`` on the XLA backend at 24x24, 32 spp, depth 8:
    each channel's image mean within 5 standard errors of the per-pixel
    differences' mean.  Independent random streams.  The JAX scene's black
    smoke ends every path it scatters; white smoke carries the isotropic
    directions into the image."""
    w, spp, depth = 24, 32, 8
    jscene = smoke_mis_scene(JaxSceneBuilder, smoke)
    scene = smoke_mis_scene(SceneBuilder, smoke)
    jcfg = JaxRenderConfig(image_width=w, **SMOKE_CFG)
    cfg = RenderConfig(image_width=w, **SMOKE_CFG)
    ref = np.asarray(jrender.render_pass(
        jscene, jax_derive_camera(jcfg), jax.random.key(9), width=w,
        height=w, spp=spp, max_depth=depth, integrator="mis", backend="xla",
        chunk=576)) / spp
    got = render.render_pass(
        scene, derive_camera(cfg, "cpu"), 2, width=w, height=w, spp=spp,
        max_depth=depth, integrator="mis", device="cpu").numpy() / spp
    assert np.all(np.isfinite(got)) and got.mean() > 0.01
    diff = (got - ref).reshape(-1, 3)
    se = diff.std(axis=0, ddof=1) / np.sqrt(diff.shape[0])
    assert np.all(np.abs(diff.mean(axis=0)) < 5 * se), (
        diff.mean(axis=0), se)


def test_mis_isotropic_lanes_sample_the_uniform_sphere():
    """Under MIS, a lane that scatters in a medium and takes the mixture's
    material half (u10 >= 0.5) leaves along the uniform-sphere direction of
    its own u5, u6, and its weight uses the pdf 1/4pi for both the mixture
    and the scattering (pallas_megakernel.py:1618-1627, 1678-1681): away
    from the light the attenuation doubles the albedo."""
    b = SceneBuilder()
    b.add_medium_sphere((0, 0, 0), 5.0, 10.0, b.isotropic((0.5, 0.6, 0.7)))
    b.add_light_sphere((0, 50, 0), 1.0)
    scene = b.build()
    cfg = RenderConfig(image_width=16, **SMOKE_CFG)
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=16,
                                 height=16, mis=True, device="cpu")
    n = 512
    rng = np.random.default_rng(3)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))
    zero, one = torch.zeros(n), torch.ones(n)
    v = dict(tm=zero, ox=zero, oy=zero, oz=zero, dx=d[:, 0], dy=d[:, 1],
             dz=d[:, 2], ax=one, ay=one, az=one, rx=zero, ry=zero, rz=zero,
             alive=one, b=zero)
    slot = torch.arange(n, dtype=torch.int64)
    sample = torch.zeros(n, dtype=torch.int64)
    key = wf.seed_key(3)
    assert wf.bounce_live(prep, v, slot, sample, key, 8)
    u5, u6 = wf.uniforms4(slot, sample, 0, wf.STREAM_MIS_A, key)[:2]
    u10 = wf.uniforms4(slot, sample, 0, wf.STREAM_MIS_B, key)[1]
    mat = (u10 >= 0.5) & (v["alive"] > 0.0)
    assert int(mat.sum()) > n // 4
    z = u6 * 2.0 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = wf._TWO_PI * u5
    want = (torch.cos(phi) * r, torch.sin(phi) * r, z)
    for got, w in zip((v["dx"], v["dy"], v["dz"]), want):
        assert torch.equal(got[mat], w[mat])
    away = mat & (v["dy"] < 0.99)
    assert int(away.sum()) > n // 4
    for got, alb in zip((v["ax"], v["ay"], v["az"]), (0.5, 0.6, 0.7)):
        np.testing.assert_allclose(got[away].numpy(), 2.0 * alb, rtol=1e-6)


def test_image_textured_media_still_raise():
    """Image-textured constant media stay on the JAX package's XLA path."""
    b = SceneBuilder()
    img = np.full((4, 4, 3), 0.5, np.float32)
    b.add_medium_sphere((0, 0, 0), 1.0, 0.5,
                        b.isotropic(tex=b.image_texture(img)))
    b.add_sphere((0, -100, 0), 99.0, b.lambertian((.5,) * 3))
    scene = b.build()
    assert {"image", "media"} <= set(scene.features)
    with pytest.raises(NotImplementedError, match="image-textured"):
        mk.megakernel_eligible(scene, "path")

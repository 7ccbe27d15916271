"""The port's Book-2 slice against the JAX package: every catalog scene
bit-equal; the prepared tables of the Book-2 final scene and the bouncing
spheres bit-equal to ``prepare_megakernel(..., segment=True)`` after the
documented layout change; the plain twin's feature functions (moving
spheres, boxes and their face normals, constant-medium free flight, Perlin
marble, sphere UV and image texels) against JAX's XLA functions on seeded
inputs; ``render_image`` against JAX's XLA backend for the final scene, the
Cornell smoke and the globe; the launch-loop invariance of the image route;
and the entry points' default device.  The CUDA kernels are held against
the plain twin on the card by ``chip_smoke.py``."""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu import native as jnative  # noqa: E402
from rustraytrace_tpu import render as jrender  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.ops import intersect as jinter  # noqa: E402
from rustraytrace_tpu.ops import pallas_megakernel as jmk  # noqa: E402
from rustraytrace_tpu.ops import pallas_wavefront as jwf  # noqa: E402
from rustraytrace_tpu.ops import perlin as jperlin  # noqa: E402
from rustraytrace_tpu.ops import textures as jtex  # noqa: E402
from rustraytrace_tpu.scene import SceneBuilder as JaxSceneBuilder  # noqa: E402
from rustraytrace_tpu_torch import SceneBuilder, models, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_scenes  # noqa: E402

NEW_SCENES = ["book2_bouncing_spheres", "book2_checkered_spheres",
              "book2_earth", "book2_perlin_spheres", "book2_simple_light",
              "book2_cornell_smoke", "book2_final_scene", "sphere_field_10k",
              "in_one_weekend"]


def _jax_fields(scene) -> dict:
    out = {f.name: np.asarray(getattr(scene, f.name))
           for f in dataclasses.fields(scene) if f.name != "features"}
    out["features"] = tuple(scene.features)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("name,num", [(n, None) for n in NEW_SCENES] + [
    ("the_next_week", n) for n in (None, *range(1, 10))])
def test_catalog_scenes_bit_equal_jax(name, num):
    """Scene arrays, config and integrator equal to the JAX package's,
    including ``get_scene("the_next_week", scene_num=9)`` (800x800, 10000
    spp, depth 40) and the final scene it builds without a number."""
    jscene, jcfg, jinteg = jmodels.get_scene(name, scene_num=num)
    scene, cfg, integ = models.get_scene(name, scene_num=num)
    assert integ == jinteg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ref = _jax_fields(jscene)
    got = scene.to_numpy()
    assert got["features"] == ref["features"]
    assert set(got) == set(ref)
    for key, want in ref.items():
        if key != "features":
            assert got[key].dtype == want.dtype, key
            np.testing.assert_array_equal(got[key], want, err_msg=key)


def test_earthmap_source():
    """The globe decodes the repository's earthmap.jpg where PIL exists
    and falls back to the JAX package's procedural globe otherwise."""
    img, src = models.earthmap()
    assert img.dtype == np.float32 and img.ndim == 3 and img.shape[2] == 3
    assert src == "procedural" or src.endswith("earthmap.jpg")
    assert 0.0 <= img.min() and img.max() <= 1.0


@pytest.mark.parametrize("name", ["book2_final_scene",
                                  "book2_bouncing_spheres"])
def test_book2_prepared_tables_equal_jax(name):
    """Sphere order with the static/moving split, super-clusters,
    n_ssc_static, the box table, its clusters and winner attributes, the
    media, the Perlin lattice and the texels, bit-equal to the JAX
    package's tables; only the Mosaic layouts differ (see
    ops/megakernel.py)."""
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load")
    jscene, jcfg, _ = jmodels.get_scene(name, dict(image_width=48))
    scene, cfg, _ = models.get_scene(name, dict(image_width=48))
    _assert_tables_equal_jax(jscene, jcfg, scene, cfg)


@pytest.mark.parametrize("knob,value", [("RTT_SPHERE_GRID", "1"),
                                        ("RTT_GRID_RES", "4"),
                                        ("RTT_GRID_FILL", "0.95")])
def test_book2_prepared_tables_under_knob_equal_jax(monkeypatch, knob,
                                                    value):
    """The same tables on the final scene with a knob of the prep set: the
    sphere grid, the grid at 4 cells an axis, and a fill threshold above
    the cloud's, under which the grid is declined and the SAH tables
    stay."""
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load")
    for k in ("RTT_SPHERE_GRID", "RTT_GRID_RES", "RTT_GRID_FILL"):
        monkeypatch.delenv(k, raising=False)
    over = dict(image_width=48)
    jscene, jcfg, _ = jmodels.get_scene("book2_final_scene", over)
    scene, cfg, _ = models.get_scene("book2_final_scene", over)
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=48, height=cfg.image_height, device="cpu")
    base = mk.prepare_megakernel(scene, cam, **kw)
    if knob != "RTT_SPHERE_GRID":
        monkeypatch.setenv("RTT_SPHERE_GRID", "1")
        grid = mk.prepare_megakernel(scene, cam, **kw)
    monkeypatch.setenv(knob, value)
    prep = _assert_tables_equal_jax(jscene, jcfg, scene, cfg)
    if knob == "RTT_SPHERE_GRID":  # spheres listed in every cell they cross
        assert prep.geom.shape[0] > base.geom.shape[0]
    elif knob == "RTT_GRID_RES":
        assert prep.geom.shape[0] > base.geom.shape[0]
        assert prep.geom.shape[0] != grid.geom.shape[0]
    else:
        assert grid.geom.shape[0] > base.geom.shape[0]
        np.testing.assert_array_equal(prep.geom.numpy(), base.geom.numpy())


def _assert_tables_equal_jax(jscene, jcfg, scene, cfg):
    """The port's prepared tables of a scene against JAX's
    ``prepare_megakernel(..., interpret=True, segment=True)``; returns the
    port's."""
    w, h = cfg.image_width, cfg.image_height
    arrays, st = jmk.prepare_megakernel(
        jscene, jax_derive_camera(jcfg), width=w, height=h, spp=8,
        max_depth=8, interpret=True, segment=True)
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=w,
                                 height=h, device="cpu")
    gtab = np.asarray(arrays["tab"]).T  # JAX: column-major geometry
    n = gtab.shape[0]
    np.testing.assert_array_equal(prep.geom.numpy(), gtab[:, :4])
    if st["moving"]:
        np.testing.assert_array_equal(prep.gvel.numpy()[:, :3], gtab[:, 4:7])
    acols = [mk.J_KIND, mk.J_AR, mk.J_AG, mk.J_AB, mk.J_FUZZ, mk.J_IOR,
             mk.J_CX, mk.J_CY, mk.J_CZ, mk.J_INVR]
    acols += [mk.J_VX, mk.J_VY, mk.J_VZ] if st["moving"] else []
    if prep.book2:  # the texture columns
        acols += [mk.J_TEXK, mk.J_C2R, mk.J_C2G, mk.J_C2B, mk.J_INVS]
    acols += [mk.J_IMG] if st["has_image"] else []
    atab = np.asarray(arrays["atab"]).reshape(len(acols), -1)[:, :n].T
    np.testing.assert_array_equal(prep.tab.numpy()[:, acols], atab)
    for k in ("clb", "cls", "sclb", "scls", "cam_u", "bg", "qtab"):
        np.testing.assert_array_equal(getattr(prep, k).numpy(),
                                      np.asarray(arrays[k]), k)
    for k in ("n_clusters", "n_sclusters", "n_ssc_static", "unroll",
              "b_unroll", "n_boxes", "n_bclusters", "n_media", "rows",
              "n_quads", "n_qclusters", "moving", "has_checker",
              "has_noise", "has_image"):
        assert getattr(prep, k) == st[k], k
    if prep.n_boxes:
        for k in ("btab", "bclb", "bcls"):
            np.testing.assert_array_equal(getattr(prep, k).numpy(),
                                          np.asarray(arrays[k]), k)
        batab = np.asarray(arrays["batab"]).reshape(17, -1)[
            :, :prep.n_boxes].T
        bcols = [mk.BA_KIND, mk.BA_AR, mk.BA_AG, mk.BA_AB, mk.BA_FUZZ,
                 mk.BA_IOR]
        np.testing.assert_array_equal(prep.batt.numpy()[:, bcols],
                                      batab[:, :6])
        np.testing.assert_array_equal(prep.btab.numpy()[:, :6],
                                      batab[:, 6:12])
        tcols = [mk.BA_TEXK, mk.BA_C2R, mk.BA_C2G, mk.BA_C2B, mk.BA_INVS]
        np.testing.assert_array_equal(prep.batt.numpy()[:, tcols],
                                      batab[:, 12:17])
    np.testing.assert_array_equal(prep.mtab.numpy()[:prep.n_media],
                                  np.asarray(arrays["mtab"])[:prep.n_media])
    if prep.has_noise:
        np.testing.assert_array_equal(
            prep.perm.numpy(), np.asarray(arrays["ptab"]).reshape(3, 256))
        np.testing.assert_array_equal(
            prep.randvec.numpy(),
            np.asarray(arrays["vtab"]).reshape(3, 256).T)
    if prep.has_image:
        meta = prep.img_meta.numpy()
        assert [tuple(r) for r in meta.tolist()] == list(st["dma_meta"])
        t = prep.texels.shape[0]
        np.testing.assert_array_equal(
            prep.texels.numpy(),
            np.asarray(arrays["img_dma"]).reshape(-1)[:4 * t].reshape(
                t, 4)[:, :3])
    return prep


def _moving_cloud(b):
    """150 seeded spheres, two in three moving (the same calls on either
    builder)."""
    rng = np.random.default_rng(11)
    mat = b.lambertian((0.5, 0.5, 0.5))
    for k in range(150):
        c = rng.uniform(-5, 5, 3)
        r = float(rng.uniform(0.2, 0.8))
        c2 = c + rng.uniform(-1, 1, 3) if k % 3 else None
        b.add_sphere(c, r, mat, center2=c2)
    return b.build()


def _rays(n, seed, center, spread, target_spread):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-1, 1, (n, 3)) * spread + center).astype(np.float32)
    tgt = rng.uniform(-1, 1, (n, 3)) * target_spread
    return o, (tgt - o).astype(np.float32)


def test_moving_sphere_hits_match_jax_hit_spheres():
    """Closest moving-sphere hit at each ray's time against the XLA
    ``hit_spheres``: hit flags equal on > 99.9% of rays, winners equal and
    t within 1e-3 relative where both hit (XLA expands the quadric into
    matrix products, so grazing roots round differently)."""
    jscene = _moving_cloud(JaxSceneBuilder())
    scene = _moving_cloud(SceneBuilder())
    o, d = _rays(8192, 1, np.float32([0, 0, 15]), 4.0, 5.0)
    tm = np.random.default_rng(2).uniform(size=8192).astype(np.float32)
    n = o.shape[0]
    t_ref, i_ref, any_ref = (np.asarray(x) for x in jinter.hit_spheres(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), jscene,
        jnp.full(n, 1e-3), jnp.full(n, 1e9)))
    tab = mk.pack_joined_table(scene)
    a = (_t(d) * _t(d)).sum(1)
    bt, bi = wf._sphere_rows_min(
        _t(tab[:, :4]), *_t(o).T, *_t(d).T, a, 1.0 / a, _t(tab[:, 4:7]),
        _t(tm))
    hit = bt.numpy() < 1e29
    assert hit.mean() > 0.3
    assert np.mean(hit == any_ref) > 0.999
    both = hit & any_ref
    np.testing.assert_array_equal(bi.numpy()[both], i_ref[both])
    np.testing.assert_allclose(bt.numpy()[both], t_ref[both], rtol=1e-3)


def test_box_hits_and_face_normals_match_jax():
    """The 400 ground boxes of the final scene: the twin's box scan
    (entry face, else exit face) and face normal against XLA ``hit_boxes``
    and ``box_outward_normal`` on rays from above and from inside boxes:
    t bitwise (the same slab arithmetic), winners and normals equal."""
    jscene, _, _ = jmodels.book2_final_scene()
    scene, _, _ = models.book2_final_scene()
    mask = scene.box_mask.numpy() > 0
    btab = np.zeros((int(mask.sum()), 8), np.float32)
    btab[:, :3] = scene.box_lo.numpy()[mask]
    btab[:, 3:6] = scene.box_hi.numpy()[mask]
    rng = np.random.default_rng(3)
    n = 8192
    o = rng.uniform([-1000, 0, -1000], [1000, 400, 1000], (n, 3))
    o[: n // 4, 1] = rng.uniform(0.5, 1.0, n // 4)  # inside the ground boxes
    d = rng.normal(size=(n, 3)) * [1, 2, 1] - [0, 1, 0]
    o, d = o.astype(np.float32), d.astype(np.float32)
    t_ref, i_ref, any_ref = (np.asarray(x) for x in jinter.hit_boxes(
        jnp.asarray(o), jnp.asarray(d), jscene, jnp.full(n, 1e-3),
        jnp.full(n, 1e9)))
    ox, oy, oz = _t(o).T
    dx, dy, dz = _t(d).T
    iv = [wf._safe_inv(x) for x in (dx, dy, dz)]
    bt, bi = wf._box_rows_min(_t(btab), ox, oy, oz, *iv)
    hit = bt.numpy() < 1e29
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(hit, any_ref)
    np.testing.assert_array_equal(bi.numpy()[hit], i_ref[hit])
    np.testing.assert_array_equal(bt.numpy()[hit], t_ref[hit])
    n_ref = np.asarray(jinter.box_outward_normal(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_ref),
        jnp.asarray(btab[i_ref, :3]), jnp.asarray(btab[i_ref, 3:6])))
    got = torch.stack(wf._box_normal(_t(btab)[bi], ox, oy, oz, dx, dy, dz),
                      1).numpy()
    np.testing.assert_array_equal(got[hit], n_ref[hit])


@pytest.mark.parametrize("name", ["book2_final_scene", "book2_cornell_smoke"])
def test_medium_free_flight_matches_jax_hit_media(name):
    """Constant-medium free flight with injected uniforms, clipped by a
    running closest hit, against XLA ``hit_media``: hit flags and winning
    media equal on > 99.9% of rays, t within 1e-4 relative where both hit
    (XLA divides by |d| where the twin multiplies by 1/|d|)."""
    jscene, jcfg, _ = jmodels.get_scene(name, dict(image_width=16))
    scene, cfg, _ = models.get_scene(name, dict(image_width=16))
    prep = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=16,
                                 height=cfg.image_height, device="cpu")
    assert prep.n_media == 2
    center = np.float32([360, 150, 145] if name == "book2_final_scene"
                        else [278, 278, 278])
    o, d = _rays(8192, 4, center, 200.0, 150.0)
    n = o.shape[0]
    rng = np.random.default_rng(5)
    # XLA draws a column per medium row, padding rows included: spheres
    # first, then boxes
    K = scene.msph_mask.shape[0]
    u = rng.uniform(size=(n, K + scene.mbox_mask.shape[0])).astype(
        np.float32)
    cols = np.concatenate([np.nonzero(scene.msph_mask.numpy() > 0)[0],
                           K + np.nonzero(scene.mbox_mask.numpy() > 0)[0]])
    t_best = np.where(rng.uniform(size=n) < 0.5, 1e9,
                      rng.uniform(1, 400, n)).astype(np.float32)
    t_ref, mat_ref, hit_ref = (np.asarray(x) for x in jinter.hit_media(
        jnp.asarray(o), jnp.asarray(d), jscene, jnp.full(n, 1e-3),
        jnp.asarray(t_best), jnp.asarray(u)))
    dx, dy, dz = _t(d).T
    a = dx * dx + dy * dy + dz * dz
    bt = _t(t_best).clone()
    mi = wf._media_hits_plain(prep, *_t(o).T, dx, dy, dz, a, 1.0 / a, bt,
                              [_t(u[:, c]) for c in cols]).numpy()
    hit = mi >= 0
    assert hit.mean() > 0.05
    assert np.mean(hit == hit_ref) > 0.999
    mats = np.concatenate([
        scene.msph_mat.numpy()[scene.msph_mask.numpy() > 0],
        scene.mbox_mat.numpy()[scene.mbox_mask.numpy() > 0]])
    both = hit & hit_ref
    assert np.mean(mats[mi[both]] == mat_ref[both]) > 0.999
    np.testing.assert_allclose(bt.numpy()[both], t_ref[both], rtol=1e-4)
    assert np.all(bt.numpy()[~hit] == t_best[~hit])


def test_perlin_marble_matches_jax_turb():
    """Marble albedo 0.5 (1 + sin(s z + 10 turb(p))) against XLA
    ``perlin.turb`` on seeded points, negative lattice cells included:
    within 2e-5 (the octave sums round in another order)."""
    scene, _, _ = models.book2_perlin_spheres()
    ns = types.SimpleNamespace(perm=scene.perlin_perm,
                               randvec=scene.perlin_randvec)
    p = np.random.default_rng(6).uniform(-60, 60, (8192, 3)).astype(
        np.float32)
    turb = np.asarray(jperlin.turb(jnp.asarray(p),
                                   jnp.asarray(scene.perlin_randvec.numpy()),
                                   jnp.asarray(scene.perlin_perm.numpy())))
    ref = 0.5 * (1.0 + np.sin(np.float32(4.0) * p[:, 2]
                              + np.float32(10.0) * turb))
    got = wf._marble(ns, torch.full((8192,), 4.0), *_t(p).T).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_sphere_uv_and_image_texel_match_jax():
    """Sphere (u, v) from outward normals, poles included, within 1e-6 of
    XLA ``sphere_uv``; nearest texels of the globe equal to XLA
    ``image_texel`` wherever (u, v) is not within 1e-4 of a texel
    border."""
    jscene, _, _ = jmodels.book2_earth()
    scene, _, _ = models.book2_earth()
    texels, meta = mk.pack_image_table(scene)
    ns = types.SimpleNamespace(texels=_t(texels), img_meta=_t(meta))
    rng = np.random.default_rng(7)
    ow = rng.normal(size=(8192, 3))
    ow /= np.linalg.norm(ow, axis=1, keepdims=True)
    ow[:4] = [[0, 1, 0], [0, -1, 0], [0, 1 - 1e-8, 0], [1, 0, 0]]
    ow = ow.astype(np.float32)
    u_ref, v_ref = (np.asarray(x) for x in jinter.sphere_uv(jnp.asarray(ow)))
    u, v = (x.numpy() for x in wf.sphere_uv(*_t(ow).T))
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-6)
    img = torch.zeros(8192)
    ref = np.asarray(jtex.image_texel(jscene, jnp.zeros(8192, jnp.int32),
                                      jnp.asarray(u), jnp.asarray(v)))
    got = torch.stack(wf.image_texel(ns, img, _t(u), _t(v)), 1).numpy()
    h, w = (int(x) for x in meta[0, 2:0:-1])
    fu = np.clip(u, 0, 1) * w
    fv = (1 - np.clip(v, 0, 1)) * h
    away = ((np.abs(fu - np.round(fu)) > 1e-4)
            & (np.abs(fv - np.round(fv)) > 1e-4))
    assert away.mean() > 0.99
    np.testing.assert_array_equal(got[away], ref[away])


@pytest.mark.parametrize("name,spp,depth", [
    ("book2_final_scene", 32, 4), ("book2_cornell_smoke", 48, 8),
    ("book2_earth", 32, 8)])
def test_book2_render_image_matches_jax_xla(name, spp, depth):
    """``render_image(device="cpu")`` (the twin of the route the card
    takes) vs JAX ``render_pass`` on the XLA backend at 24 px wide: the
    means of a 4x4 grid of blocks within 5 standard errors, each block's
    standard error from the spread of its per-pixel differences
    (independent random streams)."""
    w = 24
    over = dict(image_width=w, samples_per_pixel=spp, max_depth=depth)
    jscene, jcfg, jinteg = jmodels.get_scene(name, over)
    scene, cfg, integ = models.get_scene(name, over)
    h = cfg.image_height
    ref = np.asarray(jrender.render_pass(
        jscene, jax_derive_camera(jcfg), jax.random.key(0), width=w,
        height=h, spp=spp, max_depth=depth, integrator=jinteg,
        backend="xla", chunk=w * h)) / spp
    img_u8, state = render.render_image(scene, cfg, integrator=integ,
                                        device="cpu")
    assert state["spp_done"] == spp and img_u8.shape == (h, w, 3)
    got = state["accum"] / spp
    assert np.all(np.isfinite(got)) and got.mean() > 0.05
    diff = got - ref
    for ys in np.array_split(np.arange(h), 4):
        for xs in np.array_split(np.arange(w), 4):
            blk = diff[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1].reshape(-1, 3)
            se = blk.std(axis=0, ddof=1) / np.sqrt(blk.shape[0])
            assert np.all(np.abs(blk.mean(axis=0)) < 5 * se + 1e-6), (
                ys[0], xs[0], blk.mean(axis=0), se)


def test_image_route_sums_invariant_to_sort_bounds_and_kernel():
    """On a 16x16 final scene cut into four 256-lane tiles: the sorted
    loop with per-tile adaptive bounds, the unsorted loop at a uniform
    bound, and K3 bank bitwise equal sums (every draw is keyed by slot,
    sample, bounce and stream), and the adaptive bounds really differ
    between tiles."""
    scene, cfg, _ = models.book2_final_scene(
        dict(image_width=16, samples_per_pixel=4, max_depth=4))
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"),
                                   width=16, height=16, tile_rows=2,
                                   device="cpu")
    assert tables.n_lanes == 1024 and tables.book2
    seen = []

    def step(*args, tile_bounds=None, **kw):
        seen.append(None if tile_bounds is None else tile_bounds.tolist())
        wf.persist_step(*args, tile_bounds=tile_bounds, **kw)

    kw = dict(spp=4, max_depth=4)
    adaptive = wf._wavefront_pass_persist(
        tables, 7, 3, persist_iters=8, sort_rays=True, sort_every=1,
        adaptive_bounds=(1, 3, 0.25), step=step, **kw)
    uniform = wf._wavefront_pass_persist(tables, 7, 3, persist_iters=8,
                                         sort_rays=False, **kw)
    k3 = mk.respawn_pass(tables, 7, 3, 4, 4)
    assert float(uniform.sum()) > 0
    assert torch.equal(adaptive, uniform)
    assert torch.equal(k3, uniform)
    assert seen[0] == [3] * 4
    assert any(len(set(b)) > 1 for b in seen if b)


def test_tile_bounds_follow_the_jax_rule():
    """``tile_bounds_next`` against the JAX package's formula
    (pallas_wavefront.py:692-714) written out in jnp on the same state:
    tight tiles keep the long bound, spread ones get the short one, empty
    tiles the long one."""
    rng = np.random.default_rng(9)
    n_tiles, lanes = 6, 128
    st = np.zeros((20, n_tiles * lanes), np.float32)
    st[1:4] = rng.normal(size=(3, n_tiles * lanes)) * np.repeat(
        [0.1, 5.0, 0.2, 9.0, 0.0, 1.0], lanes)
    st[19] = rng.uniform(size=n_tiles * lanes) < 0.7
    st[19, 4 * lanes:5 * lanes] = 0.0  # one empty tile
    short_b, long_b, rel = 4, 8, 0.25
    act = jnp.asarray(st[19]).reshape(n_tiles, -1) > 0.0
    big = jnp.float32(3e38)
    exts = jnp.zeros((n_tiles,), jnp.float32)
    gext = jnp.float32(0)
    for k in (1, 2, 3):
        v = jnp.asarray(st[k]).reshape(n_tiles, -1)
        mn = jnp.min(jnp.where(act, v, big), axis=1)
        mx = jnp.max(jnp.where(act, v, -big), axis=1)
        exts = exts + jnp.where(jnp.any(act, axis=1), mx - mn, 0.0)
        gext = gext + (jnp.max(jnp.where(act, v, -big))
                       - jnp.min(jnp.where(act, v, big)))
    ref = np.asarray(jnp.where(exts > rel * jnp.maximum(gext, 1e-20),
                               short_b, long_b))
    got = wf.tile_bounds_next(_t(st), (short_b, long_b, rel), n_tiles)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(ref.tolist()) == {short_b, long_b}


@pytest.mark.parametrize("name", NEW_SCENES[:7])
def test_image_route_predicates_equal_jax(name):
    """Routing predicates and loop shapes of each new scene as the JAX
    package computes them."""
    jscene, jcfg, _ = jmodels.get_scene(name)
    scene, cfg, _ = models.get_scene(name)
    w, h = cfg.image_width, cfg.image_height
    n = wf.slot_lane_count(w, h)
    assert mk.active_primitive_count(scene) == jmk.active_primitive_count(
        jscene)
    assert mk.noise_dominant(scene) == jmk.noise_dominant(jscene)
    assert wf.texel_gate_heuristic(scene) == jwf.texel_gate_heuristic(jscene)
    assert wf.wavefront_tile_rows(scene) == jwf.wavefront_tile_rows(jscene)
    assert wf.ray_sort_heuristic(scene, n) == jwf.ray_sort_heuristic(jscene,
                                                                     n)
    assert (wf.sorted_persist_route(scene, w, h)
            == jwf.sorted_persist_route(jscene, w, h))
    image = "image" in scene.features
    assert image == jwf.wavefront_eligible(jscene)
    assert mk.megakernel_eligible(scene)
    for iters in range(1, 17):
        assert (wf.persist_adaptive_bounds(iters)
                == jwf.persist_adaptive_bounds(iters))
    assert (wf.PERSIST_SPARSE_ITERS, wf.PERSIST_DENSE_ITERS,
            wf.PERSIST_SORT_ITERS) == (jwf.PERSIST_SPARSE_ITERS,
                                       jwf.PERSIST_DENSE_ITERS,
                                       jwf.PERSIST_SORT_ITERS)


def test_main_path_shapes():
    """``the_next_week`` is the final scene at 400x400, 250 spp, depth 4 in
    one pass: the image route, sorted, 8 iterations per launch with
    adaptive tile bounds (4, 8, 0.25) and a sort every 8 launches over
    176,128 lanes of 1,409 primitives; scene 9 runs passes of 104 spp over
    643,072 lanes."""
    scene, cfg, integ = models.get_scene("the_next_week")
    w, h = cfg.image_width, cfg.image_height
    assert (w, h, cfg.samples_per_pixel, cfg.max_depth, integ) == (
        400, 400, 250, 4, "path")
    assert render.effective_spp_per_pass(cfg, "wavefront", 250, w * h) == 250
    assert mk.active_primitive_count(scene) == 1409
    sort = wf.ray_sort_heuristic(scene, wf.slot_lane_count(w, h))
    assert sort and wf.image_route_iters(scene, sort) == 8
    assert wf.persist_sort_every(8) == 8
    assert wf.persist_adaptive_bounds(8) == (4, 8, 0.25)
    tables = mk.prepare_megakernel_cached(
        scene, derive_camera(cfg, "cpu"), width=w, height=h,
        tile_rows=wf.wavefront_tile_rows(scene), device="cpu")
    assert wf.slot_lane_count(w, h) == 173_056
    assert tables.n_lanes == 176_128 and tables.book2
    assert int(scene.box_mask.sum()) == 400 <= tables.n_boxes
    assert (tables.n_quads, tables.n_media) == (1, 2)
    assert 0 < tables.n_ssc_static < tables.n_sclusters
    _, c9, _ = models.get_scene("the_next_week", scene_num=9)
    assert render.effective_spp_per_pass(c9, "wavefront", 10000,
                                        800 * 800) == 104
    n9 = wf.slot_lane_count(800, 800)
    assert -(-n9 // 4096) * 4096 == 643_072


def test_image_scenes_route_to_the_image_route(monkeypatch):
    scene, _, _ = models.get_scene("the_next_week")
    assert render.resolve_backend(scene, "path", device="cpu") == "plain"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert render.resolve_backend(scene, "path", device="cuda") == (
        "wavefront")
    earth, _, _ = models.book2_earth()
    assert render.resolve_backend(earth, "path") == "wavefront"


def test_render_image_without_device_needs_the_card():
    """The entry points run on the card unless asked for the CPU: with no
    card, ``render_image(scene, cfg)`` raises instead of rendering."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    scene, cfg, _ = models.book1_three_spheres(dict(image_width=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render.render_image(scene, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render.resolve_backend(scene)


def test_prepared_tables_cached_by_camera_value():
    """Repeated renders share their tables: cameras derived anew from one
    config hit the cache; another view, scene or keyword does not."""
    scene, cfg, _ = models.book3_cornell_box(dict(image_width=32))
    kw = dict(width=32, height=32, mis=True, device="cpu")
    a = mk.prepare_megakernel_cached(scene, derive_camera(cfg, "cpu"), **kw)
    assert mk.prepare_megakernel_cached(
        scene, derive_camera(cfg, "cpu"), **kw) is a
    moved = derive_camera(cfg.replace(lookfrom=(278.0, 278.0, -700.0)),
                          "cpu")
    assert mk.prepare_megakernel_cached(scene, moved, **kw) is not a
    assert mk.prepare_megakernel_cached(
        scene, derive_camera(cfg, "cpu"), **dict(kw, mis=False)) is not a
    other, _, _ = models.book3_cornell_box(dict(image_width=32))
    assert mk.prepare_megakernel_cached(
        other, derive_camera(cfg, "cpu"), **kw) is not a

"""The port's ``ops/bvh.py`` and the table knobs against the JAX package:
every function bit-equal to ``rustraytrace_tpu/ops/bvh.py`` on seeded
inputs and on the final scene's cloud; the grid dispatch under its
environment knobs; the prep cache keyed by each knob; ``RTT_SORT_RAYS``;
and the grid against the SAH tables: the same closest-hit winners through
the plain twin's per-thread cull on rays aimed at the cell faces, and the
same image within 5 SE.  The prepared tables under each knob are held to
JAX's in ``test_torch_book2.py``."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu.ops import bvh as jbvh  # noqa: E402
from rustraytrace_tpu.ops import pallas_wavefront as jwf  # noqa: E402
from rustraytrace_tpu_torch import models, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import bvh  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_scenes  # noqa: E402
from test_torch_reference import _block_agreement  # noqa: E402

KNOBS = ("RTT_SPHERE_GRID", "RTT_GRID_RES", "RTT_GRID_FILL",
         "RTT_SORT_RAYS")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _cloud(n=300, seed=0, box=100.0, r=8.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, box, (n, 3)).astype(np.float32),
            np.full(n, r, np.float32))


def _mixed(seed=4):
    """A dense cloud of varied radii, two oversize spheres and a
    negative radius (a hollow glass sphere's)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-50, 50, (240, 3)).astype(np.float32)
    r = rng.uniform(3.0, 9.0, 240).astype(np.float32)
    r[7] = -r[7]
    c = np.concatenate([c, [[200.0, 0.0, 0.0], [0.0, 300.0, 0.0]]])
    r = np.concatenate([r, [90.0, 120.0]])
    return c.astype(np.float32), r.astype(np.float32)


def _final_cloud():
    """The final scene's static spheres (the 1000-sphere cloud and the
    big ones), as the prep's static group clusters them."""
    scene, _, _ = models.get_scene("the_next_week")
    cen = scene.sph_center.numpy()
    vel = scene.sph_cvel.numpy()
    mask = scene.sph_mask.numpy() > 0
    rad = np.where(mask, np.abs(scene.sph_radius.numpy()), 0.0)
    static = mask & ~(np.abs(vel).max(axis=-1) > 0)
    return cen[static].astype(np.float32), rad[static].astype(np.float32)


INPUTS = {"cloud": _cloud, "mixed": _mixed, "final_cloud": _final_cloud,
          "sparse": lambda: (np.random.default_rng(3).uniform(
              0, 1000, (300, 3)).astype(np.float32),
              np.full(300, 2.0, np.float32))}


def _equal(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    if isinstance(want, float):
        assert isinstance(got, float) and got == want
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn,args", [
    ("build_bvh_numpy", dict(max_leaf=2)),
    ("build_bvh_aabb_numpy", dict(max_leaf=4)),
    ("cluster_spheres_numpy", dict(max_leaf=16)),
    ("cluster_aabbs_numpy", dict(max_leaf=32)),
    ("sphere_fill_fraction", {}),
    ("grid_bin_spheres", dict(max_leaf=32, res=6)),
    ("grid_bin_spheres", dict(max_leaf=8, res=12)),
])
@pytest.mark.parametrize("data", sorted(INPUTS))
def test_functions_bit_equal_jax(fn, args, data):
    """Each function of the port's ops/bvh.py gives JAX's output, bit for
    bit (the AABB functions take the spheres' bounds)."""
    c, r = INPUTS[data]()
    if "aabb" in fn:
        ra = np.abs(r)
        c, r = c - ra[:, None], c + ra[:, None]
    _equal(getattr(bvh, fn)(c, r, **args), getattr(jbvh, fn)(c, r, **args))


@pytest.mark.parametrize("env,data,route", [
    ({}, "cloud", "sah"),
    ({"RTT_SPHERE_GRID": "1"}, "cloud", "grid"),
    ({"RTT_SPHERE_GRID": "1"}, "final_cloud", "grid"),
    ({"RTT_SPHERE_GRID": "1"}, "sparse", "sah"),
    ({"RTT_SPHERE_GRID": "1", "RTT_GRID_RES": "4"}, "cloud", "grid"),
    ({"RTT_SPHERE_GRID": "1", "RTT_GRID_RES": "12"}, "final_cloud", "grid"),
    ({"RTT_SPHERE_GRID": "1", "RTT_GRID_FILL": "0.95"}, "cloud", "sah"),
    ({"RTT_SPHERE_GRID": "1", "RTT_GRID_FILL": "1e-6"}, "sparse", "grid"),
    ({"RTT_SPHERE_GRID": "1"}, "mixed", "sah"),
    ({"RTT_SPHERE_GRID": "1", "RTT_GRID_FILL": "0.1"}, "mixed", "grid"),
    ({"RTT_SPHERE_GRID": "1"}, "few", "sah"),
])
def test_dispatch_equals_jax(monkeypatch, env, data, route):
    """``cluster_spheres_spatial`` decides as JAX's does and builds the
    same tables: the switch, the fill trigger, ``RTT_GRID_RES``,
    ``RTT_GRID_FILL``, mixed sizes (the oversize ones SAH-clustered after
    the cells) and fewer than 64 spheres."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if data == "few":
        c, r = _cloud(n=63)
    else:
        c, r = INPUTS[data]()
    got = bvh.cluster_spheres_spatial(c, r, 32)
    _equal(got, jbvh.cluster_spheres_spatial(c, r, 32))
    n_rows = got[0].shape[0]
    assert (n_rows > c.shape[0]) == (route == "grid")
    # the injected SAH cut is what the SAH route returns
    sah = bvh.cluster_spheres_spatial(c, r, 32, build_sah=lambda *a: "sah")
    assert (sah == "sah") == (route == "sah")


def test_grid_declines_as_jax():
    """The duplication cap and a population under 64 small spheres give
    None in both packages; oversize spheres are listed once each.  (Through
    ``cluster_spheres_spatial`` the default cap of 8 cannot trip: a small
    sphere spans at most 2 cells an axis, so it is called directly.)"""
    c, r = _cloud()
    assert bvh.grid_bin_spheres(c, r, dup_cap=1.2) is None
    assert jbvh.grid_bin_spheres(c, r, dup_cap=1.2) is None
    c2, r2 = _cloud(n=60)
    assert bvh.grid_bin_spheres(c2, r2) is None
    c3, r3 = _mixed()
    order = bvh.grid_bin_spheres(c3, r3)[0]
    assert (order == 240).sum() == 1 and (order == 241).sum() == 1


@pytest.mark.parametrize("knob,value", [
    ("RTT_SPHERE_GRID", "1"), ("RTT_GRID_RES", "4"),
    ("RTT_GRID_FILL", "0.5"), ("RTT_GRID_RES", "12"),
    ("RTT_GRID_FILL", "0.95")])
def test_prep_cache_keys_each_knob(monkeypatch, knob, value):
    """Toggling a knob never returns the cached tables of the other
    setting; setting it back returns them again."""
    scene, cfg, _ = models.get_scene("book2_final_scene",
                                     dict(image_width=32))
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=32, height=cfg.image_height, device="cpu")
    if knob in ("RTT_GRID_RES", "RTT_GRID_FILL"):
        monkeypatch.setenv("RTT_SPHERE_GRID", "1")
    a = mk.prepare_megakernel_cached(scene, cam, **kw)
    assert mk.prepare_megakernel_cached(scene, cam, **kw) is a
    monkeypatch.setenv(knob, value)
    b = mk.prepare_megakernel_cached(scene, cam, **kw)
    assert b is not a
    monkeypatch.delenv(knob)
    assert mk.prepare_megakernel_cached(scene, cam, **kw) is a


@pytest.mark.parametrize("env", [None, "0", "1", ""])
def test_sort_rays_knob_equals_jax(monkeypatch, env):
    """``RTT_SORT_RAYS`` forces the between-launch sort on (below 2^24
    lanes) or off, as in JAX; unset, the heuristic decides."""
    if env is not None:
        monkeypatch.setenv("RTT_SORT_RAYS", env)
    for name in ("book1_random_spheres", "book2_earth"):
        jscene = getattr(jmodels, name)()[0]
        scene = getattr(models, name)()[0]
        for lanes in (1 << 16, (1 << 21) + 1, 1 << 24):
            assert (wf.ray_sort_heuristic(scene, lanes)
                    == jwf.ray_sort_heuristic(jscene, lanes))


def _winners(prep, o, d):
    """(best t, the winning sphere's center and r^2) of rays through the
    plain twin's per-thread cluster cull."""
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    a = (d * d).sum(dim=1)
    t, i = wf._sphere_hits_plain(prep, *o.unbind(1), *d.unbind(1), a,
                                 1.0 / a, torch.zeros_like(a))
    return t, prep.geom[i]


def test_grid_and_sah_find_the_same_winners(monkeypatch):
    """The cell-face count: on rays aimed at the grid's cell faces of the
    final scene's cloud, and on rays leaving cloud spheres, the grid
    tables and the SAH tables give the same closest hit (t and sphere),
    through the plain twin's cull.  A clipped cell box could drop a root
    that lies a rounding past its face; none does here."""
    scene, cfg, _ = models.get_scene("the_next_week")
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=cfg.image_width, height=cfg.image_height,
              tile_rows=wf.wavefront_tile_rows(scene), device="cpu")
    sah = mk.prepare_megakernel(scene, cam, **kw)
    monkeypatch.setenv("RTT_SPHERE_GRID", "1")
    grid = mk.prepare_megakernel(scene, cam, **kw)
    assert grid.geom.shape[0] > sah.geom.shape[0]
    c, r = _final_cloud()
    o, d = torch_scenes.cell_face_rays(c, r, 6000, seed=1)
    rng = np.random.default_rng(2)
    k = rng.choice(np.where(r < 20)[0], 2000)
    nrm = rng.normal(size=(2000, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    o = np.concatenate([o, c[k] + r[k, None] * nrm]).astype(np.float32)
    d = np.concatenate([d, nrm]).astype(np.float32)
    ts, gs = _winners(sah, o, d)
    tg, gg = _winners(grid, o, d)
    hit = ts < 1e30
    assert hit.float().mean() > 0.9
    assert torch.equal(hit, tg < 1e30)
    differ = hit & ((ts != tg) | (gs != gg).any(dim=1))
    assert int(differ.sum()) == 0


def test_grid_render_matches_sah(monkeypatch):
    """The final scene through ``render_image`` on the CPU (the kernels'
    plain twins) at width 48, 8 spp, depth 4: the grid's image within 5
    SE of the SAH image (the same draws, so also pixel for pixel here)."""
    scene, cfg, integ = models.get_scene(
        "the_next_week", dict(image_width=48, samples_per_pixel=8,
                              max_depth=4))
    _, sah = render.render_image(scene, cfg, integrator=integ, device="cpu")
    monkeypatch.setenv("RTT_SPHERE_GRID", "1")
    _, grid = render.render_image(scene, cfg, integrator=integ, device="cpu")
    a, b = grid["accum"] / 8, sah["accum"] / 8
    assert np.all(np.isfinite(a))
    _block_agreement(a, b)
    np.testing.assert_array_equal(a, b)

"""The port's persist path tracer (plain step on the CPU): exact sample
accounting, bitwise invariance of the sums to the ray sort and to the
launch bound, and camera spawn against the JAX ray generator.  The CUDA
kernel is held against the plain step in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from rustraytrace_tpu.camera import generate_rays  # noqa: E402
from rustraytrace_tpu.config import RenderConfig as JaxRenderConfig  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu.ops import pallas_wavefront as jwf  # noqa: E402
from rustraytrace_tpu_torch import RenderConfig, SceneBuilder, models  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402

BG = (0.25, 0.5, 0.75)


def _all_miss_scene():
    """One sphere far behind the camera and a flat background: every
    sample contributes exactly BG (test_megakernel_tpu.py's setup)."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 1000.0), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    cfg = RenderConfig(image_width=64, samples_per_pixel=32, max_depth=8,
                       background=BG, lookfrom=(0.0, 0.0, 0.0),
                       lookat=(0.0, 0.0, -1.0))
    return b.build(), cfg


def test_sample_accounting_exact():
    scene, cfg = _all_miss_scene()
    h, w, spp = cfg.image_height, cfg.image_width, 32
    cam = derive_camera(cfg, "cpu")
    acc = wf.render_pass_wavefront(scene, cam, 3, width=w, height=h,
                                   spp=spp, max_depth=8, device="cpu")
    expect = np.broadcast_to(np.float32(spp) * np.float32(BG), (h, w, 3))
    np.testing.assert_array_equal(acc.numpy(), expect)
    # lane bookkeeping after the launch loop: every lane did exactly spp
    # samples and has none in flight
    tables = mk.prepare_megakernel(scene, cam, width=w, height=h, device="cpu")
    state = torch.zeros((wf.N_STATE, tables.n_lanes))
    slot = torch.arange(tables.n_lanes, dtype=torch.int32)
    for _ in range(spp * 8 + 2):
        wf.persist_step(state, slot, tables, 3, persist_iters=5, spp=spp,
                        max_depth=8)
    assert torch.all(state[wf.R_DONE] == spp)
    assert torch.all(state[wf.R_MID] == 0)
    assert torch.all(state[wf.R_SX:wf.R_SX + 3].T
                     == torch.tensor(BG) * spp)


def test_sums_bitwise_invariant_to_sort_and_launch_bound():
    scene, cfg, _ = models.book1_random_spheres(dict(image_width=64))
    tables = mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=64,
                                   height=cfg.image_height, device="cpu")
    runs = {}
    for sort in (True, False):
        for iters in (4, 16):
            stats = {}
            runs[sort, iters] = wf._wavefront_pass_persist(
                tables, 7, 16, spp=8, max_depth=8, persist_iters=iters,
                sort_rays=sort, stats=stats)
            assert stats["launches"] >= 2
    ref = runs[False, 4]
    assert torch.all(torch.isfinite(ref)) and float(ref.sum()) > 0
    for key, sums in runs.items():
        assert torch.equal(sums, ref), key


def test_camera_spawn_matches_jax_generate_rays():
    _, cfg, _ = models.book1_random_spheres(dict(image_width=64))
    jcfg = JaxRenderConfig(**{k: getattr(cfg, k) for k in (
        "aspect_ratio", "image_width", "samples_per_pixel", "max_depth",
        "vfov", "lookfrom", "lookat", "vup", "defocus_angle",
        "focus_dist")})
    tables = mk.prepare_megakernel(
        models.book1_random_spheres(dict(image_width=64))[0],
        derive_camera(cfg, "cpu"), width=64, height=cfg.image_height, device="cpu")
    px, py, rows = jwf._slot_pixels(64, cfg.image_height, 32)
    n = rows * 128
    u = np.random.default_rng(0).uniform(size=(n, 5)).astype(np.float32)
    u[:, 4] = 0.0
    o_ref, d_ref, _ = generate_rays(jax_derive_camera(jcfg), px, py,
                                    jnp.asarray(u))
    o, d = wf.spawn_rays(tables.cam_u, torch.from_numpy(np.array(px)),
                         torch.from_numpy(np.array(py)),
                         *(torch.from_numpy(u[:, k]) for k in range(4)),
                         defocus=True)
    np.testing.assert_allclose(torch.stack(o, 1).numpy(), np.asarray(o_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.stack(d, 1).numpy(), np.asarray(d_ref),
                               rtol=1e-5, atol=1e-5)


def _field_scene(n, seed):
    """n small spheres scattered over the flagship's ground sphere."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    mat = b.lambertian((0.4, 0.2, 0.1))
    for x, z, r in zip(rng.uniform(-15, 15, n), rng.uniform(-15, 15, n),
                       rng.uniform(0.1, 0.3, n)):
        b.add_sphere((float(x), float(r), float(z)), float(r), mat)
    return b.build()


def _cull_tables(name):
    if name == "flagship":
        scene, cfg, _ = models.book1_random_spheres(dict(image_width=32))
    else:
        scene = _field_scene(1500, 4)
        cfg = RenderConfig(image_width=32)
    return mk.prepare_megakernel(scene, derive_camera(cfg, "cpu"), width=32,
                                 height=cfg.image_height, device="cpu")


def _ray_args(o, d):
    o = torch.as_tensor(np.asarray(o, np.float32).reshape(-1, 3))
    d = torch.as_tensor(np.asarray(d, np.float32).reshape(-1, 3))
    a = (d * d).sum(1)
    return (*o.T, *d.T, a, 1.0 / a)


@pytest.mark.parametrize("name", ["flagship", "field_1500"])
def test_plain_cull_finds_the_full_scan_winner(name):
    """The twin's cluster cull (one level on the flagship, two on a 1500-
    sphere field) picks the full scan's winner on seeded rays."""
    tables = _cull_tables(name)
    assert tables.n_clusters > 0
    assert (tables.n_sclusters > 1) == (name == "field_1500")
    rng = np.random.default_rng(8)
    o = rng.uniform(-12, 12, (4096, 3)) + np.asarray([0.0, 3.0, 0.0])
    d = np.where((rng.uniform(size=4096) < 0.7)[:, None],
                 rng.uniform(-10, 10, (4096, 3)) * [1, 0, 1] - o,
                 rng.normal(size=(4096, 3)))
    args = _ray_args(o, d)
    t_c, i_c = wf._sphere_hits_plain(tables, *args)
    t_f, i_f = wf._sphere_rows_min(tables.geom, *args)
    hit = t_f < 1e29
    assert int(hit.sum()) > 2000
    assert torch.equal(t_c, t_f)
    assert torch.equal(i_c[hit], i_f[hit])


def test_plain_cull_drops_a_root_past_its_box_as_the_kernel_does():
    """A ray 3.5e-5 under the ground sphere's surface (r = 1000), from a
    4K flagship path: the f32 exit root (~1.5e-3) lies past the box's top
    face (exit 8.5e-4 < T_MIN), so the kernel's cull misses the ground
    where a full scan hits it.  The twin must cull the same way."""
    tables = _cull_tables("flagship")
    args = _ray_args((-0.144117892, -3.47942114e-05, -0.137541652),
                     (0.0369626693, 0.0410585999, -0.281303614))
    t_f, i_f = wf._sphere_rows_min(tables.geom, *args)
    assert float(t_f[0]) < 2e-3
    assert float(tables.geom[int(i_f[0]), 3]) == 1e6  # the ground sphere
    t_c, _ = wf._sphere_hits_plain(tables, *args)
    assert float(t_c[0]) > 1e29

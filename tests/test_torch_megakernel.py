"""The respawn megakernel K3 (plain twin on the CPU) and the slice it opens:
K3 equals the unsorted persist loop bitwise; the Book-3 and Book-2 Cornell
boxes through ``render_image`` against the JAX package's XLA backend,
statistically; and the routing of scenes and integrators to K2 or K3.  The
CUDA kernel is held against its plain twin in test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several test processes on shared cores: one torch thread
# each avoids oversubscription (small tensors gain nothing from more)
torch.set_num_threads(1)

import jax  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu import render as jrender  # noqa: E402
from rustraytrace_tpu.config import derive_camera as jax_derive_camera  # noqa: E402
from rustraytrace_tpu_torch import SceneBuilder, models, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.ops import megakernel as mk  # noqa: E402
from rustraytrace_tpu_torch.ops import wavefront as wf  # noqa: E402


@pytest.mark.parametrize("name,spp", [("book1_three_spheres", 8),
                                      ("book3_cornell_box", 16)])
def test_respawn_pass_equals_unsorted_persist_loop(name, spp):
    """Same tables, same seed and sample offset: K3's one pass and the
    bounded, unsorted launch loop bank bitwise equal sums, because both run
    the same lane step keyed by (slot, sample, bounce, stream)."""
    scene, cfg, integ = models.get_scene(
        name, dict(image_width=24, samples_per_pixel=spp))
    n = int(np.sqrt(spp)) if cfg.stratified else 0
    tables = mk.prepare_megakernel(
        scene, derive_camera(cfg, "cpu"), width=24, height=cfg.image_height,
        mis=integ == "mis", stratified=cfg.stratified, sqrt_spp=n, device="cpu")
    k3 = mk.respawn_pass(tables, 13, 5, spp, 8)
    k2 = wf._wavefront_pass_persist(tables, 13, 5, spp=spp, max_depth=8,
                                    persist_iters=3, sort_rays=False)
    assert k3.shape == (tables.n_lanes, 3)
    assert torch.all(torch.isfinite(k3)) and float(k3.sum()) > 0
    assert torch.equal(k3, k2)


@pytest.mark.parametrize("name,spp", [("book3_cornell_box", 64),
                                      ("book2_cornell_box", 32)])
def test_cornell_render_image_matches_jax_xla(name, spp):
    """``render_image`` (plain K3 on the CPU) vs JAX ``render_pass`` on the
    XLA backend at 24x24, depth 8: per-channel means within 0.02, and the
    means of a 4x4 grid of blocks within 5 standard errors, as
    test_torch_slice.py holds the Book-1 scenes.  Independent random
    streams; each block's standard error comes from the spread of its
    per-pixel differences."""
    w, depth = 24, 8
    over = dict(image_width=w, samples_per_pixel=spp, max_depth=depth)
    jscene, jcfg, jinteg = jmodels.get_scene(name, over)
    scene, cfg, integ = models.get_scene(name, over)
    assert integ == jinteg
    n = int(np.sqrt(spp)) if cfg.stratified else 0
    ref = np.asarray(jrender.render_pass(
        jscene, jax_derive_camera(jcfg), jax.random.key(0), width=w,
        height=w, spp=spp, max_depth=depth, integrator=jinteg,
        backend="xla", chunk=576, stratified=cfg.stratified,
        sqrt_spp=n)) / spp
    img_u8, state = render.render_image(scene, cfg, integrator=integ, device="cpu")
    assert state["spp_done"] == spp and img_u8.shape == (w, w, 3)
    got = state["accum"] / spp
    assert np.all(np.isfinite(got))
    # the room is lit: a black image would mean the light never counted
    assert got.mean() > 0.05
    err = np.abs(got.mean(axis=(0, 1)) - ref.mean(axis=(0, 1)))
    assert err.max() < 0.02, (got.mean(axis=(0, 1)), ref.mean(axis=(0, 1)))
    diff = got - ref
    for ys in np.array_split(np.arange(w), 4):
        for xs in np.array_split(np.arange(w), 4):
            blk = diff[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1].reshape(-1, 3)
            se = blk.std(axis=0, ddof=1) / np.sqrt(blk.shape[0])
            assert np.all(np.abs(blk.mean(axis=0)) < 5 * se + 1e-6), (
                ys[0], xs[0], blk.mean(axis=0), se)


def test_stratified_render_counts_a_square_number_of_samples():
    scene, cfg, integ = models.book3_cornell_box(
        dict(image_width=8, samples_per_pixel=10, max_depth=2))
    _, state = render.render_image(scene, cfg, integrator=integ, device="cpu")
    assert state["spp_done"] == 9


def test_routes_follow_the_jax_package():
    three, _, _ = models.book1_three_spheres()
    flagship, _, _ = models.book1_random_spheres()
    cornell, _, _ = models.book3_cornell_box()
    # the slice's main path: one K3 pass over 19x19 blocks of 1024 slots
    assert wf.slot_lane_count(600, 600) == 369_664
    tables = mk.prepare_megakernel(
        cornell, derive_camera(models.book3_cornell_box()[1], "cpu"), width=600,
        height=600, mis=True, stratified=True, sqrt_spp=10, device="cpu")
    assert tables.n_lanes == 372_736
    assert (tables.n_quads, tables.n_lights, tables.unroll) == (12, 2, 1)
    assert not wf.sorted_persist_route(cornell, 600, 600)
    assert not wf.sorted_persist_route(three, 1200, 675)
    assert wf.sorted_persist_route(flagship, 1200, 675)
    assert not wf.sorted_persist_route(flagship, 3840, 2160)  # > 2 Mi lanes
    assert render.effective_spp_per_pass(
        models.book3_cornell_box()[1], "megakernel", 100, 600 * 600) == 100


def test_mis_routes_to_the_megakernel_on_cuda(monkeypatch):
    cornell, _, _ = models.book3_cornell_box()
    assert render.resolve_backend(cornell, "mis", device="cpu") == "plain"
    # the rule on a CUDA device, without needing one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert render.resolve_backend(cornell, "mis", device="cuda") == (
        "megakernel")
    assert render.resolve_backend(cornell, "path", device="cuda") == (
        "wavefront")


def test_unsupported_mis_and_quad_scenes_raise():
    """MIS without NEE lights still raises in the kernel routes, and on
    'auto' takes the reference route (the JAX package's XLA route); 32 or
    more quads (SAH quad clusters) and isotropic media under MIS are ported
    and route to the kernels."""
    assert mk.megakernel_mis_eligible(models.book3_cornell_box()[0])
    box, _, _ = models.book2_cornell_box()  # no NEE lights
    with pytest.raises(NotImplementedError, match="1 to 16 NEE lights"):
        render.resolve_backend(box, "mis", "megakernel")
    with pytest.raises(NotImplementedError, match="1 to 16 NEE lights"):
        mk.megakernel_mis_eligible(box)
    assert render.resolve_backend(box, "mis") == "reference"
    b = SceneBuilder()
    for k in range(mk.QUAD_CLUSTER_MIN):
        b.add_quad((k, 0, 0), (1, 0, 0), (0, 1, 0), b.lambertian((.5,) * 3))
    assert render.resolve_backend(b.build(), "path", device="cpu") == "plain"
    fog = SceneBuilder()
    fog.add_sphere((0, 0, 0), 1.0, fog.isotropic((.5,) * 3))
    fog.add_light_sphere((0, 5, 0), 1.0)
    assert render.resolve_backend(fog.build(), "mis", device="cpu") == (
        "plain")

"""The port's sharded rendering (``parallel``) on the CPU: the twins of
``tests/test_parallel.py:34-136``, the sharded image loop and the kernel
routes' sharded passes.

Sharding is an execution choice, not a semantics choice.  The port's
draws are keyed by (pixel or slot, absolute sample, bounce, stream), never
by rank, so the sample set does not depend on the mesh: pixel-sharded
renders are bitwise equal to the 1-rank render, spp-sharded ones equal up
to the order of the f32 sums (rtol 1e-5 / atol 1e-5, the JAX test's), and
the 1-rank ``render_image_sharded`` is ``render.render_image`` bitwise on
the reference route and on the kernel loop's plain twins.

Meshes of 8 ranks are run in this process, rank by rank without a
process group (each rank's part), and summed: what ``all_reduce`` adds.
The 2-process cases run ``gloo`` with file init in the test's own
directory, as ``tests/test_torch_diff_parallel.py`` does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from rustraytrace_tpu import models as jmodels  # noqa: E402
from rustraytrace_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from rustraytrace_tpu.parallel import render as jprender  # noqa: E402
from rustraytrace_tpu_torch import models, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.parallel import (Mesh, render_image_sharded,  # noqa: E402
                                             render_pass_sharded,
                                             resolve_sharded_backend,
                                             sharded_megakernel_wiring,
                                             spp_traced, spp_traced_mesh)
from rustraytrace_tpu_torch.parallel import megakernel as pmk  # noqa: E402
from rustraytrace_tpu_torch.parallel import render as prender  # noqa: E402
from test_torch_reference import _block_agreement  # noqa: E402

CHUNK = 256  # shared by both sides, so the chunks' batches coincide
KW = dict(width=32, height=16, spp=4, max_depth=5, chunk=CHUNK,
          device="cpu")


def _small():
    scene, cfg, _ = models.book1_three_spheres(
        dict(image_width=32, samples_per_pixel=4, max_depth=5,
             spp_per_pass=4))
    cfg = cfg.replace(aspect_ratio=2.0)  # 32 x 16
    return scene, cfg, derive_camera(cfg, "cpu")


def _tiny():
    """book1_three_spheres at 16 x 8, 4 spp, depth 3, passes of 2."""
    scene, cfg, integ = models.book1_three_spheres(
        dict(image_width=16, samples_per_pixel=4, max_depth=3,
             spp_per_pass=2))
    return scene, cfg.replace(aspect_ratio=2.0), integ


def _box(spp=16, depth=6):
    """The stratified Book-3 box at 16 x 16, passes of 4."""
    return models.book3_cornell_box(dict(
        image_width=16, samples_per_pixel=spp, max_depth=depth,
        spp_per_pass=4))


def _emulated(px: int, spp: int, fn):
    """The sum over the ranks of a (px, spp) mesh of ``fn(mesh)``, each
    rank run here without a group (so it returns its own part)."""
    out = None
    for r in range(px * spp):
        part = fn(Mesh(px, spp, r // spp, r % spp))
        out = part if out is None else out + part
    return out


def test_pixel_sharded_bit_identical():
    scene, _, cam = _small()
    single = render.render_pass(scene, cam, 7, backend="reference", **KW)
    sharded = _emulated(8, 1, lambda m: render_pass_sharded(
        scene, cam, 7, mesh=m, **KW))
    assert torch.equal(single, sharded)


def test_spp_sharded_allclose():
    scene, _, cam = _small()
    single = render.render_pass(scene, cam, 7, backend="reference", **KW)
    assert spp_traced(4, Mesh(4, 2)) == 4
    sharded = _emulated(4, 2, lambda m: render_pass_sharded(
        scene, cam, 7, mesh=m, **KW))
    np.testing.assert_allclose(single.numpy(), sharded.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_spp_round_up():
    assert spp_traced(5, Mesh(4, 2)) == 6
    # the kernel routes split samples over every rank, whatever the shape
    assert spp_traced_mesh(5, Mesh(4, 2)) == 8
    assert spp_traced_mesh(5, Mesh(1, 1)) == 5


def test_stratified_sharded_pass_takes_the_sample_offset():
    """Strata of absolute samples ``sample_offset + [0, spp)``: the pass
    at an offset equals ``render_pass`` at that offset, not at 0."""
    scene, cfg, _ = _box(spp=16, depth=4)
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=16, height=16, spp=4, max_depth=4, integrator="mis",
              chunk=CHUNK, stratified=True, sqrt_spp=4, device="cpu")
    for off in (0, 6):
        want = render.render_pass(scene, cam, 3, sample_offset=off,
                                  backend="reference", **kw)
        got = render_pass_sharded(scene, cam, 3, sample_offset=off, **kw)
        assert torch.equal(got, want), off
        spp_split = _emulated(1, 2, lambda m: render_pass_sharded(
            scene, cam, 3, mesh=m, sample_offset=off, **kw))
        np.testing.assert_allclose(spp_split.numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert not torch.equal(got, render.render_pass(
        scene, cam, 3, backend="reference", **kw))


@pytest.mark.parametrize("backend", ["reference", "plain"])
def test_render_image_sharded_matches_single(backend):
    """One rank: bitwise equal to ``render_image`` on the same route, over
    several passes (so ``sample_offset`` is used), with the same pass
    schedule and the same ``on_pass`` host copies."""
    scene, cfg, integ = _box(depth=6 if backend == "reference" else 4)
    seen = {"one": [], "mesh": []}

    def hooks(k):
        return dict(progress=lambda d, t: seen[k].append((d, t)),
                    on_pass=lambda st: seen[k].append(
                        (st["accum"].device.type, st["spp_done"])))

    img1, st1 = render.render_image(scene, cfg, integrator=integ,
                                    chunk=CHUNK, backend=backend,
                                    device="cpu", **hooks("one"))
    img, st = render_image_sharded(scene, cfg, integrator=integ, chunk=CHUNK,
                                   backend=backend, device="cpu",
                                   **hooks("mesh"))
    assert st["spp_done"] == st1["spp_done"] == 16
    assert seen["mesh"] == seen["one"]
    assert ("cpu", 4) in seen["mesh"] and (8, 16) in seen["mesh"]
    np.testing.assert_array_equal(st["accum"], st1["accum"])
    np.testing.assert_array_equal(img, img1)


def test_sharded_routing_decision_table():
    """Every (backend, integrator, megakernel-eligible, wavefront-eligible)
    combination: the port's ``resolve_sharded_backend`` returns what the
    JAX package's returns with the same injected predicates, or raises
    ``ValueError`` where it raises."""
    from rustraytrace_tpu.parallel.render import \
        resolve_sharded_backend as jax_resolve

    scene, _, _ = _small()
    jscene = jmodels.book1_three_spheres()[0]
    jmesh = jax_make_mesh(jax.devices())
    mesh = Mesh(1, 1)
    pred = {True: lambda s, i, m: True, False: lambda s, i, m: False}
    n = 0
    for be in ("auto", "xla", "megakernel", "wavefront", "sphere_kernel",
               "bogus"):
        for integ in ("path", "mis", "nonsense"):
            for mk_ok in (True, False):
                for wf_ok in (True, False):
                    try:
                        want = jax_resolve(jscene, integ, jmesh, be,
                                           _mk_eligible=pred[mk_ok],
                                           _wf_eligible=pred[wf_ok])
                    except ValueError:
                        want = ValueError
                    try:
                        got = resolve_sharded_backend(
                            scene, integ, mesh, be, _mk_eligible=pred[mk_ok],
                            _wf_eligible=pred[wf_ok])
                    except ValueError:
                        got = ValueError
                    assert got == want, (be, integ, mk_ok, wf_ok)
                    n += 1
    assert n == 72
    # the port's names: 'reference' is 'xla'; 'plain' runs the kernel loop
    # on the twins, for the kernels' integrators only
    assert resolve_sharded_backend(scene, "nonsense", mesh,
                                   "reference") == "xla"
    for integ in ("path", "mis"):
        assert resolve_sharded_backend(scene, integ, mesh, "plain") == "plain"
    with pytest.raises(ValueError):
        resolve_sharded_backend(scene, "nonsense", mesh, "plain")
    # the default predicates: 'auto' is the reference route on the CPU, as
    # JAX's on a CPU mesh; a card asked for and missing raises
    box = _box()[0]
    for s, integ in ((scene, "path"), (box, "mis")):
        assert resolve_sharded_backend(s, integ, mesh, device="cpu") == "xla"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_sharded_backend(scene, "path", mesh)


def test_kernel_shard_eligibility_on_a_card_follows_the_scene(monkeypatch):
    """On a CUDA device the predicates follow the scene: the megakernels
    take covered scenes without image textures, the wavefront route the
    image-textured ones too, nothing takes a scene the kernels do not
    cover (``kernel_gap``)."""
    monkeypatch.setattr(pmk, "_on_cuda", lambda device: True)
    mesh = Mesh(1, 1)
    book1 = _small()[0]
    earth = models.book2_earth(dict(image_width=16))[0]
    box = _box()[0]
    assert pmk.megakernel_shard_eligible(book1, "path", mesh)
    assert pmk.megakernel_shard_eligible(box, "mis", mesh)
    assert not pmk.megakernel_shard_eligible(book1, "mis", mesh)  # no light
    assert not pmk.megakernel_shard_eligible(earth, "path", mesh)
    assert pmk.wavefront_shard_eligible(earth, "path", mesh)
    assert not pmk.wavefront_shard_eligible(book1, "nonsense", mesh)
    assert resolve_sharded_backend(book1, "path", mesh) == "wavefront"
    assert resolve_sharded_backend(box, "mis", mesh) == "megakernel"
    assert resolve_sharded_backend(earth, "path", mesh) == "wavefront"
    assert resolve_sharded_backend(book1, "mis", mesh) == "xla"


def test_mis_integrator_sharded():
    """The Book-3 MIS estimator sharded over 8 pixel ranks."""
    scene, cfg, _ = models.book3_cornell_box(
        dict(image_width=16, samples_per_pixel=4, max_depth=4,
             stratified=False))
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=16, height=16, spp=4, max_depth=4, chunk=CHUNK,
              integrator="mis", device="cpu")
    single = render.render_pass(scene, cam, 3, backend="reference", **kw)
    sharded = _emulated(8, 1, lambda m: render_pass_sharded(
        scene, cam, 3, mesh=m, **kw))
    assert float(single.sum()) > 0
    assert torch.equal(single, sharded)


def test_wiring_hands_each_rank_its_offset():
    """``sharded_megakernel_wiring`` calls the pass with the rank's own
    offset (px-major rank order, as JAX flattens its mesh), and the
    kernel routes' sharded pass traces every sample of the 1-rank pass
    once: the ranks' parts on the plain twins add up to it."""
    seen = []
    offsets = [10, 11, 12, 13, 14, 15]
    for r in range(6):
        mesh = Mesh(3, 2, r // 2, r % 2)
        out = sharded_megakernel_wiring(
            lambda a, s, off: seen.append((a, s, off)) or torch.ones(1),
            "arrays", 5, offsets, mesh)
        assert torch.equal(out, torch.ones(1))
    assert seen == [("arrays", 5, o) for o in offsets]

    scene, cfg, _ = _tiny()
    cam = derive_camera(cfg, "cpu")
    kw = dict(width=16, height=8, spp=4, max_depth=3, sample_offset=2,
              device="cpu")
    one = pmk.render_pass_wavefront_sharded(
        scene, cam, 9, step=None, respawn_step=pmk.mk.respawn_pass_plain,
        **kw)
    parts = _emulated(2, 1, lambda m: pmk.render_pass_wavefront_sharded(
        scene, cam, 9, mesh=m, step=None,
        respawn_step=pmk.mk.respawn_pass_plain, **kw))
    np.testing.assert_allclose(parts.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)
    # K4's twin (respawn=False, the JAX default) on the same samples
    mono = _emulated(1, 2, lambda m: pmk.render_pass_megakernel_sharded(
        scene, cam, 9, mesh=m, step=pmk.mk.mono_pass_plain, **kw))
    np.testing.assert_allclose(mono.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape,spp,per_pass,stratified", [
    ((1, 2), 7, 3, False), ((2, 1), 7, 3, False),
    ((1, 2), 10, 4, True), ((2, 1), 10, 4, True), ((1, 2), 41, 0, False)])
def test_pass_schedule_matches_jax(monkeypatch, shape, spp, per_pass,
                                   stratified):
    """The ``(done, total)`` pairs ``progress`` receives: the port's loop
    against the JAX loop on a 2-device JAX mesh of the same shape (both
    passes stubbed: the schedule is the loop's alone)."""
    import jax.numpy as jnp

    over = dict(image_width=16, samples_per_pixel=spp, max_depth=2,
                spp_per_pass=per_pass, stratified=stratified)
    jscene, jcfg, _ = jmodels.book1_three_spheres(over)
    scene, cfg, _ = models.book1_three_spheres(over)
    h, w = cfg.image_height, cfg.image_width
    jmesh = jax_make_mesh(jax.devices()[:2], spp_shards=shape[1])
    assert dict(jmesh.shape) == {"px": shape[0], "spp": shape[1]}
    monkeypatch.setattr(jprender, "render_pass_sharded",
                        lambda *a, **k: jnp.zeros((h, w, 3), jnp.float32))
    monkeypatch.setattr(prender, "render_pass_sharded",
                        lambda *a, **k: torch.zeros((h, w, 3)))
    want, got = [], []
    jprender.render_image_sharded(jscene, jcfg, mesh=jmesh, backend="xla",
                                  progress=lambda d, t: want.append((d, t)))
    render_image_sharded(scene, cfg, mesh=Mesh(*shape), backend="xla",
                         progress=lambda d, t: got.append((d, t)),
                         device="cpu")
    assert got == want and len(want) >= 2


def test_sharded_image_matches_jax():
    """The slice against JAX: the port's sharded image (one rank, the
    reference route 'auto' takes on the CPU) against the JAX package's on
    a 2-device mesh (xla); channel means within 0.02, 4x4 blocks within 5
    SE (independent streams)."""
    over = dict(image_width=40, samples_per_pixel=8, max_depth=6)
    jscene, jcfg, integ = jmodels.get_scene("book1_three_spheres", over)
    scene, cfg, _ = models.get_scene("book1_three_spheres", over)
    _, jst = jprender.render_image_sharded(
        jscene, jcfg, mesh=jax_make_mesh(jax.devices()[:2]),
        integrator=integ, chunk=4096)
    _, st = render_image_sharded(scene, cfg, integrator=integ, device="cpu")
    assert st["spp_done"] == jst["spp_done"] == 8
    got = st["accum"] / 8
    assert np.all(np.isfinite(got))
    _block_agreement(got, np.asarray(jst["accum"]) / 8)


def test_no_fallback_a_failed_pass_raises(monkeypatch):
    """A kernel pass that fails at the second pass raises out of
    ``render_image_sharded`` after ``on_pass`` saw the first: nothing
    re-runs on the reference route."""
    scene, cfg, integ = _tiny()
    real = pmk.render_pass_wavefront_sharded
    calls = []

    def failing(*a, **k):
        calls.append(k["sample_offset"])
        if len(calls) == 2:
            raise RuntimeError("injected kernel failure")
        return real(*a, **k)

    monkeypatch.setattr(pmk, "render_pass_wavefront_sharded", failing)
    seen = []
    with pytest.raises(RuntimeError, match="injected"):
        render_image_sharded(scene, cfg, integrator=integ, backend="plain",
                             on_pass=lambda st: seen.append(st["spp_done"]),
                             device="cpu")
    assert calls == [0, 2] and seen == [2]


WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, init, out, px, spp = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                            int(sys.argv[4]), int(sys.argv[5]))
sys.path.insert(0, sys.argv[6])
from rustraytrace_tpu_torch.parallel import (initialize, make_mesh,
                                             render_image_sharded,
                                             render_pass_sharded)
initialize("file://" + init, world_size=2, rank=rank, device="cpu")
import test_torch_parallel as t
from rustraytrace_tpu_torch.config import derive_camera
mesh = make_mesh(spp_shards=spp)
scene, cfg, integ = t._tiny()
sched = []
_, plain = render_image_sharded(scene, cfg, integrator=integ, mesh=mesh,
                                backend="plain", device="cpu",
                                progress=lambda d, n: sched.append((d, n)))
_, ref = render_image_sharded(scene, cfg, integrator=integ, mesh=mesh,
                              backend="xla", chunk=t.CHUNK, device="cpu")
box, bcfg, _ = t._box(depth=4)
strat = render_pass_sharded(box, derive_camera(bcfg, "cpu"), 3, mesh=mesh,
                            **t.STRAT)
torch.save({"mesh": (mesh.px, mesh.spp, mesh.px_idx, mesh.spp_idx),
            "plain": torch.from_numpy(plain["accum"]),
            "ref": torch.from_numpy(ref["accum"]),
            "strat": strat, "sched": sched}, out)
"""

STRAT = dict(width=16, height=16, spp=4, max_depth=4, integrator="mis",
             chunk=CHUNK, stratified=True, sqrt_spp=4, sample_offset=6,
             device="cpu")


def _two_ranks(tmp_path, px, spp):
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    init = str(tmp_path / f"pg_{px}_{spp}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), init,
         str(tmp_path / f"out_{px}_{spp}_{r}.pt"), str(px), str(spp), here],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    return [torch.load(tmp_path / f"out_{px}_{spp}_{r}.pt")
            for r in range(2)]


@pytest.mark.parametrize("px,spp", [(1, 2), (2, 1)])
def test_two_ranks_match_one(tmp_path, px, spp):
    """2 processes on gloo, spp-sharded (1 x 2) or pixel-sharded (2 x 1):
    every rank holds the whole sum.  The kernel loop's twins
    (``backend="plain"``) split the samples over both ranks whatever the
    shape, so they equal one process's ``render_image`` up to the order
    of the sums; the reference route's image is bitwise equal pixel-
    sharded and close spp-sharded, and so is a stratified pass at an
    offset."""
    outs = _two_ranks(tmp_path, px, spp)
    scene, cfg, integ = _tiny()
    _, plain1 = render.render_image(scene, cfg, integrator=integ,
                                    backend="plain", device="cpu")
    _, ref1 = render.render_image(scene, cfg, integrator=integ,
                                  backend="reference", chunk=CHUNK,
                                  device="cpu")
    box, bcfg, _ = _box(depth=4)
    strat1 = render.render_pass(box, derive_camera(bcfg, "cpu"), 3,
                                backend="reference", **STRAT)
    for r, out in enumerate(outs):
        assert out["mesh"] == (px, spp, r // spp, r % spp)
        # passes of 2 spp (rounded up to the 2 ranks): 2, then 4
        assert out["sched"] == [(2, 4), (4, 4)]
        np.testing.assert_allclose(out["plain"].numpy(), plain1["accum"],
                                   rtol=1e-5, atol=1e-5)
        if spp == 1:
            np.testing.assert_array_equal(out["ref"].numpy(), ref1["accum"])
        else:
            np.testing.assert_allclose(out["ref"].numpy(), ref1["accum"],
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["strat"].numpy(), strat1.numpy(),
                                   rtol=1e-5, atol=1e-5)
    for k in ("plain", "ref", "strat"):
        assert torch.equal(outs[0][k], outs[1][k]), k

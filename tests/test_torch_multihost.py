"""The port's multi-process bring-up and render (``parallel/multihost.py``)
on the CPU: the twins of ``tests/test_multihost.py:103`` and ``:136`` (two
real processes on ``gloo``, file init in the test's own directory) and of
``tests/test_metrics.py:33`` (one process).

Two processes render the same scene through ``render_image_multihost``
and must hold the identical framebuffer, equal to one process's render
(bitwise on the pixel-sharded mesh, up to the order of the sums on the
spp-sharded one), and a checkpoint/resume cycle under the sharded loop
must reproduce the uninterrupted render bitwise on every rank (the draws
are keyed by absolute sample, so the pass split changes nothing).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rustraytrace_tpu_torch import models, render  # noqa: E402
from rustraytrace_tpu_torch.parallel import (global_mesh, initialize,  # noqa: E402
                                             make_assemble,
                                             render_image_multihost,
                                             render_image_sharded)


def _scene(spp):
    scene, cfg, integ = models.book1_three_spheres(
        dict(image_width=16, samples_per_pixel=spp, max_depth=3,
             spp_per_pass=2))
    return scene, cfg.replace(aspect_ratio=2.0), integ  # 16 x 8


CHILD = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, init, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
import torch.distributed as dist
from rustraytrace_tpu_torch.parallel import multihost
multihost.initialize("file://" + init, world_size=2, rank=rank,
                     device="cpu")
assert dist.get_world_size() == 2 and dist.get_rank() == rank
import test_torch_multihost as t
scene, cfg, integ = t._scene(2)
img, state = multihost.render_image_multihost(scene, cfg, integrator=integ,
                                              chunk=256, device="cpu")
np.savez(os.path.join(outdir, f"out_{rank}.npz"), img=img,
         accum=state["accum"], spp=state["spp_done"])
"""

CHILD_SPP = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, init, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
from rustraytrace_tpu_torch.parallel import multihost
from rustraytrace_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
multihost.initialize("file://" + init, world_size=2, rank=rank,
                     device="cpu")
# spp-sharded: each process owns one sample shard
mesh = multihost.global_mesh(spp_shards=2)
assert mesh.shape == {"px": 1, "spp": 2} and mesh.spp_idx == rank
import test_torch_multihost as t
scene, cfg, integ = t._scene(4)
kw = dict(mesh=mesh, integrator=integ, chunk=256, device="cpu")
img_full, st_full = multihost.render_image_multihost(scene, cfg, **kw)
assert st_full["spp_done"] == 4
# render the first pass only, checkpoint the assembled state (each
# process its own copy), then resume the second pass from it
assemble = multihost.make_assemble(mesh)
states = []
multihost.render_image_multihost(
    scene, cfg.replace(samples_per_pixel=2), on_pass=lambda s: states.append(
        {"accum": assemble(s["accum"]), "spp_done": s["spp_done"]}), **kw)
ck = os.path.join(outdir, f"ck_{rank}.npz")
save_checkpoint(ck, states[-1], cfg, scene)
resumed = load_checkpoint(ck, cfg, scene)
assert resumed["spp_done"] == 2
img_res, st_res = multihost.render_image_multihost(
    scene, cfg, accum_state=resumed, **kw)
assert st_res["spp_done"] == 4
np.savez(os.path.join(outdir, f"spp_{rank}.npz"), img_full=img_full,
         accum_full=st_full["accum"], img_res=img_res,
         accum_res=st_res["accum"])
"""


def _run_two(tmp_path, code, tag):
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        env.pop(k, None)
    init = str(tmp_path / f"pg_{tag}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), init, str(tmp_path), here],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()


def test_two_process_cpu_multihost(tmp_path):
    """Pixel-sharded over 2 processes (the default mesh): identical
    framebuffers on both ranks, bitwise equal to one process."""
    _run_two(tmp_path, CHILD, "px")
    a = np.load(tmp_path / "out_0.npz")
    b = np.load(tmp_path / "out_1.npz")
    np.testing.assert_array_equal(a["img"], b["img"])
    np.testing.assert_array_equal(a["accum"], b["accum"])
    assert np.isfinite(a["accum"]).all()
    assert float(np.abs(a["accum"]).sum()) > 0.0
    assert int(a["spp"]) == 2
    scene, cfg, integ = _scene(2)
    img1, st1 = render.render_image(scene, cfg, integrator=integ,
                                    backend="reference", chunk=256,
                                    device="cpu")
    np.testing.assert_array_equal(a["accum"], st1["accum"])
    np.testing.assert_array_equal(a["img"], img1)


def test_two_process_spp_sharded_with_resume(tmp_path):
    """A 2-process mesh with spp_shards=2 (each process owns a sample
    shard): identical framebuffers on both ranks, close to one process,
    and a checkpoint/resume cycle under the sharded loop reproduces the
    uninterrupted render bitwise on every rank."""
    _run_two(tmp_path, CHILD_SPP, "spp")
    a = np.load(tmp_path / "spp_0.npz")
    b = np.load(tmp_path / "spp_1.npz")
    np.testing.assert_array_equal(a["accum_full"], b["accum_full"])
    np.testing.assert_array_equal(a["img_full"], b["img_full"])
    assert float(np.abs(a["accum_full"]).sum()) > 0.0
    for r in (a, b):
        np.testing.assert_array_equal(r["accum_res"], r["accum_full"])
        np.testing.assert_array_equal(r["img_res"], r["img_full"])
    scene, cfg, integ = _scene(4)
    _, st1 = render.render_image(scene, cfg, integrator=integ,
                                 backend="reference", chunk=256,
                                 device="cpu")
    np.testing.assert_allclose(a["accum_full"], st1["accum"], rtol=1e-5,
                               atol=1e-5)


def test_multihost_single_process_path(monkeypatch):
    """``initialize`` is a no-op for one process (arguments or no
    environment), the mesh is 1 x 1, and ``render_image_multihost``
    equals ``render_image_sharded``."""
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    initialize(world_size=1, device="cpu")
    initialize(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    initialize(device="cpu")  # torchrun's environment of one process
    assert not torch.distributed.is_initialized()
    mesh = global_mesh()
    assert mesh.shape == {"px": 1, "spp": 1} and mesh.group is None
    assemble = make_assemble(mesh)
    x = torch.arange(6.0).reshape(2, 3)
    np.testing.assert_array_equal(assemble(x), x.numpy())
    scene, cfg, integ = _scene(2)
    img, st = render_image_multihost(scene, cfg, integrator=integ, chunk=256,
                                     device="cpu")
    img2, st2 = render_image_sharded(scene, cfg, integrator=integ,
                                     chunk=256, device="cpu")
    assert img.shape == (8, 16, 3) and st["spp_done"] == 2
    np.testing.assert_array_equal(st["accum"], st2["accum"])
    np.testing.assert_array_equal(img, img2)


def test_initialize_explicit_arguments(monkeypatch):
    """An ``init_method`` or ``rank`` without a world size raises rather
    than render the whole image as a 1 x 1 mesh; on CUDA the rank's card
    is ``LOCAL_RANK``, else rank modulo the cards."""
    from rustraytrace_tpu_torch.parallel import multihost

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for kw in (dict(init_method="file:///nowhere"), dict(rank=1),
               dict(init_method="file:///nowhere", rank=0)):
        with pytest.raises(ValueError, match="world size"):
            initialize(device="cpu", **kw)
    assert not torch.distributed.is_initialized()

    cards, groups = [], []
    monkeypatch.setattr(multihost, "_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda backend, **kw: groups.append((backend, kw)))
    initialize("file:///x", world_size=8, rank=5)
    monkeypatch.setenv("LOCAL_RANK", "2")
    initialize("file:///x", world_size=8, rank=5)
    assert cards == [1, 2]
    assert groups[0] == ("nccl", dict(init_method="file:///x",
                                      world_size=8, rank=5))


def test_run_cpu_ranks_environment_and_a_failed_rank():
    """``run_cpu_ranks`` gives each process torchrun's variables and
    returns the outputs in rank order; a rank that fails raises at once
    with its error output, and the rank still waiting is killed."""
    import time

    from rustraytrace_tpu_torch.parallel import run_cpu_ranks

    outs = run_cpu_ranks(2, ["-c", (
        "import os; print(os.environ['RANK'], os.environ['WORLD_SIZE'], "
        "os.environ['MASTER_ADDR'], int(os.environ['MASTER_PORT']) > 0)")])
    assert [o.split() for o in outs] == [
        [str(r), "2", "127.0.0.1", "True"] for r in range(2)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited 3"):
        run_cpu_ranks(2, ["-c", (
            "import os, sys, time\n"
            "if os.environ['RANK'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)")])
    assert time.monotonic() - t0 < 30

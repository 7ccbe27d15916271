"""The port's mesh and sharded pass over ``torch.distributed``
(``parallel``) on the CPU: the mesh's axis rule against the JAX package's,
the 1-rank pass against ``render.render_pass`` on the reference route, the
contraction against the image it contracts, and 2-process ``gloo`` runs
(file init in the test's own directory, so parallel test workers never
share a port) against one process.

Sharding is an execution choice, not a semantics choice: pixel-sharded
renders are bitwise equal to the 1-rank render (the draws are keyed by
pixel and absolute sample), spp-sharded ones equal up to summation order
(rtol 1e-5 / atol 1e-5, the JAX test's), and the contraction's gradient
summed over 2 ranks equals the 1-rank gradient within rtol 1e-5 (plus an
atol of 1e-6 of the largest entry, for the order of the sums).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rustraytrace_tpu_torch import models, render  # noqa: E402
from rustraytrace_tpu_torch.config import derive_camera  # noqa: E402
from rustraytrace_tpu_torch.parallel import (Mesh, make_mesh,  # noqa: E402
                                             mesh_axis_sizes,
                                             render_contract_sharded,
                                             render_pass_sharded, spp_traced)

CHUNK = 256  # shared by both sides, so the chunks' batches coincide
NAMES = ("sph_center", "tex_color1")


def _small():
    scene, cfg, _ = models.book1_three_spheres(
        dict(image_width=32, samples_per_pixel=4, max_depth=5))
    cfg = cfg.replace(aspect_ratio=2.0)  # 32 x 16
    return scene, cfg, derive_camera(cfg, "cpu")


KW = dict(width=32, height=16, spp=4, max_depth=5, chunk=CHUNK,
          device="cpu")


def _ct():
    return torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 32, 3)).astype(np.float32))


def test_mesh_axis_sizes_match_jax():
    from rustraytrace_tpu.parallel.mesh import \
        mesh_axis_sizes as jax_mesh_axis_sizes

    for n in (1, 2, 3, 4, 6, 8, 16):
        for spp_shards in (None, 1, 2, 3, 4, 8):
            try:
                want = jax_mesh_axis_sizes(n, spp_shards)
            except ValueError:
                with pytest.raises(ValueError):
                    mesh_axis_sizes(n, spp_shards)
                continue
            assert mesh_axis_sizes(n, spp_shards) == want, (n, spp_shards)


def test_spp_traced_rounds_up_and_the_default_mesh_is_one_process():
    assert spp_traced(5, Mesh(px=4, spp=2)) == 6
    assert spp_traced(4, Mesh(px=4, spp=2)) == 4
    assert spp_traced(5, Mesh(px=8, spp=1)) == 5
    mesh = make_mesh()
    assert mesh.shape == {"px": 1, "spp": 1} and mesh.size == 1
    assert mesh.group is None
    with pytest.raises(ValueError):
        make_mesh(spp_shards=2)  # one process is not divisible by 2


def test_one_rank_pass_equals_render_pass_bitwise():
    scene, _, cam = _small()
    single = render.render_pass(scene, cam, 7, backend="reference", **KW)
    sharded = render_pass_sharded(scene, cam, 7, **KW)
    assert torch.equal(single, sharded)
    with pytest.raises(ValueError):
        render_pass_sharded(scene, cam, 7, backend="wavefront", **KW)


@pytest.mark.parametrize("warp", [False, "tent", True])
def test_contraction_equals_the_image_it_contracts(warp):
    """Value: sum(image * ct) of the same draws.  Gradient, three ways:
    the per-unit backward (``wrt``), autograd of the returned scalar, and
    autograd of sum(render_pass_sharded * ct)."""
    scene, _, cam = _small()
    ct = _ct()
    leaves = {n: getattr(scene, n).clone().requires_grad_(True)
              for n in NAMES}
    sp = dataclasses.replace(scene, **leaves)
    img = render_pass_sharded(sp, cam, 7, warp_primary=warp, **KW)
    ref = torch.sum(img * ct)
    g_img = torch.autograd.grad(ref, list(leaves.values()))
    val, g_wrt = render_contract_sharded(sp, cam, 7, ct, warp_primary=warp,
                                         wrt=leaves, **KW)
    s = render_contract_sharded(sp, cam, 7, ct, warp_primary=warp, **KW)
    g_s = torch.autograd.grad(s, list(leaves.values()))
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(s), float(ref), rtol=1e-5)
    for n, gi, gs in zip(NAMES, g_img, g_s):
        assert torch.any(gi != 0), n
        for g in (g_wrt[n], gs):
            np.testing.assert_allclose(g.numpy(), gi.numpy(), rtol=1e-4,
                                       atol=1e-6 * gi.abs().max().item(),
                                       err_msg=n)


WORKER = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
spp_shards = None if sys.argv[5] == "none" else int(sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world)
sys.path.insert(0, sys.argv[6])
import test_torch_diff_parallel as t
from rustraytrace_tpu_torch.parallel import (make_mesh, render_contract_sharded,
                                             render_pass_sharded)
scene, _, cam = t._small()
mesh = make_mesh(spp_shards)
with torch.no_grad():
    img = render_pass_sharded(scene, cam, 7, mesh=mesh, **t.KW)
leaves = {n: getattr(scene, n).clone().requires_grad_(True) for n in t.NAMES}
sp = dataclasses.replace(scene, **leaves)
val, g_wrt = render_contract_sharded(sp, cam, 7, t._ct(), mesh=mesh,
                                     warp_primary=True, wrt=leaves, **t.KW)
warped = render_pass_sharded(sp, cam, 7, mesh=mesh, warp_primary=True, **t.KW)
g_img = torch.autograd.grad(torch.sum(warped * t._ct()), list(leaves.values()))
torch.save({"mesh": (mesh.px, mesh.spp, mesh.px_idx, mesh.spp_idx),
            "img": img, "val": val, "g_wrt": g_wrt,
            "g_img": dict(zip(t.NAMES, g_img))}, out)
dist.destroy_process_group()
"""


def _two_ranks(tmp_path, spp_shards):
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    init = str(tmp_path / f"pg_{spp_shards}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "2", init,
         str(tmp_path / f"out_{spp_shards}_{r}.pt"), str(spp_shards), here],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return [torch.load(tmp_path / f"out_{spp_shards}_{r}.pt")
            for r in range(2)]


def _one_rank_contraction():
    scene, _, cam = _small()
    leaves = {n: getattr(scene, n).clone().requires_grad_(True)
              for n in NAMES}
    return render_contract_sharded(dataclasses.replace(scene, **leaves),
                                   cam, 7, _ct(), warp_primary=True,
                                   wrt=leaves, **KW)


def _close_grads(got, want):
    for n in NAMES:
        np.testing.assert_allclose(
            got[n].numpy(), want[n].numpy(), rtol=1e-5,
            atol=1e-6 * want[n].abs().max().item(), err_msg=n)


@pytest.mark.parametrize("spp_shards", ["none", 2])
def test_two_ranks_match_one(tmp_path, spp_shards):
    """2 processes on gloo, pixel-sharded (2 x 1) or spp-sharded (1 x 2):
    every rank holds the whole image (bitwise equal to the 1-rank render
    when pixel-sharded, allclose when spp-sharded) and the whole
    contraction gradient, both by the per-unit backward and by autograd
    through the sharded pass."""
    outs = _two_ranks(tmp_path, spp_shards)
    scene, _, cam = _small()
    single = render.render_pass(scene, cam, 7, backend="reference", **KW)
    val1, g1 = _one_rank_contraction()
    for r, out in enumerate(outs):
        if spp_shards == "none":
            assert out["mesh"] == (2, 1, r, 0)
            assert torch.equal(out["img"], single)
        else:
            assert out["mesh"] == (1, 2, 0, r)
            np.testing.assert_allclose(out["img"].numpy(), single.numpy(),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(out["val"]), float(val1),
                                   rtol=1e-5)
        _close_grads(out["g_wrt"], g1)
        _close_grads(out["g_img"], g1)

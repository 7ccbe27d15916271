"""Entry points: one forward render step and a multi-rank dry run
of one training step (counterpart: ``__graft_entry__.py``).

``entry()`` returns ``(fn, args)``: ``fn(*args)`` is one
``render.render_pass`` on the flagship (Book-1 random spheres,
``in_one_weekend/mod.rs:57-126``) at width 192, 1 spp, depth 8, on the
"auto" route (on the card the sorted persist kernel K2).

``dryrun_multichip(n)`` runs ONE sharded inverse-rendering training step
(the differentiable pass over the ('px', 'spp') mesh, MSE loss, gradients
summed over the ranks, an Adam update) on tiny shapes, then the kernel
routes' sharding plumbing with a substitute pass.  With ``n == 1``, or
inside a process group of ``n`` ranks (``torchrun``), it runs in this
process on ``device``.  Without a process group and ``n > 1`` it starts
``n`` gloo ranks on the CPU itself when ``device`` is the CPU, and raises
otherwise: one card cannot host several NCCL ranks.

    python -m rustraytrace_tpu_torch.graft_entry [N] [--device cuda|cpu]
    python -m rustraytrace_tpu_torch.graft_entry 2 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

PARAMS = ("sph_center", "tex_color1", "mat_ior")


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` is the flagship's forward render pass
    (the radiance sum [H, W, 3] on ``device``)."""
    from . import models
    from .config import derive_camera
    from .ops._cuda import device as _device
    from .render import render_pass

    dev = _device(device)
    scene, cfg, _ = models.book1_random_spheres(
        dict(image_width=192, samples_per_pixel=1, max_depth=8))
    cam = derive_camera(cfg, device=dev)
    w, h = cfg.image_width, cfg.image_height

    def fn(scene, cam, seed):
        return render_pass(scene, cam, seed, width=w, height=h, spp=1,
                           max_depth=8, integrator="path", chunk=16384,
                           device=dev)

    return fn, (scene, cam, 0)


def wiring_sum(mesh, seed: int, spp: int, device) -> torch.Tensor:
    """The kernel routes' sharding plumbing
    (``parallel.sharded_megakernel_wiring``: per-rank sample offsets
    ``rank * spp``, the sum over the mesh) with a substitute pass, as the
    JAX files check it off the TPU: each rank adds seeded uniforms [8, 8,
    3] plus the sum of a replicated table of 16 ones."""
    from .parallel import sharded_megakernel_wiring

    def pass_fn(arrays, seed, off):
        base = np.random.default_rng([seed, off]).random((8, 8, 3),
                                                         np.float32)
        return torch.as_tensor(base, device=device) + arrays["tab"].sum()

    return sharded_megakernel_wiring(
        pass_fn, {"tab": torch.ones(16, dtype=torch.float32,
                                    device=device)}, seed,
        [r * spp for r in range(mesh.size)], mesh)


def _dryrun_here(n_devices: int, dev) -> dict:
    """The dry run in this process: over the world group when one is up
    (its size must be ``n_devices``), else the mesh of this process."""
    from . import models
    from .diff import make_train_step
    from .parallel import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"{n_devices} devices asked for, but the job has "
                         f"{world} ranks")
    spp_shards = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(spp_shards=spp_shards)

    scene, cfg, _ = models.book1_three_spheres(
        dict(image_width=32, samples_per_pixel=2, max_depth=3))
    cfg = cfg.replace(aspect_ratio=2.0)  # 32x16
    target = np.zeros((cfg.image_height, cfg.image_width, 3), np.float32)
    step, params, _ = make_train_step(scene, list(PARAMS), target, cfg,
                                      mesh=mesh, spp=2, chunk=256,
                                      device=dev)
    loss = float(step(0))
    if not np.isfinite(loss):
        raise AssertionError("multichip dry run produced a non-finite loss")

    out = wiring_sum(mesh, 7, 4, dev)
    if not (out.shape == (8, 8, 3) and bool(torch.isfinite(out).all())):
        raise AssertionError("the sharded wiring's sum is malformed")
    return dict(loss=loss, mesh=(mesh.px, mesh.spp),
                params={k: v.detach().cpu().numpy()
                        for k, v in params.items()},
                wiring=out.cpu().numpy())


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded training step on ``n_devices`` ranks (``spp_shards`` 2
    when ``n_devices`` is even and above 1) of ``book1_three_spheres`` at
    32x16, 2 spp, depth 3, chunk 256, against a zero target, over
    ``PARAMS``; raises unless the loss is finite.  Returns rank 0's
    {"loss", "params" (updated, NumPy), "wiring" (the substitute pass's
    sum), "mesh" (px, spp)}.  Without a process group and with
    ``n_devices > 1`` it starts gloo ranks on the CPU when ``device`` is
    the CPU (and raises unless every rank got the same), and raises
    ValueError for any other device."""
    if dist.is_initialized() or n_devices == 1:
        from .ops._cuda import device as _device

        return _dryrun_here(n_devices, _device(device))
    if torch.device(device).type != "cpu":
        raise ValueError(f"{n_devices} ranks on {str(device)!r} need a "
                         "process group: run under torchrun, or pass "
                         "device='cpu' for gloo ranks on the CPU")
    from .parallel import run_cpu_ranks

    with tempfile.TemporaryDirectory() as tmp:
        run_cpu_ranks(n_devices, ["-m", "rustraytrace_tpu_torch.graft_entry",
                                  str(n_devices), "--rank-out", tmp])
        got = [np.load(os.path.join(tmp, f"rank_{r}.npz"))
               for r in range(n_devices)]
        res = {k: got[0][k] for k in got[0].files}
        for g in got[1:]:
            for k in g.files:
                if not np.array_equal(g[k], res[k]):
                    raise AssertionError(f"ranks disagree on {k}")
    return dict(loss=float(res["loss"]), mesh=tuple(res["mesh"].tolist()),
                params={k: res[k] for k in PARAMS}, wiring=res["wiring"])


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank-out", default=None,
                    help="as one rank of a CPU job: write this rank's "
                         "result to DIR/rank_<r>.npz")
    args = ap.parse_args(argv)
    if args.rank_out is None:
        res = dryrun_multichip(args.n_devices, device=args.device)
        print(f"dry run on {args.n_devices} ranks (mesh {res['mesh']}): "
              f"loss {res['loss']:.9g}")
        return 0
    from .parallel import initialize

    initialize(device="cpu")
    try:
        res = _dryrun_here(args.n_devices, torch.device("cpu"))
        np.savez(os.path.join(args.rank_out, f"rank_{dist.get_rank()}.npz"),
                 loss=res["loss"], mesh=np.asarray(res["mesh"]),
                 wiring=res["wiring"], **res["params"])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

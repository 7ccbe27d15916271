"""Scaling-efficiency harness (counterpart: ``scaling_bench.py``):
sharded render throughput against the number of ranks over the
('px', 'spp') mesh of ``torch.distributed``.

Backends (``--backend``):
  xla         the reference route's pixel-sharded pass
              (``parallel.render_pass_sharded``)
  megakernel  the spp-sharded respawn megakernel K3
              (``parallel.render_pass_megakernel_sharded(respawn=True)``)
  wavefront   the spp-sharded image route (K2) on ``book2_earth``
              (``parallel.render_pass_wavefront_sharded``)

Under ``torchrun`` the world is the job's; for each power of two n up to
its size, ranks 0..n-1 form a group and render.  ``--virtual N`` starts N
gloo ranks on the CPU (the JAX script forces N virtual CPU devices): that
checks the scaling code path (the collectives, the sample offsets, the
efficiency accounting), and its absolute numbers mean nothing.  The CUDA
kernels do not run on CPU ranks, so there the kernel backends check their
sharding plumbing through ``parallel.sharded_megakernel_wiring`` with a
substitute pass and print ``wiring_only`` instead of a throughput, as the
JAX script does off the TPU.  On one card the world size is 1 and the
efficiency is 1.0 by definition.

Rank 0 prints one JSON line per rank count:
  {"backend", "devices", "paths_per_s", "seconds", "efficiency"}
with efficiency = throughput(n) / (n * throughput(1)).

    python -m rustraytrace_tpu_torch.scripts.scaling_bench \\
        [--backend xla|megakernel|wavefront] [--width 384] [--spp 8] \\
        [--depth 8] [--spp-shards K] [--virtual N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

SEED = 0


def scene_for(backend: str, width: int, spp: int, depth: int):
    """(scene, cfg) of a backend: the earth for ``wavefront``, else the
    flagship."""
    from .. import models

    name = "book2_earth" if backend == "wavefront" else "book1_random_spheres"
    scene, cfg, _ = getattr(models, name)(
        dict(image_width=width, samples_per_pixel=spp, max_depth=depth))
    return scene, cfg


def run_pass(backend: str, scene, cam, mesh, *, width: int, height: int,
             spp: int, depth: int, device) -> torch.Tensor:
    """One sharded pass of ``backend`` over ``mesh`` (seed ``SEED``): the
    radiance sum [H, W, 3], the same on every rank."""
    from ..parallel import (render_pass_megakernel_sharded,
                            render_pass_sharded,
                            render_pass_wavefront_sharded)

    kw = dict(mesh=mesh, width=width, height=height, spp=spp,
              max_depth=depth, device=device)
    if backend == "xla":
        return render_pass_sharded(scene, cam, SEED, chunk=16384,
                                   remat=False, **kw)
    if backend == "megakernel":
        return render_pass_megakernel_sharded(scene, cam, SEED, respawn=True,
                                              **kw)
    return render_pass_wavefront_sharded(scene, cam, SEED, **kw)


def bench(args) -> None:
    """The measurement on this rank of the job (or alone)."""
    from ..config import derive_camera
    from ..graft_entry import wiring_sum
    from ..ops._cuda import device as _device
    from ..parallel import (Mesh, initialize, make_mesh,
                            megakernel_shard_eligible,
                            wavefront_shard_eligible)

    dev = _device(args.device)
    initialize(device=dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    scene, cfg = scene_for(args.backend, args.width, args.spp, args.depth)
    cam = derive_camera(cfg, device=dev)
    w, h = cfg.image_width, cfg.image_height

    counts, n = [], 1
    while n <= world:
        counts.append(n)
        n *= 2
    base = None
    for n in counts:
        # every rank takes part in creating each group
        group = (dist.new_group(list(range(n))) if dist.is_initialized()
                 else None)
        if rank >= n:
            continue
        shards = (args.spp_shards if args.spp_shards
                  and n % args.spp_shards == 0 else None)
        mesh = (make_mesh(shards, group) if group is not None
                else Mesh(1, 1))
        if args.backend != "xla" and not (
                megakernel_shard_eligible(scene, "path", mesh, dev)
                or wavefront_shard_eligible(scene, "path", mesh, dev)):
            ok = bool(torch.isfinite(wiring_sum(mesh, SEED, args.spp,
                                                dev)).all())
            rec = {"backend": args.backend, "devices": n,
                   "wiring_only": True, "ok": ok}
        else:
            def go():
                out = run_pass(args.backend, scene, cam, mesh, width=w,
                               height=h, spp=args.spp, depth=args.depth,
                               device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                return out

            go()  # warm-up: kernel build, tables
            t0 = time.perf_counter()
            go()
            el = time.perf_counter() - t0
            # the spp-sharded kernel backends trace ceil(spp / n) * n
            spp_traced = (args.spp if args.backend == "xla"
                          else -(-args.spp // n) * n)
            pps = w * h * spp_traced / el
            base = pps if base is None else base
            rec = {"backend": args.backend, "devices": n,
                   "paths_per_s": pps, "seconds": el,
                   "efficiency": pps / (n * base)}
        if rank == 0:
            print(json.dumps(rec), flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="run N gloo ranks on the CPU (code-path check)")
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--spp-shards", type=int, default=None)
    ap.add_argument("--backend", choices=["xla", "megakernel", "wavefront"],
                    default="xla")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.virtual:
        from ..parallel import run_cpu_ranks

        child = ["--width", str(args.width), "--spp", str(args.spp),
                 "--depth", str(args.depth), "--backend", args.backend,
                 "--device", "cpu"]
        if args.spp_shards:
            child += ["--spp-shards", str(args.spp_shards)]
        outs = run_cpu_ranks(args.virtual, [
            "-m", "rustraytrace_tpu_torch.scripts.scaling_bench", *child])
        sys.stdout.write(outs[0])
        return 0
    owned = not dist.is_initialized()  # a caller's group is left up
    try:
        bench(args)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return 0

if __name__ == "__main__":
    sys.exit(main())

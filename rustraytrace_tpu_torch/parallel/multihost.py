"""Multi-process rendering over ``torch.distributed`` (counterpart:
``rustraytrace_tpu/parallel/multihost.py``).

* every process calls :func:`initialize` (``torchrun``'s environment, or
  explicit arguments), the counterpart of ``jax.distributed.initialize``;
* :func:`global_mesh` builds the ('px', 'spp') mesh over every rank of the
  job;
* :func:`render_image_multihost` is ``render_image_sharded`` on that
  mesh; every rank gets the whole framebuffer;
* :func:`run_cpu_ranks` starts a job of several processes on the CPU
  (gloo), where the JAX package forces virtual CPU devices: one card
  cannot host several NCCL ranks.

A lost process fails the job; restart it and resume from the last pass
checkpoint (``utils.checkpoint``): the accumulation state is (sum,
spp_done), so any pass boundary is a resume point.  A job of one process
works unchanged (``initialize`` is then a no-op).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops._cuda import device as _device
from .mesh import Mesh, make_mesh
from .render import render_image_sharded


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device="cuda") -> None:
    """Start the process group when the job has more than one process; a
    no-op otherwise, and when a group is already up.  Without arguments
    the job is read from ``torchrun``'s environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``); without that environment it is one
    process.  An ``init_method`` or ``rank`` with no world size (argument
    or ``WORLD_SIZE``) raises ``ValueError``.  NCCL on a CUDA ``device``,
    gloo on the CPU; the rank's card is ``cuda:LOCAL_RANK``, else
    ``rank`` modulo the cards in view."""
    if dist.is_initialized():
        return
    env = os.environ
    if init_method is None and world_size is None and rank is None:
        if not all(k in env for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR")):
            return
        init_method = "env://"
    if world_size is None:
        if "WORLD_SIZE" not in env:
            raise ValueError("init_method or rank was given, but no world "
                             "size (argument or WORLD_SIZE)")
        world_size = int(env["WORLD_SIZE"])
    if world_size <= 1:
        return
    if rank is None:
        if "RANK" not in env:
            raise ValueError(f"a job of {world_size} processes needs this "
                             "process's rank (argument or RANK)")
        rank = int(env["RANK"])
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env
                              else rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)


def global_mesh(spp_shards: Optional[int] = None) -> Mesh:
    """('px', 'spp') mesh over every rank of the job."""
    return make_mesh(spp_shards)


def make_assemble(mesh: Mesh):
    """The framebuffer assembler for ``mesh``: a host copy.  The JAX
    package gathers a px-sharded array across hosts here; the port's
    sharded sums are already added over the whole mesh with
    ``all_reduce``, so every rank holds the whole framebuffer and no
    gather is needed."""
    def assemble(accum) -> np.ndarray:
        if isinstance(accum, torch.Tensor):
            return accum.detach().cpu().numpy()
        return np.asarray(accum)

    return assemble


def render_image_multihost(scene, cfg, *, mesh: Optional[Mesh] = None,
                           integrator: str = "path", chunk: int = 65536,
                           progress=None, accum_state=None, on_pass=None,
                           device="cuda"):
    """The JAX package's name for ``render_image_sharded`` on the job's
    mesh (default ``global_mesh()``): (image_u8, accum_state), the same on
    every rank, since the sums are added with ``all_reduce``.
    ``on_pass(state)`` fires at every pass boundary (checkpointing: the
    resume point after a lost process)."""
    return render_image_sharded(
        scene, cfg, mesh=global_mesh() if mesh is None else mesh,
        integrator=integrator, chunk=chunk, progress=progress,
        accum_state=accum_state, on_pass=on_pass, device=device)


def run_cpu_ranks(n: int, args: List[str], timeout: float = 600.0
                  ) -> List[str]:
    """Run ``python <args>`` as a job of ``n`` processes on the CPU, with
    ``torchrun``'s variables (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR=127.0.0.1``, a free ``MASTER_PORT``), so that each calls
    ``initialize(device="cpu")`` to join the gloo group.  The package's
    parent directory leads ``PYTHONPATH``.  Raises ``RuntimeError`` with
    its error output as soon as a process fails (the others are killed,
    as they would wait for it), and ``TimeoutError`` after ``timeout``
    seconds; returns the standard outputs in rank order."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    path = [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    procs, files = [], []
    try:
        for r in range(n):
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(path),
                       WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *args], env=env,
                                          stdout=out, stderr=err))
        def failed(r):
            err = files[r][1]
            err.seek(0)
            return RuntimeError(
                f"rank {r} of {n} exited {procs[r].returncode}:\n"
                f"{err.read().decode(errors='replace')[-4000:]}")

        deadline = time.monotonic() + timeout
        while [p.poll() for p in procs].count(None):
            bad = [r for r, p in enumerate(procs) if p.returncode]
            if bad:
                raise failed(bad[0])
            if time.monotonic() > deadline:
                raise TimeoutError(f"a job of {n} ranks ran past "
                                   f"{timeout} s")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.returncode]
        if bad:
            raise failed(bad[0])
        outs = []
        for out, _ in files:
            out.seek(0)
            outs.append(out.read().decode())
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()

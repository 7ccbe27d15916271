"""The dense closest-sphere spike on the card (counterpart:
``scripts/spike_dense_mxu.py``): the tensor-core formulation of the sphere
quadric (``ops/dense_hit.py`` ``dense_hit``, ``wgmma`` TF32) against
the per-sphere scalar loop (``scalar_hit``) on the spike's tables and rays,
outside the path tracer.  Prints the agreement of the two kernels, then
each one's time and rate in pairs (ray x sphere x iteration) per second.

    python -m rustraytrace_tpu_torch.scripts.spike_dense_mxu [NS] [iters] \\
        [--precision highest|default] [--device cuda|cpu]

NS is a multiple of 16 (the spike uses multiples of 512); ``--device
cpu`` runs the plain twins.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import dense_hit as dh
from ..ops._cuda import device as _device

T, L = 32, 128  # the spike's ray tile: 4,096 rays


def spike_inputs(ns: int, seed: int = 0):
    """The spike's tables and rays (spike_dense_mxu.py:159-174), NumPy:
    (dtab [8, ns], stab [4, ns], o [3, T, L], d [3, T, L])."""
    rng = np.random.default_rng(seed)
    cen = rng.uniform(-50, 50, (ns, 3)).astype(np.float32)
    rad = rng.uniform(1, 10, ns).astype(np.float32)
    r2 = rad * rad
    c2 = (cen * cen).sum(1)
    dtab = np.zeros((8, ns), np.float32)
    dtab[0:3] = cen.T
    dtab[3] = 0.5 * (c2 - r2)
    stab = np.zeros((4, ns), np.float32)
    stab[0:3] = cen.T
    stab[3] = r2
    o = rng.uniform(-100, 100, (3, T, L)).astype(np.float32)
    d = rng.normal(size=(3, T, L)).astype(np.float32)
    return dtab, stab, o, d


def agreement(bt_d, bi_d, bt_s, bi_s):
    """(hit-mask agreement, winner-index agreement where both hit, max |dt|
    where both hit), the spike's line."""
    hit_d, hit_s = bi_d >= 0, bi_s >= 0
    both = hit_d & hit_s
    return (float((hit_d == hit_s).mean()),
            float((bi_d[both] == bi_s[both]).mean()),
            float(np.abs(bt_d - bt_s)[both].max()))


def _time(fn, dev, reps: int = 3) -> float:
    """Best of ``reps`` seconds of fn() after a warm-up (CUDA events on a
    card, the host clock on the CPU)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ns", nargs="?", type=int, default=1024)
    ap.add_argument("iters", nargs="?", type=int, default=200)
    ap.add_argument("--precision", choices=dh.PRECISIONS, default="highest")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    ns, iters = args.ns, args.iters

    dtab, stab, o, d = spike_inputs(ns)
    dtab_t, stab_t = (torch.from_numpy(x).to(dev) for x in (dtab, stab))
    rays = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (o[0], o[1], o[2], d[0], d[1], d[2])]

    def dense():
        return dh.dense_hit(dtab_t, *rays, iters=iters,
                            precision=args.precision)

    def scalar():
        return dh.scalar_hit(stab_t, *rays, iters=iters)

    bt_d, bi_d = (x.cpu().numpy() for x in dense())
    bt_s, bi_s = (x.cpu().numpy() for x in scalar())
    agree, idx_agree, dt = agreement(bt_d, bi_d, bt_s, bi_s)
    print(f"hit-mask agreement {agree:.6f}, winner-idx agreement "
          f"{idx_agree:.6f}, |t| max delta {dt:.3e}")

    pairs = T * L * ns * iters
    b_s = _time(scalar, dev)
    print(f"scalar unroll=4 ns={ns}: {b_s * 1e3:.1f} ms = "
          f"{pairs / b_s / 1e9:.1f} Gpairs/s", flush=True)
    b_d = _time(dense, dev)
    print(f"dense wgmma ns={ns} ({args.precision}): {b_d * 1e3:.1f} ms = "
          f"{pairs / b_d / 1e9:.1f} Gpairs/s", flush=True)
    print(f"dense/scalar speedup: {b_s / b_d:.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

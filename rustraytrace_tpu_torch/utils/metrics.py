"""Observability: throughput meters, device fences, profiler hooks
(counterpart: ``rustraytrace_tpu/utils/metrics.py``).

The reference's observability is stderr progress lines (scanline countdown
``in_one_weekend/camera.rs:64,80-84``; GPU ``pass/total (%) elapsed eta``
``gpu/mod.rs:469-480``).  Here, as in the JAX package: structured
per-pass records (also emitted by the CLI), a paths/s meter, and a
``torch.profiler`` trace context for kernel-level profiling.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


def device_fence(x) -> np.ndarray:
    """Completion fence and host copy: for a CUDA tensor,
    ``torch.cuda.synchronize`` of its device, then the copy.  Returns
    NumPy."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def time_best(go, repeats: int = 2, on_rep=None) -> float:
    """Best-of-``repeats`` wall time of ``go()``, fenced with
    ``device_fence`` of its result.  ``go`` must have been run once
    already (warm-up, kernel build).  ``on_rep(i, seconds)`` fires after
    each rep, so that a recorded number can be audited."""
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        device_fence(go())
        dt = time.perf_counter() - t0
        if on_rep is not None:
            on_rep(i, dt)
        best = min(best, dt)
    return best


@dataclass
class PassRecord:
    spp: int
    paths: int
    seconds: float

    @property
    def paths_per_sec(self) -> float:
        return self.paths / max(self.seconds, 1e-12)


@dataclass
class RenderMeter:
    """Accumulates per-pass throughput; emits JSON lines (the structured
    analog of the reference's stderr progress)."""

    n_pixels: int
    records: List[PassRecord] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def lap(self, spp: int) -> PassRecord:
        now = time.perf_counter()
        rec = PassRecord(spp=spp, paths=spp * self.n_pixels,
                         seconds=now - (self._t0 or now))
        self._t0 = now
        self.records.append(rec)
        return rec

    @property
    def total_paths(self) -> int:
        return sum(r.paths for r in self.records)

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.records)

    @property
    def paths_per_sec(self) -> float:
        return self.total_paths / max(self.total_seconds, 1e-12)

    def json_line(self, **extra) -> str:
        return json.dumps(dict(
            passes=len(self.records), total_paths=self.total_paths,
            elapsed_s=round(self.total_seconds, 3),
            paths_per_sec=round(self.paths_per_sec, 1), **extra,
        ))


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record CPU and (with a card) CUDA activity with ``torch.profiler``
    and write a Chrome trace (``trace_<pid>_<ms>.json``) into ``log_dir``;
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))

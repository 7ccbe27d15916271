"""The port's observability module (``utils/metrics.py``) on the CPU: the
twin of ``tests/test_metrics.py:17-31``.  ``RenderMeter`` and
``PassRecord`` are held to the JAX classes' values and JSON keys on the
same laps (``time.perf_counter`` patched, so both read one clock);
``time_best``'s contract; ``device_fence`` returns NumPy;
``profile_trace`` writes a Chrome trace into its directory.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from rustraytrace_tpu.utils import metrics as jmetrics  # noqa: E402
from rustraytrace_tpu_torch.utils import metrics  # noqa: E402
from rustraytrace_tpu_torch.utils.metrics import (device_fence,  # noqa: E402
                                                  profile_trace, time_best)


def _laps(mod, monkeypatch):
    clock = iter([10.0, 10.5, 11.25, 11.25, 13.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    m = mod.RenderMeter(n_pixels=100).start()
    recs = [m.lap(4), m.lap(4), m.lap(0), m.lap(8)]
    return m, recs


def test_render_meter_matches_jax(monkeypatch):
    got, got_recs = _laps(metrics, monkeypatch)
    want, want_recs = _laps(jmetrics, monkeypatch)
    assert [(r.spp, r.paths, r.seconds, r.paths_per_sec) for r in got_recs] \
        == [(r.spp, r.paths, r.seconds, r.paths_per_sec) for r in want_recs]
    assert got.total_paths == want.total_paths == 1600
    assert got.total_seconds == want.total_seconds == 3.0
    assert got.paths_per_sec == want.paths_per_sec
    line, jline = (json.loads(m.json_line(scene="x", pass_spp=16))
                   for m in (got, want))
    assert line == jline
    assert list(line) == ["passes", "total_paths", "elapsed_s",
                          "paths_per_sec", "scene", "pass_spp"]
    assert line["passes"] == 4 and line["paths_per_sec"] > 0


def test_time_best_calls_go_repeats_times_and_fires_on_rep():
    calls, reps = [], []

    def go():
        calls.append(1)
        return torch.ones(3)

    best = time_best(go, repeats=3, on_rep=lambda i, s: reps.append((i, s)))
    assert len(calls) == 3 and [i for i, _ in reps] == [0, 1, 2]
    assert best == min(s for _, s in reps) and best >= 0.0


def test_device_fence_returns_numpy():
    out = device_fence(torch.ones((4, 4)) * 2)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.full((4, 4), 2.0, np.float32))
    np.testing.assert_array_equal(device_fence([1, 2]), np.asarray([1, 2]))


def test_profile_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir)):
        (torch.arange(1000.0) * 2).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]

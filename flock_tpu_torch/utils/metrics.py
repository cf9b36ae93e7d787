"""Structured metrics — a copy of ``Metrics``, ``METRICS`` and
``device_trace`` from ``flock_tpu/utils/metrics.py``.  ``device_trace``
records a ``torch.profiler`` trace (CPU and CUDA activity) and writes it
as a Chrome trace under ``<tempdir>/flock_tpu_torch_trace/<name>/``, where
the reference writes a ``jax.profiler`` trace.

Reference: Flock has no tracer; it logs to CloudWatch and parses REPORT lines
offline (scripts/parser/cloudwatch).  Here: an in-process metrics registry
recording per-stage rows/bytes/time, renderable as a table or JSON, plus a
``device_trace`` context manager for the profiler.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Metrics:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    timings: dict = field(default_factory=lambda: defaultdict(float))

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] += time.perf_counter() - t0

    def rate(self, rows_key: str, time_key: str) -> float:
        t = self.timings.get(time_key, 0.0)
        return self.counters.get(rows_key, 0) / t if t else 0.0

    def to_json(self) -> str:
        return json.dumps({"counters": dict(self.counters),
                           "timings": {k: round(v, 6) for k, v in
                                       self.timings.items()}})

    def report(self) -> str:
        lines = ["metric               value"]
        for k, v in sorted(self.counters.items()):
            lines.append(f"{k:<20} {v}")
        for k, v in sorted(self.timings.items()):
            lines.append(f"{k:<20} {v:.4f}s")
        return "\n".join(lines)


METRICS = Metrics()


def trace_dir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), "flock_tpu_torch_trace", name)


@contextlib.contextmanager
def device_trace(name: str, enabled: bool = False):
    """``torch.profiler`` trace of the block (a Chrome trace,
    ``trace.json`` in ``trace_dir(name)``) when enabled."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir(name), exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir(name), "trace.json"))

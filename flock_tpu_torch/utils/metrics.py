"""Structured metrics — a copy of ``Metrics``, ``METRICS`` and
``device_trace`` from ``flock_tpu/utils/metrics.py``, with spans.
``device_trace`` records a ``torch.profiler`` trace (CPU and CUDA activity)
and writes it as a Chrome trace under ``<tempdir>/flock_tpu_torch_trace/
<name>/``, where the reference writes a ``jax.profiler`` trace.

Reference: Flock has no tracer; it logs to CloudWatch and parses REPORT lines
offline (scripts/parser/cloudwatch).  Here: an in-process metrics registry
of per-stage counters and always-on timers, rendered as a table, plus
``device_trace`` for the profiler.

Spans (``span(name)``) mark the program's layer boundaries: per name, the
count, the total host time and the self time (the total less the time of
the spans opened inside it).  A span records only while a
``torch.profiler`` session records or inside ``tracing()``; under the
profiler it also opens ``record_function(name)``, so that it lands in the
Chrome trace as a ``user_annotation`` on the kernels' clock.  Otherwise
``span`` returns one shared object that does nothing: no clock read, no
profiler annotation, no write to the registry.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
# ``_autograd_profiler._is_profiler_enabled``: torch's Python flag that its
# profiler sets while a session records, read without a call into C++
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


class _Span:
    """One open span.  Its times leave out its own profiler annotation and
    bookkeeping, and so does its parent's self time: their cost lands in
    the parent's total alone."""

    __slots__ = ("reg", "name", "rf", "t_out", "t0", "inner")

    def __init__(self, reg: "Metrics", name: str):
        self.reg, self.name = reg, name

    def __enter__(self):
        self.inner = 0.0
        self.rf = None
        self.t_out = self.t0 = time.perf_counter()
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
            self.t0 = time.perf_counter()
        self.reg._open.append(self)
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        s = self.reg.spans[self.name]
        s[0] += 1
        s[1] += dt
        s[2] += dt - self.inner
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = self.reg._open
        stack.pop()
        if stack:
            stack[-1].inner += time.perf_counter() - self.t_out
        return False


@dataclass
class Metrics:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    timings: dict = field(default_factory=lambda: defaultdict(float))
    # name -> [count, total seconds, self seconds]
    spans: dict = field(default_factory=lambda: defaultdict(
        lambda: [0, 0.0, 0.0]))
    _tracing: int = 0
    _open: list = field(default_factory=list, repr=False)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] += time.perf_counter() - t0

    def span(self, name: str):
        """A span of the block named ``name`` while tracing is on (a
        profiler records, or inside ``tracing()``); else a no-op."""
        if self._tracing or _autograd_profiler._is_profiler_enabled:
            return _Span(self, name)
        return _OFF

    def spanned(self, name: str):
        """Decorator: every call of the function in ``span(name)``; while
        tracing is off, the call alone."""
        def wrap(fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                if not (self._tracing
                        or _autograd_profiler._is_profiler_enabled):
                    return fn(*args, **kwargs)
                with _Span(self, name):
                    return fn(*args, **kwargs)
            return call
        return wrap

    @contextlib.contextmanager
    def tracing(self):
        """Spans record inside the block, without a profiler."""
        self._tracing += 1
        try:
            yield
        finally:
            self._tracing -= 1

    def report(self) -> str:
        lines = ["metric               value"]
        for k, v in sorted(self.counters.items()):
            lines.append(f"{k:<20} {v}")
        for k, v in sorted(self.timings.items()):
            lines.append(f"{k:<20} {v:.4f}s")
        if self.spans:
            lines.append("span                 count     total_ms      self_ms")
            for k, (n, total, own) in sorted(self.spans.items()):
                lines.append(f"{k:<20} {n:<9} {total * 1e3:<12.4f} "
                             f"{own * 1e3:.4f}")
        return "\n".join(lines)


METRICS = Metrics()


def trace_dir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), "flock_tpu_torch_trace", name)


@contextlib.contextmanager
def device_trace(name: str, enabled: bool = False):
    """``torch.profiler`` trace of the block (a Chrome trace,
    ``trace.json`` in ``trace_dir(name)``) when enabled; the program's
    spans record inside it."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir(name), exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir(name), "trace.json"))

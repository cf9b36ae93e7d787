"""The traced run's profile of a bounded stretch of windows, read from the
profiler's Chrome trace.

``torch.profiler`` records the host's operations, the benchmark's spans
(``record_function``: ``stretch`` around the whole stretch, ``window``,
``execute`` and ``emit`` around each window's parts), the program's own
spans inside those (``execute.form``, ``.lower``, ``.flags``,
``.fallback``; ``emit.copy``, ``.compact``, ``.sink``) and the card's
operations (kernels, copies, sets).  ``summarize`` reduces them to what the
per-layer readers and the ``breakdown`` need:

* ``window_s``: the length of the ``stretch`` span;
* ``busy_s``: the time inside it in which any operation ran on the card
  (the union of the device operations' intervals);
* ``kernel_s``: the summed time of the device's kernels, copies and sets
  excluded;
* ``h2d_bytes``, ``d2h_bytes``: the bytes copied from host to device and
  back inside the stretch;
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the card's idle time inside the stretch by what the host
  was doing then (the innermost benchmark or program span and the
  innermost host operation over the middle of each gap), the ten largest.
"""

from __future__ import annotations

import json
from collections import defaultdict

SPANS = ("stretch", "window", "execute", "emit",
         # the program's spans (``flock_tpu_torch.utils.metrics``)
         "execute.form", "execute.lower", "execute.flags", "execute.fallback",
         "emit.copy", "emit.compact", "emit.sink")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(path: str) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(events: list[dict], t: float) -> dict | None:
    best = None
    for e in events:
        if e["ts"] <= t <= e["ts"] + e["dur"]:
            if best is None or e["dur"] < best["dur"]:
                best = e
    return best


def summarize(path: str) -> dict | None:
    """The stretch's numbers (times in seconds), or None when the trace
    holds no ``stretch`` span or no device operation inside it."""
    evs = _events(path)
    stretch = [e for e in evs if e.get("name") == "stretch"
               and e.get("cat") == "user_annotation"]
    if not stretch:
        return None
    s0 = stretch[0]["ts"]
    s1 = s0 + stretch[0]["dur"]
    dev = [e for e in evs if e.get("cat") in _DEVICE_CATS
           and s0 <= e["ts"] and e["ts"] + e["dur"] <= s1]
    if not dev:
        return None
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name: dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"]
    kernel_us = sum(e["dur"] for e in dev if e["cat"] == "kernel")

    def copied(way):
        evs = [e for e in dev if e["cat"] == "gpu_memcpy" and way in e["name"]]
        return sum(int(e.get("args", {}).get("bytes", 0)) for e in evs), \
            len(evs)

    h2d, h2d_n = copied("HtoD")
    d2h, _ = copied("DtoH")

    spans = [e for e in evs if e.get("cat") == "user_annotation"
             and e.get("name") in SPANS and s0 <= e["ts"] <= s1]
    host_ops = [e for e in evs if e.get("cat") in ("cpu_op", "cuda_runtime")
                and s0 <= e["ts"] <= s1]
    gaps: dict[str, float] = defaultdict(float)
    edges = [s0] + [t for iv in busy for t in iv] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        span = _innermost(spans, mid)
        op = _innermost(host_ops, mid)
        name = span["name"] if span else "host"
        if op is not None:
            name += "/" + op["name"]
        gaps[name] += b - a

    def top(d):
        return [[k, v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "window_s": (s1 - s0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "h2d_bytes": h2d,
        "h2d_copies": h2d_n,
        "d2h_bytes": d2h,
        "device_ops": top(by_name),
        "idle_gaps": top(gaps),
    }

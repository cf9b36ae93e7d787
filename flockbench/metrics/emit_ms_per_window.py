"""Emission per window (ms): the benchmark's span around
``LocalExecutor.materialize``, which copies the window's output to the host
and finishes its rows there, averaged over the timed window."""

import statistics


def read(rec):
    if not rec.emit_s:
        return None
    return statistics.fmean(rec.emit_s) * 1e3

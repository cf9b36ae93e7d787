"""Median time from a window's dispatch to its rows on the host (ms), over
every window of the timed window: the benchmark's own clock, beside the
95th percentile."""

import statistics


def read(rec):
    if not rec.latencies_s:
        return None
    return statistics.median(rec.latencies_s) * 1e3

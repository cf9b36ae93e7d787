"""The executor's own time per window (ms): the program's METRICS timer
``q<n>.execute_s`` over its counter ``q<n>.windows``, across the timed
window; from dispatch through the flags' read, the output left on the
card."""


def read(rec):
    n = rec.counters.get("windows", 0)
    if not n:
        return None
    return rec.counters["execute_s"] / n * 1e3

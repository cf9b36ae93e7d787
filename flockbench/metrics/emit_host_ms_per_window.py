"""The emission's host work per window (ms): the program's spans
``emit.compact`` (``Batch.to_numpy``'s compaction of each column by the
valid mask) and ``emit.sink`` (``materialize_columns``), over the profiled
stretch.  The card is idle through them: the flags read drained its
queue."""

from flockbench import spans


def read(rec):
    return spans.ms_per_window(rec, "emit.compact", "emit.sink")

"""The emission's copy per window (ms): the program's span ``emit.copy``
(``Batch.to_numpy``'s one ``torch.cat`` of the output's bytes and its copy
to the host), over the profiled stretch."""

from flockbench import spans


def read(rec):
    return spans.ms_per_window(rec, "emit.copy")

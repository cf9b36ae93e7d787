"""The executor's dispatch per window (ms): the self time of the program's
spans ``execute.form`` (the ``torch.cat`` that forms the window) and
``execute.lower`` (the plan's lowering: its operations queued on the
card), over the profiled stretch."""

from flockbench import spans


def read(rec):
    return spans.ms_per_window(rec, "execute.form", "execute.lower", own=True)

"""The host's wait on the card per window (ms): the program's span
``execute.flags``, the window's one read of its overflow and escape flags,
which returns once the card has run the window's queue; over the profiled
stretch."""

from flockbench import spans


def read(rec):
    return spans.ms_per_window(rec, "execute.flags")

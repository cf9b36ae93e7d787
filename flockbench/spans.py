"""The program's own spans and staging counters, read from a run's
``Record`` for the per-layer metrics.

``run_cell`` keeps the program's span totals and counters
(``program.registry``) as they moved over the profiled stretch
(``Record.stretch``) and over set-up (``Record.setup_counters``).  The
program records its spans only while a profiler records (the run opens no
``tracing()``), so the stretch holds those of the traced run's profiled
windows, and the window count is its count of ``execute`` spans (one a
window).  Every reader returns None on a record whose stretch holds no
span: an untraced run's, or one under a program that has no spans."""

from __future__ import annotations


def _span(rec, name: str) -> tuple[int, float, float]:
    """(count, total seconds, self seconds) of ``name``'s spans in the
    profiled stretch."""
    s = rec.stretch
    return (s.get(f"{name}:count", 0), s.get(f"{name}:total_s", 0.0),
            s.get(f"{name}:self_s", 0.0))


def windows(rec) -> int:
    """Windows run while the spans recorded."""
    return _span(rec, "execute")[0]


def ms_per_window(rec, *names: str, own: bool = False) -> float | None:
    """The spans ``names``' summed total (``own``: self) time per traced
    window, in ms."""
    n = windows(rec)
    if not n:
        return None
    return sum(_span(rec, s)[2 if own else 1] for s in names) / n * 1e3


def stage_ms_per_epoch(rec) -> float | None:
    """The staging timer over the epochs staged in set-up, in ms."""
    setup = rec.setup_counters
    epochs = setup.get("stage.epochs", 0)
    if not windows(rec) or not epochs:
        return None
    return setup["stage.epoch_s"] / epochs * 1e3

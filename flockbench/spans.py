"""The program's own spans and staging counters, read from its metrics
registry (``flock_tpu_torch.utils.metrics.METRICS``) for the per-layer
metrics.

The program records its spans only while a profiler records (the run
opens no ``tracing()``), so the span totals here are those of the traced
run's profiled stretch, and the window count is the registry's count of
``execute`` spans (one a window).  Every reader returns None while the
registry holds no traced stretch, as it does under a program that has no
spans."""

from __future__ import annotations


def _registry():
    from flock_tpu_torch.utils.metrics import METRICS
    return METRICS


def _span(name: str) -> tuple[int, float, float]:
    """(count, total seconds, self seconds) of ``name``'s spans."""
    got = getattr(_registry(), "spans", {}).get(name)
    return tuple(got) if got else (0, 0.0, 0.0)


def windows() -> int:
    """Windows run while the spans recorded."""
    return _span("execute")[0]


def ms_per_window(*names: str, own: bool = False) -> float | None:
    """The spans ``names``' summed total (``own``: self) time per traced
    window, in ms."""
    n = windows()
    if not n:
        return None
    return sum(_span(s)[2 if own else 1] for s in names) / n * 1e3


def stage_ms_per_epoch() -> float | None:
    """The staging timer over the staged epochs, in ms."""
    reg = _registry()
    epochs = reg.counters.get("stage.epochs", 0)
    if not windows() or not epochs:
        return None
    return reg.timings["stage.epoch_s"] / epochs * 1e3

"""The system under test: ``flock_tpu_torch``'s stream driver, fed a ring of
epochs that lives on the card.

This is the only module of the benchmark that imports the program.  It
takes from it the query registry, the driver, its staging, its executor
(the window's entry and its sink) and the program's counters and spans;
the stream, the windows, the reference and the comparison are the
benchmark's own.

A window runs as ``StreamDriver._run_ranges`` runs it once its epochs are
staged: ``executor.execute_epochs`` over the window's resident epoch
Batches, then ``executor.materialize``, which delivers the window's rows to
the host.  The capacities are the driver's own ``epoch_caps``: an
overflow in the warm-up fails the run, as one in the timed window fails
that window.
"""

from __future__ import annotations

import contextlib
import re
import time

# the program's counters that the readers take from a run's record
COUNTERS = ("execute.form_views", "execute.form_copies", "stage.epochs")
TIMERS = ("stage.epoch_s",)


def query_spec(query: str):
    """The program's ``QuerySpec`` of the benchmark's query name: ``ysb``,
    or ``q<n>`` from the program's NEXMark registry.  Raises
    ``ValueError`` with a one-line reason for a query the program lacks."""
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.queries.ysb import ysb_query

    m = re.fullmatch(r"q(\d+)", query)
    try:
        spec = ysb_query() if query == "ysb" else \
            get_query(int(m.group(1))) if m else None
    except NotImplementedError:
        spec = None
    if spec is None:
        raise ValueError(f"query {query!r}: flock_tpu_torch has no such "
                         f"query (names: ysb, q<n> of its NEXMark registry)")
    return spec


def _registry():
    from flock_tpu_torch.utils.metrics import METRICS
    return METRICS


def registry() -> dict:
    """The program's span totals and the counters and timers of
    ``COUNTERS`` and ``TIMERS``, as they stand: a span ``s`` as
    ``s:count``, ``s:total_s`` and ``s:self_s``."""
    reg = _registry()
    out = {k: reg.counters.get(k, 0) for k in COUNTERS}
    out.update((k, reg.timings.get(k, 0.0)) for k in TIMERS)
    for name, got in list(reg.spans.items()):
        for part, v in zip(("count", "total_s", "self_s"), got):
            out[f"{name}:{part}"] = v
    return out


class Program:
    """The driver over one cell's ring, staged on ``device``, running
    ``query`` over the query's own windows."""

    def __init__(self, query: str, epochs: list[dict], device):
        from flock_tpu_torch.runtime.stream import StreamDriver

        self.spec = query_spec(query)
        self.driver = StreamDriver(self.spec, len(epochs), device=device)
        self.executor = self.driver.executor
        self.staged = self.driver.stage_epochs(
            epochs, self.driver.epoch_caps(epochs))
        self.ranges = [(tag, [t for t in rng if t < len(epochs)])
                       for tag, rng in self.driver.epoch_ranges(epochs)]

    def warm_up(self) -> None:
        """Every distinct window once, with its flags checked."""
        for _, rng in self.ranges:
            self.executor.materialize(self.executor.execute_epochs(
                [self.staged[t] for t in rng]))

    def run_window(self, i: int, spans=None):
        """Window ``i`` of the ring: (host rows, seconds to execute,
        seconds to emit).  ``spans(name)`` opens a named span around each
        part (the traced run's profiler annotations)."""
        spans = spans or (lambda name: contextlib.nullcontext())
        ets = [self.staged[t] for t in self.ranges[i][1]]
        t0 = time.perf_counter()
        with spans("execute"):
            out = self.executor.execute_epochs(ets)
        t1 = time.perf_counter()
        with spans("emit"):
            rows = self.executor.materialize(out)
        return rows, t1 - t0, time.perf_counter() - t1

    def counters(self) -> dict:
        """The program's own counts as they stand: the executor's host
        syncs, its METRICS window counter and execute timer of this query,
        and ``registry()``."""
        reg = _registry()
        q = f"q{self.spec.number}"
        return {
            "host_syncs": self.executor.host_syncs,
            "windows": reg.counters.get(f"{q}.windows", 0),
            "execute_s": reg.timings.get(f"{q}.execute_s", 0.0),
            **registry(),
        }

    def release(self) -> None:
        """Drop the staged ring, so that the reference finds the memory."""
        self.staged = None

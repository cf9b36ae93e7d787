"""The system under test: ``flock_tpu_torch``'s stream driver, fed a ring of
epochs that lives on the card.

This is the only module of the benchmark that imports the program.  It
takes from it the driver, its staging, its executor (the window's entry and
its sink) and the executor's counters; the stream, the reference and the
comparison are the benchmark's own.

A window runs as ``StreamDriver._run_ranges`` runs it once its epochs are
staged: ``executor.execute_epochs`` over the window's resident epoch
Batches, then ``executor.materialize``, which delivers the window's rows to
the host.  The capacities are the driver's own ``epoch_caps``: an
overflow in the warm-up fails the run, as one in the timed window fails
that window.
"""

from __future__ import annotations

import contextlib
import time

# the program's queries by the benchmark's query names
_NEXMARK = {"q5": 5, "q7": 7}


def query_spec(query: str):
    if query == "ysb":
        from flock_tpu_torch.queries.ysb import ysb_query
        return ysb_query()
    from flock_tpu_torch.queries.nexmark import get_query
    return get_query(_NEXMARK[query])


class Program:
    """The driver over one cell's ring, staged on ``device``."""

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
        """The program's own counts: the executor's host syncs, and its
        METRICS window counter and execute timer of this query."""
        from flock_tpu_torch.utils.metrics import METRICS

        q = f"q{self.spec.number}"
        return {
            "host_syncs": self.executor.host_syncs,
            "windows": METRICS.counters.get(f"{q}.windows", 0),
            "execute_s": METRICS.timings.get(f"{q}.execute_s", 0.0),
        }

    def release(self) -> None:
        """Drop the staged ring, so that the reference finds the memory."""
        self.staged = None

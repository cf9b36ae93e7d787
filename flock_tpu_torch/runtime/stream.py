"""Stream driver — the counterpart of ``flock_tpu/runtime/stream.py``, cut
down to what the q3/q4/q9/q13 slices need: ``generate_epochs`` and a
``StreamDriver`` for element-wise windows (one window per epoch,
elementwise.rs in the reference) with the overflow widen-and-retry of
``_execute_all``, and q13's side input staged once per driver.  Other window
kinds raise.
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from flock_tpu_torch.batch import round_up
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.datagen.native_gen import nexmark_generate_partition
from flock_tpu_torch.datagen.nexmark import NexmarkConfig
from flock_tpu_torch.queries.nexmark import QuerySpec, get_query
from flock_tpu_torch.runtime.executor import LocalExecutor, OverflowError
from flock_tpu_torch.runtime.tables import (concat_relations,
                                            epoch_to_relations,
                                            window_relations)


def generate_epochs(seconds: int, events_per_second: int, generators: int = 1
                    ) -> list[dict]:
    """Generate and merge all generator partitions into per-epoch relation
    tables — column for column what ``flock_tpu.runtime.stream.
    generate_epochs`` returns for the same arguments."""
    cfg = NexmarkConfig(events_per_second=events_per_second,
                        num_event_generators=generators)
    per_epoch: dict[int, list] = defaultdict(list)
    # ctypes releases the GIL during native generation: partitions generate
    # in parallel threads
    with ThreadPoolExecutor(max_workers=min(generators, 8)) as pool:
        results = list(pool.map(
            lambda p: nexmark_generate_partition(cfg, seconds, p),
            range(generators)))
    for eps in results:
        for e in eps:
            per_epoch[e.epoch].append(epoch_to_relations(e))
    return [concat_relations(per_epoch.get(t, []), ("person", "auction", "bid"))
            for t in range(seconds)]


@dataclass
class WindowResult:
    tag: tuple          # window identifier, e.g. ("epoch", 3)
    columns: dict       # materialized output columns (schema order)


class StreamDriver:
    def __init__(self, spec: QuerySpec, seconds: int,
                 side_input: dict | None = None,
                 agg_capacity: int | None = None, device=None):
        self.spec = spec
        self.seconds = seconds
        self.executor = LocalExecutor(spec, agg_capacity, device, side_input)

    def _window_epoch_ranges(self):
        """Window tag → epoch list (element-wise windows only)."""
        kind = self.spec.window[0]
        if kind != "elementwise":
            raise NotImplementedError(f"{kind} windows are not ported")
        return [(("epoch", t), [t]) for t in range(self.seconds)]

    def windows(self, epochs: list[dict]) -> list[tuple]:
        """(tag, relation tables) for every window of the stream; the
        static side input is the executor's, not a window's."""
        return [(tag, concat_relations([epochs[t] for t in rng
                                        if t < len(epochs)],
                                       window_relations(self.spec.relations)))
                for tag, rng in self._window_epoch_ranges()]

    def run(self, epochs: list[dict]) -> list[WindowResult]:
        return self._execute_all(self.windows(epochs))

    def _fixed_caps(self, windows, relations) -> dict[str, int]:
        caps = {}
        for rel in relations:
            m = 1
            for _, tables in windows:
                cols = tables.get(rel)
                if cols:
                    m = max(m, len(next(iter(cols.values()))))
            caps[rel] = max(round_up(m), 128)
        return caps

    def _execute_all(self, windows) -> list[WindowResult]:
        """Run every window with one capacity signature.  On overflow (static
        buffers too small — a wide key span, or join fan-out extras from
        duplicate build keys) the aggregate capacity quadruples, relation
        capacities double, and the window retries."""
        caps = self._fixed_caps(windows, list({r for _, t in windows for r in t}))
        out = []
        for tag, tables in windows:
            for attempt in range(6):
                try:
                    b = self.executor.execute_window(tables, caps)
                    break
                except OverflowError:
                    if attempt == 5:
                        raise
                    base = self.executor.agg_capacity or (
                        max(caps.values()) + CONFIG.agg_span_margin)
                    self.executor.agg_capacity = base * 4
                    caps = {r: c * 2 for r, c in caps.items()}
            out.append(WindowResult(tag, self.executor.materialize(b)))
        return out


def run_nexmark(query: int, seconds: int = 2, events_per_second: int = 1000,
                generators: int = 1, side_input: dict | None = None,
                device=None) -> list[WindowResult]:
    """End to end: generate → window → execute → materialize, on ``device``
    (``None`` → ``cuda``).  ``side_input`` is q13's table (``None`` →
    ``default_side_input()``)."""
    spec = get_query(query)
    driver = StreamDriver(spec, seconds, side_input=side_input, device=device)
    return driver.run(generate_epochs(seconds, events_per_second, generators))

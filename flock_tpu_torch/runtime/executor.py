"""Single-device executor — the counterpart of ``LocalExecutor``,
``_pow2_bucket`` and ``materialize_columns`` in
``flock_tpu/runtime/executor.py``.

Host columns → fixed-capacity device Batches → the plan run eagerly on the
device → host materialization with timestamp restore and the exact f64 sink
columns.  A window is either one set of Batches (``execute_batches``) or a
list of per-epoch Batches staged once and concatenated on the device
(``execute_epochs``, the range windows' path).  Static relations (q13's
``side_input``) are staged on the device once (``statics()``) and merged
into every window's tables.  Each window reads its overflow and escape flags in one
host sync; an escape (duplicate build keys, slot overflow in a fused pass,
or an int64 column too wide to rebase to int32) reruns the plan with the
duplicate-faithful fallback and the unrebased scatter, and is counted in
``fallback_runs``.

``execute_stacked``, ``execute_session_tables``, ``execute_consts`` and the
session state are later slices of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from flock_tpu_torch import resolve_device
from flock_tpu_torch.batch import TS_BASE, Batch, round_up
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.plan import compile_plan
from flock_tpu_torch.queries.nexmark import QuerySpec
from flock_tpu_torch.runtime.tables import default_side_input, window_relations


class OverflowError(RuntimeError):
    """A static output capacity was exceeded (the analogue of Flock's payload
    size guards); retry with larger capacities."""


def _pow2_bucket(n: int) -> int:
    """Power-of-two capacity bucket (at least 128): windows of varying row
    counts share a handful of capacities."""
    c = 128
    while c < n:
        c *= 2
    return c


@dataclass
class LocalExecutor:
    spec: QuerySpec
    agg_capacity: int | None = None
    device: torch.device | str | None = None  # None → cuda (raises without)
    side_input: dict | None = None  # q13's table; None → default_side_input()
    fallback_runs: int = 0
    _statics: dict | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def statics(self) -> dict[str, Batch]:
        """The query's static relations (q13's ``side_input``) as device
        Batches, staged on first use and shared by every window."""
        if self._statics is None:
            self._statics = {}
            if "side_input" in self.spec.relations:
                self._statics = self.prepare_window(
                    {"side_input": self.side_input or default_side_input()})
        return self._statics

    def prepare_window(self, tables: dict[str, dict[str, np.ndarray]],
                       capacities: dict[str, int] | None = None
                       ) -> dict[str, Batch]:
        """Host columns → fixed-capacity device Batches (the feed step)."""
        capacities = capacities or {}
        batches = {}
        for rel, cols in tables.items():
            n = len(next(iter(cols.values()))) if cols else 0
            cap = capacities.get(rel) or max(round_up(max(n, 1)), 128)
            batches[rel] = Batch.from_numpy(cols, cap, self.device)
        return batches

    def execute_batches(self, batches: dict[str, Batch],
                        check_overflow: bool = True) -> Batch:
        """Run the plan over device-resident Batches (compute only); the
        static relations join them without another copy.  The aggregate
        capacity follows the window's relations, as the reference's
        ``execute_epochs``."""
        agg_cap = self.agg_capacity or (
            max(batches[r].capacity for r in window_relations(batches))
            + CONFIG.agg_span_margin)
        return self._run({**self.statics(), **batches}, agg_cap,
                         check_overflow, lambda: "caps={}".format(tuple(
                             sorted((r, b.capacity)
                                    for r, b in batches.items()))))

    def execute_epochs(self, epoch_tables: list[dict[str, Batch]],
                       check_overflow: bool = True) -> Batch:
        """Run the plan over a window formed from device-resident per-epoch
        Batches of equal capacities: each relation's columns and ``valid``
        concatenate on the device (one ``torch.cat`` each), a one-epoch
        window takes its epoch's Batches as they stand, and the executor's
        ``statics()`` join them.  The aggregate capacity is the
        reference's: epochs × the largest per-epoch capacity + the span
        margin, what ``execute_batches`` computes on the concatenated
        window."""
        caps = tuple(sorted(
            (rel, b.capacity) for rel, b in epoch_tables[0].items()))
        agg_cap = self.agg_capacity or (
            len(epoch_tables) * max(c for _, c in caps)
            + CONFIG.agg_span_margin)
        if len(epoch_tables) == 1:
            merged = dict(epoch_tables[0])
        else:
            merged = {rel: Batch(
                {c: torch.cat([et[rel].columns[c] for et in epoch_tables])
                 for c in b.columns},
                torch.cat([et[rel].valid for et in epoch_tables]))
                for rel, b in epoch_tables[0].items()}
        tables = {**self.statics(), **merged}
        return self._run(tables, agg_cap, check_overflow,
                         lambda: f"w={len(epoch_tables)}, caps={caps}")

    def _run(self, tables: dict[str, Batch], agg_cap: int,
             check_overflow: bool, what) -> Batch:
        """The plan over one window's tables, with the overflow and escape
        flags read in one host sync and the fallback rerun on an escape;
        ``what()`` describes the window's capacities for an overflow."""
        fn = compile_plan(self.spec.plan, agg_cap)
        out, overflow, escape = fn(tables)
        overflow, escape = torch.stack([overflow, escape]).tolist()
        if escape:
            self.fallback_runs += 1
            out, overflow, _ = fn(tables, fallback=True)
            overflow = bool(overflow)
        if check_overflow and overflow:
            raise OverflowError(
                f"q{self.spec.number}: static capacity exceeded "
                f"({what()}, agg={agg_cap})")
        return out

    def execute_window(self, tables: dict[str, dict[str, np.ndarray]],
                       capacities: dict[str, int] | None = None) -> Batch:
        """Run the query plan over one window's relation tables.  Returns the
        device output Batch (padded); raises OverflowError when a static
        capacity was exceeded."""
        return self.execute_batches(self.prepare_window(tables, capacities))

    def stage_chunk(self, cols: dict[str, np.ndarray],
                    capacity: int) -> Batch:
        """One epoch's columns → a device-resident Batch of ``capacity``
        rows."""
        return Batch.from_numpy(cols, capacity, self.device)

    def _driving_relation(self) -> str:
        rels = window_relations(self.spec.relations)
        if len(rels) != 1:
            raise ValueError("chunked execution needs one driving relation")
        return rels[0]

    def materialize(self, out: Batch) -> dict[str, np.ndarray]:
        return materialize_columns(self.spec, out.to_numpy())


def materialize_columns(spec: QuerySpec, host: dict[str, np.ndarray]
                        ) -> dict[str, np.ndarray]:
    """Sink-side finalization: restore absolute timestamps (int32 relative
    → int64 ms) and recompute exact f64 money columns from their integer
    basis."""
    schema = spec.schema
    result = {}
    for name in schema.names:
        v = host[name]
        if name in schema.timestamp_cols:
            v = v.astype(np.int64) + TS_BASE
        if name in schema.f64_recompute:
            kind, a, b = schema.f64_recompute[name]
            if kind == "mul_lit":
                v = a * host[b].astype(np.float64)
            elif kind == "div":
                v = host[a].astype(np.float64) / np.maximum(host[b], 1)
        # the hand-built queries' recipes (as in the reference): q1's money
        # column from its cents, q4's average from its exact sum and count
        elif name == "price" and "price_cents" in host:
            v = 0.908 * host["price_cents"].astype(np.float64)
        elif name == "avg_final" and "sum_final" in host:
            v = host["sum_final"].astype(np.float64) / host["cnt"]
        result[name] = v
    return result

"""Single-device executor — the counterpart of ``LocalExecutor``,
``_pow2_bucket``, ``_consts_fast_shape``, the two consts runners and
``materialize_columns`` in ``flock_tpu/runtime/executor.py``.

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

``execute_consts`` runs a processing-time window (q12): staged chunks and
one constant int32 column per chunk (``p_time``, the arrival epoch in ms),
made on the device.  A single-key Aggregate over the driving scan whose
other aggregates read only those constants takes the fast runner: one
count per chunk on kernel K2, shifted to the window's base key on the
device and summed, the constants' min/max/sum derived from the counts.
Any other plan runs over the chunks concatenated, with the constants
filled in (``torch.full``).

``execute_session_tables`` runs one emission of the generic session tier
(q11's plans that the device tier does not take): the staged chunks
concatenate on the device, each row gathers its session label and its
session's chunk range from three dense tables (``kernels.lookup_join`` with
a slotted build: kernel K3), rows outside their session's range turn
invalid, and the plan aggregates by ``__session`` (kernel K2).

Every window is counted in ``utils.metrics.METRICS`` (windows, rows in,
execute seconds), as in the reference.  ``execute_stacked`` is a later
slice of the port.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from flock_tpu_torch import resolve_device
from flock_tpu_torch.batch import TS_BASE, Batch, round_up
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.plan import Aggregate, Scan, compile_plan
from flock_tpu_torch.queries.nexmark import QuerySpec
from flock_tpu_torch.runtime.tables import default_side_input, window_relations
from flock_tpu_torch.utils.metrics import METRICS


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


_I64_MAX, _I64_MIN = 2**63 - 1, -(2**63)


def _consts_fast_shape(plan, rel: str, const_names, key_dtype=None) -> bool:
    """True when the plan is a single-key Aggregate over the driving scan
    whose other aggregates read only per-chunk constant columns — q12's
    shape: min/max/sum of a constant follow from per-chunk counts.
    ``key_dtype`` guards the runner's int32 key cast: any key but int32
    takes the general runner."""
    if not (isinstance(plan, Aggregate) and isinstance(plan.child, Scan)
            and plan.child.relation == rel and len(plan.group_keys) == 1):
        return False
    if key_dtype is not None and key_dtype != torch.int32:
        return False
    return all(fn == "count" or (c in const_names
                                 and fn in ("min", "max", "sum"))
               for c, fn, _ in plan.aggs)


def _run_plan_consts_fast(plan, agg_capacity: int, chunks: list[Batch],
                          const_names: tuple[str, ...], const_vals):
    """The fast runner: one count per chunk (kernel K2, slotted at the
    chunk's own minimum key), each shifted to the window's base ``m`` and
    summed, and the constants' aggregates derived from the counts.  ``m``,
    the shifts and the overflow stay on the device: a chunk's count moves
    by an index made from ``arange`` and its device offset, clamped as the
    reference's slice start.  Returns (Batch, overflow)."""
    key = plan.group_keys[0]
    cap = agg_capacity
    dev = chunks[0].valid.device
    m = torch.stack([torch.where(ch.valid, ch.columns[key].to(torch.int64),
                                 _I64_MAX).amin()
                     for ch in chunks]).amin().to(torch.int32)
    slots = torch.arange(cap, device=dev)
    over, cnts = [], []
    for ch in chunks:
        k32 = ch.columns[key].to(torch.int32)
        out, _, _, esc = kernels.dense_group_aggregate(
            {key: k32}, ch.valid, key, [(None, "count", "__fast_cnt")], cap)
        cmin = torch.where(ch.valid, k32, kernels.I32_MAX).amin()
        # a key at or beyond the shared base's capacity would be cut off by
        # the shift: overflow
        over += [esc, torch.where(ch.valid, k32, m).amax() - m >= cap]
        off = torch.where(ch.valid.any(), cmin - m, 0).clamp(0, cap)
        src = slots - off
        cnt = out["__fast_cnt"]
        cnts.append(torch.where(src >= 0, cnt[src.clamp(min=0)], 0))
    total = torch.stack(cnts).sum(0, dtype=torch.int32)
    cols = {key: (m.to(torch.int64) + slots).to(torch.int32)}
    idx = {nm: j for j, nm in enumerate(const_names)}
    for c, fn, name in plan.aggs:
        if fn == "count":
            cols[name] = total
            continue
        vals = [int(const_vals[i][idx[c]]) for i in range(len(chunks))]
        if fn == "sum":
            cols[name] = torch.stack([cnt.to(torch.int64) * v
                                      for cnt, v in zip(cnts, vals)]).sum(0)
            continue
        sent = _I64_MAX if fn == "min" else _I64_MIN
        per = torch.stack([torch.where(cnt > 0, v, sent)
                           for cnt, v in zip(cnts, vals)])
        red = per.amin(0) if fn == "min" else per.amax(0)
        cols[name] = red.to(torch.int32)
    return Batch(cols, total > 0), kernels.any_flag(*over)


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
                                    for r, b in batches.items()))),
                         sum(b.capacity for b in batches.values()))

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
                         lambda: f"w={len(epoch_tables)}, caps={caps}",
                         len(epoch_tables) * sum(c for _, c in caps))

    @contextlib.contextmanager
    def _metered(self, rows_in: int):
        """One window in ``METRICS``, under the reference's names: the
        window, its ``rows_in`` (its capacities: host ints, no sync) and
        the time of the block (``execute_s``)."""
        q = f"q{self.spec.number}"
        METRICS.count(f"{q}.windows")
        METRICS.count(f"{q}.rows_in", rows_in)
        with METRICS.timer(f"{q}.execute_s"):
            yield

    def _run(self, tables: dict[str, Batch], agg_cap: int,
             check_overflow: bool, what, rows_in: int) -> Batch:
        """The plan over one window's tables, with the overflow and escape
        flags read in one host sync and the fallback rerun on an escape;
        ``what()`` describes the window's capacities for an overflow."""
        with self._metered(rows_in):
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

    def execute_session_tables(self, chunks: list[Batch], key: str,
                               tables: tuple, cids,
                               agg_capacity: int) -> Batch:
        """Run the plan over staged chunks whose rows are labelled and
        filtered on the device from an emission's dense tables
        (``Emission.dense_tables``: ``rank_tab``, ``ok_tab``, ``end_tab``
        over the keys ``cmin + i``, and ``k`` sessions): only the tables
        cross to the device, never the rows.  A row of chunk ``cids[i]``
        joins its key's slot (K3); it carries ``__session`` =
        ``min(rank, k - 1)`` and is live iff ``ok <= cid < end``.  Raises
        OverflowError when the sessions overflow ``agg_capacity``."""
        rank_tab, ok_tab, end_tab, cmin, k = tables
        span_bucket = len(rank_tab)
        dev = self.device
        cols = {c: torch.cat([ch.columns[c] for ch in chunks])
                for c in chunks[0].columns}
        valid_in = torch.cat([ch.valid for ch in chunks])
        cidvec = torch.cat([torch.full((ch.capacity,), int(cid),
                                       dtype=torch.int32, device=dev)
                            for ch, cid in zip(chunks, cids)])
        build = {"__k": (torch.arange(span_bucket, device=dev)
                         + int(cmin)).to(torch.int32)}
        for name, tab in (("__rank", rank_tab), ("__ok", ok_tab),
                          ("__end", end_tab)):
            build[name] = torch.from_numpy(np.ascontiguousarray(tab)).to(dev)
        joined, hit, _, _ = kernels.lookup_join(
            build, torch.ones(span_bucket, dtype=torch.bool, device=dev),
            "__k", {"__k": cols[key].to(torch.int32)}, valid_in, "__k",
            {"__rank": "__rank", "__ok": "__ok", "__end": "__end"},
            build_slotted=True)
        cols["__session"] = joined["__rank"].clamp(max=int(k) - 1)
        valid = hit & (joined["__ok"] <= cidvec) & (cidvec < joined["__end"])
        return self._run({self._driving_relation(): Batch(cols, valid)},
                         agg_capacity, True,
                         lambda: f"session emission, {len(chunks)} chunks",
                         sum(ch.capacity for ch in chunks))

    def execute_consts(self, chunks: list[Batch],
                       const_cols: dict[str, list],
                       agg_capacity: int) -> Batch:
        """Run the plan over staged chunks plus one constant int32 column
        per name and chunk (``const_cols[name][i]`` for chunk i), at
        ``agg_capacity`` slots: the fast runner when the plan has
        ``_consts_fast_shape``, else the plan over the concatenated chunks
        with the constants made on the device.  Raises OverflowError when a
        key lies at or beyond the window's base plus the capacity."""
        names = tuple(sorted(const_cols))
        vals = np.asarray([[const_cols[nm][i] for nm in names]
                           for i in range(len(chunks))], np.int32)
        plan = self.spec.plan
        keys = getattr(plan, "group_keys", None)
        key_dt = chunks[0].columns[keys[0]].dtype \
            if keys and keys[0] in chunks[0].columns else None
        rel = self._driving_relation()
        if _consts_fast_shape(plan, rel, names, key_dtype=key_dt):
            with self._metered(sum(ch.capacity for ch in chunks)):
                out, overflow = _run_plan_consts_fast(
                    plan, agg_capacity, chunks, names, vals.tolist())
                overflow = bool(overflow)
            if overflow:
                raise OverflowError(
                    f"q{self.spec.number}: const-epoch capacity exceeded "
                    f"(agg={agg_capacity})")
            return out
        return self._run_plan_consts(chunks, rel, names, vals, agg_capacity)

    def _run_plan_consts(self, chunks: list[Batch], rel: str,
                         names: tuple[str, ...], vals: np.ndarray,
                         agg_capacity: int) -> Batch:
        """The general runner: the chunks concatenated on the device, each
        constant filled per chunk (``torch.full``), then the plan."""
        cols = {c: torch.cat([ch.columns[c] for ch in chunks])
                for c in chunks[0].columns}
        for j, name in enumerate(names):
            cols[name] = torch.cat([
                torch.full((ch.capacity,), int(vals[i, j]), dtype=torch.int32,
                           device=ch.valid.device)
                for i, ch in enumerate(chunks)])
        batch = Batch(cols, torch.cat([ch.valid for ch in chunks]))
        return self._run({rel: batch}, agg_capacity, True,
                         lambda: f"const-epoch, {len(chunks)} chunks",
                         sum(ch.capacity for ch in chunks))

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
        # column from its cents, q4's and q6's averages from their exact
        # sums and counts
        elif name == "price" and "price_cents" in host:
            v = 0.908 * host["price_cents"].astype(np.float64)
        elif name == "avg_final" and "sum_final" in host:
            v = host["sum_final"].astype(np.float64) / host["cnt"]
        elif name == "avg_price" and "sum_price" in host:
            v = host["sum_price"].astype(np.float64) / host["cnt"]
        result[name] = v
    return result

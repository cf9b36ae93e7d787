"""Static operator DAG and its lowering to PyTorch — the counterpart of
``flock_tpu/plan.py`` for the node kinds the ported queries and their
duplicate fallbacks reach (Scan, Filter, Project, Aggregate, Join, Rank,
Sort, Compact, FusedJoinAggregate).

The node classes, ``fuse_join_aggregates``, ``walk``, ``_sorted_by``,
``_slot_dense``, ``referenced_columns`` and ``dup_expand_capacity`` are the
port's own copies (the TPU-only locality and limb hints are left out).
Lowering runs eagerly on the batches' device.  An Aggregate over a Rank on
its key (q6's per-seller average) takes the sorted-segment path; a fused
pass replays a middle Project whose callables read only probe columns
(q6's ``__order``) on the probe side before kernel K1.

Where the reference branches to the duplicate-faithful fallback on the
device (``lax.cond``), the port returns the escape flag (duplicate build
keys of a fused pass or of a duplicate-faithful join, slot overflow of a
fused pass, an int64 range too wide to rebase) as a 0-d tensor beside the
overflow flag; the executor reads both once per window and, when the escape
is set, lowers the plan again with ``fallback=True``: every fused node
replaced by its fallback, every duplicate-faithful join fanned out, every
int64 aggregate column left unrebased.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import reduce
from typing import Callable

import torch

from flock_tpu_torch.batch import Batch
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.ops import kernels, lookup_agg
from flock_tpu_torch.ops.lookup_agg import lookup_aggregate
from flock_tpu_torch.ops.join_agg import (fits_kernel, join_aggregate,
                                        unsupported_aggs, wide_cols)
from flock_tpu_torch.utils.metrics import METRICS

Expr = Callable[[dict], torch.Tensor]

_CMP = {"<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
        "==": torch.eq, "!=": torch.ne}


@dataclass(frozen=True)
class Conj:
    """A conjunction of comparisons, ``terms = ((lhs, op, rhs), ...)`` with
    ``op`` one of ``< <= > >= == !=``, ``lhs`` a column and ``rhs`` a column
    or an integer literal.  Callable on a column dict like any predicate,
    and inspectable: the fused kernels read its terms (K1 column terms only,
    ``join_agg.fits_kernel``; K4 both kinds)."""

    terms: tuple

    def __post_init__(self):
        if not self.terms:
            raise ValueError("a conjunction needs at least one term")
        for lhs, op, rhs in self.terms:
            if op not in _CMP:
                raise ValueError(f"unknown comparison {op!r}")
            if not isinstance(lhs, str) or isinstance(rhs, bool) \
                    or not isinstance(rhs, (str, int)):
                raise TypeError(f"a term compares a column with a column or "
                                f"an int, got {(lhs, op, rhs)!r}")

    def columns(self) -> list[str]:
        """The columns the terms read, each once, in order."""
        return list(dict.fromkeys(c for lhs, _, rhs in self.terms
                                  for c in (lhs, rhs) if isinstance(c, str)))

    def __call__(self, cols: dict) -> torch.Tensor:
        # one device operation per term and one per AND (a single term is
        # its own mask)
        return reduce(torch.logical_and, [
            _CMP[op](cols[lhs], cols[rhs] if isinstance(rhs, str) else rhs)
            for lhs, op, rhs in self.terms])


@dataclass(frozen=True)
class Node:
    def inputs(self) -> tuple["Node", ...]:
        return ()


@dataclass(frozen=True)
class Scan(Node):
    relation: str


@dataclass(frozen=True)
class Filter(Node):
    child: Node
    pred: Expr
    label: str = ""

    def inputs(self):
        return (self.child,)


@dataclass(frozen=True)
class Project(Node):
    child: Node
    exprs: tuple  # tuple[(out_name, str passthrough | Expr)]

    def inputs(self):
        return (self.child,)


@dataclass(frozen=True)
class Aggregate(Node):
    """Grouped aggregation (single mode: one complete aggregation)."""

    child: Node
    group_keys: tuple[str, ...]
    aggs: tuple  # tuple[(in_col|None, fn, out_name)]
    out_capacity: int | None = None

    def inputs(self):
        return (self.child,)


@dataclass(frozen=True)
class Join(Node):
    """Inner lookup join (see ``kernels.lookup_join``).  ``post_filter``
    runs on the joined row (probe cols + taken build cols), e.g. q4's
    interval predicate b_date_time BETWEEN a_date_time AND expires.

    Duplicate build keys fan out (duplicate-faithful, DataFusion hash-join
    semantics); ``unique_build=True`` declares that build keys cannot
    duplicate (q13's side input), which skips the expansion buffer and turns
    surprise duplicates into an overflow."""

    build: Node
    probe: Node
    build_key: str
    probe_key: str
    take: tuple  # tuple[(build_col, out_name)]
    post_filter: Expr | None = None
    unique_build: bool = False

    def inputs(self):
        return (self.build, self.probe)


@dataclass(frozen=True)
class Rank(Node):
    """ROW_NUMBER() OVER (PARTITION BY group ORDER BY order)."""

    child: Node
    group_key: str
    order_col: str
    descending: bool
    rank_name: str
    tiebreak: str | None = None

    def inputs(self):
        return (self.child,)


@dataclass(frozen=True)
class Sort(Node):
    child: Node
    keys: tuple[str, ...]
    descending: tuple[bool, ...] = ()

    def inputs(self):
        return (self.child,)


@dataclass(frozen=True)
class Compact(Node):
    """Densify live rows into a smaller buffer (CoalesceBatchesExec
    analogue)."""

    child: Node
    out_capacity: int

    def inputs(self):
        return (self.child,)


@dataclass(frozen=True)
class FusedJoinAggregate(Node):
    """Join + (filters, projections) + grouped aggregation in one pass (K1) —
    joined rows are never built.  Produced by ``fuse_join_aggregates`` when
    an Aggregate's primary group key is the join key of a lookup Join below
    it (the winning-bid core of q4).

    ``group_key2`` is a secondary group key that is a taken build column
    (q4's GROUP BY a_id, category): with unique build keys it is carried as
    a max.  Duplicate build keys escape to ``fallback``, the original
    Aggregate subtree over the duplicate-faithful join."""

    join: Join
    middle: tuple            # Filter/Project chain, join-side first
    group_key: str
    aggs: tuple
    fallback: Node = None
    out_capacity: int | None = None
    group_key2: str | None = None

    def inputs(self):
        return (self.join,)


@dataclass(frozen=True)
class FusedLookupAggregate(Node):
    """Filters + unique lookup join + counts grouped by a taken build column
    in one probe pass (K4, ``ops/lookup_agg.py``): the filter mask, the
    gathered column and the joined rows are never built.  Produced by
    ``fuse_join_aggregates`` when an Aggregate of counts has one group key
    that resolves, through renaming Projects, to a column a
    ``unique_build`` Join without a post-filter takes from its build side,
    and the Join's probe side is a chain of Filters with ``Conj``
    predicates over a Scan (YSB's views per campaign).  The group is a
    function of the join key, so each probe row's group comes through the
    build's slot table.

    ``join`` is that Join with the Filters taken off its probe side;
    ``pred`` is their terms as one ``Conj`` (None without a Filter);
    ``taken`` is the build column the group key resolves to.  A window
    whose taken values span more than the output's slots escapes to
    ``fallback``, the original Aggregate subtree; duplicate build keys
    overflow, as the unique join's do."""

    join: Join
    taken: str
    group_key: str
    aggs: tuple
    pred: Conj | None = None
    fallback: Node = None
    out_capacity: int | None = None

    def inputs(self):
        return (self.join,)


def _sorted_by(node: Node, key: str) -> bool:
    """True when ``node``'s rows arrive grouped by ``key``: a Rank on that
    key, or a Sort whose first key it is, below order-preserving Filters
    and Projects (the reference's ``_sorted_by``)."""
    while True:
        if isinstance(node, Filter):
            node = node.child
        elif isinstance(node, Project):
            src = dict(node.exprs).get(key)
            if not isinstance(src, str):
                return False
            key = src
            node = node.child
        else:
            break
    if isinstance(node, Sort):
        return bool(node.keys) and node.keys[0] == key
    return isinstance(node, Rank) and node.group_key == key


def _slot_dense(node: Node, key: str) -> bool:
    """True when ``node`` lowers to a dense-slot relation keyed on ``key``
    (slot i holds key ``col[0] + i``, gaps invalid): single-key Aggregates
    (every ``dense_group_aggregate`` branch slots its output) and fused
    join-aggregates without a secondary key.  Callers still check that the
    key is an integer (float keys take the sort-based, non-slotted path)."""
    while isinstance(node, Project):
        src = dict(node.exprs).get(key)
        if not isinstance(src, str):
            return False
        key = src
        node = node.child
    if isinstance(node, Aggregate):
        return node.group_keys == (key,) and not _sorted_by(node.child, key)
    if isinstance(node, FusedJoinAggregate):
        # a secondary key means duplicate windows emit more than one row per
        # primary key (the fallback's multi-key output is not slotted)
        return node.group_key == key and node.group_key2 is None
    return isinstance(node, FusedLookupAggregate) and node.group_key == key


def dup_expand_capacity(n_probe: int) -> int:
    """Join output capacity with fan-out headroom for duplicate build keys:
    half the probe capacity of free tail (128-aligned) on top of the probe's
    own rows; extras beyond it overflow and the drivers widen and retry."""
    return n_probe + max((n_probe // 2 + 127) // 128 * 128, 128)


@dataclass
class Lowered:
    """Result of lowering a node: columns + validity + overflow and escape
    flags (0-d bool tensors)."""

    cols: dict
    valid: torch.Tensor
    overflow: torch.Tensor
    escape: torch.Tensor


def lower(node: Node, tables: dict[str, Batch], agg_capacity: int | None = None,
          fallback: bool = False, memo: dict | None = None) -> Lowered:
    """Recursively lower a plan over concrete input batches.  ``fallback``
    lowers every fused node as its fallback subtree, fans out every
    duplicate-faithful join and aggregates int64 columns by scatter, never
    rebased (the escape rerun).

    A subtree the plan reaches twice is lowered once per ``memo``: q5's
    per-auction counts feed both sides of its join, and eager execution
    would count them twice where the reference's compiler merges the two.
    Entries key on the node's identity and the aggregate capacity and hold
    the node, so no id is reused while the memo lives."""
    memo = {} if memo is None else memo
    key = (id(node), agg_capacity)
    if key not in memo:
        memo[key] = (node, _lower_node(node, tables, agg_capacity, fallback,
                                       memo))
    return memo[key][1]


def _lower_node(node: Node, tables, agg_capacity, fallback: bool,
                memo: dict) -> Lowered:
    if isinstance(node, Scan):
        b = tables[node.relation]
        f = kernels.false_flag(b.valid.device)
        return Lowered(dict(b.columns), b.valid, f, f)

    if isinstance(node, Filter):
        c = lower(node.child, tables, agg_capacity, fallback, memo)
        return Lowered(c.cols, c.valid & node.pred(c.cols), c.overflow, c.escape)

    if isinstance(node, Project):
        c = lower(node.child, tables, agg_capacity, fallback, memo)
        out = {name: c.cols[e] if isinstance(e, str) else e(c.cols)
               for name, e in node.exprs}
        return Lowered(out, c.valid, c.overflow, c.escape)

    if isinstance(node, Aggregate):
        c = lower(node.child, tables, agg_capacity, fallback, memo)
        if len(node.group_keys) == 1 \
                and _sorted_by(node.child, node.group_keys[0]):
            # rows arrive sorted by the key (a Rank below): segmented
            # prefix sums, no scatter by key; the input capacity is kept
            cols, valid, ovf = kernels.sorted_segment_aggregate(
                c.cols, c.valid, node.group_keys[0], list(node.aggs))
            return Lowered(cols, valid, kernels.any_flag(c.overflow, ovf),
                           c.escape)
        cap = node.out_capacity or agg_capacity or c.valid.shape[0]
        cols, valid, ovf, esc = kernels.group_aggregate(
            c.cols, c.valid, list(node.group_keys), list(node.aggs), cap,
            rebase=not fallback)
        return Lowered(cols, valid, kernels.any_flag(c.overflow, ovf),
                       kernels.any_flag(c.escape, esc))

    if isinstance(node, Join):
        b = lower(node.build, tables, agg_capacity, fallback, memo)
        p = lower(node.probe, tables, agg_capacity, fallback, memo)
        # the escape rerun keeps a slotted build slotted: a fused node lowers
        # to its single-key Aggregate, which slots its output too
        b_slotted = _slot_dense(node.build, node.build_key)
        if b.cols[node.build_key].is_floating_point() \
                or p.cols[node.probe_key].is_floating_point():
            # float keys have no dense slot span: sort the build side and
            # binary-search the probes (never an overflow or an escape)
            cols, valid = kernels.sorted_lookup_join(
                b.cols, b.valid, node.build_key, p.cols, p.valid,
                node.probe_key, dict(node.take))
            ovf = esc = kernels.false_flag(valid.device)
        elif b_slotted and _slot_dense(node.probe, node.probe_key):
            # both sides are dense-slot aggregates over the same key domain:
            # the join is a shifted contiguous copy (q8)
            cols, valid, ovf = kernels.slot_join(
                b.cols, b.valid, node.build_key, p.cols, p.valid,
                node.probe_key, dict(node.take))
            esc = kernels.false_flag(ovf.device)
        else:
            exp_cap = None
            if not node.unique_build and not b_slotted:
                exp_cap = dup_expand_capacity(p.valid.shape[0])
            cols, valid, ovf, esc = kernels.lookup_join(
                b.cols, b.valid, node.build_key, p.cols, p.valid,
                node.probe_key, dict(node.take), out_capacity=exp_cap,
                build_slotted=b_slotted, dup_expand=not node.unique_build,
                fallback=fallback)
        if node.post_filter is not None:
            valid = valid & node.post_filter(cols)
        return Lowered(cols, valid,
                       kernels.any_flag(b.overflow, p.overflow, ovf),
                       kernels.any_flag(b.escape, p.escape, esc))

    if isinstance(node, Rank):
        c = lower(node.child, tables, agg_capacity, fallback, memo)
        cols, valid = kernels.rank_in_group(
            c.cols, c.valid, node.group_key, node.order_col, node.descending,
            node.rank_name, node.tiebreak)
        return Lowered(cols, valid, c.overflow, c.escape)

    if isinstance(node, Sort):
        c = lower(node.child, tables, agg_capacity, fallback, memo)
        desc = node.descending or (False,) * len(node.keys)
        cols, valid = kernels.sort_rows(c.cols, c.valid, list(node.keys),
                                        desc)
        return Lowered(cols, valid, c.overflow, c.escape)

    if isinstance(node, Compact):
        c = lower(node.child, tables, agg_capacity, fallback, memo)
        cols, valid, ovf = kernels.compact(c.cols, c.valid, node.out_capacity)
        return Lowered(cols, valid, kernels.any_flag(c.overflow, ovf),
                       c.escape)

    if isinstance(node, FusedJoinAggregate):
        return _lower_fused(node, tables, agg_capacity, fallback, memo)

    if isinstance(node, FusedLookupAggregate):
        return _lower_lookup_agg(node, tables, agg_capacity, fallback, memo)

    raise NotImplementedError(f"plan node {type(node).__name__} is not ported")


def _fused_clean_aggs(node: FusedJoinAggregate) -> list:
    """The aggregate list the clean (unique-build-key) fused pass executes:
    ``wmin:`` winner-carries lower to plain max and a secondary group key is
    carried as one more max — both functionally dependent on the unique
    join key.  Duplicate build keys escape before this can bite."""
    aggs = [(c, "max" if f.startswith("wmin:") else f, o)
            for c, f, o in node.aggs]
    if node.group_key2 is not None:
        aggs.append((node.group_key2, "max", node.group_key2))
    return aggs


@dataclass
class FusedReplay:
    """The chain between a fused pass's Join and its Aggregate in kernel
    K1's terms: ``probe_cols`` are the probe side's columns plus what a
    middle Project computed from them, ``pred`` the Join's post_filter and
    every middle Filter over those columns and the taken build columns, as
    one ``Conj`` (None when there is none), and ``aggs`` the clean pass's
    aggregates over the same names."""

    probe_cols: dict
    pred: object
    aggs: list


def _renamed(pred, names: dict):
    """The ``Conj`` ``pred``, written over the chain's current column
    names, over the replay's names (literals as they are); None when it
    reads a column the chain does not have, or is not a ``Conj``."""
    if not isinstance(pred, Conj) or any(c not in names
                                         for c in pred.columns()):
        return None
    return Conj(tuple((names[lhs], op,
                       names[rhs] if isinstance(rhs, str) else rhs)
                      for lhs, op, rhs in pred.terms))


def fused_replay(node: FusedJoinAggregate, b_cols, p_cols
                 ) -> FusedReplay | None:
    """Replay the middle chain on the probe side, or None when K1 cannot
    take it.  Filters become predicate terms; K1 reads comparison terms
    only, so a predicate that is not a ``Conj`` (a callable) sends the
    node to the unfused path on every device, as the reference fuses only
    what its kernels can evaluate.  A Project's string
    expressions are renames (resolved as ``fuse_join_aggregates`` resolves
    keys); its callables are evaluated on the probe columns alone, before
    K1, as one elementwise expression each (q6's ``__order``, which the
    reference computes in XLA, outside Pallas).  A callable that reads a
    taken build column raises KeyError there and sends the node to the
    unfused path, as the reference's ``try`` around its replay does."""
    slot_names = set(dict(node.join.take).values())
    probe = dict(p_cols)
    names = {c: c for c in p_cols}
    names.update({c: c for c in slot_names})
    preds = []
    if node.join.post_filter is not None:
        if not isinstance(node.join.post_filter, Conj):
            return None
        preds.append(node.join.post_filter)
    for nd in node.middle:
        if isinstance(nd, Filter):
            pred = _renamed(nd.pred, names)
            if pred is None:
                return None
            preds.append(pred)
            continue
        new = {}
        for out, e in nd.exprs:
            if isinstance(e, str):
                if e not in names:
                    return None
                new[out] = names[e]
                continue
            view = {n: probe[b] for n, b in names.items()
                    if b in probe and b not in slot_names}
            try:
                col = e(view)
            except KeyError:
                return None
            base, i = out, 0
            while base in probe or base in slot_names:
                i += 1
                base = f"{out}__{i}"
            probe[base] = col
            new[out] = base
        names = new
    aggs = []
    for c, fn, o in _fused_clean_aggs(node):
        if c is not None and c not in names:
            return None
        aggs.append((None if c is None else names[c], fn, o))
    pred = Conj(tuple(t for p in preds for t in p.terms)) if preds else None
    return FusedReplay(probe, pred, aggs)


def fused_supported(node: FusedJoinAggregate, b_cols,
                    replay: FusedReplay | None) -> bool:
    """Static pre-check: a chain K1 can replay (``fused_replay``),
    aggregating int32 columns or an int64 probe column under max that
    nothing compares (the wrapper's own rule, ``unsupported_aggs``), within
    the kernel's static limits (``fits_kernel``, the rule its codes apply);
    anything else takes the unfused path, on every device."""
    if replay is None:
        return False
    slots = {dst: b_cols[src] for src, dst in node.join.take}
    if unsupported_aggs(slots, replay.probe_cols, replay.pred, replay.aggs):
        return False
    terms = () if replay.pred is None else replay.pred.terms
    return fits_kernel(tuple(slots),
                       wide_cols(slots, replay.probe_cols, replay.aggs),
                       tuple(terms), replay.aggs)


def fused_local_pass(node: FusedJoinAggregate, b_cols, b_valid, p_cols,
                     p_valid, replay: FusedReplay):
    """The fused join + filter + aggregate core over already-lowered sides:
    build slotting (K2: max of the taken columns and the duplicate-key
    flag), then the fused probe pass (K1) over the replayed chain
    (``fused_replay`` of the same sides).  Returns (out_cols, valid,
    slot_overflow, escape).  K1 counts only pairs on present slots, so its
    out_valid already lies within ``present``."""
    jn = node.join
    span = b_valid.shape[0] + CONFIG.join_span_margin
    take = dict(jn.take)
    slot_aggs = [(src, "max", src) for src in take] \
        + [(None, "dups", "__dups")]
    slots, present, ovf_b, esc_b = kernels.dense_group_aggregate(
        {jn.build_key: b_cols[jn.build_key], **{s: b_cols[s] for s in take}},
        b_valid, jn.build_key, slot_aggs, span)
    # duplicate build keys invalidate the max-collapsed slots and the
    # functional dependencies of the clean pass: escape to the fallback
    has_dups = slots.pop("__dups")
    m = slots[jn.build_key][0]
    slot_cols = {dst: slots[src] for src, dst in take.items()}
    out, ovalid, esc = join_aggregate(
        slot_cols, present, m, replay.probe_cols, p_valid, jn.probe_key,
        replay.pred, replay.aggs)
    out[node.group_key] = out.pop("__key")
    return out, ovalid, ovf_b, kernels.any_flag(esc, esc_b, has_dups)


def _lower_fused(node: FusedJoinAggregate, tables, agg_capacity,
                 fallback: bool, memo: dict) -> Lowered:
    jn = node.join
    b = lower(jn.build, tables, agg_capacity, fallback, memo)
    p = lower(jn.probe, tables, agg_capacity, fallback, memo)
    replay = None if fallback else fused_replay(node, b.cols, p.cols)
    if not fused_supported(node, b.cols, replay):
        # the original Aggregate(...(Join)) subtree, sized to the fused span
        # (rows are (key, value) pairs either way — slot alignment differs,
        # semantics don't)
        span = b.valid.shape[0] + CONFIG.join_span_margin
        fb_node = dataclasses.replace(node.fallback, out_capacity=span)
        return lower(fb_node, tables, span, fallback, memo)
    out, valid, ovf_b, esc = fused_local_pass(
        node, b.cols, b.valid, p.cols, p.valid, replay)
    return Lowered(out, valid, kernels.any_flag(b.overflow, p.overflow),
                   kernels.any_flag(b.escape, p.escape, esc, ovf_b))


def _lower_lookup_agg(node: FusedLookupAggregate, tables, agg_capacity,
                      fallback: bool, memo: dict) -> Lowered:
    """K4 over the lowered build and probe Scan: the build slotted on K2
    (max of the taken column and the duplicate flag), as the unique
    join's ``lookup_join`` slots it, then the probe pass.  The node's
    ``fallback`` lowers instead on the escape rerun, and wherever K4 cannot
    take the node: a key, the taken column or a compared column that is
    not int32, or the kernel's static limits (``lookup_agg.fits``) — a
    rule of the plan's shapes, so every device lowers alike.  Each lowering
    that takes K4 counts in ``lower.lookup_agg``."""
    jn = node.join
    cap = node.out_capacity or agg_capacity
    if not fallback:
        b = lower(jn.build, tables, agg_capacity, fallback, memo)
        p = lower(jn.probe, tables, agg_capacity, fallback, memo)
        cap = cap or p.valid.shape[0]
        names = [] if node.pred is None else node.pred.columns()
        if lookup_agg.fits(cap, node.pred) and all(
                t.dtype == torch.int32 for t in (
                    b.cols[jn.build_key], b.cols[node.taken],
                    p.cols[jn.probe_key], *(p.cols[c] for c in names))):
            span = b.valid.shape[0] + CONFIG.join_span_margin
            slots, present, ovf_b, esc_b = kernels.dense_group_aggregate(
                {jn.build_key: b.cols[jn.build_key],
                 node.taken: b.cols[node.taken]},
                b.valid, jn.build_key,
                [(node.taken, "max", node.taken), (None, "dups", "__dups")],
                span)
            has_dups = slots.pop("__dups")
            cnt, key, valid, esc = lookup_aggregate(
                slots[node.taken], present, slots[jn.build_key][0],
                p.cols[jn.probe_key], p.valid, {c: p.cols[c] for c in names},
                node.pred, cap)
            METRICS.count("lower.lookup_agg")
            cols = {name: cnt for _, _, name in node.aggs}
            cols[node.group_key] = key
            return Lowered(cols, valid,
                           kernels.any_flag(b.overflow, p.overflow, ovf_b,
                                            has_dups),
                           kernels.any_flag(b.escape, p.escape, esc_b, esc))
    return lower(node.fallback, tables, agg_capacity, fallback, memo)


def compile_plan(root: Node, agg_capacity: int | None = None):
    """Plan → ``fn(tables, fallback=False) -> (Batch, overflow, escape)``,
    the flags as 0-d bool tensors on the batches' device."""
    root = fuse_join_aggregates(root)

    def fn(tables: dict[str, Batch], fallback: bool = False):
        out = lower(root, tables, agg_capacity, fallback)
        return Batch(columns=out.cols, valid=out.valid), out.overflow, out.escape

    return fn


def walk(root: Node):
    """Post-order traversal (planner utility)."""
    seen = []

    def rec(n):
        for i in n.inputs():
            rec(i)
        seen.append(n)

    rec(root)
    return seen


def referenced_columns(root: Node) -> set[str] | None:
    """Over-approximate the set of column names a plan reads, or None when
    it is not statically determinable (the reference's rule, kept so that
    both engines stage the same columns: any Filter, post-filter or
    callable expression gives None, a ``Conj`` included).  Drivers project
    input tables down to these columns before staging them; the set may
    hold non-scan names (aggregate outputs, aliases), which callers
    intersect with the table's columns."""
    cols: set[str] = set()
    for n in walk(root):
        if isinstance(n, Filter):
            return None
        if isinstance(n, Project):
            for _, e in n.exprs:
                if not isinstance(e, str):
                    return None
                cols.add(e)
        elif isinstance(n, Aggregate):
            cols.update(n.group_keys)
            cols.update(c for c, _, _ in n.aggs if c is not None)
            cols.update(f[5:] for _, f, _ in n.aggs if f.startswith("wmin:"))
        elif isinstance(n, Join):
            if n.post_filter is not None:
                return None
            cols.update((n.build_key, n.probe_key))
            cols.update(src for src, _ in n.take)
        elif isinstance(n, Rank):
            cols.update((n.group_key, n.order_col))
            if n.tiebreak:
                cols.add(n.tiebreak)
        elif isinstance(n, Sort):
            cols.update(n.keys)
        elif isinstance(n, (FusedJoinAggregate, FusedLookupAggregate)):
            return None  # pre-fusion plans only; fusion happens at compile
    return cols


def fuse_join_aggregates(node: Node) -> Node:
    """Rewrite Aggregate(…Filter/Project…(Join)) patterns into
    FusedJoinAggregate when the group key is the join key, and
    Aggregate(…Project…(Join(build, Filter…(Scan)))) into
    FusedLookupAggregate when its counts group by one taken column of a
    unique build (``_lookup_aggregate``)."""

    def resolve(chain, k):
        """Map a column name top-down through the Project chain, or None."""
        for nd in chain:
            if isinstance(nd, Project):
                src = dict(nd.exprs).get(k)
                if not isinstance(src, str):
                    return None
                k = src
        return k

    # a subtree the plan shares stays one object after the rewrite, so
    # lower() meets it once (entries hold the node: no id is reused)
    done: dict[int, tuple] = {}

    def rewrite(n: Node) -> Node:
        if id(n) not in done:
            done[id(n)] = (n, _rewrite(n))
        return done[id(n)][1]

    def _rewrite(n: Node) -> Node:
        if isinstance(n, Aggregate) and len(n.group_keys) in (1, 2):
            chain = []
            cur = n.child
            while isinstance(cur, (Filter, Project)):
                chain.append(cur)
                cur = cur.child
            if isinstance(cur, Join):
                take_outs = set(dict(cur.take).values())
                key = n.group_keys[0]
                k = resolve(chain, key)
                int_aggs = all(fn in ("count", "count_sum", "sum", "min",
                                      "max") or fn.startswith("wmin:")
                               for _, fn, _ in n.aggs)
                # wmin winner-carries and a secondary group key lower to max
                # in the clean pass: valid only for taken build columns
                wmin_ok = all(resolve(chain, c) in take_outs
                              for c, fn, _ in n.aggs
                              if fn.startswith("wmin:"))
                key2 = n.group_keys[1] if len(n.group_keys) == 2 else None
                key2_ok = key2 is None or resolve(chain, key2) in take_outs
                if k in (cur.probe_key, cur.build_key) and int_aggs \
                        and wmin_ok and key2_ok:
                    join = dataclasses.replace(
                        cur, build=rewrite(cur.build),
                        probe=rewrite(cur.probe))
                    return FusedJoinAggregate(
                        join=join, middle=tuple(reversed(chain)),
                        group_key=key, aggs=n.aggs, fallback=n,
                        out_capacity=n.out_capacity, group_key2=key2)
            fused = _lookup_aggregate(n, chain, cur,
                                      resolve(chain, n.group_keys[0]))
            if fused is not None:
                return dataclasses.replace(
                    fused, join=dataclasses.replace(
                        fused.join, build=rewrite(fused.join.build)))
        if isinstance(n, (Aggregate, Filter, Project, Rank, Sort, Compact)):
            return dataclasses.replace(n, child=rewrite(n.child))
        if isinstance(n, Join):
            return dataclasses.replace(n, build=rewrite(n.build),
                                       probe=rewrite(n.probe))
        return n

    return rewrite(node)


def _lookup_aggregate(agg: Aggregate, chain: list, join: Node,
                      key_src: str | None) -> FusedLookupAggregate | None:
    """``agg`` as a FusedLookupAggregate, or None where it is not one: its
    aggregates all ``count``, ``chain`` (the nodes between it and
    ``join``) renaming Projects only, its one group key resolved through
    them (``key_src``) to a column that ``join`` takes from its build
    side, ``join`` a ``unique_build`` Join without a post-filter whose
    probe side is Filters with ``Conj`` predicates over a Scan.  Dtypes
    are the lowering's to check (``_lower_lookup_agg``)."""
    if not (isinstance(join, Join) and join.unique_build
            and join.post_filter is None and len(agg.group_keys) == 1
            and all(fn == "count" for _, fn, _ in agg.aggs)
            and all(isinstance(nd, Project) for nd in chain)):
        return None
    taken = {dst: src for src, dst in join.take}.get(key_src)
    probe, terms = join.probe, []
    while isinstance(probe, Filter) and isinstance(probe.pred, Conj):
        terms += probe.pred.terms
        probe = probe.child
    if taken is None or not isinstance(probe, Scan):
        return None
    return FusedLookupAggregate(
        join=dataclasses.replace(join, probe=probe), taken=taken,
        group_key=agg.group_keys[0], aggs=agg.aggs,
        pred=Conj(tuple(terms)) if terms else None, fallback=agg,
        out_capacity=agg.out_capacity)

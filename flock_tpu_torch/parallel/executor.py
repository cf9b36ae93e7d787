"""The sharded executor — the counterpart of ``flock_tpu/parallel/executor.py``.

Reference counterpart: Flock's distributed mode, a DAG of query stages each
deployed as N Lambda instances exchanging payloads.  The reference compiles
the staged DAG into one SPMD program per window; here every node lowers
shard-major: it takes and returns one ``Lowered`` (columns, valid,
overflow, escape) per local shard of a mesh (``parallel/mesh.py``), the
stage boundaries are the collectives of ``parallel/shuffle.py``, and every
shard runs the port's local operators, so kernels K1, K2 and K3 launch on
each shard's tensors.

Lowering rules (the reference's, the DistributedPlanner analogue):
* Scan/Filter/Project/Compact — purely local;
* Aggregate — a local partial → all-to-all by hash(group keys) → a local
  final over ``_final_aggs`` (count partials re-aggregate as count_sum);
* Join — the build side broadcast (all-gather), probed locally;
* Rank — all-to-all by the partition key, then a local rank;
* Sort — coalesced to shard 0 at or below ``_SMALL_SORT_ROWS`` rows or for
  keys ``_composite_sort_key`` cannot route, else range-partitioned by 64
  samples per shard;
* FusedJoinAggregate — a broadcast build, the fused partial (K2 slotting,
  K1) per shard, then the shuffle and the final.

Where the reference picks each shard's unfused branch on the device
(``lax.cond``), the executor reads every shard's overflow and escape flags
in one host sync per window, as ``LocalExecutor`` does; on an escape it
lowers the window again with ``fallback=True`` (every fused node on its
unfused branch, every duplicate-faithful join fanned out, no int64 rebase)
and counts it in ``fallback_runs``; a window that escaped lowers each later
widen attempt on the fallback at once.  The rows are the same.  The final
of a two-phase aggregate over one integer key takes int64 partials exactly
on K2 on either lowering (``_final_aggregate``: sums by their 31-bit
halves, min/max by their high words, then their low words among the rows
that attain them), where the reference's rebase would escape to a scatter
on wide ranges.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from flock_tpu_torch.batch import Batch, round_up
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.parallel.mesh import Mesh, make_mesh
from flock_tpu_torch.parallel.shuffle import (all_gather, all_to_all_by_dest,
                                              all_to_all_shuffle,
                                              broadcast_gather)
from flock_tpu_torch.plan import (Aggregate, Compact, Filter,
                                  FusedJoinAggregate, Join, Lowered, Node,
                                  Project, Rank, Scan, Sort,
                                  dup_expand_capacity, fuse_join_aggregates,
                                  fused_local_pass, fused_replay,
                                  fused_supported)
from flock_tpu_torch.queries.nexmark import QuerySpec
from flock_tpu_torch.runtime import stream as runtime_stream
from flock_tpu_torch.runtime.executor import OverflowError, agg_capacity_for
from flock_tpu_torch.utils.metrics import METRICS


@dataclass
class _Ctx:
    mesh: Mesh
    agg_capacity: int

    @property
    def n_shards(self) -> int:
        return self.mesh.n_shards


_SMALL_SORT_ROWS = 1 << 16  # below this, gather-everything beats a shuffle
_SAMPLES = 64               # range-partition samples per shard
_I64_MAX = 2**63 - 1


def _per_dest(cap: int, n: int) -> int:
    """Per-destination bucket rows: 4× the average, at least 2048, at most
    the input capacity (post-shuffle work shrinks with the shard count;
    the overflow flag guards the bound)."""
    return min(cap, max(4 * (cap // n), 2048))


def _composite_sort_key(cols, keys, desc):
    """Monotone int64 routing key for a ≤2-key integer sort, or None when
    inexpressible (floats, >2 keys).  It only routes rows between shards —
    the local order always uses the real multi-key sort — so it needs
    a ≤ b ⟹ comp(a) ≤ comp(b), not strictness."""
    if len(keys) > 2 or any(cols[k].is_floating_point() for k in keys):
        return None

    def adj(name, d):
        k = cols[name].to(torch.int64).clamp(-(1 << 31) + 1, (1 << 31) - 1)
        return -k if d else k

    if len(keys) == 1:
        k = cols[keys[0]].to(torch.int64)
        return -k if desc[0] else k
    return (adj(keys[0], desc[0]) << 32) \
        | ((adj(keys[1], desc[1]) + (1 << 31)) & 0xFFFFFFFF)


def _final_aggs(aggs, clean: bool = False):
    """The final's aggregates over the partial's outputs: count partials
    re-aggregate with an int32 sum (count_sum); the rest keep their
    function.  ``clean`` (a run with unique build keys: duplicates escape
    first) takes a ``wmin:`` carry as the plain max the clean fused pass
    computed it as."""
    out = []
    for _, fn, name in aggs:
        fn = {"count": "count_sum"}.get(fn, fn)
        if clean and fn.startswith("wmin:"):
            fn = "max"
        out.append((name, fn, name))
    return tuple(out)


def _final_aggregate(cols, valid, keys, aggs, cap):
    """The final of a two-phase aggregate, on either lowering.  Over one
    integer key int64 partials go to K2 exactly, with no range escape: a
    sum by its low 31 bits and the rest (each summed in int64 and
    recombined), a min/max by its high 32-bit word, then by its low word
    (unsigned order) over the rows whose high word attains the slot's —
    one more K2 per such column, slotted alike (every slot keeps a row that
    attains it).  A ``wmin:`` carry (a fallback lowering's, which K2 does
    not compute) scatters onto the same slots (``scatter_aggs``, as the
    reference's scatter does).  Any other key is ``group_aggregate``'s."""
    if len(keys) != 1 or cols[keys[0]].is_floating_point():
        return kernels.group_aggregate(cols, valid, list(keys), list(aggs),
                                       cap)
    key = keys[0]
    k2_cols, k2_aggs, wide, halves, carries = {key: cols[key]}, [], [], [], []
    for c, fn, out in aggs:
        v = cols[c] if c is not None else None
        if fn.startswith("wmin:"):
            carries.append((c, fn, out))
        elif v is not None and v.dtype == torch.int64 and fn == "sum":
            lo, hi = f"{out}__lo", f"{out}__hi"
            k2_cols[lo] = (v & 0x7FFFFFFF).to(torch.int32)
            k2_cols[hi] = (v >> 31).to(torch.int32)
            k2_aggs += [(lo, "sum", lo), (hi, "sum", hi)]
            halves.append((out, lo, hi))
        elif v is not None and v.dtype == torch.int64 and fn in ("min", "max"):
            hi = f"{out}__hi"
            k2_cols[hi] = (v >> 32).to(torch.int32)
            k2_aggs.append((hi, fn, hi))
            wide.append((c, fn, out, hi))
        else:
            if c is not None:
                k2_cols[c] = v
            k2_aggs.append((c, fn, out))
    res, ovalid, ovf, esc = kernels.dense_group_aggregate(
        k2_cols, valid, key, k2_aggs, cap)
    for out, lo, hi in halves:
        res[out] = (res.pop(hi) << 31) + res.pop(lo)
    if wide or carries:
        # each row's slot in the output (slot i holds key m + i)
        rel = cols[key].to(torch.int64) - res[key][0].to(torch.int64)
        slot = rel.clamp(0, cap - 1)
    for c, fn, out, hi in wide:
        v = cols[c]
        top = res.pop(hi)
        attain = valid & (k2_cols[hi] == top[slot])
        low = ((v & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
        r2, _, o2, e2 = kernels.dense_group_aggregate(
            {key: cols[key], "__lo": low}, attain, key,
            [("__lo", fn, "__lo")], cap)
        res[out] = (top.to(torch.int64) << 32) \
            + (r2["__lo"].to(torch.int64) + (1 << 31))
        ovf, esc = kernels.any_flag(ovf, o2), kernels.any_flag(esc, e2)
    if carries:
        # the carry's order column is a max partial of the same final,
        # read at its input (a partial's max keeps its input name)
        seg = torch.where(valid & (rel >= 0) & (rel < cap), rel, cap)
        res.update(kernels.scatter_aggs(seg, valid, cols, carries, cap))
    return res, ovalid, ovf, esc


def _expand_cap(n_probe: int, node) -> int | None:
    """Fan-out headroom for duplicate build keys (``dup_expand_capacity``)."""
    if node.unique_build:
        return None
    return dup_expand_capacity(n_probe)


def _flags(*lowered: Lowered):
    return (kernels.any_flag(*[x.overflow for x in lowered]),
            kernels.any_flag(*[x.escape for x in lowered]))


def lower_dist(node: Node, tables: list[dict], ctx: _Ctx,
               fallback: bool = False, memo: dict | None = None
               ) -> list[Lowered]:
    """Lower a plan node over every local shard: ``tables[i]`` holds local
    shard i's relations as Batches; returns one ``Lowered`` per local
    shard.  A subtree the plan reaches twice is lowered once per ``memo``
    (q5's per-auction counts), as ``plan.lower`` does."""
    memo = {} if memo is None else memo
    if id(node) not in memo:
        memo[id(node)] = (node, _lower_dist(node, tables, ctx, fallback,
                                            memo))
    return memo[id(node)][1]


def _lower_dist(node, tables, ctx: _Ctx, fallback: bool, memo: dict):
    mesh, n = ctx.mesh, ctx.n_shards

    def child(nd):
        return lower_dist(nd, tables, ctx, fallback, memo)

    if isinstance(node, Scan):
        out = []
        for t in tables:
            b = t[node.relation]
            f = kernels.false_flag(b.valid.device)
            out.append(Lowered(dict(b.columns), b.valid, f, f))
        return out

    if isinstance(node, Filter):
        return [Lowered(c.cols, c.valid & node.pred(c.cols), c.overflow,
                        c.escape) for c in child(node.child)]

    if isinstance(node, Project):
        return [Lowered({name: c.cols[e] if isinstance(e, str) else e(c.cols)
                         for name, e in node.exprs},
                        c.valid, c.overflow, c.escape)
                for c in child(node.child)]

    if isinstance(node, Aggregate):
        cs = child(node.child)
        cap = node.out_capacity or ctx.agg_capacity
        keys = list(node.group_keys)
        parts = [kernels.group_aggregate(c.cols, c.valid, keys,
                                         list(node.aggs), cap,
                                         rebase=not fallback) for c in cs]
        # post-partial rows are ≤ one per (producer, key), so the buckets
        # shrink with the shard count
        scols, svalid, o2 = all_to_all_shuffle(
            mesh, [p[0] for p in parts], [p[1] for p in parts], keys,
            per_dest_cap=_per_dest(cap, n))
        out = []
        for c, p, sc, sv, o in zip(cs, parts, scols, svalid, o2):
            fcols, fvalid, o3, e3 = _final_aggregate(
                sc, sv, keys, _final_aggs(node.aggs), cap)
            out.append(Lowered(
                fcols, fvalid, kernels.any_flag(c.overflow, p[2], o, o3),
                kernels.any_flag(c.escape, p[3], e3)))
        return out

    if isinstance(node, Join):
        bs = child(node.build)
        gcols, gvalid = broadcast_gather(mesh, [b.cols for b in bs],
                                         [b.valid for b in bs])
        ps = child(node.probe)
        out = []
        for b, p, gc, gv in zip(bs, ps, gcols, gvalid):
            if gc[node.build_key].is_floating_point() \
                    or p.cols[node.probe_key].is_floating_point():
                cols, valid = kernels.sorted_lookup_join(
                    gc, gv, node.build_key, p.cols, p.valid, node.probe_key,
                    dict(node.take))
                ovf = esc = kernels.false_flag(valid.device)
            else:
                cols, valid, ovf, esc = kernels.lookup_join(
                    gc, gv, node.build_key, p.cols, p.valid, node.probe_key,
                    dict(node.take),
                    out_capacity=_expand_cap(p.valid.shape[0], node),
                    dup_expand=not node.unique_build, fallback=fallback)
            if node.post_filter is not None:
                valid = valid & node.post_filter(cols)
            o, e = _flags(b, p)
            out.append(Lowered(cols, valid, kernels.any_flag(o, ovf),
                               kernels.any_flag(e, esc)))
        return out

    if isinstance(node, Rank):
        cs = child(node.child)
        cap = cs[0].valid.shape[0]
        scols, svalid, o2 = all_to_all_shuffle(
            mesh, [c.cols for c in cs], [c.valid for c in cs],
            [node.group_key], per_dest_cap=_per_dest(cap, n))
        out = []
        for c, sc, sv, o in zip(cs, scols, svalid, o2):
            rcols, rvalid = kernels.rank_in_group(
                sc, sv, node.group_key, node.order_col, node.descending,
                node.rank_name, node.tiebreak)
            out.append(Lowered(rcols, rvalid, kernels.any_flag(c.overflow, o),
                               c.escape))
        return out

    if isinstance(node, Sort):
        return _lower_sort(node, child(node.child), ctx)

    if isinstance(node, Compact):
        out = []
        for c in child(node.child):
            cols, valid, ovf = kernels.compact(c.cols, c.valid,
                                               node.out_capacity)
            out.append(Lowered(cols, valid, kernels.any_flag(c.overflow, ovf),
                               c.escape))
        return out

    if isinstance(node, FusedJoinAggregate):
        return _lower_fused_dist(node, tables, ctx, fallback, memo)

    raise TypeError(f"unsupported distributed node {type(node)}")


def _lower_sort(node: Sort, cs: list[Lowered], ctx: _Ctx) -> list[Lowered]:
    mesh, n = ctx.mesh, ctx.n_shards
    keys = list(node.keys)
    desc = node.descending or (False,) * len(keys)
    cap = cs[0].valid.shape[0]
    if cap * n <= _SMALL_SORT_ROWS \
            or _composite_sort_key(cs[0].cols, keys, desc) is None:
        # coalesce to one partition (DataFusion SortExec semantics): every
        # shard's rows gathered, sorted on shard 0; the other shards keep
        # no row
        gcols, gvalid = broadcast_gather(mesh, [c.cols for c in cs],
                                         [c.valid for c in cs])
        out = []
        for i, (c, gc, gv) in enumerate(zip(cs, gcols, gvalid)):
            if mesh.local_shards[i] == 0:
                gc, gv = kernels.sort_rows(gc, gv, keys, desc)
            else:
                gv = torch.zeros_like(gv)
            out.append(Lowered(gc, gv, c.overflow, c.escape))
        return out
    # sampled range partition: each shard's sorted routing keys sampled,
    # the samples gathered into global splitters, rows routed by key range,
    # then sorted locally — shard i owns the i-th key range, so the
    # shard-major output is globally ordered
    routed, samples = [], []
    for c in cs:
        comp = torch.where(c.valid,
                           _composite_sort_key(c.cols, keys, desc), _I64_MAX)
        scomp, order = torch.sort(comp, stable=True)
        svalid = c.valid[order]
        n_valid = svalid.sum()
        pos = (torch.arange(_SAMPLES, device=comp.device) * n_valid) \
            // _SAMPLES
        samples.append(torch.where(n_valid > 0, scomp[pos], _I64_MAX))
        routed.append(({nm: v[order] for nm, v in c.cols.items()}, svalid,
                       scomp))
    allsamp = all_gather(mesh, samples)
    dests = []
    for (sc, sv, scomp), a in zip(routed, allsamp):
        splitters = torch.sort(a).values[
            _SAMPLES * torch.arange(1, n, device=a.device)]
        dests.append(torch.searchsorted(splitters, scomp, right=True)
                     .to(torch.int32))
    rcols, rvalid, o2 = all_to_all_by_dest(
        mesh, [r[0] for r in routed], [r[1] for r in routed], dests,
        _per_dest(cap, n))
    out = []
    for c, rc, rv, o in zip(cs, rcols, rvalid, o2):
        fcols, fvalid = kernels.sort_rows(rc, rv, keys, desc)
        out.append(Lowered(fcols, fvalid, kernels.any_flag(c.overflow, o),
                           c.escape))
    return out


def _lower_fused_dist(node: FusedJoinAggregate, tables, ctx: _Ctx,
                      fallback: bool, memo: dict) -> list[Lowered]:
    """The broadcast build, the fused pass per shard as a PARTIAL (K2
    build slotting, K1), then the shuffle and the final — the two-phase
    split of a plain Aggregate.  ``fallback`` runs the reference's escape
    branch on every shard: the unfused join (fanned out) and the scatter
    partial at the fused span."""
    mesh, n = ctx.mesh, ctx.n_shards
    jn = node.join
    bs = lower_dist(jn.build, tables, ctx, fallback, memo)
    ps = lower_dist(jn.probe, tables, ctx, fallback, memo)
    # each shard replays the middle chain on its own probe columns
    replays = [None if fallback else fused_replay(node, b.cols, p.cols)
               for b, p in zip(bs, ps)]
    if not fallback and not fused_supported(node, bs[0].cols, replays[0]):
        return lower_dist(node.fallback, tables, ctx, fallback, memo)
    gcols, gvalid = broadcast_gather(mesh, [b.cols for b in bs],
                                     [b.valid for b in bs])
    span = gvalid[0].shape[0] + CONFIG.join_span_margin
    gkeys = [node.group_key] + ([node.group_key2] if node.group_key2 else [])
    outs, valids, ovfs, escs = [], [], [], []
    for b, p, gc, gv, replay in zip(bs, ps, gcols, gvalid, replays):
        o, e = _flags(b, p)
        if not fallback:
            out, valid, ovf_b, esc = fused_local_pass(
                node, gc, gv, p.cols, p.valid, replay)
            e = kernels.any_flag(e, esc, ovf_b)
        else:
            cols, valid, jo, je = kernels.lookup_join(
                gc, gv, jn.build_key, p.cols, p.valid, jn.probe_key,
                dict(jn.take), out_capacity=_expand_cap(p.valid.shape[0], jn),
                dup_expand=not jn.unique_build, fallback=True)
            if jn.post_filter is not None:
                valid = valid & jn.post_filter(cols)
            for nd in node.middle:
                if isinstance(nd, Filter):
                    valid = valid & nd.pred(cols)
                else:
                    cols = {nm: cols[ex] if isinstance(ex, str) else ex(cols)
                            for nm, ex in nd.exprs}
            out, valid, o5, e5 = kernels.group_aggregate(
                cols, valid, gkeys, list(node.aggs), span, rebase=False)
            o = kernels.any_flag(o, jo, o5)
            e = kernels.any_flag(e, je, e5)
        outs.append(out)
        valids.append(valid)
        ovfs.append(o)
        escs.append(e)
    scols, svalid, o3 = all_to_all_shuffle(
        mesh, outs, valids, gkeys, per_dest_cap=_per_dest(span, n))
    res = []
    for sc, sv, o, o3_i, e in zip(scols, svalid, ovfs, o3, escs):
        fcols, fvalid, o4, e4 = _final_aggregate(
            sc, sv, gkeys, _final_aggs(node.aggs, clean=not fallback), span)
        res.append(Lowered(fcols, fvalid, kernels.any_flag(o, o3_i, o4),
                           kernels.any_flag(e, e4)))
    return res


@dataclass
class DistributedExecutor:
    """Executes a QuerySpec plan over an n-shard mesh (``make_mesh(n_shards,
    device)`` unless ``mesh`` is given; ``device=None`` means the card and
    raises without CUDA).  ``fallback_runs`` counts escape reruns,
    ``host_syncs`` the host's reads of the windows' flags."""

    spec: QuerySpec
    n_shards: int
    mesh: Mesh | None = None
    agg_capacity: int | None = None
    device: object = None
    fallback_runs: int = 0
    host_syncs: int = 0
    plan: Node = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_mesh(self.n_shards, self.device)
        if self.mesh.n_shards != self.n_shards:
            raise ValueError(f"a mesh of {self.mesh.n_shards} shards for "
                             f"{self.n_shards}")
        self.device = self.mesh.device
        self.plan = fuse_join_aggregates(self.spec.plan)

    def capacities(self, shard_tables: list[dict],
                   capacities: dict[str, int] | None = None,
                   widen: int = 1) -> dict[str, int]:
        """Per-relation shard capacity: the largest local shard's rows
        rounded up (at least 128; agreed over every process of the mesh),
        or ``capacities[rel]``, times ``widen``."""
        capacities = capacities or {}
        rels = sorted({r for st in shard_tables for r in st})
        rows = [max((len(next(iter(st[rel].values())))
                     for st in shard_tables if st.get(rel)), default=1)
                for rel in rels]
        if self.mesh.group is not None:
            t = torch.tensor(rows, dtype=torch.int64, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
            rows = t.tolist()
        return {rel: (capacities.get(rel) or max(round_up(max(m, 1)), 128))
                * widen for rel, m in zip(rels, rows)}

    def stage(self, shard_tables: list[dict], caps: dict[str, int]
              ) -> list[dict[str, Batch]]:
        """Each local shard's host relations → Batches at ``caps`` on its
        device (a relation a shard lacks is staged empty, with the columns
        and dtypes the other shards give it)."""
        if len(shard_tables) != len(self.mesh.local_shards):
            raise ValueError(f"{len(shard_tables)} shard tables for "
                             f"{len(self.mesh.local_shards)} local shards")
        like = {}
        for st in shard_tables:
            for rel, cols in st.items():
                like.setdefault(rel, {}).update(
                    {nm: v[:0] for nm, v in cols.items()})
        return [{rel: Batch.from_numpy(
                    {nm: (st.get(rel) or {}).get(nm, empty)
                     for nm, empty in sorted(like[rel].items())}, cap, dev)
                 for rel, cap in caps.items()}
                for st, dev in zip(shard_tables, self.mesh.devices)]

    def execute_staged(self, staged: list[dict[str, Batch]],
                       agg_capacity: int | None = None,
                       fallback: bool = False) -> list[Batch]:
        """Run the plan over staged shard inputs: one output Batch per
        local shard.  Every shard's flags are read in one host sync; an
        escape reruns the window with ``fallback=True``, and ``fallback``
        (a window that escaped before) lowers it so at once.  Every
        fallback lowering counts in ``fallback_runs``.  Raises
        OverflowError when a static capacity was exceeded."""
        if agg_capacity is None:
            agg_capacity = self.agg_capacity or agg_capacity_for(
                b.capacity for st in staged for b in st.values())
        q = f"q{self.spec.number}"
        METRICS.count(f"{q}.dist_windows")
        with METRICS.timer(f"{q}.dist_execute_s"):
            if not fallback:
                outs = self._lower(staged, agg_capacity, False)
                overflow, fallback = self._read_flags(outs)
            if fallback:
                self.fallback_runs += 1
                outs = self._lower(staged, agg_capacity, True)
                overflow, _ = self._read_flags(outs)
        if overflow:
            raise OverflowError(f"q{self.spec.number} distributed overflow "
                                f"(agg={agg_capacity})")
        return [Batch(o.cols, o.valid) for o in outs]

    def _lower(self, staged, agg_capacity: int, fallback: bool):
        return lower_dist(self.plan, staged, _Ctx(self.mesh, agg_capacity),
                          fallback)

    def _read_flags(self, outs: list[Lowered]) -> tuple[bool, bool]:
        """(overflow, escape) over every shard of the mesh: one host read."""
        dev = self.device
        f = torch.stack([torch.stack([o.overflow.to(dev), o.escape.to(dev)])
                         for o in outs]).any(0)
        if self.mesh.group is not None:
            f = f.to(torch.int32)
            dist.all_reduce(f, op=dist.ReduceOp.MAX, group=self.mesh.group)
        self.host_syncs += 1
        overflow, escape = f.tolist()
        return bool(overflow), bool(escape)

    def execute_window(self, shard_tables: list[dict],
                       capacities: dict[str, int] | None = None,
                       staged: list[dict[str, Batch]] | None = None
                       ) -> dict[str, np.ndarray]:
        """Run one window.  ``shard_tables[i]`` holds local shard i's host
        columns per relation (or ``shard_tables`` is a function that makes
        them, called only when the window is staged here); ``staged``
        (from ``stage`` at ``capacities(shard_tables, capacities)``) the
        same on the shards' devices, for the first attempt.  Returns the
        host columns of every local shard's live rows, merged
        shard-major."""
        return merged_host(self.execute_widening(shard_tables, capacities,
                                                 staged), self.device)

    def execute_widening(self, shard_tables: list[dict],
                         capacities: dict[str, int] | None = None,
                         staged: list[dict[str, Batch]] | None = None
                         ) -> list[Batch]:
        """``execute_staged`` over the window's tables, staged anew at
        doubled shard capacities after each overflow (``_WIDENS`` times, as
        the single-card driver); one output Batch per local shard.  Once an
        attempt escaped, the later ones lower on the fallback at once:
        wider capacities do not remove a repeated build key."""
        fallback = False
        widens = runtime_stream._WIDENS
        for attempt in range(widens + 1):
            if staged is None or attempt:
                if callable(shard_tables):
                    shard_tables = shard_tables()
                staged = self.stage(shard_tables, self.capacities(
                    shard_tables, capacities, 2 ** attempt))
            METRICS.count(f"q{self.spec.number}.dist_bytes_in", sum(
                v.nbytes for st in staged for b in st.values()
                for v in [*b.columns.values(), b.valid]))
            runs = self.fallback_runs
            try:
                return self.execute_staged(staged, fallback=fallback)
            except OverflowError:
                if attempt == widens:
                    raise
                fallback = self.fallback_runs > runs


def merged_host(outs: list[Batch], device) -> dict[str, np.ndarray]:
    """The shards' live rows on the host, shard-major: the live rows
    gathered on ``device`` (one host read of their count), then one copy
    of them alone — the shards' outputs are mostly padding (a sharded
    aggregate's slots, a join's fan-out capacity)."""
    live = torch.cat([o.valid.to(device) for o in outs]).nonzero()[:, 0]
    cols = {nm: torch.cat([o.columns[nm].to(device) for o in outs])[live]
            for nm in outs[0].columns}
    return Batch(cols, torch.ones(live.shape[0], dtype=torch.bool,
                                  device=device)).to_numpy()

"""Distributed stream driver: windowed queries over a shard mesh — the
counterpart of ``flock_tpu/parallel/stream.py``.

Combines the window rules of the single-card driver (``runtime/stream.py``)
with the ``DistributedExecutor``: each window's generator partitions shard
across the mesh (partition p → shard p % n), row-count windows and session
batches shard their rows round robin, and q12's processing-time windows
carry their arrival epoch as a host column (``_run_global``).

Session windows take one of the reference's two tiers:

* the key-range device tier (``_run_session_device``, the default for plans
  ``device_session.session_fast_spec`` admits): each shard owns a disjoint
  key range of ``S_shard`` keys and runs ``device_session.step_impl`` over
  it on its own state — no collective.  Each epoch's rows go to the shard
  that owns their key; the shard's key range for the step is the host's
  range over those rows.  A key beyond the shards' ranges, or an emission
  buffer too small, restarts the run with doubled spans (``_WIDENS`` times);
  the state is updated in place, and each shard has its own.
* the generic label-table tier (``_dist_session_exec``): the host keeps
  ``SessionState``, every epoch's rows are staged round robin over the
  shards once, and an emission labels each shard's rows from the
  emission's dense tables (K3) before the plan's two-phase aggregate by
  ``__session``.
"""

from __future__ import annotations

import numpy as np
import torch

from flock_tpu_torch.batch import Batch
from flock_tpu_torch.parallel.executor import (DistributedExecutor,
                                               merged_host)
from flock_tpu_torch.plan import referenced_columns
from flock_tpu_torch.queries.nexmark import QuerySpec
from flock_tpu_torch.runtime import device_session as ds
from flock_tpu_torch.runtime import stream as runtime_stream
from flock_tpu_torch.runtime.executor import (materialize_columns,
                                              session_rows)
from flock_tpu_torch.runtime.stream import (_SPAN_LIMIT, SessionState,
                                            StreamDriver, WindowResult,
                                            _bucket_cap, widen_aggregate,
                                            window_epoch_ranges)
from flock_tpu_torch.runtime.tables import (concat_relations,
                                            default_side_input,
                                            window_relations)


def _dist_session_exec(executor: DistributedExecutor, spec: QuerySpec,
                       staged_chunks: list, cids, tables: tuple,
                       agg_cap: int) -> dict[str, np.ndarray]:
    """One emission of the generic tier: each shard labels and filters its
    resident chunk rows from the emission's dense tables (``tables`` =
    ``Emission.dense_tables``; ``session_rows``, kernel K3), then the plan
    runs shard-major (partial aggregate → all-to-all by ``__session`` →
    final).  ``staged_chunks``: one list of per-shard Batches per chunk.
    Returns the merged host columns; raises OverflowError on overflow."""
    rel = window_relations(spec.relations)[0]
    shard_tables = []
    for i in range(len(executor.mesh.devices)):
        cols, valid = session_rows([ch[i] for ch in staged_chunks],
                                   SessionState.key, tables, cids)
        shard_tables.append({rel: Batch(cols, valid)})
    outs = executor.execute_staged(shard_tables, agg_cap)
    return merged_host(outs, executor.device)


class DistStreamDriver:
    """The stream driver over an ``n_shards`` mesh (``device=None`` means
    the card and raises without CUDA); ``run`` takes per-epoch lists of
    per-generator tables (``generate_epoch_parts``)."""

    def __init__(self, spec: QuerySpec, seconds: int, n_shards: int,
                 side_input: dict | None = None, device=None, mesh=None):
        self.spec = spec
        self.seconds = seconds
        self.n_shards = n_shards
        self.side_input = side_input
        self.executor = DistributedExecutor(spec, n_shards, mesh=mesh,
                                            device=device)
        # the device session tier's last run: epoch dispatches, flag reads,
        # restarts, and the shard steps that aggregated rows (one K2 each)
        self.session_stats = None

    def _shard_tables(self, window_parts: list[list[dict]]) -> list[dict]:
        """window_parts: per-epoch lists of per-generator relation tables;
        generator p → shard p % n; q13's side input on shard 0 only (the
        broadcast join sees the union)."""
        rels = window_relations(self.spec.relations)
        shards = [[] for _ in range(self.n_shards)]
        for parts in window_parts:
            for p, part in enumerate(parts):
                shards[p % self.n_shards].append(part)
        out = []
        for i, ps in enumerate(shards):
            tables = dict(concat_relations(ps, rels))
            if "side_input" in self.spec.relations:
                si = self.side_input or default_side_input()
                tables["side_input"] = si if i == 0 else \
                    {k: v[:0] for k, v in si.items()}
            out.append(tables)
        return out

    def _windows(self, epoch_parts: list[list[dict]]) -> list[tuple]:
        """(tag, shard tables, capacities) of every range or
        processing-time window, the tables a function that makes them on
        the host: a prestaged run makes them only to widen."""
        if self.spec.window[0] == "global":
            return self._global_windows(epoch_parts)
        rels = window_relations(self.spec.relations)
        occupancy = [any(len(next(iter(p[r].values())))
                         for p in parts for r in rels if r in p and p[r])
                     for parts in epoch_parts]
        return [(tag, lambda rng=rng: self._shard_tables(
                    [epoch_parts[t] for t in rng if t < len(epoch_parts)]),
                 None)
                for tag, rng in window_epoch_ranges(self.spec, self.seconds,
                                                    occupancy)]

    def prestage(self, epoch_parts: list[list[dict]]) -> list:
        """Every window's shard inputs on the shards' devices ahead of the
        run (range and processing-time windows: each window's shard tables
        staged at their first attempt's capacities; the session device
        tier: each epoch's rows staged on the shards owning their keys at
        the first attempt's spans): what ``run(epoch_parts,
        prestaged=...)`` takes.  Row-count windows and the generic session
        tier stage their own."""
        ex = self.executor
        if self.spec.window[0] == "session":
            plan = self._session_plan(epoch_parts)
            return None if plan is None else \
                self._stage_session_epochs(plan, plan["S_shard"])
        out = []
        for _, make, caps in self._windows(epoch_parts):
            tables = make()
            out.append(ex.stage(tables, ex.capacities(tables, caps)))
        return out

    def run(self, epoch_parts: list[list[dict]],
            prestaged: list | None = None) -> list[WindowResult]:
        """Every window of the stream, in order; ``prestaged`` (from
        ``prestage``) holds the first attempt's staged inputs."""
        kind = self.spec.window[0]
        if kind == "session":
            return self._run_session(epoch_parts, prestaged)
        if kind == "rows":
            return self._run_rows(epoch_parts)
        return [WindowResult(tag, materialize_columns(
                    self.spec, self.executor.execute_window(
                        make, caps,
                        None if prestaged is None else prestaged[i])))
                for i, (tag, make, caps) in enumerate(
                    self._windows(epoch_parts))]

    def _run_rows(self, epoch_parts) -> list[WindowResult]:
        """Row-count windows: the merged stream is cut every n rows; each
        window row-shards over the mesh."""
        n = self.spec.window[1]
        (rel,) = window_relations(self.spec.relations)
        results: list[WindowResult] = []
        pending: list[dict] = []
        have = 0
        for parts in epoch_parts:
            merged = dict(concat_relations(parts, (rel,)))[rel]
            cnt = len(next(iter(merged.values()))) if merged else 0
            if not cnt:
                continue
            pending.append(merged)
            have += cnt
            while have >= n:
                joined = {k: np.concatenate([p[k] for p in pending])
                          for k in pending[0]}
                results.append(self._exec_row_sharded(
                    rel, {k: v[:n] for k, v in joined.items()},
                    ("rows", len(results))))
                have -= n
                pending = [{k: v[n:] for k, v in joined.items()}] \
                    if have else []
        if have:
            results.append(self._exec_row_sharded(
                rel, {k: np.concatenate([p[k] for p in pending])
                      for k in pending[0]}, ("rows", len(results))))
        return results

    def _merged_bids(self, parts: list[dict]) -> dict:
        """The merged driving table cut to the columns the plan (or the
        session bookkeeping) reads."""
        rel = window_relations(self.spec.relations)[0]
        bid = dict(concat_relations(parts, (rel,)))[rel]
        refs = referenced_columns(self.spec.plan)
        if refs is None:
            return bid
        keep = (refs | set(self.spec.schema.names)
                | {SessionState.key, SessionState.time_col})
        return {k: v for k, v in bid.items() if k in keep}

    def _exec_row_sharded(self, rel: str, cols: dict, tag: tuple
                          ) -> WindowResult:
        """Row-shard one batch round robin and execute it, at a
        power-of-two capacity."""
        n = len(next(iter(cols.values())))
        shard_tables = [{rel: {k: v[i::self.n_shards]
                               for k, v in cols.items()}}
                        for i in range(self.n_shards)]
        caps = {rel: _bucket_cap(-(-n // self.n_shards))}
        host = self.executor.execute_window(shard_tables, caps)
        return WindowResult(tag, materialize_columns(self.spec, host))

    # -- processing-time windows (q12) ----------------------------------------

    def _global_windows(self, epoch_parts) -> list[tuple]:
        """Processing-time windows as ``_windows`` gives them: w arrival
        epochs a window, a bid's processing time its arrival epoch in
        ms."""
        w = self.spec.window[1]
        rel = window_relations(self.spec.relations)[0]
        names = ("auction", "bidder", "price", "b_date_time", "p_time")
        results = []

        def tables(shards):
            out = []
            for ps in shards:
                cols = {}
                for k in names:
                    cols[k] = np.concatenate(
                        [np.full(len(b["bidder"]), t * 1000, np.int32)
                         if k == "p_time" else b[k] for t, b in ps]) \
                        if ps else np.array([], np.int32)
                out.append({rel: cols})
            return out

        def emit(shards, start):
            m = max([1] + [sum(len(b["bidder"]) for _, b in ps)
                           for ps in shards])
            results.append((("ptime", start, start + w),
                            lambda: tables(shards), {rel: _bucket_cap(m)}))

        shards = [[] for _ in range(self.n_shards)]
        start = 0
        for t, parts in enumerate(epoch_parts):
            if t - start >= w:
                emit(shards, start)
                shards = [[] for _ in range(self.n_shards)]
                start = t
            for p, part in enumerate(parts):
                shards[p % self.n_shards].append((t, part[rel]))
        if any(shards):
            emit(shards, start)
        return results

    # -- session windows: the generic label-table tier ------------------------

    def _stage_session_chunk(self, cols: dict) -> list[Batch]:
        """One epoch's merged rows, round robin over the shards, staged
        once on the shards' devices at a power-of-two capacity."""
        n = len(next(iter(cols.values())))
        cap = _bucket_cap(max(-(-n // self.n_shards), 1))
        return [Batch.from_numpy({k: v[i::self.n_shards]
                                  for k, v in cols.items()}, cap, dev)
                for i, dev in enumerate(self.executor.mesh.devices)]

    def _exec_session_tables(self, em, tag: tuple) -> WindowResult | None:
        """One emission from the shards' resident rows and the emission's
        dense tables; None when the tables cannot express it (sparse keys,
        unstaged chunks, a key closed twice)."""
        dt = None
        if em.merged is not None and em.chunks and \
                all(ch.staged is not None for ch in em.chunks):
            closed = em.merged[0]
            span = int(closed.max()) - int(closed.min()) + 1
            bucket = max(_bucket_cap(span + 1), 128)
            if bucket <= _SPAN_LIMIT:
                dt = em.dense_tables(bucket)
        if dt is None:
            return None
        host = widen_aggregate(lambda agg_cap: _dist_session_exec(
            self.executor, self.spec, [ch.staged for ch in em.chunks],
            [ch.cid for ch in em.chunks], dt, agg_cap),
            max(_bucket_cap(em.n_sessions), 128))
        return WindowResult(tag, materialize_columns(self.spec, host))

    def _run_session(self, epoch_parts, prestaged=None
                     ) -> list[WindowResult]:
        """Streaming session windows: the key-range device tier when the
        plan is incrementally aggregable (gap ≥ 1 s), else the generic
        label-table tier, whose emissions fall back to a host batch
        row-sharded over the mesh where the dense tables cannot express
        them."""
        gap = self.spec.window[1]
        rel = window_relations(self.spec.relations)[0]
        fs = ds.session_fast_spec(self.spec, SessionState.key, rel) \
            if gap >= 1 else None
        if fs is not None:
            return self._run_session_device(epoch_parts, prestaged)
        state = SessionState(gap=gap)
        out: list[WindowResult] = []
        sid = 0
        t = -1

        def emit(em, t):
            nonlocal sid
            r = self._exec_session_tables(em, ("sessions", t))
            if r is None:     # host batch (sparse/degenerate keys)
                b = em.to_batch(sid)
                sid += em.n_sessions
                r = self._exec_row_sharded(rel, b, ("sessions", t))
            out.append(r)

        for t, parts in enumerate(epoch_parts):
            bid = self._merged_bids(parts)
            staged = self._stage_session_chunk(bid) \
                if len(bid[SessionState.key]) else None
            em = state.advance(bid, t, staged=staged)
            if em is not None:
                emit(em, t)
            state.compact(StreamDriver.MAX_CHUNKS,
                          restage=self._stage_session_chunk)
        em = state.flush(t + 1)
        if em is not None:
            emit(em, t + 1)
        return out

    # -- session windows: the key-range device tier ---------------------------

    def _session_plan(self, epoch_parts) -> dict | None:
        """The device tier's host metadata: each epoch's needed columns,
        key range and event-second range, the global key range and the
        first attempt's per-shard span; None without a session row or for
        a plan the tier does not take."""
        rel = window_relations(self.spec.relations)[0]
        key, tcol = SessionState.key, SessionState.time_col
        fs = ds.session_fast_spec(self.spec, key, rel) \
            if self.spec.window[1] >= 1 else None
        if fs is None:
            return None
        epoch_aggs, accs = ds._acc_plan(fs, key, tcol)
        need = sorted({key, tcol}
                      | {c for c, _f, _o in epoch_aggs if c is not None})
        metas = []
        for parts in epoch_parts:
            bid = self._merged_bids(parts)
            bid = {c: bid[c] for c in need}
            k = bid[key]
            metas.append((len(k), int(k.min()) if len(k) else 0,
                          int(k.max()) if len(k) else -1, bid,
                          *ds._event_sec_range(bid.get(tcol))))
        first = next((t for t in range(len(metas)) if metas[t][0]), None)
        if first is None:
            return None
        # the global key range: a later epoch's key below the first epoch's
        # least must not strand the base
        m = min(mn for nn, mn, *_ in metas if nn)
        kmax_all = max(mx for nn, _mn, mx, *_ in metas if nn)
        return {"fs": fs, "epoch_aggs": epoch_aggs, "accs": accs,
                "need": need, "metas": metas, "first": first, "m": m,
                "S_shard": ds._bucket(
                    max((kmax_all - m + 1) // self.n_shards, 1) + 4096)}

    def _stage_session_epochs(self, plan: dict, S_shard: int) -> list:
        """Per epoch from the first with rows, per shard: (columns, valid,
        key range) of the rows whose key the shard owns at span
        ``S_shard`` (keys past the last shard's range stay on it, and its
        step flags them), staged once on the shard's device; ({}, None,
        None) for a shard without rows.  The key range is the host's, over
        the shard's own rows: it places the epoch in the shard's state."""
        n, m, need = self.n_shards, plan["m"], plan["need"]
        key = SessionState.key
        devices = self.executor.mesh.devices
        out = []
        for nrows, _mn, _mx, bid, *_ in plan["metas"][plan["first"]:]:
            shard_rows = [({}, None, None)] * n
            if nrows:
                k = np.asarray(bid[key], np.int64)
                part = np.clip((k - m) // S_shard, 0, n - 1)
                sels = [np.flatnonzero(part == i) for i in range(n)]
                cap = _bucket_cap(max(max(len(s) for s in sels), 1))
                shard_rows = []
                for sel, dev in zip(sels, devices):
                    if not len(sel):
                        shard_rows.append(({}, None, None))
                        continue
                    b = Batch.from_numpy({c: np.asarray(bid[c])[sel]
                                          for c in need}, cap, dev)
                    ks = k[sel]
                    shard_rows.append((b.columns, b.valid,
                                       (int(ks.min()), int(ks.max()))))
            out.append(shard_rows)
        return out

    def _run_session_device(self, epoch_parts, prestaged=None
                            ) -> list[WindowResult]:
        """Key-range sharded incremental sessions: shard i owns the keys
        ``[m + i * S_shard, m + (i + 1) * S_shard)``.  Key-space growth
        restarts the run with doubled spans: range boundaries move with the
        span, so growing in place would strand state on the wrong shard."""
        self.session_stats = {"dispatches": 0, "flag_reads": 0,
                              "restarts": 0, "shard_steps": 0}
        plan = self._session_plan(epoch_parts)
        if plan is None:
            return []
        for attempt in range(runtime_stream._WIDENS + 1):
            S_shard = plan["S_shard"] * (2 ** attempt)
            staged = prestaged if attempt == 0 and prestaged is not None \
                else self._stage_session_epochs(plan, S_shard)
            res = self._session_device_once(plan, staged, S_shard,
                                            8192 * (2 ** attempt))
            if res is not None:
                return res
            self.session_stats["restarts"] += 1
        raise RuntimeError("distributed device sessions: span retry budget")

    def _session_device_once(self, plan: dict, staged: list, S_shard: int,
                             cap_out: int):
        """One run at per-shard span ``S_shard`` over the staged epochs;
        None when a flag says the spans or the emission buffer were too
        small.  One host read of every shard's flags per epoch."""
        key, tcol = SessionState.key, SessionState.time_col
        gap = self.spec.window[1]
        n = self.n_shards
        devices = self.executor.mesh.devices
        stats = self.session_stats
        fs, epoch_aggs, accs = plan["fs"], plan["epoch_aggs"], plan["accs"]
        metas, first = plan["metas"], plan["first"]
        # each shard's own state; buffers carry an S_shard tail pad, so the
        # step's window merge (SE = S_shard) never clamps
        states = [ds.init_state(2 * S_shard, accs, dev) for dev in devices]
        bases = [plan["m"] + i * S_shard for i in range(n)]
        out: list[WindowResult] = []
        min_ev_seen = None
        for t, shard_rows in zip(range(first, len(metas)), staged):
            nrows, _mn, _mx, _bid, ev_mn, ev_mx = metas[t]
            min_ev_seen, may_close = ds.closure_gate(
                min_ev_seen, ev_mn, ev_mx, nrows, t, gap)
            ocs, flags = [], []
            for i, (cols, valid, krange) in enumerate(shard_rows):
                stats["shard_steps"] += krange is not None
                states[i], oc, _ov, ne, ovf = ds.step_impl(
                    key, tcol, epoch_aggs, accs, S_shard, cap_out, may_close,
                    gap, t + 1 - gap, bases[i], states[i], cols, valid,
                    krange)
                ocs.append(oc)
                flags.append(torch.stack([ne.to(torch.int64),
                                          ovf.to(torch.int64)])
                             .to(devices[0]))
            stats["dispatches"] += 1
            ne_h, ovf_h = torch.stack(flags).T.tolist()
            stats["flag_reads"] += 1
            if any(ovf_h):
                return None      # span or emission growth: restart
            if may_close and sum(ne_h):
                out.append(self._session_result(fs, ocs, ne_h,
                                                ("sessions", t)))
        ocs, nes = [], []
        for i in range(n):
            oc, _ov, ne = ds.flush_impl(accs, S_shard, bases[i], states[i])
            ocs.append(oc)
            nes.append(ne.to(devices[0]))
        ne_h = torch.stack(nes).tolist()
        stats["flag_reads"] += 1
        if sum(ne_h):
            out.append(self._session_result(fs, ocs, ne_h,
                                            ("sessions", len(metas))))
        return out

    def _session_result(self, fs, ocs: list[dict], ne: list[int],
                        tag: tuple) -> WindowResult:
        """The shards' emitted sessions (the first ``ne[i]`` rows of shard
        i's buffer), in shard order, read back in one copy."""
        dev = self.executor.device
        cols = {c: torch.cat([oc[c][:k].to(dev) for oc, k in zip(ocs, ne)])
                for c in sorted(ocs[0])}
        total = sum(ne)
        host = Batch(cols, torch.ones(total, dtype=torch.bool, device=dev)
                     ).to_numpy()
        return WindowResult(tag, materialize_columns(
            self.spec, ds.finish_names(fs, SessionState.key, host)))

"""Stream driver — the counterpart of ``flock_tpu/runtime/stream.py``:
``generate_epochs``, ``generate_epoch_parts`` (the per-generator tables
the sharded driver, ``parallel/stream.py``, shards) and a ``StreamDriver`` for the range windows
(element-wise, tumbling, hopping, sliding, stagger), row-count windows,
processing-time (global) windows and session windows, with q13's side
input staged once per driver.

Range windows stage every epoch on the device once, at uniform per-epoch
capacities, end to end in one device buffer per relation and column, so
that a window of consecutive epochs is a view of those buffers
(``LocalExecutor.execute_epochs``): overlapping hopping and sliding windows
share their epochs without another transfer or copy.  On overflow the
per-epoch capacities double, every epoch is staged again into new buffers
and the window retries.
Row-count windows pack the driving relation's rows on the host.
Processing-time windows (q12) group arrival epochs: each epoch's projected
driving table is staged once (``prestage`` stages them all ahead of the
run, as bench.py times it), and a window runs through
``LocalExecutor.execute_consts`` as soon as it completes, with its
processing time made on the device.

Session windows (q11) take one of two tiers, as in the reference: a plan
whose session aggregates are count/sum/min/max runs on the device tier
(``runtime/device_session.py``: the open sessions as dense per-key
accumulators on the device, kernel K2 once per epoch); any other plan runs
on the generic label-table tier here.  That tier's host bookkeeping
(``SessionState``, ``Emission``, ``_host_masks``) is a copy of the
reference's; each epoch's projected rows are staged once, and an emission
ships three O(key-span) label tables that ``LocalExecutor.
execute_session_tables`` gathers to the rows (kernel K3) before the plan's
``__session`` aggregate (kernel K2).  Both tiers checkpoint their open
sessions as payloads (``to_payloads``/``from_payloads``).
"""

from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from flock_tpu_torch.batch import Batch, round_up, staged_dtype, torch_dtype
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.datagen.native_gen import nexmark_generate_partition
from flock_tpu_torch.datagen.nexmark import NexmarkConfig
from flock_tpu_torch.plan import Aggregate, referenced_columns, walk
from flock_tpu_torch.queries.nexmark import QuerySpec, get_query
from flock_tpu_torch.runtime import device_session
from flock_tpu_torch.runtime.executor import (LocalExecutor, OverflowError,
                                              _pow2_bucket, agg_capacity_for)
from flock_tpu_torch.runtime.payload import FragmentId, Payload
from flock_tpu_torch.runtime.tables import (concat_relations,
                                            epoch_to_relations,
                                            window_relations)
from flock_tpu_torch.utils.metrics import METRICS

# widen-and-retry budget of one window, shared by the single-card and sharded
# stream drivers (read when a loop runs, so one patch reaches every loop)
_WIDENS = 5


def widen_aggregate(run, agg_cap: int):
    """``run(agg_cap)``, retried at four times the aggregate capacity after
    each OverflowError, ``_WIDENS`` times; the last attempt's OverflowError
    stands."""
    for _ in range(_WIDENS):
        try:
            return run(agg_cap)
        except OverflowError:
            agg_cap *= 4
    return run(agg_cap)


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


def generate_epoch_parts(seconds: int, events_per_second: int,
                         generators: int = 1) -> list[list[dict]]:
    """Per-epoch, per-generator-partition relation tables, unmerged — the
    unit the sharded driver spreads over its shards.  ``parts[t][i]`` is
    the i-th table of epoch t, in generator order, as the reference's."""
    cfg = NexmarkConfig(events_per_second=events_per_second,
                        num_event_generators=generators)
    # ctypes releases the GIL during native generation: partitions generate
    # in parallel threads
    with ThreadPoolExecutor(max_workers=min(generators, 8)) as pool:
        results = list(pool.map(
            lambda p: nexmark_generate_partition(cfg, seconds, p),
            range(generators)))
    parts: list[list[dict]] = [[] for _ in range(seconds)]
    for eps in results:
        for e in eps:
            if e.epoch < seconds:
                parts[e.epoch].append(epoch_to_relations(e))
    return parts


# the reference's name for the power-of-two capacity bucket
_bucket_cap = _pow2_bucket


def _bucket_cap_fine(n: int) -> int:
    """1/8-octave capacity bucket (8..15 sixteenths of a power of two past
    1024): output buffers track the observed span within ~12 % instead of
    up to 2x, with 8 buckets per octave (copy of the reference's)."""
    c = 128
    while c < n:
        c *= 2
    if c <= 1024:
        return c
    step = c // 16
    m = c // 2
    while m < n:
        m += step
    return m


@dataclass
class WindowResult:
    tag: tuple          # window identifier, e.g. ("epoch", 3)
    columns: dict       # materialized output columns (schema order)


def _rows(cols: dict) -> int:
    return len(next(iter(cols.values()))) if cols else 0


# -- session windows: the generic label-table tier ----------------------------
# (copies of the reference's _Chunk, _host_masks, Emission and SessionState)


@dataclass
class _Chunk:
    """One epoch's rows retained on the host while sessions stay open.
    ``staged`` optionally holds the same rows as a device-resident Batch
    (set by the driver's device emission path; rows are then never
    re-shipped — an emission transfers only three small label tables)."""

    cid: int             # absolute chunk counter (session start markers)
    cols: dict           # host columns, arrival order
    bidders: np.ndarray  # int64 view of the session-key column
    kmin: int            # key range of this chunk (emission pre-filter)
    kmax: int
    staged: object = None


_SPAN_LIMIT = 1 << 24  # dense key-table fallback threshold (64MB of int64)
_NO_START = np.iinfo(np.int32).max
_NO_END = np.iinfo(np.int32).max


def _host_masks(closed: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                ch: _Chunk):
    """(labels int32[rows], live bool[rows]) for one chunk against one closed
    set.  Labels are a monotone compression of the key column (non-closed
    keys carry their insertion rank).  A row is live iff its key's session
    is closed AND the session's chunk range [start, end) contains this
    chunk — rows outside it belong to a previous or reopened session of the
    same key.  Dense key tables when the closed keys' span is small, else
    binary searches."""
    k = len(closed)
    cmin = int(closed.min())
    cspan = int(closed.max()) - cmin + 1
    cb = ch.bidders
    if cspan <= max(64 * k, _SPAN_LIMIT):
        flag = np.zeros(cspan, bool)
        flag[closed - cmin] = True
        rank = (np.cumsum(flag) - flag).astype(np.int32)
        stab = np.full(cspan, np.iinfo(np.int64).max, np.int64)
        stab[closed - cmin] = starts
        etab = np.full(cspan, -1, np.int64)
        etab[closed - cmin] = ends
        p = cb - cmin
        inr = (p >= 0) & (p < cspan)
        pc = np.where(inr, p, 0)
        lab = np.minimum(rank[pc], k - 1)
        live = inr & flag[pc] & (stab[pc] <= ch.cid) & (ch.cid < etab[pc])
    else:
        ix = np.searchsorted(closed, cb)
        ixc = np.minimum(ix, k - 1)
        lab = ixc.astype(np.int32)
        live = ((closed[ixc] == cb) & (starts[ixc] <= ch.cid)
                & (ch.cid < ends[ixc]))
    return lab, live


class Emission:
    """Sessions closed by one ``advance``/``flush`` call — a LAZY description
    (closed keys + per-session [start, end) chunk ranges + a chunk snapshot).
    Realization is the consumer's choice:

    * ``dense_tables()`` — three small int32 tables (session rank, start
      chunk, end chunk) the device labels and filters its staged rows with:
      per-emission transfer is O(key span), not O(rows);
    * ``parts()``/``to_batch()`` — host-side per-row labels for the generic
      executors (tests, checkpoints, the host fallback)."""

    def __init__(self, groups: list, chunks: list, t: int):
        # group = (closed sorted, starts, ends) — ends bound gap-closed
        # sessions away from the reopening epoch's chunk
        groups = [g for g in groups if len(g[0])]
        self.t = t
        self.merged = None
        if len(groups) == 1:
            self.merged = groups[0]
        elif groups:
            allc = np.concatenate([g[0] for g in groups])
            alls = np.concatenate([g[1] for g in groups])
            alle = np.concatenate([g[2] for g in groups])
            order = np.argsort(allc, kind="stable")
            allc, alls, alle = allc[order], alls[order], alle[order]
            if not np.any(allc[1:] == allc[:-1]):
                self.merged = (allc, alls, alle)
        self.groups = groups
        lo = min(int(g[0].min()) for g in groups)
        hi = max(int(g[0].max()) for g in groups)
        min_start = min(int(g[1].min()) for g in groups)
        self.chunks = [ch for ch in chunks
                       if ch.cid >= min_start
                       and ch.kmax >= lo and ch.kmin <= hi]

    @property
    def bidders(self) -> np.ndarray:
        if self.merged is not None:
            return self.merged[0]
        return np.concatenate([g[0] for g in self.groups])

    @property
    def n_sessions(self) -> int:
        return sum(len(g[0]) for g in self.groups)

    def dense_tables(self, span_bucket: int):
        """(rank_tab, ok_tab, end_tab, cmin, k) for the device labeling
        pass, or None when not expressible (duplicate keys across groups —
        the gap≈0 degenerate case — or key span ≥ span_bucket).
        ``rank_tab[key-cmin]`` is the session label (monotone insertion rank
        for non-closed keys); a row in chunk c is live iff
        ok_tab ≤ c.cid < end_tab."""
        if self.merged is None:
            return None
        closed, starts, ends = self.merged
        cmin = int(closed.min())
        span = int(closed.max()) - cmin + 1
        if span >= span_bucket:
            return None
        flag = np.zeros(span_bucket, bool)
        flag[closed - cmin] = True
        rank = (np.cumsum(flag) - flag).astype(np.int32)
        ok = np.full(span_bucket, _NO_START, np.int32)
        ok[closed - cmin] = starts.astype(np.int32)
        endt = np.zeros(span_bucket, np.int32)
        endt[closed - cmin] = np.minimum(ends, _NO_END).astype(np.int32)
        return rank, ok, endt, cmin, len(closed)

    def parts(self):
        """Host-side realization: (chunk, labels, live) per involved chunk,
        with labels offset per group so session ids stay unique."""
        out, off = [], 0
        for closed, starts, ends in self.groups:
            for ch in self.chunks:
                if ch.kmax < closed.min() or ch.kmin > closed.max() \
                        or ch.cid < starts.min():
                    continue
                lab, live = _host_masks(closed, starts, ends, ch)
                if live.any():
                    out.append((ch, lab + np.int32(off), live))
            off += len(closed)
        return out

    @property
    def n_rows(self) -> int:
        return sum(int(lv.sum()) for _, __, lv in self.parts())

    def to_batch(self, sid0: int = 0) -> dict:
        """Host-materialized emitted rows with a ``__session`` id column
        (the generic form fed to arbitrary executors)."""
        parts = self.parts()
        idxs = [(ch, np.flatnonzero(lv), lab) for ch, lab, lv in parts]
        cols = {c: np.concatenate([ch.cols[c][ix] for ch, ix, _ in idxs])
                for c in parts[0][0].cols}
        cols["__session"] = np.concatenate(
            [lab[ix] for _, ix, lab in idxs]).astype(np.int32) + sid0
        return cols


_INF_END = np.iinfo(np.int64).max


class SessionState:
    """Session-window bookkeeping (q11): per-bidder open windows, fully
    vectorized (no per-bidder host loop, no per-row work on the hot path).

    Reference counterpart: window/session.rs:64-178 — a fragment more than
    ``gap`` seconds (second-truncated) after its window's last row closes the
    window; idle windows time out as epochs advance.

    Open-session state is three aligned vectors over the sorted open-key set
    (last row second, session start chunk) plus the retained row chunks.
    Per-epoch statistics use dense key-span scatter tables (one native pass,
    ``native.session_stats``) with an argsort fallback for sparse keys.
    Rows are never mutated: exactly-once emission falls out of per-session
    [start, end) chunk ranges, and chunks retire once no open session can
    reach them.

    The state is checkpointable: ``to_payloads``/``from_payloads`` serialize
    the open windows through the payload codec so a replacement worker
    resumes mid-stream (the reference's S3 window-state checkpoint
    analogue, state/s3.rs + actor.rs:391-413).
    """

    key = "bidder"
    time_col = "b_date_time"

    def __init__(self, gap: int):
        self.gap = gap
        self.chunks: list[_Chunk] = []
        self.ob = np.empty(0, np.int64)         # open session keys, sorted
        self.last_s = np.empty(0, np.int64)     # last row second per key
        self.start_cid = np.empty(0, np.int64)  # chunk id the session opened at
        self.next_cid = 0
        self.epoch = 0

    # -- internals -------------------------------------------------------------

    @staticmethod
    def _per_key_stats(keys: np.ndarray, times: np.ndarray):
        """(uniq sorted keys, first row second, last row second) per key.
        Rows arrive time-ordered within an epoch, so first/last occurrence
        equals min/max; dense scatter tables make this O(n) without a sort.
        Epochs sliced by event second (the generator's layout) hit the
        constant-second fast path: every key's first == last == the epoch's
        second, so only the key-occupancy pass runs."""
        from flock_tpu_torch import native

        kmin = int(keys.min())
        span = int(keys.max()) - kmin + 1
        n = len(keys)
        tmin = int(times.min())
        const_sec = tmin // 1000 if int(times.max()) // 1000 == tmin // 1000 \
            else None
        if span <= max(64 * n, _SPAN_LIMIT):
            st = native.session_stats(keys, times, kmin, span)
            if st is not None:     # one C pass instead of several numpy ones
                first_t, last_t = st
                off = np.flatnonzero(last_t >= 0)
                return off + kmin, first_t[off], last_t[off]
            pos = keys - kmin
            if const_sec is not None:
                flag = np.zeros(span, bool)
                flag[pos] = True
                off = np.flatnonzero(flag)
                sec = np.full(len(off), const_sec, np.int64)
                return off + kmin, sec, sec
            secs = times // 1000
            last = np.full(span, -1, np.int64)
            last[pos] = secs
            first = np.empty(span, np.int64)
            first[pos[::-1]] = secs[::-1]
            off = np.flatnonzero(last >= 0)
            return off + kmin, first[off], last[off]
        secs = times // 1000
        order = np.argsort(keys, kind="stable")
        sk, ss = keys[order], secs[order]
        uniq, starts = np.unique(sk, return_index=True)
        ends = np.append(starts[1:], n) - 1
        return uniq, ss[starts], ss[ends]

    def _prune_chunks(self) -> None:
        """A chunk retires once every open session started after it — its
        remaining rows all belong to already-emitted sessions."""
        if not len(self.ob):
            self.chunks = []
            return
        floor = int(self.start_cid.min())
        self.chunks = [c for c in self.chunks if c.cid >= floor]

    # -- epoch advance ---------------------------------------------------------

    def advance(self, bids: dict, t: int, staged=None) -> Emission | None:
        """Feed one epoch's rows; returns the sessions closed by gap/timeout
        (as a lazy Emission over the retained chunks) or None."""
        groups: list[tuple] = []
        n = len(bids[self.key])
        if n:
            keys = np.asarray(bids[self.key]).astype(np.int64, copy=False)
            times = np.asarray(bids[self.time_col])
            uniq, first_sec, last_sec = self._per_key_stats(keys, times)
            if len(self.ob):
                ix = np.searchsorted(self.ob, uniq)
                ixc = np.minimum(ix, len(self.ob) - 1)
                found = (ix < len(self.ob)) & (self.ob[ixc] == uniq)
                gap_close = found & (first_sec - self.last_s[ixc] > self.gap)
            else:
                found = np.zeros(len(uniq), bool)
                gap_close = found
            cid = self.next_cid
            self.next_cid += 1
            if gap_close.any():
                # the closing (old) sessions END at this epoch's chunk: its
                # rows belong to the reopened sessions
                k1 = int(gap_close.sum())
                groups.append((uniq[gap_close],
                               self.start_cid[ixc[gap_close]],
                               np.full(k1, cid, np.int64)))
            self.chunks.append(_Chunk(
                cid=cid, cols={c: np.asarray(v) for c, v in bids.items()},
                bidders=keys, kmin=int(keys.min()), kmax=int(keys.max()),
                staged=staged))
            # merge the open set: epoch keys update last_s; fresh keys (new or
            # gap-reopened) start a session at this chunk
            ob2 = np.union1d(self.ob, uniq)
            last2 = np.empty(len(ob2), np.int64)
            start2 = np.empty(len(ob2), np.int64)
            if len(self.ob):
                po = np.searchsorted(ob2, self.ob)
                last2[po] = self.last_s
                start2[po] = self.start_cid
            pn = np.searchsorted(ob2, uniq)
            last2[pn] = last_sec
            fresh = ~found | gap_close
            start2[pn[fresh]] = cid
            self.ob, self.last_s, self.start_cid = ob2, last2, start2
        # timeout scan (session.rs:136-178): epoch time vs last row time
        now_s = NexmarkConfig().base_time // 1000 + (t + 1)
        cutoff = now_s - self.gap
        to = self.last_s < cutoff
        if to.any():
            groups.append((self.ob[to], self.start_cid[to],
                           np.full(int(to.sum()), _INF_END, np.int64)))
            keep = ~to
            self.ob = self.ob[keep]
            self.last_s = self.last_s[keep]
            self.start_cid = self.start_cid[keep]
        self.epoch = t + 1
        em = Emission(groups, list(self.chunks), t) if groups else None
        self._prune_chunks()
        return em

    def flush(self, seconds: int) -> Emission | None:
        """Close remaining sessions at stream end (bounded-run semantics)."""
        if not len(self.ob):
            return None
        em = Emission(
            [(self.ob, self.start_cid,
              np.full(len(self.ob), _INF_END, np.int64))],
            list(self.chunks), seconds)
        self.ob = np.empty(0, np.int64)
        self.last_s = np.empty(0, np.int64)
        self.start_cid = np.empty(0, np.int64)
        self.chunks = []
        return em

    def _live_row_indices(self):
        ends = np.full(len(self.ob), _INF_END, np.int64)
        idxs = []
        for ch in self.chunks:
            _, live = _host_masks(self.ob, self.start_cid, ends, ch)
            idxs.append((ch, np.flatnonzero(live)))
        return idxs

    def compact(self, max_chunks: int, restage=None) -> None:
        """Bound the retained-chunk count (and the device buffers) by
        merging live rows into one chunk when long-lived sessions pile up
        epochs (the granule-packing analogue, window/mod.rs:29-56)."""
        if len(self.chunks) <= max_chunks or not len(self.ob):
            return
        idxs = self._live_row_indices()
        cols = {c: np.concatenate([ch.cols[c][ix] for ch, ix in idxs])
                for c in self.chunks[0].cols}
        keys = cols[self.key].astype(np.int64, copy=False)
        cid = self.next_cid
        self.next_cid += 1
        merged = _Chunk(cid=cid, cols=cols, bidders=keys,
                        kmin=int(keys.min()) if len(keys) else 0,
                        kmax=int(keys.max()) if len(keys) else -1,
                        staged=restage(cols) if restage else None)
        self.chunks = [merged]

    # -- checkpoint / resume ---------------------------------------------------

    def to_payloads(self, qid: str):
        if not len(self.ob):
            return []
        idxs = self._live_row_indices()
        cols = {c: np.concatenate([ch.cols[c][ix] for ch, ix in idxs])
                for c in self.chunks[0].cols}
        keys = cols[self.key].astype(np.int64, copy=False)
        # group rows per key, chunk (=time) order preserved within key
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        bounds = np.flatnonzero(np.diff(sk)) + 1
        splits = np.concatenate([[0], bounds, [len(sk)]])
        uniq = sk[splits[:-1]]
        out = []
        for i, bidder in enumerate(uniq.tolist()):
            sel = order[splits[i]:splits[i + 1]]
            out.append(Payload(
                FragmentId(qid, i, len(uniq), shuffle_id=0),
                {c: v[sel] for c, v in cols.items()},
                metadata={"bidder": int(bidder), "epoch": self.epoch}))
        return out

    @classmethod
    def from_payloads(cls, gap: int, payloads) -> "SessionState":
        st = cls(gap=gap)
        payloads = list(payloads)
        if not payloads:
            return st
        bidders = np.array([p.metadata["bidder"] for p in payloads], np.int64)
        # fragments are time-ordered, so the restored window's last row
        # second is the tail of its time column — the open-set/last_s
        # invariant must hold on resume or gap/timeout logic breaks
        last = np.array([int(p.columns[cls.time_col][-1]) // 1000
                         for p in payloads], np.int64)
        order = np.argsort(bidders)
        st.ob = bidders[order]
        st.last_s = last[order]
        st.start_cid = np.zeros(len(payloads), np.int64)
        cols = {c: np.concatenate([p.columns[c] for p in payloads])
                for c in payloads[0].columns}
        keys = cols[cls.key].astype(np.int64, copy=False)
        st.chunks = [_Chunk(cid=0, cols=cols, bidders=keys,
                            kmin=int(keys.min()), kmax=int(keys.max()))]
        st.next_cid = 1
        st.epoch = max(p.metadata["epoch"] for p in payloads)
        return st


def window_epoch_ranges(spec: QuerySpec, seconds: int,
                    occupancy: list[bool] | None = None) -> list[tuple]:
    """Window tag → epoch list, for the range-based kinds (both stream
    drivers slice so).

    ``occupancy`` (per-epoch has-data flags) is required only for stagger
    windows, whose anchors are data-dependent (window.rs:104-110 — a
    window opens at the first event after the previous one closes)."""
    kind = spec.window[0]
    s = seconds
    if kind == "elementwise":
        return [(("epoch", t), [t]) for t in range(s)]
    if kind == "tumbling":
        w = spec.window[1]
        return [(("win", k * w, k * w + w), list(range(k * w, k * w + w)))
                for k in range(s // w)]
    if kind == "hopping":
        w, h = spec.window[1], spec.window[2]
        return [(("win", t, t + w), list(range(t, t + w)))
                for t in range(0, s, h) if t + w <= s]
    if kind == "sliding":
        # window.rs:94-97: emit at every slide point, covering the
        # trailing w seconds (leading windows are partial)
        w, sl = spec.window[1], spec.window[2]
        return [(("win", max(0, t - w), t), list(range(max(0, t - w), t)))
                for t in range(sl, s + 1, sl)]
    if kind == "stagger":
        # window.rs:104-110: first-event-anchored w-second windows
        w = spec.window[1]
        if occupancy is None:
            raise ValueError("stagger windows need per-epoch occupancy")
        out, t = [], 0
        while t < s:
            if occupancy[t]:
                out.append((("win", t, t + w),
                            list(range(t, min(t + w, s)))))
                t += w
            else:
                t += 1
        return out
    raise ValueError(kind)


def _ring(epochs: list[dict], rel: str, cap: int, device) -> Batch | None:
    """An unfilled Batch of ``len(epochs) × cap`` rows with relation
    ``rel``'s columns as every epoch stages them, or None where the epochs
    differ in their columns' names, order or staged dtypes."""
    layouts = {tuple((c, staged_dtype(np.asarray(a)))
                     for c, a in e[rel].items()) for e in epochs}
    if len(layouts) != 1:
        return None
    n = len(epochs) * cap
    return Batch({c: torch.empty(n, dtype=torch_dtype(dt), device=device)
                  for c, dt in layouts.pop()},
                 torch.empty(n, dtype=torch.bool, device=device))


class StreamDriver:
    def __init__(self, spec: QuerySpec, seconds: int,
                 side_input: dict | None = None,
                 agg_capacity: int | None = None, device=None):
        self.spec = spec
        self.seconds = seconds
        self.executor = LocalExecutor(spec, agg_capacity, device, side_input)
        # the device session tier's last run (device_session.SessionRunStats)
        self.session_stats = None

    # -- window slicing -------------------------------------------------------

    def _window_epoch_ranges(self, occupancy: list[bool] | None = None):
        return window_epoch_ranges(self.spec, self.seconds, occupancy)

    @staticmethod
    def _epoch_rows(tables: dict) -> int:
        return sum(_rows(cols) for cols in tables.values())

    def epoch_ranges(self, epochs: list[dict]) -> list[tuple]:
        """(tag, epoch list) of every range window over ``epochs``, with the
        per-epoch occupancy stagger windows anchor on."""
        rels = window_relations(self.spec.relations)
        occupancy = [self._epoch_rows({r: e.get(r, {}) for r in rels}) > 0
                     for e in epochs]
        return self._window_epoch_ranges(occupancy)

    def windows(self, epochs: list[dict]) -> list[tuple]:
        """(tag, host relation tables) for every window of the stream, as the
        driver forms them; the static side input is the executor's, not a
        window's."""
        if self.spec.window[0] == "rows":
            return list(self._row_windows(epochs))
        rels = window_relations(self.spec.relations)
        return [(tag, concat_relations([epochs[t] for t in rng
                                        if t < len(epochs)], rels))
                for tag, rng in self.epoch_ranges(epochs)]

    # -- execution ------------------------------------------------------------

    def run(self, epochs: list[dict],
            prestaged: list | None = None) -> list[WindowResult]:
        """Every window of the stream, in order.  ``prestaged`` (from
        ``prestage``) holds processing-time and session windows' staged
        epochs, so the run stages nothing; other window kinds stage their
        own."""
        kind = self.spec.window[0]
        if kind == "session":
            return self._run_session(epochs, prestaged)
        if kind == "global":
            return self._run_global(epochs, prestaged)
        if kind == "rows":
            return self._run_rows(epochs)
        return self._run_ranges(epochs)

    def epoch_caps(self, epochs: list[dict]) -> dict[str, int]:
        """Uniform per-epoch capacities: each window relation's largest
        epoch, rounded up (at least 128 rows)."""
        return {rel: max(round_up(max((_rows(e[rel]) for e in epochs
                                       if rel in e and e[rel]), default=1)),
                         128)
                for rel in window_relations(self.spec.relations)}

    def stage_epochs(self, epochs: list[dict], caps: dict[str, int]
                     ) -> list[dict[str, Batch]]:
        """Every epoch's window relations on the device, once each, laid
        end to end: each column of a relation, and its ``valid`` mask, is
        one device tensor of ``len(epochs) × cap`` rows, and epoch ``e``'s
        Batch is its rows ``[e·cap, (e+1)·cap)``, so that
        ``LocalExecutor.execute_epochs`` forms a window of consecutive
        epochs as a view.  A relation whose epochs differ in their columns'
        names or staged dtypes takes a tensor per epoch.  The host's time
        per epoch in ``METRICS`` (``stage.epoch_s`` over
        ``stage.epochs``)."""
        rings = {rel: _ring(epochs, rel, cap, self.executor.device)
                 for rel, cap in caps.items()}
        staged = []
        for i, e in enumerate(epochs):
            with METRICS.timer("stage.epoch_s"):
                staged.append({
                    rel: self.executor.stage_chunk(
                        e[rel], cap, None if rings[rel] is None
                        else rings[rel].rows(i * cap, (i + 1) * cap))
                    for rel, cap in caps.items()})
            METRICS.count("stage.epochs")
        return staged

    def _run_ranges(self, epochs) -> list[WindowResult]:
        """Stage each epoch on the device ONCE, end to end; each window is
        a view of its epochs (``LocalExecutor.execute_epochs``), so hopping
        windows share their overlapping epochs without another transfer."""
        caps = self.epoch_caps(epochs)
        staged = self.stage_epochs(epochs, caps)
        out = []
        for tag, rng in self.epoch_ranges(epochs):
            with METRICS.span("driver.window"):
                for attempt in range(_WIDENS + 1):
                    ets = [staged[t] for t in rng if t < len(staged)]
                    try:
                        b = self.executor.execute_epochs(ets)
                        break
                    except OverflowError:
                        # static buffers too small (wide key span, or join
                        # fan-out extras from duplicate build keys): double
                        # the per-epoch capacities, stage again, retry
                        if attempt == _WIDENS:
                            raise
                        caps = {r: c * 2 for r, c in caps.items()}
                        staged = self.stage_epochs(epochs, caps)
                out.append(WindowResult(tag, self.executor.materialize(b)))
        return out

    @METRICS.spanned("driver.window")
    def _execute_retry(self, tag, tables, caps) -> WindowResult:
        """One window from host tables with the overflow widen-and-retry:
        the aggregate capacity quadruples, relation capacities double."""
        for attempt in range(_WIDENS + 1):
            try:
                b = self.executor.execute_window(tables, caps)
                break
            except OverflowError:
                if attempt == _WIDENS:
                    raise
                base = self.executor.agg_capacity or agg_capacity_for(
                    caps.values())
                self.executor.agg_capacity = base * 4
                caps = {r: c * 2 for r, c in caps.items()}
        return WindowResult(tag, self.executor.materialize(b))

    # -- row-count windows (Schedule::Rows, window.rs:75-77) -------------------

    def _row_windows(self, epochs):
        """(tag, tables) of the row-count windows: the driving relation's
        rows pack into consecutive windows of exactly n rows; the remainder
        flushes at stream end.  Host state is bounded by one window's
        rows."""
        n = self.spec.window[1]
        rel = self.executor._driving_relation()
        pending: list[dict] = []
        have = widx = 0
        for tables in epochs:
            cols = tables.get(rel)
            if not _rows(cols):
                continue
            pending.append(dict(cols))
            have += _rows(cols)
            while have >= n:
                joined = {k: np.concatenate([p[k] for p in pending])
                          for k in pending[0]}
                yield ("rows", widx), {rel: {k: v[:n]
                                             for k, v in joined.items()}}
                widx += 1
                have -= n
                pending = [{k: v[n:] for k, v in joined.items()}] \
                    if have else []
        if have:
            yield ("rows", widx), {rel: {k: np.concatenate([p[k] for p in
                                                            pending])
                                         for k in pending[0]}}

    def _run_rows(self, epochs) -> list[WindowResult]:
        return [self._execute_retry(
                    tag, tables,
                    {r: _pow2_bucket(_rows(c)) for r, c in tables.items()})
                for tag, tables in self._row_windows(epochs)]

    # -- processing-time and session windows (q12, q11) ----------------------

    def _needed_cols(self, table: dict, extra: tuple[str, ...] = ()) -> dict:
        """``table`` cut to the columns the plan (or the window bookkeeping,
        ``extra``) reads before it is staged (projection pushdown), less
        ``p_time``, which the executor makes on the device."""
        refs = referenced_columns(self.spec.plan)
        keep = None if refs is None \
            else refs | set(self.spec.schema.names) | set(extra)
        return {k: v for k, v in table.items()
                if k != "p_time" and (keep is None or k in keep)}

    MAX_CHUNKS = 8

    def prestage(self, epochs: list[dict]) -> list:
        """Each epoch's projected driving table on the device ahead of the
        run (None for an empty epoch), at the reference's capacity
        ``_pow2_bucket(rows)``: what ``run(epochs, prestaged=...)`` takes.
        Session windows keep the session key and time columns too."""
        rel = self.executor._driving_relation()
        extra = (SessionState.key, SessionState.time_col) \
            if self.spec.window[0] == "session" else ()
        out = []
        for tables in epochs:
            cols = self._needed_cols(tables[rel], extra)
            n = _rows(cols)
            out.append(self.executor.stage_chunk(cols, _pow2_bucket(n))
                       if n else None)
        return out

    def _run_global(self, epochs, prestaged=None) -> list[WindowResult]:
        """Processing-time windows: each window of w arrival epochs runs as
        soon as it completes, holding only its own staged epochs.  Its
        processing time is made on the device from the arrival epoch (one
        constant per staged epoch), so nothing per row moves at emission;
        the aggregate is sized to the window's observed key span, and on
        overflow its capacity quadruples (``widen_aggregate``)."""
        w = self.spec.window[1]
        rel = self.executor._driving_relation()
        # the span key is the plan's single group key (q12: bidder)
        span_keys = [n.group_keys[0] for n in walk(self.spec.plan)
                     if isinstance(n, Aggregate) and len(n.group_keys) == 1
                     and n.group_keys[0] != "p_time"]
        if not span_keys:
            raise ValueError(
                "processing-time driver needs a single-key aggregation")
        span_key = span_keys[0]
        out: list[WindowResult] = []
        pending: list[tuple] = []  # (t, staged Batch, key_min, key_max)
        start = 0

        def emit(start: int) -> WindowResult | None:
            if not pending:
                return None
            chunks = [b for _, b, _, _ in pending]
            p_times = [t * 1000 for t, _, _, _ in pending]
            span = (max(mx for *_, mx in pending)
                    - min(mn for _, _, mn, _ in pending) + 1)
            agg_cap = _bucket_cap_fine(span + CONFIG.agg_span_margin)
            pending.clear()
            with METRICS.span("driver.window"):
                b = widen_aggregate(lambda cap: self.executor.execute_consts(
                    chunks, {"p_time": p_times}, cap), agg_cap)
                return WindowResult(("ptime", start, start + w),
                                    self.executor.materialize(b))

        for t, tables in enumerate(epochs):
            if t - start >= w:
                r = emit(start)
                if r is not None:
                    out.append(r)
                start = t
            cols = self._needed_cols(tables[rel])
            keys = cols[span_key]
            if not len(keys):
                continue
            staged = prestaged[t] if prestaged is not None \
                else self.executor.stage_chunk(cols, _pow2_bucket(len(keys)))
            pending.append((t, staged, int(keys.min()), int(keys.max())))
        r = emit(start)
        if r is not None:
            out.append(r)
        return out

    def _run_session(self, epochs, prestaged=None) -> list[WindowResult]:
        """Streaming session windows: sessions closed by gap or timeout are
        executed and emitted per epoch (the reference's per-epoch session
        drain, session.rs:136-178); the rest flush at stream end.

        A plan whose session aggregation is incrementally mergeable
        (count/sum/min/max, ``device_session.session_fast_spec``) runs on
        the device tier, gated on gap ≥ 1 s (the per-epoch first/last-second
        granularity both tiers share).  Any other plan takes the generic
        label-table tier: each epoch's projected rows are staged once, the
        host keeps ``SessionState``, and an emission runs on the device
        from three label tables (``_exec_emission``); retained chunks
        compact past ``MAX_CHUNKS``.  Both tiers read the driving relation,
        whatever its name."""
        gap = self.spec.window[1]
        rel = self.executor._driving_relation()
        key, tcol = SessionState.key, SessionState.time_col
        fs = device_session.session_fast_spec(self.spec, key, rel) \
            if gap >= 1 else None
        if fs is not None:
            return device_session.run_device_sessions(
                self, epochs, prestaged, fs)
        state = SessionState(gap=gap)
        out: list[WindowResult] = []

        def restage(cols):
            return self.executor.stage_chunk(cols, _pow2_bucket(_rows(cols)))

        t = -1
        for t, tables in enumerate(epochs):
            bid = self._needed_cols(tables[rel], extra=(key, tcol))
            n = len(bid[key])
            staged = None
            if n:
                staged = prestaged[t] if prestaged is not None \
                    else restage(bid)
            em = state.advance(bid, t, staged=staged) if n or len(state.ob) \
                else None
            if em is not None:
                out.append(self._exec_emission(em))
            state.compact(self.MAX_CHUNKS, restage=restage)
        em = state.flush(t + 1)
        if em is not None:
            out.append(self._exec_emission(em))
        return out

    def _exec_emission(self, em: Emission) -> WindowResult:
        """One emission's sessions through the plan.  Its rows are labelled
        on the device from the emission's dense tables when every involved
        chunk is staged and the closed keys' span fits a table
        (``execute_session_tables``); otherwise (sparse keys, restored
        unstaged chunks, or one key closed twice in one emission) the host
        realizes the rows (``em.to_batch()``) and they run as one window.
        On overflow the aggregate capacity quadruples (``widen_aggregate``)."""
        agg_cap = _pow2_bucket(em.n_sessions)
        dt = None
        if em.merged is not None and em.chunks and \
                all(ch.staged is not None for ch in em.chunks):
            closed = em.merged[0]
            span = int(closed.max()) - int(closed.min()) + 1
            bucket = _pow2_bucket(span + 1)
            if bucket <= _SPAN_LIMIT:
                dt = em.dense_tables(bucket)
        if dt is not None:
            with METRICS.span("driver.window"):
                chunks = [ch.staged for ch in em.chunks]
                cids = [ch.cid for ch in em.chunks]
                b = widen_aggregate(
                    lambda cap: self.executor.execute_session_tables(
                        chunks, SessionState.key, dt, cids, cap), agg_cap)
                return WindowResult(("sessions", em.t),
                                    self.executor.materialize(b))
        bid = em.to_batch()
        rel = self.executor._driving_relation()
        caps = {rel: _pow2_bucket(len(bid["__session"]))}
        self.executor.agg_capacity = agg_cap
        return self._execute_retry(("sessions", em.t), {rel: bid}, caps)


def run_nexmark(query: int, seconds: int = 2, events_per_second: int = 1000,
                generators: int = 1, side_input: dict | None = None,
                device=None) -> list[WindowResult]:
    """End to end: generate → window → execute → materialize, on ``device``
    (``None`` → ``cuda``).  ``side_input`` is q13's table (``None`` →
    ``default_side_input()``)."""
    spec = get_query(query)
    driver = StreamDriver(spec, seconds, side_input=side_input, device=device)
    return driver.run(generate_epochs(seconds, events_per_second, generators))

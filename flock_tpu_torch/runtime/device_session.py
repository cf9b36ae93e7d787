"""Device-resident sessionization: the open-set merge as dense span state —
the counterpart of ``flock_tpu/runtime/device_session.py``.

Reference counterpart: flock-function/src/aws/window/session.rs:64-178 (a
fragment more than ``gap`` seconds after its window's last row closes the
window; idle windows time out as epochs advance).  The generic tier
(``runtime/stream.py`` ``SessionState``) retains rows on the host and
re-aggregates each closed session from label tables; this module
recognizes INCREMENTALLY AGGREGABLE session plans — a single Aggregate over
the driving scan grouped by ``__session`` whose aggregates are all
count/sum/min/max, under at most a top Project that renames its outputs —
and keeps the ENTIRE open-session state as dense per-key accumulators on
the device:

* ``open``/``last_s`` — open-set membership and each key's last row second;
* one [span] accumulator per aggregate (count add, sum add, min/max merge).

One step per epoch (``step_impl``):
  1. grouped count/min/max(/sum) over the epoch's staged rows, slotted at
     the epoch's least key (kernel K2, ``kernels.dense_group_aggregate``);
  2. a CONTIGUOUS window merge into the state accumulators at the epoch's
     offset from the state's base key — a slice, no scatter;
  3. gap-close and timeout as O(span) vector masks (sessions closed by a gap
     emit their pre-merge accumulators; the epoch's rows then seed the
     reopened session — exactly SessionState's chunk-range semantics);
  4. closed sessions compact into a small output buffer by a cumsum rank
     and one binary search (no sort).

Where the reference slices at a device offset (``lax.dynamic_slice``), a
torch slice needs a host integer: the host already knows each epoch's key
range (it sizes the state from it), and that range equals the device's
over the staged valid rows, so the offset and the span check are computed
on the host and the step slices with them.  K2's overflow and the emission
buffer's overflow stay device flags.

Rows are consumed ONCE, the epoch they arrive; no row chunks are retained
and no label tables ship.  Epochs group into chunks of at most ``SCAN_W``
(one host read of their flags per chunk); the next chunk is dispatched
against the previous one's unconfirmed state while its flags are read, and
a flagged chunk rolls back to its retained start state and reruns with
doubled buckets.  The step updates the state's tensors in place, so every
chunk works on a clone of its start state, which stays intact for the
rollback.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from flock_tpu_torch.batch import TS_BASE
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.ops.dense_agg import I32_MAX, I32_MIN
from flock_tpu_torch.runtime.executor import _pow2_bucket, materialize_columns
from flock_tpu_torch.runtime.payload import FragmentId, Payload

# epochs per chunk: one host read of the flags, the rollback granularity
SCAN_W = 16
# closed-session slots of one epoch's emission buffer (doubles on overflow)
CAP_OUT = 8192
# rollbacks one run may take before it gives up
RETRY_BUDGET = 6


# ---------------------------------------------------------------------------
# Plan-shape gate
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FastSessionSpec:
    """A session plan the incremental device path can execute.

    ``aggs`` — the Aggregate's (in_col, fn, out) list; ``renames`` — the
    optional top Project's (out_name, agg_out) passthroughs."""

    aggs: tuple
    renames: tuple | None


def session_fast_spec(spec, key: str, relation: str) -> FastSessionSpec | None:
    """Gate: Project?(Aggregate(Scan(relation), by __session)) with every
    aggregate incrementally mergeable (count/sum/min/max over scan columns or
    the session key) and every projected column an aggregate's output.
    Anything else → None (the generic label-table tier).  The reference
    admits a Project of any column name and then fails on one that is not
    an aggregate's output (``__session`` itself, say) when it names the
    emission's columns; here such a plan takes the generic tier, which has
    the column."""
    from flock_tpu_torch.plan import Aggregate, Project, Scan

    node = spec.plan
    renames = None
    if isinstance(node, Project):
        if not all(isinstance(e, str) for _, e in node.exprs):
            return None
        renames = node.exprs
        node = node.child
    if not (isinstance(node, Aggregate) and node.group_keys == ("__session",)
            and isinstance(node.child, Scan)
            and node.child.relation == relation):
        return None
    for c, fn, _out in node.aggs:
        if fn == "count":
            continue
        if fn not in ("min", "max", "sum") or c in (None, "__session"):
            return None
    if renames is not None:
        outs = {out for _c, _fn, out in node.aggs}
        if not all(src in outs for _, src in renames):
            return None
    return FastSessionSpec(aggs=tuple(node.aggs), renames=renames)


# ---------------------------------------------------------------------------
# Accumulator algebra
# ---------------------------------------------------------------------------


def _acc_plan(fs: FastSessionSpec, key: str, tcol: str):
    """(epoch_aggs, accs) — the per-epoch aggregation list and the state
    accumulators.  ``accs``: name → (epoch_out, fn, dtype, identity).
    Bookkeeping (occupancy count + min/max of the time column → first/last
    second) is always aggregated and shared with same-shaped plan aggs."""
    epoch_aggs = [(None, "count", "__cnt0"), (tcol, "min", "__emn"),
                  (tcol, "max", "__emx")]
    shared = {(None, "count"): "__cnt0", (tcol, "min"): "__emn",
              (tcol, "max"): "__emx"}
    accs: dict[str, tuple] = {}
    for c, fn, out in fs.aggs:
        if c == key and fn in ("min", "max"):
            continue  # an aggregate of the session key IS the slot key
        eff_c = None if fn == "count" else c
        eo = shared.get((eff_c, fn))
        if eo is None:
            eo = f"__e{len(epoch_aggs)}"
            epoch_aggs.append((eff_c, fn, eo))
            shared[(eff_c, fn)] = eo
        if fn == "count":
            accs[out] = (eo, "count", torch.int32, 0)
        elif fn == "sum":
            accs[out] = (eo, "sum", torch.int64, 0)
        elif fn == "min":
            accs[out] = (eo, "min", torch.int32, I32_MAX)
        else:
            accs[out] = (eo, "max", torch.int32, I32_MIN)
    return tuple(epoch_aggs), tuple(sorted(accs.items()))


def _combine(fn: str, a, b):
    if fn in ("count", "sum"):
        return a + b
    return torch.minimum(a, b) if fn == "min" else torch.maximum(a, b)


def _identities(accs) -> dict:
    idents = {"open": (torch.bool, False), "last_s": (torch.int32, I32_MIN)}
    idents.update({name: (dt, ident) for name, (_e, _f, dt, ident) in accs})
    return idents


def init_state(S: int, accs, device) -> dict:
    return {name: torch.full((S,), ident, dtype=dt, device=device)
            for name, (dt, ident) in _identities(accs).items()}


def grow(state: dict, S2: int, accs) -> dict:
    """Pad state arrays to a wider span (base key unchanged); new slots get
    each accumulator's identity."""
    idents = _identities(accs)
    return {name: torch.cat([a, torch.full((S2 - a.shape[0],),
                                           idents[name][1], dtype=a.dtype,
                                           device=a.device)])
            for name, a in state.items()}


# ---------------------------------------------------------------------------
# The per-epoch step
# ---------------------------------------------------------------------------


def step_impl(key: str, tcol: str, epoch_aggs: tuple, accs: tuple,
              SE: int, cap_out: int, may_close: bool, gap_s: int,
              cutoff_s: int, m: int, state: dict, cols: dict, valid,
              krange: tuple | None):
    """One epoch: aggregate → window-merge → gap/timeout close → compact.

    Returns (state, out_cols, out_valid, n_emit, overflow), the last two
    0-d device tensors.  ``state``'s tensors are updated IN PLACE and
    returned (pass a clone to keep the old state).  ``m`` is the state's
    base key (slot i ↔ key m+i); ``cutoff_s`` the timeout threshold in
    relative seconds (now − gap, session.rs:136-178).  ``krange`` is the
    epoch's (least, greatest) key over its valid rows, from the host (None
    for an epoch with no row: nothing merges and K2 does not run); it
    places the epoch's window in the state, which the reference computes on
    the device.  ``may_close=False`` (host-proven: no session can close by
    gap or timeout yet) runs the merge-only form — no closure masks, no
    compaction, no emission buffers."""
    S = state["open"].shape[0]
    dev = state["open"].device
    ovf = kernels.false_flag(dev)
    gap_close = w = None
    emit_w = {}
    if krange is not None:
        # 1. per-epoch grouped aggregation (slot 0 = the epoch's least key)
        e_out, e_occ, e_ovf, _ = kernels.dense_group_aggregate(
            {key: cols[key], **{c: cols[c] for c, _f, _o in epoch_aggs
                                if c is not None}},
            valid, key, list(epoch_aggs), SE)
        first_s = torch.div(e_out["__emn"], 1000, rounding_mode="floor")
        last_s = torch.div(e_out["__emx"], 1000, rounding_mode="floor")
        # 2. contiguous window merge at [SE].  State buffers carry an
        #    SE-slot tail pad beyond the logical key span, so the window
        #    never clamps for in-range epochs; the overflow test is on the
        #    actual greatest key against the logical span
        kmin, kmax = krange
        off = min(max(kmin - m, 0), S - SE)
        w = slice(off, off + SE)
        ovf = e_ovf
        if kmin < m or kmax - m >= S - SE:
            ovf = torch.ones((), dtype=torch.bool, device=dev)
        w_open = state["open"][w]
        w_last = state["last_s"][w]
        if may_close:
            gap_close = e_occ & w_open & (first_s - w_last > gap_s)
            new_start = e_occ & (gap_close | ~w_open)
        else:
            new_start = e_occ & ~w_open
        for name, (eo, fn, dt, _ident) in accs:
            w_acc = state[name][w]
            if may_close:
                emit_w[name] = w_acc.clone()      # pre-merge (old session)
            e_val = e_out[eo].to(dt)
            state[name][w] = torch.where(
                e_occ, torch.where(new_start, e_val,
                                   _combine(fn, w_acc, e_val)), w_acc)
        state["last_s"][w] = torch.where(e_occ, last_s.to(torch.int32),
                                         w_last)
        state["open"][w] |= e_occ

    if not may_close:
        return (state, {}, torch.zeros((0,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev), ovf)

    # 3. closures: gap-closed (pre-merge values, window coords) ∪ timed-out
    #    (post-merge values, full span) — disjoint: a gap-closed key was just
    #    reopened with a fresh last_s and cannot time out this epoch
    to = state["open"] & (state["last_s"] < cutoff_s)
    emask = to.clone()
    if gap_close is not None:
        emask[w] |= gap_close
    state["open"] &= ~to
    evals = {}
    for name, (_eo, _fn, dt, ident) in accs:
        placed = torch.full((S,), ident, dtype=dt, device=dev)
        if w is not None:
            placed[w] = emit_w[name]
        evals[name] = torch.where(to, state[name], placed)
        state[name].masked_fill_(to, ident)

    # 4. compact closed sessions: cumsum rank + binary search (no sort)
    out_cols, out_valid, n_emit = _extract(emask, evals, m, cap_out)
    ovf = kernels.any_flag(ovf, n_emit > cap_out)
    return state, out_cols, out_valid, n_emit, ovf


def session_scan(key: str, tcol: str, epoch_aggs: tuple, accs: tuple,
                 SE: int, cap_out: int, may_close: bool, gap_s: int,
                 t0: int, m: int, state: dict, epochs: list):
    """One chunk of epochs, ``epochs`` a list of (cols, valid, krange) in
    stream order, the step run for each on ``state`` (in place).  Returns
    (state, the epochs' emissions, n_emit [W] int32, overflow [W] bool),
    all left on the device; the caller reads the flags once per chunk."""
    ocs, nes, ovfs = [], [], []
    for w, (cols, valid, krange) in enumerate(epochs):
        state, oc, _ov, ne, ovf = step_impl(
            key, tcol, epoch_aggs, accs, SE, cap_out, may_close, gap_s,
            t0 + w + 1 - gap_s, m, state, cols, valid, krange)
        ocs.append(oc)
        nes.append(ne)
        ovfs.append(ovf)
    return state, ocs, torch.stack(nes), torch.stack(ovfs)


def _extract(emask, evals: dict, m: int, cap_out: int):
    """The closed slots (``emask``) compacted into ``cap_out`` rows: a
    cumsum ranks them, a binary search finds the slot of each rank.
    ``n_emit`` stays on the device."""
    S = emask.shape[0]
    r_inc = torch.cumsum(emask.to(torch.int32), 0, dtype=torch.int32)
    n_emit = r_inc[-1]
    ranks = torch.arange(1, cap_out + 1, dtype=torch.int32,
                         device=emask.device)
    tgt = torch.searchsorted(r_inc, ranks).clamp(max=S - 1)
    out_valid = ranks <= n_emit
    out = {"__key": (tgt + m).to(torch.int32)}
    for name, v in evals.items():
        out[name] = v[tgt]
    return out, out_valid, n_emit


def flush_impl(accs: tuple, cap_out: int, m: int, state: dict):
    """Close every remaining open session (bounded-run semantics)."""
    evals = {name: state[name] for name, _ in accs}
    return _extract(state["open"], evals, m, cap_out)


# ---------------------------------------------------------------------------
# Driver loop
# ---------------------------------------------------------------------------


def _bucket(n: int) -> int:
    c = 1024
    while c < n:
        c *= 2
    return c


def closure_gate(min_ev_seen, ev_mn: int, ev_mx: int, nrows: int, t: int,
                 gap: int) -> tuple:
    """(min_ev_seen', may_close) — the event-time closure-possibility gate.

    Closure possibility is an EVENT-time question: every open session's
    last_s is ≥ the lowest event second tracked (``min_ev_seen``; a resume
    must seed it with from_payloads' ev_floor), so neither a timeout
    (cutoff = t+1-gap must exceed some last_s) nor a gap close (some epoch
    first_s − last_s > gap) can happen until these bounds say so — until
    then the merge-only step form applies."""
    if nrows:
        min_ev_seen = ev_mn if min_ev_seen is None \
            else min(min_ev_seen, ev_mn)
    may_close = min_ev_seen is not None and (
        (t + 1 - gap > min_ev_seen)
        or (bool(nrows) and ev_mx - min_ev_seen > gap))
    return min_ev_seen, may_close


def _event_sec_range(tc) -> tuple:
    """(min, max) EVENT second of a host time column, relative to TS_BASE
    (absolute int64 inputs rebase; already-relative inputs pass through)."""
    if tc is None or not len(tc):
        return (0, 0)
    tmin, tmax = int(np.min(tc)), int(np.max(tc))
    if tmin >= TS_BASE:
        tmin -= TS_BASE
        tmax -= TS_BASE
    return (tmin // 1000, tmax // 1000)


@dataclass
class SessionRunStats:
    """What one ``run_device_sessions`` call did: its chunk dispatches
    (reruns included), host reads of the device flags (one per dispatch
    that is confirmed or rolled back, and the flush's session count),
    rollbacks, and the host's seconds over the per-epoch key and
    event-second ranges."""

    dispatches: int = 0
    flag_reads: int = 0
    retries: int = 0
    meta_s: float = 0.0


def run_device_sessions(driver, epochs, prestaged, fs: FastSessionSpec,
                        resume_payloads=None, t_base: int = 0):
    """The StreamDriver session loop on the incremental device path.

    Epochs group into chunks of ≤ SCAN_W (uniform capacity bucket and
    closure gate); chunk ci+1 is dispatched against ci's unconfirmed output
    state before ci's flags are read (one host read per chunk), and the
    flush is dispatched before the last chunk's read.  A flagged chunk rolls
    back to ITS start state (each chunk runs on a clone of it), doubles the
    buckets, and reruns from there; each epoch is staged once, its batch
    kept until its chunk is confirmed.

    ``resume_payloads`` (checkpoint payloads from ``to_payloads``) makes
    the run a REPLACEMENT worker: the state base/span widen to cover the
    restored keys, the open sessions scatter back in via ``from_payloads``,
    and the closure gate's event floor seeds from the restored minimum
    last-row second.  ``t_base`` is the ABSOLUTE stream epoch of
    ``epochs[0]`` — timeout cutoffs are stream-absolute seconds, so a
    resumed run keeps counting from where the stream is.

    The driving relation is the executor's, whatever its name (the
    reference reads the literal ``bid``).  ``driver.session_stats`` gets
    this run's ``SessionRunStats``."""
    from flock_tpu_torch.runtime.stream import SessionState

    key, tcol = SessionState.key, SessionState.time_col
    gap = driver.spec.window[1]
    rel = driver.executor._driving_relation()
    dev = driver.executor.device
    epoch_aggs, accs = _acc_plan(fs, key, tcol)
    stats = SessionRunStats()
    driver.session_stats = stats

    # host-side per-epoch metadata: key range + EVENT-second range.  The
    # key range places each epoch's window in the state; the event-time
    # range drives the may_close gate (late rows can time out sessions long
    # before gap epochs have arrived)
    t_meta = time.perf_counter()
    metas = []
    for tables in epochs:
        bid = driver._needed_cols(tables[rel], extra=(key, tcol))
        k = bid[key]
        metas.append((len(k), int(k.min()) if len(k) else 0,
                      int(k.max()) if len(k) else -1, bid,
                      *_event_sec_range(bid.get(tcol))))
    stats.meta_s = time.perf_counter() - t_meta

    resume_payloads = list(resume_payloads or [])
    r_keys = np.concatenate(
        [np.asarray(p.columns["__key"]) for p in resume_payloads]) \
        if resume_payloads else np.empty(0, np.int64)

    n_ep = len(epochs)
    first = next((t for t in range(n_ep) if metas[t][0]), None)
    if first is None:
        if not len(r_keys):
            return []
        first = 0   # restored sessions still time out across empty epochs
    # the state base and span come from the GLOBAL key range (restored keys
    # included): a later epoch's key below the first epoch's least key must
    # not strand the base (growth cannot rebase downward)
    kmins = [mn for nn, mn, _mx, *_ in metas if nn]
    kmaxs = [mx for nn, _mn, mx, *_ in metas if nn]
    if len(r_keys):
        kmins.append(int(r_keys.min()))
        kmaxs.append(int(r_keys.max()))
    m = min(kmins)
    kmax_all = max(kmaxs)
    S = _bucket(kmax_all - m + 1 + 8192)
    SE = _bucket(max(max((mx - mn + 1 for nn, mn, mx, *_ in metas if nn),
                         default=1), 1))
    cap_out = CAP_OUT
    # buffers carry an SE-slot tail pad so the step's window merge never
    # clamps (see step_impl); the logical key span stays [m, m+S)
    ev_floor = None
    if resume_payloads:
        state, _ep, ev_floor = from_payloads(resume_payloads, accs, m,
                                             S + SE, dev)
    else:
        state = init_state(S + SE, accs, dev)

    results = []
    need = sorted({key, tcol} | {c for c, _f, _o in epoch_aggs
                                 if c is not None})

    # host-side closure gates for every epoch, then CONSECUTIVE epochs with
    # equal (capacity bucket, gate) group into chunks of ≤ SCAN_W
    gates = []
    mev = ev_floor
    for t in range(n_ep):
        mev, mc = closure_gate(mev, metas[t][4], metas[t][5],
                               metas[t][0], t_base + t, gap)
        gates.append(mc)

    def epoch_cap(t):
        if prestaged is not None and prestaged[t] is not None:
            return prestaged[t].capacity
        return _pow2_bucket(metas[t][0])

    chunks = []   # (t_start, [t...], C, may_close)
    t = first
    while t < n_ep:
        C, mc = epoch_cap(t), gates[t]
        ts = [t]
        t += 1
        while (t < n_ep and len(ts) < SCAN_W and gates[t] == mc
               and epoch_cap(t) == C):
            ts.append(t)
            t += 1
        chunks.append((ts[0], ts, C, mc))

    staged = {}   # epoch → (cols, valid, krange), until its chunk confirms

    def staged_cols(t, C):
        """One epoch's needed columns on the device, staged once."""
        if t not in staged:
            nn, mn, mx = metas[t][:3]
            if nn == 0:
                staged[t] = ({}, None, None)
            else:
                b = prestaged[t] if prestaged is not None \
                    and prestaged[t] is not None \
                    else driver.executor.stage_chunk(metas[t][3], C)
                staged[t] = ({c: b.columns[c] for c in need}, b.valid,
                             (mn, mx))
        return staged[t]

    def dispatch(ci, st):
        t0, ts, C, mc = chunks[ci]
        st2, ocs, nes, ovfs = session_scan(
            key, tcol, epoch_aggs, accs, SE, cap_out, mc, gap, t_base + t0,
            m, {k: v.clone() for k, v in st.items()},
            [staged_cols(t, C) for t in ts])
        # one tensor, so the host reads a chunk's flags in one copy
        flags = torch.cat([nes.to(torch.int64), ovfs.to(torch.int64)])
        return st2, (ci, st, ocs, flags)

    flush_cap = _bucket(max(kmax_all - m + 1, 1))
    ci = 0
    inflight = None   # one unconfirmed chunk: (ci, start_state, ocs, flags)
    flushed = None
    while True:
        if ci < len(chunks):
            state, newly = dispatch(ci, state)
            stats.dispatches += 1
            ci += 1
        else:
            newly = None
            if flushed is None:
                # the flush rides the device queue while the host waits on
                # the last chunk's flags
                flushed = flush_impl(accs, flush_cap, m, state)
        if inflight is not None:
            fci, chunk_start, ocs, flags = inflight
            flags = flags.tolist()
            stats.flag_reads += 1
            W = len(ocs)
            ne_h, ovf_h = flags[:W], flags[W:]
            if any(ovf_h):
                stats.retries += 1
                if stats.retries > RETRY_BUDGET:
                    raise RuntimeError("device session path: retry budget")
                # grow every bucket; the span grows by padding the chunk's
                # start state (the old tail pad becomes part of the logical
                # span — pad slots hold identities, i.e. valid never-opened
                # sessions); the chunk dispatched against this one's
                # corrupt output is discarded
                SE = SE * 2
                cap_out = cap_out * 2
                S2 = S * 2
                state = grow(chunk_start, S2 + SE, accs)
                S = S2
                ci = fci
                inflight = None
                flushed = None
                continue
            if chunks[fci][3]:
                for w, t in enumerate(chunks[fci][1]):
                    if ne_h[w]:
                        results.append((t_base + t, ocs[w], ne_h[w]))
            for t in chunks[fci][1]:
                staged.pop(t, None)
        inflight = newly
        if inflight is None and flushed is not None:
            break

    f_cols, _f_valid, f_n = flushed
    n = int(f_n)
    stats.flag_reads += 1
    if n:
        results.append((t_base + n_ep, f_cols, n))

    return [_materialize(driver, fs, key, et, out_cols, n)
            for et, out_cols, n in results]


def _materialize(driver, fs: FastSessionSpec, key: str, et: int,
                 out_cols: dict, n: int):
    """Readback of the live rows only: the int32 columns ride ONE stacked
    copy to the host, any other column one copy each."""
    from flock_tpu_torch.runtime.stream import WindowResult

    ncols = {}
    i32 = [nm for nm, a in out_cols.items() if a.dtype == torch.int32]
    if i32:
        stacked = torch.stack([out_cols[nm][:n] for nm in i32]).cpu().numpy()
        for i, nm in enumerate(i32):
            ncols[nm] = stacked[i]
    for nm, a in out_cols.items():
        if nm not in i32:
            ncols[nm] = a[:n].cpu().numpy()
    return WindowResult(("sessions", et),
                        materialize_columns(driver.spec,
                                            finish_names(fs, key, ncols)))


def finish_names(fs: FastSessionSpec, key: str, ncols: dict) -> dict:
    """Map raw emission columns (slot ``__key`` + accumulator outs) to the
    plan's output names: aggregates OF the session key read the slot key;
    the top Project's passthrough renames apply last."""
    host = {}
    for c, fn, out in fs.aggs:
        if c == key and fn in ("min", "max"):
            host[out] = ncols["__key"]
        else:
            host[out] = ncols[out]
    if fs.renames is not None:
        host = {name: host[src] for name, src in fs.renames}
    return host


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------


def to_payloads(state: dict, m: int, accs, qid: str, epoch: int):
    """Checkpoint the open sessions through the payload codec.

    Unlike the generic tier (SessionState.to_payloads re-ships every
    retained ROW so the replacement worker can re-aggregate), the device
    tier's state already IS the aggregates: the checkpoint is one payload of
    O(open sessions) — (key, last_s, accumulator...) per open slot.  A
    checkpoint with ZERO open sessions still writes the (empty) payload:
    the epoch watermark must advance, or a crash after every session closed
    would resume from a stale earlier checkpoint and re-emit its windows.
    Reference analogue: the S3 window-state checkpoint (state/s3.rs +
    actor.rs:391-413)."""
    host = {k: v.cpu().numpy() for k, v in state.items()}
    idx = np.flatnonzero(host["open"])
    cols = {"__key": (idx.astype(np.int64) + m),
            "last_s": host["last_s"][idx].astype(np.int64)}
    for name, _spec in accs:
        cols[name] = host[name][idx]
    return [Payload(FragmentId(qid, 0, 1, shuffle_id=0), cols,
                    metadata={"epoch": int(epoch)})]


def from_payloads(payloads, accs, m: int, S_buf: int, device):
    """Restore a device session state (buffer span ``S_buf``, base ``m``)
    on ``device`` from checkpoint payloads.  Returns (state,
    restored_epoch, ev_floor); raises if a restored key falls outside
    [m, m+S_buf).  ``ev_floor`` (None when no sessions were open) is the
    MINIMUM restored last-row second: the resuming driver MUST seed its
    closure gate's event floor with it (the gate is sound only while every
    open session's last_s is ≥ the lowest event second tracked)."""
    payloads = list(payloads)
    if not payloads:
        return init_state(S_buf, accs, device), 0, None
    keys = np.concatenate([np.asarray(p.columns["__key"]) for p in payloads])
    pos = keys - m
    if len(pos) and (pos.min() < 0 or pos.max() >= S_buf):
        raise ValueError("restored session keys outside the state span")
    pos = pos.astype(np.int64)
    open_ = np.zeros(S_buf, bool)
    open_[pos] = True
    last_h = np.concatenate(
        [np.asarray(p.columns["last_s"]) for p in payloads]).astype(np.int32)
    last_s = np.full(S_buf, I32_MIN, np.int32)
    last_s[pos] = last_h
    host = {"open": open_, "last_s": last_s}
    for name, (_eo, _fn, dt, ident) in accs:
        buf = np.full(S_buf, ident,
                      np.int64 if dt == torch.int64 else np.int32)
        buf[pos] = np.concatenate([np.asarray(p.columns[name])
                                   for p in payloads])
        host[name] = buf
    out = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    ev_floor = int(last_h.min()) if len(last_h) else None
    return out, max(p.metadata["epoch"] for p in payloads), ev_floor

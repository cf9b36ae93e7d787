"""Masked columnar operators in plain PyTorch — the counterpart of
``flock_tpu/ops/kernels.py`` for what the ported queries and their
duplicate fallbacks need.

The contract is the reference's: every op is fixed-capacity (``[capacity]``
tensors plus a ``valid`` mask), and an op that can exceed a static output
capacity returns its overflow as a 0-d bool tensor, with no host sync
inside the op.  PyTorch has real scatters (``index_add_``,
``scatter_reduce_``), so the plain forms are scatters; the blocked one-hot
formulations the TPU needed have no counterpart here.  Dense int32
aggregation goes to kernel K2 (``ops/dense_agg.py``), the probe side of a
lookup join to kernel K3 (``ops/gather.py``).  q6's ``rank_in_group`` and
``sorted_segment_aggregate``, the float-key join's ``build_lookup`` and
``sorted_lookup_join`` and the Compact node's ``compact`` are plain
PyTorch, as the reference computes them in XLA, not Pallas.
"""

from __future__ import annotations

from functools import reduce

import torch

from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.ops.dense_agg import K2_FNS as _K2_FNS
from flock_tpu_torch.ops.dense_agg import I32_MAX, dense_agg, dense_agg_plain
from flock_tpu_torch.ops.gather import gather

_FALSE: dict = {}


def false_flag(device) -> torch.Tensor:
    """A 0-d False on ``device``, made once per device and shared: a flag
    that is clear by construction costs no device operation.  Nothing writes
    a flag in place."""
    f = _FALSE.get(device)
    if f is None:
        f = torch.zeros((), dtype=torch.bool, device=device)
        _FALSE[device] = _FALSE[f.device] = f
    return f


def any_flag(*flags: torch.Tensor) -> torch.Tensor:
    """OR of 0-d bool flags, leaving out the shared clear ones
    (``false_flag``): one device operation per flag that can be set."""
    live = [f for f in flags if f is not _FALSE.get(f.device)]
    return reduce(torch.logical_or, live) if live else flags[0]


def _shift_ne(k: torch.Tensor) -> torch.Tensor:
    """True where a row differs from the previous row (row 0 → True)."""
    return torch.cat([torch.ones(1, dtype=torch.bool, device=k.device),
                      k[1:] != k[:-1]])


def sort_rows(cols: dict[str, torch.Tensor], valid: torch.Tensor,
              keys: list[str], descending: tuple[bool, ...] | None = None):
    """Stable multi-key sort; invalid rows sort last.  Returns (cols, valid).
    Least-significant key first, one stable sort per key."""
    descending = descending or (False,) * len(keys)
    key_arrays = [(~valid).to(torch.int8)]
    for k, d in zip(keys, descending):
        key_arrays.append(-cols[k] if d else cols[k])
    perm = torch.arange(valid.shape[0], device=valid.device)
    for k in reversed(key_arrays):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return {n: c[perm] for n, c in cols.items()}, valid[perm]


def compact(cols: dict[str, torch.Tensor], valid: torch.Tensor,
            out_capacity: int):
    """Move live rows to the front of an ``out_capacity``-row buffer,
    keeping their order (the reference's ``compact``: a stable sort on the
    validity flag, the rows past ``out_capacity`` cut off or zero rows
    padded).  Returns (cols, valid, overflow)."""
    n_in = valid.shape[0]
    perm = torch.sort((~valid).to(torch.int8), stable=True).indices
    take = min(out_capacity, n_in)
    out = {}
    for name, arr in cols.items():
        a = arr[perm[:take]]
        if take < out_capacity:
            a = torch.cat([a, a.new_zeros(out_capacity - take)])
        out[name] = a
    n = valid.sum()
    out_valid = torch.arange(out_capacity, device=valid.device) \
        < torch.clamp(n, max=out_capacity)
    return out, out_valid, n > out_capacity


def _dinfo(v: torch.Tensor):
    return torch.finfo(v.dtype) if v.is_floating_point() else torch.iinfo(v.dtype)


def scatter_aggs(seg: torch.Tensor, svalid: torch.Tensor, scols: dict,
                 aggs, out_capacity: int) -> dict[str, torch.Tensor]:
    """Scatter-based aggregation into ``out_capacity`` segments (the
    reference's ``_scatter_aggs``).  ``seg`` is ``out_capacity`` for rows
    that contribute nothing; those land in one spare slot that is cut off.
    Integer sums accumulate in int64 (exact: the sink divides in f64),
    counts and count_sums in int32, min/max in the column's dtype from its
    sentinels."""
    cap1 = out_capacity + 1
    dev = seg.device
    seg = seg.to(torch.int64)

    def full(value, dtype):
        return torch.full((cap1,), value, dtype=dtype, device=dev)

    out = {}
    for in_col, fn, out_name in aggs:
        if fn == "count":
            acc = full(0, torch.int32).index_add_(
                0, seg, torch.ones_like(seg, dtype=torch.int32))
        elif fn == "count_sum":
            acc = full(0, torch.int32).index_add_(
                0, seg, scols[in_col].to(torch.int32))
        elif fn == "sum":
            v = scols[in_col]
            dt = torch.float32 if v.is_floating_point() else torch.int64
            acc = full(0, dt).index_add_(0, seg, v.to(dt))
        elif fn in ("min", "max"):
            v = scols[in_col]
            sent = _dinfo(v).max if fn == "min" else _dinfo(v).min
            acc = full(sent, v.dtype).scatter_reduce_(
                0, seg, v, "amin" if fn == "min" else "amax")
        elif fn.startswith("wmin:"):
            # winner-carry: min(in_col) over the rows attaining the group
            # MAX of the order column after the colon (q6's seller of the
            # winning bid under duplicate fan-out)
            ov = scols[fn[5:]]
            omax = full(_dinfo(ov).min, ov.dtype).scatter_reduce_(
                0, seg, ov, "amax")
            attain = svalid & (seg < out_capacity) & (ov == omax[seg])
            v = scols[in_col]
            seg2 = torch.where(attain, seg, out_capacity)
            acc = full(_dinfo(v).max, v.dtype).scatter_reduce_(
                0, seg2, v, "amin")
        else:
            raise ValueError(fn)
        out[out_name] = acc[:out_capacity]
    return out


def dense_group_aggregate(cols: dict[str, torch.Tensor], valid: torch.Tensor,
                          key: str, aggs, out_capacity: int,
                          rebase: bool = True):
    """Dense-key grouped aggregation: segment id = key − min(valid keys);
    output slot i holds key ``min + i`` (gaps invalid); rows beyond
    ``out_capacity`` slots raise the overflow flag.  Returns (out_cols,
    out_valid, overflow, escape), the flags as 0-d bool tensors.

    int32 keys and columns under count/count_sum/sum/min/max go to kernel K2
    (``dense_agg``).  With ``rebase``, int64 min/max/sum columns first shift
    to window-relative int32 (the reference's rebase branch) and go to K2
    too; a window whose int64 range exceeds int32 sets ``escape`` and its
    answer is void.  The reference picks the scatter answer for it on the
    device (``lax.cond``); here the executor reads the escape flag in the
    window's one host sync and reruns the plan with ``rebase=False``, where
    such columns, like any other dtype and ``wmin:``, take the scatter
    (``dense_agg_plain``)."""
    aggs = list(aggs)
    k = cols[key]
    i64_cols = sorted({c for c, f, _ in aggs
                       if c is not None and cols[c].dtype == torch.int64
                       and f in ("min", "max", "sum")})
    i64_ok = all(c is None or cols[c].dtype == torch.int32 or c in i64_cols
                 for c, _, _ in aggs)
    if rebase and i64_cols and i64_ok and k.dtype == torch.int32:
        big, small = torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min
        cols2, bases = dict(cols), {}
        ok64 = torch.ones((), dtype=torch.bool, device=k.device)
        for c in i64_cols:
            v = cols[c]
            lo = torch.where(valid, v, big).amin()
            hi = torch.where(valid, v, small).amax()
            ok64 = ok64 & ((hi - lo <= 2**31 - 2) | (hi < lo))
            bases[c] = lo
            cols2[c] = (v - lo).clamp(0, 2**31 - 2).to(torch.int32)
        out, ovalid, ovf, _ = dense_group_aggregate(
            cols2, valid, key, aggs + [(None, "count", "__rb_cnt")],
            out_capacity)
        rb_cnt = out.pop("__rb_cnt").to(torch.int64)
        # min/max shift back exactly, sum adds count·base (exact in int64)
        for c, f, name in aggs:
            if c in i64_cols and f in ("min", "max"):
                out[name] = out[name].to(torch.int64) + bases[c]
            elif c in i64_cols and f == "sum":
                out[name] = out[name] + rb_cnt * bases[c]
        return out, ovalid, ovf, ~ok64

    on_k2 = k.dtype == torch.int32 and all(
        f in _K2_FNS and (c is None or cols[c].dtype == torch.int32)
        for c, f, _ in aggs)
    out, ovalid, ovf = (dense_agg if on_k2 else dense_agg_plain)(
        k, valid, cols, aggs, out_capacity)
    out[key] = out.pop("__key")
    return out, ovalid, ovf, false_flag(k.device)


def group_aggregate(cols: dict[str, torch.Tensor], valid: torch.Tensor,
                    group_keys: list[str], aggs, out_capacity: int,
                    rebase: bool = True):
    """Grouped aggregation.  One integer key → ``dense_group_aggregate``
    (``rebase`` is its own); several keys → sort-based: output rows sorted
    by the group keys, one per distinct key tuple, padded to
    ``out_capacity``.  Returns (out_cols, out_valid, overflow, escape)."""
    aggs = list(aggs)
    if len(group_keys) == 1 and not cols[group_keys[0]].is_floating_point():
        return dense_group_aggregate(cols, valid, group_keys[0], aggs,
                                     out_capacity, rebase)
    needed = list(dict.fromkeys(
        list(group_keys)
        + [c for c, f, _ in aggs if f != "count" and c is not None]
        + [f[5:] for _, f, _ in aggs if f.startswith("wmin:")]))
    sub = {k: cols[k] for k in needed}
    if group_keys:
        scols, svalid = sort_rows(sub, valid, list(group_keys))
        boundary = reduce(torch.logical_or,
                          [_shift_ne(scols[k]) for k in group_keys]) & svalid
    else:
        # global aggregate: one segment spanning every live row
        scols, svalid = sub, valid
        boundary = svalid & (torch.cumsum(svalid.to(torch.int64), 0) == 1)
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    seg = torch.where(svalid & (seg < out_capacity), seg, out_capacity)
    n_seg = boundary.sum()
    out = {}
    for k in group_keys:
        out[k] = torch.zeros(out_capacity + 1, dtype=scols[k].dtype,
                             device=seg.device).scatter_(0, seg, scols[k])[:out_capacity]
    out.update(scatter_aggs(seg, svalid, scols, aggs, out_capacity))
    out_valid = torch.arange(out_capacity, device=seg.device) \
        < torch.clamp(n_seg, max=out_capacity)
    return out, out_valid, n_seg > out_capacity, false_flag(seg.device)


def build_lookup(build_cols: dict[str, torch.Tensor], build_valid: torch.Tensor,
                 key: str):
    """Sort the build side by key for binary-search probing.  Invalid rows
    get the ``I32_MAX`` sentinel (in the key's dtype, as the reference's
    ``jnp.where`` casts it) so they sort past any live key; the sort is
    stable and carries every column by its permutation.  Returns
    (sorted_key, sorted_cols, sorted_valid)."""
    k = torch.where(build_valid, build_cols[key], I32_MAX)
    sk, order = torch.sort(k, stable=True)
    return sk, {n: c[order] for n, c in build_cols.items()}, build_valid[order]


def sorted_lookup_join(build_cols: dict[str, torch.Tensor],
                       build_valid: torch.Tensor, build_key: str,
                       probe_cols: dict[str, torch.Tensor],
                       probe_valid: torch.Tensor, probe_key: str,
                       take: dict[str, str]):
    """General-key N-to-1 join (float keys have no dense slot span): sort
    the build side, binary-search the probes (left side, clamped to the
    last row).  A probe row hits when its key equals the found build key,
    that build row is valid and the probe row is valid; duplicate build
    keys give the first match in the stable order only (the reference's
    limit, kept).  Returns (out_cols, hit)."""
    bk, bcols, bvalid = build_lookup(build_cols, build_valid, build_key)
    pk = probe_cols[probe_key]
    dt = torch.promote_types(bk.dtype, pk.dtype)
    idx = torch.searchsorted(bk.to(dt), pk.to(dt)).clamp(max=bk.shape[0] - 1)
    hit = (bk[idx] == pk) & bvalid[idx] & probe_valid
    out = dict(probe_cols)
    for src, dst in take.items():
        out[dst] = bcols[src][idx]
    return out, hit


def lookup_join(build_cols: dict[str, torch.Tensor], build_valid: torch.Tensor,
                build_key: str, probe_cols: dict[str, torch.Tensor],
                probe_valid: torch.Tensor, probe_key: str,
                take: dict[str, str], out_capacity: int | None = None,
                span_margin: int | None = None, build_slotted: bool = False,
                dup_expand: bool = True, fallback: bool = False):
    """Inner join: probe rows keep their slots and gather the matched build
    columns (kernel K3, ``ops/gather.py``); unmatched probe rows become
    invalid.  Three modes, as in the reference:

    * ``build_slotted``: the build side is already a dense-slot aggregate
      output (slot i holds key ``bk[0] + i``, one row per slot), reused as
      it stands — no slotting, no duplicate check;
    * ``dup_expand=False`` (a declared-unique build, q13's side input): the
      build is slotted by key with ``dense_group_aggregate`` (kernel K2: max
      of the taken columns and the ``dups`` flag), and duplicate keys raise
      overflow;
    * duplicate-faithful (the default): slotted the same way, and duplicate
      keys raise ``escape``.  The executor's rerun lowers the plan with
      ``fallback=True``, where every build row beyond the first with the
      same key emits one more joined row into the free slots of an
      ``out_capacity``-row output (DataFusion hash-join semantics, the
      sort-merge fan-out below); extras beyond the free slots raise
      overflow (callers widen and retry).  The reference picks the fan-out
      on the device (``lax.cond``); here a clean window never runs it.

    Returns (out_cols, out_valid, overflow, escape) at ``n`` rows for a
    slotted or unique build, else at ``max(out_capacity, n)``.  K3 gathers
    at most 8 taken columns, and the clean duplicate-faithful pass carries
    at most 32 other probe columns in the same launch (``gather``'s limits;
    more raise NotImplementedError, on the CPU too).  ``fallback``
    also aggregates int64 slot columns by scatter, never rebased (the
    ``rebase`` of ``dense_group_aggregate``, whose escape rides along).
    """
    if span_margin is None:
        span_margin = CONFIG.join_span_margin
    bk = build_cols[build_key]
    take_list = list(take)
    dev = bk.device
    if build_slotted:
        slots, present, m = build_cols, build_valid, bk[0]
        ovf_b = esc = has_dups = false_flag(dev)
    else:
        slot_aggs = [(src, "max", src) for src in take_list] \
            + [(None, "dups", "__dups")]
        slots, present, ovf_b, esc = dense_group_aggregate(
            {build_key: bk, **{src: build_cols[src] for src in take_list}},
            build_valid, build_key, slot_aggs, bk.shape[0] + span_margin,
            rebase=not fallback)
        has_dups = slots.pop("__dups")
        m = slots[build_key][0]   # min(valid build keys), the key of slot 0

    pk = probe_cols[probe_key]
    n = pk.shape[0]
    expand = dup_expand and not build_slotted
    E = n if out_capacity is None or not expand else max(out_capacity, n)

    if not (expand and fallback):
        # one K3 launch writes the whole output: at E > n (a clean
        # duplicate-faithful window) it also carries the probe columns a
        # taken column does not replace and zero-pads everything to E rows
        taken = {take[src]: slots[src] for src in take_list}
        carry = None
        if E > n:
            carry = {c: col for c, col in probe_cols.items() if c not in taken}
        res, hit = gather(taken, present, m, pk, probe_valid, out_rows=E,
                          carry=carry)
        out = {c: res.get(c, col) for c, col in probe_cols.items()}
        out.update(res)
        if expand:
            return out, hit, ovf_b, any_flag(esc, has_dups)
        return out, hit, any_flag(ovf_b, has_dups), esc

    def pad(a):
        if E == n:
            return a
        return torch.cat([a, torch.zeros(E - n, dtype=a.dtype, device=dev)])

    # the fan-out: sort the build side by key, locate each probe key's range
    # with two binary searches, emit the first duplicate in the probe's own
    # slot and every further one into the free slots (ranks enumerated with
    # cumsums and a rank → probe-row binary search: static shapes, no
    # multiplicity bound)
    nb = bk.shape[0]
    skey = torch.where(build_valid, bk, I32_MAX)
    order = torch.sort(skey, stable=True).indices
    sk, svb = skey[order], build_valid[order]
    lo = torch.searchsorted(sk, pk)
    hi = torch.searchsorted(sk, pk, right=True)
    loc = lo.clamp(max=nb - 1)
    hit0 = probe_valid & (sk[loc] == pk) & svb[loc]
    hit0E = pad(hit0)
    extras = torch.where(hit0, hi - lo - 1, 0)
    r_inc = torch.cumsum(extras, 0)
    n_extras = r_inc[-1]
    excl = r_inc - extras
    free = ~hit0E
    freerank = torch.cumsum(free.to(torch.int64), 0) - 1
    is_extra = free & (freerank < n_extras)
    f = torch.where(is_extra, freerank, 0)
    src = torch.searchsorted(r_inc, f, right=True).clamp(max=n - 1)
    bsrc = (lo[src] + f - excl[src] + 1).clamp(0, nb - 1)
    ex_ovf = n_extras > free.sum()

    out = {c: torch.where(is_extra, col[src], pad(col))
           for c, col in probe_cols.items()}
    for src_name in take_list:
        sb = build_cols[src_name][order]
        out[take[src_name]] = torch.where(is_extra, sb[bsrc], pad(sb[loc]))
    return out, hit0E | is_extra, any_flag(ovf_b, ex_ovf), esc


def _runs(start: torch.Tensor):
    """(run, first): each row's run id and the index of its run's first row,
    runs beginning where ``start`` is set (rows before the first run: run
    -1, first 0).  ``first`` is the reference's running max of the start
    indices (``lax.cummax``); ``torch.cummax`` takes 0.6 ms on 248 k rows on
    the H100 (PERF.md), so each run's first index is scattered to the
    run's id and gathered back instead."""
    n = start.shape[0]
    idx = torch.arange(n, device=start.device)
    run = torch.cumsum(start.to(torch.int64), 0) - 1
    first = torch.zeros(n + 1, dtype=torch.int64, device=start.device)
    first.scatter_(0, torch.where(start, run, n), idx)
    return run, torch.where(run >= 0, first[run.clamp(min=0)], 0)


def rank_in_group(cols: dict[str, torch.Tensor], valid: torch.Tensor,
                  group_key: str, order_col: str, descending: bool,
                  rank_name: str, tiebreak: str | None = None):
    """ROW_NUMBER() OVER (PARTITION BY group_key ORDER BY order_col), 1-based
    (the reference's ``rank_in_group``): rows sort by (group asc, order asc
    or desc, tiebreak asc), invalid rows last, and each row's rank is its
    index less its segment's first index, plus one.  The output stays
    sorted.  Returns (cols with ``rank_name``, valid)."""
    keys = [group_key, order_col] + ([tiebreak] if tiebreak else [])
    desc = (False, descending) + ((False,) if tiebreak else ())
    scols, svalid = sort_rows(cols, valid, keys, desc)
    _, first = _runs(_shift_ne(scols[group_key]) & svalid)
    idx = torch.arange(svalid.shape[0], device=svalid.device)
    return {**scols, rank_name: (idx - first + 1).to(torch.int32)}, svalid


def sorted_segment_aggregate(cols: dict[str, torch.Tensor],
                             valid: torch.Tensor, key: str, aggs):
    """Grouped aggregation over rows already sorted by ``key`` (a Rank's
    output), the reference's contract: each run of equal keys is a group,
    invalid rows inside it contribute nothing, the group's aggregate lands
    on the run's last row and every other row is invalid, the input's
    capacity is kept, and it never overflows.  Returns (out_cols, out_valid,
    overflow).

    The reference's segmented scans become prefix sums: a row's running
    value is the inclusive ``cumsum`` less the exclusive one at its run's
    first row (``_runs``), all in int64, so
    counts and integer sums are exact (count and count_sum wrap to int32 as
    the reference's int32 scans do).  PyTorch has no segmented min/max scan:
    min, max and float sums scatter onto the run id (``scatter_reduce_``,
    ``index_add_``) and gather back, exact on every run's last row."""
    k = cols[key]
    n = k.shape[0]
    dev = k.device
    change = k[1:] != k[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    start, end = torch.cat([one, change]), torch.cat([change, one])
    run, first = _runs(start)

    def running_sum(v):
        inclusive = torch.cumsum(v, 0)
        return inclusive - (inclusive - v)[first]

    cnt = running_sum(valid.to(torch.int64)).to(torch.int32)
    out = {key: k}
    for in_col, fn, out_name in aggs:
        if fn == "count":
            out[out_name] = cnt
            continue
        v = cols[in_col]
        if fn in ("count_sum", "sum") and not v.is_floating_point():
            s = running_sum(torch.where(valid, v.to(torch.int64), 0))
            out[out_name] = s.to(torch.int32) if fn == "count_sum" else s
        elif fn == "sum":
            acc = torch.zeros(n, dtype=torch.float32, device=dev).index_add_(
                0, run, torch.where(valid, v.to(torch.float32), 0.0))
            out[out_name] = acc[run]
        elif fn in ("min", "max"):
            sent = _dinfo(v).max if fn == "min" else _dinfo(v).min
            acc = torch.full((n,), sent, dtype=v.dtype, device=dev)
            acc.scatter_reduce_(0, run, torch.where(valid, v, sent),
                                "amin" if fn == "min" else "amax")
            out[out_name] = acc[run]
        else:
            raise ValueError(fn)
    return out, end & (cnt > 0), false_flag(dev)


def slot_join(build_cols: dict[str, torch.Tensor], build_valid: torch.Tensor,
              build_key: str, probe_cols: dict[str, torch.Tensor],
              probe_valid: torch.Tensor, probe_key: str, take: dict[str, str]):
    """Join two slot-dense relations (both ``dense_group_aggregate``
    outputs: slot i holds key ``col[0] + i``, gaps invalid) over the same
    key domain — q8's new persons ⋈ distinct sellers.  Probe slot i meets
    build slot ``i + offset``, ``offset`` the difference of the two slot-0
    keys: the join is one shifted contiguous copy per taken column and a
    mask AND, no probing.  The offset arithmetic is the reference's (int64
    difference cast to int32, the start clamped into the zero padding on
    either side), so sides that do not overlap, or a side with no valid row
    (its slot-0 key is the sentinel), give only misses.  Returns (out_cols,
    hit, overflow)."""
    pcap, bcap = probe_valid.shape[0], build_valid.shape[0]
    dev = probe_valid.device
    m_b = build_cols[build_key][0].to(torch.int64)
    m_p = probe_cols[probe_key][0].to(torch.int64)
    offset = (m_p - m_b).to(torch.int32)
    start = (offset + pcap).clamp(0, bcap + pcap).to(torch.int64) - pcap
    idx = start + torch.arange(pcap, device=dev)
    inside = (idx >= 0) & (idx < bcap)
    src = torch.where(inside, idx, 0)

    def shifted(arr):
        return torch.where(inside, arr[src], arr.new_zeros(()))

    hit = probe_valid & shifted(build_valid)
    out = dict(probe_cols)
    for s_name, dst in take.items():
        out[dst] = shifted(build_cols[s_name])
    return out, hit, false_flag(dev)

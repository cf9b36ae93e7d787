"""K1 — fused lookup join + filter + grouped aggregation: the wrapper over
``csrc/join_agg.cu``, its plain PyTorch version, and its launch counter.

Counterpart of ``flock_tpu/pallas/join_agg.py`` ``fused_join_aggregate``
(with the int64 rebasing of ``fused_join_aggregate_rebased``), whose contract
is also ``ops/blocked.py`` ``blocked_join_aggregate``: probe rows whose key
hits a present slot of a slot-dense build table form pairs, pairs that pass
the predicate aggregate into the slot (count / count_sum / sum / min / max
over probe or gathered build columns), slot i holds key ``m + i``, and
joined rows are never built.

The predicate is an inspectable conjunction of ``(lhs_col, op, rhs_col)``
comparisons (``plan.Conj``): the plain version calls it on the column dict,
the kernel reads its ``terms``.  A predicate without terms (an arbitrary
callable) raises on a CUDA tensor — it never falls back to the plain
version there.

Columns are int32, with two exceptions.  An int64 column that the
predicate compares (a timestamp) is rebased to int32 first.  An int64
probe column that only ``max`` aggregates and nothing compares (q6's
``__order = price << 32 | (2³² − 1 − b_date_time)``) passes through as it
stands: its maximum is exact over every int64 value, into an int64 output
that holds ``INT64_MIN`` where no pair landed — the identity of the plain
version's scatter.  The reference keeps that accumulator on its XLA path
(``pallas/join_agg.py:23-25``); the port has no such path, so K1 holds it.
Any other int64 aggregate (sum, min, a slot column, a compared column)
raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from flock_tpu_torch.ops import _build
from flock_tpu_torch.ops.dense_agg import AGG_CODES, FNS, slot_keys

_OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "==": 4, "!=": 5}
_MAX_COLS, _MAX_TERMS, _MAX_AGGS, _MAX_PROBE = 16, 8, 8, 4
_I64_SPAN = 2**31 - 2
# the kernel's code for max over an int64 probe column (enum Fn in
# csrc/warp_agg.cuh), outside K2's codes; such a column has side 2 in the
# packed column table (1 slot, 0 int32 probe)
_MAX64 = 5


def _compared(pred) -> set[str] | None:
    """The columns an inspectable predicate compares; None for a callable,
    whose reads are unknown."""
    if pred is None:
        return set()
    terms = getattr(pred, "terms", None)
    return None if terms is None else {c for lhs, _, rhs in terms
                                       for c in (lhs, rhs)}


def unsupported_aggs(slot_cols, probe_cols, pred, aggs) -> list[str]:
    """The aggregated columns K1 cannot take: any but int32, except an
    int64 probe column under ``max`` that the predicate (inspectable)
    does not compare."""
    compared = _compared(pred)
    bad = []
    for c, fn, _ in aggs:
        if fn == "count":
            continue
        v = slot_cols[c] if c in slot_cols else probe_cols[c]
        wide_max = (fn == "max" and v.dtype == torch.int64
                    and c not in slot_cols and compared is not None
                    and c not in compared)
        if v.dtype != torch.int32 and not wide_max:
            bad.append(c)
    return bad


def _rebase_i64(slot_cols, present, probe_cols, probe_valid, compared):
    """The int64 columns in ``compared`` (timestamps; every int64 column
    when ``compared`` is None) shift by one shared base — the minimum over
    live values — to int32, which keeps comparisons between them exact.
    Returns (slot_cols, probe_cols, escape): ``escape`` is set when the live
    values span 2³¹ or more (the ``_rebased`` contract)."""
    from flock_tpu_torch.ops.kernels import false_flag  # kernels imports us

    def rebased(cols):
        return [k for k, v in cols.items() if v.dtype == torch.int64
                and (compared is None or k in compared)]

    i64_p, i64_s = rebased(probe_cols), rebased(slot_cols)
    if not i64_p and not i64_s:
        return slot_cols, probe_cols, false_flag(present.device)
    big, small = torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min
    pairs = [(probe_cols[k], probe_valid) for k in i64_p] \
        + [(slot_cols[k], present) for k in i64_s]
    base = torch.stack([torch.where(v, c, big).amin() for c, v in pairs]).amin()
    hi = torch.stack([torch.where(v, c, small).amax() for c, v in pairs]).amax()
    # empty window: hi < base, nothing to compare
    ok64 = (hi - base <= _I64_SPAN) | (hi < base)

    def rb(v):
        return (v - base).clamp(0, _I64_SPAN).to(torch.int32)

    pc = {k: rb(v) if k in i64_p else v for k, v in probe_cols.items()}
    sc = {k: rb(v) if k in i64_s else v for k, v in slot_cols.items()}
    return sc, pc, ~ok64


def join_agg_plain(slot_cols, present, m, probe_cols, probe_valid, probe_key,
                   pred, aggs):
    """The plain version: gather, predicate, scatter.  Returns (out_cols
    with ``__key``, out_valid)."""
    from flock_tpu_torch.ops.kernels import scatter_aggs  # kernels imports us

    span = present.shape[0]
    rel = probe_cols[probe_key].to(torch.int64) - m.to(torch.int64)
    in_span = probe_valid & (rel >= 0) & (rel < span)
    relc = torch.where(in_span, rel, 0)
    pair = in_span & present[relc]
    cols = dict(probe_cols)
    cols.update({k: v[relc] for k, v in slot_cols.items()})
    if pred is not None:
        pair = pair & pred(cols)
    seg = torch.where(pair, relc, span)
    out = scatter_aggs(seg, pair, cols,
                       list(aggs) + [(None, "count", "__cnt")], span)
    cnt = out.pop("__cnt")
    out["__key"] = slot_keys(m, span, torch.int32)
    return out, cnt > 0


def _check(slot_cols, present, probe_cols, probe_valid, probe_key, terms,
           aggs):
    """Every column the kernel reads: the probe key, the compared columns
    and the aggregated ones, int32 but for the int64 probe columns under
    ``max`` that ``unsupported_aggs`` admitted."""
    n, span = probe_valid.shape[0], present.shape[0]
    dev = present.device

    def vec(t, dtype, size, what):
        if t.dtype != dtype or t.shape != (size,) or t.device != dev \
                or not t.is_contiguous():
            raise TypeError(f"join_agg: {what} must be a contiguous "
                            f"{dtype} [{size}] on {dev}")

    vec(probe_valid, torch.bool, n, "probe_valid")
    vec(present, torch.bool, span, "present")
    if probe_key not in probe_cols:
        raise KeyError(f"join_agg: probe key {probe_key}")
    vec(probe_cols[probe_key], torch.int32, n, "probe key")
    wide = {c for c, fn, _ in aggs if fn == "max" and c not in slot_cols
            and c in probe_cols and probe_cols[c].dtype == torch.int64}
    read = [c for lhs, _, rhs in terms for c in (lhs, rhs)] \
        + [c for c, fn, _ in aggs if fn != "count"]
    for c in read:
        if c in slot_cols:
            vec(slot_cols[c], torch.int32, span, f"slot column {c}")
        elif c in probe_cols:
            vec(probe_cols[c], torch.int64 if c in wide else torch.int32, n,
                f"probe column {c}")
        else:
            raise KeyError(f"join_agg: unknown column {c}")
    for c, fn, _ in aggs:
        if fn not in FNS:
            raise NotImplementedError(f"join_agg: aggregate {fn!r}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("join_agg")
    if not getattr(lib, "_flock_argtypes", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.flock_join_agg.argtypes = [vp, vp, i64, vp, vp, i64, i32, i32, i32,
                                       vp, vp, vp, vp, vp]
        lib.flock_join_agg.restype = ctypes.c_int
        lib._flock_argtypes = True
    return lib


def wide_cols(slot_cols, probe_cols, aggs) -> tuple[str, ...]:
    """The int64 probe columns that only ``max`` aggregates: K1 takes them
    as they stand (code ``_MAX64``, side 2)."""
    return tuple(c for c, fn, _ in aggs if fn == "max" and c not in slot_cols
                 and probe_cols[c].dtype == torch.int64)


def fits_kernel(slot_names, wide, terms, aggs) -> bool:
    """K1's static limits, the one rule of the fused gate
    (``plan.fused_supported``) and of the kernel's codes (``_codes``): at
    most ``_MAX_COLS`` columns read (compared or aggregated; a slot name
    reads the slot column), ``_MAX_TERMS`` comparisons, ``_MAX_AGGS``
    aggregates besides ``count`` and ``_MAX_PROBE`` int32 probe columns
    (``wide`` columns take none of those registers).  It holds on every
    device, so the CPU and the card lower the same plan."""
    names = dict.fromkeys([c for lhs, _, rhs in terms for c in (lhs, rhs)]
                          + [c for c, fn, _ in aggs if fn != "count"])
    probe = [c for c in names if c not in slot_names and c not in wide]
    return (len(names) <= _MAX_COLS and len(terms) <= _MAX_TERMS
            and sum(fn != "count" for _, fn, _ in aggs) <= _MAX_AGGS
            and len(probe) <= _MAX_PROBE)


@lru_cache(maxsize=256)
def _codes(slot_names: tuple, probe_names: tuple, wide: tuple, terms: tuple,
           aggs: tuple):
    """The kernel's column table and codes for one call signature, cached:
    (names of the columns the kernel reads, their sides, the packed codes
    ``sides + terms + (fn, column) pairs``).  A name on both sides reads the
    slot column, as the plain version.  ``wide`` names the int64 probe
    columns, which only ``max`` aggregates (code ``_MAX64``, side 2): they
    take no register of the kernel's ``_MAX_PROBE``."""
    names: list[str] = []

    def col(name):
        if name not in slot_names and name not in probe_names:
            raise KeyError(f"join_agg: unknown column {name}")
        if name not in names:
            names.append(name)
        return names.index(name)

    term_codes = []
    for lhs, op, rhs in terms:
        if op not in _OPS:
            raise NotImplementedError(f"join_agg: comparison {op!r}")
        if lhs in wide or rhs in wide:
            raise NotImplementedError("join_agg: an int64 probe column is "
                                      "compared unrebased")
        term_codes += [col(lhs), _OPS[op], col(rhs)]
    agg_codes = []
    for c, fn, _ in aggs:
        if fn == "count":
            continue
        if c in wide and fn != "max":
            raise NotImplementedError(f"join_agg: {fn} of an int64 column")
        agg_codes += [_MAX64 if c in wide else AGG_CODES[fn], col(c)]
    if not fits_kernel(slot_names, wide, terms, aggs):
        raise NotImplementedError(
            "join_agg: too many columns, terms, aggregates or probe columns "
            f"(at most {_MAX_PROBE}) for the kernel")
    sides = tuple(1 if c in slot_names else 2 if c in wide else 0
                  for c in names)
    return tuple(names), sides, sides + tuple(term_codes + agg_codes)


def _launch(slot_cols, present, m, probe_cols, probe_valid, probe_key, pred,
            aggs):
    """One cooperative launch; the outputs are ``torch.empty`` and the
    kernel initialises them, writes the slot keys and out_valid."""
    terms = getattr(pred, "terms", None) if pred is not None else ()
    if terms is None:
        raise NotImplementedError(
            "join_agg: the kernel reads only conjunctions of column "
            f"comparisons (plan.Conj), got {pred!r}")
    wide = wide_cols(slot_cols, probe_cols, aggs)
    names, sides, codes = _codes(tuple(slot_cols), tuple(probe_cols), wide,
                                 tuple(terms), tuple(aggs))
    dev, span, n = present.device, present.shape[0], probe_valid.shape[0]

    def empty(dtype):
        return torch.empty(span, dtype=dtype, device=dev)

    cnt, key, ovalid = empty(torch.int32), empty(torch.int32), empty(torch.bool)
    out, outs = {}, []
    for c, fn, name in aggs:
        if fn == "count":
            out[name] = cnt
        else:
            wide_out = fn == "sum" or c in wide
            out[name] = acc = empty(torch.int64 if wide_out else torch.int32)
            outs.append(acc.data_ptr())
    out["__key"] = key
    if span:
        ptrs = [(slot_cols[c] if side == 1 else probe_cols[c]).data_ptr()
                for c, side in zip(names, sides)]
        args = [*ptrs, *codes, *outs]
        lib = _lib()
        with _build.on_device(dev):
            rc = lib.flock_join_agg(
                probe_cols[probe_key].data_ptr(), probe_valid.data_ptr(), n,
                present.data_ptr(), m.data_ptr(), span, len(names), len(terms),
                len(outs), (ctypes.c_int64 * len(args))(*args), cnt.data_ptr(),
                key.data_ptr(), ovalid.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "join_agg")
        join_aggregate.launches += 1
    return out, ovalid


def join_aggregate(slot_cols: dict[str, torch.Tensor], present: torch.Tensor,
                   m: torch.Tensor, probe_cols: dict[str, torch.Tensor],
                   probe_valid: torch.Tensor, probe_key: str, pred, aggs):
    """K1.  ``slot_cols``: [span] build columns, slot-dense; ``present``:
    bool [span]; ``m``: 0-d int32 device tensor, the key of slot 0;
    ``probe_cols``: [n] columns; ``pred``: ``plan.Conj`` or None.  CPU
    tensors take :func:`join_agg_plain`; CUDA tensors launch the kernel or
    raise.  Returns (out_cols with ``__key``, out_valid, escape) — escape
    only carries the int64 range check; there is no locality escape."""
    aggs = list(aggs)
    bad = unsupported_aggs(slot_cols, probe_cols, pred, aggs)
    if bad:
        raise NotImplementedError(
            "join_agg: aggregated columns must be int32, or int64 probe "
            f"columns under max that nothing compares; got {bad}")
    slot_cols, probe_cols, escape = _rebase_i64(
        slot_cols, present, probe_cols, probe_valid, _compared(pred))
    _check(slot_cols, present, probe_cols, probe_valid, probe_key,
           getattr(pred, "terms", None) or (), aggs)
    if m.dtype != torch.int32 or m.dim() != 0 or m.device != present.device:
        raise TypeError("join_agg: m must be a 0-d int32 tensor on the "
                        "slots' device")
    if present.device.type == "cpu":
        out, valid = join_agg_plain(slot_cols, present, m, probe_cols,
                                    probe_valid, probe_key, pred, aggs)
    elif present.device.type == "cuda":
        out, valid = _launch(slot_cols, present, m, probe_cols, probe_valid,
                             probe_key, pred, aggs)
    else:
        raise TypeError(f"join_agg: unsupported device {present.device}")
    return out, valid, escape


join_aggregate.launches = 0

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


def _rebase_i64(slot_cols, present, probe_cols, probe_valid):
    """int64 columns (timestamps) shift by one shared base — the minimum
    over live values — to int32, which keeps comparisons between them exact.
    Returns (slot_cols, probe_cols, escape): ``escape`` is set when the live
    int64 values span 2³¹ or more (the ``_rebased`` contract)."""
    from flock_tpu_torch.ops.kernels import false_flag  # kernels imports us

    i64_p = [k for k, v in probe_cols.items() if v.dtype == torch.int64]
    i64_s = [k for k, v in slot_cols.items() if v.dtype == torch.int64]
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


def _check(slot_cols, present, probe_cols, probe_valid, probe_key, aggs):
    n, span = probe_valid.shape[0], present.shape[0]
    dev = present.device

    def vec(t, dtype, size, what):
        if t.dtype != dtype or t.shape != (size,) or t.device != dev \
                or not t.is_contiguous():
            raise TypeError(f"join_agg: {what} must be a contiguous "
                            f"{dtype} [{size}] on {dev}")

    vec(probe_valid, torch.bool, n, "probe_valid")
    vec(present, torch.bool, span, "present")
    for k, v in probe_cols.items():
        vec(v, torch.int32, n, f"probe column {k}")
    for k, v in slot_cols.items():
        vec(v, torch.int32, span, f"slot column {k}")
    if probe_key not in probe_cols:
        raise KeyError(f"join_agg: probe key {probe_key}")
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


@lru_cache(maxsize=256)
def _codes(slot_names: tuple, probe_names: tuple, terms: tuple, aggs: tuple):
    """The kernel's column table and codes for one call signature, cached:
    (names of the columns the kernel reads, their sides, the packed codes
    ``sides + terms + (fn, column) pairs``).  A name on both sides reads the
    slot column, as the plain version."""
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
        term_codes += [col(lhs), _OPS[op], col(rhs)]
    agg_codes = []
    for c, fn, _ in aggs:
        if fn != "count":
            agg_codes += [AGG_CODES[fn], col(c)]
    sides = tuple(int(c in slot_names) for c in names)
    if len(names) > _MAX_COLS or len(terms) > _MAX_TERMS \
            or len(agg_codes) // 2 > _MAX_AGGS \
            or len(sides) - sum(sides) > _MAX_PROBE:
        raise NotImplementedError(
            "join_agg: too many columns, terms, aggregates or probe columns "
            f"(at most {_MAX_PROBE}) for the kernel")
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
    names, sides, codes = _codes(tuple(slot_cols), tuple(probe_cols),
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
            out[name] = acc = empty(torch.int64 if fn == "sum" else torch.int32)
            outs.append(acc.data_ptr())
    out["__key"] = key
    if span:
        ptrs = [(slot_cols[c] if side else probe_cols[c]).data_ptr()
                for c, side in zip(names, sides)]
        args = [*ptrs, *codes, *outs]
        lib = _lib()
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
    i64_aggs = [c for c, fn, _ in aggs if fn != "count" and (
        (c in slot_cols and slot_cols[c].dtype != torch.int32)
        or (c not in slot_cols and probe_cols[c].dtype != torch.int32))]
    if i64_aggs:
        raise NotImplementedError(
            f"join_agg: aggregated columns must be int32, got {i64_aggs}")
    slot_cols, probe_cols, escape = _rebase_i64(slot_cols, present,
                                                probe_cols, probe_valid)
    _check(slot_cols, present, probe_cols, probe_valid, probe_key, aggs)
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

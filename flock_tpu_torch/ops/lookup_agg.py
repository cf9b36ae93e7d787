"""K4 — filter, unique lookup and count by a taken build column in one probe
pass: the wrapper over ``csrc/lookup_agg.cu``, its plain PyTorch version,
and its launch counter.

K4 replaces no TPU kernel.  It fuses the port's chain for an ``Aggregate``
of counts whose one group key is a column a ``unique_build`` join takes
from its build side (YSB's views per campaign): the probe side's filter
(ATen compares), the join's gather of the taken column (K3) and the count
by it (K2).  The group is a function of the join key, so each probe row's
group is found through the build's slot table and counted there, and the
filter mask, the gathered column and the joined rows are never written
(``plan.FusedLookupAggregate``).

Contract.  The build side is slot-dense, as K2's build slotting leaves it:
slot s holds key ``m + s``, ``present[s]`` marks the slots that hold a
build row and ``taken[s]`` is that row's taken value.  ``cmin`` is the
least taken value over the present slots (``I32_MAX`` when none is).  A
probe row counts when it is valid, passes every term of ``pred`` (a
``plan.Conj`` over the probe columns, a term comparing a column with a
column or an integer), its key's slot is present and its group
``taken - cmin`` lies below ``out_capacity``.  The output is that of
``dense_group_aggregate`` over the joined rows: per slot i the count
(int32) of group ``cmin + i``, the slot keys and ``valid = count > 0``.
``escape`` is set when the taken values of the present slots span more
than ``out_capacity`` slots; the caller then reruns the unfused plan.
"""

from __future__ import annotations

import ctypes
import struct
from functools import lru_cache

import torch

from flock_tpu_torch.ops import _build
from flock_tpu_torch.ops.dense_agg import I32_MAX, LANES_BYTES, slot_keys

# comparison codes of the kernel (the order of csrc/lookup_agg.cu's Op)
OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3, "==": 4, "!=": 5}
_MAX_COLS, _MAX_TERMS = 4, 8


def fits(out_capacity: int, pred) -> bool:
    """The kernel's static limits: 32 lane-private int32 copies of every
    output slot within ``LANES_BYTES`` (K2's budget for the same table),
    at most ``_MAX_COLS`` columns compared and ``_MAX_TERMS`` terms, every
    literal an int32.  The lowering holds every device to it, so the CPU
    and the card lower the same plan."""
    terms = () if pred is None else pred.terms
    ncols = 0 if pred is None else len(pred.columns())
    return (0 < out_capacity and out_capacity * 32 * 4 <= LANES_BYTES
            and ncols <= _MAX_COLS and len(terms) <= _MAX_TERMS
            and all(isinstance(rhs, str) or -2**31 <= rhs < 2**31
                    for _, _, rhs in terms))


def lookup_agg_plain(taken, present, m, probe_key, probe_valid, cols, pred,
                     out_capacity: int):
    """The plain version: compose each slot's group, look the probes up,
    mask and scatter.  Returns (count, key, valid, escape)."""
    cap, span = out_capacity, present.shape[0]
    # cmin is I32_MAX and the width negative where no slot is present
    cmin = torch.where(present, taken, I32_MAX).amin()
    width = torch.where(present, taken, -I32_MAX - 1).amax().to(
        torch.int64) - cmin.to(torch.int64)
    rel = probe_key.to(torch.int64) - m.to(torch.int64)
    ok = probe_valid & (rel >= 0) & (rel < span)
    if pred is not None:
        ok = ok & pred(cols)
    relc = torch.where(ok, rel, 0)
    group = taken[relc].to(torch.int64) - cmin.to(torch.int64)
    hit = ok & present[relc] & (group < cap)
    seg = torch.where(hit, group, cap)
    cnt = torch.zeros(cap + 1, dtype=torch.int32,
                      device=present.device).index_add_(
        0, seg, torch.ones_like(seg, dtype=torch.int32))[:cap]
    return cnt, slot_keys(cmin, cap, torch.int32), cnt > 0, width >= cap


@lru_cache(maxsize=64)
def _codes(pred, out_capacity: int) -> tuple[tuple, tuple]:
    """(the columns ``pred`` reads, the kernel's codes of its terms: lhs
    column, operator, rhs column or literal, 1 for a literal), cached by
    call signature; raises past the kernel's limits (``fits``)."""
    if not fits(out_capacity, pred):
        raise NotImplementedError(
            f"lookup_agg: {out_capacity} slots or the terms of {pred!r} "
            "exceed the kernel's limits")
    names = () if pred is None else tuple(pred.columns())
    codes = []
    for lhs, op, rhs in () if pred is None else pred.terms:
        lit = not isinstance(rhs, str)
        codes += (names.index(lhs), OPS[op],
                  rhs if lit else names.index(rhs), int(lit))
    return names, tuple(codes)


def _check(taken, present, m, probe_key, probe_valid, cols, pred,
           out_capacity):
    """Refuse what the kernel does not take; returns ``_codes``."""
    names, codes = _codes(pred, out_capacity)
    span, n = present.shape[0], probe_key.shape[0]
    where = present.get_device()
    vecs = [(present, span, "present", torch.bool),
            (taken, span, "taken", torch.int32),
            (probe_key, n, "probe key", torch.int32),
            (probe_valid, n, "probe valid", torch.bool)]
    for c in names:
        if c not in cols:
            raise KeyError(f"lookup_agg: the predicate reads {c}, not given")
        vecs.append((cols[c], n, f"column {c}", torch.int32))
    for t, size, what, dtype in vecs:
        if t.dtype is not dtype or t.shape != (size,) \
                or t.get_device() != where or not t.is_contiguous():
            raise TypeError(f"lookup_agg: {what} must be a contiguous "
                            f"{dtype} [{size}] on {present.device}")
    if m.dtype is not torch.int32 or m.dim() != 0 or m.get_device() != where:
        raise TypeError("lookup_agg: m must be a 0-d int32 tensor on the "
                        "slots' device")
    if span == 0 or span >= 2**31:
        raise ValueError(f"lookup_agg: build span {span}")
    return names, codes


_fn = None


def _kernel():
    """``flock_lookup_agg`` of the built library, its argument types set
    once."""
    global _fn
    if _fn is None:
        fn = _build.load("lookup_agg").flock_lookup_agg
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def lookup_aggregate(taken: torch.Tensor, present: torch.Tensor,
                     m: torch.Tensor, probe_key: torch.Tensor,
                     probe_valid: torch.Tensor, cols: dict, pred,
                     out_capacity: int):
    """K4.  ``taken``: int32 [span], the slot-dense build's taken column;
    ``present``: bool [span]; ``m``: 0-d int32 device tensor, the key of
    slot 0; ``probe_key``: int32 [n]; ``probe_valid``: bool [n]; ``cols``:
    the int32 [n] probe columns ``pred`` (a ``plan.Conj`` or None) reads.
    CPU tensors take :func:`lookup_agg_plain`; CUDA tensors launch the
    kernel or raise.  Returns (count int32 [cap], key int32 [cap], valid
    bool [cap], escape 0-d bool), with no host sync.

    On the card the call is two launches: one block composes each slot's
    group and zeroes the counts, then the probe pass counts and writes
    the rest.  Every output is ``torch.empty``, which the kernels fill."""
    names, codes = _check(taken, present, m, probe_key, probe_valid, cols,
                          pred, out_capacity)
    dev = present.device
    if dev.type == "cpu":
        return lookup_agg_plain(taken, present, m, probe_key, probe_valid,
                                cols, pred, out_capacity)
    if dev.type != "cuda":
        raise TypeError(f"lookup_agg: unsupported device {dev}")
    cap, span = out_capacity, present.shape[0]
    # counts, slot keys, then the scratch: 4 words of state and the group
    # of every slot; out_valid, then the escape flag
    ints = torch.empty(2 * cap + 4 + span, dtype=torch.int32, device=dev)
    flags = torch.empty(cap + 1, dtype=torch.bool, device=dev)
    at, fl = ints.data_ptr(), flags.data_ptr()
    index = present.get_device()
    args = [probe_key.data_ptr(), probe_valid.data_ptr(), probe_key.shape[0],
            taken.data_ptr(), present.data_ptr(), m.data_ptr(), span, cap,
            at, at + 4 * cap, fl, fl + cap, at + 8 * cap,
            torch._C._cuda_getCurrentRawStream(index), index, len(names),
            len(codes) // 4, *(cols[c].data_ptr() for c in names), *codes]
    with _build.on_device(dev):
        rc = _kernel()(struct.pack(f"{len(args)}q", *args))
    if rc:
        _build.check(_build.load("lookup_agg"), rc, "lookup_agg")
    lookup_aggregate.launches += 1
    return ints[:cap], ints[cap:2 * cap], flags[:cap], flags[cap]


lookup_aggregate.launches = 0

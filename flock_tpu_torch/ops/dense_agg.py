"""K2 — dense-key grouped aggregation: the wrapper over ``csrc/dense_agg.cu``,
its plain PyTorch version, and its launch counter.

Counterpart of ``flock_tpu/pallas/factored.py`` ``pallas_factored_agg`` (and
of ``pallas/agg.py`` ``pallas_local_agg``, ``ops/blocked.py``
``blocked_local_agg`` / ``full_onehot_agg``): grouped count / count_sum /
sum / min / max over int32 keys, slot i holding key ``min(valid keys) + i``,
overflow when a valid key lies at or beyond ``min + out_capacity``.  There is
no locality escape: the kernel handles any key in the span.

On q4's path K2 slots the auction table by ``a_id`` (max of the taken
columns and the ``dups`` flag) and computes the per-category sum + count.

The kernel accumulates in one of three variants, which
:func:`accumulator_variant` picks from the capacity and the aggregates'
widths alone: ``lanes`` (32 lane-private copies of every slot in shared
memory: YSB's count over 128 slots), ``shared`` (one copy of every slot in
shared memory: q4's per-category sum and count) and ``global`` (atomics
into the outputs: build slotting).
"""

from __future__ import annotations

import ctypes

import torch

from flock_tpu_torch.ops import _build

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)

FNS = ("count", "count_sum", "sum", "min", "max")
# K2 also takes ``dups`` (no column): a 0-d bool, set when some slot counted
# more than one row — a build side's duplicate keys, read by the lookup join
# and the fused pass without a reduction of their own
K2_FNS = FNS + ("dups",)
# aggregate codes of both kernels (enum Fn in csrc/warp_agg.cuh); count is
# the row count itself and never reaches a kernel
AGG_CODES = {"count_sum": 1, "sum": 2, "min": 3, "max": 4}
_MAX_AGGS = 8
# int32 entries of the per-block minima, and so the most blocks one launch
# takes (132 SMs x 4 resident blocks on the H100 fit)
_GRID_MAX = 1024
# the accumulation variants, by their codes in csrc/dense_agg.cu (enum Variant)
VARIANTS = ("global", "shared", "lanes")
# shared-memory bytes of one copy of a slot's accumulator, by aggregate; the
# row count takes 4 more
_SLOT_BYTES = {"count_sum": 4, "sum": 8, "min": 4, "max": 4}
# the block-shared table's limit: what a block takes without opting in
SHARED_BYTES = 48 * 1024
# the budget of the lane-private table (32 copies of every slot), measured on
# the H100 (PERF.md): YSB's count (16 KB) gains 2.1x at 100 M rows,
# while q4's per-category pass (48 KB, ~250 k rows) lost 15 % to the
# table's initialisation and flush, and keeps the block-shared variant
LANES_BYTES = 32 * 1024


def min_valid(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """0-d ``min(keys[valid])`` on the keys' device (dtype max when none)."""
    sentinel = torch.iinfo(keys.dtype).max
    if keys.numel() == 0:
        return torch.full((), sentinel, dtype=keys.dtype, device=keys.device)
    return torch.where(valid, keys, sentinel).amin()


def slot_keys(m: torch.Tensor, out_capacity: int, dtype) -> torch.Tensor:
    return (m.to(torch.int64)
            + torch.arange(out_capacity, device=m.device)).to(dtype)


def dense_agg_plain(keys, valid, agg_cols, aggs, out_capacity: int):
    """The plain version: the same contract as a PyTorch scatter.  It takes
    any key and column dtype and ``wmin:`` as well, and so is also
    ``kernels.dense_group_aggregate``'s scatter path.  Returns (out_cols with
    ``__key``, out_valid, overflow)."""
    from flock_tpu_torch.ops.kernels import scatter_aggs  # kernels imports us

    m = min_valid(keys, valid)
    rel = keys.to(torch.int64) - m.to(torch.int64)
    in_range = valid & (rel >= 0) & (rel < out_capacity)
    overflow = (valid & ~in_range).any()
    seg = torch.where(in_range, rel, out_capacity)
    out = scatter_aggs(seg, in_range, agg_cols,
                       [a for a in aggs if a[1] != "dups"]
                       + [(None, "count", "__cnt")], out_capacity)
    cnt = out.pop("__cnt")
    for _, fn, name in aggs:
        if fn == "dups":
            out[name] = (cnt > 1).any()
    out["__key"] = slot_keys(m, out_capacity, keys.dtype)
    return out, cnt > 0, overflow


def _check(keys, valid, agg_cols, aggs, out_capacity):
    n = keys.shape[0]
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise TypeError("dense_agg: keys must be a contiguous int32 vector")
    if valid.dtype != torch.bool or valid.shape != (n,) \
            or valid.device != keys.device or not valid.is_contiguous():
        raise TypeError("dense_agg: valid must be a contiguous bool [n] "
                        "on the keys' device")
    for c, fn, _ in aggs:
        if fn not in K2_FNS:
            raise NotImplementedError(f"dense_agg: aggregate {fn!r}")
        if fn in ("count", "dups"):
            continue
        col = agg_cols[c]
        if col.dtype != torch.int32 or col.shape != (n,) \
                or col.device != keys.device or not col.is_contiguous():
            raise TypeError(f"dense_agg: column {c} must be a contiguous "
                            "int32 [n] on the keys' device")
    if out_capacity <= 0 or out_capacity >= 2**31:
        raise ValueError(f"dense_agg: out_capacity {out_capacity}")


def accumulator_variant(out_capacity: int, aggs) -> str:
    """The variant one launch of K2 accumulates in, from ``out_capacity``
    and the kinds of ``aggs`` (their widths) alone: ``lanes`` where 32
    copies of every slot fit ``LANES_BYTES``, else ``shared`` where one
    copy fits ``SHARED_BYTES``, else ``global``."""
    slot = 4 + sum(_SLOT_BYTES.get(fn, 0) for _, fn, _ in aggs)
    if out_capacity * 32 * slot <= LANES_BYTES:
        return "lanes"
    if out_capacity * slot <= SHARED_BYTES:
        return "shared"
    return "global"


def _lib() -> ctypes.CDLL:
    lib = _build.load("dense_agg")
    if not getattr(lib, "_flock_argtypes", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.flock_dense_agg.argtypes = [vp, vp, i64, i32, i32, vp, vp, vp, vp,
                                        vp, vp, i32, i32, vp]
        lib.flock_dense_agg.restype = ctypes.c_int
        lib._flock_argtypes = True
    return lib


def dense_agg(keys: torch.Tensor, valid: torch.Tensor,
              agg_cols: dict[str, torch.Tensor], aggs, out_capacity: int):
    """K2.  CPU tensors take :func:`dense_agg_plain`; CUDA tensors launch the
    kernel or raise.  Returns (out_cols with ``__key``, out_valid, overflow
    as a 0-d bool tensor — no host sync).  The kernel holds at most
    ``_MAX_AGGS`` aggregates (``AGG_CODES``), so a longer list splits into
    launches of that many over the same keys and valid mask; ``count``,
    ``dups``, ``__key``, out_valid and the overflow flag come from the
    first, since every launch slots alike (slot i holds key min + i).  On
    the CPU each part takes the plain version, so both devices run the
    same split."""
    aggs = list(aggs)
    _check(keys, valid, agg_cols, aggs, out_capacity)
    if keys.device.type == "cpu":
        launch = dense_agg_plain
    elif keys.device.type == "cuda":
        launch = _launch
    else:
        raise TypeError(f"dense_agg: unsupported device {keys.device}")
    coded = [a for a in aggs if a[1] in AGG_CODES]
    first = [a for a in aggs if a[1] not in AGG_CODES] + coded[:_MAX_AGGS]
    out, ovalid, overflow = launch(keys, valid, agg_cols, first, out_capacity)
    for i in range(_MAX_AGGS, len(coded), _MAX_AGGS):
        more, _, _ = launch(keys, valid, agg_cols, coded[i:i + _MAX_AGGS],
                            out_capacity)
        del more["__key"]
        out.update(more)
    return out, ovalid, overflow


def _launch(keys, valid, agg_cols, aggs, out_capacity: int):
    """One launch of K2 for at most ``_MAX_AGGS`` kernel aggregates: the
    outputs are ``torch.empty`` and the kernel computes the minimum key and
    writes every output and flag itself."""
    if sum(fn in AGG_CODES for _, fn, _ in aggs) > _MAX_AGGS:
        raise NotImplementedError(
            f"dense_agg: more than {_MAX_AGGS} aggregates in one launch")
    dev = keys.device

    def empty(dtype, size=out_capacity):
        return torch.empty(size, dtype=dtype, device=dev)

    cnt, key, ovalid = empty(torch.int32), empty(torch.int32), empty(torch.bool)
    flags = empty(torch.bool, 2)          # overflow, duplicates
    scratch = empty(torch.int32, _GRID_MAX)
    out, packed = {}, []
    for c, fn, name in aggs:
        if fn == "count":
            out[name] = cnt
        elif fn == "dups":
            out[name] = flags[1]
        else:
            acc = empty(torch.int64 if fn == "sum" else torch.int32)
            out[name] = acc
            packed += (AGG_CODES[fn], agg_cols[c].data_ptr(), acc.data_ptr())
    out["__key"] = key
    variant = accumulator_variant(out_capacity, aggs)
    lib = _lib()
    with _build.on_device(dev):
        rc = lib.flock_dense_agg(
            keys.data_ptr(), valid.data_ptr(), keys.shape[0], out_capacity,
            len(packed) // 3, (ctypes.c_int64 * len(packed))(*packed),
            cnt.data_ptr(), key.data_ptr(), ovalid.data_ptr(), flags.data_ptr(),
            scratch.data_ptr(), _GRID_MAX, VARIANTS.index(variant),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "dense_agg")
    dense_agg.launches += 1
    dense_agg.variant_launches[variant] += 1
    return out, ovalid, flags[0]


dense_agg.launches = 0
# launches by accumulation variant, so that a run shows which one it took
dense_agg.variant_launches = dict.fromkeys(VARIANTS, 0)

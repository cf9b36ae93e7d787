"""K3 — probe-side gather of a lookup join: the wrapper over
``csrc/gather.cu``, its plain PyTorch version, and its launch counter.

Counterpart of ``flock_tpu/pallas/factored.py`` ``pallas_factored_gather``,
whose contract is also ``ops/blocked.py`` ``blocked_local_join``: the build
side is slot-dense (slot i holds key ``m + i``, ``present`` marks the slots
that hold a build row), and every probe row gathers the taken slot columns
plus a hit flag — valid, key inside the span, slot present.  Gathered values
under a miss are 0 (the reference leaves them unspecified; the caller masks
them).  There is no locality escape: the kernel handles any key in the span.

What bounds it on the card is bytes (probe keys and flags in, gathered
columns and hit out, the slot columns read at most once); see the source.
On the slice's path K3 gathers q3's person columns, q9's winning price and
q13's side-input value to the probe rows (``kernels.lookup_join``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flock_tpu_torch.ops import _build

_MAX_COLS = 8


def gather_plain(slot_cols: dict[str, torch.Tensor], present: torch.Tensor,
                 m: torch.Tensor, probe_keys: torch.Tensor,
                 probe_valid: torch.Tensor):
    """The plain version: index with ``torch.where(ok, rel, 0)`` and mask.
    Returns (gathered columns, hit)."""
    span = present.shape[0]
    rel = probe_keys.to(torch.int64) - m.to(torch.int64)
    ok = probe_valid & (rel >= 0) & (rel < span)
    relc = torch.where(ok, rel, 0)
    hit = ok & present[relc]
    return {k: torch.where(hit, v[relc], 0) for k, v in slot_cols.items()}, hit


def _check(slot_cols, present, m, probe_keys, probe_valid):
    n, span = probe_keys.shape[0], present.shape[0]
    dev = present.device

    def vec(t, size, what, dtypes):
        if t.dtype not in dtypes or t.shape != (size,) or t.device != dev \
                or not t.is_contiguous():
            raise TypeError(f"gather: {what} must be a contiguous "
                            f"{'/'.join(map(str, dtypes))} [{size}] on {dev}")

    vec(present, span, "present", (torch.bool,))
    vec(probe_keys, n, "probe keys", (torch.int32,))
    vec(probe_valid, n, "probe valid", (torch.bool,))
    for k, v in slot_cols.items():
        if v.element_size() not in (4, 8) or v.dtype == torch.bool:
            raise TypeError(f"gather: slot column {k} must have 4- or 8-byte "
                            f"elements, got {v.dtype}")
        vec(v, span, f"slot column {k}", (v.dtype,))
    if m.dtype != torch.int32 or m.dim() != 0 or m.device != dev:
        raise TypeError("gather: m must be a 0-d int32 tensor on the slots' "
                        "device")
    if span == 0:
        raise ValueError("gather: the build span is empty")
    if len(slot_cols) > _MAX_COLS:
        raise NotImplementedError(f"gather: more than {_MAX_COLS} columns")


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather")
    if not getattr(lib, "_flock_argtypes", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.flock_gather.argtypes = [vp, vp, i64, vp, vp, i64, i32, vp, vp, vp,
                                     vp, vp]
        lib.flock_gather.restype = ctypes.c_int
        lib._flock_argtypes = True
    return lib


def gather(slot_cols: dict[str, torch.Tensor], present: torch.Tensor,
           m: torch.Tensor, probe_keys: torch.Tensor, probe_valid: torch.Tensor):
    """K3.  ``slot_cols``: [span] columns of 4- or 8-byte elements;
    ``present``: bool [span]; ``m``: 0-d int32 device tensor, the key of
    slot 0; ``probe_keys``: int32 [n]; ``probe_valid``: bool [n].  CPU
    tensors take :func:`gather_plain`; CUDA tensors launch the kernel or
    raise.  Returns (gathered columns [n], hit bool [n])."""
    _check(slot_cols, present, m, probe_keys, probe_valid)
    if present.device.type == "cpu":
        return gather_plain(slot_cols, present, m, probe_keys, probe_valid)
    if present.device.type != "cuda":
        raise TypeError(f"gather: unsupported device {present.device}")
    dev, n = present.device, probe_keys.shape[0]
    out = {k: torch.empty(n, dtype=v.dtype, device=dev)
           for k, v in slot_cols.items()}
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        lib = _lib()
        widths_h = np.asarray([v.element_size() for v in slot_cols.values()],
                              np.int32)
        cols_h = np.asarray([v.data_ptr() for v in slot_cols.values()], np.int64)
        outs_h = np.asarray([v.data_ptr() for v in out.values()], np.int64)
        rc = lib.flock_gather(
            probe_keys.data_ptr(), probe_valid.data_ptr(), n,
            present.data_ptr(), m.data_ptr(), present.shape[0], len(out),
            widths_h.ctypes.data, cols_h.ctypes.data, outs_h.ctypes.data,
            hit.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "gather")
        gather.launches += 1
    return out, hit


gather.launches = 0

"""K3 — probe-side gather of a lookup join: the wrapper over
``csrc/gather.cu``, its plain PyTorch version, and its launch counter.

Counterpart of ``flock_tpu/pallas/factored.py`` ``pallas_factored_gather``,
whose contract is also ``ops/blocked.py`` ``blocked_local_join``: the build
side is slot-dense (slot i holds key ``m + i``, ``present`` marks the slots
that hold a build row), and every probe row gathers the taken slot columns
plus a hit flag — valid, key inside the span, slot present.  Gathered values
under a miss are 0 (the reference leaves them unspecified; the caller masks
them).  There is no locality escape: the kernel handles any key in the span.

With ``out_rows`` (E >= n) and ``carry`` (probe columns), the same launch
writes the whole output of the reference's clean duplicate-faithful join
(``flock_tpu/ops/kernels.py`` ``clean_branch``): gathered columns, hit and
the carried columns at E rows, rows n..E zero and not hit.

What bounds it on the card is bytes (probe keys and flags in, gathered
columns and hit out, the slot columns read at most once); see the source.
On the slice's path K3 gathers q3's person columns (with q3's auction
columns carried), q9's winning price and q13's side-input value to the
probe rows (``kernels.lookup_join``).
"""

from __future__ import annotations

import ctypes
import struct

import torch

from flock_tpu_torch.ops import _build

_MAX_COLS = 8
_MAX_CARRY = 32


def gather_plain(slot_cols: dict[str, torch.Tensor], present: torch.Tensor,
                 m: torch.Tensor, probe_keys: torch.Tensor,
                 probe_valid: torch.Tensor, out_rows: int | None = None,
                 carry: dict[str, torch.Tensor] | None = None):
    """The plain version: index with ``torch.where(ok, rel, 0)`` and mask,
    then add the carried columns and zero-pad everything to ``out_rows``.
    Returns (gathered and carried columns, hit)."""
    span, n = present.shape[0], probe_keys.shape[0]
    rel = probe_keys.to(torch.int64) - m.to(torch.int64)
    ok = probe_valid & (rel >= 0) & (rel < span)
    relc = torch.where(ok, rel, 0)
    hit = ok & present[relc]
    out = {k: torch.where(hit, v[relc], 0) for k, v in slot_cols.items()}
    out.update(carry or {})
    rows = n if out_rows is None else out_rows
    if rows == n:
        return out, hit

    def pad(a):
        return torch.cat([a, a.new_zeros(rows - n)])

    return {k: pad(v) for k, v in out.items()}, pad(hit)


def _check(slot_cols, present, m, probe_keys, probe_valid, out_rows, carry):
    """Refuse what the kernel does not take; returns the output rows."""
    n, span = probe_keys.shape[0], present.shape[0]
    dev = present.device
    for t, size, what, dtype in ((present, span, "present", torch.bool),
                                 (probe_keys, n, "probe keys", torch.int32),
                                 (probe_valid, n, "probe valid", torch.bool)):
        if t.dtype is not dtype or t.shape != (size,) or t.device != dev \
                or not t.is_contiguous():
            raise TypeError(f"gather: {what} must be a contiguous {dtype} "
                            f"[{size}] on {dev}")
    for group, size, widths in ((slot_cols, span, (4, 8)),
                                (carry, n, (1, 2, 4, 8))):
        for k, v in group.items():
            if v.element_size() not in widths:
                raise TypeError(f"gather: column {k} must have "
                                f"{'/'.join(map(str, widths))}-byte "
                                f"elements, got {v.dtype}")
            if v.shape != (size,) or v.device != dev or not v.is_contiguous():
                raise TypeError(f"gather: column {k} must be a contiguous "
                                f"{v.dtype} [{size}] on {dev}")
    if m.dtype is not torch.int32 or m.dim() != 0 or m.device != dev:
        raise TypeError("gather: m must be a 0-d int32 tensor on the slots' "
                        "device")
    if span == 0:
        raise ValueError("gather: the build span is empty")
    if len(slot_cols) > _MAX_COLS or len(carry) > _MAX_CARRY:
        raise NotImplementedError(f"gather: more than {_MAX_COLS} gathered or "
                                  f"{_MAX_CARRY} carried columns")
    if carry and not slot_cols.keys().isdisjoint(carry):
        raise ValueError("gather: a carried column has a gathered column's "
                         "name")
    rows = n if out_rows is None else out_rows
    if rows < n:
        raise ValueError(f"gather: out_rows {rows} below the {n} probe rows")
    return rows


def _empty_outputs(slot_cols, carry, rows, dev):
    """Uninitialised [rows] outputs, gathered then carried, and the hit flag:
    one ``torch.empty`` per dtype, a [k, rows] block unbound into its k rows
    when k > 1, each row 16-byte aligned.  On the card's host one more
    allocation or slice costs 3-5 us of Python and ATen, one more unbound row
    less (PERF.md)."""
    groups: dict[torch.dtype, list[str]] = {}
    for cols in (slot_cols, carry):
        for k, v in cols.items():
            groups.setdefault(v.dtype, []).append(k)
    made = {}
    for dt, names in groups.items():
        if len(names) == 1:
            made[names[0]] = torch.empty(rows, dtype=dt, device=dev)
            continue
        pitch = (rows + 15) & ~15
        block = torch.empty((len(names), pitch), dtype=dt, device=dev)
        made.update(zip(names, (block if pitch == rows
                                else block[:, :rows]).unbind(0)))
    hit = torch.empty(rows, dtype=torch.bool, device=dev)
    if len(groups) == 1:
        return made, hit
    return {k: made[k] for cols in (slot_cols, carry) for k in cols}, hit


_fn = None


def _kernel():
    """``flock_gather`` of the built library, its argument types set once."""
    global _fn
    if _fn is None:
        fn = _build.load("gather").flock_gather
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gather(slot_cols: dict[str, torch.Tensor], present: torch.Tensor,
           m: torch.Tensor, probe_keys: torch.Tensor, probe_valid: torch.Tensor,
           out_rows: int | None = None,
           carry: dict[str, torch.Tensor] | None = None):
    """K3.  ``slot_cols``: [span] columns of 4- or 8-byte elements;
    ``present``: bool [span]; ``m``: 0-d int32 device tensor, the key of
    slot 0; ``probe_keys``: int32 [n]; ``probe_valid``: bool [n];
    ``out_rows``: the output rows E >= n (default n); ``carry``: probe
    columns [n] of any 1/2/4/8-byte dtype, copied to the outputs and
    zero-padded to E rows (their names must differ from the gathered ones).
    CPU tensors take :func:`gather_plain`; CUDA tensors launch the kernel or
    raise.  Returns (gathered and carried columns [E], hit bool [E]).

    On the card the call is one launch into ``torch.empty`` outputs, every
    byte of which the kernel writes."""
    carry = {} if carry is None else carry
    rows = _check(slot_cols, present, m, probe_keys, probe_valid, out_rows,
                  carry)
    dev = present.device
    if dev.type == "cpu":
        return gather_plain(slot_cols, present, m, probe_keys, probe_valid,
                            out_rows, carry)
    if dev.type != "cuda":
        raise TypeError(f"gather: unsupported device {dev}")
    out, hit = _empty_outputs(slot_cols, carry, rows, dev)
    if rows:
        index = present.get_device()
        args = [probe_keys.data_ptr(), probe_valid.data_ptr(),
                present.data_ptr(), m.data_ptr(), hit.data_ptr(),
                torch._C._cuda_getCurrentRawStream(index), index,
                probe_keys.shape[0], rows, present.shape[0], len(slot_cols),
                len(carry)]
        for cols in (slot_cols, carry):
            for k, v in cols.items():
                args += (v.element_size(), v.data_ptr(), out[k].data_ptr())
        with _build.on_device(dev):
            rc = _kernel()(struct.pack(f"{len(args)}q", *args))
        if rc:
            _build.check(_build.load("gather"), rc, "gather")
        gather.launches += 1
    return out, hit


gather.launches = 0

"""Columnar batch — the torch counterpart of ``flock_tpu/batch.py``.

A :class:`Batch` is a fixed-capacity struct-of-arrays: a dict of
``[capacity]`` tensors plus a bool ``valid`` mask; padding rows are invalid.
Operators are masked (filters clear validity bits), exactly as in the
reference package, so both engines see the same capacities and slots.

Dtype policy (shared with the reference): ids/prices/codes int32;
timestamps int32 milliseconds since the stream base time (sinks add
``TS_BASE`` back); money float32 on the device with exact f64 recomputed at
the sink from integer columns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from flock_tpu_torch import resolve_device
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.datagen.nexmark import BASE_TIME

TS_BASE = BASE_TIME  # sinks add this back to int32 relative-ms timestamps

# columns this long take the native staging pass (as in the reference)
_NATIVE_MIN_ROWS = 1 << 16


def round_up(n: int, m: int | None = None) -> int:
    m = m or CONFIG.capacity_round
    return ((n + m - 1) // m) * m


def staged_numpy(cols: Mapping[str, np.ndarray], capacity: int | None = None,
                 rebase_ts: bool = True,
                 alloc: Callable[[np.dtype, int], np.ndarray] | None = None):
    """(padded host columns, valid mask) — the transfer-buffer staging pass
    (copy of ``flock_tpu.batch.staged_numpy``): int64 ms timestamps at or
    above ``TS_BASE`` rebase to int32 relative ms, other int64 columns
    narrow, and every column zero-pads to ``capacity``.  ``alloc(dtype, n)``
    supplies the destination buffers (e.g. views of pinned host tensors)."""
    from flock_tpu_torch import native

    alloc = alloc or (lambda dt, n: np.empty(n, dt))
    n = len(next(iter(cols.values()))) if cols else 0
    if capacity is None:
        capacity = max(round_up(n), 128)
    if n > capacity:
        raise ValueError(f"{n} rows exceed capacity {capacity}")
    out = {}
    for name, arr in cols.items():
        arr = np.asarray(arr)
        if arr.ndim != 1:
            raise ValueError(f"column {name} is not 1-D")
        dt = np.dtype(np.int32) if arr.dtype == np.int64 else arr.dtype
        dst = alloc(dt, capacity)
        base = 0
        if arr.dtype == np.int64 and rebase_ts and arr.size:
            mn = native.min_i64(arr) if n >= _NATIVE_MIN_ROWS else int(arr.min())
            base = TS_BASE if mn >= TS_BASE else 0
        if n >= _NATIVE_MIN_ROWS:
            native.stage_column(arr, capacity, base, out=dst)
        else:
            dst[:n] = (arr - base) if base else arr
            dst[n:] = 0
        out[name] = dst
    valid = np.zeros(capacity, dtype=bool)
    valid[:n] = True
    return out, valid


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


@dataclass
class Batch:
    """Fixed-capacity columnar batch with validity mask."""

    columns: dict[str, torch.Tensor]
    valid: torch.Tensor  # bool[capacity]

    @classmethod
    def from_numpy(cls, cols: Mapping[str, np.ndarray],
                   capacity: int | None = None, device=None,
                   rebase_ts: bool = True) -> "Batch":
        """Pad host columns to ``capacity`` rows on ``device`` (``None`` →
        ``cuda``).  For the card, columns are staged straight into pinned
        host buffers and copied without blocking the host."""
        dev = resolve_device(device)
        if dev.type == "cpu":
            out, valid = staged_numpy(cols, capacity, rebase_ts)
            return cls({k: torch.from_numpy(v) for k, v in out.items()},
                       torch.from_numpy(valid))
        pinned = []

        def alloc(dt, n):
            t = torch.empty(n, dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                            pin_memory=True)
            pinned.append(t)
            return t.numpy()

        out, valid = staged_numpy(cols, capacity, rebase_ts, alloc=alloc)
        columns = {k: t.to(dev, non_blocking=True)
                   for k, t in zip(out, pinned)}
        n = int(valid.sum())
        return cls(columns, torch.arange(len(valid), device=dev) < n)

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def to_numpy(self, restore_ts: tuple[str, ...] = ()) -> dict[str, np.ndarray]:
        """Compact to live rows on the host; named int32 ts columns are
        restored to absolute int64 ms.  All columns and the mask travel in
        ONE device-to-host copy (their bytes concatenated on the device)."""
        names = list(self.columns)
        tensors = [self.valid] + [self.columns[n] for n in names]
        flat = torch.cat([t.contiguous().view(torch.uint8) for t in tensors])
        host = flat.cpu().numpy()
        arrays, off = [], 0
        for t in tensors:
            nbytes = t.numel() * t.element_size()
            arrays.append(host[off:off + nbytes].view(_np_dtype(t.dtype)))
            off += nbytes
        valid = arrays[0]
        out = {}
        for name, h in zip(names, arrays[1:]):
            h = h[valid]
            if name in restore_ts:
                h = h.astype(np.int64) + TS_BASE
            out[name] = h
        return out


@dataclass
class Schema:
    """Host-side metadata: column order, dictionaries (the vocabulary of
    each dictionary-coded column) and timestamp columns, in the reference's
    field order, with its ``decode`` (the CLI's ``--show`` and the sinks).

    ``f64_recompute`` maps an output column to an exact float64 recompute
    recipe applied at the sink from carried integer basis columns:
    ("mul_lit", literal, basis_col) or ("div", sum_col, count_col).
    """

    names: list[str]
    dictionaries: dict[str, list[str]] = field(default_factory=dict)
    timestamp_cols: tuple[str, ...] = ()
    f64_recompute: dict[str, tuple] = field(default_factory=dict)

    def decode(self, cols: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """The named columns in schema order, dictionary codes replaced by
        their strings (object arrays), as the reference's ``decode``."""
        out = {}
        for n in self.names:
            v = cols[n]
            if n in self.dictionaries:
                vocab = np.asarray(self.dictionaries[n], dtype=object)
                out[n] = vocab[v]
            else:
                out[n] = v
        return out

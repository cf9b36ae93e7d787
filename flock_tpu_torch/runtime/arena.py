"""Window arena: bitmap-tracked reassembly of out-of-order fragments — copy
of ``flock_tpu/runtime/arena.py``.

Reference counterpart: flock/src/runtime/arena/{mod.rs:60-233, bitmap.rs} —
a per-function store keyed by ``(qid, shuffle_id)`` that collects N payload
fragments (possibly duplicated / out of order, Lambda is at-least-once),
tracks arrival with a bitmap, and releases the window once full.

In the engine this guards the *ingest* boundary (host feeds arriving from
external generators/sources, ``datagen/ingest.py``) and the
persistence-recovery path; the on-device exchange needs no arena (it is
lossless and ordered).  Duplicate fragments are dropped via the bitmap;
fully-processed windows short-circuit re-delivery (the PROCESSED_WINDOWS
dedup set, actor.rs:37,153).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from flock_tpu_torch.runtime.payload import Payload

WindowId = tuple[str, int]  # (qid, shuffle_id)


class WindowStatus(Enum):
    READY = "ready"
    NOT_READY = "not_ready"
    PROCESSED = "processed"


class Bitmap:
    """Arrival-tracking bitset (arena/bitmap.rs:27-62)."""

    def __init__(self, size: int):
        self.bits = np.zeros(size, dtype=bool)

    def set(self, i: int) -> bool:
        """Sets bit i; returns False if it was already set (duplicate)."""
        if self.bits[i]:
            return False
        self.bits[i] = True
        return True

    def all_set(self) -> bool:
        return bool(self.bits.all())

    def missing(self) -> list[int]:
        return np.flatnonzero(~self.bits).tolist()


@dataclass
class WindowSession:
    seq_len: int
    bitmap: Bitmap
    fragments: dict[int, Payload] = field(default_factory=dict)


@dataclass
class Arena:
    sessions: dict[WindowId, WindowSession] = field(default_factory=dict)
    processed: set[WindowId] = field(default_factory=set)

    def collect(self, payload: Payload) -> WindowStatus:
        """Add one fragment; says whether its window is now complete.

        Duplicates are dropped (bitmap); re-delivery of a finished window
        returns PROCESSED (idempotence under at-least-once delivery).
        """
        wid: WindowId = (payload.fragment.qid, payload.fragment.shuffle_id)
        if wid in self.processed:
            return WindowStatus.PROCESSED
        sess = self.sessions.get(wid)
        if sess is None:
            sess = WindowSession(payload.fragment.seq_len,
                                 Bitmap(payload.fragment.seq_len))
            self.sessions[wid] = sess
        if sess.bitmap.set(payload.fragment.seq_num):
            sess.fragments[payload.fragment.seq_num] = payload
        return (WindowStatus.READY if sess.bitmap.all_set()
                else WindowStatus.NOT_READY)

    def missing(self, wid: WindowId) -> list[int]:
        sess = self.sessions.get(wid)
        return sess.bitmap.missing() if sess else []

    def take(self, wid: WindowId) -> dict[str, np.ndarray]:
        """Remove a complete window and return its concatenated columns
        (fragments in seq order — arena/mod.rs take())."""
        sess = self.sessions.pop(wid)
        assert sess.bitmap.all_set(), f"window {wid} incomplete"
        self.processed.add(wid)
        frames = [sess.fragments[i].columns for i in range(sess.seq_len)]
        names = frames[0].keys()
        return {k: np.concatenate([f[k] for f in frames]) for k in names}

"""State backends: checkpoint / recovery for window fragments — copy of
``flock_tpu/runtime/state.py`` (``StateBackend``, ``MemoryStateBackend`` and
``FileStateBackend``).

Reference counterpart: flock/src/state/{mod.rs,s3.rs} — a ``StateBackend``
trait with S3 (bucket=qid, key=``<plan_idx>/<shuffle_id>/<seq_num>``), EFS
and no-op HashMap implementations.  Producers write every fragment in
parallel with sending it; a starving consumer diffs stored keys against its
arrival bitmap to pull missing fragments (actor.rs:186-234).

Here: ``MemoryStateBackend`` (HashMap analogue) and ``FileStateBackend``
(filesystem standing in for S3; key layout identical).  The session tiers
checkpoint their open windows through it (``SessionState.to_payloads``,
``device_session.to_payloads``) and a replacement driver resumes from it; a
window's fragments (``payload.to_fragments``) checkpoint there before
delivery, and a consumer whose arena misses some pulls them back
(lost-fragment recovery).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from flock_tpu_torch.runtime.payload import Payload, decode, encode


class StateBackend:
    def write(self, plan_idx: int, payload: Payload) -> None:
        raise NotImplementedError

    def read(self, qid: str, plan_idx: int, shuffle_id: int,
             seq_num: int) -> Payload | None:
        raise NotImplementedError

    def list_seqs(self, qid: str, plan_idx: int, shuffle_id: int) -> list[int]:
        raise NotImplementedError


@dataclass
class MemoryStateBackend(StateBackend):
    store: dict = field(default_factory=dict)

    def _key(self, qid, plan_idx, shuffle_id, seq_num):
        return (qid, plan_idx, shuffle_id, seq_num)

    def write(self, plan_idx: int, payload: Payload) -> None:
        f = payload.fragment
        self.store[self._key(f.qid, plan_idx, f.shuffle_id, f.seq_num)] = \
            encode(payload)

    def read(self, qid, plan_idx, shuffle_id, seq_num):
        data = self.store.get(self._key(qid, plan_idx, shuffle_id, seq_num))
        return decode(data) if data is not None else None

    def list_seqs(self, qid, plan_idx, shuffle_id):
        return sorted(s for (q, p, sh, s) in self.store
                      if (q, p, sh) == (qid, plan_idx, shuffle_id))


def _default_state_dir() -> str:
    from flock_tpu_torch.config import CONFIG

    return CONFIG.state_dir


@dataclass
class FileStateBackend(StateBackend):
    """S3 analogue on the local filesystem: <root>/<qid>/<plan_idx>/
    <shuffle_id>/<seq_num> (key layout from state/s3.rs:108-186)."""

    root: str = field(default_factory=_default_state_dir)

    def _path(self, qid, plan_idx, shuffle_id, seq_num=None):
        p = os.path.join(self.root, qid, str(plan_idx), str(shuffle_id))
        return p if seq_num is None else os.path.join(p, str(seq_num))

    def write(self, plan_idx: int, payload: Payload) -> None:
        from flock_tpu_torch.utils.retry import with_retry

        f = payload.fragment
        d = self._path(f.qid, plan_idx, f.shuffle_id)
        tmp = self._path(f.qid, plan_idx, f.shuffle_id, f.seq_num) + ".tmp"
        blob = encode(payload)

        def attempt() -> None:
            os.makedirs(d, exist_ok=True)
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, tmp[:-4])  # atomic publish

        # transient filesystem faults (NFS hiccups, ENOSPC races) retry with
        # the reference's backoff policy (aws/lambda.rs:104-152)
        with_retry(attempt, max_retries=10, retryable=(OSError,))

    def read(self, qid, plan_idx, shuffle_id, seq_num):
        from flock_tpu_torch.utils.retry import with_retry

        p = self._path(qid, plan_idx, shuffle_id, seq_num)
        if not os.path.exists(p):
            return None

        def attempt():
            with open(p, "rb") as fh:
                return decode(fh.read())

        return with_retry(attempt, max_retries=10, retryable=(OSError,))

    def list_seqs(self, qid, plan_idx, shuffle_id):
        d = self._path(qid, plan_idx, shuffle_id)
        if not os.path.isdir(d):
            return []
        return sorted(int(x) for x in os.listdir(d) if x.isdigit())

"""The generic session tier of the port on the CPU: ``SessionState``,
``Emission`` and ``_host_masks`` (runtime/stream.py) against flock_tpu's,
epoch by epoch on the same streams — open keys, last row seconds, start
chunks, retained chunks and every emission's host rows — both
``_host_masks`` branches, the compaction bound of one immortal session,
and checkpoint/resume through the payload codec and the file backend,
including the reference's checkpoint resumed by the port.  Comparisons
are exact (PyTorch port, CPU)."""

import functools

import numpy as np
import pytest
import torch

from flock_tpu.datagen.nexmark import NexmarkConfig
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime import device_session as ref_ds
from flock_tpu.runtime import state as ref_state
from flock_tpu.runtime import stream as ref_stream
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime import device_session, state, stream
from flock_tpu_torch.runtime.stream import SessionState, StreamDriver

torch.set_num_threads(1)

BASE = NexmarkConfig().base_time


@functools.lru_cache(maxsize=None)
def _epochs(seconds, eps, generators=1):
    return stream.generate_epochs(seconds, eps, generators)


def _sparse_epochs():
    """tests/test_checkpoint.py's sparse stream: real gaps and timeouts."""
    return _epochs(16, 200)


def _same_cols(a: dict, b: dict):
    assert list(a) == list(b)
    for k, v in b.items():
        v = np.asarray(v)
        assert a[k].dtype == v.dtype, k
        np.testing.assert_array_equal(a[k], v, err_msg=k)


def _same_state(mine, ref):
    for name in ("ob", "last_s", "start_cid"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    assert (mine.next_cid, mine.epoch) == (ref.next_cid, ref.epoch)
    assert [(c.cid, c.kmin, c.kmax) for c in mine.chunks] \
        == [(c.cid, c.kmin, c.kmax) for c in ref.chunks]


def _same_emission(mine, ref):
    assert (mine is None) == (ref is None)
    if mine is None:
        return
    assert mine.t == ref.t and mine.n_sessions == ref.n_sessions
    assert [c.cid for c in mine.chunks] == [c.cid for c in ref.chunks]
    np.testing.assert_array_equal(mine.bidders, ref.bidders)
    _same_cols(mine.to_batch(), ref.to_batch())
    assert mine.n_rows == ref.n_rows
    # the bucket _exec_emission asks for (none past _SPAN_LIMIT)
    bucket = min(stream._pow2_bucket(int(ref.bidders.max())
                                     - int(ref.bidders.min()) + 2),
                 stream._SPAN_LIMIT)
    dm, dr = mine.dense_tables(bucket), ref.dense_tables(bucket)
    assert (dm is None) == (dr is None)
    if dm is not None:
        for a, b in zip(dm, dr):
            np.testing.assert_array_equal(a, b)


def _revisit_epochs(seconds=24, pool=40, p=0.15, seed=0):
    """A small pool of bidders, each bidding in an epoch with probability
    ``p``, with event time running at twice the arrival rate (epoch t holds
    event second 2t): bidders come back after idle spells before their
    sessions time out, so gap closes and timeouts both happen (a timeout
    follows arrival epochs, a gap close event seconds; in the generator's
    streams the two advance together and only timeouts close)."""
    rng = np.random.default_rng(seed)
    epochs = []
    for t in range(seconds):
        bidders = np.flatnonzero(rng.random(pool) < p).astype(np.int64) + 500
        bidders = np.repeat(bidders, rng.integers(1, 4, len(bidders)))
        rng.shuffle(bidders)
        n = len(bidders)
        epochs.append({"bid": {
            "auction": rng.integers(1000, 1010, n).astype(np.int64),
            "bidder": bidders,
            "price": rng.integers(1, 10**6, n).astype(np.int64),
            "b_date_time": BASE + 2 * t * 1000
            + np.sort(rng.integers(0, 1000, n)).astype(np.int64)}})
    return epochs


KINDS = ["sparse", "dense", "revisit", "hot"]


@pytest.mark.parametrize("stream_kind", KINDS)
def test_session_state_epoch_by_epoch(stream_kind):
    """``advance``/``compact``/``flush`` against the reference's, epoch by
    epoch.  The revisit stream closes sessions by gap (mid-stream
    emissions with a gap group); the generator's streams only time
    out."""
    if stream_kind == "sparse":
        epochs, gap = _sparse_epochs(), 3
    elif stream_kind == "dense":
        epochs, gap = _epochs(12, 500, 2), 3
    elif stream_kind == "revisit":
        epochs, gap = _revisit_epochs(), 2
    else:
        epochs, gap = _hot_epochs(12, 50), 10
    gap_groups = 0
    mine, ref = SessionState(gap), ref_stream.SessionState(gap)
    emitted = 0
    for t, tables in enumerate(epochs):
        em_m, em_r = mine.advance(tables["bid"], t), ref.advance(
            tables["bid"], t)
        _same_emission(em_m, em_r)
        emitted += em_m is not None
        if em_m is not None:
            gap_groups += sum(int(g[2][0]) != stream._INF_END
                              for g in em_m.groups)
        _same_state(mine, ref)
        mine.compact(4)
        ref.compact(4)
        _same_state(mine, ref)
        for cm, cr in zip(mine.chunks, ref.chunks):
            _same_cols(cm.cols, cr.cols)
    _same_emission(mine.flush(len(epochs)), ref.flush(len(epochs)))
    assert (emitted > 1) == (stream_kind != "hot")
    assert (gap_groups > 0) == (stream_kind == "revisit")


def test_host_masks_both_branches():
    """Dense key tables for a small span, binary searches for a sparse one
    (tests/test_adversarial.py:121's keys), equal to the reference's."""
    rng = np.random.default_rng(5)
    for keys in (rng.integers(100, 400, 2000),
                 np.array([10, 1 << 40, 10, 1 << 40, 77] * 30)):
        keys = keys.astype(np.int64)
        ch = stream._Chunk(cid=3, cols={}, bidders=keys,
                           kmin=int(keys.min()), kmax=int(keys.max()))
        rch = ref_stream._Chunk(cid=3, cols={}, bidders=keys,
                                kmin=int(keys.min()), kmax=int(keys.max()))
        closed = np.unique(keys)[::2]
        starts = rng.integers(0, 5, len(closed))
        ends = rng.integers(3, 8, len(closed))
        for a, b in zip(stream._host_masks(closed, starts, ends, ch),
                        ref_stream._host_masks(closed, starts, ends, rch)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert stream._host_masks(closed, starts, ends, ch)[1].any()


def test_sparse_key_span_takes_the_sorted_paths():
    """tests/test_adversarial.py:121 on the port: keys over a 2^40 span take
    the argsort per-key statistics and the binary-search masks; the
    emission has no dense tables and realizes on the host."""
    k = np.array([10, 1 << 40, 10, 1 << 40, 77], np.int64)
    bid = {"bidder": k, "b_date_time": np.full(5, BASE + 10, np.int64),
           "price": np.arange(5, dtype=np.int64),
           "auction": np.ones(5, np.int64)}
    st = SessionState(gap=2)
    assert st.advance(bid, 0) is None
    em = st.flush(1)
    assert em is not None and em.n_sessions == 3
    assert em.dense_tables(1 << 20) is None
    sid = em.to_batch()["__session"]
    assert sorted(int((sid == s).sum()) for s in np.unique(sid)) == [1, 2, 2]
    ref = ref_stream.SessionState(gap=2)
    ref.advance(bid, 0)
    _same_emission(em, ref.flush(1))


def _hot_epochs(seconds: int, rows_per_epoch: int):
    """tests/test_adversarial.py's immortal session: one bidder bidding
    every epoch until the stream ends."""
    epochs = []
    for t in range(seconds):
        n = rows_per_epoch
        epochs.append({"bid": {
            "auction": np.full(n, 5, np.int64),
            "bidder": np.full(n, 77, np.int64),
            "price": np.arange(n, dtype=np.int64) + 100,
            "b_date_time": BASE + t * 1000
            + np.arange(n, dtype=np.int64) % 1000}})
    return epochs


def test_hot_session_bounded_chunks(monkeypatch):
    """tests/test_adversarial.py:32 on the port's generic tier: compaction
    bounds the retained chunks of an immortal session; one row at flush
    with the exact count, equal to the reference's generic tier."""
    monkeypatch.setattr(device_session, "session_fast_spec",
                        lambda *a, **kw: None)
    seen = {"max_chunks": 0, "compactions": 0}
    real = SessionState

    class Spy(real):
        def compact(self, max_chunks, restage=None):
            before = self.next_cid
            super().compact(max_chunks, restage)
            seen["compactions"] += self.next_cid != before
            seen["max_chunks"] = max(seen["max_chunks"], len(self.chunks))

    monkeypatch.setattr(stream, "SessionState", Spy)
    seconds = 40
    epochs = _hot_epochs(seconds, 100)
    results = StreamDriver(get_query(11), seconds, device="cpu").run(epochs)
    assert 0 < seen["max_chunks"] <= StreamDriver.MAX_CHUNKS
    assert seen["compactions"] > 0
    rows = [r for r in results if len(r.columns["bidder"])]
    assert len(rows) == 1 and rows[0].columns["bid_count"].tolist() == [
        100 * seconds]
    monkeypatch.setattr(ref_ds, "session_fast_spec", lambda *a, **kw: None)
    want = ref_stream.StreamDriver(ref_get_query(11), seconds).run(epochs)
    assert [r.tag for r in results] == [r.tag for r in want]
    for g, w in zip(results, want):
        _same_cols(g.columns, w.columns)


# -- checkpoint / resume -----------------------------------------------------


def _session_rows(cols):
    """Emitted batch → [(bidder, count, min_time, max_time)] per session."""
    sid = cols["__session"]
    rows = []
    for s in np.unique(sid):
        m = sid == s
        times = cols["b_date_time"][m]
        rows.append((int(cols["bidder"][m][0]), int(m.sum()),
                     int(times.min()), int(times.max())))
    return rows


def _run_sessions(epochs, gap=10, split_at=None, backend=None, qid="ck",
                  writer=SessionState, reader=SessionState):
    """tests/test_checkpoint.py's driver: sessionize, optionally checkpoint
    at ``split_at`` from a ``writer`` state and resume into a fresh
    ``reader`` state (a worker replacement, possibly across engines)."""
    st = writer(gap=gap)
    rows = []
    for t, tables in enumerate(epochs):
        if split_at is not None and t == split_at:
            for p in st.to_payloads(qid):
                backend.write(0, p)
            seqs = backend.list_seqs(qid, 0, 0)
            st = reader.from_payloads(
                gap, [backend.read(qid, 0, 0, s) for s in seqs])
        em = st.advance(tables["bid"], t)
        if em is not None:
            rows += _session_rows(em.to_batch())
    em = st.flush(len(epochs))
    if em is not None:
        rows += _session_rows(em.to_batch())
    return sorted(rows)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_session_checkpoint_resume(writer, tmp_path):
    """test_checkpoint.py:46 on the port: a checkpoint at epoch 8 — written
    by the port, or by the reference through its own backend — resumed by
    the port gives the uninterrupted run's rows."""
    epochs = _sparse_epochs()
    direct = _run_sessions(epochs)
    assert direct == _run_sessions(epochs, writer=ref_stream.SessionState,
                                   reader=ref_stream.SessionState)
    if writer == "port":
        kw = dict(backend=state.FileStateBackend(root=str(tmp_path)))
    else:
        kw = dict(backend=ref_state.FileStateBackend(root=str(tmp_path)),
                  writer=ref_stream.SessionState)
    assert _run_sessions(epochs, split_at=8, **kw) == direct
    assert len(direct) > 0


def test_session_payloads_equal_reference():
    epochs = _sparse_epochs()
    mine, ref = SessionState(10), ref_stream.SessionState(10)
    for t in range(8):
        mine.advance(epochs[t]["bid"], t)
        ref.advance(epochs[t]["bid"], t)
    pm, pr = mine.to_payloads("ck"), ref.to_payloads("ck")
    assert len(pm) == len(pr) > 0
    for a, b in zip(pm, pr):
        assert (a.fragment.qid, a.fragment.seq_num, a.fragment.seq_len,
                a.fragment.shuffle_id) == (b.fragment.qid, b.fragment.seq_num,
                                           b.fragment.seq_len,
                                           b.fragment.shuffle_id)
        assert a.metadata == b.metadata
        _same_cols(a.columns, b.columns)
    _same_state(SessionState.from_payloads(10, pr),
                ref_stream.SessionState.from_payloads(10, pr))
    assert SessionState(10).to_payloads("ck") == []


def test_session_timeout_after_resume(tmp_path):
    """test_checkpoint.py:56 on the port: a session open at the checkpoint
    still times out after the resume (last row seconds restored), and the
    emission records the closing epoch."""
    bid = {"auction": np.array([7, 7], np.int64),
           "bidder": np.array([42, 42], np.int64),
           "price": np.array([100, 200], np.int64),
           "b_date_time": np.array([BASE, BASE + 500], np.int64)}
    empty = {k: v[:0] for k, v in bid.items()}
    epochs = [{"bid": bid}] + [{"bid": empty}] * 7
    direct = _run_sessions(epochs, gap=3)
    resumed = _run_sessions(epochs, gap=3, split_at=2,
                            backend=state.FileStateBackend(root=str(tmp_path)))
    assert direct == resumed == [(42, 2, BASE, BASE + 500)]
    st = SessionState(gap=3)
    emitted = [em for t, e in enumerate(epochs)
               if (em := st.advance(e["bid"], t)) is not None]
    assert emitted and emitted[0].t == 3
    assert not len(st.ob) and not st.chunks
    assert st.flush(len(epochs)) is None

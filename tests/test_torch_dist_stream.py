"""The distributed stream driver against flock_tpu's on the same
per-generator parts (8 generators over 8 shards): q4 element-wise, q5
hopping, q7 tumbling, q12 processing-time and q11 session windows, window
for window and row for row; q11's key-range device tier is the default and
collective-free (an empty byte record), its generic label-table tier
forced; the generic tier checkpointed and resumed on the mesh, and the
adversarial session streams in both tiers (PyTorch port, CPU)."""

import numpy as np
import pytest
import torch

from flock_tpu.parallel.stream import DistStreamDriver as RefDistDriver
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime import device_session as ref_ds
from flock_tpu_torch.parallel import shuffle
from flock_tpu_torch.parallel import stream as pstream
from flock_tpu_torch.parallel.stream import DistStreamDriver
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime import device_session as ds
from flock_tpu_torch.runtime.stream import (StreamDriver, generate_epoch_parts,
                                            generate_epochs)

torch.set_num_threads(1)

SECONDS, EPS, GENS, N = 12, 800, 8, 8


@pytest.fixture(scope="module")
def parts():
    return generate_epoch_parts(SECONDS, EPS, GENS)


_REF = {}


def reference(qnum, parts, generic=False):
    """The reference driver's windows, cached per module (its first run
    of a query compiles)."""
    key = (qnum, generic)
    if key not in _REF:
        mp = pytest.MonkeyPatch()
        if generic:
            mp.setattr(ref_ds, "session_fast_spec", lambda *a, **kw: None)
        try:
            _REF[key] = RefDistDriver(ref_get_query(qnum), SECONDS, N).run(
                parts)
        finally:
            mp.undo()
    return _REF[key]


def _same_windows(got, want, names):
    assert [g.tag for g in got] == [tuple(w.tag) for w in want]
    for g, w in zip(got, want):
        for name in names:
            np.testing.assert_array_equal(g.columns[name], w.columns[name],
                                          err_msg=f"{g.tag} {name}")


@pytest.mark.parametrize("qnum", [4, 5, 7, 12])
def test_dist_windowed_equals_reference(qnum, parts):
    spec = get_query(qnum)
    got = DistStreamDriver(spec, SECONDS, N, device="cpu").run(parts)
    assert got
    _same_windows(got, reference(qnum, parts), spec.schema.names)


def test_dist_sessions_device_tier_is_default_and_collective_free(
        parts, monkeypatch):
    """q11's default is the key-range device tier: no collective, no
    label-table emission, every emission equal to the reference's."""
    calls = []
    monkeypatch.setattr(pstream, "_dist_session_exec",
                        lambda *a, **kw: calls.append(1))
    spec = get_query(11)
    driver = DistStreamDriver(spec, SECONDS, N, device="cpu")
    shuffle.TALLY = tally = []
    try:
        got = driver.run(parts)
    finally:
        shuffle.TALLY = None
    assert tally == [] and calls == []
    assert driver.session_stats["dispatches"] > 0
    _same_windows(got, reference(11, parts), spec.schema.names)


def test_dist_sessions_generic_tier(parts, monkeypatch):
    """The label-table tier forced: emissions labelled on the shards
    (never the host batch), equal to the reference's generic tier and, as
    row sets, to the single-device driver's."""
    monkeypatch.setattr(ds, "session_fast_spec", lambda *a, **kw: None)
    calls = {"tables": 0, "host": 0}
    orig_exec = pstream._dist_session_exec
    orig_rows = DistStreamDriver._exec_row_sharded

    def spy_exec(*a, **kw):
        calls["tables"] += 1
        return orig_exec(*a, **kw)

    def spy_rows(self, *a, **kw):
        calls["host"] += 1
        return orig_rows(self, *a, **kw)

    monkeypatch.setattr(pstream, "_dist_session_exec", spy_exec)
    monkeypatch.setattr(DistStreamDriver, "_exec_row_sharded", spy_rows)
    spec = get_query(11)
    got = DistStreamDriver(spec, SECONDS, N, device="cpu").run(parts)
    assert calls["tables"] > 0 and calls["host"] == 0
    names = spec.schema.names
    _same_windows(got, reference(11, parts, generic=True), names)
    local = StreamDriver(spec, SECONDS, device="cpu").run(
        generate_epochs(SECONDS, EPS, GENS))

    def rows(results):
        return sorted(r for res in results for r in zip(
            *(np.asarray(res.columns[n]).tolist() for n in names)))
    assert rows(got) == rows(local)


def test_dist_sessions_restart_with_doubled_spans(parts, monkeypatch):
    """An emission buffer too small for an epoch's closures restarts the
    device tier with doubled spans; the rows stay the reference's."""
    spec = get_query(11)
    driver = DistStreamDriver(spec, SECONDS, N, device="cpu")
    real = driver._session_device_once
    monkeypatch.setattr(driver, "_session_device_once",
                        lambda *a: real(*a[:-1], a[-1] // 4096))
    got = driver.run(parts)
    assert driver.session_stats["restarts"] > 0
    _same_windows(got, reference(11, parts), spec.schema.names)


# -- sharded session parity: resume and the adversarial streams ---------------


def _session_rows(results):
    names = ("bidder", "bid_count", "start_time", "end_time")
    return sorted(tuple(int(v) for v in row) for r in results
                  for row in zip(*(np.asarray(r.columns[n]) for n in names)))


def test_dist_session_checkpoint_resume(tmp_path, monkeypatch):
    """tests/test_checkpoint.py:91 through the port: the generic tier's
    session state on the 8-shard mesh is checkpointed mid-stream to the
    file backend, a replacement driver restores it and restages its rows
    onto the shards, and the resumed run's rows equal the reference's
    uninterrupted DistStreamDriver on the same parts."""
    from flock_tpu_torch.runtime.state import FileStateBackend
    from flock_tpu_torch.runtime.stream import SessionState

    seconds, split = 16, 8
    parts = generate_epoch_parts(seconds, 200, GENS)
    spec = get_query(11)
    want = RefDistDriver(ref_get_query(11), seconds, N).run(parts)

    def emit(driver, em, t, out):
        r = driver._exec_session_tables(em, ("sessions", t))
        if r is None:
            r = driver._exec_row_sharded("bid", em.to_batch(0),
                                         ("sessions", t))
        out.append(r)

    def advance(driver, state, t, out):
        bid = driver._merged_bids(parts[t])
        staged = driver._stage_session_chunk(bid) \
            if len(bid[SessionState.key]) else None
        em = state.advance(bid, t, staged=staged)
        if em is not None:
            emit(driver, em, t, out)
        state.compact(StreamDriver.MAX_CHUNKS,
                      restage=driver._stage_session_chunk)

    out, tables = [], []
    driver = DistStreamDriver(spec, seconds, N, device="cpu")
    real = pstream._dist_session_exec
    monkeypatch.setattr(pstream, "_dist_session_exec",
                        lambda *a: tables.append(1) or real(*a))
    state = SessionState(gap=spec.window[1])
    for t in range(split):
        advance(driver, state, t, out)
    backend = FileStateBackend(root=str(tmp_path))
    for p in state.to_payloads("distck"):
        backend.write(0, p)
    # the replacement driver and its state, restored from the file
    driver = DistStreamDriver(spec, seconds, N, device="cpu")
    state = SessionState.from_payloads(
        spec.window[1], [backend.read("distck", 0, 0, s)
                         for s in backend.list_seqs("distck", 0, 0)])
    assert state.chunks
    for ch in state.chunks:
        ch.staged = driver._stage_session_chunk(ch.cols)
    for t in range(split, seconds):
        advance(driver, state, t, out)
    em = state.flush(seconds)
    if em is not None:
        emit(driver, em, seconds, out)
    assert tables                    # emissions labelled on the shards
    assert len(_session_rows(want)) > 0
    assert _session_rows(out) == _session_rows(want)


@pytest.mark.parametrize("tier", ["device", "generic"])
@pytest.mark.parametrize("case", ["key_below_first_min", "late_rows"])
def test_dist_adversarial_session_streams(case, tier, monkeypatch):
    """The ``dist=True`` cases of tests/test_adversarial.py:223 (a later
    epoch's key below the first epoch's least) and :246 (late rows still
    time sessions out), one part per epoch over 8 shards, in either tier:
    the reference's DistStreamDriver's rows, window for window."""
    from test_torch_q11 import ADVERSARIAL

    epochs, n_rows = ADVERSARIAL[case]
    parts = [[e] for e in epochs]
    if tier == "generic":
        monkeypatch.setattr(ds, "session_fast_spec", lambda *a, **kw: None)
        monkeypatch.setattr(ref_ds, "session_fast_spec",
                            lambda *a, **kw: None)
    got = DistStreamDriver(get_query(11), len(epochs), N,
                           device="cpu").run(parts)
    want = RefDistDriver(ref_get_query(11), len(epochs), N).run(parts)
    _same_windows(got, want, get_query(11).schema.names)
    assert len(_session_rows(got)) == n_rows

"""The device session tier of the port on the CPU
(``runtime/device_session.py``) against flock_tpu's: ``step_impl`` epoch
by epoch in its merge-only and closing forms (state, emissions, ``n_emit``
and the overflow flag), ``_extract``, ``flush_impl``, ``grow`` and
``closure_gate``; checkpoints (``to_payloads``/``from_payloads``), the
empty checkpoint's watermark and the reference's checkpoint resumed by the
port; the driver-level resume; and a forced rollback, whose rows equal the
reference's.  The reference's step runs unjitted on JAX's CPU backend, as
its own tests drive it.  Comparisons are exact (PyTorch port, CPU)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flock_tpu.batch import Batch as RefBatch
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime import device_session as ref_ds
from flock_tpu.runtime import state as ref_state
from flock_tpu.runtime import stream as ref_stream
from flock_tpu_torch.batch import TS_BASE, Batch
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime import device_session as ds
from flock_tpu_torch.runtime import state
from flock_tpu_torch.runtime.stream import SessionState, StreamDriver

from test_torch_sessions import _revisit_epochs, _run_sessions, _sparse_epochs

torch.set_num_threads(1)

KEY, TCOL = SessionState.key, SessionState.time_col
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _plans():
    fs = ds.session_fast_spec(get_query(11), KEY, "bid")
    rfs = ref_ds.session_fast_spec(ref_get_query(11), KEY, "bid")
    return fs, ds._acc_plan(fs, KEY, TCOL), rfs, ref_ds._acc_plan(rfs, KEY,
                                                                  TCOL)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(a, b, what=""):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_state(mine: dict, ref: dict):
    assert sorted(mine) == sorted(ref)
    for k in ref:
        _same(mine[k], ref[k], k)


def _key_range(epochs):
    ks = [e["bid"][KEY] for e in epochs if len(e["bid"][KEY])]
    return min(int(k.min()) for k in ks), max(int(k.max()) for k in ks)


def test_fast_spec_and_acc_plan_equal_reference():
    fs, (ea, accs), rfs, (rea, raccs) = _plans()
    assert fs.aggs == rfs.aggs and fs.renames == rfs.renames
    assert ea == rea
    assert [(n, e, f, i) for n, (e, f, _d, i) in accs] \
        == [(n, e, f, int(i)) for n, (e, f, _d, i) in raccs]
    assert [str(d).split(".")[-1] for _, (_e, _f, d, _i) in accs] \
        == [np.dtype(d).name for _, (_e, _f, d, _i) in raccs]


@pytest.mark.parametrize("stream_kind", ["revisit", "sparse"])
def test_step_impl_equals_reference(stream_kind):
    """Both steps over the same epochs from the same state: the merge-only
    form while the closure gate says no session can close, the closing
    form after — every state array, the emission's columns and validity,
    ``n_emit`` and the overflow flag, epoch by epoch."""
    epochs, gap = ((_revisit_epochs(), 2) if stream_kind == "revisit"
                   else (_sparse_epochs(), 3))
    fs, (ea, accs), rfs, (rea, raccs) = _plans()
    kmin, kmax = _key_range(epochs)
    m, SE, cap_out = kmin, 1024, 1024
    S_buf = ds._bucket(kmax - kmin + 1 + 1) + SE
    mine = ds.init_state(S_buf, accs, CPU)
    ref = ref_ds.init_state(S_buf, raccs)
    _same_state(mine, ref)
    forms, emitted, mev = set(), 0, None
    for t, tables in enumerate(epochs):
        bid = {c: tables["bid"][c] for c in (KEY, TCOL)}
        ev = ds._event_sec_range(bid[TCOL])
        mev, mc = ds.closure_gate(mev, *ev, len(bid[KEY]), t, gap)
        cap = max(len(bid[KEY]), 128)
        b = Batch.from_numpy(bid, cap, CPU)
        rb = RefBatch.from_numpy(bid, cap)
        kr = (int(bid[KEY].min()), int(bid[KEY].max())) if len(bid[KEY]) \
            else None
        mine, oc, ov, ne, ovf = ds.step_impl(
            KEY, TCOL, ea, accs, SE, cap_out, mc, gap, t + 1 - gap, m,
            mine, dict(b.columns), b.valid, kr)
        ref, roc, rov, rne, rovf = ref_ds.step_impl(
            KEY, TCOL, rea, raccs, SE, cap_out, None, mc, np.int32(gap),
            np.int32(t + 1 - gap), np.int32(m), ref, dict(rb.columns),
            rb.valid)
        forms.add(mc)
        _same_state(mine, ref)
        _same(ov, rov, "out_valid")
        assert int(ne) == int(rne) and bool(ovf) == bool(rovf) is False
        assert sorted(oc) == sorted(roc)
        for k in roc:
            _same(oc[k], roc[k], k)
        emitted += int(ne)
    assert forms == {False, True} and emitted > 0
    f, fv, fn = ds.flush_impl(accs, 2048, m, mine)
    rf, rfv, rfn = ref_ds.flush_impl(raccs, 2048, np.int32(m), ref)
    assert int(fn) == int(rfn) > 0
    _same(fv, rfv)
    for k in rf:
        _same(f[k], rf[k], k)


def test_step_flags_span_and_k2_overflow():
    """A key beyond the state's logical span and an epoch wider than SE
    both raise the step's overflow flag, as in the reference."""
    fs, (ea, accs), rfs, (rea, raccs) = _plans()
    S_buf, SE, m = 2048 + 256, 256, 1000
    for keys in ([1000, 1000 + 2048], [1000, 1000 + 300], [999, 1000]):
        bid = {KEY: np.asarray(keys, np.int64),
               TCOL: np.asarray([TS_BASE, TS_BASE + 5], np.int64)}
        b = Batch.from_numpy(bid, 128, CPU)
        rb = RefBatch.from_numpy(bid, 128)
        *_, ovf = ds.step_impl(KEY, TCOL, ea, accs, SE, 64, True, 10, -9, m,
                               ds.init_state(S_buf, accs, CPU),
                               dict(b.columns), b.valid,
                               (min(keys), max(keys)))
        *_, rovf = ref_ds.step_impl(
            KEY, TCOL, rea, raccs, SE, 64, None, True, np.int32(10),
            np.int32(-9), np.int32(m), ref_ds.init_state(S_buf, raccs),
            dict(rb.columns), rb.valid)
        assert bool(ovf) and bool(rovf)


def test_extract_equals_reference():
    rng = np.random.default_rng(7)
    S = 4096
    for density, cap_out in ((0.001, 16), (0.3, 512), (0.3, 4096), (0, 8)):
        emask = rng.random(S) < density
        vals = {"a": rng.integers(-2**31, 2**31 - 1, S).astype(np.int32),
                "b": rng.integers(-2**40, 2**40, S).astype(np.int64)}
        out, ov, n = ds._extract(torch.from_numpy(emask),
                                 {k: torch.from_numpy(v)
                                  for k, v in vals.items()}, 77, cap_out)
        rout, rov, rn = ref_ds._extract(jnp.asarray(emask),
                                        {k: jnp.asarray(v)
                                         for k, v in vals.items()},
                                        np.int32(77), cap_out)
        assert int(n) == int(rn) == int(emask.sum())
        _same(ov, rov)
        for k in rout:
            _same(out[k], rout[k], k)


def test_grow_and_closure_gate_equal_reference():
    fs, (ea, accs), rfs, (rea, raccs) = _plans()
    st = ds.init_state(1024, accs, CPU)
    st["open"][5] = True
    st["last_s"][5] = 3
    st["bid_count"][5] = 9
    rst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    _same_state(ds.grow(st, 4096, accs), ref_ds.grow(rst, 4096, raccs))
    rng = np.random.default_rng(1)
    mev = rmev = None
    for t in range(200):
        lo = int(rng.integers(-5, 30))
        args = (lo, lo + int(rng.integers(0, 20)), int(rng.integers(0, 3)),
                int(rng.integers(0, 40)), int(rng.integers(0, 12)))
        mev, mc = ds.closure_gate(mev, *args)
        rmev, rmc = ref_ds.closure_gate(rmev, *args)
        assert (mev, mc) == (rmev, rmc)
        if t % 50 == 49:
            mev = rmev = None


def _state_after(epochs, split, gap, engine):
    """The state-layer loop of tests/test_checkpoint.py:256 on one engine:
    epochs before ``split`` through its step; returns (state, m, rows)."""
    fs, (ea, accs), rfs, (rea, raccs) = _plans()
    kmin, kmax = _key_range(epochs)
    m, SE = kmin, 1024
    S_buf = ds._bucket(kmax - kmin + 1 + 1) + SE
    rows = []
    if engine == "port":
        st = ds.init_state(S_buf, accs, CPU)
    else:
        st = ref_ds.init_state(S_buf, raccs)
    for t in range(split):
        bid = {c: epochs[t]["bid"][c] for c in (KEY, TCOL)}
        cap = max(len(bid[KEY]), 128)
        if engine == "port":
            b = Batch.from_numpy(bid, cap, CPU)
            st, oc, _ov, ne, ovf = ds.step_impl(
                KEY, TCOL, ea, accs, SE, 1024, True, gap, t + 1 - gap, m, st,
                dict(b.columns), b.valid,
                (int(bid[KEY].min()), int(bid[KEY].max())))
            host_fs = fs
        else:
            b = RefBatch.from_numpy(bid, cap)
            st, oc, _ov, ne, ovf = ref_ds.step_impl(
                KEY, TCOL, rea, raccs, SE, 1024, None, True, np.int32(gap),
                np.int32(t + 1 - gap), np.int32(m), st, dict(b.columns),
                b.valid)
            host_fs = rfs
        assert not bool(ovf)
        n = int(ne)
        if n:
            cols = {c: np.asarray(a)[:n] for c, a in oc.items()}
            host = ds.finish_names(host_fs, KEY, cols)
            rows += [(int(host["bidder"][i]), int(host["bid_count"][i]),
                      int(host["start_time"][i]) + TS_BASE,
                      int(host["end_time"][i]) + TS_BASE) for i in range(n)]
    return st, m, S_buf, rows


def test_payloads_equal_reference_and_round_trip(tmp_path):
    epochs = _sparse_epochs()
    fs, (ea, accs), rfs, (rea, raccs) = _plans()
    mine, m, S_buf, _ = _state_after(epochs, 8, 10, "port")
    ref, *_ = _state_after(epochs, 8, 10, "ref")
    pm = ds.to_payloads(mine, m, accs, "devck", 8)
    pr = ref_ds.to_payloads(ref, m, raccs, "devck", 8)
    assert len(pm) == len(pr) == 1
    assert pm[0].metadata == pr[0].metadata == {"epoch": 8}
    assert list(pm[0].columns) == list(pr[0].columns)
    for k, v in pr[0].columns.items():
        _same(pm[0].columns[k], v, k)
    be = state.FileStateBackend(root=str(tmp_path))
    be.write(0, pm[0])
    back = [be.read("devck", 0, 0, s) for s in be.list_seqs("devck", 0, 0)]
    st, ep, floor = ds.from_payloads(back, accs, m, S_buf, CPU)
    rst, rep, rfloor = ref_ds.from_payloads(pr, raccs, m, S_buf)
    assert (ep, floor) == (rep, rfloor) and floor is not None
    _same_state(st, rst)
    _same_state(st, mine)
    with pytest.raises(ValueError, match="outside"):
        ds.from_payloads(back, accs, m + 10**6, S_buf, CPU)


def test_empty_checkpoint_advances_watermark(tmp_path):
    """test_checkpoint.py:233 on the port: zero open sessions still write
    the (empty) payload, so the epoch watermark advances."""
    fs, (ea, accs), rfs, (rea, raccs) = _plans()
    st = ds.init_state(2048, accs, CPU)
    be = state.FileStateBackend(root=str(tmp_path))
    for p in ds.to_payloads(st, 1000, accs, "devck2", 9):
        be.write(0, p)
    seqs = be.list_seqs("devck2", 0, 0)
    assert seqs, "empty checkpoint must still persist the watermark"
    back = [be.read("devck2", 0, 0, s) for s in seqs]
    st2, ep, ev_floor = ds.from_payloads(back, accs, 1000, 2048, CPU)
    assert ep == 9 and ev_floor is None and not st2["open"].any()
    # the reference reads the port's empty checkpoint alike
    _, rep, rfloor = ref_ds.from_payloads(back, raccs, 1000, 2048)
    assert (rep, rfloor) == (9, None)
    assert ds.from_payloads([], accs, 1000, 2048, CPU)[1:] == (0, None)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_driver_level_resume(writer, tmp_path):
    """test_checkpoint.py:256 on the port: a worker dies at epoch 8 after
    checkpointing — its state written by the port, or by the reference
    through its own backend — and a replacement StreamDriver resumes
    through ``run_device_sessions(resume_payloads=, t_base=8)``; the union
    of the emissions equals the uninterrupted run's rows."""
    epochs = _sparse_epochs()
    want = _run_sessions(epochs)
    fs, (ea, accs), rfs, (rea, raccs) = _plans()
    st, m, _, rows = _state_after(epochs, 8, 10, writer)
    if writer == "port":
        be = state.FileStateBackend(root=str(tmp_path))
        payloads = ds.to_payloads(st, m, accs, "devck3", 8)
    else:
        be = ref_state.FileStateBackend(root=str(tmp_path))
        payloads = ref_ds.to_payloads(st, m, raccs, "devck3", 8)
    for p in payloads:
        be.write(0, p)
    payloads = [be.read("devck3", 0, 0, s)
                for s in be.list_seqs("devck3", 0, 0)]
    driver = StreamDriver(get_query(11), 16, device="cpu")
    res = ds.run_device_sessions(driver, epochs[8:], None, fs,
                                 resume_payloads=payloads, t_base=8)
    rows += [tuple(int(r.columns[c][i]) for c in ("bidder", "bid_count",
                                                  "start_time", "end_time"))
             for r in res for i in range(len(r.columns["bidder"]))]
    assert sorted(rows) == want and len(want) > 0
    assert [r.tag[1] for r in res] == sorted(r.tag[1] for r in res)


def test_forced_rollback_equals_reference(monkeypatch):
    """An emission buffer of 4 sessions overflows at the first closing
    chunk: the chunk rolls back to its start state, every bucket doubles,
    and it reruns, until the buffer holds the epoch's sessions.  Rows and
    tags equal the reference's run (which needs no rollback) and its
    generic tier's."""
    epochs = ref_stream.generate_epochs(12, 500, 2)
    monkeypatch.setattr(ds, "CAP_OUT", 4)
    driver = StreamDriver(get_query(11), 12, device="cpu")
    got = driver.run(epochs)
    assert driver.session_stats.retries >= 2
    # at most one host read of the flags per chunk dispatch (a dispatch a
    # rollback discards is never read), and the flush's
    stats = driver.session_stats
    assert stats.retries < stats.dispatches < stats.flag_reads + stats.retries
    assert stats.flag_reads <= stats.dispatches + 1
    want = ref_stream.StreamDriver(ref_get_query(11), 12).run(epochs)
    assert [g.tag for g in got] == [w.tag for w in want]
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        for k, v in w.columns.items():
            _same(g.columns[k], v, k)
    monkeypatch.setattr(ds, "session_fast_spec", lambda *a, **kw: None)
    generic = StreamDriver(get_query(11), 12, device="cpu").run(epochs)

    def rows(rs):
        return sorted(tuple(int(r.columns[c][i]) for c in r.columns)
                      for r in rs for i in range(len(r.columns["bidder"])))

    assert rows(generic) == rows(got)

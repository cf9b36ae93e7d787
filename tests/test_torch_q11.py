"""NEXMark q11 (session windows) end to end on the CPU: the port's
StreamDriver against flock_tpu's and ``oracle.q11_sessions`` on
tests/test_queries.py's configuration (12 s × 500 events/s, 2 generators),
in both session tiers — tags, column order, dtypes and values exact; the
emission order per epoch; late rows whose event time times sessions out
and a key below the first epoch's least key; ``prestage`` and
``run(prestaged=...)``; one emission's device output from
``execute_session_tables`` (the K3 label gather, then the K2 aggregate)
against the reference's on the same staged chunks; and the two reference
faults the port does not copy (PyTorch port, CPU)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import oracle
from flock_tpu.datagen.nexmark import NexmarkConfig
from flock_tpu.plan import Aggregate as RefAggregate
from flock_tpu.plan import Project as RefProject
from flock_tpu.plan import Scan as RefScan
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime import device_session as ref_ds
from flock_tpu.runtime import stream as ref_stream
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu_torch.plan import Aggregate, Project, Scan
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime import device_session, stream
from flock_tpu_torch.runtime.stream import (StreamDriver, generate_epochs,
                                            run_nexmark)

torch.set_num_threads(1)

SECONDS, EPS, GENERATORS = 12, 500, 2
NAMES = ["bidder", "bid_count", "start_time", "end_time"]
TIERS = ["device", "generic"]


@functools.lru_cache(maxsize=None)
def _epochs():
    return generate_epochs(SECONDS, EPS, GENERATORS)


def _rows(results, names=NAMES):
    return sorted(row for r in results
                  for row in zip(*(np.asarray(r.columns[n]).tolist()
                                   for n in names)))


def _same_results(got, want):
    assert [g.tag for g in got] == [w.tag for w in want]
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        for name, col in w.columns.items():
            col = np.asarray(col)
            assert g.columns[name].dtype == col.dtype, name
            np.testing.assert_array_equal(g.columns[name], col, err_msg=name)


@pytest.fixture
def generic(monkeypatch):
    """Force both engines onto the generic label-table tier, the way
    tests/test_adversarial.py:84 does."""
    def force():
        monkeypatch.setattr(device_session, "session_fast_spec",
                            lambda *a, **kw: None)
        monkeypatch.setattr(ref_ds, "session_fast_spec",
                            lambda *a, **kw: None)
    return force


def _run_both(spec, ref_spec, epochs, seconds, tier, generic, **kw):
    if tier == "generic":
        generic()
    port = StreamDriver(spec, seconds, device="cpu")
    return port, port.run(epochs, **kw), \
        RefDriver(ref_spec, seconds).run(epochs)


@pytest.mark.parametrize("tier", TIERS)
def test_q11_equals_reference_and_oracle(tier, generic):
    port, got, want = _run_both(get_query(11), ref_get_query(11), _epochs(),
                                SECONDS, tier, generic)
    _same_results(got, want)
    assert (port.session_stats is not None) == (tier == "device")
    expected = oracle.q11_sessions([e["bid"] for e in _epochs()], gap=10)
    assert _rows(got) == sorted(zip(*(expected[n].tolist() for n in NAMES)))
    assert len(_rows(got)) > 100


@pytest.mark.parametrize("tier", TIERS)
def test_q11_incremental_emission(tier, generic):
    """test_queries.py:127: closed sessions are emitted per epoch, in epoch
    order, before the stream ends."""
    _, got, _ = _run_both(get_query(11), ref_get_query(11), _epochs(),
                          SECONDS, tier, generic)
    tags = [r.tag for r in got]
    assert all(t[0] == "sessions" for t in tags)
    assert tags == sorted(tags)
    assert len(tags) > 1 and tags[0][1] < SECONDS


def test_prestaged_run_equals_run():
    port = StreamDriver(get_query(11), SECONDS, device="cpu")
    staged = port.prestage(_epochs())
    assert all(sorted(b.columns) == ["b_date_time", "bidder"]
               and b.capacity == stream._pow2_bucket(
                   len(e["bid"]["bidder"]))
               for b, e in zip(staged, _epochs()))
    _same_results(port.run(_epochs(), prestaged=staged),
                  port.run(_epochs()))


def test_spec_and_run_nexmark():
    mine, ref = get_query(11), ref_get_query(11)
    assert mine.relations == ref.relations and mine.window == ref.window
    assert mine.schema.__dict__ == ref.schema.__dict__
    got = run_nexmark(11, seconds=6, events_per_second=300, device="cpu")
    want = ref_stream.run_nexmark(11, seconds=6, events_per_second=300)
    _same_results(got, want)


def _mk_bid_epoch(bidders, secs):
    base = NexmarkConfig().base_time
    n = len(bidders)
    return {"bid": {
        "auction": np.full(n, 5, np.int64),
        "bidder": np.asarray(bidders, np.int64),
        "price": np.arange(n, dtype=np.int64) + 100,
        "b_date_time": base + np.asarray(secs, np.int64) * 1000}}


ADVERSARIAL = {
    # test_adversarial.py:223: a later epoch's key below the first epoch's
    # least key must not strand the device tier's base
    "key_below_first_min": (
        [_mk_bid_epoch([5000, 5001, 5002], [0, 0, 0]),
         _mk_bid_epoch([4000], [1])] + [_mk_bid_epoch([], [])] * 13, 4),
    # test_adversarial.py:246: late rows (event second lagging the arrival
    # epoch) still time sessions out
    "late_rows": (
        [_mk_bid_epoch([], [])] * 8 + [_mk_bid_epoch([100], [0])]
        + [_mk_bid_epoch([], [])] * 3 + [_mk_bid_epoch([100], [12])]
        + [_mk_bid_epoch([], [])] * 10, 2),
}


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
@pytest.mark.parametrize("tier", TIERS)
def test_adversarial_streams(case, tier, generic):
    epochs, n_rows = ADVERSARIAL[case]
    _, got, want = _run_both(get_query(11), ref_get_query(11), epochs,
                             len(epochs), tier, generic)
    _same_results(got, want)
    assert len(_rows(got)) == n_rows


def test_hot_session_device_tier_equals_generic(generic):
    """test_adversarial.py:75: one immortal session, both tiers equal."""
    from test_torch_sessions import _hot_epochs

    epochs = _hot_epochs(15, 300)
    fast = StreamDriver(get_query(11), 15, device="cpu").run(epochs)
    generic()
    slow = StreamDriver(get_query(11), 15, device="cpu").run(epochs)
    assert _rows(fast) == _rows(slow) == [
        (77, 4500, NexmarkConfig().base_time,
         NexmarkConfig().base_time + 14 * 1000 + 299)]


def test_session_tables_device_output_equals_reference():
    """One emission of the generic tier on the same staged chunks: the
    port's ``execute_session_tables`` (K3 gathers the three label tables,
    K2 aggregates by ``__session``) against the reference's — capacity,
    validity and every column on the valid rows."""
    from flock_tpu.runtime.executor import LocalExecutor as RefExecutor
    from flock_tpu_torch.runtime.executor import LocalExecutor

    epochs = _epochs()
    ex = LocalExecutor(get_query(11), device="cpu")
    rex = RefExecutor(ref_get_query(11))
    st = stream.SessionState(gap=3)
    checked = 0
    for t, tables in enumerate(epochs):
        bid = {c: tables["bid"][c] for c in ("bidder", "b_date_time")}
        cap = stream._pow2_bucket(len(bid["bidder"]))
        em = st.advance(bid, t, staged=(ex.stage_chunk(bid, cap),
                                        rex.stage_chunk(bid, cap)))
        if em is None or em.merged is None:
            continue
        closed = em.merged[0]
        bucket = stream._pow2_bucket(int(closed.max()) - int(closed.min())
                                     + 2)
        dt = em.dense_tables(bucket)
        cids = [ch.cid for ch in em.chunks]
        agg = stream._pow2_bucket(em.n_sessions)
        got = ex.execute_session_tables([ch.staged[0] for ch in em.chunks],
                                        "bidder", dt, cids, agg)
        want = rex.execute_session_tables([ch.staged[1] for ch in em.chunks],
                                          "bidder", dt, np.asarray(cids),
                                          agg)
        wv = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), wv)
        assert wv.sum() == em.n_sessions
        for name, col in want.columns.items():
            g = got.columns[name].numpy()[wv]
            w = np.asarray(col)[wv]
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        checked += 1
    assert checked >= 3


def test_a_projected_session_label_runs_on_the_generic_tier(generic):
    """Reference fault C8, not copied: the reference's device-tier gate
    admits a Project of ``__session`` (not an aggregate's output) and then
    raises KeyError naming the emission's columns.  The port sends the plan
    to the generic tier, which has the column: its rows equal the
    reference's generic tier."""
    def plan(P, A, S):
        return P(A(S("bid"), group_keys=("__session",),
                   aggs=(("bidder", "max", "bidder"),
                         (None, "count", "bid_count"))),
                 (("bidder", "bidder"), ("sess", "__session"),
                  ("bid_count", "bid_count")))

    def respec(q, P, A, S):
        return dataclasses.replace(q, plan=plan(P, A, S),
                                   schema=dataclasses.replace(
                                       q.schema, timestamp_cols=(),
                                       names=["bidder", "sess", "bid_count"]))

    spec = respec(get_query(11), Project, Aggregate, Scan)
    ref_spec = respec(ref_get_query(11), RefProject, RefAggregate, RefScan)
    assert device_session.session_fast_spec(spec, "bidder", "bid") is None
    assert ref_ds.session_fast_spec(ref_spec, "bidder", "bid") is not None
    with pytest.raises(KeyError):
        RefDriver(ref_spec, SECONDS).run(_epochs())
    got = StreamDriver(spec, SECONDS, device="cpu").run(_epochs())
    generic()
    _same_results(got, RefDriver(ref_spec, SECONDS).run(_epochs()))
    assert len(_rows(got, ["bidder", "bid_count"])) > 100


@pytest.mark.parametrize("tier", TIERS)
def test_a_driving_relation_not_named_bid(tier, generic):
    """Reference fault C8, not copied: the reference reads ``tables["bid"]``
    in both tiers.  The port reads the driving relation: q11 over a
    relation named ``bids`` gives the rows q11 gives over ``bid``."""
    spec = dataclasses.replace(
        get_query(11), relations=("bids",),
        plan=dataclasses.replace(get_query(11).plan, child=dataclasses.replace(
            get_query(11).plan.child, child=Scan("bids"))))
    renamed = [{"bids": e["bid"]} for e in _epochs()]
    if tier == "generic":
        generic()
    else:
        assert device_session.session_fast_spec(spec, "bidder",
                                                "bids") is not None
    got = StreamDriver(spec, SECONDS, device="cpu").run(renamed)
    _same_results(got, RefDriver(ref_get_query(11), SECONDS).run(_epochs()))

"""The window model and the port's range and row-count windows on the CPU:
``Schedule``/``Window`` against flock_tpu's; sliding, stagger, rows,
tumbling and hopping windows against flock_tpu's ``StreamDriver`` at
tests/test_windows.py's configuration (10 s × 600 events/s, 2 generators),
tags and rows exact; element-wise windows through ``_run_ranges`` with a
forced widen, where the device outputs match the reference's in capacity
too; and each epoch staged once however many windows share it (PyTorch
port, CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import oracle
from flock_tpu import window as ref_window
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu_torch import window
from flock_tpu_torch.batch import Batch
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs

torch.set_num_threads(1)

SECONDS, EPS = 10, 600


@pytest.fixture(scope="module")
def epochs():
    return generate_epochs(SECONDS, EPS, 2)


def _gapped(epochs):
    """tests/test_windows.py's stagger input: epochs 0, 1 and 5 blank."""
    empty = {k: v[:0] for k, v in epochs[0]["bid"].items()}
    out = [dict(e) for e in epochs]
    for t in (0, 1, 5):
        out[t] = {"bid": empty}
    return out


def _drivers(q, win, seconds=SECONDS):
    return (StreamDriver(dataclasses.replace(get_query(q), window=win),
                         seconds, device="cpu"),
            RefDriver(dataclasses.replace(ref_get_query(q), window=win),
                      seconds))


def _same_results(got, want):
    assert [g.tag for g in got] == [w.tag for w in want]
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        for name, col in w.columns.items():
            col = np.asarray(col)
            assert g.columns[name].dtype == col.dtype, name
            np.testing.assert_array_equal(g.columns[name], col, err_msg=name)


# ------------------------------------------------------------------ model --

@pytest.mark.parametrize("mod", [window, ref_window], ids=["port", "ref"])
def test_schedule_rate_parsing_and_cron(mod):
    S = mod.Schedule
    assert [S.rate(e).to_seconds() for e in (
        "rate(1 second)", "rate(5 minutes)", "rate(2 hours)",
        "rate(7 days)")] == [1, 300, 7200, 604800]
    assert S.seconds(9).to_seconds() == 9
    with pytest.raises(ValueError):
        S.rate("every 5 minutes").to_seconds()
    with pytest.raises(NotImplementedError):
        S.cron("cron(0/10 * ? * MON-FRI *)").to_seconds()
    with pytest.raises(ValueError):
        S.rows(5).to_seconds()


def _windows(mod):
    S = mod.Schedule
    return [mod.tumbling_window(10), mod.tumbling_window(S.rate("rate(1 minute)")),
            mod.tumbling_window(S.rows(512)), mod.hopping_window(10, 5),
            mod.sliding_window(10, 5), mod.stagger_window(4),
            mod.session_window(10), mod.global_window(S.seconds(3)),
            mod.element_wise_window(), mod.Window("session", S.seconds(10))]


def test_window_lowering_equals_reference():
    mine, ref = _windows(window), _windows(ref_window)
    assert [w.to_spec() for w in mine] == [w.to_spec() for w in ref] == [
        ("tumbling", 10), ("tumbling", 60), ("rows", 512), ("hopping", 10, 5),
        ("sliding", 10, 5), ("stagger", 4), ("session", 10), ("global", 3),
        ("elementwise",), ("session", 10)]
    for m, r in zip(mine, ref):
        assert dataclasses.asdict(m) == dataclasses.asdict(r)
    for mod in (window, ref_window):
        with pytest.raises(NotImplementedError):
            mod.session_window(mod.Schedule.rows(5)).to_spec()


# ------------------------------------------------------- window kinds ------

KINDS = [(2, ("sliding", 4, 2), False), (2, ("stagger", 3), True),
         (2, ("stagger", 5), False), (0, ("rows", 700), False),
         (2, ("rows", 700), False), (2, ("tumbling", 5), False),
         (2, ("hopping", 4, 2), False)]


@pytest.mark.parametrize("q,win,gapped", KINDS,
                         ids=[f"q{q}-{w[0]}{w[1:]}{'-gapped' if g else ''}"
                              for q, w, g in KINDS])
def test_window_kinds_equal_reference(epochs, q, win, gapped):
    ep = _gapped(epochs) if gapped else epochs
    port, ref = _drivers(q, win)
    got = port.run(ep)
    _same_results(got, ref.run(ep))
    assert len(got) > 1
    if win[0] == "stagger" and gapped:
        assert [r.tag for r in got] == [("win", 2, 5), ("win", 6, 9),
                                        ("win", 9, 12)]
    if win[0] == "sliding":
        assert [r.tag for r in got] == [("win", 0, 2), ("win", 0, 4),
                                        ("win", 2, 6), ("win", 4, 8),
                                        ("win", 6, 10)]
    if win[0] != "rows":
        names = port.spec.schema.names
        for r, (tag, tables) in zip(got, port.windows(ep)):
            assert r.tag == tag
            want = oracle.q2(tables["bid"])
            assert sorted(zip(*(r.columns[n].tolist() for n in names))) == \
                sorted(zip(*(want[n].tolist() for n in names)))


def test_rows_windows_pack_exactly(epochs):
    """Row-count windows hold exactly n rows in stream order, the last one
    the remainder (q0 is the identity)."""
    n = 700
    port, _ = _drivers(0, ("rows", n))
    got = port.run(epochs)
    bids = np.concatenate([e["bid"]["auction"] for e in epochs])
    sizes = [len(r.columns["auction"]) for r in got]
    assert sizes[:-1] == [n] * (len(bids) // n) and sum(sizes) == len(bids)
    np.testing.assert_array_equal(
        np.concatenate([r.columns["auction"] for r in got]), bids)
    assert [r.tag for r in got] == [("rows", i) for i in range(len(got))]


def test_stagger_needs_occupancy_and_other_kinds_raise(epochs):
    port, _ = _drivers(2, ("stagger", 3))
    with pytest.raises(ValueError, match="occupancy"):
        port._window_epoch_ranges()
    # session windows run (q11's slice): q2 over sessions takes the generic
    # tier in both engines, with equal results
    port, ref = _drivers(2, ("session", 10))
    _same_results(port.run(epochs), ref.run(epochs))
    # global windows run (q12); over a plan with no single-key aggregate
    # both engines refuse them alike
    for driver in _drivers(2, ("global", 10)):
        with pytest.raises(ValueError, match="single-key aggregation"):
            driver.run(epochs)


# ------------------------------------------- element-wise widen parity -----

def _wide_span_epochs():
    """Two epochs of bids whose auction ids span 9,000: q5's count per
    auction needs 9,000 slots, and a 128-row epoch gives 128 + 8,192."""
    rng = np.random.default_rng(5)
    out = []
    for t in range(2):
        n = 100
        auction = np.sort(1000 + rng.integers(0, 9000, n)).astype(np.int32)
        auction[[0, -1]] = 1000, 1000 + 8999
        out.append({"bid": {
            "auction": auction,
            "bidder": rng.integers(1, 500, n).astype(np.int32),
            "price": rng.integers(100, 10**6, n).astype(np.int32),
            "b_date_time": (1_436_918_400_000 + 1000 * t
                            + np.arange(n)).astype(np.int64)}})
    return out


def _repeated_persons():
    """Two epochs of q3 input where ten Oregon persons each appear ten
    times and all 100 auctions are theirs, in category 10: the fan-out's
    900 extras outgrow the free slots until the auction capacity reaches
    1,024 rows."""
    rng = np.random.default_rng(3)
    ts = 1_436_918_400_000
    out = []
    for t in range(2):
        pid = np.tile(np.arange(10 * t, 10 * t + 10, dtype=np.int32), 10)
        n = 100
        out.append({
            "person": {"p_id": pid,
                       "name": rng.integers(0, 100, 100).astype(np.int32),
                       "city": rng.integers(0, 10, 100).astype(np.int32),
                       "state": np.full(100, 3, np.int32),
                       "p_date_time": np.full(100, ts, np.int64)},
            "auction": {"a_id": np.arange(n * t, n * t + n, dtype=np.int32),
                        "initial_bid": np.ones(n, np.int32),
                        "reserve": np.ones(n, np.int32),
                        "a_date_time": np.full(n, ts, np.int64),
                        "expires": np.full(n, ts + 10, np.int64),
                        "seller": (10 * t + rng.integers(0, 10, n))
                        .astype(np.int32),
                        "category": np.full(n, 10, np.int32)}})
    return out


def _capture(driver, name):
    seen = []
    orig = getattr(driver.executor, name)

    def spy(*a, **k):
        b = orig(*a, **k)
        seen.append(b)
        return b

    setattr(driver.executor, name, spy)
    return seen


@pytest.mark.parametrize("case", ["wide_span", "fan_out"])
def test_elementwise_widen_matches_reference(case, monkeypatch):
    """Element-wise windows run through ``_run_ranges`` as in the
    reference: on overflow the per-epoch capacities double and every epoch
    is staged again, so the window's device output has the reference's
    capacity, validity and values after the widen."""
    if case == "wide_span":
        q, ep, seconds = 5, _wide_span_epochs(), 2
    else:
        q, ep, seconds = 3, _repeated_persons(), 2
    port, ref = _drivers(q, ("elementwise",), seconds)
    port_out = _capture(port, "execute_epochs")
    ref_out = _capture(ref, "execute_epochs")
    staged = []
    orig = Batch.from_numpy.__func__
    monkeypatch.setattr(Batch, "from_numpy", classmethod(
        lambda cls, *a, **k: staged.append(1) or orig(cls, *a, **k)))
    got = port.run(ep)
    monkeypatch.undo()
    want = ref.run(ep)
    _same_results(got, want)
    # at least one widen staged every epoch again
    assert len(staged) > seconds * len(port.spec.relations)
    assert len(port_out) == len(ref_out) == seconds
    for g, r in zip(port_out, ref_out):
        rv = np.asarray(r.valid)
        assert g.capacity == rv.shape[0]
        np.testing.assert_array_equal(g.valid.numpy(), rv)
        for name, col in r.columns.items():
            np.testing.assert_array_equal(g.columns[name].numpy()[rv],
                                          np.asarray(col)[rv], err_msg=name)


# ------------------------------------------------------ epoch reuse --------

@pytest.mark.parametrize("q,win,windows", [(5, ("hopping", 10, 5), 2),
                                           (2, ("sliding", 4, 2), 7)])
def test_overlapping_windows_stage_each_epoch_once(q, win, windows,
                                                   monkeypatch):
    """15 epochs under hopping 10/5 (2 windows, 20 epoch-windows) or
    sliding 4/2 (7 windows): each epoch reaches the device once."""
    ep = generate_epochs(15, 200, 1)
    port, ref = _drivers(q, win, 15)
    calls = []
    orig = Batch.from_numpy.__func__
    monkeypatch.setattr(Batch, "from_numpy", classmethod(
        lambda cls, *a, **k: calls.append(1) or orig(cls, *a, **k)))
    got = port.run(ep)
    assert len(got) == windows and len(calls) == 15
    monkeypatch.undo()
    _same_results(got, ref.run(ep))

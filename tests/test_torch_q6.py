"""The q6 slice on the CPU: the port's StreamDriver against flock_tpu's and
tests/oracle.py on element-wise windows (tests/test_queries.py's
configuration, 12 s × 500 events/s, 2 generators), on the G=3 window of
tests/test_sqlite_oracle.py (10 s × 350 events/s, 3 generators: duplicate
auction ids, one rerun) and on one whole-stream window (as
tests/test_large_window.py, at 4 s × 20,000 events/s instead of its
250,000, so that it runs in tier-1 in a few seconds); the device columns of
every window; the fused pass staying fused (K1's plain version, the
Project's ``__order`` made on the probe side); ``rank_in_group``,
``sorted_segment_aggregate``, ``_sorted_by`` and ``_slot_dense`` against
the reference's; and the ``avg_price`` sink recipe.  Every comparison is
exact, the f64 ``avg_price`` included (PyTorch port, CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from flock_tpu import plan as ref_plan
from flock_tpu.ops import kernels as ref_kernels
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime.executor import LocalExecutor as RefExecutor
from flock_tpu.runtime.executor import materialize_columns as ref_materialize
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu_torch import plan
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime.executor import LocalExecutor, materialize_columns
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
from flock_tpu_torch.runtime.tables import concat_relations

torch.set_num_threads(1)

# (seconds, events/s, generators, one window over the whole stream)
CONFIGS = {"elementwise": (12, 500, 2, False),
           "duplicates": (10, 350, 3, True),
           "whole_stream": (4, 20_000, 1, True)}
RERUNS = {"elementwise": 0, "duplicates": 1, "whole_stream": 0}
NAMES = ["seller", "avg_price"]


@functools.lru_cache(maxsize=None)
def _epochs(config):
    seconds, eps, gens, _ = CONFIGS[config]
    return generate_epochs(seconds, eps, gens)


def _ranges(config):
    seconds, _, _, single = CONFIGS[config]
    return [list(range(seconds))] if single else [[t] for t in range(seconds)]


def _windows(config):
    rels = ("auction", "bid")
    return [concat_relations([_epochs(config)[t] for t in rng], rels)
            for rng in _ranges(config)]


def _rows(cols, names):
    return sorted(zip(*(np.asarray(cols[n]).tolist() for n in names)))


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    config = request.param
    seconds, _, _, single = CONFIGS[config]
    port = StreamDriver(get_query(6), seconds, device="cpu")
    ref = RefDriver(ref_get_query(6), seconds)
    if single:
        whole = [(("win", 0, seconds), list(range(seconds)))]
        port._window_epoch_ranges = lambda occupancy=None: whole
        ref._window_epoch_ranges = lambda occupancy=None: whole
    return config, port, port.run(_epochs(config)), ref.run(_epochs(config))


def test_sink_rows_equal_reference(case):
    config, port, got, want = case
    assert len(got) == len(want) == len(_ranges(config))
    for g, w in zip(got, want):
        assert g.tag == w.tag and list(g.columns) == NAMES
        for name in NAMES:
            gv, wv = g.columns[name], np.asarray(w.columns[name])
            assert gv.dtype == wv.dtype, name
            np.testing.assert_array_equal(gv, wv, err_msg=name)
    assert sum(len(g.columns["seller"]) for g in got) > 0
    assert port.executor.fallback_runs == RERUNS[config]


def test_sink_rows_equal_oracle(case):
    config, _, got, _ = case
    for r, w in zip(got, _windows(config)):
        assert _rows(r.columns, NAMES) \
            == _rows(oracle.q6(w["auction"], w["bid"]), NAMES)


@pytest.mark.parametrize("config", ["elementwise", "duplicates"])
def test_device_columns_equal_reference(config):
    """The device output window by window: the same capacity, validity and
    values in every valid row (the sorted-segment output keeps the fused
    span's capacity, its groups on each run's last row)."""
    port = LocalExecutor(get_query(6), device="cpu")
    ref = RefExecutor(ref_get_query(6))
    for w in _windows(config):
        g = port.execute_window(w)
        r = ref.execute_window(w)
        rv = np.asarray(r.valid)
        np.testing.assert_array_equal(g.valid.numpy(), rv)
        assert set(g.columns) == set(r.columns)
        for name, col in r.columns.items():
            np.testing.assert_array_equal(g.columns[name].numpy()[rv],
                                          np.asarray(col)[rv], err_msg=name)
    assert port.fallback_runs == RERUNS[config]


def test_clean_window_stays_fused(monkeypatch):
    """A clean window runs q6's fused pass (K1's plain version on the CPU):
    the Project's ``__order`` is made on the probe side and aggregated as
    an int64 max, the seller carried from its slot; nothing reruns."""
    calls = []
    orig = plan.join_aggregate

    def spy(slot_cols, present, m, probe_cols, pvalid, key, pred, aggs):
        calls.append((sorted(slot_cols), probe_cols["__order"].dtype,
                      list(aggs)))
        return orig(slot_cols, present, m, probe_cols, pvalid, key, pred,
                    aggs)

    monkeypatch.setattr(plan, "join_aggregate", spy)
    driver = StreamDriver(get_query(6), 12, device="cpu")
    got = driver.run(_epochs("elementwise"))
    assert driver.executor.fallback_runs == 0
    assert len(calls) == 12
    assert calls[0] == (["a_date_time", "expires", "seller"], torch.int64,
                        [("__order", "max", "__order"),
                         ("seller", "max", "seller")])
    assert sum(len(r.columns["seller"]) for r in got) > 0


def test_a_project_reading_build_columns_is_not_fused(monkeypatch):
    """A middle Project whose callable reads a taken build column cannot
    run on the probe side: the node takes the unfused path statically, with
    the same rows."""
    from flock_tpu_torch.plan import Aggregate, Project

    base = get_query(6).plan
    win_agg = next(n for n in plan.walk(base) if isinstance(n, Aggregate)
                   and n.group_keys == ("auction",))
    joined = win_agg.child.child
    spec = get_query(4)
    with_key = Project(joined, (
        ("auction", "auction"),
        ("v", lambda c: c["price"] + c["a_date_time"])))
    agg = Aggregate(with_key, ("auction",), (("v", "max", "v"),))
    node = next(n for n in plan.walk(plan.fuse_join_aggregates(agg))
                if isinstance(n, plan.FusedJoinAggregate))
    w = _windows("elementwise")[3]
    ex = LocalExecutor(spec, device="cpu")
    b = ex.prepare_window({"auction": w["auction"], "bid": w["bid"]})
    assert plan.fused_replay(node, b["auction"].columns,
                             b["bid"].columns) is None
    calls = []
    monkeypatch.setattr(plan, "join_aggregate",
                        lambda *a: calls.append(1))
    out, ovf, esc = plan.compile_plan(agg, 4096)(b)
    assert not calls and not bool(ovf) and not bool(esc)
    assert bool(out.valid.any())


def test_filter_behind_a_renaming_project_is_replayed(monkeypatch):
    """A Conj Filter behind a Project that renames columns is replayed
    under the columns' own names: the fused pass (K1's plain version, an
    int64 max of a probe-side column among its aggregates) gives the rows
    of the unfused lowering."""
    from flock_tpu_torch.plan import Aggregate, Conj, Filter, Project

    joined = next(n for n in plan.walk(get_query(6).plan)
                  if isinstance(n, plan.Join))
    proj = Project(joined, (
        ("a", "auction"), ("p", "price"), ("t", "b_date_time"),
        ("start", "a_date_time"),
        ("o", lambda c: c["price"].to(torch.int64) * 2**33 - c["bidder"])))
    agg = Aggregate(Filter(proj, Conj((("t", ">=", "start"),
                                       ("p", ">", "t")))),
                    ("a",), (("o", "max", "o"), ("p", "min", "p"),
                             (None, "count", "n")))
    calls = []
    orig = plan.join_aggregate
    monkeypatch.setattr(plan, "join_aggregate",
                        lambda *a: calls.append(a[6]) or orig(*a))
    w = _windows("elementwise")[5]
    b = LocalExecutor(get_query(6), device="cpu").prepare_window(w)
    fn = plan.compile_plan(agg, 4096)
    (fused, _, esc), (unfused, _, _) = fn(b), fn(b, fallback=True)
    assert not bool(esc)
    assert calls == [Conj((("b_date_time", ">=", "a_date_time"),
                           ("b_date_time", "<=", "expires"),
                           ("b_date_time", ">=", "a_date_time"),
                           ("price", ">", "b_date_time")))]
    names = ["a", "o", "p", "n"]
    got = _rows({k: v[fused.valid].numpy() for k, v in fused.columns.items()},
                names)
    want = _rows({k: v[unfused.valid].numpy()
                  for k, v in unfused.columns.items()}, names)
    assert got == want and len(got) > 10


def test_avg_price_sink_recipe_equals_reference():
    """The sink divides the exact integer sum by the count in f64, as the
    reference's ``materialize_columns`` does."""
    rng = np.random.default_rng(6)
    n = 1000
    host = {"seller": rng.integers(1000, 9000, n).astype(np.int32),
            "avg_price": rng.random(n).astype(np.float32),
            "sum_price": rng.integers(0, 10**12, n).astype(np.int64),
            "cnt": rng.integers(1, 11, n).astype(np.int32)}
    got = materialize_columns(get_query(6), dict(host))
    want = ref_materialize(ref_get_query(6), dict(host))
    assert list(got) == list(want) == NAMES
    for name in NAMES:
        assert got[name].dtype == np.asarray(want[name]).dtype
        np.testing.assert_array_equal(got[name], np.asarray(want[name]))
    assert got["avg_price"].dtype == np.float64


def _rank_inputs(seed, n=600):
    rng = np.random.default_rng(seed)
    return ({"g": rng.integers(0, 12, n).astype(np.int32),
             "o": rng.integers(0, 30, n).astype(np.int32),   # many ties
             "t": rng.permutation(n).astype(np.int32),
             "x": rng.integers(-(2**40), 2**40, n).astype(np.int64)},
            rng.random(n) < 0.8)


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("tiebreak", ["t", None])
def test_rank_in_group_equals_reference(descending, tiebreak):
    """Ties in the order column, either direction, with and without a
    tiebreak, invalid rows interspersed: every row of every column, the
    rank included, in the same order."""
    cols, valid = _rank_inputs(int(descending) + 2 * (tiebreak is None))
    got, gvalid = kernels.rank_in_group(
        {k: torch.from_numpy(v) for k, v in cols.items()},
        torch.from_numpy(valid), "g", "o", descending, "r", tiebreak)
    want, wvalid = ref_kernels.rank_in_group(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(valid),
        "g", "o", descending, "r", tiebreak)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    assert list(got) == list(want)
    for name, col in want.items():
        assert got[name].numpy().dtype == np.asarray(col).dtype, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(col),
                                      err_msg=name)
    assert int(got["r"][gvalid].max()) > 1


def _segment_cases():
    """tests/test_sorted_slot_kernels.py's inputs: 4096 rows sorted over
    800 keys, a fifth invalid, values of both signs; and five rows whose
    middle group is wholly invalid."""
    rng = np.random.default_rng(2)
    n = 4096
    big = (np.sort(rng.integers(100, 900, n)).astype(np.int32),
           rng.random(n) < 0.8,
           rng.integers(-(10**6), 10**6, n).astype(np.int32))
    small = (np.array([1, 1, 2, 2, 3], np.int32),
             np.array([True, True, False, False, True]),
             np.arange(5, dtype=np.int32))
    return {"sorted_4096": big, "all_invalid_group": small}


@pytest.mark.parametrize("name", list(_segment_cases()))
def test_sorted_segment_aggregate_equals_reference(name):
    keys, valid, vals = _segment_cases()[name]
    aggs = [("v", "sum", "s"), ("v", "min", "lo"), ("v", "max", "hi"),
            (None, "count", "c"), ("v", "count_sum", "cs")]
    got, gvalid, govf = kernels.sorted_segment_aggregate(
        {"k": torch.from_numpy(keys), "v": torch.from_numpy(vals)},
        torch.from_numpy(valid), "k", aggs)
    # jitted, as the reference's own test runs it (its eager scans are slow)
    want, wvalid, wovf = jax.jit(
        lambda c, v: ref_kernels.sorted_segment_aggregate(c, v, "k", aggs))(
        {"k": jnp.asarray(keys), "v": jnp.asarray(vals)}, jnp.asarray(valid))
    wv = np.asarray(wvalid)
    np.testing.assert_array_equal(gvalid.numpy(), wv)
    assert not bool(govf) and not bool(wovf) and wv.any()
    assert set(got) == set(want)
    for k, col in want.items():
        assert got[k].numpy().dtype == np.asarray(col).dtype, k
        np.testing.assert_array_equal(got[k].numpy()[wv], np.asarray(col)[wv],
                                      err_msg=k)
    if name == "all_invalid_group":
        assert got["k"][gvalid].tolist() == [1, 3]
        assert got["s"][gvalid].tolist() == [1, 4]


def test_sorted_by_and_slot_dense_on_q6_and_q8_shapes():
    """The reference's ``test_plan_detection_q6_q8_shapes`` on the port:
    q8's join sides are slot-dense, q6's per-seller Aggregate sits on
    Filter(Rank(seller)) and so is sorted, not slot-dense."""
    for P, get in ((plan, get_query), (ref_plan, ref_get_query)):
        q8_join = get(8).plan.child
        assert isinstance(q8_join, P.Join)
        assert P._slot_dense(q8_join.build, q8_join.build_key)
        assert P._slot_dense(q8_join.probe, q8_join.probe_key)
        q6_agg = get(6).plan.child
        assert isinstance(q6_agg, P.Aggregate)
        assert P._sorted_by(q6_agg.child, "seller")
        assert not P._slot_dense(q6_agg, "seller")
        assert not P._sorted_by(q6_agg.child, "auction")


def test_q6_spec_matches_reference():
    mine, ref = get_query(6), ref_get_query(6)
    assert mine.relations == ref.relations and mine.window == ref.window
    assert mine.schema.__dict__ == ref.schema.__dict__

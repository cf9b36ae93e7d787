"""The SQL frontend on the CPU: the port's ``sql_to_spec`` against
flock_tpu's on the same generated window (tests/test_sql.py's texts and
fixture, ``generate_epochs(3, 2000, 2)``) and against the port's hand
plans, sink columns compared exactly in order, dtypes and the f64 sink
columns included (SQL q6's averages to the reference test's rtol=1e-9);
SQL q5 and q7 over their hopping and tumbling windows through both
engines' ``StreamDriver``; SQL q4 at G=3 (one escape); the parse errors
and the lowering's uniqueness facts; the structural check that SQL q4 and
q9 keep kernel K1's fused pass (a ``Conj`` replay, one ``join_aggregate``
call per window); and the repair that sends a fused chain with a callable
predicate to the unfused path (PyTorch port)."""

import functools

import numpy as np
import pytest
import torch

from test_sql import NEXMARK_SQL, Q6_SQL, YSB_SQL
from flock_tpu.datagen.ysb import YsbConfig as RefYsbConfig
from flock_tpu.batch import Batch as RefBatch
from flock_tpu.plan import Aggregate as RefAggregate
from flock_tpu.plan import Filter as RefFilter
from flock_tpu.plan import Join as RefJoin
from flock_tpu.plan import Scan as RefScan
from flock_tpu.plan import compile_plan as ref_compile_plan
from flock_tpu.queries.ysb import campaign_table as ref_campaign_table
from flock_tpu.queries.ysb import generate_ysb_epochs as ref_ysb_epochs
from flock_tpu.runtime.executor import LocalExecutor as RefExecutor
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu.runtime.tables import default_side_input as ref_side_input
from flock_tpu.sql.catalog import nexmark_catalog as ref_nexmark_catalog
from flock_tpu.sql.catalog import ysb_catalog as ref_ysb_catalog
from flock_tpu.sql.lower import sql_to_spec as ref_sql_to_spec
from flock_tpu_torch import plan
from flock_tpu_torch.batch import Batch
from flock_tpu_torch.datagen.ysb import YsbConfig
from flock_tpu_torch.plan import (Aggregate, Conj, Filter, FusedJoinAggregate,
                                  Join, Scan, compile_plan, walk)
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.queries.ysb import (campaign_table, generate_ysb_epochs,
                                         ysb_query)
from flock_tpu_torch.runtime.executor import LocalExecutor
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
from flock_tpu_torch.runtime.tables import concat_relations
from flock_tpu_torch.sql.catalog import nexmark_catalog, ysb_catalog
from flock_tpu_torch.sql.lower import Lowerer, sql_to_spec
from flock_tpu_torch.sql.parser import parse_sql

torch.set_num_threads(1)

Q11_SQL = ("SELECT bidder, Count(*) AS bid_count, Min(b_date_time) AS "
           "start_time, Max(b_date_time) AS end_time FROM bid "
           "GROUP BY bidder;")


@functools.lru_cache(maxsize=None)
def _window(seconds=3, eps=2000, gens=2):
    return concat_relations(generate_epochs(seconds, eps, gens),
                            ("person", "auction", "bid"))


def _run_port(spec, window):
    ex = LocalExecutor(spec, device="cpu")
    out = ex.materialize(ex.execute_window(
        {r: window[r] for r in spec.relations if r != "side_input"}))
    return out, ex


def _run_ref(spec, window):
    tables = {r: window[r] for r in spec.relations if r != "side_input"}
    if "side_input" in spec.relations:
        tables["side_input"] = ref_side_input()
    ex = RefExecutor(spec)
    return ex.materialize(ex.execute_window(tables))


def _same_columns(got: dict, want: dict, names_got, names_want):
    """The named columns equal in order, dtype and value."""
    assert len(names_got) == len(names_want)
    for g, w in zip(names_got, names_want):
        gv, wv = np.asarray(got[g]), np.asarray(want[w])
        assert gv.dtype == wv.dtype, g
        np.testing.assert_array_equal(gv, wv, err_msg=g)


def _rows(cols, names):
    return sorted(zip(*(np.asarray(cols[n]).tolist() for n in names)))


@pytest.mark.parametrize("qnum", sorted(NEXMARK_SQL))
def test_sql_equals_reference_sql(qnum):
    sql = NEXMARK_SQL[qnum]
    spec = sql_to_spec(sql, nexmark_catalog())
    ref = ref_sql_to_spec(sql, ref_nexmark_catalog())
    assert spec.schema.names == ref.schema.names
    assert spec.relations == ref.relations
    assert spec.schema.f64_recompute == ref.schema.f64_recompute
    assert spec.schema.timestamp_cols == ref.schema.timestamp_cols
    got, _ = _run_port(spec, _window())
    want = _run_ref(ref, _window())
    assert list(got) == list(want)
    _same_columns(got, want, list(got), list(want))
    assert len(got[spec.schema.names[0]]) > 0


@pytest.mark.parametrize("qnum", sorted(NEXMARK_SQL))
def test_sql_equals_hand_plan(qnum):
    hand = get_query(qnum)
    spec = sql_to_spec(NEXMARK_SQL[qnum], nexmark_catalog())
    got, _ = _run_port(spec, _window())
    want, _ = _run_port(hand, _window())
    # output names align by position (aliases may differ for money columns)
    _same_columns(got, want, spec.schema.names, hand.schema.names)


def test_sql_q1_device_price_is_the_hand_plans_float32():
    """0.908 * price: a float32 literal times the float32 column, bit for
    bit the hand plan's device column; the sink's mul_lit f64 recompute
    equals the hand plan's recipe exactly (test_sql_equals_hand_plan)."""
    spec = sql_to_spec(NEXMARK_SQL[1], nexmark_catalog())
    w = {"bid": _window()["bid"]}
    got = LocalExecutor(spec, device="cpu").execute_window(w)
    want = LocalExecutor(get_query(1), device="cpu").execute_window(w)
    assert got.columns["price"].dtype == torch.float32
    assert torch.equal(got.columns["price"], want.columns["price"])
    assert spec.schema.f64_recompute == {"price": ("mul_lit", 0.908,
                                                   "__basis_price")}


def test_sql_q6():
    hand = get_query(6)
    spec = sql_to_spec(Q6_SQL, nexmark_catalog())
    got, _ = _run_port(spec, _window())
    for want, names in ((_run_ref(ref_sql_to_spec(Q6_SQL,
                                                  ref_nexmark_catalog()),
                                  _window()), spec.schema.names),
                        (_run_port(hand, _window())[0], hand.schema.names)):
        g = _rows(got, spec.schema.names)
        w = _rows(want, names)
        # tie order inside ROW_NUMBER is unspecified in SQL: sellers exact,
        # averages to the reference test's tolerance
        assert [r[0] for r in g] == [r[0] for r in w]
        np.testing.assert_allclose([r[1] for r in g], [r[1] for r in w],
                                   rtol=1e-9)
    assert len(got["seller"]) > 0


def test_sql_ysb():
    cfg = YsbConfig(seconds=2, events_per_second=3000)
    epochs = generate_ysb_epochs(cfg)
    events = {k: np.concatenate([e["ad_event"][k] for e in epochs])
              for k in epochs[0]["ad_event"]}
    tables = {"ad_event": events, "campaign": campaign_table(cfg)}
    spec = sql_to_spec(YSB_SQL, ysb_catalog())
    ex = LocalExecutor(spec, device="cpu")
    got = ex.materialize(ex.execute_window(tables))

    rcfg = RefYsbConfig(seconds=2, events_per_second=3000)
    repochs = ref_ysb_epochs(rcfg)
    rtables = {"ad_event": {k: np.concatenate([e["ad_event"][k]
                                               for e in repochs])
                            for k in repochs[0]["ad_event"]},
               "campaign": ref_campaign_table(rcfg)}
    rex = RefExecutor(ref_sql_to_spec(YSB_SQL, ref_ysb_catalog()))
    want = rex.materialize(rex.execute_window(rtables))
    _same_columns(got, want, list(got), list(want))

    hand = LocalExecutor(ysb_query(), device="cpu")
    want_hand = hand.materialize(hand.execute_window(tables))
    _same_columns(got, want_hand, ["campaign_id", "count"],
                  ["campaign_id", "count"])
    assert int(got["count"].sum()) > 0


def test_sql_q11_reference_text():
    """q11.sql's per-bidder aggregate over one window: the reference's rows
    and a numpy group-by; start and end stay timestamps."""
    spec = sql_to_spec(Q11_SQL, nexmark_catalog())
    assert spec.schema.timestamp_cols == ("start_time", "end_time")
    got, _ = _run_port(spec, _window())
    want = _run_ref(ref_sql_to_spec(Q11_SQL, ref_nexmark_catalog()),
                    _window())
    _same_columns(got, want, list(got), list(want))
    bid = _window()["bid"]
    b, t = bid["bidder"], bid["b_date_time"]
    assert _rows(got, spec.schema.names) == sorted(
        (int(u), int((b == u).sum()), int(t[b == u].min()),
         int(t[b == u].max())) for u in np.unique(b))


@pytest.mark.parametrize("qnum,window", [(5, ("hopping", 10, 5)),
                                         (7, ("tumbling", 10))])
def test_sql_windowed_through_stream_driver(qnum, window):
    """SQL q5 and q7 over their windows: the port's StreamDriver against
    the reference's on the same spec text, window for window."""
    seconds = 15
    epochs = generate_epochs(seconds, 1000, 1)
    sql = NEXMARK_SQL[qnum]
    got = StreamDriver(sql_to_spec(sql, nexmark_catalog(), window=window),
                       seconds, device="cpu").run(epochs)
    want = RefDriver(ref_sql_to_spec(sql, ref_nexmark_catalog(),
                                     window=window), seconds).run(epochs)
    assert [g.tag for g in got] == [w.tag for w in want]
    assert len(got) == {5: 2, 7: 1}[qnum]
    for g, w in zip(got, want):
        _same_columns(g.columns, w.columns, list(g.columns), list(w.columns))
    hand = StreamDriver(get_query(qnum), seconds, device="cpu").run(epochs)
    names = get_query(qnum).schema.names
    for g, h in zip(got, hand):
        assert _rows(g.columns, names) == _rows(h.columns, names)


def test_sql_q4_duplicate_window_escapes_once():
    """tests/test_sqlite_oracle.py's G=3 configuration as one window: the
    generator repeats auction ids, SQL q4's fused pass escapes once and
    the fan-out rerun's rows equal the reference's and hand q4's."""
    w = _window(10, 350, 3)
    spec = sql_to_spec(NEXMARK_SQL[4], nexmark_catalog())
    got, ex = _run_port(spec, w)
    assert ex.fallback_runs == 1
    want = _run_ref(ref_sql_to_spec(NEXMARK_SQL[4], ref_nexmark_catalog()), w)
    _same_columns(got, want, list(got), list(want))
    hand, hex_ = _run_port(get_query(4), w)
    assert hex_.fallback_runs == 1
    _same_columns(got, hand, ["category", "avg_final"],
                  ["category", "avg_final"])


def test_sql_parse_errors():
    with pytest.raises(SyntaxError):
        parse_sql("SELECT FROM bid")
    with pytest.raises(SyntaxError):
        parse_sql("SELEC * FROM bid")
    with pytest.raises(ValueError):   # no such dictionary code
        sql_to_spec("SELECT * FROM person WHERE state = 'tx';",
                    nexmark_catalog())


def test_sql_joins_carry_uniqueness_facts():
    """q13's side-input join declares unique_build (a hard catalog fact:
    duplicates overflow); q4's auction build stays soft (NEXMark's id
    wraparound can repeat a_id, so duplicates fan out)."""
    def join_of(q):
        spec = sql_to_spec(NEXMARK_SQL[q], nexmark_catalog())
        return [n for n in walk(spec.plan) if isinstance(n, Join)][0]

    assert join_of(13).unique_build
    assert not join_of(4).unique_build


def test_projection_uniqueness_follows_columns_not_names():
    low = Lowerer(nexmark_catalog())
    aliased = low.lower_select(parse_sql("SELECT value AS key FROM side_input"))
    assert "key" not in aliased.hard_unique_keys
    assert "key" not in aliased.unique_keys
    renamed = low.lower_select(parse_sql("SELECT key AS k2 FROM side_input"))
    assert "k2" in renamed.hard_unique_keys


@pytest.mark.parametrize("qnum", [4, 9])
def test_sql_q4_q9_keep_the_fused_pass(qnum, monkeypatch):
    """The residual BETWEEN lowers to a Conj, which survives the join's
    renaming Project: the fused node replays it and K1 (its plain version
    here) runs once per window."""
    spec = sql_to_spec(NEXMARK_SQL[qnum], nexmark_catalog())
    fused = [n for n in walk(plan.fuse_join_aggregates(spec.plan))
             if isinstance(n, FusedJoinAggregate)]
    assert len(fused) == 1
    epochs = generate_epochs(3, 2000, 2)
    ex = LocalExecutor(spec, device="cpu")
    b = ex.prepare_window({r: epochs[0][r] for r in spec.relations})
    node = fused[0]
    replay = plan.fused_replay(node, b["auction"].columns, b["bid"].columns)
    assert replay.pred == Conj((("b_date_time", ">=", "a_date_time"),
                                ("b_date_time", "<=", "expires")))
    calls = []
    orig = plan.join_aggregate
    monkeypatch.setattr(plan, "join_aggregate",
                        lambda *a: calls.append(1) or orig(*a))
    StreamDriver(spec, 3, device="cpu").run(epochs)
    assert len(calls) == 3


def _callable_filter_plan(mod):
    """Join(k = k) → Filter(callable over both sides) → Aggregate(k; max v)
    in either engine's IR."""
    join = mod["Join"](build=mod["Scan"]("b"), probe=mod["Scan"]("p"),
                       build_key="k", probe_key="k", take=(("w", "w"),))
    filt = mod["Filter"](join, lambda c: c["v"] > c["w"], "v>w")
    return mod["Aggregate"](filt, group_keys=("k",),
                            aggs=(("v", "max", "m"),))


def test_callable_predicate_takes_the_unfused_path(monkeypatch):
    """A fused chain whose predicate K1 cannot read (a callable, not a
    Conj) lowers unfused on every device — join_aggregate is never
    called — and its rows equal the reference's compile_plan's."""
    rng = np.random.default_rng(3)
    nb, n = 200, 1000
    build = {"k": rng.permutation(nb).astype(np.int32) + 50,
             "w": rng.integers(0, 100, nb).astype(np.int32)}
    probe = {"k": rng.integers(40, 260, n).astype(np.int32),
             "v": rng.integers(0, 100, n).astype(np.int32)}
    port_plan = _callable_filter_plan(
        {"Join": Join, "Scan": Scan, "Filter": Filter, "Aggregate": Aggregate})
    node = next(x for x in walk(plan.fuse_join_aggregates(port_plan))
                if isinstance(x, FusedJoinAggregate))
    tables = {"b": Batch.from_numpy(build, device="cpu"),
              "p": Batch.from_numpy(probe, device="cpu")}
    assert plan.fused_replay(node, tables["b"].columns,
                             tables["p"].columns) is None
    monkeypatch.setattr(plan, "join_aggregate",
                        lambda *a: pytest.fail("K1 called"))
    out, ovf, esc = compile_plan(port_plan, 4096)(tables)
    assert not bool(ovf) and not bool(esc)

    ref_plan = _callable_filter_plan({"Join": RefJoin, "Scan": RefScan,
                                      "Filter": RefFilter,
                                      "Aggregate": RefAggregate})
    rout, rovf = ref_compile_plan(ref_plan, 4096)(
        {"b": RefBatch.from_numpy(build), "p": RefBatch.from_numpy(probe)})
    assert not bool(rovf)
    g = {k: v.numpy()[out.valid.numpy()] for k, v in out.columns.items()}
    rv = np.asarray(rout.valid)
    w = {k: np.asarray(v)[rv] for k, v in rout.columns.items()}
    assert len(g["k"]) > 0
    assert _rows(g, ["k", "m"]) == _rows(w, ["k", "m"])

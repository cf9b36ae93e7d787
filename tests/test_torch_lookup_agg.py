"""Kernel K4 (filter, unique lookup and count in one probe pass) and the plan
rule that routes to it (``plan.FusedLookupAggregate``), on the CPU: K4's
plain version against the unfused lowering and numpy on adversarial cases
(``torch_kernel_cases``), YSB through the executor, the stream driver and
the sharded executor against numpy, the ``lower.lookup_agg`` counter, and
the plans the rule must leave as they were (PyTorch port, CPU)."""

import numpy as np
import pytest
import torch

import oracle
from flock_tpu import plan as ref_plan
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.sql.catalog import ysb_catalog as ref_ysb_catalog
from flock_tpu.sql.lower import sql_to_spec as ref_sql_to_spec
from flock_tpu_torch import plan
from flock_tpu_torch.batch import Batch
from flock_tpu_torch.datagen.ysb import YsbConfig
from flock_tpu_torch.ops import join_agg, lookup_agg
from flock_tpu_torch.parallel.executor import DistributedExecutor
from flock_tpu_torch.plan import (Aggregate, Conj, Filter,
                                  FusedJoinAggregate, FusedLookupAggregate,
                                  Join, Scan, fuse_join_aggregates, lower,
                                  walk)
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.queries.ysb import (campaign_table, generate_ysb_epochs,
                                         ysb_capacities, ysb_query)
from flock_tpu_torch.runtime.executor import (LocalExecutor,
                                              materialize_columns)
from flock_tpu_torch.runtime.stream import StreamDriver
from flock_tpu_torch.sql.catalog import ysb_catalog
from flock_tpu_torch.sql.lower import sql_to_spec
from flock_tpu_torch.utils.metrics import METRICS
from torch_kernel_cases import (K4_CASES, k4_case, k4_numpy, k4_slots,
                                k4_terms)

torch.set_num_threads(1)

YSB_SQL = ("SELECT campaign_id, Count(*) AS count FROM ad_event INNER JOIN "
           "campaign ON ad_id = c_ad_id WHERE event_type = 'view' "
           "GROUP BY campaign_id;")


def _batch(table: dict) -> Batch:
    return Batch({c: torch.from_numpy(v) for c, v in table.items()
                  if c != "valid"}, torch.from_numpy(table["valid"]))


def _k4_plan(terms, cap):
    views = Filter(Scan("ev"), Conj(terms))
    join = Join(build=Scan("camp"), probe=views, build_key="k",
                probe_key="ad", take=(("cid", "cid"),), unique_build=True)
    return Aggregate(join, ("cid",), ((None, "count", "n"),),
                     out_capacity=cap)


def _rows(out: plan.Lowered) -> dict:
    valid = out.valid.numpy()
    return dict(zip(out.cols["cid"].numpy()[valid].tolist(),
                    out.cols["n"].numpy()[valid].tolist()))


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_plain_equals_unfused_and_numpy(case):
    """The fused node's lowering (K2's build slotting, then K4's plain
    version) against the unfused plan and numpy: the same rows and flags;
    a span past the capacity escapes and its rerun (the fallback) gives
    numpy's rows; repeated build keys overflow as the unique join's do."""
    build, events, cap = k4_case(case)
    terms = k4_terms(case)
    tables = {"camp": _batch(build), "ev": _batch(events)}
    unfused_plan = _k4_plan(terms, cap)
    fused_plan = fuse_join_aggregates(unfused_plan)
    assert isinstance(fused_plan, FusedLookupAggregate)
    before = METRICS.counters["lower.lookup_agg"]
    fused = lower(fused_plan, tables)
    assert METRICS.counters["lower.lookup_agg"] == before + 1
    unfused = lower(unfused_plan, tables)
    assert not bool(unfused.escape)
    if case == "dup_keys":
        assert bool(fused.overflow) and bool(unfused.overflow)
        return
    assert not bool(fused.overflow) and not bool(unfused.overflow)
    want = k4_numpy(build, events, terms)
    assert _rows(unfused) == want
    if case == "wide_span":
        assert bool(fused.escape)
        rerun = lower(fused_plan, tables, fallback=True)
        assert not bool(rerun.overflow) and _rows(rerun) == want
        assert METRICS.counters["lower.lookup_agg"] == before + 1
        return
    assert not bool(fused.escape)
    assert _rows(fused) == want
    assert fused.cols["n"].dtype == unfused.cols["n"].dtype == torch.int32
    assert fused.cols["cid"].dtype == torch.int32
    assert fused.valid.shape == unfused.valid.shape == (cap,)
    if case in ("no_valid", "no_view", "empty_build"):
        assert not want and not fused.valid.any()


@pytest.mark.parametrize("case", ["ysb", "misses", "wide_span", "ragged",
                                  "two_terms", "op!="])
def test_k4_plain_slots_and_counts(case):
    """K4's wrapper on slot tables made by numpy (``k4_slots``): slot i
    holds the least present campaign plus i, the count of that campaign's
    passing events, ``valid = count > 0``, and the escape flag."""
    build, events, cap = k4_case(case)
    terms = k4_terms(case)
    taken, present, m = k4_slots(build)
    cols = {c: torch.from_numpy(events[c]) for c in ("et", "x", "y")}
    cnt, key, valid, esc = lookup_agg.lookup_aggregate(
        torch.from_numpy(taken), torch.from_numpy(present),
        torch.tensor(int(m), dtype=torch.int32),
        torch.from_numpy(events["ad"]), torch.from_numpy(events["valid"]),
        cols, Conj(terms), cap)
    cmin = int(taken[present].min())
    assert key.tolist() == [cmin + i for i in range(cap)]
    assert bool(esc) == (int(taken[present].max()) - cmin >= cap)
    want = k4_numpy(build, events, terms)
    got = {cmin + i: c for i, c in enumerate(cnt.tolist()) if c}
    assert torch.equal(valid, cnt > 0)
    if case != "wide_span":
        assert got == want


def test_k4_refuses_what_it_cannot_take():
    """More slots than 32 lane copies fit, an int64 literal, and a column
    the terms read that was not given raise; ``fits`` says which."""
    assert lookup_agg.fits(256, Conj((("et", "==", 0),)))
    assert not lookup_agg.fits(257, None)
    assert not lookup_agg.fits(128, Conj((("et", "==", 2**31),)))
    build, events, cap = k4_case("ysb", n=64)
    taken, present, m = k4_slots(build)
    args = (torch.from_numpy(taken), torch.from_numpy(present),
            torch.tensor(int(m), dtype=torch.int32),
            torch.from_numpy(events["ad"]),
            torch.from_numpy(events["valid"]))
    with pytest.raises(NotImplementedError):
        lookup_agg.lookup_aggregate(*args, {}, None, 257)
    with pytest.raises(KeyError):
        lookup_agg.lookup_aggregate(*args, {}, Conj((("et", "==", 0),)), cap)
    with pytest.raises(TypeError):
        Conj((("et", "==", 1.5),))


def _ysb_epochs(seed: int, seconds: int = 20, eps: int = 1500):
    """YSB's epochs with the ad ids and event types drawn from ``seed``
    (the program's generator reseeds each epoch alike), the campaign table
    riding with each window's first epoch."""
    cfg = YsbConfig(seconds=seconds, events_per_second=eps, threads=2)
    rng = np.random.default_rng(seed)
    epochs = generate_ysb_epochs(cfg)
    camp = campaign_table(cfg)
    for t, e in enumerate(epochs):
        ev = e["ad_event"]
        n = len(ev["ad_id"])
        ev["ad_id"] = rng.integers(0, cfg.num_ads, n).astype(np.int32)
        ev["event_type"] = rng.integers(0, 3, n).astype(np.int32)
        e["campaign"] = camp if t % 10 == 0 else \
            {k: v[:0] for k, v in camp.items()}
    return cfg, epochs


def _same_as_oracle(columns: dict, events: dict):
    want = oracle.ysb(events)
    assert columns["campaign_id"].tolist() == want["campaign_id"].tolist()
    assert columns["count"].tolist() == want["count"].tolist()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ysb_executor_and_driver_equal_reference(seed):
    """YSB's hand plan through ``LocalExecutor.execute_window`` and
    ``StreamDriver.run`` on seeded events: numpy's rows per window, one
    K4 lowering a window (``lower.lookup_agg``) and no escape."""
    cfg, epochs = _ysb_epochs(seed)
    spec = ysb_query()
    before = METRICS.counters["lower.lookup_agg"]
    driver = StreamDriver(spec, cfg.seconds, device="cpu")
    results = driver.run(epochs)
    assert len(results) == 2
    ex = LocalExecutor(spec, device="cpu")
    for k, res in enumerate(results):
        chunk = epochs[10 * k:10 * k + 10]
        events = {c: np.concatenate([e["ad_event"][c] for e in chunk])
                  for c in chunk[0]["ad_event"]}
        _same_as_oracle(res.columns, events)
        out = ex.materialize(ex.execute_window(
            {"ad_event": events, "campaign": campaign_table(cfg)},
            ysb_capacities(cfg, 10)))
        _same_as_oracle(out, events)
    assert METRICS.counters["lower.lookup_agg"] - before == 4
    assert driver.executor.fallback_runs == ex.fallback_runs == 0


def test_lookup_agg_counter_counts_each_window():
    """``lower.lookup_agg`` counts one a window through ``execute_epochs``
    and the span ``execute.fallback`` none: K4 served every window."""
    cfg, epochs = _ysb_epochs(4)
    driver = StreamDriver(ysb_query(), cfg.seconds, device="cpu")
    staged = driver.stage_epochs(epochs, driver.epoch_caps(epochs))
    ex = driver.executor
    before = METRICS.counters["lower.lookup_agg"]
    fell = METRICS.spans["execute.fallback"][0]
    with METRICS.tracing():
        for _, rng in driver.epoch_ranges(epochs):
            ex.materialize(ex.execute_epochs([staged[t] for t in rng]))
    assert METRICS.counters["lower.lookup_agg"] - before == 2
    assert METRICS.spans["execute.fallback"][0] == fell
    assert ex.fallback_runs == 0


def test_sharded_ysb_lowers_the_fallback_and_equals_reference():
    """``DistributedExecutor`` keeps the node in its plan and lowers its
    fallback (the two-phase aggregate over the broadcast join): numpy's
    rows, and no K4 lowering."""
    cfg = YsbConfig(seconds=2, events_per_second=4000, threads=4)
    epochs = generate_ysb_epochs(cfg)
    camp = campaign_table(cfg)
    events = {k: np.concatenate([e["ad_event"][k] for e in epochs])
              for k in epochs[0]["ad_event"]}
    n = 4
    shards = [{"ad_event": {k: v[i::n] for k, v in events.items()},
               "campaign": camp if i == 0 else
               {k: v[:0] for k, v in camp.items()}} for i in range(n)]
    spec = ysb_query()
    dist = DistributedExecutor(spec, n, device="cpu")
    assert isinstance(dist.plan, FusedLookupAggregate)
    before = METRICS.counters["lower.lookup_agg"]
    out = materialize_columns(spec, dist.execute_window(shards))
    assert METRICS.counters["lower.lookup_agg"] == before
    order = np.argsort(out["campaign_id"], kind="stable")
    _same_as_oracle({k: v[order] for k, v in out.items()}, events)


def _types(root) -> list[str]:
    return [type(n).__name__ for n in walk(root)]


def test_ysb_hand_plan_fuses_to_lookup_aggregate():
    fused = fuse_join_aggregates(ysb_query().plan)
    assert _types(fused) == ["Scan", "Scan", "Join", "FusedLookupAggregate"]
    assert (fused.taken, fused.group_key, fused.out_capacity) == \
        ("campaign_id", "campaign_id", 128)
    assert fused.pred == Conj((("event_type", "==", 0),))
    assert isinstance(fused.fallback, Aggregate)
    assert isinstance(fused.fallback.child, Join)
    # the join keeps its build side and takes the Filter off its probe
    assert isinstance(fused.join.probe, Scan)
    assert fused.join.probe.relation == "ad_event"


@pytest.mark.parametrize("which", ["q4", "q5", "q7", "q13", "sql-ysb"])
def test_other_plans_lower_to_the_same_nodes(which):
    """Every other plan's fused form has the node types of flock_tpu's
    ``fuse_join_aggregates`` of the same plan, none of them the new node."""
    if which == "sql-ysb":
        port = sql_to_spec(YSB_SQL, ysb_catalog()).plan
        ref = ref_sql_to_spec(YSB_SQL, ref_ysb_catalog()).plan
    else:
        port = get_query(int(which[1:])).plan
        ref = ref_get_query(int(which[1:])).plan
    got = _types(fuse_join_aggregates(port))
    assert "FusedLookupAggregate" not in got
    assert got == _types(ref_plan.fuse_join_aggregates(ref))


def test_k1_node_with_literal_term_takes_unfused_path(monkeypatch):
    """A FusedJoinAggregate whose middle Filter has a literal term: K1
    refuses it (``fits_kernel``), so the node lowers its unfused fallback
    on the CPU, never the fused pass, and its rows equal numpy's."""
    rng = np.random.default_rng(11)
    nb, n = 300, 5000
    auctions = {"a_id": (7 + np.arange(nb)).astype(np.int32),
                "cat": rng.integers(0, 5, nb).astype(np.int32),
                "valid": np.ones(nb, bool)}
    bids = {"auction": rng.integers(0, nb + 20, n).astype(np.int32),
            "price": rng.integers(0, 100, n).astype(np.int32),
            "valid": rng.random(n) < 0.9}
    join = Join(build=Scan("auction"), probe=Scan("bid"), build_key="a_id",
                probe_key="auction", take=(("cat", "cat"),))
    agg = Aggregate(Filter(join, Conj((("price", ">", 50),))), ("auction",),
                    ((None, "count", "n"), ("price", "max", "mx")),
                    out_capacity=nb + 64)
    fused = fuse_join_aggregates(agg)
    assert isinstance(fused, FusedJoinAggregate)
    assert not join_agg.fits_kernel(("cat",), (), (("price", ">", 50),),
                                    [("price", "max", "mx")])

    def refuse(*a, **k):
        raise AssertionError("the fused pass ran")

    monkeypatch.setattr(plan, "fused_local_pass", refuse)
    out = lower(fused, {"auction": _batch(auctions), "bid": _batch(bids)})
    ok = bids["valid"] & (bids["price"] > 50) & (bids["auction"] >= 7) \
        & (bids["auction"] < 7 + nb)
    want = {}
    for a, p in zip(bids["auction"][ok].tolist(), bids["price"][ok].tolist()):
        c, mx = want.get(a, (0, -1))
        want[a] = (c + 1, max(mx, p))
    valid = out.valid.numpy()
    got = dict(zip(out.cols["auction"].numpy()[valid].tolist(),
                   zip(out.cols["n"].numpy()[valid].tolist(),
                       out.cols["mx"].numpy()[valid].tolist())))
    assert got == want


def test_conj_literal_terms_compare_with_the_literal():
    cols = {"a": torch.tensor([0, 1, 2, 3], dtype=torch.int32),
            "b": torch.tensor([3, 1, 0, 3], dtype=torch.int32)}
    for op, want in (("<", [1, 0, 0, 0]), ("<=", [1, 1, 0, 0]),
                     (">", [0, 0, 1, 1]), (">=", [0, 1, 1, 1]),
                     ("==", [0, 1, 0, 0]), ("!=", [1, 0, 1, 1])):
        assert Conj((("a", op, 1),))(cols).tolist() == [bool(w) for w in want]
    two = Conj((("a", "<=", 2), ("a", "<", "b")))
    assert two(cols).tolist() == [True, False, False, False]
    assert two.columns() == ["a", "b"]

"""The q3, q9 and q13 slice end to end on the CPU: the port's StreamDriver
against flock_tpu's on the same generated epochs, sink rows and device
columns compared exactly, in the clean configuration (2 s × 20,000 events/s,
element-wise windows) and in the G=3 duplicate configuration (one 10 s
window, tests/test_sqlite_oracle.py's) for q3 and q9; every result also
against tests/oracle.py.  Then the lookup join's contracts: a clean window
runs no fan-out, q3's duplicate persons take one rerun, q13's duplicate
side-input keys end in OverflowError, the side input is staged once, and
a join on float keys (the sorted lookup) equals the reference's (PyTorch
port, CPU)."""

import functools

import numpy as np
import pytest
import torch

import oracle
from flock_tpu.batch import Schema as RefSchema
from flock_tpu.queries.nexmark import NAME_VOCAB as REF_NAME_VOCAB
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime.executor import LocalExecutor as RefExecutor
from flock_tpu.runtime.executor import OverflowError as RefOverflowError
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu.runtime.tables import load_side_input_csv as ref_load_csv
from flock_tpu_torch.batch import Schema
from flock_tpu_torch.queries.nexmark import NAME_VOCAB, get_query
from flock_tpu_torch.runtime.executor import LocalExecutor, OverflowError
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
from flock_tpu_torch.runtime.tables import (concat_relations,
                                            default_side_input,
                                            load_side_input_csv)

torch.set_num_threads(1)

# (seconds, events/s, generators, one window over the whole stream)
CONFIGS = {"clean": (2, 20_000, 1, False),
           "duplicates": (10, 350, 3, True)}
CASES = [(3, "clean"), (9, "clean"), (13, "clean"), (3, "duplicates"),
         (9, "duplicates")]
# duplicate auction ids reach q9's fused pass; the generator never repeats
# a person id, so q3's G=3 window is clean in both engines
RERUNS = {(9, "duplicates"): 1}


@functools.lru_cache(maxsize=None)
def _epochs(config):
    seconds, eps, gens, _ = CONFIGS[config]
    return generate_epochs(seconds, eps, gens)


def _ranges(config):
    seconds, _, _, single = CONFIGS[config]
    return [list(range(seconds))] if single else [[t] for t in range(seconds)]


def _windows(config):
    rels = ("person", "auction", "bid")
    return [concat_relations([_epochs(config)[t] for t in rng], rels)
            for rng in _ranges(config)]


def _oracle(q, w):
    if q == 3:
        return oracle.q3(w["person"], w["auction"])
    if q == 9:
        return oracle.q9(w["auction"], w["bid"])
    return oracle.q13(w["bid"], default_side_input())


def _rows(cols, names):
    return sorted(zip(*(np.asarray(cols[n]).tolist() for n in names)))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"q{q}-{c}" for q, c in CASES])
def case(request):
    q, config = request.param
    seconds, _, _, single = CONFIGS[config]
    port = StreamDriver(get_query(q), seconds, device="cpu")
    ref = RefDriver(ref_get_query(q), seconds)
    if single:
        whole = [(("win", 0, seconds), list(range(seconds)))]
        port._window_epoch_ranges = lambda occupancy=None: whole
        ref._window_epoch_ranges = lambda occupancy=None: whole
    got = port.run(_epochs(config))
    return q, config, port, got, ref.run(_epochs(config))


def test_sink_rows_equal_reference(case):
    q, config, port, got, want = case
    names = get_query(q).schema.names
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.tag == w.tag
        assert list(g.columns) == names
        for name in names:
            gv, wv = g.columns[name], np.asarray(w.columns[name])
            assert gv.dtype == wv.dtype, name
            np.testing.assert_array_equal(gv, wv, err_msg=name)
    assert sum(len(g.columns[names[0]]) for g in got) > 0
    assert port.executor.fallback_runs == RERUNS.get((q, config), 0)


def test_sink_rows_equal_oracle(case):
    q, config, _, got, _ = case
    names = get_query(q).schema.names
    for r, w in zip(got, _windows(config)):
        assert _rows(r.columns, names) == _rows(_oracle(q, w), names)


def test_device_columns_equal_reference(case):
    """The device output window by window: the same capacity, validity and
    values in every valid row."""
    q, config, _, _, _ = case
    port = LocalExecutor(get_query(q), device="cpu")
    ref = RefExecutor(ref_get_query(q))
    rels = get_query(q).relations
    for w in _windows(config):
        tables = {r: w[r] for r in rels if r != "side_input"}
        g = port.execute_window(tables)
        if q == 13:
            tables = dict(tables, side_input=default_side_input())
        r = ref.execute_window(tables)
        rv = np.asarray(r.valid)
        np.testing.assert_array_equal(g.valid.numpy(), rv)
        assert set(g.columns) == set(r.columns)
        for name, col in r.columns.items():
            np.testing.assert_array_equal(g.columns[name].numpy()[rv],
                                          np.asarray(col)[rv], err_msg=name)


@pytest.mark.parametrize("q", [3, 9, 13])
def test_clean_window_runs_no_fan_out(q, monkeypatch):
    """No sort and no binary search run in a clean window: the lookup join
    gathers, and the fan-out waits for a rerun that never comes."""
    calls = []
    for name in ("sort", "searchsorted"):
        orig = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    driver = StreamDriver(get_query(q), 2, device="cpu")
    got = driver.run(_epochs("clean"))
    assert driver.executor.fallback_runs == 0 and not calls
    assert sum(len(r.columns["a_id" if q == 3 else "auction"])
               for r in got) > 0


def _duplicate_persons():
    """The G=3 window with every person row repeated under another name,
    city and state inside the filter: each seller joins twice."""
    w = _windows("duplicates")[0]
    p = w["person"]
    twin = dict(p, name=(p["name"] + 1) % len(NAME_VOCAB),
                city=(p["city"] + 1) % 10, state=np.full_like(p["state"], 3))
    return dict(w, person={k: np.concatenate([p[k], twin[k]]) for k in p})


def test_duplicate_persons_take_one_rerun():
    w = _duplicate_persons()
    tables = {"person": w["person"], "auction": w["auction"]}
    port = LocalExecutor(get_query(3), device="cpu")
    got = port.materialize(port.execute_window(tables))
    assert port.fallback_runs == 1
    ref = RefExecutor(ref_get_query(3))
    want = ref.materialize(ref.execute_window(tables))
    names = get_query(3).schema.names
    assert _rows(got, names) == _rows(want, names) \
        == _rows(oracle.q3(w["person"], w["auction"]), names)
    assert len(got["a_id"]) > len(set(got["a_id"].tolist()))


def test_duplicate_side_input_keys_overflow():
    """Duplicate side-input keys are an overflow, not a rerun: after the
    widen-and-retry budget the driver raises OverflowError, as the
    reference does."""
    si = default_side_input(300)
    si = {k: np.concatenate([v, v[:5]]) for k, v in si.items()}
    driver = StreamDriver(get_query(13), 2, side_input=si, device="cpu")
    with pytest.raises(OverflowError):
        driver.run(_epochs("clean"))
    assert driver.executor.fallback_runs == 0
    tables = {"bid": _windows("clean")[0]["bid"], "side_input": si}
    with pytest.raises(RefOverflowError):
        RefExecutor(ref_get_query(13)).execute_window(tables)


def test_side_input_is_staged_once(tmp_path):
    """A side input from CSV, loaded as the reference loads it, staged on
    the device once and shared by every window."""
    path = tmp_path / "side.csv"
    path.write_text("".join(f"{k},{3 * k}\n" for k in range(1000, 12000, 3)))
    si = load_side_input_csv(str(path))
    for k, v in ref_load_csv(str(path)).items():
        np.testing.assert_array_equal(si[k], v)
        assert si[k].dtype == v.dtype
    driver = StreamDriver(get_query(13), 2, side_input=si, device="cpu")
    staged = driver.executor.statics()
    got = driver.run(_epochs("clean"))
    assert driver.executor.statics() is staged
    assert staged["side_input"].capacity == 3712   # 3667 rows, 128-rounded
    names = get_query(13).schema.names
    for r, w in zip(got, _windows("clean")):
        assert _rows(r.columns, names) == _rows(oracle.q13(w["bid"], si), names)
        assert len(r.columns["value"])


def test_schema_and_vocabularies_match_reference():
    """A positional Schema means the same in both packages."""
    args = (["a", "t"], {"a": ["x", "y"]}, ("t",))
    assert Schema(*args).__dict__ == RefSchema(*args).__dict__
    assert NAME_VOCAB == REF_NAME_VOCAB
    for q in (3, 9, 13):
        mine, ref = get_query(q), ref_get_query(q)
        assert mine.relations == ref.relations and mine.window == ref.window
        assert mine.schema.__dict__ == ref.schema.__dict__


def test_q9_rerun_keeps_the_second_join_slotted(monkeypatch):
    """The duplicate window's rerun lowers the fused pass to its single-key
    Aggregate, whose output is still slot-dense: the second join reuses it
    as its build side in both passes; only the inner join fans out."""
    from flock_tpu_torch import plan

    calls = []
    orig = plan.kernels.lookup_join

    def spy(*a, **kw):
        calls.append((kw["build_slotted"], kw["fallback"]))
        return orig(*a, **kw)

    monkeypatch.setattr(plan.kernels, "lookup_join", spy)
    w = _windows("duplicates")[0]
    ex = LocalExecutor(get_query(9), device="cpu")
    ex.execute_window({"auction": w["auction"], "bid": w["bid"]})
    assert ex.fallback_runs == 1
    assert calls == [(True, False), (False, True), (True, True)]


def _float_key_inputs(case):
    """(build, probe) host columns: tests/test_blocked_kernels.py:91's
    inputs (misses every 7th probe), or the edges — an invalid build row,
    a duplicate float key (the first match in the stable order wins), a
    NaN build key and a NaN probe (never a hit), -0.0 against 0.0 (equal)
    and an invalid probe row."""
    if case == "reference_inputs":
        rng = np.random.default_rng(7)
        bk = np.arange(50, dtype=np.float32) * 2.5 + 10.0
        build = {"fk": bk, "payload": np.arange(50, dtype=np.int32) * 3}
        probe_keys = bk[rng.integers(0, 50, 256)]
        probe_keys[::7] = -1.0
        probe = {"fk": probe_keys.astype(np.float32),
                 "v": rng.integers(0, 100, 256).astype(np.int32)}
        return build, probe, None
    build = {"fk": np.array([3.0, 1.0, -0.0, 2.0, 1.0, 5.0, np.nan, 7.5],
                            np.float32),
             "payload": np.arange(8, dtype=np.int32) * 10 + 1}
    build_valid = np.array([True] * 5 + [False, True, True])
    probe = {"fk": np.array([1.0, 0.0, -0.0, 2.0, 5.0, np.nan, 7.5, 4.0,
                             3.0, 1.0], np.float32),
             "v": np.arange(10, dtype=np.int32)}
    return build, probe, build_valid


@pytest.mark.parametrize("case", ["reference_inputs", "edges"])
def test_float_key_join_equals_reference(case):
    """A join on float keys lowers to ``kernels.sorted_lookup_join`` (sort
    the build side, binary-search the probes): the same validity and the
    same taken values as flock_tpu's ``compile_plan``, no overflow."""
    from flock_tpu.batch import Batch as RefBatch
    from flock_tpu.plan import Join as RefJoin
    from flock_tpu.plan import Scan as RefScan
    from flock_tpu.plan import compile_plan as ref_compile_plan
    from flock_tpu_torch.batch import Batch
    from flock_tpu_torch.plan import Join, Scan, compile_plan

    build, probe, build_valid = _float_key_inputs(case)
    kw = dict(build_key="fk", probe_key="fk", take=(("payload", "payload"),))
    port_in = {"b": Batch.from_numpy(build, device="cpu"),
               "p": Batch.from_numpy(probe, device="cpu")}
    ref_in = {"b": RefBatch.from_numpy(build), "p": RefBatch.from_numpy(probe)}
    if build_valid is not None:
        n = len(build_valid)
        port_in["b"].valid[:n] = torch.from_numpy(build_valid)
        ref_in["b"] = RefBatch(ref_in["b"].columns,
                               ref_in["b"].valid.at[:n].set(build_valid))
    out, ovf, esc = compile_plan(Join(build=Scan("b"), probe=Scan("p"), **kw),
                                 4096)(port_in)
    rout, rovf = ref_compile_plan(RefJoin(build=RefScan("b"),
                                          probe=RefScan("p"), **kw),
                                  4096)(ref_in)
    assert not bool(ovf) and not bool(esc) and not bool(rovf)
    rv = np.asarray(rout.valid)
    np.testing.assert_array_equal(out.valid.numpy(), rv)
    assert set(out.columns) == set(rout.columns)
    for name, col in rout.columns.items():
        np.testing.assert_array_equal(out.columns[name].numpy()[rv],
                                      np.asarray(col)[rv], err_msg=name)
    if case == "edges":
        # 1.0 → the first of its two build rows; 0.0 and -0.0 → the -0.0
        # row; 5.0 (invalid build row), NaN and 4.0 miss
        got = dict(zip(range(10), out.columns["payload"].numpy().tolist()))
        hit = out.valid.numpy()[:10].tolist()
        assert hit == [True, True, True, True, False, False, True, False,
                       True, True]
        assert [got[i] for i in (0, 1, 2, 3, 6, 8, 9)] == [11, 21, 21, 31,
                                                           71, 1, 11]
    else:
        assert rv.sum() == 256 - len(range(0, 256, 7))


I32_MAX = 2**31 - 1
# (build slot-0 key, build capacity, build valid share, probe slot-0 key,
#  probe capacity, probe valid share): overlapping either way round, no
# overlap above or below, a side with no valid row (the sentinel as its
# slot-0 key), and both empty
SLOT_JOIN_CASES = {
    "probe_inside": (1000, 600, 0.7, 1100, 300, 0.8),
    "probe_before": (1000, 300, 0.7, 900, 600, 0.8),
    "probe_above": (1000, 300, 0.9, 1300, 200, 1.0),
    "probe_below": (1000, 300, 0.9, 500, 200, 1.0),
    "build_far_below": (-2**31 + 5, 128, 1.0, 2**31 - 200, 128, 1.0),
    "empty_build": (I32_MAX, 256, 0.0, 1000, 128, 1.0),
    "empty_probe": (1000, 256, 1.0, I32_MAX, 384, 0.0),
    "both_empty": (I32_MAX, 128, 0.0, I32_MAX, 128, 0.0),
}


def _slotted(rng, m, cap, share):
    keys = (np.int64(m) + np.arange(cap)).astype(np.int32)   # wraps as K2's
    return ({"k": keys, "v": rng.integers(0, 100, cap).astype(np.int32),
             "w": rng.integers(-9, 9, cap).astype(np.int64)},
            rng.random(cap) < share)


@pytest.mark.parametrize("case", list(SLOT_JOIN_CASES))
def test_slot_join_equals_reference(case):
    """``kernels.slot_join`` (a join of two slot-dense sides, q8's) against
    the reference's on the same inputs: every output column and the hit
    mask equal, row for row."""
    import jax.numpy as jnp

    from flock_tpu.ops.kernels import slot_join as ref_slot_join
    from flock_tpu_torch.ops.kernels import slot_join

    rng = np.random.default_rng(len(case))
    mb, bcap, bshare, mp, pcap, pshare = SLOT_JOIN_CASES[case]
    bcols, bvalid = _slotted(rng, mb, bcap, bshare)
    pcols, pvalid = _slotted(rng, mp, pcap, pshare)
    pcols.pop("w")
    take = {"v": "bv", "w": "bw"}
    got, ghit, govf = slot_join(
        {k: torch.from_numpy(v) for k, v in bcols.items()},
        torch.from_numpy(bvalid), "k",
        {k: torch.from_numpy(v) for k, v in pcols.items()},
        torch.from_numpy(pvalid), "k", take)
    want, whit, wovf = ref_slot_join(
        {k: jnp.asarray(v) for k, v in bcols.items()}, jnp.asarray(bvalid),
        "k", {k: jnp.asarray(v) for k, v in pcols.items()},
        jnp.asarray(pvalid), "k", take)
    np.testing.assert_array_equal(ghit.numpy(), np.asarray(whit))
    assert list(got) == list(want) and not bool(govf) and not bool(wovf)
    for name, col in want.items():
        assert got[name].numpy().dtype == np.asarray(col).dtype, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(col),
                                      err_msg=name)
    if case in ("probe_inside", "probe_before"):
        assert ghit.any()
    elif case != "build_far_below":
        assert not ghit.any()


@pytest.mark.parametrize("empty", ["none", "build", "probe"])
def test_slot_join_lowering_equals_reference(empty):
    """Join(Aggregate, Aggregate) on integer keys lowers to ``slot_join`` in
    both engines, with a side that has no valid row too."""
    import jax.numpy as jnp

    from flock_tpu.batch import Batch as RefBatch
    from flock_tpu.plan import Aggregate as RefAggregate
    from flock_tpu.plan import Join as RefJoin
    from flock_tpu.plan import Scan as RefScan
    from flock_tpu.plan import compile_plan as ref_compile
    from flock_tpu_torch.batch import Batch
    from flock_tpu_torch.plan import Aggregate, Join, Scan, compile_plan

    rng = np.random.default_rng(8)
    n = 256
    host = {"b": {"k": rng.integers(100, 400, n).astype(np.int32),
                  "v": rng.integers(0, 99, n).astype(np.int32)},
            "p": {"k": rng.integers(300, 600, n).astype(np.int32),
                  "v": rng.integers(0, 99, n).astype(np.int32)}}
    valid = {r: rng.random(n) < (0.0 if empty[0] == r else 0.8)
             for r in ("b", "p")}

    def plan(A, J, S):
        return J(build=A(S("b"), ("k",), (("v", "max", "v"),)),
                 probe=A(S("p"), ("k",), ()), build_key="k", probe_key="k",
                 take=(("v", "bv"),))

    out, ovf, esc = compile_plan(plan(Aggregate, Join, Scan), 1024)(
        {r: Batch({k: torch.from_numpy(v) for k, v in c.items()},
                  torch.from_numpy(valid[r])) for r, c in host.items()})
    ref, rovf = ref_compile(plan(RefAggregate, RefJoin, RefScan), 1024)(
        {r: RefBatch({k: jnp.asarray(v) for k, v in c.items()},
                     jnp.asarray(valid[r])) for r, c in host.items()})
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(out.valid.numpy(), rv)
    assert set(out.columns) == set(ref.columns) == {"k", "bv"}
    for name, col in ref.columns.items():
        np.testing.assert_array_equal(out.columns[name].numpy()[rv],
                                      np.asarray(col)[rv], err_msg=name)
    assert not bool(ovf) and not bool(esc) and not bool(rovf)
    assert rv.any() == (empty == "none")

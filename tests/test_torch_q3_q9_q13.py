"""The q3, q9 and q13 slice end to end on the CPU: the port's StreamDriver
against flock_tpu's on the same generated epochs, sink rows and device
columns compared exactly, in the clean configuration (2 s × 20,000 events/s,
element-wise windows) and in the G=3 duplicate configuration (one 10 s
window, tests/test_sqlite_oracle.py's) for q3 and q9; every result also
against tests/oracle.py.  Then the lookup join's contracts: a clean window
runs no fan-out, q3's duplicate persons take one rerun, q13's duplicate
side-input keys end in OverflowError, and the side input is staged once
(PyTorch port, CPU)."""

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
        port._window_epoch_ranges = lambda: whole
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


def _join_plan(build, probe, key):
    from flock_tpu_torch.plan import Join, Project

    return Project(Join(build=build, probe=probe, build_key=key, probe_key=key,
                        take=(("v", "v"),)), (("k", "k"),))


@pytest.mark.parametrize("kind", ["slot_join", "float_keys"])
def test_join_lowering_refuses_unported_modes(kind):
    """A join of two slot-dense sides (slot_join, q8's) and a join on float
    keys (sorted_lookup_join) are not on this slice's path: both raise."""
    from flock_tpu_torch.batch import Batch
    from flock_tpu_torch.plan import Aggregate, Scan, compile_plan

    n = 256
    k = np.arange(n, dtype=np.float32 if kind == "float_keys" else np.int32)
    cols = {"k": torch.from_numpy(k), "v": torch.arange(n, dtype=torch.int32)}
    tables = {"r": Batch(cols, torch.ones(n, dtype=torch.bool))}
    if kind == "slot_join":
        side = Aggregate(Scan("r"), ("k",), (("v", "max", "v"),))
        root, match = _join_plan(side, side, "k"), "slot_join"
    else:
        root, match = _join_plan(Scan("r"), Scan("r"), "k"), "float keys"
    with pytest.raises(NotImplementedError, match=match):
        compile_plan(root, 1024)(tables)

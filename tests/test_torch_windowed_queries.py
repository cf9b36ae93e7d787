"""NEXMark q0, q1, q2, q5, q7, q8 and q10 end to end on the CPU: the port's
StreamDriver against flock_tpu's on the same generated epochs
(tests/test_queries.py's 12 s × 500 events/s, 2 generators, and q8 also in
the G=3 configuration), sink rows exactly equal — tags, column order,
dtypes (q1's f64 ``price``) and values — and equal to tests/oracle.py; then
each window's device output from ``execute_epochs`` against the
reference's ``execute_epochs`` on the same per-epoch batches: capacity,
validity and the values in valid rows (PyTorch port, CPU)."""

import functools

import numpy as np
import pytest
import torch

import oracle
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime.executor import LocalExecutor as RefExecutor
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs

torch.set_num_threads(1)

CONFIGS = {"bench": (12, 500, 2), "duplicates": (10, 350, 3)}
CASES = [(q, "bench") for q in (0, 1, 2, 5, 7, 8, 10)] + [(8, "duplicates")]
ORACLES = {0: oracle.q0, 1: oracle.q1, 2: oracle.q2, 5: oracle.q5,
           7: oracle.q7, 10: oracle.q0}


@functools.lru_cache(maxsize=None)
def _epochs(config):
    return generate_epochs(*CONFIGS[config])


def _rows(cols, names):
    return sorted(zip(*(np.asarray(cols[n]).tolist() for n in names)))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"q{q}-{c}" for q, c in CASES])
def case(request):
    q, config = request.param
    seconds = CONFIGS[config][0]
    port = StreamDriver(get_query(q), seconds, device="cpu")
    got = port.run(_epochs(config))
    want = RefDriver(ref_get_query(q), seconds).run(_epochs(config))
    return q, config, port, got, want


def test_sink_rows_equal_reference(case):
    q, _, port, got, want = case
    names = get_query(q).schema.names
    assert [g.tag for g in got] == [w.tag for w in want]
    assert len(got) == (12 if get_query(q).window == ("elementwise",) else 1)
    for g, w in zip(got, want):
        assert list(g.columns) == names
        for name in names:
            gv, wv = g.columns[name], np.asarray(w.columns[name])
            assert gv.dtype == wv.dtype, name
            np.testing.assert_array_equal(gv, wv, err_msg=name)
    assert sum(len(g.columns[names[0]]) for g in got) > 0
    assert port.executor.fallback_runs == 0
    if q == 1:
        assert got[0].columns["price"].dtype == np.float64


def test_sink_rows_equal_oracle(case):
    q, _, port, got, _ = case
    names = get_query(q).schema.names
    for r, (tag, w) in zip(got, port.windows(_epochs(case[1]))):
        assert r.tag == tag
        want = oracle.q8(w["person"], w["auction"]) if q == 8 \
            else ORACLES[q](w["bid"])
        assert _rows(r.columns, names) == _rows(want, names)


def test_device_columns_equal_reference(case):
    """Each window's device output through ``execute_epochs`` on per-epoch
    batches staged at StreamDriver's uniform capacities, in both engines:
    the same capacity, validity and values in every valid row."""
    q, config, port, _, _ = case
    epochs = _epochs(config)
    caps = port.epoch_caps(epochs)
    staged = port.stage_epochs(epochs, caps)
    ref = RefExecutor(ref_get_query(q))
    ref_staged = [ref.prepare_window({r: e[r] for r in caps}, caps)
                  for e in epochs]
    for tag, rng in port.epoch_ranges(epochs):
        g = port.executor.execute_epochs([staged[t] for t in rng])
        r = ref.execute_epochs([ref_staged[t] for t in rng])
        rv = np.asarray(r.valid)
        assert g.capacity == rv.shape[0]
        if q in (5, 8):   # slotted at the window's aggregate capacity
            assert g.capacity == len(rng) * max(caps.values()) \
                + CONFIG.agg_span_margin
        np.testing.assert_array_equal(g.valid.numpy(), rv, err_msg=str(tag))
        assert set(g.columns) == set(r.columns)
        for name, col in r.columns.items():
            gc = g.columns[name].numpy()
            assert gc.dtype == np.asarray(col).dtype, name
            np.testing.assert_array_equal(gc[rv], np.asarray(col)[rv],
                                          err_msg=name)


def test_q8_lowers_to_slot_join(monkeypatch):
    """q8's join of two slot-dense aggregates runs ``kernels.slot_join``,
    never the lookup join."""
    from flock_tpu_torch import plan

    calls = []
    for name in ("slot_join", "lookup_join"):
        orig = getattr(plan.kernels, name)
        monkeypatch.setattr(plan.kernels, name, lambda *a, _o=orig, _n=name,
                            **k: calls.append(_n) or _o(*a, **k))
    got = StreamDriver(get_query(8), 12, device="cpu").run(_epochs("bench"))
    assert calls == ["slot_join"] and len(got[0].columns["p_id"])


@pytest.mark.parametrize("shape", ["no_aggs", "one_hot_key"])
def test_dense_aggregate_at_the_slice_shapes_equals_reference(shape):
    """K2's plain path at two shapes this slice adds, against the
    reference's ``dense_group_aggregate``: no aggregate column at all
    (q8's distinct sellers) and every row on one key (q5's and q7's max
    over the constant ``__g``)."""
    import jax.numpy as jnp

    from flock_tpu.ops import kernels as ref_kernels
    from flock_tpu_torch.ops import kernels

    rng = np.random.default_rng(11)
    n = 5000
    if shape == "no_aggs":
        keys = rng.integers(1000, 4000, n).astype(np.int32)
        aggs, cap = [], 4096
    else:
        keys = np.zeros(n, np.int32)
        aggs, cap = [("v", "max", "mx")], 8
    v = rng.integers(-(10**8), 10**8, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    got = kernels.dense_group_aggregate(
        {"k": torch.from_numpy(keys), "v": torch.from_numpy(v)},
        torch.from_numpy(valid), "k", aggs, cap)
    ref = ref_kernels.dense_group_aggregate(
        {"k": jnp.asarray(keys), "v": jnp.asarray(v)}, jnp.asarray(valid),
        "k", aggs, cap)
    assert set(got[0]) == set(ref[0]) == {"k", *(a[2] for a in aggs)}
    for name, col in ref[0].items():
        np.testing.assert_array_equal(got[0][name].numpy(), np.asarray(col),
                                      err_msg=name)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert not bool(got[2]) and not bool(ref[2])


def test_shared_subtree_is_lowered_once(monkeypatch):
    """q5's per-auction counts feed both sides of its join: each window
    aggregates twice (the counts, then their max over ``__g``), not three
    times."""
    from flock_tpu_torch import plan

    calls = []
    orig = plan.kernels.group_aggregate
    monkeypatch.setattr(plan.kernels, "group_aggregate", lambda *a, **k:
                        calls.append(a[2]) or orig(*a, **k))
    got = StreamDriver(get_query(5), 12, device="cpu").run(_epochs("bench"))
    assert calls == [["auction"], ["__g"]] and len(got[0].columns["num"])

"""The q12 slice on the CPU: processing-time (global) windows through the
port's StreamDriver against flock_tpu's and ``oracle.q12_window`` on
tests/test_queries.py's configuration (12 s × 500 events/s, 2 generators:
arrival windows [0,10) and [10,12)); ``execute_consts``' fast runner (one
count per chunk, shifted and summed) against its general runner on the
same staged chunks; a forced overflow widen against the reference's; an
int64 group key, which takes the general runner in both engines;
``run(prestaged=...)`` against ``run()``; and ``_bucket_cap_fine``,
``referenced_columns`` and ``prestage`` against the reference's.  Every
comparison is exact (PyTorch port, CPU)."""

import functools

import numpy as np
import pytest
import torch

import oracle
from flock_tpu import plan as ref_plan
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime import executor as ref_executor
from flock_tpu.runtime import stream as ref_stream
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu_torch import plan
from flock_tpu_torch.batch import Batch
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.queries.nexmark import QUERIES, get_query
from flock_tpu_torch.runtime import executor, stream
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs

torch.set_num_threads(1)

SECONDS, EPS, GENERATORS = 12, 500, 2
NAMES = ["bidder", "bid_count", "start_time", "end_time"]


@functools.lru_cache(maxsize=None)
def _epochs():
    return generate_epochs(SECONDS, EPS, GENERATORS)


def _rows(cols, names=NAMES):
    return sorted(zip(*(np.asarray(cols[n]).tolist() for n in names)))


def _same_results(got, want):
    assert [g.tag for g in got] == [w.tag for w in want]
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns)
        for name, col in w.columns.items():
            col = np.asarray(col)
            assert g.columns[name].dtype == col.dtype, name
            np.testing.assert_array_equal(g.columns[name], col, err_msg=name)


@pytest.fixture(scope="module")
def runs():
    port = StreamDriver(get_query(12), SECONDS, device="cpu")
    return port, port.run(_epochs()), \
        RefDriver(ref_get_query(12), SECONDS).run(_epochs())


def test_windows_equal_reference(runs):
    _, got, want = runs
    assert [g.tag for g in got] == [("ptime", 0, 10), ("ptime", 10, 20)]
    _same_results(got, want)


def test_windows_equal_oracle(runs):
    _, got, _ = runs
    for (start, r) in zip((0, 10), got):
        chunk = [e["bid"] for e in _epochs()[start:start + 10]]
        assert _rows(r.columns) == _rows(oracle.q12_window(chunk, start))
        assert len(r.columns["bidder"]) > 0


def test_prestaged_run_equals_run(runs):
    port, got, _ = runs
    staged = port.prestage(_epochs())
    assert len(staged) == SECONDS and all(b is not None for b in staged)
    # the projected driving table only, at the reference's pow2 bucket
    ref_staged = RefDriver(ref_get_query(12), SECONDS).prestage(_epochs())
    for b, r in zip(staged, ref_staged):
        assert list(b.columns) == list(r.columns) == ["bidder"]
        assert b.capacity == r.capacity
        np.testing.assert_array_equal(b.valid.numpy(), np.asarray(r.valid))
        np.testing.assert_array_equal(b.columns["bidder"].numpy(),
                                      np.asarray(r.columns["bidder"]))
    calls = []
    orig = port.executor.stage_chunk
    port.executor.stage_chunk = lambda *a: calls.append(1) or orig(*a)
    try:
        _same_results(port.run(_epochs(), prestaged=staged), got)
    finally:
        port.executor.stage_chunk = orig
    assert not calls


def _chunks(window):
    """The staged chunks and p_time constants of one arrival window, and
    the driver's aggregate capacity for it."""
    port = StreamDriver(get_query(12), SECONDS, device="cpu")
    staged = port.prestage(_epochs())
    ts = list(range(window * 10, min(window * 10 + 10, SECONDS)))
    keys = np.concatenate([_epochs()[t]["bid"]["bidder"] for t in ts])
    span = int(keys.max()) - int(keys.min()) + 1
    cap = stream._bucket_cap_fine(span + 8192)
    return port.executor, [staged[t] for t in ts], [t * 1000 for t in ts], cap


@pytest.mark.parametrize("window", [0, 1])
def test_fast_runner_equals_general_runner(window, monkeypatch):
    """Both runners slot from the window's least key at the same capacity:
    validity equal, every column equal on the valid rows.  The fast runner
    counts each chunk once (one K2 call each) and never concatenates."""
    ex, chunks, p_times, cap = _chunks(window)
    calls = []
    orig = kernels.dense_group_aggregate
    monkeypatch.setattr(kernels, "dense_group_aggregate",
                        lambda *a, **k: calls.append(a[3]) or orig(*a, **k))
    fast = ex.execute_consts(chunks, {"p_time": p_times}, cap)
    assert calls == [[(None, "count", "__fast_cnt")]] * len(chunks)
    general = ex._run_plan_consts(chunks, "bid", ("p_time",),
                                  np.asarray([[p] for p in p_times], np.int32),
                                  cap)
    assert fast.capacity == general.capacity == cap
    np.testing.assert_array_equal(fast.valid.numpy(), general.valid.numpy())
    v = fast.valid
    assert bool(v.any())
    assert set(fast.columns) == set(general.columns)
    for name, col in general.columns.items():
        assert fast.columns[name].dtype == col.dtype, name
        np.testing.assert_array_equal(fast.columns[name][v].numpy(),
                                      col[v].numpy(), err_msg=name)


def test_fast_runner_overflows_past_the_capacity():
    """A key at or beyond the window's base plus the capacity sets the
    overflow flag: execute_consts raises, as the reference's does."""
    ex, chunks, p_times, _ = _chunks(0)
    keys = np.concatenate([_epochs()[t]["bid"]["bidder"] for t in range(10)])
    span = int(keys.max()) - int(keys.min()) + 1
    with pytest.raises(executor.OverflowError):
        ex.execute_consts(chunks, {"p_time": p_times}, span - 1)
    ex.execute_consts(chunks, {"p_time": p_times}, span)


def test_forced_widen_equals_reference(monkeypatch):
    """With the first capacity forced to 128 slots, both drivers overflow,
    quadruple and retry: the same windows, the same rows."""
    for mod in (stream, ref_stream):
        monkeypatch.setattr(mod, "_bucket_cap_fine", lambda n: 128)
    caps = []
    port = StreamDriver(get_query(12), SECONDS, device="cpu")
    orig = port.executor.execute_consts

    def spy(chunks, consts, cap, *a, **k):
        caps.append(cap)
        return orig(chunks, consts, cap, *a, **k)

    port.executor.execute_consts = spy
    got = port.run(_epochs())
    _same_results(got, RefDriver(ref_get_query(12), SECONDS).run(_epochs()))
    assert caps[0] == 128 and len(caps) > len(got)


def _int64_key_chunks():
    """Two chunks whose group key is int64 (staging narrows every int64
    column, so the Batches are made here)."""
    rng = np.random.default_rng(12)
    out = []
    for n, cap in ((300, 384), (200, 256)):
        k = np.zeros(cap, np.int64)
        k[:n] = 5_000 + rng.integers(0, 400, n)
        out.append((k, np.arange(cap) < n))
    return out


def test_int64_key_takes_the_general_runner():
    """An int64 group key fails the fast runner's int32 gate in both
    engines; the general runners agree on every valid row."""
    import jax.numpy as jnp

    from flock_tpu.batch import Batch as RefBatch

    chunks = _int64_key_chunks()
    key_dt = torch.int64
    assert not executor._consts_fast_shape(get_query(12).plan, "bid",
                                           ("p_time",), key_dtype=key_dt)
    assert not ref_executor._consts_fast_shape(
        ref_get_query(12).plan, "bid", ("p_time",), key_dtype=jnp.int64)
    ex = executor.LocalExecutor(get_query(12), device="cpu")
    got = ex.execute_consts(
        [Batch({"bidder": torch.from_numpy(k)}, torch.from_numpy(v))
         for k, v in chunks], {"p_time": [3000, 4000]}, 1024)
    ref = ref_executor.LocalExecutor(ref_get_query(12)).execute_consts(
        [RefBatch({"bidder": jnp.asarray(k)}, jnp.asarray(v))
         for k, v in chunks], {"p_time": [3000, 4000]}, 1024)
    rv = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), rv)
    assert rv.sum() > 100
    for name, col in ref.columns.items():
        np.testing.assert_array_equal(got.columns[name].numpy()[rv],
                                      np.asarray(col)[rv], err_msg=name)


def test_bucket_cap_fine_equals_reference():
    ns = sorted({1, 127, 128, 129, 1023, 1024, 1025, 2**24 - 1, 2**24}
                | set(np.random.default_rng(0).integers(1, 2**24, 2000)
                      .tolist())
                | {2**k + d for k in range(7, 24) for d in (-1, 0, 1)})
    assert [stream._bucket_cap_fine(n) for n in ns] \
        == [ref_stream._bucket_cap_fine(n) for n in ns]


@pytest.mark.parametrize("q", sorted(QUERIES))
def test_referenced_columns_equal_reference(q):
    """Both engines stage the same columns: the reference's rule, a Filter
    or post-filter making it None even where the port's Conj is
    inspectable."""
    assert plan.referenced_columns(get_query(q).plan) \
        == ref_plan.referenced_columns(ref_get_query(q).plan)


def test_q12_spec_matches_reference():
    mine, ref = get_query(12), ref_get_query(12)
    assert mine.relations == ref.relations and mine.window == ref.window
    assert mine.schema.__dict__ == ref.schema.__dict__

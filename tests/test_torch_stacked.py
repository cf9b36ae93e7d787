"""``LocalExecutor.execute_stacked`` in the port against flock_tpu's: W
windows of equal capacities in one call equal ``execute_batches`` window
by window and the reference's ``execute_stacked`` slot for slot (q2 —
tests/test_queries.py:161-175 —, q3, q4, q9, and q13 with its side input);
a G=3 window whose fused pass escapes, stacked with clean ones; one host
sync for a clean set; overflow per window (PyTorch port, CPU)."""

import numpy as np
import pytest
import torch

from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime.executor import LocalExecutor as RefLocalExecutor
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime.executor import LocalExecutor, OverflowError
from flock_tpu_torch.runtime.stream import generate_epochs
from flock_tpu_torch.runtime.tables import concat_relations, window_relations
from flock_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def epochs():
    return generate_epochs(4, 4000, 1)


@pytest.fixture(scope="module")
def duplicates():
    """tests/test_sqlite_oracle.py:280's window: misaligned generators
    repeat auction ids (G=3), so q4's, q6's and q9's fused passes escape."""
    return concat_relations(generate_epochs(10, 350, 3),
                            ("person", "auction", "bid"))


def _stage(q: int, windows: list, cap: int = 4096):
    """The windows staged at one capacity per relation, on the port's CPU
    executor and on the reference's."""
    spec = get_query(q)
    rels = window_relations(spec.relations)
    caps = {r: cap for r in rels}
    ex, ref = LocalExecutor(spec, device="cpu"), RefLocalExecutor(
        ref_get_query(q))
    tables = [{r: w[r] for r in rels} for w in windows]
    return (ex, [ex.prepare_window(t, caps) for t in tables],
            ref, [ref.prepare_window(t, caps) for t in tables])


def _count_tolist(monkeypatch) -> list:
    calls = []
    orig = torch.Tensor.tolist

    def counted(self):
        calls.append(1)
        return orig(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    return calls


def _equal_per_window(ex, staged, out):
    """Window i of the stacked output: ``execute_batches``' output on
    window i, slot for slot (each window's own call reads its flags)."""
    for i, w in enumerate(staged):
        want = ex.execute_batches(w)
        assert torch.equal(out.valid[i], want.valid)
        for c, t in want.columns.items():
            assert out.columns[c].dtype == t.dtype, c
            assert torch.equal(out.columns[c][i], t), c


def _equal_reference(out, overflow, ref_out, ref_overflow):
    """Slot for slot the reference's ``lax.map`` output (dtypes too)."""
    assert overflow.tolist() == np.asarray(ref_overflow).tolist()
    valid = np.asarray(ref_out.valid)
    assert np.array_equal(out.valid.numpy(), valid)
    assert set(out.columns) == set(ref_out.columns)
    for c, t in out.columns.items():
        want = np.asarray(ref_out.columns[c])
        assert t.numpy().dtype == want.dtype, c
        assert np.array_equal(t.numpy()[valid], want[valid]), c


@pytest.mark.parametrize("q", [2, 3, 4, 9])
def test_stacked_equals_per_window_and_reference(epochs, q, monkeypatch):
    ex, staged, ref, ref_staged = _stage(q, epochs)
    syncs = _count_tolist(monkeypatch)
    out, overflow = ex.execute_stacked(staged)
    assert len(syncs) == 1 and ex.host_syncs == 1
    assert ex.fallback_runs == 0
    monkeypatch.undo()
    assert out.valid.shape[0] == 4
    _equal_reference(out, overflow, *ref.execute_stacked(ref_staged))
    _equal_per_window(ex, staged, out)
    assert int(out.valid.sum()) > 0


def test_stacked_q13_with_side_input(epochs):
    """The executor's static side input joins every stacked window, as it
    joins each window of ``execute_batches``."""
    ex, staged, _, _ = _stage(13, epochs)
    out, overflow = ex.execute_stacked(staged)
    assert not overflow.any() and ex.host_syncs == 1
    _equal_per_window(ex, staged, out)
    assert int(out.valid.sum()) > 0


@pytest.mark.parametrize("q", [4, 6, 9])
def test_stacked_escaping_window(epochs, duplicates, q, monkeypatch):
    """A G=3 window between two clean ones: only it reruns on the fallback
    (one more sync), and every window equals its per-window output and the
    reference's ``lax.cond`` branch slot for slot."""
    ex, staged, ref, ref_staged = _stage(
        q, [epochs[0], duplicates, epochs[1]])
    syncs = _count_tolist(monkeypatch)
    out, overflow = ex.execute_stacked(staged)
    assert (len(syncs), ex.host_syncs, ex.fallback_runs) == (2, 2, 1)
    monkeypatch.undo()
    _equal_reference(out, overflow, *ref.execute_stacked(ref_staged))
    runs = ex.fallback_runs
    _equal_per_window(ex, staged, out)
    assert ex.fallback_runs == runs + 1     # the per-window pass escapes too


def test_stacked_overflow_is_per_window():
    """A window whose auction span overflows the aggregate capacity sets
    its own overflow flag; ``check_overflow`` raises on it."""
    rng = np.random.default_rng(0)

    def bids(span):
        n = 500
        return {"bid": {
            "auction": (1000 + rng.integers(0, span, n)).astype(np.int32),
            "bidder": rng.integers(0, 100, n).astype(np.int32),
            "price": rng.integers(1, 1000, n).astype(np.int32),
            "b_date_time": np.arange(n, dtype=np.int64)}}

    ex = LocalExecutor(get_query(5), agg_capacity=256, device="cpu")
    staged = [ex.prepare_window(bids(span), {"bid": 512})
              for span in (100, 4000, 200)]
    out, overflow = ex.execute_stacked(staged, check_overflow=False)
    assert overflow.tolist() == [False, True, False]
    assert out.valid.shape[0] == 3
    with pytest.raises(OverflowError, match=r"windows \[1\]"):
        ex.execute_stacked(staged)


def test_stacked_needs_equal_capacities(epochs):
    ex = LocalExecutor(get_query(2), device="cpu")
    staged = [ex.prepare_window({"bid": epochs[t]["bid"]}, {"bid": cap})
              for t, cap in ((0, 4096), (1, 8192))]
    with pytest.raises(ValueError, match="equal capacities"):
        ex.execute_stacked(staged)


def test_stacked_counts_every_window(epochs):
    ex, staged, _, _ = _stage(2, epochs)
    before = METRICS.counters.get("q2.windows", 0)
    ex.execute_stacked(staged)
    assert METRICS.counters["q2.windows"] == before + 4

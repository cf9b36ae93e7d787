"""The q4 slice end to end on the CPU: the port's StreamDriver against
flock_tpu's on the same generated epochs, sink rows compared exactly (f64
``avg_final`` included), in the clean configuration and in the duplicate
configuration that takes the fallback; both also against tests/oracle.py;
the plan fused once per executor, not per window (PyTorch port, CPU)."""

import numpy as np
import pytest
import torch

import oracle
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime.executor import LocalExecutor as RefExecutor
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu_torch import plan
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime import executor
from flock_tpu_torch.runtime.executor import LocalExecutor
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
from flock_tpu_torch.runtime.tables import concat_relations

torch.set_num_threads(1)

# (seconds, events/s, generators, one window over the whole stream)
CLEAN = (2, 20_000, 1, False)
DUPLICATES = (10, 350, 3, True)   # tests/test_sqlite_oracle.py's G=3 config


def _drivers(seconds, single_window):
    port = StreamDriver(get_query(4), seconds, device="cpu")
    ref = RefDriver(ref_get_query(4), seconds)
    if single_window:
        whole = [(("win", 0, seconds), list(range(seconds)))]
        port._window_epoch_ranges = lambda occupancy=None: whole
        ref._window_epoch_ranges = lambda occupancy=None: whole
    return port, ref


def _rows(cols, names=("category", "avg_final")):
    return sorted(zip(*(np.asarray(cols[n]).tolist() for n in names)))


@pytest.fixture(scope="module", params=[CLEAN, DUPLICATES],
                ids=["clean", "duplicates"])
def config(request):
    seconds, eps, gens, single = request.param
    epochs = generate_epochs(seconds, eps, gens)
    port, ref = _drivers(seconds, single)
    got = port.run(epochs)
    return request.param, epochs, port, got, ref.run(epochs)


def test_sink_rows_equal_reference(config):
    (_, _, _, single), _, port, got, want = config
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g.tag == w.tag
        assert list(g.columns) == ["category", "avg_final"]
        for name in ("category", "avg_final"):
            assert g.columns[name].dtype == np.asarray(w.columns[name]).dtype
            np.testing.assert_array_equal(g.columns[name], w.columns[name])
    # the duplicate window escapes to the fallback; the clean ones never do
    assert (port.executor.fallback_runs > 0) == single


def test_sink_rows_equal_oracle(config):
    (seconds, _, _, single), epochs, _, got, _ = config
    ranges = [list(range(seconds))] if single else [[t] for t in range(seconds)]
    for r, rng in zip(got, ranges):
        w = concat_relations([epochs[t] for t in rng], ("auction", "bid"))
        assert _rows(r.columns) == _rows(oracle.q4(w["auction"], w["bid"]))


def test_device_columns_equal_reference(config):
    """The exact integer basis of the sink's average, window by window."""
    (seconds, _, _, single), epochs, _, _, _ = config
    port = LocalExecutor(get_query(4), device="cpu")
    ref = RefExecutor(ref_get_query(4))
    ranges = [list(range(seconds))] if single else [[t] for t in range(seconds)]
    for rng in ranges:
        w = concat_relations([epochs[t] for t in rng], ("auction", "bid"))
        g = port.execute_window(w).to_numpy()
        r = ref.execute_window(w).to_numpy()
        for name in ("category", "sum_final", "cnt"):
            np.testing.assert_array_equal(g[name], r[name], err_msg=name)
        assert g["sum_final"].dtype == np.int64


def test_plan_fused_once_per_executor(monkeypatch):
    """The executor rewrites the plan (``plan.fuse_join_aggregates``) once,
    at construction, and lowers that rewrite in every window: over several
    windows the rewrite runs once, and the rows equal the reference's."""
    seconds = 3
    epochs = generate_epochs(seconds, 2_000, 1)
    fused = []
    orig = plan.fuse_join_aggregates

    def spy(node):
        fused.append(node)
        return orig(node)

    monkeypatch.setattr(plan, "fuse_join_aggregates", spy)
    # the executor's own name for it, where it binds one at import
    monkeypatch.setattr(executor, "fuse_join_aggregates", spy, raising=False)
    port = StreamDriver(get_query(4), seconds, device="cpu")
    got = port.run(epochs)
    assert len(got) == seconds
    assert fused == [port.spec.plan]
    want = RefDriver(ref_get_query(4), seconds).run(epochs)
    assert [g.tag for g in got] == [w.tag for w in want]
    for g, w in zip(got, want):
        assert _rows(g.columns) == _rows(w.columns)

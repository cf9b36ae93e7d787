"""The port's windows equal the plain reference on tiny rings, on the CPU;
the generator copy and the window arithmetic."""

import json

import numpy as np
import pytest

from fbhelp import CELLS, tiny_cell
from flockbench import gen, trace
from flockbench.run import run_cell, window_ranges

BIG_SEED = 2**31 + 977


@pytest.mark.parametrize("name", CELLS)
def test_cell_equals_reference_on_cpu(name):
    line, notes, rec = run_cell(tiny_cell(name), BIG_SEED, 0.5, False,
                                device="cpu")
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 2
    want = {m["name"] for m in tiny_cell(name).end_to_end}
    assert set(line["metrics"]) == want and "setup_s" in want and len(want) > 1
    assert list(line)[-1] == "checks"
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert rec.counters["host_syncs"] == rec.windows


def test_traced_run_on_cpu_reads_the_host_metrics():
    line, _, _ = run_cell(tiny_cell("ysb-campaigns"), 5, 0.3, True,
                          device="cpu")
    assert line["correct"] is True
    # the CPU has no device trace: the trace's metrics are left out
    assert {"window_p50_ms", "host_syncs_per_window",
            "execute_ms_per_window", "emit_ms_per_window"} \
        <= set(line["metrics"])
    assert "kernel_roofline" not in line["metrics"]
    assert line["metrics"]["host_syncs_per_window"]["value"] == 1.0


def test_generator_copy_equals_the_programs_at_seed_zero():
    from flock_tpu_torch.datagen.nexmark import NexmarkConfig
    from flock_tpu_torch.runtime.stream import generate_epochs

    cfg = NexmarkConfig(events_per_second=100_000)
    g = {f: getattr(cfg, f) for f in gen.CFG_FIELDS}
    want = generate_epochs(3, 100_000)
    for t in range(3):
        got, n = gen.nexmark_epoch(g, 0, t)
        assert n == sum(len(want[t][r][next(iter(want[t][r]))])
                        for r in ("person", "auction", "bid"))
        for rel in ("person", "auction", "bid"):
            for c, v in want[t][rel].items():
                np.testing.assert_array_equal(got[rel][c], v)


@pytest.mark.parametrize("dataset", ["nexmark", "ysb"])
def test_seed_changes_the_draws_not_the_sizes(dataset):
    cell = tiny_cell("nexmark-q5-hop" if dataset == "nexmark"
                     else "ysb-campaigns")
    rels = tuple(r for r in cell.traffic["relations"] if r != "campaign")
    a, na = gen.generate(cell.config, 1, 3, rels)
    b, nb = gen.generate(cell.config, 2**33 + 1, 3, rels)
    c, _ = gen.generate(cell.config, 1, 3, rels)
    assert na == nb
    col = "auction" if dataset == "nexmark" else "ad_id"
    rel = rels[0]
    for x, y, z in zip(a, b, c):
        assert len(x[rel][col]) == len(y[rel][col])
        assert not np.array_equal(x[rel][col], y[rel][col])
        np.testing.assert_array_equal(x[rel][col], z[rel][col])


def test_window_ranges():
    assert window_ranges(["elementwise"], 3) == [([0], [0]), ([1], [1]),
                                                 ([2], [2])]
    assert window_ranges(["hopping", 10, 5], 15) == [
        (list(range(0, 10)), list(range(5, 10))),
        (list(range(5, 15)), list(range(10, 15)))]
    assert window_ranges(["tumbling", 10], 20) == [
        (list(range(0, 10)), list(range(0, 10))),
        (list(range(10, 20)), list(range(10, 20)))]


def test_trace_summary_busy_idle_and_gaps(tmp_path):
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": args}

    evs = [x("stretch", "user_annotation", 0, 100),
           x("window", "user_annotation", 0, 100),
           x("execute", "user_annotation", 0, 40),
           x("emit", "user_annotation", 40, 60),
           x("aten::item", "cpu_op", 30, 15),
           x("k2", "kernel", 10, 20), x("cat", "kernel", 25, 10),
           x("Memcpy DtoH", "gpu_memcpy", 50, 30, bytes=64),
           x("outside", "kernel", 200, 10)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    s = trace.summarize(str(path))
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(55e-6)        # [10,35) + [50,80)
    assert s["kernel_s"] == pytest.approx(30e-6)      # copies excluded
    assert s["h2d_bytes"] == 0 and s["d2h_bytes"] == 64
    gaps = dict(s["idle_gaps"])
    # each gap named by the innermost span and host operation over its
    # middle: [0,10) execute, [35,50) emit/aten::item, [80,100) emit
    assert gaps == pytest.approx({"execute": 10e-6, "emit/aten::item": 15e-6,
                                  "emit": 20e-6})

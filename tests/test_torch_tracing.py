"""The port's spans (``utils.metrics.Metrics.span``) on the CPU: off unless
a profiler records or ``METRICS.tracing()`` is open, and then free of any
profiler annotation, clock read or registry write; under
``torch.profiler`` each executor and emission span once per YSB window,
with self times inside totals and the spans nested in the Chrome trace;
an escaped window's fallback span; the staging counters; the CLI's
``--trace --metrics`` (PyTorch port, CPU)."""

import json
import tempfile
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flock_tpu_torch import cli
from flock_tpu_torch.datagen.ysb import YsbConfig
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.queries.ysb import (campaign_table, generate_ysb_epochs,
                                         ysb_query)
from flock_tpu_torch.runtime.executor import LocalExecutor
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
from flock_tpu_torch.runtime.tables import concat_relations, window_relations
from flock_tpu_torch.utils import metrics
from flock_tpu_torch.utils.metrics import METRICS, Metrics

torch.set_num_threads(1)

# parent -> its children, in the order they open
NESTED = {"execute": ("execute.form", "execute.lower", "execute.flags"),
          "emit": ("emit.copy", "emit.compact", "emit.sink")}
WINDOW_SPANS = tuple(NESTED) + tuple(c for cs in NESTED.values() for c in cs)
WINDOWS = 2


@pytest.fixture(scope="module")
def ysb():
    """(driver, staged epochs, epochs): one 10 s YSB window of 10 staged
    epochs, the campaign table with the first."""
    cfg = YsbConfig(seconds=10, events_per_second=2000, threads=2)
    epochs = generate_ysb_epochs(cfg)
    camp = campaign_table(cfg)
    for t, e in enumerate(epochs):
        e["campaign"] = camp if t == 0 else \
            {k: v[:0] for k, v in camp.items()}
    driver = StreamDriver(ysb_query(), cfg.seconds, device="cpu")
    return driver, driver.stage_epochs(epochs, driver.epoch_caps(epochs)), \
        epochs


def _window(ex, staged):
    return ex.materialize(ex.execute_epochs(staged))


def _snapshot() -> dict:
    return {k: list(v) for k, v in METRICS.spans.items()}


def _delta(before: dict) -> dict:
    zero = [0, 0.0, 0.0]
    return {k: [a - b for a, b in zip(v, before.get(k, zero))]
            for k, v in METRICS.spans.items() if v != before.get(k)}


def _refuse_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span built a record_function")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_spans_off_record_nothing_and_read_no_clock(ysb, monkeypatch):
    """Profiler off, no ``tracing()``: a YSB window builds no
    ``record_function``, writes no span and reads the clock only for the
    always-on ``q<n>.execute_s`` timer."""
    driver, staged, _ = ysb
    _refuse_record_function(monkeypatch)
    reads = []

    def clock():
        reads.append(1)
        return 0.0

    monkeypatch.setattr(metrics, "time", types.SimpleNamespace(
        perf_counter=clock))
    assert METRICS.span("execute") is METRICS.span("emit")
    before = _snapshot()
    rows = _window(driver.executor, staged)
    assert len(rows["campaign_id"]) > 0
    assert _snapshot() == before
    assert len(reads) == 2


def test_tracing_records_spans_without_the_profiler(ysb, monkeypatch):
    """Inside ``tracing()`` the spans record, and still build no
    profiler annotation when no profiler records."""
    driver, staged, _ = ysb
    _refuse_record_function(monkeypatch)
    before = _snapshot()
    with METRICS.tracing():
        _window(driver.executor, staged)
    got = _delta(before)
    assert {k: v[0] for k, v in got.items()} == \
        {k: 1 for k in WINDOW_SPANS}
    with METRICS.tracing():
        pass
    assert METRICS.span("execute") is METRICS.span("emit")


@pytest.fixture(scope="module")
def profiled(ysb, tmp_path_factory):
    """(span deltas, Chrome trace events) of WINDOWS YSB windows under
    ``torch.profiler`` on the CPU."""
    driver, staged, _ = ysb
    before = _snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(WINDOWS):
            _window(driver.executor, staged)
    got = _delta(before)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    return got, [e for e in evs if e.get("cat") == "user_annotation"
                 and e.get("ph") == "X"]


def test_each_span_once_per_window_under_the_profiler(profiled):
    got, _ = profiled
    assert {k: v[0] for k, v in got.items()} == \
        {k: WINDOWS for k in WINDOW_SPANS}


def test_self_time_within_total_and_children_within_parent(profiled):
    got, _ = profiled
    for name, (n, total, own) in got.items():
        assert 0 < own <= total, name
    for parent, children in NESTED.items():
        inner = sum(got[c][1] for c in children)
        # a child's profiler annotation counts in neither its time nor the
        # parent's self time
        assert inner + got[parent][2] <= got[parent][1]


def test_chrome_trace_nests_the_spans_in_order(profiled):
    """Every window's spans are ``user_annotation`` events: each child
    inside its parent, the children in their order, the emission after
    the execution."""
    _, evs = profiled

    def of(name):
        return sorted((e for e in evs if e["name"] == name),
                      key=lambda e: e["ts"])

    for parent, children in NESTED.items():
        parents = of(parent)
        assert len(parents) == WINDOWS
        kids = [of(c) for c in children]
        assert all(len(k) == WINDOWS for k in kids)
        for i, p in enumerate(parents):
            p0, p1 = p["ts"], p["ts"] + p["dur"]
            t = p0
            for k in kids:
                e = k[i]
                assert t <= e["ts"] and e["ts"] + e["dur"] <= p1
                t = e["ts"] + e["dur"]
    for ex, em in zip(of("execute"), of("emit")):
        assert ex["ts"] + ex["dur"] <= em["ts"]


def test_escaped_window_records_one_fallback_span():
    """A G=3 duplicate-key q4 window (tests/test_sqlite_oracle.py's
    config) escapes: one ``execute.fallback`` span, two host syncs."""
    spec = get_query(4)
    rels = window_relations(spec.relations)
    tables = concat_relations(generate_epochs(10, 350, 3), rels)
    ex = LocalExecutor(spec, device="cpu")
    batches = ex.prepare_window(tables, {r: 4096 for r in rels})
    before = _snapshot()
    with METRICS.tracing():
        ex.materialize(ex.execute_batches(batches))
    got = _delta(before)
    assert got["execute.fallback"][0] == 1
    assert got["execute"][0] == 1
    assert ex.host_syncs == 2 and ex.fallback_runs == 1


def test_stage_epochs_counts_each_epoch(ysb):
    driver, _, epochs = ysb
    n = 3
    count = METRICS.counters.get("stage.epochs", 0)
    secs = METRICS.timings.get("stage.epoch_s", 0.0)
    staged = driver.stage_epochs(epochs[:n], driver.epoch_caps(epochs))
    assert len(staged) == n
    assert METRICS.counters["stage.epochs"] == count + n
    assert METRICS.timings["stage.epoch_s"] > secs


def test_report_lists_span_totals():
    m = Metrics()
    m.count("q4.windows", 2)
    with m.tracing():
        with m.span("execute"):
            with m.span("execute.flags"):
                pass
    lines = m.report().splitlines()
    at = lines.index("span                 count     total_ms      self_ms")
    names = [ln.split()[0] for ln in lines[at + 1:]]
    assert names == ["execute", "execute.flags"]
    assert [ln.split()[1] for ln in lines[at + 1:]] == ["1", "1"]
    assert "span" not in Metrics().report()


def test_cli_trace_writes_one_driver_window_span_per_window(
        tmp_path, monkeypatch, capsys):
    """``nexmark run --trace --metrics``: the report holds the span
    totals, and the Chrome trace one ``driver.window`` span a window."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    METRICS.counters.clear()
    METRICS.timings.clear()
    METRICS.spans.clear()
    assert cli.main(["nexmark", "run", "-q", "4", "-s", "3", "-e", "2000",
                     "--trace", "--metrics", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    windows = sum(ln.startswith("window ") for ln in out)
    assert windows == 3
    at = out.index("span                 count     total_ms      self_ms")
    counts = {ln.split()[0]: int(ln.split()[1]) for ln in out[at + 1:]}
    assert counts["driver.window"] == windows
    assert counts["execute"] == counts["emit"] == windows
    with open(tmp_path / "flock_tpu_torch_trace" / "nexmark_q4"
              / "trace.json") as f:
        doc = json.load(f)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    spans = [e for e in evs if e.get("cat") == "user_annotation"
             and e.get("name") == "driver.window"]
    assert len(spans) == windows
    assert np.all(np.diff([e["ts"] for e in spans]) > 0)

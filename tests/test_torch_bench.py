"""The port's benchmark harness (``flock_tpu_torch.tools.bench``) on the CPU
against the reference's (the repository root's ``bench.py``): each
``--only`` entry counts the reference's input rows and windows at the same
arguments and sizing, ``--all`` writes its artifact of fifteen records and
exits non-zero when an entry raised, and the last line has the
reference's format (PyTorch port, CPU)."""

import argparse
import importlib.util
import json
import os

import pytest
import torch

from flock_tpu_torch.tools import bench

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS, EPS = 2, 2000


def _load_reference():
    """The repository root's bench.py, loaded by path (a ``bench/``
    directory stands beside it)."""
    spec = importlib.util.spec_from_file_location(
        "flock_tpu_reference_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_bench = _load_reference()


def metric_line(line: str, query: int) -> dict:
    """The harness's last line, checked against the reference's format."""
    m = json.loads(line)
    assert list(m) == ["metric", "value", "unit", "vs_baseline"]
    assert m["metric"] == f"nexmark_q{query}_rows_per_s_per_chip"
    assert m["unit"] == "rows/s" and m["value"] > 0
    baseline = ref_bench.REFERENCE_EVENTS_PER_SEC
    assert bench.REFERENCE_EVENTS_PER_SEC == baseline
    assert m["vs_baseline"] == round(m["value"] / baseline, 2)
    return m


@pytest.mark.parametrize("which", ["3", "4", "5", "11", "12", "ysb"])
def test_only_entry_counts_the_reference_rows(which, capsys):
    assert bench.main(["--only", which, "--seconds", str(SECONDS), "--eps",
                       str(EPS), "--repeats", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    want = ref_bench._run_one(which, argparse.Namespace(
        seconds=SECONDS, eps=EPS, repeats=1))
    for key in ("query", "rows_in", "windows", "seconds", "eps"):
        assert got[key] == want[key], key
    assert got["rows_in"] > 0 and got["device"] == "cpu"
    rates = ["rows_per_s", "rows_per_s_feed_inclusive"]
    if which not in ("11", "12"):
        rates.append("rows_per_s_stacked")
    for key in rates:
        assert got[key] > 0, key
    assert set(want) <= set(got)


def test_all_writes_the_artifact(tmp_path, monkeypatch, capsys):
    """Fifteen records (q0-q13 and YSB), none failed, in the artifact
    ``--out`` names; q8's 5 M events/s floor is cut for the CPU."""
    monkeypatch.setattr(bench, "Q8_MIN_EPS", 1000)
    out = tmp_path / "bench.json"
    assert bench.main(["--all", "--seconds", "2", "--eps", "1000",
                       "--repeats", "1", "--device", "cpu",
                       "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["hardware"] == "cpu"
    assert [r["query"] for r in doc["results"]] == list(range(14)) + ["ysb"]
    assert not [r for r in doc["results"] if "error" in r]
    by_query = {r["query"]: r for r in doc["results"]}
    assert (by_query[3]["eps"], by_query[8]["eps"]) == (4000, 1000)
    assert [by_query[q]["seconds"] for q in (5, 7, 8, "ysb")] == [10] * 4
    metric_line(capsys.readouterr().out.splitlines()[-1], 4)


def test_all_exits_nonzero_when_an_entry_raises(tmp_path, monkeypatch,
                                                capsys):
    """An entry that raises is recorded with its error, the artifact is
    written and the metric line printed, and ``main`` returns 1."""
    def run_one(which, args, cache=None):
        if which == "7":
            raise RuntimeError("boom")
        return {"query": which}

    monkeypatch.setattr(bench, "_run_one", run_one)
    monkeypatch.setattr(bench, "bench_query", lambda *a: {
        "rows_per_s": 2.0, "rows_per_s_stacked": 3.0})
    out = tmp_path / "bench.json"
    assert bench.main(["--all", "--device", "cpu", "--out", str(out)]) == 1
    results = json.loads(out.read_text())["results"]
    assert len(results) == 15
    assert [r for r in results if "error" in r] == [
        {"query": "7", "error": "boom"}]
    assert metric_line(capsys.readouterr().out.splitlines()[-1],
                       4)["value"] == 3.0

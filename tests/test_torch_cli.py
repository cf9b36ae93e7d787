"""The port's CLI (``python -m flock_tpu_torch.cli``) against flock_tpu's:
``nexmark run``, ``ysb run`` and ``fsql`` (one-shot and REPL) with
``--device cpu`` print the reference's lines for the same arguments, times
left out; the sinks, the metrics registry and the executor's records
(tests/test_runtime_aux.py's tests, against the port's modules) (PyTorch
port, CPU)."""

import builtins
import re
import tempfile

import numpy as np
import pytest
import torch

from test_sql import NEXMARK_SQL, YSB_SQL
from flock_tpu import cli as ref_cli
from flock_tpu.runtime.sink import FileSink as RefFileSink
from flock_tpu.runtime.stream import run_nexmark as ref_run_nexmark
from flock_tpu.utils.metrics import METRICS as REF_METRICS
from flock_tpu_torch import cli
from flock_tpu_torch.batch import Schema
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime.executor import LocalExecutor
from flock_tpu_torch.runtime.sink import FileSink, MemorySink, make_sink
from flock_tpu_torch.utils.metrics import METRICS, Metrics

torch.set_num_threads(1)

_TIME = re.compile(r"\d+\.\d+s\b")


def _lines(main, argv, capsys) -> list[str]:
    """What ``main(argv)`` prints, its times replaced by ``<t>``."""
    for m in (METRICS, REF_METRICS):
        m.counters.clear()
        m.timings.clear()
    capsys.readouterr()
    assert main(argv) == 0
    return [_TIME.sub("<t>", line)
            for line in capsys.readouterr().out.splitlines()]


CASES = {
    "nexmark-q4": ["nexmark", "run", "-q", "4", "-s", "2", "-e", "2000",
                   "--show", "3"],
    "nexmark-q3": ["nexmark", "run", "-q", "3", "-s", "2", "-e", "4000",
                   "--show", "2"],
    "ysb": ["ysb", "run", "-s", "10", "-e", "2000", "--show", "4"],
    "fsql-q4": ["fsql", NEXMARK_SQL[4], "-s", "2", "-e", "2000"],
    "fsql-q3": ["fsql", NEXMARK_SQL[3], "-s", "2", "-e", "4000"],
    "fsql-ysb": ["fsql", YSB_SQL, "--dataset", "ysb", "-s", "2", "-e",
                 "3000", "--show", "5"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_prints_the_reference_lines(case, capsys):
    argv = CASES[case]
    got = _lines(cli.main, argv + ["--device", "cpu"], capsys)
    want = _lines(ref_cli.main, argv, capsys)
    assert got == want
    assert any(line.startswith("window ") for line in got)


def test_fsql_repl(monkeypatch, capsys):
    """The REPL answers each line (an error as a line of its own) and ends
    at end of input, as the reference's."""
    def feed(lines):
        it = iter(lines)

        def fake_input(prompt=""):
            try:
                return next(it)
            except StopIteration:
                raise EOFError from None
        monkeypatch.setattr(builtins, "input", fake_input)

    script = [NEXMARK_SQL[2], "", "SELECT nope FROM bid;",
              "SELECT * FROM person WHERE state = 'tx';"]
    argv = ["fsql", "-s", "2", "-e", "2000"]
    feed(script)
    got = _lines(cli.main, argv + ["--device", "cpu"], capsys)
    feed(script)
    want = _lines(ref_cli.main, argv, capsys)
    assert got == want
    assert sum(line.startswith("error: ") for line in got) == 2


def _report(lines: list[str]):
    """(counter lines, timing names) of a metrics report."""
    at = lines.index("metric               value")
    body = lines[at + 1:]
    return ([ln for ln in body if not ln.endswith("<t>")],
            sorted(ln.split()[0] for ln in body if ln.endswith("<t>")))


def test_nexmark_metrics_and_memory_sink(capsys):
    argv = ["nexmark", "run", "-q", "4", "-s", "3", "-e", "2000",
            "--metrics", "--sink", "memory"]
    got = _lines(cli.main, argv + ["--device", "cpu"], capsys)
    want = _lines(ref_cli.main, argv, capsys)
    assert got == want     # the memory sink's read-back line included
    counters, timings = _report(got)
    assert "q4.windows           3" in counters
    assert timings == ["q4.execute_s"]
    assert any(line.startswith("sink[memory]: [(('epoch', 0)")
               for line in got)


def test_nexmark_file_sink_writes_the_reference_files(monkeypatch, tmp_path,
                                                      capsys):
    """One file per window under the sink's directory, each the text the
    reference's FileSink writes for the reference's rows."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    lines = _lines(cli.main, ["nexmark", "run", "-q", "3", "-s", "2", "-e",
                              "4000", "--sink", "file", "--device", "cpu"],
                   capsys)
    ref = RefFileSink(directory=str(tmp_path / "ref"))
    spec = get_query(3)
    for r in ref_run_nexmark(3, 2, 4000, 1):
        ref.write(r.tag, r.columns, spec.schema)
    paths = [str(tmp_path / "flock_tpu_torch_out" / p.split("/")[-1])
             for p in ref.read()]
    assert f"sink[file]: {paths}" in lines
    for mine, theirs in zip(paths, ref.read()):
        assert open(mine).read() == open(theirs).read()


def test_nexmark_trace_writes_a_chrome_trace(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    lines = _lines(cli.main, ["nexmark", "run", "-q", "2", "-s", "1", "-e",
                              "1000", "--trace", "--device", "cpu"], capsys)
    where = tmp_path / "flock_tpu_torch_trace" / "nexmark_q2"
    assert lines[0] == f"profiler trace → {where}"
    assert (where / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("argv", [
    ["nexmark", "run", "-q", "4", flag] for flag in
    ("--distributed", "--multihost", "--shards=2", "--coordinator=h:1",
     "--num-processes=2", "--process-id=0")] + [
    [cmd] for cmd in ("explain", "bench", "ingest", "produce")])
def test_unported_subcommands_and_flags_are_refused(argv, capsys):
    """What needs the sharded executor, the planner or ingestion is not
    registered: argparse refuses it by name."""
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert argv[-1].split("=")[0] in capsys.readouterr().err


# -- tests/test_runtime_aux.py's sink and metrics tests, on the port --------


def test_sinks(tmp_path):
    schema = Schema(["x", "label"], dictionaries={"label": ["lo", "hi"]})
    cols = {"x": np.array([1, 2], np.int32),
            "label": np.array([0, 1], np.int32)}
    mem = MemorySink()
    mem.write(("epoch", 0), cols, schema)
    (tag, decoded), = mem.read()
    assert list(decoded["label"]) == ["lo", "hi"]

    fs = FileSink(directory=str(tmp_path), fmt="csv")
    fs.write(("win", 0, 10), cols, schema)
    text = open(fs.read()[0]).read()
    assert text.splitlines()[0] == "x,label"
    assert "2,hi" in text

    bh = make_sink("blackhole")
    bh.write("t", cols, schema)
    assert bh.rows_seen == 2


def test_metrics():
    m = Metrics()
    m.count("rows", 500)
    with m.timer("exec"):
        pass
    assert m.counters["rows"] == 500
    assert "rows" in m.to_json()


def test_executor_records_metrics():
    """Engine paths feed the global METRICS registry (per-query windows,
    rows, execute time) — the observability the CLI surfaces via
    --metrics."""
    before = METRICS.counters.get("q2.windows", 0)
    ex = LocalExecutor(get_query(2), device="cpu")
    ex.execute_window({"bid": {
        "auction": np.array([123, 246, 5], np.int32),
        "bidder": np.array([1, 2, 3], np.int32),
        "price": np.array([10, 20, 30], np.int32),
        "b_date_time": np.array([0, 1, 2], np.int32),
    }})
    assert METRICS.counters["q2.windows"] == before + 1
    assert METRICS.counters["q2.rows_in"] >= 3
    assert METRICS.timings["q2.execute_s"] > 0

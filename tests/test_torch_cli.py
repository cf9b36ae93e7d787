"""The port's CLI (``python -m flock_tpu_torch.cli``) against flock_tpu's:
``nexmark run`` (single-card and ``--distributed``), ``ysb run``, ``fsql``
(one-shot and REPL), ``ingest`` (``--file``, ``--listen``) with ``--device
cpu``, ``produce`` (``--file``, ``--connect``) and ``explain`` print the
reference's lines for the same arguments, times left out; ``bench``
prints the reference harness's metric line over its rows; the sinks, the
metrics registry and the executor's records (tests/test_runtime_aux.py's
tests, against the port's modules) (PyTorch port, CPU)."""

import builtins
import json
import re
import socket
import tempfile
import threading

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
from flock_tpu_torch.datagen.ingest import SocketIngestServer, send_fragments
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
    METRICS.spans.clear()
    capsys.readouterr()
    assert main(argv) == 0
    return [_TIME.sub("<t>", line)
            for line in capsys.readouterr().out.splitlines()]


CASES = {
    "nexmark-q4": ["nexmark", "run", "-q", "4", "-s", "2", "-e", "2000",
                   "--show", "3"],
    "nexmark-q3": ["nexmark", "run", "-q", "3", "-s", "2", "-e", "4000",
                   "--show", "2"],
    "nexmark-q4-distributed": ["nexmark", "run", "-q", "4", "-s", "2", "-e",
                               "2000", "-g", "8", "--distributed", "--show",
                               "3"],
    "nexmark-q9-distributed-4": ["nexmark", "run", "-q", "9", "-s", "1",
                                 "-e", "3000", "-g", "4", "--distributed",
                                 "--shards", "4", "--show", "2"],
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
    at = got.index("metric               value")
    # the memory sink's read-back line included
    assert got[:at + 1] == want[:at + 1]
    counters, timings = _report(got)
    ref_counters, ref_timings = _report(want)
    # the port counts no q<n>.rows_in (a sum of capacities), and counts its
    # staged epochs
    assert counters == [ln for ln in ref_counters
                        if not ln.startswith("q4.rows_in")] \
        + ["stage.epochs         3"]
    assert "q4.windows           3" in counters
    assert ref_timings == ["q4.execute_s"]
    assert timings == ["q4.execute_s", "stage.epoch_s"]
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


def test_bench_prints_the_reference_metric_line(capsys):
    """``bench`` runs the port's harness for one query: its record, then
    the last line in the reference harness's format, over the reference's
    input rows and windows at the same arguments."""
    from test_torch_bench import metric_line, ref_bench

    assert cli.main(["bench", "--query", "4", "--seconds", "2", "--eps",
                     "2000", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    metric_line(out.out.splitlines()[-1], 4)
    record = json.loads(out.err.splitlines()[-1])
    want = ref_bench.bench_query(4, 2, 2000, repeats=1)
    assert (record["rows_in"], record["windows"]) \
        == (want["rows_in"], want["windows"])


# -- ingest and produce -------------------------------------------------------

_ADDRESS = re.compile(r"127\.0\.0\.1:\d+")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("q,size", [(2, ["-s", "2", "-e", "3000"]),
                                    (3, ["-s", "3", "-e", "2000",
                                         "--granule", "100"])])
def test_produce_file_writes_the_reference_fragments(q, size, tmp_path,
                                                     capsys):
    """``produce --file`` appends the reference's fragment lines, byte for
    byte, and prints its line."""
    argv = ["produce", "-q", str(q), *size]
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    got = _lines(cli.main, argv + ["--file", str(mine)], capsys)
    want = _lines(ref_cli.main, argv + ["--file", str(theirs)], capsys)
    assert got == [ln.replace("ref.jsonl", "port.jsonl") for ln in want]
    assert mine.read_bytes() == theirs.read_bytes()
    assert got[0].startswith("appended ")


def test_produce_connect_sends_the_reference_fragments(capsys):
    """``produce --connect`` sends the reference's lines to a listener."""
    srv = SocketIngestServer()
    try:
        host, port = srv.address
        argv = ["produce", "-q", "4", "-s", "2", "-e", "2000", "--connect",
                f"{host}:{port}"]
        got = _lines(cli.main, argv, capsys)
        want = _lines(ref_cli.main, argv, capsys)
        n = int(got[0].split()[1])
        received = list(srv.lines(2 * n, timeout_s=60))
    finally:
        srv.close()
    assert got == want == [f"sent {n} fragments to {host}:{port}"]
    assert received[:n] == received[n:]
    assert json.loads(received[0])["qid"] == "q4"


@pytest.fixture(scope="module")
def fragment_log(tmp_path_factory):
    """q4's fragments of 3 s × 3,000 events/s in a file, as ``produce``
    writes them."""
    path = tmp_path_factory.mktemp("ingest") / "q4.jsonl"
    assert cli.main(["produce", "-q", "4", "-s", "3", "-e", "3000",
                     "--granule", "256", "--file", str(path)]) == 0
    return path


def test_ingest_file_prints_the_reference_lines(fragment_log, capsys):
    n = len(fragment_log.read_text().splitlines())
    argv = ["ingest", "-q", "4", "-s", "3", "--file", str(fragment_log),
            "--lines", str(n), "--show", "2"]
    got = _lines(cli.main, argv + ["--device", "cpu"], capsys)
    want = _lines(ref_cli.main, argv, capsys)
    assert got == want
    assert got[-1] == "q4 ingest: 3 windows, 15 output rows; elapsed <t>"


def test_ingest_listen_prints_the_reference_lines(fragment_log, capsys):
    """``ingest --listen`` on a port a producer thread sends the log to
    (the producer retries its connect until the listener is up); the
    lines equal the reference's, the address left out."""
    lines = fragment_log.read_text().splitlines()

    def run(main, extra):
        port = _free_port()
        producer = threading.Thread(
            target=send_fragments, args=(("127.0.0.1", port), lines),
            daemon=True)
        producer.start()
        out = _lines(main, ["ingest", "-q", "4", "-s", "3", "--listen",
                            str(port), "--lines", str(len(lines)),
                            "--timeout", "60", "--show", "1", *extra],
                     capsys)
        producer.join(30)
        assert not producer.is_alive()
        return [_ADDRESS.sub("<address>", ln) for ln in out]

    got = run(cli.main, ["--device", "cpu"])
    want = run(ref_cli.main, [])
    assert got == want
    assert got[0] == f"listening on <address> for {len(lines)} fragments"


@pytest.mark.parametrize("source", [[], ["--file", "x", "--listen", "0"]])
def test_ingest_takes_exactly_one_source(source, capsys):
    argv = ["ingest", "--lines", "1", *source]
    capsys.readouterr()
    rc = cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr()
    assert rc == ref_cli.main(argv) == 2
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)


@pytest.mark.parametrize("argv", [
    ["explain"], ["explain", "-q", "6"], ["explain", "-q", "13"],
    ["explain", "-q", "99"], ["explain", "--sql", NEXMARK_SQL[3]],
    ["explain", "--sql", YSB_SQL, "--dataset", "ysb"]])
def test_explain_prints_the_reference_lines(argv, capsys):
    """``explain`` needs no card and takes no --device: the stage DAG's
    text, or the reference's error for an unknown query."""
    capsys.readouterr()
    rc = cli.main(argv)
    got = capsys.readouterr()
    assert rc == ref_cli.main(argv)
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)


@pytest.mark.parametrize("flag", [
    "--multihost", "--coordinator=h:1", "--num-processes=2",
    "--process-id=0", "--shards=2", "--distributed"])
def test_ported_flags_are_accepted(flag, monkeypatch):
    """The sharded run's flags parse; with the run stubbed, each reaches
    the command with its value."""
    seen = {}
    monkeypatch.setattr(cli, "cmd_nexmark",
                        lambda args: seen.update(vars(args)) or 0)
    assert cli.main(["nexmark", "run", "-q", "4", flag, "--device",
                     "cpu"]) == 0
    name, _, value = flag[2:].partition("=")
    got = seen[name.replace("-", "_")]
    assert got == (int(value) if value.isdigit() else value or True)


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
    lines = m.report().splitlines()
    assert "rows                 500" in lines
    assert any(ln.startswith("exec ") and ln.endswith("s") for ln in lines)


def test_executor_records_metrics():
    """Engine paths feed the global METRICS registry (per-query windows,
    execute time) — the observability the CLI surfaces via --metrics."""
    before = METRICS.counters.get("q2.windows", 0)
    ex = LocalExecutor(get_query(2), device="cpu")
    ex.execute_window({"bid": {
        "auction": np.array([123, 246, 5], np.int32),
        "bidder": np.array([1, 2, 3], np.int32),
        "price": np.array([10, 20, 30], np.int32),
        "b_date_time": np.array([0, 1, 2], np.int32),
    }})
    assert METRICS.counters["q2.windows"] == before + 1
    assert "q2.rows_in" not in METRICS.counters
    assert METRICS.timings["q2.execute_s"] > 0

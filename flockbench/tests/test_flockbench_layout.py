"""BENCHMARK.json keeps to its contract, and a workload, a configuration and
a metric are each added as new files that the harness finds by name."""

import json
import os
import re
import shutil

import pytest

from fbhelp import Q4_JOIN, added_cell, tiny_cell
from flockbench.run import ROOT, load_cell, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_to_its_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["flockbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    cfgs = {c["name"] for c in b["configs"]}
    used = {w["config"] for w in b["workloads"]}
    assert cfgs == used
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("flockbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(ROOT, "flockbench", "traffic",
                               f"{w['traffic']}.json")) as f:
            query = json.load(f)["query"]
        assert os.path.exists(os.path.join(ROOT, "flockbench", "reference",
                                           f"{query}.py"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in b["workloads"]}

    def cells_of(m):
        return set(m.get("workloads", cells))

    for w in cells:
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one, and each per-layer metric moves one it reports
        mine = {m["name"] for m in b["end_to_end"] if w in cells_of(m)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in b["per_layer"] if w in cells_of(m)]
        assert layer and all(m["moves"] in mine for m in layer)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(
            ROOT, "flockbench", "metrics", f"{m['name'].split('.')[0]}.py"))
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
    assert len(json.dumps(b)) <= 64 * 1024


def test_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and entries and edits none: a new
    configuration, traffic mix and per-layer reader, found by name."""
    shutil.copytree(os.path.join(ROOT, "flockbench"),
                    tmp_path / "flockbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    b = _bench()
    cfg = json.loads((tmp_path / "flockbench" / "configs"
                      / "nexmark-10M.json").read_text())
    cfg.update(name="nexmark-skew")
    cfg["generator"]["hot_auction_ratio"] = 8
    (tmp_path / "flockbench" / "configs" / "nexmark-skew.json").write_text(
        json.dumps(cfg))
    (tmp_path / "flockbench" / "traffic" / "q7-long-ring.json").write_text(
        json.dumps({"query": "q7", "relations": ["bid"], "ring_epochs": 30,
                    "profile_windows": 4}))
    (tmp_path / "flockbench" / "metrics" / "windows_timed.py").write_text(
        "def read(rec):\n    return float(rec.windows)\n")
    b["configs"].append({"name": "nexmark-skew", "source": "x",
                         "file": "flockbench/configs/nexmark-skew.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "nexmark-q7-skew", "config": "nexmark-skew",
                           "traffic": "q7-long-ring", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "windows_timed", "unit": "windows",
                           "better": "higher", "source": "host_clock",
                           "layer": "windows and driver (runtime/stream.py)",
                           "moves": "events_per_s",
                           "workloads": ["nexmark-q7-skew"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = load_cell("nexmark-q7-skew", root=str(tmp_path))
    assert cell.config["generator"]["hot_auction_ratio"] == 8
    assert cell.traffic["ring_epochs"] == 30
    assert [m["name"] for m in cell.per_layer if m["name"] == "windows_timed"]
    cell.config["generator"]["events_per_second"] = 2_000
    line, _, rec = run_cell(cell, 3, 0.2, True, device="cpu")
    assert line["correct"] is True
    assert line["metrics"]["windows_timed"]["value"] == rec.windows
    # the cells already there do not report the new metric
    assert all(m["name"] != "windows_timed"
               for m in load_cell("ysb-campaigns",
                                  root=str(tmp_path)).per_layer)


@pytest.mark.parametrize("name", ["nexmark-q5-hop", "ysb-campaigns",
                                  "nexmark-q7-tumble"])
def test_every_listed_metric_is_read(name):
    """Each per-layer metric the cell lists has a reader that returns a
    number from a record that holds what it reads."""
    from flockbench.run import Record

    cell = tiny_cell(name)
    span = {f"{s}:{part}": v for s in ("execute", "execute.form",
                                       "execute.lower", "execute.flags",
                                       "emit.copy", "emit.compact",
                                       "emit.sink")
            for part, v in (("count", 4), ("total_s", 0.02),
                            ("self_s", 0.01))}
    rec = Record(seconds=1.0, windows=4, events=10, latencies_s=[0.1] * 4,
                 execute_s=[0.05] * 4, emit_s=[0.05] * 4,
                 counters={"host_syncs": 4, "windows": 4, "execute_s": 0.2},
                 setup_counters={"stage.epochs": 20, "stage.epoch_s": 1.0},
                 stretch=span,
                 profile={"window_s": 1.0, "busy_s": 0.5, "kernel_s": 0.4,
                          "d2h_bytes": 4e6},
                 profile_windows=4, least_bytes=1e8,
                 peaks={"hbm_bytes_per_s": 3.35e12})
    for m in cell.per_layer:
        v = cell.reader(m["name"]).read(rec)
        assert isinstance(v, float), m["name"]


def test_a_join_cell_needs_no_edit(tmp_path):
    """q4 over element-wise windows, auction ⋈ bid, in a copy of the
    benchmark that gains only new files and entries, runs as correct: its
    query comes from the program's registry, its window and relations from
    the traffic file, its reference from ``reference/q4.py``."""
    cell = added_cell(tmp_path, Q4_JOIN)
    assert (cell.query, cell.window) == ("q4", ["elementwise"])
    line, _, rec = run_cell(cell, 2**31 + 21, 0.3, False, device="cpu")
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= Q4_JOIN["ring_epochs"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert rec.counters["host_syncs"] == rec.windows


def test_the_traffic_files_window_takes_precedence(tmp_path):
    """The traffic file's window is the one held to the query's own: q7,
    tumbling 10 s in ``nexmark-10M`` and in the program, is refused at
    load where the traffic file asks for hopping 4 s / 2 s windows, and
    loads where it names the program's window though the configuration
    names another."""
    q7 = {"query": "q7", "relations": ["bid"], "ring_epochs": 20,
          "profile_windows": 4}
    added_cell(tmp_path, dict(q7, window=["tumbling", 10]))
    cfg = os.path.join(tmp_path, "flockbench", "configs",
                       "nexmark-added-cfg.json")
    with open(cfg) as f:
        c = json.load(f)
    c["windows"]["q7"] = ["hopping", 4, 2]
    with open(cfg, "w") as f:
        json.dump(c, f)
    assert load_cell("nexmark-added", root=str(tmp_path)).window \
        == ["tumbling", 10]
    with pytest.raises(ValueError, match=r"q7.*\['hopping', 4, 2\] is not "
                       r"the query's own.*\['tumbling', 10\]"):
        added_cell(tmp_path, dict(q7, window=["hopping", 4, 2]),
                   name="nexmark-hop")


@pytest.mark.parametrize("traffic,why", [
    ({"query": "q11"}, "q11.*session windows are not ranges of epochs"),
    ({"query": "q12"}, "q12.*global windows are not ranges of epochs"),
    ({"query": "q99"}, "q99.*flock_tpu_torch has no such query"),
    ({"query": "ysb5"}, "ysb5.*flock_tpu_torch has no such query"),
    ({"query": "q9"}, "q9.*no plain reference"),
    ({"query": "q4", "window": None}, "q4.*no window"),
    ({"query": "q4", "window": ["sliding", 4, 2]},
     r"q4.*\['sliding', 4, 2\] is not the query's own.*\['elementwise'\]"),
    ({"query": "q4", "relations": ["bid"]}, r"q4.*\['auction'\]"),
])
def test_a_cell_the_harness_cannot_run_fails_at_load(tmp_path, traffic, why):
    t = dict(Q4_JOIN, **traffic)
    if t["window"] is None:
        del t["window"]
    with pytest.raises(ValueError, match=why) as e:
        added_cell(tmp_path, t, name="nexmark-bad")
    assert str(e.value).startswith("cell nexmark-bad: query ")
    assert "\n" not in str(e.value)

"""Shared helpers of the benchmark's tests: a cell cut to a size the CPU
holds (the rate only; the ring, the windows and the query stay).

Besides the cells of ``BENCHMARK.json``, the tests hold the cells that
wait under PERF.md's Open questions to the same checks: their
configuration, traffic and reference files are in place, so that a later
change adds each by its ``BENCHMARK.json`` entry alone.  Such a cell takes
the metrics of ``ysb-campaigns``.

``added_cell`` adds a cell the way a later change does, by new files and
entries alone, in a copy of the benchmark: a NEXMark configuration at a
small rate, a traffic file and a workload."""

import copy
import dataclasses
import json
import os
import shutil

from flockbench.run import ROOT, load_cell

# waiting cell -> (configuration, traffic)
WAITING = {"nexmark-q5-hop": ("nexmark-10M", "q5-hop"),
           "nexmark-q7-tumble": ("nexmark-10M", "q7-tumble")}
CELLS = ("nexmark-q5-hop", "ysb-campaigns", "nexmark-q7-tumble")
TINY_EPS = 20_000


def _json(*parts):
    with open(os.path.join(ROOT, "flockbench", *parts)) as f:
        return json.load(f)


def any_cell(name: str):
    """The cell of ``BENCHMARK.json`` or the waiting cell named ``name``."""
    if name not in WAITING:
        return load_cell(name)
    config, traffic = WAITING[name]
    return dataclasses.replace(
        load_cell("ysb-campaigns"), name=name,
        config=_json("configs", f"{config}.json"),
        traffic=_json("traffic", f"{traffic}.json"))


def tiny_cell(name: str, eps: int = TINY_EPS):
    cell = any_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["generator"]["events_per_second"] = eps
    return dataclasses.replace(cell, config=cfg)


# q4 over element-wise windows: auction ⋈ bid, the join cell added by new
# files alone
Q4_JOIN = {"query": "q4", "relations": ["auction", "bid"],
           "window": ["elementwise"], "ring_epochs": 4, "profile_windows": 4}


def added_cell(root, traffic: dict, eps: int = TINY_EPS,
               name: str = "nexmark-added"):
    """Copy ``flockbench/`` and ``BENCHMARK.json`` under ``root``, add a
    NEXMark configuration at ``eps`` events/s, the traffic file
    ``traffic`` and a workload ``name`` of the two, and load the cell: no
    file that is there is edited.  Raises what ``load_cell`` raises."""
    root = str(root)
    bench = os.path.join(root, "flockbench")
    if not os.path.exists(bench):
        shutil.copytree(os.path.join(ROOT, "flockbench"), bench,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
    cfg = _json("configs", "nexmark-10M.json")
    cfg["name"] = f"{name}-cfg"
    cfg["generator"]["events_per_second"] = eps
    with open(os.path.join(bench, "configs", f"{name}-cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", f"{name}.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": f"{name}-cfg", "source": "x",
                         "file": f"flockbench/configs/{name}-cfg.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": name, "config": f"{name}-cfg",
                           "traffic": name, "chips": 1, "why": "x"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return load_cell(name, root=root)

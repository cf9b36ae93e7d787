"""Shared helpers of the benchmark's tests: a cell cut to a size the CPU
holds (the rate only; the ring, the windows and the query stay).

Besides the cells of ``BENCHMARK.json``, the tests hold the cells that
wait under PERF.md's Open questions to the same checks: their
configuration, traffic and reference files are in place, so that a later
change adds each by its ``BENCHMARK.json`` entry alone.  Such a cell takes
the metrics of ``ysb-campaigns``."""

import copy
import dataclasses
import json
import os

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

"""Run one benchmark cell once.

    python3 -m flockbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell, its configuration and its metrics
come from ``BENCHMARK.json``; each is found by name in files of its own:
``flockbench/configs/<config>.json`` (the deployment: the generator's
sizes, the windows, the guarantees), ``flockbench/traffic/<traffic>.json``
(the query, the relations it reads, the length of the ring of epochs, the
profiled stretch, and where it gives one, the window, which then takes
precedence over the configuration's),
``flockbench/reference/<query>.py`` (the plain reference) and
``flockbench/metrics/<metric>.py`` (each per-layer metric's reader; a
metric named ``<metric>.<part>``, one quantity split by the end-to-end
metric it moves in different cells, shares ``<metric>``'s reader).

A run:

1. Set-up (``setup_s``): generates the cell's ring of epochs on the host
   from ``--seed``, builds the program's stream driver, stages the ring on
   the card with the driver's own staging, and runs every distinct window
   once.
2. The timed window: replays the ring's windows in stream order for
   ``--seconds`` seconds, each through the program's window entry and its
   sink; nothing is staged inside it.  ``events_per_s`` is the events the
   completed windows advanced (a hop's for a hopping window, a whole
   window's for a tumbling one) over the window's wall time, which ends on a
   synchronize; ``window_p95_ms`` the 95th percentile of the windows' times
   from dispatch to their rows on the host.
3. ``--trace 1`` then profiles a stretch of windows and reports the
   per-layer metrics in place of the end-to-end ones.  The program's
   counters and span totals over the stretch, and over set-up, are kept
   in the run's ``Record`` for the readers.
4. Once the window has closed, the program's state is freed and every
   window's rows are compared with the plain reference's.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit).
Without a card (or with fewer than the cell asks for) the run prints no
result and exits 2; a run that finds ``jax``, ``jaxlib``, ``flax`` or
``flock_tpu`` loaded exits 3; a cell the harness cannot run (a query the
program lacks, one whose windows are not ranges of epochs, a window other
than the query's own in the program, a window or relation missing) exits
4 with one line that names the query and why.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "flock_tpu")


# -- the benchmark's files, found by name ------------------------------------

def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: str = ROOT

    @property
    def query(self) -> str:
        return self.traffic["query"]

    @property
    def window(self) -> list | None:
        """The cell's window: the traffic file's ``window`` where it gives
        one, else the configuration's ``windows[query]``.  ``admit`` holds
        it to the query's own window in the program."""
        return self.traffic.get("window") \
            or self.config.get("windows", {}).get(self.query)

    def reference(self):
        return _module(os.path.join(self.root, "flockbench", "reference",
                                    f"{self.query}.py"),
                       f"flockbench_reference_{self.query}")

    def reader(self, metric: str):
        base = metric.split(".")[0]
        return _module(os.path.join(self.root, "flockbench", "metrics",
                                    f"{base}.py"),
                       "flockbench_metric_" + base.replace("-", "_"))


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    (wl,) = [w for w in bench["workloads"] if w["name"] == name]
    (cf,) = [c for c in bench["configs"] if c["name"] == wl["config"]]

    def mine(m):
        return name in m.get("workloads", [name])

    cell = Cell(
        name=name, chips=wl["chips"],
        config=_json(os.path.join(root, cf["file"])),
        traffic=_json(os.path.join(root, "flockbench", "traffic",
                                   f"{wl['traffic']}.json")),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)], root=root)
    try:
        admit(cell)
    except ValueError as e:
        raise ValueError(f"cell {name}: {e}") from None
    return cell


def admit(cell: Cell) -> None:
    """Raises ``ValueError``, in one line that names the query and why,
    where the harness cannot run ``cell``: a query the program lacks or
    whose windows are not ranges of epochs, no plain reference, no window,
    a window other than the query's own in the program, no window in the
    ring, or a relation the query reads that the traffic file does not
    name."""
    from flockbench.program import query_spec

    q, window = cell.query, cell.window
    ring = cell.traffic["ring_epochs"]
    spec = query_spec(q)
    try:
        ranges = window_ranges(list(spec.window), ring)
    except ValueError as e:
        raise ValueError(f"query {q!r}: {e}") from None
    if not os.path.exists(os.path.join(cell.root, "flockbench", "reference",
                                       f"{q}.py")):
        raise ValueError(f"query {q!r}: no plain reference "
                         f"flockbench/reference/{q}.py")
    if not window:
        raise ValueError(f"query {q!r}: no window: neither the traffic "
                         f"file's 'window' nor the configuration's "
                         f"'windows' names one")
    if tuple(window) != spec.window:
        raise ValueError(f"query {q!r}: the cell's window {window} is not "
                         f"the query's own in flock_tpu_torch, "
                         f"{list(spec.window)}")
    if not ranges:
        raise ValueError(f"query {q!r}: a ring of {ring} epochs holds no "
                         f"{window} window")
    missing = sorted(set(spec.relations) - {"side_input"}
                     - set(cell.traffic["relations"]))
    if missing:
        raise ValueError(f"query {q!r} reads {missing}, which the traffic "
                         f"file's 'relations' do not name")


# -- windows -----------------------------------------------------------------

def window_ranges(window: list, epochs: int) -> list[tuple[list, list]]:
    """(epochs of the window, epochs it advances the stream by) of every
    window over a ring of ``epochs`` epochs, in stream order: an
    element-wise window is one epoch, and advances the stream by it."""
    kind = window[0]
    if kind == "elementwise":
        return [([t], [t]) for t in range(epochs)]
    w = window[1]
    if kind == "tumbling":
        return [(list(range(t, t + w)), list(range(t, t + w)))
                for t in range(0, epochs - w + 1, w)]
    if kind == "hopping":
        h = window[2]
        return [(list(range(t, t + w)), list(range(t + w - h, t + w)))
                for t in range(0, epochs - w + 1, h)]
    raise ValueError(f"{kind} windows are not ranges of epochs that the "
                     f"benchmark forms")


def window_tables(epochs: list[dict], rng: list[int]) -> dict:
    """A window's host tables: its epochs' rows of each relation."""
    rels = {r for t in rng for r in epochs[t]}
    return {r: {c: np.concatenate([epochs[t][r][c] for t in rng
                                   if r in epochs[t]])
                for c in next(epochs[t][r] for t in rng if r in epochs[t])}
            for r in sorted(rels)}


def make_ring(cell: Cell, seed: int) -> tuple[list[dict], list[int], list]:
    """(epochs, events per epoch, windows) of the cell's ring."""
    from flockbench import gen

    cfg = cell.config
    ring = cell.traffic["ring_epochs"]
    relations = tuple(cell.traffic["relations"])
    epochs, events = gen.generate(cfg, seed, ring, relations)
    windows = window_ranges(cell.window, ring)
    if "campaign" in relations:
        # the campaign table rides with the first epoch of each window
        table = gen.campaign_table(cfg["generator"])
        firsts = {rng[0] for rng, _ in windows}
        for t, e in enumerate(epochs):
            e["campaign"] = table if t in firsts else \
                {c: v[:0] for c, v in table.items()}
    return epochs, events, windows


# -- the run -----------------------------------------------------------------

@dataclass
class Record:
    """What a run measured, for the metric readers."""

    seconds: float = 0.0
    windows: int = 0
    events: int = 0
    latencies_s: list = field(default_factory=list)
    execute_s: list = field(default_factory=list)
    emit_s: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    # the program's counters and span totals (``program.registry``) over
    # set-up and over the profiled stretch
    setup_counters: dict = field(default_factory=dict)
    stretch: dict = field(default_factory=dict)
    profile: dict | None = None
    profile_windows: int = 0
    least_bytes: float = 0.0
    peaks: dict | None = None
    setup_s: float = 0.0


def _delta(before: dict, after: dict) -> dict:
    """``after`` less ``before``, key by key (a key new in ``after``
    counts from 0)."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profile_stretch(prog, order, device) -> tuple[dict | None, list]:
    """Run ``order``'s windows under the profiler; (trace summary, outputs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from flockbench import trace

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=acts) as prof:
            with record_function("stretch"):
                for w in order:
                    with record_function("window"):
                        rows, _, _ = prog.run_window(w, spans=record_function)
                    outs.append((w, rows))
                _sync(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return trace.summarize(path), outs


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device="cuda") -> tuple[dict, dict, Record]:
    """One run of ``cell``: (result line, notes for standard error, the
    record the readers read)."""
    import torch

    from flockbench.compare import checks, correct, rows_unequal
    from flockbench.program import Program, registry

    rec = Record()
    t0 = time.perf_counter()
    epochs, events, windows = make_ring(cell, seed)
    t_gen = time.perf_counter() - t0
    r0 = registry()
    prog = Program(cell.query, epochs, device)
    got = [rng for _, rng in prog.ranges]
    if got != [rng for rng, _ in windows]:
        raise RuntimeError(f"the program's windows {got} are not the "
                           f"benchmark's {[r for r, _ in windows]}")
    _sync(device)
    t_stage = time.perf_counter() - t0 - t_gen
    prog.warm_up()
    _sync(device)
    rec.setup_s = time.perf_counter() - t0
    rec.setup_counters = _delta(r0, registry())
    advance = [sum(events[t] for t in adv) for _, adv in windows]

    # the timed window
    c0 = prog.counters()
    outs: list[tuple[int, dict | None]] = []
    raised: list[str] = []
    i = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        w = i % len(windows)
        try:
            rows, te, tm = prog.run_window(w)
        except Exception as e:  # noqa: BLE001 — a window that raised fails
            raised.append(f"window {i}: {type(e).__name__}: {e}"[:300])
            outs.append((w, None))
        else:
            outs.append((w, rows))
            rec.latencies_s.append(te + tm)
            rec.execute_s.append(te)
            rec.emit_s.append(tm)
            rec.events += advance[w]
        i += 1
        # every distinct window runs at least once, however short the window
        if i >= len(windows) and time.perf_counter() >= deadline:
            break
    _sync(device)
    rec.seconds = time.perf_counter() - start
    rec.windows = i
    c1 = prog.counters()
    rec.counters = _delta(c0, c1)

    if traced:
        n = int(cell.traffic["profile_windows"])
        order = [(i + k) % len(windows) for k in range(n)]
        s0 = prog.counters()
        rec.profile, more = _profile_stretch(prog, order, device)
        rec.stretch = _delta(s0, prog.counters())
        rec.profile_windows = n
        outs += more

    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    prog.release()
    prog = None
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the check: every window's rows against the reference's
    ref_mod = cell.reference()
    refs, least = [], []
    for rng, _ in windows:
        tables = window_tables(epochs, rng)
        want = ref_mod.reference(tables, cell.config)
        refs.append(want)
        least.append(ref_mod.least_bytes(tables, cell.config, want))
    unequal_rows = unequal_windows = 0
    for w, rows in outs:
        if rows is None:
            continue
        d = rows_unequal(rows, refs[w])
        unequal_rows += d
        unequal_windows += d > 0
    if traced:
        rec.least_bytes = statistics.fmean(least[w] for w in order)

    kind = torch.cuda.get_device_name(device) \
        if torch.device(device).type == "cuda" else "cpu"
    rec.peaks = _json(os.path.join(cell.root, "flockbench",
                                   "peaks.json")).get(kind)
    compared = checks(len(raised), unequal_windows, unequal_rows)
    attempted = len(outs)
    failed = len(raised) + unequal_windows
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {
            "events_per_s": rec.events / rec.seconds,
            "window_p95_ms": float(np.percentile(rec.latencies_s, 95)) * 1e3
            if rec.latencies_s else None,
            "setup_s": rec.setup_s,
        }
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": attempted > 0 and correct(compared),
            "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if traced and rec.profile is not None:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
        line["breakdown"] = {"device_ops": rec.profile["device_ops"],
                             "idle_gaps": rec.profile["idle_gaps"]}
    line["checks"] = compared
    notes = {
        "cell": cell.name, "seed": seed, "card": _card(device),
        "ring_epochs": len(epochs), "events_in_ring": sum(events),
        "windows_timed": rec.windows, "window_s": rec.seconds,
        "gen_s": t_gen, "stage_s": t_stage, "setup_s": rec.setup_s,
        "windows_raised": raised[:5],
    }
    if rec.profile is not None:
        notes["h2d_bytes_in_stretch"] = rec.profile["h2d_bytes"]
        notes["h2d_copies_in_stretch"] = rec.profile["h2d_copies"]
        notes["kernel_s_in_stretch"] = rec.profile["kernel_s"]
        notes["least_bytes_per_window"] = rec.least_bytes
    if traced:
        notes["windows_formed_in_stretch"] = {
            k: rec.stretch.get(k, 0) for k in ("execute.form_views",
                                               "execute.form_copies")}
    return line, notes, rec


def _card(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import torch
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, check=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def forbidden_modules(names=None) -> list[str]:
    """Of ``names`` (the loaded modules by default), the top-level names
    that are JAX's or the JAX package's, compared whole
    (``flock_tpu_torch`` is not ``flock_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flockbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches stay in fixed directories of the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "build", "triton")

    import torch

    try:
        cell = load_cell(args.workload)
    except ValueError as e:
        print(f"flockbench: {e}", file=sys.stderr)
        return 4
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"flockbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    line, notes, _ = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"flockbench: loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(notes), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark harness: NEXMark and YSB rows/s on one card — the port's
counterpart of the repository root's ``bench.py`` (the reference's JAX
harness), with its function names, sizing rules and record keys.

    python -m flock_tpu_torch.tools.bench [--seconds N] [--eps N]
        [--query N] [--repeats N] [--all | --only Q] [--out FILE]
        [--device D]

Prints ONE JSON line last: {"metric", "value", "unit", "vs_baseline"},
the rows/s of ``--query`` (the larger of its per-window and stacked
rates).  ``--all`` first runs q0-q13 and YSB at ``_run_one``'s sizes,
writes them to ``--out`` and exits non-zero, once the metric line is
printed, if any entry failed; ``--only Q`` prints one entry's record and
stops.  Everything runs on the card unless ``--device cpu`` is given;
without a card and without it, the harness raises.

The timed passes feed the executor as ``StreamDriver`` does: every epoch
staged once at ``epoch_caps`` (outside the timing, reported as
``feed_time_s``), each window through ``execute_epochs``, the best of
``--repeats`` passes ended by one wait for the card.  The feed-inclusive
pass stages epoch k + 1 before the windows ending at epoch k run; the
stacked pass runs every window through one ``execute_stacked`` at equal
per-window capacities.  q11 and q12 run the whole driver
(``run(epochs, prestaged=prestage(epochs))``).  ``rtt_s`` is the round
trip of a one-element readback from the card.

The timing helpers (``cuda_ms``, ``best_s``) and the epoch staging
(``EpochFeed``) are also chip_smoke.py's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from flock_tpu_torch import resolve_device

# the reference's README q5 demo: 10k events in 1,177.85 ms billed on one
# 128 MB function (bench.py's baseline)
REFERENCE_EVENTS_PER_SEC = 10_000 / 1.17785
ENTRIES = [str(q) for q in range(14)] + ["ysb"]
# the reference's sizing of an --all entry: the windowed queries (q5's
# hopping, q7's and q8's tumbling windows, YSB's) over at least 10 s, q3
# (persons and auctions, 8 % of the events) at 4x the rate, q8 at 5 M
# events/s at least
WINDOWED_MIN_SECONDS, Q3_RATE_FACTOR, Q8_MIN_EPS = 10, 4, 5_000_000
# a call this slow (ms) is timed over SLOW_REPS runs: its median needs
# fewer, and fifteen of the plain K2 over 33.5 M rows take 17 s
SLOW_MS, SLOW_REPS = 50.0, 3


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def best_s(fn, reps: int = 3, device="cuda") -> float:
    """The least wall time of ``fn()`` to a synchronised ``device``."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def cuda_ms(fn, reps: int = 15, warmup: int = 2) -> float:
    """Median time of ``fn()`` on the device's timeline over ``reps`` runs
    (CUDA events; ``SLOW_REPS`` where a warm-up call took ``SLOW_MS`` or
    more): device work plus the gaps where the device waits for the host
    to launch the next operation."""
    def once() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    if any([once() >= SLOW_MS for _ in range(warmup)]):
        reps = min(reps, SLOW_REPS)
    return statistics.median(once() for _ in range(reps))


def round_trip_s(device, reps: int = 3) -> float:
    """Mean time of one small operation and a one-element readback."""
    x = torch.zeros(8, dtype=torch.int32, device=device)
    (x + 1)[:1].cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        (x + 1)[:1].cpu()
    return (time.perf_counter() - t0) / reps


def hardware(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (its
    name alone where ``nvidia-smi`` cannot run); ``cpu`` on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device)


def _rows(cols: dict) -> int:
    return len(next(iter(cols.values()))) if cols else 0


class EpochFeed:
    """How ``StreamDriver`` feeds range windows: every epoch staged once at
    the driver's per-epoch capacities, each window through
    ``execute_epochs`` over its epochs' batches.  Each method takes the
    executor, so the same stream can be staged on several devices."""

    def __init__(self, driver, epochs: list):
        self.epochs = epochs
        self.caps = driver.epoch_caps(epochs)
        self.ranges = [[t for t in rng if t < len(epochs)]
                       for _, rng in driver.epoch_ranges(epochs)]
        # the one epoch of each window, when every window holds one
        self.single = [rng[0] for rng in self.ranges] \
            if all(len(rng) == 1 for rng in self.ranges) else None

    def stage_one(self, ex, epoch: dict) -> dict:
        return {r: ex.stage_chunk(epoch[r], c) for r, c in self.caps.items()}

    def stage(self, ex) -> list:
        return [self.stage_one(ex, e) for e in self.epochs]

    def run(self, ex, staged: list, i: int, check: bool = True):
        return ex.execute_epochs([staged[t] for t in self.ranges[i]],
                                 check_overflow=check)

    def compute(self, ex, staged: list) -> list:
        """Every window from the staged epochs, flags unchecked."""
        return [self.run(ex, staged, i, False)
                for i in range(len(self.ranges))]

    def feed(self, ex) -> list:
        """Stage and run in stream order, epoch t + 1 staged before the
        windows that end at epoch t run."""
        ending: dict = {}
        for i, rng in enumerate(self.ranges):
            ending.setdefault(rng[-1], []).append(i)
        staged, outs = [], []
        for t, e in enumerate(self.epochs):
            staged.append(self.stage_one(ex, e))
            outs += [self.run(ex, staged, i, False)
                     for i in ending.get(t - 1, ())]
        outs += [self.run(ex, staged, i, False)
                 for i in ending.get(len(self.epochs) - 1, ())]
        return outs


def _gen_epochs(seconds: int, eps: int, cache: dict | None = None):
    """(epochs, generation seconds) of one generator's stream; ``cache``
    keeps each (seconds, eps) once across an ``--all`` sweep, whose
    queries share their inputs."""
    from flock_tpu_torch.runtime.stream import generate_epochs

    key = (seconds, eps)
    if cache is not None and key in cache:
        return cache[key]
    t0 = time.perf_counter()
    epochs = generate_epochs(seconds, eps)
    got = (epochs, time.perf_counter() - t0)
    if cache is not None:
        cache[key] = got
    return got


def _stacked(ex, windows: list, repeats: int) -> float:
    """The best time of one ``execute_stacked`` over ``windows`` (host
    tables) staged at equal capacities, after a first run that checks
    their flags."""
    from flock_tpu_torch.batch import round_up

    caps = {r: max(max(round_up(max(_rows(t[r]), 1)), 128) for t in windows)
            for r in windows[0]}
    staged = [ex.prepare_window(t, caps) for t in windows]
    ex.execute_stacked(staged)
    return best_s(lambda: ex.execute_stacked(staged, check_overflow=False),
                  repeats, ex.device)


def bench_query(qnum: int, seconds: int, eps: int, repeats: int = 3,
                device=None, cache: dict | None = None) -> dict:
    """One range-windowed query: compute-only, feed-inclusive and stacked
    passes over the one-generator stream."""
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import StreamDriver
    from flock_tpu_torch.runtime.tables import default_side_input

    spec = get_query(qnum)
    epochs, gen_dt = _gen_epochs(seconds, eps, cache)
    driver = StreamDriver(spec, seconds, device=device)
    ex = driver.executor
    feed = EpochFeed(driver, epochs)
    if not feed.ranges:
        raise ValueError(f"q{qnum}: no {spec.window[0]} window closes in "
                         f"{seconds} s")

    t0 = time.perf_counter()
    staged = feed.stage(ex)
    sync(ex.device)
    feed_dt = time.perf_counter() - t0
    # warm-up, and every window's capacities checked once: a later
    # window's overflow must fail here, not pass unseen in the timed runs
    for i in range(len(feed.ranges)):
        feed.run(ex, staged, i)
    windows = [t for _, t in driver.windows(epochs)]
    rows_in = sum(_rows(t[r]) for t in windows for r in t)
    if "side_input" in spec.relations:
        # the reference counts the side table into each window's rows
        rows_in += len(windows) * _rows(ex.side_input or default_side_input())
    rtt = round_trip_s(ex.device)
    best = best_s(lambda: feed.compute(ex, staged), repeats, ex.device)
    del staged
    best_incl = best_s(lambda: feed.feed(ex), min(repeats, 3), ex.device)
    stacked = _stacked(ex, windows, repeats)
    return {
        "query": qnum, "rows_in": rows_in, "wall_time_s": best,
        "rtt_s": round(rtt, 6), "rows_per_s": rows_in / best,
        "feed_incl_wall_s": best_incl,
        "rows_per_s_feed_inclusive": rows_in / best_incl,
        "gen_time_s": gen_dt, "feed_time_s": feed_dt,
        "windows": len(feed.ranges),
        "stacked_wall_time_s": stacked,
        "rows_per_s_stacked": rows_in / stacked,
    }


def bench_stream_query(qnum: int, seconds: int, eps: int, repeats: int = 3,
                       device=None, cache: dict | None = None) -> dict:
    """q11 and q12, whose windows depend on the data: the whole driver
    (host sessionisation or arrival windows and the card's work) over
    epochs prestaged outside the timing (``feed_time_s``); feed-inclusive,
    the driver stages each epoch itself."""
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import StreamDriver

    spec = get_query(qnum)
    epochs, gen_dt = _gen_epochs(seconds, eps, cache)
    rows_in = sum(_rows(e["bid"]) for e in epochs)
    driver = StreamDriver(spec, seconds, device=device)
    dev = driver.executor.device
    t0 = time.perf_counter()
    staged = driver.prestage(epochs)
    sync(dev)
    feed_dt = time.perf_counter() - t0
    results = driver.run(epochs, prestaged=staged)
    best = best_s(lambda: driver.run(epochs, prestaged=staged), repeats, dev)
    del staged
    best_incl = best_s(lambda: driver.run(epochs), min(repeats, 2), dev)
    return {
        "query": qnum, "rows_in": rows_in, "wall_time_s": best,
        "rows_per_s": rows_in / best, "feed_incl_wall_s": best_incl,
        "rows_per_s_feed_inclusive": rows_in / best_incl,
        "gen_time_s": gen_dt, "feed_time_s": feed_dt,
        "windows": len(results), "mode": "streaming_driver",
    }


def bench_ysb(seconds: int, eps: int, repeats: int = 3,
              device=None) -> dict:
    """YSB (filter → campaign join → tumbling count): windows formed on
    the host as ``run_ysb`` forms them, staged whole at its capacities."""
    import numpy as np

    from flock_tpu_torch.datagen.ysb import YsbConfig
    from flock_tpu_torch.queries.ysb import (campaign_table,
                                             generate_ysb_epochs,
                                             ysb_capacities, ysb_query)
    from flock_tpu_torch.runtime.executor import LocalExecutor

    cfg = YsbConfig(seconds=seconds, events_per_second=eps)
    t0 = time.perf_counter()
    epochs = generate_ysb_epochs(cfg)
    gen_dt = time.perf_counter() - t0
    spec = ysb_query()
    camp = campaign_table(cfg)
    ex = LocalExecutor(spec, device=device)
    w = spec.window[1]
    caps = ysb_capacities(cfg, w)
    windows = []
    for k in range(max(seconds // w, 1)):
        chunk = epochs[k * w:(k + 1) * w]
        windows.append({"ad_event": {
            c: np.concatenate([e["ad_event"][c] for e in chunk])
            for c in chunk[0]["ad_event"]}, "campaign": camp})
    rows_in = sum(_rows(t["ad_event"]) for t in windows)

    t0 = time.perf_counter()
    staged = [ex.prepare_window(t, caps) for t in windows]
    sync(ex.device)
    feed_dt = time.perf_counter() - t0
    # warm-up, and every window's capacities checked once
    for b in staged:
        ex.execute_batches(b)
    best = best_s(lambda: [ex.execute_batches(b, check_overflow=False)
                           for b in staged], repeats, ex.device)

    def feed():
        nxt = ex.prepare_window(windows[0], caps)
        for t in windows[1:] + [None]:
            cur, nxt = nxt, (None if t is None
                              else ex.prepare_window(t, caps))
            ex.execute_batches(cur, check_overflow=False)

    best_incl = best_s(feed, min(repeats, 3), ex.device)
    stacked = best_s(lambda: ex.execute_stacked(staged, check_overflow=False),
                     repeats, ex.device)
    return {
        "query": "ysb", "rows_in": rows_in, "wall_time_s": best,
        "rows_per_s": rows_in / best, "feed_incl_wall_s": best_incl,
        "rows_per_s_feed_inclusive": rows_in / best_incl,
        "gen_time_s": gen_dt, "feed_time_s": feed_dt,
        "windows": len(windows), "stacked_wall_time_s": stacked,
        "rows_per_s_stacked": rows_in / stacked,
    }


def _run_one(which: str, args, cache: dict | None = None) -> dict:
    """One ``--all`` entry at the reference's sizes."""
    if which == "ysb":
        secs = max(args.seconds, WINDOWED_MIN_SECONDS)
        if secs != args.seconds:
            print(f"ysb: seconds raised to {secs} (tumbling window)",
                  file=sys.stderr)
        r = bench_ysb(secs, args.eps, args.repeats, args.device)
        r["seconds"], r["eps"] = secs, args.eps
        return r
    q = int(which)
    secs = max(args.seconds, WINDOWED_MIN_SECONDS) if q in (5, 7, 8) \
        else args.seconds
    eps = args.eps
    if q == 3:
        eps = max(eps, Q3_RATE_FACTOR * args.eps)
    if q == 8:
        eps = max(eps, Q8_MIN_EPS)
    run = bench_stream_query if q in (11, 12) else bench_query
    r = run(q, secs, eps, args.repeats, args.device, cache)
    r["seconds"], r["eps"] = secs, eps
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flock_tpu_torch.tools.bench")
    ap.add_argument("--seconds", type=int, default=4)
    ap.add_argument("--eps", type=int, default=4_000_000)
    ap.add_argument("--query", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=7,
                    help="timing repeats; the least is reported")
    ap.add_argument("--all", action="store_true",
                    help="run q0..q13 and YSB and write the artifact --out")
    ap.add_argument("--only", default=None, choices=ENTRIES,
                    help="run one --all entry and print its record")
    ap.add_argument("--out", default="BENCH_TORCH_QUERIES.json",
                    help="the artifact --all writes")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch "
                    "path)")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    cache: dict = {}

    if args.only is not None:
        r = _run_one(args.only, args, cache)
        r["device"] = hardware(args.device)
        print(json.dumps(r), flush=True)
        return 0

    failed = 0
    if args.all:
        results = []
        for which in ENTRIES:
            try:
                r = _run_one(which, args, cache)
            except Exception as e:  # noqa: BLE001 — recorded, then rc 1
                failed += 1
                r = {"query": which, "error": str(e)[:200]}
            results.append(r)
            print(json.dumps(r), file=sys.stderr, flush=True)
        doc = {
            "hardware": hardware(args.device),
            "config": {
                "seconds": args.seconds, "events_per_second": args.eps,
                "repeats": args.repeats,
                "note": ("windowed queries (q5/q7/q8, ysb) run at >=10s; "
                         "q3 at 4x eps and q8 at >=5M eps (the reference "
                         "harness's sizes); q11/q12 time the whole "
                         "streaming driver over epochs prestaged outside "
                         "the timing (feed_time_s)"),
            },
            "results": results,
        }
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")

    r = bench_query(args.query, args.seconds, args.eps, args.repeats,
                    args.device, cache)
    print(json.dumps(r), file=sys.stderr, flush=True)
    best = max(r["rows_per_s"], r["rows_per_s_stacked"])
    print(json.dumps({
        "metric": f"nexmark_q{args.query}_rows_per_s_per_chip",
        "value": round(best, 1),
        "unit": "rows/s",
        "vs_baseline": round(best / REFERENCE_EVENTS_PER_SEC, 2),
    }), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

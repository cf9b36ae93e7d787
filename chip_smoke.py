#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``flock_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``flock_tpu_torch/csrc`` (``nvcc``,
into ``flock_tpu_torch/build/``) and runs these phases; any failure raises
and the script exits non-zero:

1. environment: torch / CUDA / nvcc / triton versions, the card, the kernel
   build time, and the device-to-device copy bandwidth (1 GiB copy);
2. each kernel against its plain PyTorch version on the same CUDA tensors,
   at the shapes of one bench window of the queries that run it (K3 at q3
   as the clean duplicate-faithful join: three columns gathered and seven
   carried to the fan-out capacity in one launch), and on adversarial shapes off the main path (K1 and K2: every key on one
   slot, keys K1's window misses, ragged and tiny inputs, no valid row,
   unaligned columns, K2 on both sides of its two shared-memory limits; K3: one
   hot slot, all misses, uniform keys, keys at the int32 extremes, a span
   of 1, n in {1, 3, 4, 5, 1003}, unaligned probe columns, 8-byte, mixed
   and eight columns, a ragged carry), exact equality on every output row,
   with CUDA event timings of the kernel, the plain version and the nearest
   single PyTorch call, the host's share of the call, the device operations
   per wrapper call, and each case's byte bound (K1's and K2's count
   their keys and aggregated columns over the valid rows only, since an
   invalid row's values need no read);
3. the queries, each through ``StreamDriver.run`` (YSB through ``run_ysb``)
   on the card: q4, q9, q13, q6, q0, q1, q2, q10 and q2 over row-count
   windows of 5 M bids at the bench size (4 s x 4 M events/s, element-wise
   windows, one set of epochs); q3 at 4 s x 16 M events/s; q5 (hopping
   10/5: two windows), q7 and q8 (tumbling 10 s), q2 over sliding (4/2)
   and stagger (3 s, epochs 0, 1 and 5 blanked) windows and q12 over
   processing-time windows ([0, 10) and [10, 15) of arrival) on 15 s x 4 M
   events/s; YSB at 10 s x 4 M events/s.  For each: every kernel of the
   query's path launched (counts zeroed just before the run, read just
   after), no fallback, no plain kernel version on a card tensor, each
   epoch staged once, every window's device columns equal to the plain
   CPU path's and its rows to an independent numpy version; compute-only
   (StreamDriver's path from prestaged inputs; for q12 ``run(epochs,
   prestaged=prestage(epochs))``) and feed-inclusive rows/s and the
   device's idle share.  q12 also makes exactly one K2 launch per staged
   chunk (15), and its fast consts runner equals the general one on the
   same staged chunks (a ``q12 (tag): fast runner = general runner``
   line per window).  q11 (session windows, 10 s gap) runs in its device
   tier on the bench epochs (one flush emission) and on the 15 s epochs
   (timeouts from epoch 10 on; the emission buffer overflows and the
   closing chunk rolls back and reruns with doubled buckets), and in its
   generic label-table tier on the 15 s epochs: K2 launched (and K3 in
   the generic tier), no plain kernel version on a card tensor, each
   epoch staged once (plus each compaction's merged rows), every
   emission's rows equal to ``numpy_q11`` (a vectorised sessionisation of
   the whole stream), the device tier's emissions to the plain CPU
   path's row for row and the generic tier's to the device tier's; with
   compute-only (``run(epochs, prestaged=prestage(epochs))``) and
   feed-inclusive rows/s, the idle share, the emissions, the rollbacks,
   the flag reads per chunk, the host's per-epoch key-range time and the
   generic tier's compactions.  Then the device tier's checkpoint/resume
   on the 15 s epochs: epochs 0-7 through ``step_impl``, the open
   sessions through ``to_payloads`` and a file backend, a fresh driver
   resuming at epoch 8; the union of the emissions equals the
   uninterrupted run's rows (open sessions, payload bytes, write and read
   times printed).  Then the kernels, as in phase 2, on the tensors the
   main paths gave them in their first window: K2 and K3 at q7 (~36.8 M
   bids on one key and the gather of their max back to them), K2 at q5's
   count onto ~37 M slots, K2 and K3 at YSB (~40 M events onto 128
   campaign slots, the gather from 1,000 campaign slots), K2 at q12's
   first chunk count (~3.68 M bids), K1 at q6 (~3.68 M bids, the int64
   max of ``__order`` and the seller carry), K2 at q11's first per-epoch
   aggregation (~3.68 M bids, count and min/max of ``b_date_time``) and
   K3 and K2 at the generic tier's first emission (the three label tables
   gathered to the emission's rows, the aggregate by ``__session``); then
   K1's int64 max off the
   main path on the adversarial cases of tests/torch_kernel_cases.py
   (extremes, negative values, values equal in their high or in their low
   32 bits, one slot, keys K1's window misses, no valid row), each also
   against numpy;
   The SQL phases (``sql``, ``sql windows``, ``sql ysb``): every SQL
   text of tests/test_sql.py, q6's and q11's (``GROUP BY bidder``),
   lowered by ``sql_to_spec`` and run through ``StreamDriver.run`` on the
   bench epochs as the hand plans are (less their plain CPU pass), each
   run's rows against its hand plan's from this run and the numpy
   version (SQL q6's averages to rtol 1e-9), q4's, q9's and q13's numbers
   beside their hand plans' (q4 and q9 with the same launches: K1 kept);
   the float-key join (q13's side input as float32 keys, one bench
   window's bids) against the CPU path; ``cli.main`` in process:
   ``fsql`` with SQL q4 over the bench stream as one window (its row
   count against ``numpy_q4``) and ``nexmark run -q 4 --metrics``; SQL q5
   (hopping) and q7 (tumbling) on the 15 s epochs and YSB's SQL on the
   YSB window, against the hand plans' rows and numpy; nine aggregates by
   auction (K2 in two launches a window) and the BETWEEN chain with nine
   (unfused: no K1 launch) on the bench epochs, against numpy, their
   launches exactly as predicted;
   The sharded executor (``flock_tpu_torch/parallel``), 8 shards on the
   card (``dist``, ``multihost``, ``dist windowed``, ``dist ysb``):
   ``hash32`` on the card bit for bit its CPU result on 4 M keys; the
   bench epochs of 8 generators (4 s x 4 M events/s, generator p → shard
   p % 8) through ``DistStreamDriver`` for q4, q9, q13, q6, q3, q0, q1, q2,
   q10 (element-wise) and q11's device tier, q4 also at 1, 2 and 4 shards;
   ``MultiHostExecutor`` in a one-process NCCL group of 4 local shards
   (q4, every epoch, rows equal to the in-process 4-shard run's, row for
   row); 15 s x 4 M events/s of 8 generators for q5 (hopping 10/5), q7
   (tumbling 10), q12 and q11; YSB's windows row-sharded round robin.
   Each run's rows equal the single-card ``StreamDriver``'s on the merged
   epochs (itself held against numpy), its kernels' launches the counts
   ``DIST_LAUNCHES`` predicts, exactly; no fallback, one host sync a
   window; with compute-only (prestaged shard inputs), profiled and
   feed-inclusive passes, the byte record (``shuffle.TALLY``) per window.
   The SQL phases take one compute-only and one feed-inclusive pass (no
   profile);
   Ingestion, recovery and stacked windows (``ingest``, ``recovery``,
   ``stacked``, after ``dist clean``): q4 over 4 s x 250 k events/s of
   auction and bid fragments (1,024 rows each) scrambled with duplicates,
   sent by ``send_fragments`` to a ``SocketIngestServer`` and run by
   ``IngestDriver``; q3 over the person and auction fragments of 4 s x 100
   k events/s that ``produce`` writes to a file and ``ingest --file``
   tails (the CLI in process); each window's rows equal to the direct
   ``StreamDriver``'s on the same epochs and to numpy's, the launches the
   direct run's (``WINDOW_LAUNCHES`` a window), one flag read a window, and
   produce, assemble and execute seconds apart.  The first bench epoch as
   one q4 window: ``to_fragments`` at ``SYNC_GRANULE``, a
   ``FileStateBackend`` checkpoint, an ``Arena`` that loses one bid
   fragment and gets another twice, the lost one read back; the recovered
   window on ``LocalExecutor`` and row-sharded over an 8-shard
   ``DistributedExecutor`` equal to the direct window's rows, checkpoint
   bytes and write and read seconds printed.  ``execute_stacked`` over
   the 4 bench windows of q4 and of q9 (one flag read for the set, the
   per-window passes' launches, every window ``execute_batches``' slot for
   slot, the stacked time beside the per-window pass's), and the G=3
   duplicates window stacked between two clean ones (one rerun, one more
   flag read, ``WINDOW_FALLBACK_LAUNCHES`` for it, rows equal to numpy's);
4. the duplicate configuration (10 s x 350 events/s, 3 generators, one 10 s
   window) for q4, q9, q6, SQL q4 and q3 on the card against numpy — q4,
   q9, q6 and SQL q4 rerun the window with the duplicate-faithful
   fallback, SQL q4's rows equal to q4's — and q3 over that window with
   every person row repeated, which reruns too;
5. the card's name and power limit, then one JSON result line.

Each phase prints its seconds (a ``phase <name>`` line).

It imports nothing of ``jax`` or ``flock_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from flock_tpu_torch.tools.bench import EpochFeed, best_s, cuda_ms  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM3 bandwidth.  Every kernel here moves a few
# bytes per row and does a few integer operations on them: bytes bound them.
PEAK_BYTES_S = 3.35e12
SEED = 1234
BENCH_SECONDS, BENCH_EPS = 4, 4_000_000   # bench.py's defaults
Q3_EPS = 4 * BENCH_EPS                    # bench.py raises q3 to 4x (:322)
# the windowed queries: 15 s give q5 two hopping windows ([0, 10), [5, 15))
# and q7/q8 one tumbling window; bench.py runs YSB at 10 s (:315)
WIN_SECONDS, YSB_SECONDS = 15, 10
ROWS_N = 5_000_000                        # q2's row-count windows

# kernel → (source, the TPU kernel it replaces)
KERNELS = {
    "join_agg": ("flock_tpu_torch/csrc/join_agg.cu",
                 "flock_tpu/pallas/join_agg.py:297"),
    "dense_agg": ("flock_tpu_torch/csrc/dense_agg.cu",
                  "flock_tpu/pallas/factored.py:460"),
    "gather": ("flock_tpu_torch/csrc/gather.cu",
               "flock_tpu/pallas/factored.py:555"),
}
# the kernels each run's main path must launch (the bid-only element-wise
# queries and q2's windows launch none)
QUERY_KERNELS = {"q4": ("join_agg", "dense_agg"),
                 "q6": ("join_agg", "dense_agg"),
                 "q12": ("dense_agg",),
                 "q9": ("join_agg", "dense_agg", "gather"),
                 "q13": ("dense_agg", "gather"),
                 "q3": ("dense_agg", "gather"),
                 "q5": ("dense_agg", "gather"),
                 "q7": ("dense_agg", "gather"),
                 "q8": ("dense_agg",),
                 "ysb": ("dense_agg", "gather"),
                 "q11": ("dense_agg",), "q11-bench": ("dense_agg",),
                 "q11-generic": ("dense_agg", "gather"),
                 "q0": (), "q1": (), "q2": (), "q10": (), "q2-rows": (),
                 "q2-sliding": (), "q2-stagger": ()}

# the sharded runs (8 generators → 8 shards on the card): the kernels each
# shard launches per lowering of a window on each run's main path,
# predicted from the plan (PERF.md §6, PR 9), as (a clean lowering, a
# fallback lowering).  Clean: the build's slotting (K2), the fused partial
# (K1) and the two-phase aggregates' partial and final (K2 each; an int64
# max takes its final's second K2 by the low words) per shard, the
# broadcast lookup joins' slotting (K2) and gather (K3); q4's final by
# (auction, category) has two keys: sort-based, no kernel.  Fallback (a
# window whose build keys repeat: 8 generators at 4 M events/s repeat
# auction and person ids): the joins' slotting and every single-key
# aggregate's partial and final on K2 as in a clean lowering (q6's final
# by auction: two K2 for the int64 max, its `wmin:` carry scattered on
# their slots); the fan-out and the fused node's unfused partial plain.
# q11's device tier launches one K2 per epoch and shard holding rows (its
# own count)
DIST_SHARDS, DIST_GENERATORS = 8, 8
DIST_LAUNCHES = {
    "q4": ({"join_agg": 1, "dense_agg": 3}, {"dense_agg": 3}),
    "q9": ({"join_agg": 1, "dense_agg": 3, "gather": 1}, {"dense_agg": 4}),
    "q13": ({"dense_agg": 1, "gather": 1}, {}),
    "q6": ({"join_agg": 1, "dense_agg": 5}, {"dense_agg": 5}),
    "q3": ({"dense_agg": 1, "gather": 1}, {"dense_agg": 1}),
    "q0": ({}, {}), "q1": ({}, {}), "q2": ({}, {}), "q10": ({}, {}),
    "ysb": ({"dense_agg": 3, "gather": 1}, {}),
    "q5": ({"dense_agg": 5, "gather": 1}, {}),
    "q7": ({"dense_agg": 3, "gather": 1}, {}),
    "q12": ({"dense_agg": 2}, {})}
# the runs whose every window reruns on the fallback (their build keys
# repeat in the 8-generator stream); the same queries row-sharded over the
# one-generator bench epochs keep their keys unique and stay clean
DIST_ESCAPES = ("q3", "q4", "q6", "q9")
DIST_CLEAN = (4, 9, 6)
for _q, (_clean, _) in DIST_LAUNCHES.items():
    QUERY_KERNELS[f"dist-{_q}"] = tuple(sorted(_clean))
for _q in DIST_CLEAN:
    QUERY_KERNELS[f"dist-rr-q{_q}"] = QUERY_KERNELS[f"dist-q{_q}"]
QUERY_KERNELS.update({"dist-q11": ("dense_agg",),
                      "dist-q11-15s": ("dense_agg",),
                      "multihost-q4": ("join_agg", "dense_agg")})
for _n in (1, 2, 4):
    QUERY_KERNELS[f"dist-q4-n{_n}"] = QUERY_KERNELS["dist-q4"]

# ingestion, recovery and stacked windows.  The ingest path parses and
# re-encodes every row in Python on the host, as the reference does (~10 us
# a row for fragment_lines and EpochAssembler together on the H100
# machine's host, PERF.md §5), so the ingest phase runs 4 s of the
# one-generator stream at 250 k events/s (~1 M events; q3's person and
# auction fragments at 100 k events/s), not the bench rate; recovery and
# stacked run on the bench epochs.
INGEST_EPS, INGEST_Q3_EPS, INGEST_GRANULE = 250_000, 100_000, 1024
# a window's launches per lowering on the single card: q4's build slotting
# and per-category aggregate on K2 around its fused pass on K1; q9's build
# slotting, fused pass and the gather of the winners back to the bids; q3's
# person slotting and gather
WINDOW_LAUNCHES = {"q4": {"join_agg": 1, "dense_agg": 2, "gather": 0},
                   "q9": {"join_agg": 1, "dense_agg": 1, "gather": 1},
                   "q3": {"join_agg": 0, "dense_agg": 1, "gather": 1}}
# and per fallback lowering (a window whose auction ids repeat): the
# build's slotting and the per-category (q4) or per-auction (q9) aggregate
# on K2, q9's gather of the winners on K3; the fan-out and the unfused
# partial plain
WINDOW_FALLBACK_LAUNCHES = {"q4": {"join_agg": 0, "dense_agg": 2,
                                   "gather": 0},
                            "q9": {"join_agg": 0, "dense_agg": 2,
                                   "gather": 1}}
QUERY_KERNELS["ingest-q3"] = ("dense_agg", "gather")


# the SQL runs' kernels: as their hand plans', but SQL q6 is not fused (a
# Rank sits between its join and its aggregate: the join slots on K2 and
# gathers on K3) and SQL q11's text is one aggregate by bidder
QUERY_KERNELS.update({
    "sql-q4": ("join_agg", "dense_agg"),
    "sql-q9": ("join_agg", "dense_agg", "gather"),
    "sql-q13": ("dense_agg", "gather"), "sql-q3": ("dense_agg", "gather"),
    "sql-q5": ("dense_agg", "gather"), "sql-q7": ("dense_agg", "gather"),
    "sql-q8": ("dense_agg",), "sql-q6": ("dense_agg", "gather"),
    "sql-q11": ("dense_agg",), "sql-ysb": ("dense_agg", "gather"),
    "sql-q5-hopping": ("dense_agg", "gather"),
    "sql-q7-tumbling": ("dense_agg", "gather"),
    "sql-q0": (), "sql-q1": (), "sql-q2": (), "sql-q10": (),
    "cli-fsql-q4": ("join_agg", "dense_agg"),
    "cli-nexmark-q4": ("join_agg", "dense_agg")})

# tests/test_sql.py's texts (NEXMARK_SQL, Q6_SQL, YSB_SQL) and q11's
# (test_sql_q11_reference_text), copied: the script imports nothing of
# tests/ but torch_kernel_cases
SQL_TEXTS = {
    0: "SELECT * FROM bid;",
    1: "SELECT auction, bidder, 0.908 * price AS price, b_date_time FROM bid;",
    2: "SELECT auction, price FROM bid WHERE auction % 123 = 0;",
    3: ("SELECT name, city, state, a_id FROM auction INNER JOIN person "
        "ON seller = p_id WHERE category = 10 AND (state = 'or' OR "
        "state = 'id' OR state = 'ca');"),
    4: ("SELECT category, Avg(final) AS avg_final FROM (SELECT Max(price) AS "
        "final, category FROM auction INNER JOIN bid ON a_id = auction WHERE "
        "b_date_time BETWEEN a_date_time AND expires GROUP BY a_id, category"
        ") AS Q GROUP BY category;"),
    5: ("SELECT auction, num FROM (SELECT auction, Count(*) AS num FROM bid "
        "GROUP BY auction) AS AuctionBids INNER JOIN (SELECT Max(num) AS "
        "maxn FROM (SELECT auction, Count(*) AS num FROM bid GROUP BY "
        "auction) AS CountBids) AS MaxBids ON num = maxn;"),
    7: ("SELECT auction, price, bidder, b_date_time FROM bid JOIN (SELECT "
        "Max(price) AS maxprice FROM bid) AS B1 ON price = maxprice;"),
    8: ("SELECT p_id, name FROM (SELECT p_id, name FROM person GROUP BY "
        "p_id, name) AS P JOIN (SELECT seller FROM auction GROUP BY seller)"
        " AS A ON p_id = seller;"),
    9: ("SELECT auction, bidder, price, b_date_time FROM bid JOIN (SELECT "
        "a_id AS id, Max(price) AS final FROM auction INNER JOIN bid ON "
        "a_id = auction WHERE b_date_time BETWEEN a_date_time AND expires "
        "GROUP BY a_id) AS Q ON auction = id AND price = final;"),
    10: "SELECT auction, bidder, price, b_date_time FROM bid;",
    13: ("SELECT auction, bidder, price, b_date_time, value FROM bid JOIN "
         "side_input ON auction = key;"),
    6: ("SELECT seller, Avg(price) AS avg_price FROM (SELECT seller, price, "
        "b_date_time, Row_number() OVER (partition BY seller ORDER BY "
        "b_date_time DESC) AS time_rank FROM (SELECT seller, a_id, price, "
        "b_date_time, Row_number() OVER (partition BY a_id ORDER BY price "
        "DESC) AS price_rank FROM auction INNER JOIN bid ON a_id = auction "
        "WHERE b_date_time BETWEEN a_date_time AND expires ORDER BY a_id, "
        "price DESC) AS Q WHERE price_rank = 1) AS R WHERE time_rank <= 10 "
        "GROUP BY seller;"),
    11: ("SELECT bidder, Count(*) AS bid_count, Min(b_date_time) AS "
         "start_time, Max(b_date_time) AS end_time FROM bid "
         "GROUP BY bidder;"),
}
SQL_YSB = ("SELECT campaign_id, Count(*) AS count FROM ad_event INNER JOIN "
           "campaign ON ad_id = c_ad_id WHERE event_type = 'view' GROUP BY "
           "campaign_id;")

# more aggregates than one kernel launch takes: nine by one int32 key
# (K2 holds eight a launch: two launches), and the BETWEEN chain with nine
# (K1 takes eight: it lowers unfused, the join slotting on K2 and gathering
# on K3, the aggregate's two K2 launches); tests/test_torch_sql.py's texts
MANY_AGGS_SQL = (
    "SELECT auction, Max(price), Min(price), Sum(price), Max(b_date_time), "
    "Min(b_date_time), Max(bidder), Min(bidder), Sum(bidder), "
    "Sum(b_date_time) FROM bid GROUP BY auction")
MANY_AGGS_JOIN_SQL = (
    "SELECT a_id, Max(price), Min(price), Sum(price), Max(bidder), "
    "Min(bidder), Sum(bidder), Max(b_date_time), Min(b_date_time), "
    "Sum(b_date_time) FROM auction INNER JOIN bid ON a_id = auction WHERE "
    "b_date_time BETWEEN a_date_time AND expires GROUP BY a_id")
# their launches a window
MANY_AGGS_LAUNCHES = {
    "sql-many-aggs": {"join_agg": 0, "dense_agg": 2, "gather": 0},
    "sql-many-aggs-join": {"join_agg": 0, "dense_agg": 3, "gather": 1}}
QUERY_KERNELS.update({"sql-many-aggs": ("dense_agg",),
                      "sql-many-aggs-join": ("dense_agg", "gather")})

# the SQL runs' timing depth (compute-only passes, feed-inclusive passes,
# profiled): their rows are held against the hand plans' from the same run,
# which needs no timing
SQL_DEPTH = (1, 1, False)

# every phase_query run's window results and numbers, by label: the SQL
# runs are held against their hand plans' from the same run
RESULTS: dict = {}
RECORDS: dict = {}


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def card() -> str:
    return sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]


def counters() -> dict:
    """Kernel name → its wrapper, which counts its launches."""
    from flock_tpu_torch.ops.dense_agg import dense_agg
    from flock_tpu_torch.ops.gather import gather
    from flock_tpu_torch.ops.join_agg import join_aggregate

    return {"join_agg": join_aggregate, "dense_agg": dense_agg,
            "gather": gather}


@dataclasses.dataclass
class DeviceEvents:
    """One kind of device event (a kernel, copy or fill) over a profiled
    run of a function: its name, how many times it ran, and their device
    time in microseconds."""
    key: str
    count: int
    self_device_time_total: float


def profile(fn, sessions: int = 3) -> list[DeviceEvents] | None:
    """The device-side events (kernels, copies, fills) of one run of
    ``fn``, from torch.profiler.  Once the port's kernel libraries have
    launched, the profiler loses the first device event of every session,
    and at times many more (one session recorded 3 of q7's ~20
    operations).  So every session starts with a spin kernel of its own,
    left out of the result, and ``fn`` runs in ``sessions`` sessions: each
    kind of event counts as often as the most any session recorded it, at
    its mean device time over all recorded ones.  Counts can still fall
    short; ``dispatched_ops`` counts exactly.  A session that records no
    device event at all (now and then one does, and once nine in a row did)
    is not counted, and the next starts a tenth of a second later; up to
    ``5 * sessions`` are run, and if none recorded an event the result is
    None: the device times it would give are then "not measured" (null in
    the JSON lines), and nothing else of the run depends on them.  The
    host-side operator events are left out: their device time repeats that
    of the kernels they launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    most: dict[str, int] = {}
    seen: dict[str, list] = {}    # key → [events recorded, their us]
    recorded = 0
    for attempt in range(5 * sessions):
        if recorded == sessions:
            break
        if attempt > recorded:
            time.sleep(0.1)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        # the device events by name, from the raw trace: key_averages()
        # takes seconds per 10,000 recorded operations (a sharded run makes
        # up to 100,000)
        events = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA \
                    and "spin_kernel" not in e.name():
                acc = events.setdefault(e.name(), [0, 0.0])
                acc[0] += 1
                acc[1] += e.duration_ns() / 1e3
        recorded += bool(events)
        for key, (count, us) in events.items():
            most[key] = max(most.get(key, 0), count)
            acc = seen.setdefault(key, [0, 0.0])
            acc[0] += count
            acc[1] += us
    if not most:
        print(f"profiler: no device event in {5 * sessions} sessions; "
              "not measured", flush=True)
        return None
    return [DeviceEvents(k, n, n * seen[k][1] / seen[k][0])
            for k, n in most.items()]


def dispatched_ops(fn) -> list[str]:
    """The ATen operations ``fn`` dispatches, in order (views and other
    operations that launch nothing included; the port's own kernels, called
    through ctypes, are not ATen operations): an exact record where the
    profiler's device events fall short."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return ops


def profile_summary(events, compute_ms: float) -> dict:
    """A compute-only pass's device busy time, idle share (busy time set
    against the unprofiled compute time), device operations and ten
    costliest event kinds, from ``profile``; null where the profiler
    recorded nothing."""
    if events is None:
        return {"device_busy_ms": None, "idle_share": None,
                "device_ops": None, "top": []}
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)
    return {"device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / compute_ms,
            "device_ops": sum(e.count for e in events),
            "top": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                    for e in top[:10]]}


# cycles of the spin kernel that keeps the device busy while the host
# launches a bracketed kernel (~0.2 ms at the H100's clock, tens of times a
# ctypes launch's host time)
SPIN_CYCLES = 400_000


@contextlib.contextmanager
def bracketed_launches(kernel: str):
    """Inside the block, each launch of ``kernel`` (its library entry
    point, which its wrapper calls through ctypes) is bracketed by two CUDA
    events on the current stream, with a spin kernel queued before the
    first so that the device is busy while the host launches: the interval
    is the kernel alone on the device, without the profiler.  A third
    event before the spin gives the spin's device time, and the host's
    time from queueing the spin to the launch's return is kept: where it
    is shorter than the spin, the kernel was queued before the device
    reached the start event, and the interval holds no wait for the host.
    Yields the list of (pre, start, end, host seconds), one per launch."""
    from flock_tpu_torch.ops import dense_agg, gather, join_agg

    if kernel == "gather":
        owner, attr = gather, "_fn"
        gather._kernel()
    else:
        mod = dense_agg if kernel == "dense_agg" else join_agg
        owner, attr = mod._lib(), f"flock_{kernel}"
    real = getattr(owner, attr)
    launches = []

    def bracketed(*args):
        pre, start, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
        t0 = time.perf_counter()
        pre.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        rc = real(*args)
        host_s = time.perf_counter() - t0
        end.record()
        launches.append((pre, start, end, host_s))
        return rc

    setattr(owner, attr, bracketed)
    try:
        yield launches
    finally:
        setattr(owner, attr, real)


def kernel_alone_ms(fn, kernel: str, reps: int = 15) -> tuple[float, int]:
    """(median device time of ``kernel`` alone over the calls of ``fn``
    whose launch the spin covered, how many of the ``reps`` calls it
    covered), from CUDA events bracketing each launch (see
    ``bracketed_launches``); each call must launch the kernel once, and
    the spin must cover most launches."""
    fn()
    with bracketed_launches(kernel) as launches:
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    if len(launches) != reps:
        raise AssertionError(f"{kernel}: {len(launches)} launches in {reps} "
                             "wrapper calls")
    covered = [start.elapsed_time(end) for pre, start, end, host_s in launches
               if host_s * 1e3 < pre.elapsed_time(start)]
    if 2 * len(covered) <= reps:
        raise AssertionError(f"{kernel}: the spin covered {len(covered)} of "
                             f"{reps} launches")
    return statistics.median(covered), len(covered)


def device_ops_per_call(fn, reps: int = 10) -> float | None:
    """Device operations (kernels, copies, fills) per call of ``fn`` over
    ``reps`` calls, from the profiler; None where it recorded nothing (not
    measured)."""
    fn()
    events = profile(lambda: [fn() for _ in range(reps)])
    if events is None:
        return None
    return sum(e.count for e in events) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def valid_rows_bytes(valid, *tensors) -> int:
    """Bytes of ``tensors`` over the rows ``valid`` keeps: an invalid row's
    values need no read (a staged chunk's padding, a filtered row)."""
    n = int(valid.sum())
    return sum(n * t.element_size() for t in tensors)


def nbytes_once(*tensors) -> int:
    """Bytes of ``tensors`` with a tensor passed twice counted once (q3's
    probe key is also one of its carried columns: the function reads it
    once)."""
    return nbytes(*{(t.data_ptr(), nbytes(t)): t for t in tensors}.values())


# -- phase 1 -------------------------------------------------------------------


def phase_env(card_line: str) -> dict:
    from flock_tpu_torch.ops import _build

    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    nvcc_v = sh(_build.nvcc(), "--version").splitlines()[-1]
    t0 = time.perf_counter()
    logs = _build.build_all(list(KERNELS))
    build_s = time.perf_counter() - t0
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": nvcc_v, "triton": triton_v, "card": card_line,
           "kernel_build_s": build_s}
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    src = torch.empty(2**28, dtype=torch.int32, device="cuda")  # 1 GiB
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=10)
    env["copy_bytes_per_s"] = 2 * nbytes(src) / (ms * 1e-3)  # read + write
    del src, dst
    print("env: " + json.dumps(env), flush=True)
    return env


# -- phase 2 -------------------------------------------------------------------


def _equal(a: dict, b: dict, names) -> float:
    """Exact comparison of integer outputs; returns the max abs error (0)."""
    err = 0
    for k in names:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{k}: {x.dtype}{tuple(x.shape)} vs "
                                 f"{y.dtype}{tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs().max().item() \
            if x.numel() else 0
        err = max(err, d)
        if not torch.equal(x, y):
            raise AssertionError(f"{k} differs (max abs error {d})")
    return float(err)


def _check_k2(keys, valid, cols, aggs, cap):
    from flock_tpu_torch.ops.dense_agg import dense_agg, dense_agg_plain

    o1, v1, f1 = dense_agg(keys, valid, cols, aggs, cap)
    o2, v2, f2 = dense_agg_plain(keys, valid, cols, aggs, cap)
    torch.cuda.synchronize()
    err = _equal(o1, o2, list(o2))
    if not torch.equal(v1, v2) or bool(f1) != bool(f2):
        raise AssertionError("dense_agg: validity or overflow differs")
    return err, bool(f1)


def _check_k1(slots, present, m, probe, pvalid, pred, aggs):
    from flock_tpu_torch.ops.join_agg import join_agg_plain, join_aggregate

    o1, v1, e1 = join_aggregate(slots, present, m, probe, pvalid, "auction",
                                pred, aggs)
    o2, v2 = join_agg_plain(slots, present, m, probe, pvalid, "auction",
                            pred, aggs)
    torch.cuda.synchronize()
    err = _equal(o1, o2, list(o2))
    if not torch.equal(v1, v2) or bool(e1):
        raise AssertionError("join_agg: validity or escape differs")
    return err, int(v1.sum())


def _k3_case(what, slots, present, m, keys, valid, out_rows=None,
             carry=None, main_path=True, mixed=True) -> dict:
    """K3 against its plain version on every output row, and its timing
    case.  A ``mixed`` main-path case must hold hits, misses and present
    keys whose slot is absent (q7's and YSB's joins have no miss and no
    absent slot).  The library yardstick is ``slots[idx]`` of one column;
    the bytes are every distinct input read once (keys, valid, present, the
    slot and carried columns) and every output written once (gathered,
    carried and hit, at the output rows)."""
    from flock_tpu_torch.ops.gather import gather, gather_plain

    o1, h1 = gather(slots, present, m, keys, valid, out_rows, carry)
    o2, h2 = gather_plain(slots, present, m, keys, valid, out_rows, carry)
    torch.cuda.synchronize()
    if list(o1) != list(o2):
        raise AssertionError(f"gather {what}: outputs {list(o1)} vs {list(o2)}")
    err = _equal(o1, o2, list(o2))
    if not torch.equal(h1, h2):
        raise AssertionError(f"gather {what}: hit differs")
    rel = keys.to(torch.int64) - m.to(torch.int64)
    if main_path and mixed:
        in_span = valid & (rel >= 0) & (rel < present.shape[0])
        absent = in_span & ~present[torch.where(in_span, rel, 0)]
        counts = [int(h1.sum()), int((valid & ~in_span).sum()),
                  int(absent.sum())]
        if min(counts) == 0:
            raise AssertionError(f"gather {what}: hits/misses/absent {counts}")
    col0 = next(iter(slots.values()))
    idx = rel.clamp(0, present.shape[0] - 1)
    return dict(
        kernel=lambda: gather(slots, present, m, keys, valid, out_rows, carry),
        plain=lambda: gather_plain(slots, present, m, keys, valid, out_rows,
                                   carry),
        library=lambda: col0[idx],
        library_call="slots[idx] of one column",
        bytes=nbytes_once(keys, valid, present, *slots.values(),
                          *(carry or {}).values()) + nbytes(*o1.values(), h1),
        err=err, main_path=main_path)


def _k1_bytes(slots, present, probe, pvalid, aggs) -> int:
    """K1's build side and probe validity read once, its probe columns over
    the valid rows, and its [span] outputs (count, key, validity and one
    per aggregate: 8 bytes for a sum or an int64 column's max) written
    once."""
    span = present.shape[0]
    outs = sum(8 if fn == "sum" or (c in probe and probe[c].dtype
                                    == torch.int64) else 4
               for c, fn, _ in aggs if fn != "count")
    return nbytes(pvalid, present, *slots.values()) \
        + valid_rows_bytes(pvalid, *probe.values()) + span * (4 + 4 + 1 + outs)


def _k1_i64_cases() -> dict:
    """K1's int64 max (q6's ``__order``) off the main path, on the
    adversarial inputs the CPU and card tests share
    (tests/torch_kernel_cases.py) at the card tests' size: INT64_MIN and
    INT64_MAX, negative values, values that differ only in their low or
    only in their high 32 bits, one slot, keys K1's window misses (global
    64-bit atomics), no valid row.  Each equal to the plain version and to
    numpy; the library yardstick is ``scatter_reduce_`` amax of the int64
    column at the probe slots."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_kernel_cases import (K1_I64_AGGS, K1_I64_CASES, K1_TERMS,
                                    k1_i64_case, k1_i64_numpy)

    from flock_tpu_torch.ops.join_agg import join_agg_plain, join_aggregate
    from flock_tpu_torch.plan import Conj

    dev = torch.device("cuda")
    pred = Conj(K1_TERMS)
    cases = {}
    for name in K1_I64_CASES:
        sl, pr, m0, pb, pv = k1_i64_case(name, span=248_192, n=1_000_000,
                                         seed=len(name))
        omax, cnt = k1_i64_numpy(sl, pr, m0, pb, pv)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        slots, present, probe, pvalid = ({k: t(v) for k, v in sl.items()},
                                         t(pr), {k: t(v) for k, v in
                                                 pb.items()}, t(pv))
        m = torch.tensor(int(m0), dtype=torch.int32, device=dev)
        args = (slots, present, m, probe, pvalid, "k", pred, K1_I64_AGGS)
        o1, v1, e1 = join_aggregate(*args)
        o2, v2 = join_agg_plain(*args)
        torch.cuda.synchronize()
        err = _equal(o1, o2, list(o2))
        if not torch.equal(v1, v2) or bool(e1) \
                or not np.array_equal(o1["omax"].cpu().numpy(), omax) \
                or not np.array_equal(o1["c"].cpu().numpy(), cnt):
            raise AssertionError(f"join_agg int64 {name}: differs")
        span = present.shape[0]
        idx = (probe["k"].to(torch.int64) - int(m0)).clamp(0, span)
        buf = torch.full((span + 1,), -2**63, dtype=torch.int64, device=dev)
        cases[f"join_agg/i64_{name}"] = dict(
            kernel=lambda a=args: join_aggregate(*a),
            plain=lambda a=args: join_agg_plain(*a),
            library=lambda b=buf, i=idx, o=probe["o"]: b.scatter_reduce_(
                0, i, o, "amax"),
            library_call="scatter_reduce_(amax) of the int64 column",
            bytes=_k1_bytes(slots, present, probe, pvalid, K1_I64_AGGS),
            err=err, main_path=False)
    return cases


def _k2_bytes(keys, valid, cols, aggs, cap) -> int:
    """K2's validity read over every row, its keys and columns over the
    valid rows, and its [cap] outputs written once."""
    outs = sum(8 if fn == "sum" else 4 for _, fn, _ in aggs
               if fn not in ("count", "dups"))
    return nbytes(valid) + valid_rows_bytes(valid, keys, *cols.values()) \
        + cap * (4 + 4 + 1 + outs)


def _adversarial_cases(slots, present, m, probe, pvalid, pred, k1_aggs,
                       rng) -> dict:
    """K1 and K2 on shapes off the main path, each against its plain
    version: every key on one slot (every lane of every warp collides), keys
    uniform over the span (K1's window misses almost every pair), keys far
    behind K1's window and before m, a span below the window, n below a
    tile and not a multiple of 4, n = 1, no valid row, columns off a
    16-byte boundary (element loads), and K2 at the largest capacity of its
    lane-private variant and the smallest of its block-shared one past it,
    and at the largest of the block-shared and the smallest of its global
    one."""
    from flock_tpu_torch.ops.dense_agg import (LANES_BYTES, SHARED_BYTES,
                                               dense_agg, dense_agg_plain)
    from flock_tpu_torch.ops.join_agg import join_agg_plain, join_aggregate

    dev = present.device
    span, n = present.shape[0], pvalid.shape[0]
    m0 = int(m)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def unaligned(x):
        return torch.cat([x[:1], x])[1:]

    cases = {}

    def k1(name, sl, pr, pb, pv):
        err, _ = _check_k1(sl, pr, m, pb, pv, pred, k1_aggs)
        sp = pr.shape[0]
        idx = (pb["auction"].to(torch.int64) - m0).clamp(0, sp)
        buf = torch.full((sp + 1,), -2**31, dtype=torch.int32, device=dev)
        cases[f"join_agg/{name}"] = dict(
            kernel=lambda: join_aggregate(sl, pr, m, pb, pv, "auction", pred,
                                          k1_aggs),
            plain=lambda: join_agg_plain(sl, pr, m, pb, pv, "auction", pred,
                                         k1_aggs),
            library=lambda: buf.scatter_reduce_(0, idx, pb["price"], "amax"),
            library_call="scatter_reduce_(amax) of price at the probe slots",
            bytes=_k1_bytes(sl, pr, pb, pv, k1_aggs), err=err,
            main_path=False)

    hot = 1000   # a present slot whose interval holds most bid times
    k1("one_slot", slots, present,
       dict(probe, auction=torch.full_like(probe["auction"], m0 + hot)), pvalid)
    k1("uniform", slots, present,
       dict(probe, auction=t((m0 + rng.integers(-50, span + 50, n))
                             .astype(np.int32))), pvalid)
    r = rng.random(n)
    far = np.where(r < 0.6, probe["auction"].cpu().numpy(),
                   np.where(r < 0.85, m0 + rng.integers(0, span // 8, n),
                            m0 - rng.integers(1, 5000, n)))
    k1("behind_and_before", slots, present,
       dict(probe, auction=t(far.astype(np.int32))), pvalid)
    k1("small_span", {k: v[:100] for k, v in slots.items()}, present[:100],
       dict(probe, auction=t((m0 + rng.integers(-20, 120, n))
                             .astype(np.int32))), pvalid)
    for name, rows in (("n_odd", 1003), ("n_1", 1)):
        k1(name, slots, present, {k: v[:rows] for k, v in probe.items()},
           pvalid[:rows])
    k1("all_invalid", slots, present, probe, torch.zeros_like(pvalid))
    k1("unaligned", slots, present,
       {k: unaligned(v) for k, v in probe.items()}, unaligned(pvalid))

    all_aggs = [(None, "count", "c"), ("v", "count_sum", "cs"),
                ("v", "sum", "s"), ("v", "min", "mn"), ("v", "max", "mx"),
                (None, "dups", "d")]
    nk = 1_000_000
    vals = t(rng.integers(-10**6, 10**6, nk).astype(np.int32))
    kvalid = t(rng.random(nk) < 0.9)

    def k2(name, keys, valid, cols, aggs, cap):
        err, _ = _check_k2(keys, valid, cols, aggs, cap)
        col0 = next(iter(cols.values())).to(torch.int64)
        idx = (keys.to(torch.int64) - int(keys.min())).clamp(0, cap)
        acc = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        cases[f"dense_agg/{name}"] = dict(
            kernel=lambda: dense_agg(keys, valid, cols, aggs, cap),
            plain=lambda: dense_agg_plain(keys, valid, cols, aggs, cap),
            library=lambda: acc.index_add_(0, idx, col0),
            library_call="index_add_ of the first column",
            bytes=_k2_bytes(keys, valid, cols, aggs, cap), err=err,
            main_path=False)

    cat_aggs = [("v", "sum", "s"), (None, "count", "c")]
    ncat = min(248_192, nk)   # the per-category pass's rows
    k2("one_slot", torch.full((ncat,), 12, dtype=torch.int32, device=dev),
       kvalid[:ncat], {"v": vals[:ncat]}, cat_aggs, 128)
    k2("uniform", t(rng.integers(0, 300_000, nk).astype(np.int32)), kvalid,
       {"v": vals}, all_aggs, 300_000)
    # all_aggs take 24 bytes a slot: the lane-private variant's 32 copies
    # fit its budget up to 42 slots, the block-shared one's single copy 48 KB
    # up to 2048
    lanes_cap = LANES_BYTES // (32 * 24)
    for name, cap in (("cap_lanes", lanes_cap),
                      ("cap_lanes_plus1", lanes_cap + 1),
                      ("cap_shared", SHARED_BYTES // 24),
                      ("cap_global", SHARED_BYTES // 24 + 1)):
        k2(name, t(rng.integers(0, cap, nk).astype(np.int32)), kvalid,
           {"v": vals}, all_aggs, cap)
    for name, rows in (("n_odd", 1003), ("n_1", 1)):
        k2(name, t(rng.integers(10, 15, rows).astype(np.int32)),
           kvalid[:rows], {"v": vals[:rows]}, cat_aggs, 128)
    k2("all_invalid", t(rng.integers(0, 300_000, nk).astype(np.int32)),
       torch.zeros_like(kvalid), {"v": vals}, all_aggs, 300_000)
    uk = t(rng.integers(0, 300_000, nk).astype(np.int32))
    k2("unaligned", unaligned(uk), unaligned(kvalid), {"v": unaligned(vals)},
       all_aggs, 300_000)
    return cases


def _k3_adversarial(q9_slots, fvalid, m, keys, pvalid, q3, rng) -> dict:
    """K3 on shapes off the main path, each against its plain version on
    every output row: every key on one slot, every key a miss, keys
    uniform over the span (each gather a random L2 sector), m near
    INT32_MIN with keys near INT32_MAX and m near INT32_MAX with keys near
    INT32_MIN (a 32-bit key - m would wrap into the span), a span of 1,
    n in {1, 3, 4, 5, 1003}, q3's carry case with its probe side one element
    off a 16-byte boundary (the row-by-row and byte paths), one 8-byte
    column, mixed 4/8-byte columns, eight columns (the run-time signature),
    and mixed columns carried from n = 1003 to 1009 rows."""
    dev = keys.device
    span, n = fvalid.shape[0], keys.shape[0]
    m0 = int(m)
    i32_min, i32_max = -(2**31), 2**31 - 1
    q3_slots, p_present, m3, sellers, svalid, q3_carry = q3

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def unaligned(x):
        return torch.cat([x[:1], x])[1:]

    cases = {}

    def k3(name, *args):
        cases[f"gather/{name}"] = _k3_case(name, *args, main_path=False)

    hot = int(torch.nonzero(fvalid)[0])   # a present slot
    k3("one_slot", q9_slots, fvalid, m, torch.full_like(keys, m0 + hot),
       pvalid)
    k3("all_miss", q9_slots, fvalid, m, keys + 2 * span, pvalid)
    k3("uniform", q9_slots, fvalid, m,
       t((m0 + rng.integers(-50, span + 50, n)).astype(np.int32)), pvalid)
    near = (keys.to(torch.int64) - m0).clamp(0, span - 1)
    far = t(rng.random(n) < 0.5)
    j = t(rng.integers(0, span - 100, n))
    k3("far_above", q9_slots, fvalid, scalar(i32_min + 7),
       torch.where(far, i32_max - j, i32_min + 7 + near).to(torch.int32),
       pvalid)
    k3("far_below", q9_slots, fvalid, scalar(i32_max - 99),
       torch.where(far, i32_min + j, i32_max - 99 + near % 100)
       .to(torch.int32), pvalid)
    k3("span_1", {k: v[:1] for k, v in q9_slots.items()},
       torch.ones(1, dtype=torch.bool, device=dev), m,
       t((m0 + rng.integers(-1, 2, n)).astype(np.int32)), pvalid)
    for rows in (1, 3, 4, 5, 1003):
        k3(f"n_{rows}", q9_slots, fvalid, m, keys[:rows], pvalid[:rows])
    k3("unaligned", q3_slots, p_present, m3, unaligned(sellers),
       unaligned(svalid), q3_carry["a_id"].shape[0] * 3 // 2,
       {k: unaligned(v) for k, v in q3_carry.items()})
    i32 = t(rng.integers(i32_min, i32_max, span).astype(np.int32))
    i64 = t(rng.integers(-(2**62), 2**62, span).astype(np.int64))
    mixed = {"a": i32, "ts": i64,
             "f": t(rng.random(span).astype(np.float32)),
             "d": t(rng.random(span))}
    k3("wide", {"ts": i64}, fvalid, m, keys, pvalid)
    k3("mixed", mixed, fvalid, m, keys, pvalid)
    k3("eight_cols", {f"c{i}": i64 + i if i % 3 == 0 else i32 ^ i
                      for i in range(8)}, fvalid, m, keys, pvalid)
    k3("carry_ragged", mixed, fvalid, m, keys[:1003], pvalid[:1003], 1009,
       {k: v[:1003] for k, v in q3_carry.items()})
    return cases


def _live_slots(keys, valid, cols):
    """The library calls' inputs: K2's slot of every valid row as int64
    (key - the least valid key) and the aggregated columns over those rows.
    The invalid rows are left out before timing, so no library call spends
    its time on rows the kernel skips (nor on one spill slot they would all
    hit)."""
    live = valid.nonzero().squeeze(1)
    k = keys[live].to(torch.int64)
    idx = k - k.min() if k.numel() else k
    return idx, {c: v[live] for c, v in cols.items()}


def _windowed_cases(inputs: dict) -> dict:
    """K2 and K3 on the tensors the windowed queries' main paths gave them
    (each the first such call of the run, from ``kernel_inputs``), each
    exact against its plain version: q7's max price over its one key and
    the gather of that max back to every bid; q5's count per auction onto
    the window's aggregate capacity; YSB's count per campaign and the
    gather of ``campaign_id`` from the campaign slots to every view."""
    from flock_tpu_torch.ops.dense_agg import dense_agg, dense_agg_plain

    cases = {}

    def k2(name, library, library_call):
        (keys, valid, cols, aggs, cap), _ = inputs[f"dense_agg/{name}"]
        cols = {c: cols[c] for c, _, _ in aggs if c is not None}
        err, ovf = _check_k2(keys, valid, cols, aggs, cap)
        if ovf:
            raise AssertionError(f"dense_agg {name}: overflowed")
        idx, live_cols = _live_slots(keys, valid, cols)
        cases[f"dense_agg/{name}"] = dict(
            kernel=lambda: dense_agg(keys, valid, cols, aggs, cap),
            plain=lambda: dense_agg_plain(keys, valid, cols, aggs, cap),
            library=library(idx, live_cols, cap), library_call=library_call,
            shape=(
                f"{keys.numel()} rows ({int(valid.sum())} valid) -> "
                f"{cap} slots"),
            bytes=_k2_bytes(keys, valid, cols, aggs, cap), err=err)

    def k3(name):
        args, kw = inputs[f"gather/{name}"]
        slots, present, _, keys, valid = args
        cases[f"gather/{name}"] = dict(
            _k3_case(name, *args, **kw, mixed=False), shape=(
                f"{keys.numel()} probes ({int(valid.sum())} valid), "
                f"{int(present.sum())} of {present.numel()} slots present"))

    def count(idx, cols, cap):
        return lambda: torch.bincount(idx, minlength=cap)

    def amax_of(col):
        def library(idx, cols, cap):
            buf = torch.full((cap,), -2**31, dtype=torch.int32,
                             device=idx.device)
            return lambda: buf.scatter_reduce_(0, idx, cols[col], "amax")
        return library

    def k3_sessions(name):
        # the session tables hold a slot for every key of the span, so no
        # probe meets an absent slot
        args, kw = inputs[f"gather/{name}"]
        slots, present, _, keys, valid = args
        cases[f"gather/{name}"] = dict(
            _k3_case(name, *args, **kw, mixed=False), shape=(
                f"{keys.numel()} rows ({int(valid.sum())} valid), "
                f"{present.numel()} label slots, {len(slots)} tables"))

    k2("q7_one_key", amax_of("price"), "scatter_reduce_(amax) of price")
    k3("q7")
    k2("q5_count", count, "bincount of key - m")
    k2("ysb_count", count, "bincount of key - m")
    k3("ysb")
    k2("q12_chunk_count", count, "bincount of key - m")
    k2("q11_epoch", amax_of("b_date_time"),
       "scatter_reduce_(amax) of b_date_time")
    k2("q11_generic", amax_of("b_date_time"),
       "scatter_reduce_(amax) of b_date_time")
    k3_sessions("q11_generic")
    cases["join_agg/q6"] = _q6_k1_case(*inputs["join_agg/q6"][0])
    return cases


def _order_cost(probe: dict) -> None:
    """Prints the cost of q6's probe-side ``__order`` on the bids of its
    first window: the query's own expression, timed whole with CUDA events,
    beside its byte bound (``price`` and ``b_date_time`` read, 8 bytes
    written a bid).  It must equal the column the fused pass handed K1."""
    from flock_tpu_torch.plan import Project, walk
    from flock_tpu_torch.queries.nexmark import get_query

    expr = next(dict(n.exprs)["__order"] for n in walk(get_query(6).plan)
                if isinstance(n, Project) and "__order" in dict(n.exprs))
    if not torch.equal(expr(probe), probe["__order"]):
        raise AssertionError("q6 __order differs from K1's input")
    size = nbytes(probe["price"], probe["b_date_time"], probe["__order"])
    print("q6 __order: " + json.dumps({
        "rows": probe["price"].numel(), "ms": cuda_ms(lambda: expr(probe)),
        "bytes": size, "bound_ms": size / PEAK_BYTES_S * 1e3}), flush=True)


def _q6_k1_case(slots, present, m, probe, pvalid, key, pred, aggs) -> dict:
    """K1 on the tensors q6's first window gave it: the interval predicate,
    the int64 max of ``__order`` (made on the probe side) and the seller
    carry.  Exact against its plain version; the library yardstick is
    ``scatter_reduce_`` amax of ``__order`` at the probe slots; the bytes
    are the columns the kernel reads (key, validity, ``b_date_time``,
    ``__order``, the slot columns, ``present``) once and its outputs
    once."""
    from flock_tpu_torch.ops.join_agg import join_agg_plain, join_aggregate

    o1, v1, e1 = join_aggregate(slots, present, m, probe, pvalid, key, pred,
                                aggs)
    o2, v2 = join_agg_plain(slots, present, m, probe, pvalid, key, pred, aggs)
    torch.cuda.synchronize()
    err = _equal(o1, o2, list(o2))
    if not torch.equal(v1, v2) or bool(e1) or not bool(v1.any()):
        raise AssertionError("join_agg q6: validity or escape differs, or "
                             "no slot won")
    if o1["__order"].dtype != torch.int64:
        raise AssertionError("join_agg q6: __order is not an int64 max")
    _order_cost(probe)
    span = present.shape[0]
    idx = (probe[key].to(torch.int64) - m.to(torch.int64)).clamp(0, span)
    buf = torch.full((span + 1,), -2**63, dtype=torch.int64,
                     device=present.device)
    read = {c: probe[c] for c in {key, "__order", *(t for lhs, _, rhs in
                                                    pred.terms
                                                    for t in (lhs, rhs))}
            if c in probe and c not in slots}
    return dict(
        kernel=lambda: join_aggregate(slots, present, m, probe, pvalid, key,
                                      pred, aggs),
        plain=lambda: join_agg_plain(slots, present, m, probe, pvalid, key,
                                     pred, aggs),
        library=lambda: buf.scatter_reduce_(0, idx, probe["__order"], "amax"),
        library_call="scatter_reduce_(amax) of __order at the probe slots",
        shape=(f"{pvalid.numel()} bids ({int(pvalid.sum())} valid), "
               f"{int(present.sum())} of {span} auction slots present, "
               f"{int(v1.sum())} won"),
        bytes=_k1_bytes(slots, present, read, pvalid, aggs), err=err)


def _agg_names(args) -> list:
    return [name for _, _, name in args[3]]


# the main-path kernel calls each windowed query's kernel cases take their
# inputs from: case → (wrapper, test of the call's positional arguments)
WINDOWED_PICKS = {
    "q5": {"dense_agg/q5_count": ("dense_agg",
                                  lambda a: _agg_names(a) == ["num"])},
    "q7": {"dense_agg/q7_one_key": ("dense_agg",
                                    lambda a: "maxprice" in _agg_names(a)),
           "gather/q7": ("gather", lambda a: list(a[0]) == ["maxprice"])},
    "ysb": {"dense_agg/ysb_count": ("dense_agg",
                                    lambda a: _agg_names(a) == ["count"]),
            "gather/ysb": ("gather", lambda a: list(a[0]) == ["campaign_id"])},
    # q6's fused pass in its first window: K1 with the int64 max of __order
    # and the seller carry; q12's first chunk count
    "q6": {"join_agg/q6": ("join_aggregate", lambda a: "__order" in a[3])},
    "q12": {"dense_agg/q12_chunk_count": (
        "dense_agg", lambda a: _agg_names(a) == ["__fast_cnt"])},
    # q11's device tier: the first per-epoch count + min/max of b_date_time;
    # its generic tier's first emission: the label gather (three tables)
    # and the plan's aggregate by __session
    "q11": {"dense_agg/q11_epoch": (
        "dense_agg", lambda a: _agg_names(a) == ["__cnt0", "__emn", "__emx"])},
    "q11-generic": {
        "dense_agg/q11_generic": (
            "dense_agg", lambda a: _agg_names(a) == [
                "bidder", "bid_count", "start_time", "end_time"]),
        "gather/q11_generic": (
            "gather", lambda a: sorted(a[0]) == ["__end", "__ok", "__rank"])},
}


def phase_kernels(env: dict) -> list[dict]:
    """Each kernel against its plain version at one bench window's shapes
    (4 M events/s: ~240 k auctions, ~3.68 M bids; q3 at 16 M events/s:
    ~320 k persons, ~960 k auctions), inputs from a seed."""
    from flock_tpu_torch.ops.dense_agg import dense_agg, dense_agg_plain
    from flock_tpu_torch.ops.join_agg import join_agg_plain, join_aggregate
    from flock_tpu_torch.plan import Conj, dup_expand_capacity

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    na, n = 240_000, 3_680_000
    span = na + 8_192
    m0 = 1_000

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # build side, slot-dense: ascending unique ids, window-relative ms times
    a_ts = (np.arange(na) * 1000 // na).astype(np.int32)
    a_exp = (a_ts + rng.integers(1, 20_000, na)).astype(np.int32)
    a_cat = rng.integers(10, 15, na).astype(np.int32)
    # probe side: the auction frontier advances with the bids; half the bids
    # go to the hot auction of their 100-id group (hot_auction_ratio), the
    # rest just behind the frontier; 1% point to the previous window
    f = np.arange(n, dtype=np.int64) * na // n
    rel = np.where(rng.random(n) < 0.5, f // 100 * 100,
                   f - rng.integers(0, 100, n) + rng.integers(0, 10, n))
    rel = np.where(rng.random(n) < 0.01, -rng.integers(1, 5000, n), rel)
    probe = {"auction": t((m0 + rel).astype(np.int32)),
             "price": t(rng.integers(100, 10**8, n).astype(np.int32)),
             "b_date_time": t((np.arange(n) * 1000 // n).astype(np.int32))}
    pvalid = t(np.arange(n) < n - 1_000)

    # K2 slotting (build side of the fused pass): max of the taken columns
    # plus a duplicate count per a_id, span = rows + join_span_margin
    keys = t((m0 + np.arange(na)).astype(np.int32))
    bvalid = t(np.ones(na, bool))
    bcols = {"a_date_time": t(a_ts), "expires": t(a_exp), "category": t(a_cat)}
    slot_aggs = [(c, "max", c) for c in bcols] + [(None, "count", "__dupcnt")]
    err_slot, _ = _check_k2(keys, bvalid, bcols, slot_aggs, span)
    slots, present, _ = dense_agg(keys, bvalid, bcols, slot_aggs, span)
    m = slots["__key"][0]
    slots = {k: slots[k] for k in bcols}

    # K1: q4's fused pass (interval predicate, max(price), category carry)
    pred = Conj((("b_date_time", ">=", "a_date_time"),
                 ("b_date_time", "<=", "expires")))
    k1_aggs = [("price", "max", "final"), ("category", "max", "category")]
    err_k1, hits = _check_k1(slots, present, m, probe, pvalid, pred, k1_aggs)
    if hits == 0:
        raise AssertionError("join_agg: the bench-shape case has no hits")
    # every aggregate kind, and a window with no hits at all
    all_aggs = [("price", "sum", "s"), ("price", "min", "mn"),
                ("b_date_time", "count_sum", "cs"), (None, "count", "c"),
                ("category", "max", "cat")]
    err_k1 = max(err_k1, _check_k1(slots, present, m, probe, pvalid, pred,
                                   all_aggs)[0])
    far = dict(probe, auction=probe["auction"] + 2 * span)
    e, nohit = _check_k1(slots, present, m, far, pvalid, pred, k1_aggs)
    if nohit:
        raise AssertionError("join_agg: the no-hit case found hits")
    err_k1 = max(err_k1, e)

    # K2 per-category: the fused pass's [span] output onto 128 slots
    fused, fvalid, _ = join_aggregate(slots, present, m, probe, pvalid,
                                      "auction", pred, k1_aggs)
    cat_aggs = [("final", "sum", "sum_final"), (None, "count", "cnt")]
    cat_cols = {"final": fused["final"]}
    err_cat, ovf = _check_k2(fused["category"], fvalid, cat_cols, cat_aggs, 128)
    if ovf:
        raise AssertionError("dense_agg: per-category case overflowed")
    # every aggregate kind on both kernel variants, and an overflow case
    vals = t(rng.integers(-10**6, 10**6, span).astype(np.int32))
    for cap in (128, 300_000):
        k = t((rng.integers(0, min(cap, 100_000), span) + 7).astype(np.int32))
        aggs = [(None, "count", "c"), ("v", "count_sum", "cs"),
                ("v", "sum", "s"), ("v", "min", "mn"), ("v", "max", "mx")]
        err_cat = max(err_cat, _check_k2(k, fvalid, {"v": vals}, aggs, cap)[0])
    over = fused["category"].clone()
    over[7] = 10 + 200
    fv = fvalid.clone()
    fv[7] = True
    if not _check_k2(over, fv, cat_cols, cat_aggs, 128)[1]:
        raise AssertionError("dense_agg: the overflow case did not overflow")

    # K2 with (count, max): pallas_count_max_agg's microbench shape
    # (bench/kernels_bench.py:164-176, 280-283: 4 Mi rows on an advancing
    # frontier, 256 Ki slots, m = 0)
    nb6, span6 = 4 * 1024 * 1024, 256 * 1024
    fr6 = np.arange(nb6, dtype=np.int64) * (span6 - 4096) // nb6
    keys6 = t((fr6 + rng.integers(-120, 10, nb6)).clip(0).astype(np.int32))
    valid6 = t(np.ones(nb6, bool))
    cols6 = {"v": t(rng.integers(100, 10**8, nb6).astype(np.int32))}
    aggs6 = [(None, "count", "cnt"), ("v", "max", "mx")]
    err_b6, _ = _check_k2(keys6, valid6, cols6, aggs6, span6)

    # K3: q9's second join — the fused pass's slots (final per auction)
    # gathered to every bid — then q13's side-input join (10,000 keys from
    # 1000, 18,304 slots, most bids miss) and q3's person join (~328 k
    # person slots, half absent after the state filter, ~960 k auctions) as
    # its clean duplicate-faithful pass: three person columns gathered and
    # the seven auction columns carried to dup_expand_capacity rows
    k3 = {}
    q9_slots = {"final": fused["final"]}
    k3["gather/q9"] = _k3_case("q9", q9_slots, fvalid, m, probe["auction"],
                               pvalid)
    si_span = 10_112 + 8_192
    si_present = t(np.arange(si_span) < 10_000)
    q13_slots = {"value": t((m0 + np.arange(si_span)).astype(np.int32))}
    m13 = torch.tensor(m0, dtype=torch.int32, device=dev)
    k3["gather/q13"] = _k3_case("q13", q13_slots, si_present, m13,
                                probe["auction"], pvalid)
    np_, na3 = 320_000, 960_000
    p_span = np_ + 8_192
    p_present = t(rng.random(p_span) < 0.5)
    q3_slots = {"name": t(rng.integers(0, 100, p_span).astype(np.int32)),
                "city": t(rng.integers(0, 10, p_span).astype(np.int32)),
                "state": t(rng.integers(0, 6, p_span).astype(np.int32))}
    m3 = torch.tensor(m0, dtype=torch.int32, device=dev)
    sellers = t((m0 + rng.integers(-2_000, p_span + 2_000, na3)).astype(np.int32))
    svalid = t(rng.random(na3) < 0.2)   # category = 10 keeps ~1 in 5
    a_ts = np.sort(rng.integers(0, 1000, na3)).astype(np.int32)
    q3_carry = {"a_id": t((m0 + np.arange(na3)).astype(np.int32)),
                "initial_bid": t(rng.integers(1, 10**6, na3).astype(np.int32)),
                "reserve": t(rng.integers(1, 10**7, na3).astype(np.int32)),
                "a_date_time": t(a_ts),
                "expires": t(a_ts + rng.integers(1, 20_000, na3).astype(np.int32)),
                "seller": sellers,
                "category": t(np.where(rng.random(na3) < 0.2, 10, 11)
                              .astype(np.int32))}
    k3["gather/q3"] = _k3_case("q3", q3_slots, p_present, m3, sellers, svalid,
                               dup_expand_capacity(na3), q3_carry)
    k3.update(_k3_adversarial(q9_slots, fvalid, m, probe["auction"], pvalid,
                              (q3_slots, p_present, m3, sellers, svalid,
                               q3_carry), rng))

    # timings at the main path's shapes
    rel_idx = (probe["auction"].to(torch.int64) - m0).clamp(0, span)
    buf = torch.full((span + 1,), -2**31, dtype=torch.int32, device=dev)
    cat_idx = (fused["category"].to(torch.int64) - 10).clamp(0, 127)
    cat_buf = torch.zeros(128, dtype=torch.int64, device=dev)
    final64 = fused["final"].to(torch.int64)
    buf6 = torch.full((span6,), -2**31, dtype=torch.int32, device=dev)
    keys6_64 = keys6.to(torch.int64)
    cases = {
        "join_agg": dict(
            kernel=lambda: join_aggregate(slots, present, m, probe, pvalid,
                                          "auction", pred, k1_aggs),
            plain=lambda: join_agg_plain(slots, present, m, probe, pvalid,
                                         "auction", pred, k1_aggs),
            library=lambda: buf.scatter_reduce_(0, rel_idx, probe["price"],
                                                "amax"),
            library_call="scatter_reduce_(amax) of price at the probe slots",
            bytes=nbytes(pvalid, present, *slots.values())
            + valid_rows_bytes(pvalid, *probe.values())
            + nbytes(fused["final"], fused["category"], fvalid) + 4 * span,
            err=err_k1),
        "dense_agg/slotting": dict(
            kernel=lambda: dense_agg(keys, bvalid, bcols, slot_aggs, span),
            plain=lambda: dense_agg_plain(keys, bvalid, bcols, slot_aggs, span),
            library=lambda: buf.scatter_reduce_(
                0, keys.to(torch.int64) - m0, bcols["expires"], "amax"),
            library_call="scatter_reduce_(amax) of one slot column",
            bytes=nbytes(bvalid) + valid_rows_bytes(bvalid, keys,
                                                    *bcols.values())
            + 16 * span,
            err=err_slot),
        "dense_agg/per_category": dict(
            kernel=lambda: dense_agg(fused["category"], fvalid, cat_cols,
                                     cat_aggs, 128),
            plain=lambda: dense_agg_plain(fused["category"], fvalid, cat_cols,
                                          cat_aggs, 128),
            library=lambda: cat_buf.index_add_(0, cat_idx, final64),
            library_call="index_add_ of the sum column",
            bytes=nbytes(fvalid) + valid_rows_bytes(
                fvalid, fused["category"], fused["final"]) + 12 * 128,
            err=err_cat),
        # B6's shape: no path of the port runs it, so it stays out of the
        # kernel's summed times
        "dense_agg/count_max_b6": dict(
            kernel=lambda: dense_agg(keys6, valid6, cols6, aggs6, span6),
            plain=lambda: dense_agg_plain(keys6, valid6, cols6, aggs6, span6),
            library=lambda: buf6.scatter_reduce_(0, keys6_64, cols6["v"],
                                                 "amax"),
            library_call="scatter_reduce_(amax) of the max column",
            bytes=nbytes(valid6) + valid_rows_bytes(valid6, keys6,
                                                    *cols6.values())
            + 8 * span6,
            err=err_b6, main_path=False,
            replaces="flock_tpu/pallas/agg.py:97"),
    }
    cases.update(k3)
    cases.update(_adversarial_cases(slots, present, m, probe, pvalid, pred,
                                    k1_aggs, rng))
    return time_cases(env, cases)


def time_cases(env: dict, cases: dict) -> list[dict]:
    """Times each case and prints its ``kernel case`` line."""
    out = []
    for name, c in cases.items():
        # ms / plain_ms / library_ms: CUDA-event medians of the wrapper, of
        # the plain version and of the library call, each the whole call;
        # kernel_device_ms: the median of the kernel alone between CUDA
        # events bracketing the launches a spin covered (kernel_alone_ms;
        # covered_launches of 15), host_ms: the whole call less the kernel
        # alone; device_ops_per_call: the profiler's device events
        # (kernels, copies, fills) per wrapper call, null where it recorded
        # nothing; bound_ms: the bytes over the data sheet's rate,
        # bound_copy_ms: over this run's measured copy rate
        kernel = name.split("/")[0]
        ops = device_ops_per_call(c["kernel"])
        dev_ms, covered = kernel_alone_ms(c["kernel"], kernel)
        ms = cuda_ms(c["kernel"])
        rec = {"case": name, "kernel": kernel, "ms": ms,
               "host_ms": ms - dev_ms,
               "plain_ms": cuda_ms(c["plain"]),
               "library_ms": cuda_ms(c["library"]),
               "kernel_device_ms": dev_ms, "covered_launches": covered,
               "device_ops_per_call": ops,
               "library_call": c["library_call"],
               "bytes": c["bytes"],
               "bound_ms": c["bytes"] / PEAK_BYTES_S * 1e3,
               "bound_copy_ms": c["bytes"] / env["copy_bytes_per_s"] * 1e3,
               "max_abs_err": c["err"], "exact": c["err"] == 0,
               "main_path": c.get("main_path", True),
               **({"shape": c["shape"]} if "shape" in c else {}),
               "replaces": c.get("replaces", KERNELS[kernel][1]),
               "source": KERNELS[kernel][0]}
        print("kernel case: " + json.dumps(rec), flush=True)
        out.append(rec)
    return out


# -- phases 3 and 4 -----------------------------------------------------------


def _pairs(build_keys: np.ndarray, probe_keys: np.ndarray):
    """(probe row, build row) index pairs of the equi-join, every duplicate
    build row included."""
    bk, pk = build_keys.astype(np.int64), probe_keys.astype(np.int64)
    order = np.argsort(bk, kind="stable")
    lo = np.searchsorted(bk[order], pk, "left")
    cnt = np.searchsorted(bk[order], pk, "right") - lo
    pi = np.repeat(np.arange(len(pk)), cnt)
    start = np.repeat(np.cumsum(cnt) - cnt, cnt)
    return pi, order[np.repeat(lo, cnt) + np.arange(len(pi)) - start]


def _winning_pairs(auction: dict, bid: dict):
    """(bid row, auction row) pairs with the bid inside the auction's
    [a_date_time, expires] interval."""
    bi, ai = _pairs(auction["a_id"], bid["auction"])
    t = bid["b_date_time"][bi]
    ok = (auction["a_date_time"][ai] <= t) & (t <= auction["expires"][ai])
    return bi[ok], ai[ok]


def _last_of_groups(*keys) -> tuple[np.ndarray, np.ndarray]:
    """(order, last): the lexsort order of ``keys`` (the last key most
    significant) and a mask of the last row of each group of the
    significant keys after the first."""
    order = np.lexsort(keys)
    groups = [k[order] for k in keys[1:]]
    last = np.ones(len(order), bool)
    if len(order):
        last[:-1] = np.logical_or.reduce([g[1:] != g[:-1] for g in groups])
    return order, last


def numpy_q4(t: dict) -> dict:
    """Independent q4: join every bid to every auction row with its id
    (duplicates included), keep the bids inside [a_date_time, expires],
    max price per (a_id, category), then sum and count per category."""
    auction, bid = t["auction"], t["bid"]
    bi, ai = _winning_pairs(auction, bid)
    gid = auction["a_id"][ai].astype(np.int64)
    gcat = auction["category"][ai].astype(np.int64)
    price = bid["price"][bi].astype(np.int64)
    o, last = _last_of_groups(price, gcat, gid)
    cats, inv = np.unique(gcat[o][last], return_inverse=True)
    sums = np.zeros(len(cats), np.int64)
    np.add.at(sums, inv, price[o][last])
    counts = np.bincount(inv, minlength=len(cats)).astype(np.int64)
    return {"category": cats, "sum_final": sums, "cnt": counts,
            "avg_final": sums.astype(np.float64) / counts}


def numpy_q9(t: dict) -> dict:
    """Independent q9: the max price over the bids inside any interval of
    an auction row with that id, then every bid at its auction's max."""
    auction, bid = t["auction"], t["bid"]
    bi, _ = _winning_pairs(auction, bid)
    auc = bid["auction"][bi].astype(np.int64)
    price = bid["price"][bi].astype(np.int64)
    o, last = _last_of_groups(price, auc)
    ids, best = auc[o][last], price[o][last]
    pos = np.searchsorted(ids, bid["auction"].astype(np.int64))
    posc = np.minimum(pos, max(len(ids) - 1, 0))
    keep = (pos < len(ids)) & (ids[posc] == bid["auction"]) \
        & (best[posc] == bid["price"]) if len(ids) else np.zeros(
            len(pos), bool)
    return {k: bid[k][keep] for k in ("auction", "bidder", "price",
                                      "b_date_time")}


def numpy_q6(t: dict) -> dict:
    """Independent q6: each auction id's winning joined row (every auction
    row with the id, duplicates included) by (price desc, b_date_time asc,
    seller asc), then each seller's last 10 winners by (b_date_time desc,
    auction asc), their prices summed and counted, the average in f64."""
    auction, bid = t["auction"], t["bid"]
    bi, ai = _winning_pairs(auction, bid)
    auc = bid["auction"][bi].astype(np.int64)
    price = bid["price"][bi].astype(np.int64)
    ts = bid["b_date_time"][bi].astype(np.int64)
    seller = auction["seller"][ai].astype(np.int64)
    order = np.lexsort((seller, ts, -price, auc))
    first = np.ones(len(order), bool)
    first[1:] = auc[order][1:] != auc[order][:-1]
    win = order[first]
    wa, ws, wp, wt = auc[win], seller[win], price[win], ts[win]
    by_seller = np.lexsort((wa, -wt, ws))
    s_sorted = ws[by_seller]
    starts = np.ones(len(by_seller), bool)
    starts[1:] = s_sorted[1:] != s_sorted[:-1]
    pos = np.arange(len(by_seller))
    rank = pos - np.maximum.accumulate(np.where(starts, pos, 0)) + 1
    keep = rank <= 10
    sellers, inv = np.unique(s_sorted[keep], return_inverse=True)
    sums = np.zeros(len(sellers), np.int64)
    np.add.at(sums, inv, wp[by_seller][keep])
    counts = np.bincount(inv, minlength=len(sellers)).astype(np.int64)
    return {"seller": sellers, "sum_price": sums, "cnt": counts,
            "avg_price": sums.astype(np.float64) / counts}


def numpy_q12(t: dict) -> dict:
    """Independent q12: per bidder, the bids and the least and greatest
    ``p_time`` (arrival epoch × 1000) of one processing-time window; the
    window's rows are in arrival order, so a stable sort by bidder leaves
    each bidder's first and last arrival at its group's ends."""
    bid = t["bid"]
    order = np.argsort(bid["bidder"], kind="stable")
    b, p = bid["bidder"][order], bid["p_time"][order]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    last = np.append(first[1:], True)
    idx = np.flatnonzero(first)
    return {"bidder": b[first], "bid_count": np.diff(np.append(idx, len(b))),
            "start_time": p[first], "end_time": p[last]}


def numpy_q11(epochs: list, gap: int, in_order: bool = True) -> dict:
    """Independent q11 over the whole stream: the bids, which arrive in
    time order, sorted stably by bidder, so each bidder's bids stay in
    time order; a session starts at a bidder's first bid and wherever the
    second-truncated time jumps by more than ``gap``; per session the bids,
    the first and the last time.  ``in_order=False`` (epochs merged from
    several generators, each in time order) sorts by bidder and time
    first."""
    b = np.concatenate([e["bid"]["bidder"] for e in epochs])
    t = np.concatenate([e["bid"]["b_date_time"] for e in epochs])
    if not in_order:
        # several generators' epochs, each in time order: by bidder, then
        # time
        order = np.lexsort((t, b))
        b, t = b[order], t[order]
    elif np.any(np.diff(t) < 0):
        raise AssertionError("numpy_q11: the stream is not in time order")
    order = np.argsort(b, kind="stable")
    b, t = b[order], t[order]
    sec = t // 1000
    start = np.ones(len(b), bool)
    start[1:] = (b[1:] != b[:-1]) | (sec[1:] - sec[:-1] > gap)
    idx = np.flatnonzero(start)
    end = np.append(idx[1:], len(b))
    return {"bidder": b[idx], "bid_count": end - idx, "start_time": t[idx],
            "end_time": t[end - 1]}


def numpy_q13(t: dict, side_input: dict) -> dict:
    """Independent q13: every bid whose auction id is a side-input key,
    with that key's value (the keys are unique)."""
    bid = t["bid"]
    order = np.argsort(side_input["key"], kind="stable")
    sk, sv = side_input["key"][order], side_input["value"][order]
    pos = np.searchsorted(sk, bid["auction"])
    posc = np.minimum(pos, len(sk) - 1)
    keep = (pos < len(sk)) & (sk[posc] == bid["auction"])
    out = {k: bid[k][keep] for k in ("auction", "bidder", "price",
                                     "b_date_time")}
    out["value"] = sv[posc][keep]
    return out


def numpy_q3(t: dict) -> dict:
    """Independent q3: persons in or/id/ca joined, duplicates included, to
    the auctions of category 10 they sell."""
    from flock_tpu_torch.datagen.nexmark import US_STATES

    person, auction = t["person"], t["auction"]
    pm = np.isin(person["state"], [US_STATES.index(s) for s in ("or", "id",
                                                                 "ca")])
    am = auction["category"] == 10
    p = {k: v[pm] for k, v in person.items()}
    a = {k: v[am] for k, v in auction.items()}
    ai, pj = _pairs(p["p_id"], a["seller"])
    return {"name": p["name"][pj], "city": p["city"][pj],
            "state": p["state"][pj], "a_id": a["a_id"][ai]}


def numpy_q0(t: dict) -> dict:
    """Independent q0 and q10: every bid."""
    return {k: t["bid"][k] for k in ("auction", "bidder", "price",
                                     "b_date_time")}


def numpy_q1(t: dict) -> dict:
    """Independent q1: every bid, its price times 0.908 in f64."""
    return dict(numpy_q0(t), price=0.908 * t["bid"]["price"].astype(np.float64))


def numpy_q2(t: dict) -> dict:
    """Independent q2: auction and price of the bids on every 123rd
    auction."""
    bid = t["bid"]
    keep = bid["auction"] % 123 == 0
    return {"auction": bid["auction"][keep], "price": bid["price"][keep]}


def numpy_q5(t: dict) -> dict:
    """Independent q5: the auctions with the most bids in the window."""
    ids, counts = np.unique(t["bid"]["auction"], return_counts=True)
    keep = counts == counts.max() if len(counts) else counts > 0
    return {"auction": ids[keep], "num": counts[keep]}


def numpy_q7(t: dict) -> dict:
    """Independent q7: the bids at the window's highest price."""
    bid = t["bid"]
    keep = bid["price"] == bid["price"].max() if len(bid["price"]) else \
        np.zeros(0, bool)
    return {k: bid[k][keep] for k in ("auction", "price", "bidder",
                                      "b_date_time")}


def numpy_q8(t: dict) -> dict:
    """Independent q8: each person (the greatest name among rows with its
    id) who sells an auction in the window."""
    person = t["person"]
    order, last = _last_of_groups(person["name"], person["p_id"])
    ids, names = person["p_id"][order][last], person["name"][order][last]
    keep = np.isin(ids, np.unique(t["auction"]["seller"]))
    return {"p_id": ids[keep], "name": names[keep]}


def numpy_ysb(t: dict) -> dict:
    """Independent YSB: views counted per campaign (ad // 10)."""
    ev = t["ad_event"]
    ids, counts = np.unique(ev["ad_id"][ev["event_type"] == 0] // 10,
                            return_counts=True)
    return {"campaign_id": ids, "count": counts}


def numpy_query(q: int, tables: dict) -> dict:
    from flock_tpu_torch.runtime.tables import default_side_input

    if q == 13:
        return numpy_q13(tables, default_side_input())
    return {0: numpy_q0, 1: numpy_q1, 2: numpy_q2, 3: numpy_q3, 4: numpy_q4,
            5: numpy_q5, 6: numpy_q6, 7: numpy_q7, 8: numpy_q8, 9: numpy_q9,
            10: numpy_q0, 12: numpy_q12}[q](tables)


def _same_rows(got: dict, want: dict, names, what: str) -> None:
    """The same columns, row for row."""
    for k in names:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{what}: column {k} differs:\n{g}\n{w}")


def _same_row_set(got: dict, want: dict, names, what: str) -> None:
    """The same rows in any order (SQL sets no order).  Rows that already
    agree in the order given need no sort."""
    if all(np.asarray(got[n]).shape == np.asarray(want[n]).shape
           and np.array_equal(got[n], want[n]) for n in names):
        return

    def rows(cols):
        arrays = [np.asarray(cols[n]) for n in names]
        order = np.lexsort(arrays[::-1])
        return {n: a[order] for n, a in zip(names, arrays)}

    _same_rows(rows(got), rows(want), names, what)


def _host(ex, batch) -> dict:
    """Every device column on the host, with the sink's columns over them
    (absolute timestamps, f64 averages)."""
    from flock_tpu_torch.runtime.executor import materialize_columns

    host = batch.to_numpy()
    return {**host, **materialize_columns(ex.spec, host)}


@contextlib.contextmanager
def no_plain_on_card(fused_partial: bool = False):
    """Fail the run if a plain kernel version (the scatter aggregate that
    ``kernels.dense_group_aggregate`` takes for shapes K2 does not) sees a
    card tensor.  ``fused_partial`` (the sharded runs) lets through one
    caller: the partial of a fused join-aggregate's unfused branch in a
    sharded fallback lowering (``_lower_fused_dist``), the reference's own
    scatter (``allow_blocked=False``)."""
    from flock_tpu_torch.ops import dense_agg, kernels

    # the scatter path's name and K2's wrapper's (which reaches it only on
    # the CPU, per launch)
    owners = (kernels, dense_agg)
    plains = [m.dense_agg_plain for m in owners]

    def caller() -> str:
        f = sys._getframe(2)
        while f.f_code.co_name in ("dense_group_aggregate",
                                   "group_aggregate"):
            f = f.f_back
        return f.f_code.co_name

    def guard(plain):
        def guarded(keys, *args, **kw):
            if keys.is_cuda and not (fused_partial
                                     and caller() == "_lower_fused_dist"):
                raise AssertionError("a card tensor reached dense_agg_plain")
            return plain(keys, *args, **kw)
        return guarded

    for m, plain in zip(owners, plains):
        m.dense_agg_plain = guard(plain)
    try:
        yield
    finally:
        for m, plain in zip(owners, plains):
            m.dense_agg_plain = plain


@contextlib.contextmanager
def staging_count():
    """Count ``Batch.from_numpy`` calls (one per relation staged)."""
    from flock_tpu_torch.batch import Batch

    calls = []
    orig = Batch.from_numpy.__func__
    Batch.from_numpy = classmethod(
        lambda cls, *a, **k: calls.append(1) or orig(cls, *a, **k))
    try:
        yield calls
    finally:
        Batch.from_numpy = classmethod(orig)


@contextlib.contextmanager
def executors_made():
    """Every ``LocalExecutor`` made inside the block, in order."""
    from flock_tpu_torch.runtime.executor import LocalExecutor

    made = []
    orig = LocalExecutor.__post_init__

    def keep(self):
        orig(self)
        made.append(self)

    LocalExecutor.__post_init__ = keep
    try:
        yield made
    finally:
        LocalExecutor.__post_init__ = orig


@contextlib.contextmanager
def kernel_inputs(picks: dict, into: dict):
    """Keep the arguments of the K1 (``join_aggregate``, called by the
    plan), K2 (``dense_agg``) and K3 (``gather``, called by the plain ops)
    calls made inside the block: ``picks`` maps a case name to (wrapper,
    test of the call's positional arguments), and ``into`` gets, for each
    case, the (args, kwargs) of the first call its test takes.  The wrapper
    itself runs as it would, and counts its launch as it would."""
    from flock_tpu_torch import plan
    from flock_tpu_torch.ops import kernels

    where = {"dense_agg": kernels, "gather": kernels, "join_aggregate": plan}
    wrappers = {n: getattr(mod, n) for n, mod in where.items()}

    def keeping(n):
        def call(*args, **kw):
            for case, (w, test) in picks.items():
                if w == n and case not in into and test(args):
                    into[case] = (args, kw)
            return wrappers[n](*args, **kw)
        return call

    for n, mod in where.items():
        setattr(mod, n, keeping(n))
    try:
        yield into
    finally:
        for n, mod in where.items():
            setattr(mod, n, wrappers[n])


@dataclasses.dataclass
class Path:
    """How a run's windows reach the executor: ``stage(ex)`` puts the
    inputs on ``ex``'s device, ``run(ex, staged, i)`` executes window i
    from them, and ``feed(ex)`` stages and executes in stream order.
    ``single`` maps window i to its one epoch when every window holds one
    (element-wise windows), else it is None."""
    windows: list          # (tag, host relation tables) per window
    stage: object
    run: object
    feed: object
    single: list | None = None
    # compute(ex, staged): every window from the staged inputs, when the
    # driver's own run does it (processing-time windows); else run() per
    # window
    compute: object = None


def epoch_path(driver, epochs) -> Path:
    """The range windows' path: every epoch staged once at StreamDriver's
    per-epoch capacities, each window through ``execute_epochs``
    (``bench.EpochFeed``, the harness's own feed)."""
    feed = EpochFeed(driver, epochs)
    return Path(driver.windows(epochs), feed.stage, feed.run, feed.feed,
                feed.single)


def window_path(windows, caps_of) -> Path:
    """Windows formed on the host (row-count windows, YSB), each staged
    whole at ``caps_of(tables)``."""
    def run(ex, staged, i, check=True):
        return ex.execute_batches(staged[i], check_overflow=check)

    def feed(ex):
        for _, t in windows:
            ex.execute_batches(ex.prepare_window(t, caps_of(t)),
                               check_overflow=False)

    return Path(windows,
                lambda ex: [ex.prepare_window(t, caps_of(t))
                            for _, t in windows], run, feed)


def consts_path(spec, epochs: list, seconds: int) -> Path:
    """The processing-time windows' path: every epoch's projected bid
    table prestaged (``StreamDriver.prestage``), each window of w arrival
    epochs through ``execute_consts`` at the driver's capacity
    (``_bucket_cap_fine`` of the window's key span and the margin).  The
    host tables carry ``p_time`` for the numpy version."""
    from flock_tpu_torch.config import CONFIG
    from flock_tpu_torch.runtime.stream import StreamDriver, _bucket_cap_fine

    w = spec.window[1]
    ranges = [[t for t in range(s0, min(s0 + w, seconds))
               if len(epochs[t]["bid"]["bidder"])]
              for s0 in range(0, seconds, w)]
    windows, caps = [], []
    for s0, rng in zip(range(0, seconds, w), ranges):
        bid = {c: np.concatenate([epochs[t]["bid"][c] for t in rng])
               for c in epochs[0]["bid"]}
        bid["p_time"] = np.concatenate([
            np.full(len(epochs[t]["bid"]["bidder"]), t * 1000, np.int64)
            for t in rng])
        windows.append((("ptime", s0, s0 + w), {"bid": bid}))
        keys = bid["bidder"]
        caps.append(_bucket_cap_fine(int(keys.max()) - int(keys.min()) + 1
                                     + CONFIG.agg_span_margin))

    def driver(ex):
        d = StreamDriver(spec, seconds, device=ex.device)
        d.executor = ex
        return d

    def run(ex, staged, i):
        return ex.execute_consts([staged[t] for t in ranges[i]],
                                 {"p_time": [t * 1000 for t in ranges[i]]},
                                 caps[i])

    return Path(windows, lambda ex: driver(ex).prestage(epochs), run,
                lambda ex: driver(ex).run(epochs),
                compute=lambda ex, staged: driver(ex).run(
                    epochs, prestaged=staged))


def phase_query(label: str, spec, main, path_of, numpy_fn, seconds: int,
                eps: int, gen_s: float, card_line: str,
                staged_once: int | None = None,
                inputs: dict | None = None, cpu_check: bool = True,
                compare=None, depth: tuple = (5, 3, True)) -> dict:
    """One run on the card: ``main()`` is the main path (returns the
    window results; the executor it makes runs the comparisons and the
    timed passes too), ``path_of()`` the way its windows reach the
    executor.  Returns the launches of every kernel over the main path's
    run; ``inputs`` gets the main path's kernel calls that
    ``WINDOWED_PICKS[label]`` names.  ``cpu_check=False`` leaves out the
    plain CPU path's pass (a SQL run whose hand plan held it in this run:
    the rows are held against the hand plan's instead); ``compare``
    (default ``_same_row_set``) holds rows against the numpy version's.
    The window results and the run's numbers stay in ``RESULTS`` and
    ``RECORDS`` under ``label``.  ``depth`` is (compute-only passes,
    feed-inclusive passes, profiled): the SQL runs take (1, 1, False),
    their idle share then not measured; the ATen record's pass, which
    counts the kernel launches, always runs."""
    n_compute, n_feed, profiled = depth
    compare = compare or _same_row_set
    from flock_tpu_torch.runtime.executor import LocalExecutor

    # the main path, with every launch counter at zero before it
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    picks = WINDOWED_PICKS.get(label, {})
    kept = {}
    with no_plain_on_card(), staging_count() as staged_calls, \
            executors_made() as made, kernel_inputs(picks, kept):
        t0 = time.perf_counter()
        results = main()
        torch.cuda.synchronize()
        first_run_s = time.perf_counter() - t0
    if set(kept) != set(picks):
        raise AssertionError(f"{label}: no main-path call for "
                             f"{sorted(set(picks) - set(kept))}")
    if inputs is not None:
        inputs.update(kept)
    ex = made[-1]
    launches = {k: w.launches for k, w in wrappers.items()}
    missing = [k for k in QUERY_KERNELS[label] if not launches[k]]
    if missing:
        raise AssertionError(f"{label} did not run through {missing}: "
                             f"{launches}")
    if any(e.fallback_runs for e in made):
        raise AssertionError(f"{label} at the bench size took the fallback")
    if staged_once is not None and len(staged_calls) != staged_once:
        raise AssertionError(f"{label} staged {len(staged_calls)} batches, "
                             f"not each epoch once ({staged_once})")

    path = path_of()
    if [tag for tag, _ in path.windows] != [r.tag for r in results]:
        raise AssertionError(f"{label}: window tags differ")
    cpu = LocalExecutor(spec, device="cpu", side_input=ex.side_input)
    gpu_in = path.stage(ex)
    cpu_in = path.stage(cpu) if cpu_check else None
    out_rows = 0
    for i, ((tag, tables), res) in enumerate(zip(path.windows, results)):
        got = _host(ex, path.run(ex, gpu_in, i))
        want = numpy_fn(tables)
        if cpu_check:
            plain = _host(cpu, path.run(cpu, cpu_in, i))
            _same_rows(got, plain, list(plain),
                       f"{label} {tag}: card vs CPU plain path")
        compare(got, want, list(want), f"{label} {tag}: card vs numpy")
        compare(res.columns, want, spec.schema.names,
                f"{label} {tag}: driver vs numpy")
        out_rows += len(res.columns[spec.schema.names[0]])
    del gpu_in, cpu_in

    rows_in = sum(len(next(iter(t[r].values())))
                  for _, t in path.windows for r in t)
    staged = path.stage(ex)
    torch.cuda.synchronize()

    def compute():
        if path.compute is not None:
            return path.compute(ex, staged)
        for i in range(len(path.windows)):
            path.run(ex, staged, i, False)

    best = best_s(compute, n_compute)
    # where the device time goes in one compute-only pass; the idle share
    # sets the device's busy time against the unprofiled compute time
    events = profile(compute) if profiled else None
    wrappers = counters()
    before = {k: w.launches for k, w in wrappers.items()}
    aten = dispatched_ops(compute)
    extra = {"aten_ops": len(aten), "aten_cat": aten.count("cat"),
             "kernel_launches": sum(w.launches - before[k]
                                    for k, w in wrappers.items())}
    if path.single is not None and profiled:
        # a one-epoch window takes its epoch's batches as they stand: the
        # same operations as execute_batches on them
        one = profile(
            lambda: [ex.execute_batches(staged[t], check_overflow=False)
                     for t in path.single])
        extra["device_ops_execute_batches"] = None if one is None \
            else sum(e.count for e in one)
        if dispatched_ops(lambda: [
                ex.execute_batches(staged[t], check_overflow=False)
                for t in path.single]) != aten:
            raise AssertionError(f"{label}: one-epoch windows dispatch "
                                 "other operations than execute_batches")
    del staged
    print(f"{label} profile: " + json.dumps({
        "windows": len(path.windows), "compute_ms": best * 1e3,
        **profile_summary(events, best * 1e3), **extra}), flush=True)
    best_incl = best_s(lambda: path.feed(ex), n_feed)
    rec = {"query": label, "seconds": seconds, "eps": eps,
           "windows": len(path.windows), "rows_in": rows_in,
           "rows_out": out_rows, "gen_s": gen_s,
           "first_run_s": first_run_s, "compute_s": best,
           "rows_per_s": rows_in / best, "feed_incl_s": best_incl,
           "rows_per_s_feed_inclusive": rows_in / best_incl,
           "launches": launches, "fallback_runs": ex.fallback_runs,
           "staged_batches": len(staged_calls), "card": card_line}
    print(f"{label}: " + json.dumps(rec), flush=True)
    RESULTS[label] = results
    RECORDS[label] = {
        "rows_in": rows_in, "windows": len(path.windows),
        "compute_ms": best * 1e3, "feed_incl_ms": best_incl * 1e3,
        "idle_share": profile_summary(events, best * 1e3)["idle_share"],
        "aten_ops": extra["aten_ops"],
        "kernel_launches": extra["kernel_launches"], "launches": launches}
    return launches


def phase_stream(label: str, spec, epochs: list, seconds: int, eps: int,
                 gen_s: float, card_line: str, numpy_fn=None,
                 inputs: dict | None = None, **kw) -> dict:
    """A query through ``StreamDriver.run`` on the card (see
    ``phase_query``, which takes ``kw``); range windows must stage each
    epoch once."""
    from flock_tpu_torch.runtime.stream import StreamDriver
    from flock_tpu_torch.runtime.executor import _pow2_bucket

    # the windows' shapes come from a driver of their own; the main path's
    # driver is made inside the run
    shape = StreamDriver(spec, seconds, device="cpu")

    def main():
        return StreamDriver(spec, seconds, device="cuda").run(epochs)

    if spec.window[0] == "rows":
        def path_of():
            return window_path(shape.windows(epochs), lambda t: {
                r: _pow2_bucket(len(next(iter(c.values()))))
                for r, c in t.items()})
        once = None
    else:
        def path_of():
            return epoch_path(shape, epochs)
        once = len(epochs) * len(shape.epoch_caps(epochs)) \
            + ("side_input" in spec.relations)
    return phase_query(label, spec, main, path_of,
                       numpy_fn or (lambda t: numpy_query(spec.number, t)),
                       seconds, eps, gen_s, card_line, once, inputs, **kw)


def phase_q12(epochs: list, gen_s: float, card_line: str,
              inputs: dict) -> dict:
    """q12 through ``StreamDriver.run`` on the windowed epochs: arrival
    windows [0, 10) and [10, 15).  Compute-only is ``run(epochs,
    prestaged=prestage(epochs))`` (bench.py:205-217), feed-inclusive
    ``run(epochs)``.  The main path makes one K2 count per staged chunk;
    then, on the same staged chunks, the fast runner is held against the
    general one (``_run_plan_consts``: the chunks concatenated, ``p_time``
    filled on the device, the plan's count/min/max on K2): validity equal,
    every column equal on the valid rows."""
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.executor import LocalExecutor
    from flock_tpu_torch.runtime.stream import StreamDriver

    spec = get_query(12)
    chunks = sum(1 for e in epochs if len(e["bid"]["bidder"]))
    launches = phase_query(
        "q12", spec,
        lambda: StreamDriver(spec, WIN_SECONDS, device="cuda").run(epochs),
        lambda: consts_path(spec, epochs, WIN_SECONDS), numpy_q12,
        WIN_SECONDS, BENCH_EPS, gen_s, card_line, chunks, inputs)
    if launches["dense_agg"] != chunks:
        raise AssertionError(f"q12: {launches['dense_agg']} K2 launches for "
                             f"{chunks} staged chunks")
    # the driver's host bookkeeping per run: each epoch's key range (numpy
    # min and max over its bidder column), which sizes the window's slots
    t0 = time.perf_counter()
    for e in epochs:
        keys = e["bid"]["bidder"]
        int(keys.min()), int(keys.max())
    print("q12 host: " + json.dumps({
        "key_range_ms": (time.perf_counter() - t0) * 1e3,
        "rows": sum(len(e["bid"]["bidder"]) for e in epochs)}), flush=True)
    ex = LocalExecutor(spec, device="cuda")
    path = consts_path(spec, epochs, WIN_SECONDS)
    staged = path.stage(ex)
    for i, (tag, _) in enumerate(path.windows):
        fast = path.run(ex, staged, i)
        rng = [t for t in range(tag[1], min(tag[2], WIN_SECONDS))
               if staged[t] is not None]
        general = ex._run_plan_consts(
            [staged[t] for t in rng], "bid", ("p_time",),
            np.asarray([[t * 1000] for t in rng], np.int32), fast.capacity)
        if not torch.equal(fast.valid, general.valid) \
                or not bool(fast.valid.any()):
            raise AssertionError(f"q12 {tag}: fast and general runners' "
                                 "validity differs")
        v = fast.valid
        for name, col in general.columns.items():
            if not torch.equal(fast.columns[name][v], col[v]):
                raise AssertionError(f"q12 {tag}: fast and general runners "
                                     f"differ in {name}")
        print(f"q12 {tag}: fast runner = general runner on "
              f"{sum(staged[t].capacity for t in rng)} rows, "
              f"{int(v.sum())} bidders, capacity {fast.capacity}", flush=True)
    return launches


def ysb_windows():
    """(config, windows, generation seconds) of YSB at bench.py's size."""
    from flock_tpu_torch.datagen.ysb import YsbConfig
    from flock_tpu_torch.queries.ysb import (campaign_table,
                                             generate_ysb_epochs, ysb_query)

    cfg = YsbConfig(seconds=YSB_SECONDS, events_per_second=BENCH_EPS)
    t0 = time.perf_counter()
    epochs = generate_ysb_epochs(cfg)
    gen_s = time.perf_counter() - t0
    w = ysb_query().window[1]
    camp = campaign_table(cfg)
    windows = [(("win", k * w, k * w + w), {
        "ad_event": {c: np.concatenate([e["ad_event"][c]
                                        for e in epochs[k * w:(k + 1) * w]])
                     for c in epochs[0]["ad_event"]},
        "campaign": camp}) for k in range(cfg.seconds // w)]
    return cfg, windows, gen_s


def phase_ysb(card_line: str, inputs: dict, cfg, windows,
              gen_s: float) -> dict:
    """YSB at bench.py's size through ``run_ysb`` on the card."""
    from flock_tpu_torch.queries.ysb import run_ysb, ysb_capacities, ysb_query

    spec = ysb_query()
    caps = ysb_capacities(cfg, spec.window[1])
    return phase_query("ysb", spec, lambda: run_ysb(cfg, device="cuda"),
                       lambda: window_path(windows, lambda t: caps),
                       numpy_ysb, cfg.seconds, cfg.events_per_second, gen_s,
                       card_line, inputs=inputs)


def phase_sql_ysb(card_line: str, cfg, windows, gen_s: float) -> dict:
    """YSB's SQL on the card: each window through a ``LocalExecutor`` of
    the lowered spec at ``run_ysb``'s capacities; rows against
    ``numpy_ysb`` and ``run_ysb``'s from this run."""
    from flock_tpu_torch.queries.ysb import ysb_capacities
    from flock_tpu_torch.runtime.executor import LocalExecutor
    from flock_tpu_torch.runtime.stream import WindowResult

    spec = sql_spec("ysb")
    caps = ysb_capacities(cfg, spec.window[1])

    def main():
        ex = LocalExecutor(spec, device="cuda")
        return [WindowResult(tag, ex.materialize(ex.execute_window(t, caps)))
                for tag, t in windows]

    launches = phase_query("sql-ysb", spec, main,
                           lambda: window_path(windows, lambda t: caps),
                           numpy_ysb, cfg.seconds, cfg.events_per_second,
                           gen_s, card_line, cpu_check=False,
                           depth=SQL_DEPTH)
    names = ["campaign_id", "count"]
    same_as_hand("sql-ysb", RESULTS.pop("sql-ysb"), RESULTS.pop("ysb"),
                 names, names)
    print("sql-ysb: rows equal run_ysb's and the numpy version's",
          flush=True)
    return launches


Q11_NAMES = ["bidder", "bid_count", "start_time", "end_time"]


def _all_rows(results) -> dict:
    """Every emission's sink columns, concatenated."""
    return {n: np.concatenate([np.asarray(r.columns[n]) for r in results])
            for n in Q11_NAMES}


@contextlib.contextmanager
def session_tier(generic: bool):
    """Inside the block, q11 takes the generic label-table tier when
    ``generic`` (the device tier's gate answers None, as
    tests/test_adversarial.py:84 forces it), and the number of chunk
    compactions of that tier is counted."""
    from flock_tpu_torch.runtime import device_session, stream

    gate, compact = device_session.session_fast_spec, \
        stream.SessionState.compact
    made = []

    def counting(self, max_chunks, restage=None):
        before = self.next_cid
        compact(self, max_chunks, restage)
        if self.next_cid != before:
            made.append(1)

    if generic:
        device_session.session_fast_spec = lambda *a, **kw: None
    stream.SessionState.compact = counting
    try:
        yield made
    finally:
        device_session.session_fast_spec = gate
        stream.SessionState.compact = compact


def phase_q11(label: str, epochs: list, seconds: int, eps: int,
              gen_s: float, card_line: str, want: dict, inputs: dict,
              generic: bool = False, cpu_check: bool = True,
              device_results=None, reps: int = 3) -> tuple:
    """q11 through ``StreamDriver.run`` on the card, in the device tier or
    (``generic``) the generic label-table tier.  The main path runs with
    every launch counter at zero: its tier's kernels must launch, no plain
    kernel version may see a card tensor, and each epoch is staged once
    (the generic tier also restages each compaction's merged rows).  Its
    rows must equal ``want`` (numpy_q11); the device tier's emissions must
    equal the plain CPU path's, emission for emission, row for row
    (``cpu_check``); the generic tier's must equal the device tier's
    (``device_results``), tag for tag.  Then compute-only (``run(epochs,
    prestaged=prestage(epochs))``) and feed-inclusive (``run(epochs)``)
    rows/s, the idle share of the compute-only run, the emissions, the
    device tier's rollbacks, host reads of the chunk flags per chunk
    dispatch, the host's per-epoch key-range time, and one compute-only
    run with the emission buffer preset to the size the rollbacks reach
    (none then); ``reps`` bounds the timed runs.  Returns (launches,
    results)."""
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import StreamDriver

    spec = get_query(11)
    nonempty = sum(1 for e in epochs if len(e["bid"]["bidder"]))
    with session_tier(generic) as compactions:
        wrappers = counters()
        for w in wrappers.values():
            w.launches = 0
        picks = WINDOWED_PICKS.get(label, {})
        kept = {}
        driver = StreamDriver(spec, seconds, device="cuda")
        with no_plain_on_card(), staging_count() as staged_calls, \
                kernel_inputs(picks, kept):
            t0 = time.perf_counter()
            results = driver.run(epochs)
            torch.cuda.synchronize()
            first_run_s = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        n_compactions = len(compactions)
        if set(kept) != set(picks):
            raise AssertionError(f"{label}: no main-path call for "
                                 f"{sorted(set(picks) - set(kept))}")
        inputs.update(kept)
        missing = [k for k in QUERY_KERNELS[label] if not launches[k]]
        if missing:
            raise AssertionError(f"{label} did not run through {missing}: "
                                 f"{launches}")
        if len(staged_calls) != nonempty + n_compactions:
            raise AssertionError(
                f"{label} staged {len(staged_calls)} batches, not each of "
                f"{nonempty} epochs once (+{n_compactions} compactions)")
        stats = driver.session_stats
        if (stats is None) != generic:
            raise AssertionError(f"{label}: ran in the wrong session tier")
        got = _all_rows(results)
        _same_row_set(got, want, Q11_NAMES, f"{label}: card vs numpy")
        if cpu_check:
            cpu = StreamDriver(spec, seconds, device="cpu").run(epochs)
            if [r.tag for r in cpu] != [r.tag for r in results]:
                raise AssertionError(f"{label}: emission tags differ from "
                                     "the CPU plain path's")
            for r, c in zip(results, cpu):
                _same_rows(r.columns, c.columns, Q11_NAMES,
                           f"{label} {r.tag}: card vs CPU plain path")
                for n in Q11_NAMES:
                    if r.columns[n].dtype != c.columns[n].dtype:
                        raise AssertionError(f"{label} {r.tag}: {n} dtype")
        if device_results is not None:
            if [r.tag for r in device_results] != [r.tag for r in results]:
                raise AssertionError(f"{label}: emission tags differ from "
                                     "the device tier's")
            for r, d in zip(results, device_results):
                _same_row_set(r.columns, d.columns, Q11_NAMES,
                              f"{label} {r.tag}: vs the device tier")

        rows_in = sum(len(e["bid"]["bidder"]) for e in epochs)
        timed = StreamDriver(spec, seconds, device="cuda")
        staged = timed.prestage(epochs)
        torch.cuda.synchronize()

        def compute():
            return timed.run(epochs, prestaged=staged)

        best = best_s(compute, reps)
        events = profile(compute, sessions=min(reps, 3))
        wrappers = counters()
        before = {k: w.launches for k, w in wrappers.items()}
        aten = dispatched_ops(compute)
        print(f"{label} profile: " + json.dumps({
            "compute_ms": best * 1e3, **profile_summary(events, best * 1e3),
            "aten_ops": len(aten),
            "kernel_launches": sum(w.launches - before[k]
                                   for k, w in wrappers.items())}),
              flush=True)
        if not generic:
            # the same compute-only run with the emission buffer the
            # rollbacks end at preset: what the rollbacks cost
            from flock_tpu_torch.runtime import device_session

            warm = timed.session_stats
            preset = device_session.CAP_OUT
            device_session.CAP_OUT = preset << warm.retries
            try:
                no_rollback_s = best_s(compute, 1)
            finally:
                device_session.CAP_OUT = preset
            if timed.session_stats.retries:
                raise AssertionError(f"{label}: a preset buffer rolled back")
        del staged
        best_incl = best_s(
            lambda: StreamDriver(spec, seconds, device="cuda").run(epochs),
            max(reps - 1, 1))
    rec = {"query": label, "tier": "generic" if generic else "device",
           "seconds": seconds, "eps": eps, "rows_in": rows_in,
           "rows_out": len(got["bidder"]), "emissions": len(results),
           "gen_s": gen_s, "first_run_s": first_run_s, "compute_s": best,
           "rows_per_s": rows_in / best, "feed_incl_s": best_incl,
           "rows_per_s_feed_inclusive": rows_in / best_incl,
           "launches": launches, "staged_batches": len(staged_calls),
           "card": card_line}
    if generic:
        rec["compactions"] = n_compactions
    else:
        # the flush's session count is the one read that is not a chunk's;
        # the key ranges' time is the last compute-only run's (warm)
        rec.update(dispatches=stats.dispatches, retries=stats.retries,
                   flag_reads=stats.flag_reads,
                   flag_reads_per_dispatch=(stats.flag_reads - 1)
                   / stats.dispatches,
                   key_range_ms=warm.meta_s * 1e3,
                   compute_s_no_rollback=no_rollback_s)
    print(f"{label}: " + json.dumps(rec), flush=True)
    return launches, results


def phase_q11_resume(epochs: list, seconds: int, card_line: str,
                     uninterrupted) -> None:
    """The device tier's checkpoint/resume on the card, as
    tests/test_checkpoint.py:256 drives the reference: epochs 0-7 through
    ``step_impl``, the open sessions through ``to_payloads`` and a file
    backend in a temporary directory, a fresh driver resuming with
    ``run_device_sessions(..., resume_payloads=..., t_base=8)``.  The
    union of the emissions must equal the uninterrupted run's rows."""
    import tempfile

    from flock_tpu_torch.batch import TS_BASE, Batch
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime import device_session as ds
    from flock_tpu_torch.runtime.executor import _pow2_bucket
    from flock_tpu_torch.runtime.state import FileStateBackend
    from flock_tpu_torch.runtime.stream import SessionState, StreamDriver

    t_phase = time.perf_counter()
    spec = get_query(11)
    key, tcol = SessionState.key, SessionState.time_col
    gap, split = spec.window[1], 8
    fs = ds.session_fast_spec(spec, key, "bid")
    ea, accs = ds._acc_plan(fs, key, tcol)
    ks = [e["bid"][key] for e in epochs if len(e["bid"][key])]
    m, kmax = min(int(k.min()) for k in ks), max(int(k.max()) for k in ks)
    SE = ds._bucket(max(int(k.max()) - int(k.min()) + 1 for k in ks))
    state = ds.init_state(ds._bucket(kmax - m + 1 + 8192) + SE, accs, "cuda")
    parts = []
    for t in range(split):
        bid = {c: epochs[t]["bid"][c] for c in (key, tcol)}
        b = Batch.from_numpy(bid, _pow2_bucket(len(bid[key])), "cuda")
        state, oc, _, ne, ovf = ds.step_impl(
            key, tcol, ea, accs, SE, ds.CAP_OUT, True, gap, t + 1 - gap, m,
            state, dict(b.columns), b.valid,
            (int(bid[key].min()), int(bid[key].max())))
        n = int(ne)
        if bool(ovf):
            raise AssertionError(f"q11 resume: step {t} overflowed")
        host = ds.finish_names(fs, key, {c: a[:n].cpu().numpy()
                                         for c, a in oc.items()})
        parts.append({**host,
                      "start_time": host["start_time"].astype(np.int64)
                      + TS_BASE,
                      "end_time": host["end_time"].astype(np.int64)
                      + TS_BASE})
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as root:
        backend = FileStateBackend(root=root)
        t0 = time.perf_counter()
        for p in ds.to_payloads(state, m, accs, "q11", split):
            backend.write(0, p)
        write_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in os.scandir(
            os.path.join(root, "q11", "0", "0")))
        t0 = time.perf_counter()
        payloads = [backend.read("q11", 0, 0, s)
                    for s in backend.list_seqs("q11", 0, 0)]
        read_s = time.perf_counter() - t0
    del state
    opened = sum(len(p.columns["__key"]) for p in payloads)
    if not opened:
        raise AssertionError("q11 resume: no session open at the checkpoint")
    resumed = ds.run_device_sessions(StreamDriver(spec, seconds,
                                                  device="cuda"),
                                     epochs[split:], None, fs,
                                     resume_payloads=payloads, t_base=split)
    rows = {n: np.concatenate([p[n] for p in parts]
                              + [np.asarray(r.columns[n]) for r in resumed])
            for n in Q11_NAMES}
    _same_row_set(rows, _all_rows(uninterrupted), Q11_NAMES,
                  "q11 resume: union vs the uninterrupted run")
    print("q11 resume: " + json.dumps({
        "split_epoch": split, "open_sessions": opened,
        "payload_bytes": size, "write_s": write_s, "read_s": read_s,
        "rows": len(rows["bidder"]), "resumed_emissions": len(resumed),
        "seconds": time.perf_counter() - t_phase, "card": card_line}),
        flush=True)


def _blanked(epochs: list, blank=(0, 1, 5)) -> list:
    """tests/test_windows.py's stagger input: epochs 0, 1 and 5 empty."""
    empty = {k: v[:0] for k, v in epochs[0]["bid"].items()}
    return [{"bid": empty} if t in blank else e for t, e in enumerate(epochs)]


def _duplicate_persons(window: dict) -> dict:
    """The window with every person row repeated under another name, city
    and a state inside q3's filter: each of their sellers joins twice."""
    p = window["person"]
    twin = dict(p, name=(p["name"] + 1) % 100, city=(p["city"] + 1) % 10,
                state=np.full_like(p["state"], 3))
    return dict(window, person={k: np.concatenate([p[k], twin[k]])
                                for k in p})


def phase_duplicates() -> None:
    """tests/test_sqlite_oracle.py:280's configuration: misaligned
    generators repeat auction ids (never person ids), so q4's and q9's
    fused passes escape and the window reruns (SQL q4's too, its rows equal
    hand q4's); q3 runs clean there, and reruns once over the window with
    every person row repeated."""
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.executor import LocalExecutor
    from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
    from flock_tpu_torch.runtime.tables import concat_relations

    seconds = 10
    epochs = generate_epochs(seconds, 350, 3)
    window = concat_relations(epochs, ("person", "auction", "bid"))
    for q, reruns in ((4, 1), (9, 1), (6, 1), (3, 0), ("sql-q4", 1)):
        spec = sql_spec(4) if q == "sql-q4" else get_query(q)
        driver = StreamDriver(spec, seconds, device="cuda")
        driver._window_epoch_ranges = lambda occupancy=None: [
            (("win", 0, seconds), list(range(seconds)))]
        results = driver.run(epochs)
        if driver.executor.fallback_runs != reruns:
            raise AssertionError(f"{q} duplicate window: fallback_runs "
                                 f"{driver.executor.fallback_runs}, not "
                                 f"{reruns}")
        want = numpy_query(4 if q == "sql-q4" else q, window)
        _same_row_set(results[0].columns, want, spec.schema.names,
                      f"{q} duplicate window vs numpy")
        if q == 4:
            hand_q4 = results
        if q == "sql-q4":
            same_as_hand("duplicates sql-q4", results, hand_q4,
                         spec.schema.names, spec.schema.names)
        name = q if q == "sql-q4" else f"q{q}"
        print(f"duplicates {name}: fallback_runs="
              f"{driver.executor.fallback_runs} "
              f"rows={len(want[spec.schema.names[0]])} ok", flush=True)
    dup = _duplicate_persons(window)
    spec = get_query(3)
    ex = LocalExecutor(spec, device="cuda")
    got = ex.materialize(ex.execute_window(
        {r: dup[r] for r in spec.relations}))
    want = numpy_q3(dup)
    if ex.fallback_runs != 1:
        raise AssertionError(f"q3 duplicate persons: fallback_runs "
                             f"{ex.fallback_runs}, not 1")
    _same_row_set(got, want, spec.schema.names,
                  "q3 duplicate persons vs numpy")
    print(f"duplicates q3 (persons repeated): fallback_runs={ex.fallback_runs}"
          f" rows={len(want['a_id'])} ok", flush=True)


# -- the SQL frontend and the CLI ---------------------------------------------


def sql_spec(q, window=("elementwise",)):
    """``sql_to_spec`` of SQL_TEXTS[q] (SQL_YSB for ``"ysb"``)."""
    from flock_tpu_torch.sql.catalog import nexmark_catalog, ysb_catalog
    from flock_tpu_torch.sql.lower import sql_to_spec

    if q == "ysb":
        return sql_to_spec(SQL_YSB, ysb_catalog(), window=("tumbling", 10))
    return sql_to_spec(SQL_TEXTS[q], nexmark_catalog(), window=window)


def numpy_bidders(t: dict) -> dict:
    """Independent SQL q11 text over one window: per bidder, the bids and
    the least and greatest ``b_date_time``."""
    bid = t["bid"]
    order = np.argsort(bid["bidder"], kind="stable")
    b, ts = bid["bidder"][order], bid["b_date_time"][order]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    idx = np.flatnonzero(first)
    return {"bidder": b[idx], "bid_count": np.diff(np.append(idx, len(b))),
            "start_time": np.minimum.reduceat(ts, idx),
            "end_time": np.maximum.reduceat(ts, idx)}


def _grouped(key_name: str, keys, aggs: dict) -> dict:
    """Per distinct key, each of ``aggs`` (output name → (values,
    ``np.maximum``/``np.minimum``/``np.add``)) over its rows, in int64."""
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    first = np.ones(len(k), bool)
    first[1:] = k[1:] != k[:-1]
    idx = np.flatnonzero(first)
    out = {key_name: k[idx]}
    for name, (v, op) in aggs.items():
        out[name] = op.reduceat(v[order].astype(np.int64), idx) \
            if len(idx) else np.zeros(0, np.int64)
    return out


def _nine_aggs(cols: dict) -> dict:
    """The texts' nine aggregates; the sum of ``b_date_time`` adds the
    device's relative milliseconds (``batch.TS_BASE`` off each), as the
    reference does: only a min or max is a timestamp again at the sink."""
    from flock_tpu_torch.batch import TS_BASE

    mx, mn, add = np.maximum, np.minimum, np.add
    return {"max_price": (cols["price"], mx), "min_price": (cols["price"], mn),
            "sum_price": (cols["price"], add),
            "max_b_date_time": (cols["b_date_time"], mx),
            "min_b_date_time": (cols["b_date_time"], mn),
            "max_bidder": (cols["bidder"], mx),
            "min_bidder": (cols["bidder"], mn),
            "sum_bidder": (cols["bidder"], add),
            "sum_b_date_time": (cols["b_date_time"] - TS_BASE, add)}


def numpy_many_aggs(t: dict) -> dict:
    """Independent MANY_AGGS_SQL: the nine aggregates of the bids per
    auction."""
    bid = t["bid"]
    return _grouped("auction", bid["auction"], _nine_aggs(bid))


def numpy_many_aggs_join(t: dict) -> dict:
    """Independent MANY_AGGS_JOIN_SQL: the nine aggregates per auction id
    over the bids inside an interval of an auction row with that id."""
    auction, bid = t["auction"], t["bid"]
    bi, ai = _winning_pairs(auction, bid)
    return _grouped("a_id", auction["a_id"][ai],
                    _nine_aggs({c: bid[c][bi] for c in bid}))


def _close_row_set(got: dict, want: dict, names, what: str) -> None:
    """SQL q6's comparison, tests/test_sql.py's: the first column (the
    sellers) exact, the second (the averages) to rtol 1e-9 (ROW_NUMBER's
    order among ties is unspecified)."""
    key, val = names[0], names[1]
    g, w = np.asarray(got[key]), np.asarray(want[key])
    go, wo = np.argsort(g, kind="stable"), np.argsort(w, kind="stable")
    if not np.array_equal(g[go], w[wo]):
        raise AssertionError(f"{what}: {key} differs")
    if not np.allclose(np.asarray(got[val])[go], np.asarray(want[val])[wo],
                       rtol=1e-9, atol=0):
        raise AssertionError(f"{what}: {val} differs beyond rtol 1e-9")


def same_as_hand(label: str, results, hand, sql_names, hand_names,
                 compare=_same_row_set) -> None:
    """A SQL run's windows against its hand plan's from the same run: the
    same tags, and the same rows under the hand plan's names."""
    if [r.tag for r in results] != [h.tag for h in hand]:
        raise AssertionError(f"{label}: window tags differ from the hand "
                             "plan's")
    for r, h in zip(results, hand):
        compare(r.columns, {s: h.columns[n] for s, n in zip(sql_names,
                                                            hand_names)},
                sql_names, f"{label} {r.tag}: SQL vs hand plan")


def sql_beside_hand(label: str, hand_label: str,
                    same_launches: bool) -> None:
    """The SQL run's compute-only and feed-inclusive ms, idle share, ATen
    operations and kernel launches beside its hand plan's; for q4 and q9
    the launches must be the same (K1 kept)."""
    sql, hand = RECORDS[label], RECORDS[hand_label]
    print(f"{label} beside {hand_label}: " + json.dumps(
        {"sql": sql, "hand": hand}), flush=True)
    if same_launches and (sql["launches"] != hand["launches"]
                          or sql["kernel_launches"]
                          != hand["kernel_launches"]):
        raise AssertionError(f"{label}: launches {sql['launches']} "
                             f"({sql['kernel_launches']}), the hand plan's "
                             f"{hand['launches']} "
                             f"({hand['kernel_launches']})")


def phase_sql(epochs: list, gen_s: float, card_line: str,
              launches: dict) -> None:
    """Every SQL text of tests/test_sql.py, q6's and q11's lowered by
    ``sql_to_spec`` and run through ``StreamDriver.run`` on the bench
    epochs (element-wise windows), as ``phase_stream`` runs the hand plans
    (every kernel of the path launched, no plain kernel version on a card
    tensor, each epoch staged once, rows against the numpy version), less
    the plain CPU pass the hand plans already made: each SQL run's rows
    are held against its hand plan's from this run (q3, q5, q7 and q8,
    whose hand plans ran at other windows, run theirs here), SQL q6's to
    the reference test's tolerance.  q4's, q9's and q13's numbers are
    printed beside their hand plans'; q4 and q9 must make the same
    launches (K1 kept).  Then the texts with more aggregates than a kernel
    launch takes (``MANY_AGGS_SQL``: two K2 launches a window;
    ``MANY_AGGS_JOIN_SQL``: unfused, no K1 launch), their rows against
    numpy's and their launches exactly ``MANY_AGGS_LAUNCHES`` a window."""
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import StreamDriver
    from flock_tpu_torch.sql.catalog import nexmark_catalog
    from flock_tpu_torch.sql.lower import sql_to_spec

    for q in (4, 9, 13, 0, 1, 2, 10, 3, 5, 7, 8, 6, 11):
        label = f"sql-q{q}"
        spec = sql_spec(q)
        compare = _close_row_set if q == 6 else _same_row_set
        if q == 11:
            numpy_fn, hand = numpy_bidders, None
        else:
            hspec = get_query(q)
            names = hspec.schema.names

            def numpy_fn(t, q=q, names=names, sql_names=spec.schema.names):
                want = numpy_query(q, t)
                return {s: want[n] for s, n in zip(sql_names, names)}
            hand = RESULTS.get(f"q{q}")
            if hand is None:
                hand = StreamDriver(dataclasses.replace(
                    hspec, window=("elementwise",)), BENCH_SECONDS,
                    device="cuda").run(epochs)
        launches[label] = phase_stream(
            label, spec, epochs, BENCH_SECONDS, BENCH_EPS, gen_s, card_line,
            numpy_fn=numpy_fn, cpu_check=False, compare=compare,
            depth=SQL_DEPTH)
        if hand is not None:
            same_as_hand(label, RESULTS[label], hand, spec.schema.names,
                         names, compare)
        if q in (4, 9, 13):
            sql_beside_hand(label, f"q{q}", same_launches=q != 13)
        del RESULTS[label]
        print(f"{label}: rows equal the hand plan's and the numpy "
              "version's", flush=True)
    for label, sql, numpy_fn in (
            ("sql-many-aggs", MANY_AGGS_SQL, numpy_many_aggs),
            ("sql-many-aggs-join", MANY_AGGS_JOIN_SQL,
             numpy_many_aggs_join)):
        launches[label] = phase_stream(
            label, sql_to_spec(sql, nexmark_catalog()), epochs,
            BENCH_SECONDS, BENCH_EPS, gen_s, card_line, numpy_fn=numpy_fn,
            cpu_check=False, depth=SQL_DEPTH)
        windows = len(RESULTS.pop(label))
        want = {k: windows * v for k, v in MANY_AGGS_LAUNCHES[label].items()}
        if launches[label] != want:
            raise AssertionError(f"{label}: launches {launches[label]}, "
                                 f"predicted {want}")
        print(f"{label}: rows equal the numpy version's, launches "
              f"{launches[label]}", flush=True)


def float_key_join(epochs: list, card_line: str) -> None:
    """The float-key join (``kernels.sorted_lookup_join``, plain PyTorch:
    a sort and a binary search) on the card: q13's side input (10,000
    rows, keys as float32, a tenth of its rows invalid) probed by one
    bench window's bids (auction ids as float32: most miss; row 0 a NaN),
    row for row the CPU path's."""
    from flock_tpu_torch.ops import kernels
    from flock_tpu_torch.runtime.tables import default_side_input

    si = default_side_input()
    rng = np.random.default_rng(SEED)
    build = {"key": torch.from_numpy(si["key"].astype(np.float32)),
             "value": torch.from_numpy(si["value"])}
    bvalid = torch.from_numpy(rng.random(len(si["key"])) >= 0.1)
    bid = epochs[0]["bid"]
    pk = bid["auction"].astype(np.float32)
    pk[0] = np.nan
    probe = {"auction": torch.from_numpy(pk),
             "price": torch.from_numpy(bid["price"])}
    pvalid = torch.ones(len(pk), dtype=torch.bool)

    def join(b, bv, p, pv):
        return kernels.sorted_lookup_join(b, bv, "key", p, pv, "auction",
                                          {"value": "value"})

    cout, chit = join(build, bvalid, probe, pvalid)
    on_card = ({c: t.cuda() for c, t in build.items()}, bvalid.cuda(),
               {c: t.cuda() for c, t in probe.items()}, pvalid.cuda())

    def run():
        return join(*on_card)
    gout, ghit = run()
    if not torch.equal(ghit.cpu(), chit) or bool(chit[0]):
        raise AssertionError("float-key join: hits differ from the CPU "
                             "path's")
    for c in cout:
        if not torch.equal(gout[c].cpu()[chit], cout[c][chit]):
            raise AssertionError(f"float-key join: {c} differs from the CPU "
                                 "path's")
    print("float-key join: " + json.dumps({
        "build_rows": len(si["key"]), "probe_rows": len(pk),
        "hits": int(chit.sum()), "ms": cuda_ms(run), "card": card_line}),
        flush=True)


def _cli_lines(argv: list[str], label: str, launches: dict,
               kernels: tuple) -> list[str]:
    """``cli.main(argv)`` in this process on the card, its standard output
    captured; launch counts zeroed before it and read after it, and
    ``kernels`` must have launched."""
    import io

    from flock_tpu_torch import cli
    from flock_tpu_torch.utils.metrics import METRICS

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    METRICS.counters.clear()
    METRICS.timings.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), no_plain_on_card():
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches[label] = {k: w.launches for k, w in wrappers.items()}
    if rc != 0 or [k for k in kernels if not launches[label][k]]:
        raise AssertionError(f"{label}: rc {rc}, launches {launches[label]}")
    lines = buf.getvalue().splitlines()
    print(f"{label}: " + json.dumps({"argv": [a[:40] for a in argv],
                                     "lines": lines[-8:],
                                     "launches": launches[label]}),
          flush=True)
    return lines


def phase_cli(epochs: list, launches: dict) -> None:
    """The entry point a user types, in process: ``fsql`` with SQL q4 over
    the bench stream as one window (its row count against ``numpy_q4``
    over the concatenated epochs), and ``nexmark run -q 4 --metrics``
    (its windows' row counts against StreamDriver's from this run, and a
    metrics report that counts its 4 windows)."""
    from flock_tpu_torch.runtime.tables import concat_relations

    size = ["-s", str(BENCH_SECONDS), "-e", str(BENCH_EPS)]
    lines = _cli_lines(["fsql", SQL_TEXTS[4], *size], "cli-fsql-q4",
                       launches, QUERY_KERNELS["cli-fsql-q4"])
    whole = concat_relations(epochs, ("auction", "bid"))
    want = len(numpy_q4(whole)["category"])
    if lines[0] != f"window ('sql',): {want} rows":
        raise AssertionError(f"fsql: {lines[0]!r}, numpy_q4 has {want} rows")
    lines = _cli_lines(["nexmark", "run", "-q", "4", *size, "--metrics"],
                       "cli-nexmark-q4", launches,
                       QUERY_KERNELS["cli-nexmark-q4"])
    want = [f"window {r.tag}: {len(r.columns['category'])} rows"
            for r in RESULTS["q4"]]
    if lines[:len(want)] != want or f"q4: {len(want)} windows" not in \
            lines[len(want)]:
        raise AssertionError(f"nexmark run: {lines[:len(want) + 1]}, the "
                             f"StreamDriver's {want}")
    if f"{'q4.windows':<20} {len(want)}" not in lines:
        raise AssertionError("nexmark run --metrics: no q4.windows line of "
                             f"{len(want)}")


def phase_sql_windows(epochs: list, gen_s: float, card_line: str,
                      launches: dict) -> None:
    """SQL q5 over hopping (10 s, hop 5) and SQL q7 over tumbling (10 s)
    windows on the 15 s epochs, through ``StreamDriver.run`` on the card:
    rows against the numpy versions and the hand plans' from this run."""
    for q, win, label in ((5, ("hopping", 10, 5), "sql-q5-hopping"),
                          (7, ("tumbling", 10), "sql-q7-tumbling")):
        from flock_tpu_torch.queries.nexmark import get_query

        spec = sql_spec(q, win)
        launches[label] = phase_stream(
            label, spec, epochs, WIN_SECONDS, BENCH_EPS, gen_s, card_line,
            numpy_fn=lambda t, q=q: numpy_query(q, t), cpu_check=False,
            depth=SQL_DEPTH)
        same_as_hand(label, RESULTS.pop(label), RESULTS[f"q{q}"],
                     spec.schema.names, get_query(q).schema.names)
        print(f"{label}: rows equal the hand plan's and the numpy "
              "version's", flush=True)


# -- the sharded executor (8 shards on the card) --------------------------------


def dist_parts(seconds: int) -> tuple:
    """(per-generator parts, the same merged per epoch, generation
    seconds): ``generate_epoch_parts(seconds, BENCH_EPS, 8)``."""
    from flock_tpu_torch.runtime.stream import generate_epoch_parts
    from flock_tpu_torch.runtime.tables import concat_relations

    t0 = time.perf_counter()
    parts = generate_epoch_parts(seconds, BENCH_EPS, DIST_GENERATORS)
    gen_s = time.perf_counter() - t0
    merged = [concat_relations(p, ("person", "auction", "bid"))
              for p in parts]
    return parts, merged, gen_s


class RowSharded:
    """Host windows row-sharded round robin over the shards (YSB, as
    tests/test_distributed.py shards it), with ``DistStreamDriver``'s
    ``run``/``prestage``; side tables (YSB's campaigns) on shard 0."""

    def __init__(self, spec, windows: list, n: int, side: tuple = ()):
        from flock_tpu_torch.parallel.executor import DistributedExecutor

        self.spec = spec
        self.executor = DistributedExecutor(spec, n, device="cuda")
        self.session_stats = None
        self.tables = [(tag, [{
            rel: (cols if rel in side and i == 0 else
                  {c: v[:0] for c, v in cols.items()} if rel in side else
                  {c: v[i::n] for c, v in cols.items()})
            for rel, cols in t.items()} for i in range(n)])
            for tag, t in windows]

    def prestage(self, _parts=None) -> list:
        ex = self.executor
        return [ex.stage(t, ex.capacities(t)) for _, t in self.tables]

    def run(self, _parts=None, prestaged=None) -> list:
        from flock_tpu_torch.runtime.executor import materialize_columns
        from flock_tpu_torch.runtime.stream import WindowResult

        return [WindowResult(tag, materialize_columns(
                    self.spec, self.executor.execute_window(
                        t, None, None if prestaged is None else prestaged[i])))
                for i, (tag, t) in enumerate(self.tables)]


def expected_launches(per_lowering: tuple, ex, n: int, names) -> dict:
    """The launches ``DIST_LAUNCHES``' (clean, fallback) counts per shard
    give for the executor's lowerings: every host sync reads one lowering,
    ``fallback_runs`` of them fallback ones."""
    clean, fallback = per_lowering
    n_clean = ex.host_syncs - ex.fallback_runs
    return {k: n * (n_clean * clean.get(k, 0)
                    + ex.fallback_runs * fallback.get(k, 0)) for k in names}


def phase_dist(label: str, make, parts, check, n: int,
               seconds: int, eps: int, gen_s: float, card_line: str,
               per_lowering: tuple | None, full: bool = True,
               escapes: bool = False) -> tuple:
    """One sharded run on the card: ``make()`` gives a fresh
    ``DistStreamDriver`` (or ``RowSharded``) whose ``run(parts)`` is the
    main path, with every launch counter at zero before it and the byte
    record on.  Each kernel's launches must equal what ``per_lowering``
    gives for the run's lowerings (``expected_launches``; the device
    session tier: one K2 per shard step with rows, its own count), exactly;
    no plain kernel version on a card tensor but a fused node's unfused
    partial (``no_plain_on_card(fused_partial=True)``);
    one host sync per window and no fallback, or with ``escapes`` every
    window rerun on the fallback; ``check(results)`` holds the rows
    (``same_windows``, ``same_sessions``).  Then 3 compute-only passes
    from ``prestage(parts)``, and
    with ``full`` one profiled pass (device events and the exact ATen
    record, which counts the launches too) and one feed-inclusive pass.
    Returns (launches, results)."""
    from flock_tpu_torch.parallel import shuffle

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    tally = []
    driver = make()
    with no_plain_on_card(fused_partial=True):
        shuffle.TALLY = tally
        try:
            t0 = time.perf_counter()
            results = driver.run(parts)
            torch.cuda.synchronize()
            first_run_s = time.perf_counter() - t0
        finally:
            shuffle.TALLY = None
    launches = {k: w.launches for k, w in wrappers.items()}
    ex, stats = driver.executor, driver.session_stats
    windows, syncs = len(results), ex.host_syncs
    if per_lowering is None:      # the device session tier
        expected = {k: 0 for k in launches}
        expected["dense_agg"] = stats["shard_steps"]
    else:
        expected = expected_launches(per_lowering, ex, n, launches)
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches}, predicted "
                             f"{expected}")
    missing = [k for k in QUERY_KERNELS[label] if not launches[k]]
    if missing:
        raise AssertionError(f"{label} did not run through {missing}")
    fallback_runs = ex.fallback_runs
    if escapes and fallback_runs < windows:
        raise AssertionError(f"{label}: {fallback_runs} fallback runs for "
                             f"{windows} windows whose keys repeat")
    if not escapes and (fallback_runs or (stats is None
                                          and syncs != windows)):
        raise AssertionError(f"{label}: {fallback_runs} fallback runs, "
                             f"{syncs} host syncs for {windows} windows")
    names = ex.spec.schema.names
    check(results)

    pre = driver.prestage(parts)
    torch.cuda.synchronize()

    def compute():
        driver.run(parts, prestaged=pre)

    best = best_s(compute)
    rec = {"query": label, "shards": n, "seconds": seconds, "eps": eps,
           "windows": windows,
           "rows_out": sum(len(r.columns[names[0]]) for r in results),
           "gen_s": gen_s, "first_run_s": first_run_s, "compute_s": best,
           "launches": launches, "fallback_runs": fallback_runs,
           "host_syncs_per_window": syncs / max(windows, 1),
           "tally_bytes_per_window": sum(
               r["bytes_per_shard"] for r in tally) / max(windows, 1),
           "collectives_per_window": len(tally) / max(windows, 1),
           "session_stats": stats, "card": card_line}
    if full:
        aten, calls = [], []
        before = {k: w.launches for k, w in wrappers.items()}

        def recorded():
            calls.append(1)
            aten[:] = dispatched_ops(compute)

        events = profile(recorded, sessions=1)
        rec.update(profile_summary(events, best * 1e3))
        rec["aten_ops"] = len(aten)
        rec["kernel_launches_per_pass"] = sum(
            w.launches - before[k] for k, w in wrappers.items()) / len(calls)
        del pre
        rec["feed_incl_s"] = best_s(lambda: make().run(parts), 1)
    print(f"{label}: " + json.dumps(rec, default=str), flush=True)
    RECORDS[label] = rec
    return launches, results


def _window_rows(results) -> list:
    return [(r.tag, r.columns) for r in results]


def same_windows(label: str, want: list):
    """A check of a sharded run: its windows' tags are ``want``'s, and each
    window's rows the same as ``want``'s (tag, host columns), as row
    sets."""
    def check(results):
        if [r.tag for r in results] != [tag for tag, _ in want]:
            raise AssertionError(f"{label}: window tags differ")
        for r, (tag, cols) in zip(results, want):
            names = list(r.columns)
            _same_row_set(r.columns, cols, names, f"{label} {tag}")
    return check


def same_sessions(label: str, want: dict, single: list):
    """A check of a sharded q11 run: the union of its emissions equals
    numpy's sessions and the single-card driver's emissions."""
    def check(results):
        got = _all_rows(results)
        _same_row_set(got, want, Q11_NAMES, f"{label}: sharded vs numpy")
        _same_row_set(got, _all_rows(single), Q11_NAMES,
                      f"{label}: sharded vs single card")
    return check


def _with_numpy(label: str, single: list, windows: list, numpy_fn,
                names) -> list:
    """The single-card driver's windows, each first held against the numpy
    version of its host tables (the seconds that takes printed)."""
    t0 = time.perf_counter()
    for (tag, cols), (wtag, tables) in zip(single, windows):
        if tag != wtag:
            raise AssertionError(f"{label}: window tags differ")
        _same_row_set(cols, numpy_fn(tables), names,
                      f"{label} {tag}: single card vs numpy")
    print(f"{label} numpy check: " + json.dumps(
        {"seconds": time.perf_counter() - t0}), flush=True)
    return single


def phase_dist_bench(parts, merged, gen_s: float, card_line: str,
                     launches: dict) -> dict:
    """q4, q9, q13, q6, q3, q0, q1, q2 and q10 (element-wise) and q11's
    device tier through ``DistStreamDriver`` over 8 shards on the bench
    epochs of 8 generators, each against the single-card ``StreamDriver``
    on the merged epochs from this run (itself against numpy); q4 also at
    1, 2 and 4 shards.  Returns q4's results by shard count."""
    from flock_tpu_torch.parallel.stream import DistStreamDriver
    from flock_tpu_torch.queries.nexmark import SESSION_GAP_S, get_query
    from flock_tpu_torch.runtime.stream import StreamDriver

    q4 = {}
    for q in (4, 9, 13, 6, 3, 0, 1, 2, 10):
        spec = get_query(q)
        single_driver = StreamDriver(spec, BENCH_SECONDS, device="cuda")
        single = _with_numpy(
            f"dist-q{q}", _window_rows(single_driver.run(merged)),
            single_driver.windows(merged), lambda t, q=q: numpy_query(q, t),
            spec.schema.names)
        launches[f"dist-q{q}"], res = phase_dist(
            f"dist-q{q}", lambda spec=spec: DistStreamDriver(
                spec, BENCH_SECONDS, DIST_SHARDS, device="cuda"),
            parts, same_windows(f"dist-q{q}", single), DIST_SHARDS,
            BENCH_SECONDS, BENCH_EPS, gen_s, card_line,
            DIST_LAUNCHES[f"q{q}"], escapes=f"q{q}" in DIST_ESCAPES)
        if q == 4:
            q4[DIST_SHARDS] = res
            for n in (1, 2, 4):
                launches[f"dist-q4-n{n}"], q4[n] = phase_dist(
                    f"dist-q4-n{n}", lambda n=n: DistStreamDriver(
                        spec, BENCH_SECONDS, n, device="cuda"),
                    parts, same_windows(f"dist-q4-n{n}", _window_rows(res)),
                    n, BENCH_SECONDS, BENCH_EPS, gen_s, card_line,
                    DIST_LAUNCHES["q4"], full=False, escapes=True)
            print("dist-q4: rows equal at 1, 2, 4 and 8 shards", flush=True)
    spec = get_query(11)
    want = numpy_q11(merged, SESSION_GAP_S, in_order=False)
    single = StreamDriver(spec, BENCH_SECONDS, device="cuda").run(merged)
    _same_row_set(_all_rows(single), want, Q11_NAMES,
                  "dist-q11: single card vs numpy")
    launches["dist-q11"], _ = phase_dist(
        "dist-q11", lambda: DistStreamDriver(spec, BENCH_SECONDS,
                                             DIST_SHARDS, device="cuda"),
        parts, same_sessions("dist-q11", want, single), DIST_SHARDS,
        BENCH_SECONDS, BENCH_EPS, gen_s, card_line, None)
    return q4


def phase_dist_clean(epochs: list, gen_s: float, card_line: str,
                     launches: dict) -> None:
    """q4, q9 and q6 over 8 shards with unique build keys: the
    one-generator bench epochs, every relation row-sharded round robin
    (the broadcast join gathers the whole build), so every window stays on
    the clean sharded lowering (K1's partial, the int64 finals on K2, q6's
    carry read as a max).  Each window's rows equal the single-card
    driver's from this run (``RESULTS``, held against numpy there)."""
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import StreamDriver

    for q in DIST_CLEAN:
        spec = get_query(q)
        label = f"dist-rr-q{q}"
        windows = StreamDriver(spec, BENCH_SECONDS, device="cpu").windows(
            epochs)
        launches[label], _ = phase_dist(
            label, lambda spec=spec, windows=windows: RowSharded(
                spec, windows, DIST_SHARDS),
            None, same_windows(label, _window_rows(RESULTS[f"q{q}"])),
            DIST_SHARDS, BENCH_SECONDS, BENCH_EPS, gen_s, card_line,
            DIST_LAUNCHES[f"q{q}"])


def phase_multihost(parts, q4_results: list, card_line: str,
                    launches: dict) -> None:
    """``MultiHostExecutor`` in a one-process NCCL group holding 4 local
    shards on the card: q4 on every bench epoch (generator p → shard
    p % 4), each window's rows equal to the in-process 4-shard run's, row
    for row; K1 and K2 launched as predicted; the group torn down after."""
    import socket

    import torch.distributed as dist

    from flock_tpu_torch.parallel.mesh import make_multihost_mesh
    from flock_tpu_torch.parallel.multihost import MultiHostExecutor
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.executor import materialize_columns
    from flock_tpu_torch.runtime.tables import concat_relations

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    spec = get_query(4)
    try:
        ex = MultiHostExecutor(spec, mesh=make_multihost_mesh(4))
        t0 = time.perf_counter()
        with no_plain_on_card(fused_partial=True):
            for epoch, want in zip(parts, q4_results):
                tables = [dict(concat_relations(
                    [p for j, p in enumerate(epoch) if j % 4 == i],
                    ("auction", "bid"))) for i in range(4)]
                got = materialize_columns(spec, ex.execute_window(tables))
                _same_rows(got, want.columns, spec.schema.names,
                           f"multihost-q4 {want.tag}: vs the 4-shard run")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    launches["multihost-q4"] = {k: w.launches for k, w in wrappers.items()}
    expected = expected_launches(DIST_LAUNCHES["q4"], ex._inner, 4, wrappers)
    if launches["multihost-q4"] != expected:
        raise AssertionError(f"multihost-q4: launches "
                             f"{launches['multihost-q4']}, predicted "
                             f"{expected}")
    print("multihost-q4: " + json.dumps({
        "processes": 1, "local_shards": 4, "backend": "nccl",
        "windows": len(parts), "run_s": run_s,
        "fallback_runs": ex._inner.fallback_runs,
        "host_syncs": ex._inner.host_syncs,
        "launches": launches["multihost-q4"], "card": card_line}),
        flush=True)


def check_hash32() -> None:
    """``hash32`` on the card bit for bit its CPU result on 4 M keys:
    int32 keys over the whole range (negative ones included) and int64
    keys beyond 2^31, alone and combined."""
    from flock_tpu_torch.parallel.shuffle import hash32

    rng = np.random.default_rng(SEED)
    n = 4_000_000
    k32 = torch.from_numpy(rng.integers(-2**31, 2**31, n).astype(np.int32))
    k64 = torch.from_numpy(rng.integers(-2**62, 2**62, n))
    k64[:4] = torch.tensor([2**31, -2**31 - 1, 2**63 - 1, -2**63])
    for what, keys in (("int32", [k32]), ("int64", [k64]),
                       ("int32+int64", [k32, k64])):
        got = hash32([k.cuda() for k in keys]).cpu()
        if not torch.equal(got, hash32(keys)):
            raise AssertionError(f"hash32 {what}: card differs from CPU")
    print(f"hash32: card = CPU on {n} int32, int64 and combined keys",
          flush=True)


def phase_dist_windowed(card_line: str, launches: dict) -> None:
    """15 s × 4 M events/s of 8 generators through ``DistStreamDriver``
    over 8 shards: q5 hopping 10/5, q7 tumbling 10, q12 over
    processing-time windows and q11's device tier, each against the
    single-card driver on the merged epochs (itself against numpy)."""
    from flock_tpu_torch.parallel.stream import DistStreamDriver
    from flock_tpu_torch.queries.nexmark import SESSION_GAP_S, get_query
    from flock_tpu_torch.runtime.stream import StreamDriver

    parts, merged, gen_s = dist_parts(WIN_SECONDS)
    for q in (5, 7, 12):
        spec = get_query(q)
        single_driver = StreamDriver(spec, WIN_SECONDS, device="cuda")
        windows = consts_path(spec, merged, WIN_SECONDS).windows \
            if q == 12 else single_driver.windows(merged)
        single = _with_numpy(
            f"dist-q{q}", _window_rows(single_driver.run(merged)), windows,
            lambda t, q=q: numpy_query(q, t), spec.schema.names)
        launches[f"dist-q{q}"], _ = phase_dist(
            f"dist-q{q}", lambda spec=spec: DistStreamDriver(
                spec, WIN_SECONDS, DIST_SHARDS, device="cuda"),
            parts, same_windows(f"dist-q{q}", single), DIST_SHARDS,
            WIN_SECONDS, BENCH_EPS, gen_s, card_line,
            DIST_LAUNCHES[f"q{q}"])
    spec = get_query(11)
    want = numpy_q11(merged, SESSION_GAP_S, in_order=False)
    single = StreamDriver(spec, WIN_SECONDS, device="cuda").run(merged)
    _same_row_set(_all_rows(single), want, Q11_NAMES,
                  "dist-q11-15s: single card vs numpy")
    launches["dist-q11-15s"], _ = phase_dist(
        "dist-q11-15s", lambda: DistStreamDriver(spec, WIN_SECONDS,
                                                 DIST_SHARDS, device="cuda"),
        parts, same_sessions("dist-q11-15s", want, single), DIST_SHARDS,
        WIN_SECONDS, BENCH_EPS, gen_s, card_line, None)


def phase_dist_ysb(card_line: str, cfg, windows, gen_s: float,
                   launches: dict) -> None:
    """YSB's windows row-sharded round robin over 8 shards (the campaigns
    on shard 0), each against ``run_ysb``'s rows from this run and
    numpy."""
    from flock_tpu_torch.queries.ysb import ysb_query

    spec = ysb_query()
    single = _with_numpy("dist-ysb", _window_rows(RESULTS["ysb"]), windows,
                         numpy_ysb, spec.schema.names)
    launches["dist-ysb"], _ = phase_dist(
        "dist-ysb", lambda: RowSharded(spec, windows, DIST_SHARDS,
                                       side=("campaign",)),
        None, same_windows("dist-ysb", single), DIST_SHARDS, cfg.seconds,
        cfg.events_per_second, gen_s, card_line, DIST_LAUNCHES["ysb"])


# -- ingestion, fragment recovery and stacked windows -------------------------


def zeroed_counters() -> dict:
    """The kernel wrappers, every launch count set to 0."""
    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def read_launches(wrappers: dict) -> dict:
    return {k: w.launches for k, w in wrappers.items()}


@contextlib.contextmanager
def recorded(cls, name: str):
    """Every call of the method ``cls.name`` inside the block, as
    (seconds, return value); the method runs as it would."""
    calls = []
    orig = getattr(cls, name)

    def call(self, *args, **kw):
        t0 = time.perf_counter()
        out = orig(self, *args, **kw)
        calls.append((time.perf_counter() - t0, out))
        return out

    setattr(cls, name, call)
    try:
        yield calls
    finally:
        setattr(cls, name, orig)


def scrambled(lines: list, seed: int, dup: int = 5) -> list:
    """Out-of-order, duplicated delivery (tests/test_ingest.py:46-53)."""
    import random

    rng = random.Random(seed)
    out = list(lines)
    rng.shuffle(out)
    for _ in range(dup):
        out.insert(rng.randrange(len(out) + 1), rng.choice(lines))
    return out


def expect_launches(label: str, got: dict, query: str, lowerings: int,
                    other: dict | None = None, fallbacks: int = 0) -> None:
    """``got`` must be ``WINDOW_LAUNCHES[query]`` times the lowerings plus
    ``WINDOW_FALLBACK_LAUNCHES[query]`` times the fallback lowerings, and
    ``other``'s (a direct or per-window run's on the same windows) where
    given."""
    extra = WINDOW_FALLBACK_LAUNCHES.get(query, {})
    want = {k: lowerings * v + fallbacks * extra.get(k, 0)
            for k, v in WINDOW_LAUNCHES[query].items()}
    if got != want or (other is not None and got != other):
        raise AssertionError(f"{label}: launches {got}, predicted {want}, "
                             f"the other run's {other}")


def _direct(spec, epochs: list, label: str) -> tuple:
    """StreamDriver.run on the card: (results, launches, seconds)."""
    from flock_tpu_torch.runtime.stream import StreamDriver

    wrappers = zeroed_counters()
    driver = StreamDriver(spec, len(epochs), device="cuda")
    with no_plain_on_card():
        t0 = time.perf_counter()
        results = driver.run(epochs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    ex = driver.executor
    if ex.fallback_runs or ex.host_syncs != len(results):
        raise AssertionError(f"{label} direct: {ex.host_syncs} syncs, "
                             f"{ex.fallback_runs} fallback runs")
    return results, read_launches(wrappers), seconds


def _ingest_checks(label: str, results, direct, epochs, numpy_fn, names,
                   ex) -> None:
    """An ingest run's windows: the direct driver's rows in order, each
    window's rows numpy's; one flag read a window, no fallback."""
    from flock_tpu_torch.runtime.tables import window_relations

    if [r.tag for r in results] != [r.tag for r in direct]:
        raise AssertionError(f"{label}: window tags differ")
    rels = window_relations(ex.spec.relations)
    for r, d, e in zip(results, direct, epochs):
        _same_rows(r.columns, d.columns, names, f"{label} {r.tag} vs direct")
        _same_row_set(r.columns, numpy_fn({k: e[k] for k in rels}), names,
                      f"{label} {r.tag} vs numpy")
    if ex.host_syncs != len(results) or ex.fallback_runs:
        raise AssertionError(f"{label}: {ex.host_syncs} host syncs, "
                             f"{ex.fallback_runs} fallback runs for "
                             f"{len(results)} windows")


def phase_ingest(card_line: str, launches: dict) -> None:
    """The external fragment stream → arena → windowed driver path on the
    card.  q4: the one-generator stream at ``INGEST_EPS``, auction and bid
    fragments of ``INGEST_GRANULE`` rows scrambled with duplicates, sent by
    ``send_fragments`` to a ``SocketIngestServer`` in another thread and
    run by ``IngestDriver``.  q3: ``produce`` (in process) writes q3's
    person and auction fragments at ``INGEST_Q3_EPS`` to a file, ``ingest
    --file`` tails it.  Each: rows equal the direct StreamDriver's on the
    same epochs (window for window, in order) and numpy's; launches equal
    the direct run's and ``WINDOW_LAUNCHES`` a window, exactly; one flag
    read a window.  Produce, assemble and execute seconds apart."""
    import tempfile
    import threading

    from flock_tpu_torch.datagen.ingest import (IngestDriver,
                                                SocketIngestServer,
                                                fragment_lines,
                                                send_fragments)
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs

    seconds = BENCH_SECONDS
    epochs = generate_epochs(seconds, INGEST_EPS, 1)
    spec = get_query(4)
    direct, direct_launches, direct_s = _direct(spec, epochs, "ingest-q4")
    t0 = time.perf_counter()
    lines = scrambled(fragment_lines(epochs, "q4", INGEST_GRANULE,
                                     ("auction", "bid")), seed=7)
    produce_s = time.perf_counter() - t0
    rows_in = sum(len(e[r]["b_date_time" if r == "bid" else "a_id"])
                  for e in epochs for r in ("auction", "bid"))
    srv = SocketIngestServer()
    wrappers = zeroed_counters()
    try:
        producer = threading.Thread(target=send_fragments,
                                    args=(srv.address, lines), daemon=True)
        t0 = time.perf_counter()
        producer.start()
        with no_plain_on_card(), executors_made() as made, \
                recorded(StreamDriver, "run") as runs:
            results = IngestDriver(spec, seconds, "q4", device="cuda").run(
                srv.lines(len(lines), timeout_s=600))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        producer.join(60)
        if producer.is_alive():
            raise AssertionError("ingest-q4: the producer did not finish")
    finally:
        srv.close()
    launches["ingest-q4"] = read_launches(wrappers)
    expect_launches("ingest-q4", launches["ingest-q4"], "q4", len(results),
                    direct_launches)
    _ingest_checks("ingest-q4", results, direct, epochs, numpy_q4,
                   spec.schema.names, made[-1])
    execute_s = runs[0][0]
    print("ingest-q4: " + json.dumps({
        "seconds": seconds, "eps": INGEST_EPS, "granule": INGEST_GRANULE,
        "fragments": len(lines), "rows_in": rows_in,
        "windows": len(results), "produce_s": produce_s,
        "transport_assemble_s": total_s - execute_s, "execute_s": execute_s,
        "direct_s": direct_s,
        "produce_rows_per_s": rows_in / produce_s,
        "assemble_rows_per_s": rows_in / (total_s - execute_s),
        "execute_rows_per_s": rows_in / execute_s,
        "launches": launches["ingest-q4"],
        "direct_launches": direct_launches,
        "host_syncs": made[-1].host_syncs,
        "fallback_runs": made[-1].fallback_runs, "card": card_line}),
        flush=True)
    del epochs, direct, results, lines

    epochs = generate_epochs(seconds, INGEST_Q3_EPS, 1)
    spec = get_query(3)
    direct, direct_launches, direct_s = _direct(spec, epochs, "ingest-q3")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "q3.jsonl")
        t0 = time.perf_counter()
        produced = _cli_lines(
            ["produce", "-q", "3", "-s", str(seconds), "-e",
             str(INGEST_Q3_EPS), "--granule", str(INGEST_GRANULE), "--file",
             path], "produce-q3", {}, ())
        produce_s = time.perf_counter() - t0
        n = int(produced[0].split()[1])
        with executors_made() as made, \
                recorded(IngestDriver, "run") as ingests, \
                recorded(StreamDriver, "run") as runs:
            t0 = time.perf_counter()
            printed = _cli_lines(
                ["ingest", "-q", "3", "-s", str(seconds), "--file", path,
                 "--lines", str(n)], "ingest-q3", launches,
                QUERY_KERNELS["ingest-q3"])
            total_s = time.perf_counter() - t0
    results = ingests[0][1]
    expect_launches("ingest-q3", launches["ingest-q3"], "q3", len(results),
                    direct_launches)
    _ingest_checks("ingest-q3", results, direct, epochs, numpy_q3,
                   spec.schema.names, made[-1])
    want = [f"window {r.tag}: {len(r.columns['a_id'])} rows" for r in direct]
    if printed[:len(want)] != want:
        raise AssertionError(f"ingest-q3 printed {printed[:len(want)]}, "
                             f"the direct run {want}")
    rows_in = sum(len(e[r][k]) for e in epochs
                  for r, k in (("person", "p_id"), ("auction", "a_id")))
    execute_s = runs[0][0]
    print("ingest-q3: " + json.dumps({
        "seconds": seconds, "eps": INGEST_Q3_EPS, "fragments": n,
        "rows_in": rows_in, "windows": len(results),
        "produce_s": produce_s,
        "tail_assemble_s": ingests[0][0] - execute_s,
        "execute_s": execute_s, "direct_s": direct_s, "cli_s": total_s,
        "assemble_rows_per_s": rows_in / (ingests[0][0] - execute_s),
        "execute_rows_per_s": rows_in / execute_s,
        "launches": launches["ingest-q3"],
        "direct_launches": direct_launches,
        "host_syncs": made[-1].host_syncs,
        "fallback_runs": made[-1].fallback_runs, "card": card_line}),
        flush=True)


def phase_recovery(epochs: list, card_line: str, launches: dict) -> None:
    """Lost-fragment recovery at the bench size (tests/test_fault_tolerance
    .py's two tests): the first bench epoch as one q4 window,
    ``to_fragments`` at ``SYNC_GRANULE`` and ``FileStateBackend.write``
    (the checkpoint), an ``Arena`` that loses one bid fragment and gets
    another twice, ``missing`` → ``backend.read`` → ``take``.  The
    recovered window runs on ``LocalExecutor`` and row-sharded round robin
    over an 8-shard ``DistributedExecutor`` on the card; both give the
    direct window's rows; a re-delivered fragment returns PROCESSED."""
    import tempfile

    from flock_tpu_torch.parallel.executor import DistributedExecutor
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.arena import Arena, WindowStatus
    from flock_tpu_torch.runtime.executor import (LocalExecutor,
                                                  materialize_columns)
    from flock_tpu_torch.runtime.payload import SYNC_GRANULE, to_fragments
    from flock_tpu_torch.runtime.state import FileStateBackend

    spec = get_query(4)
    window = {r: epochs[0][r] for r in ("auction", "bid")}
    names = spec.schema.names
    ex = LocalExecutor(spec, device="cuda")
    t0 = time.perf_counter()
    want = ex.materialize(ex.execute_window(window))
    direct_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        backend = FileStateBackend(root=root)
        t0 = time.perf_counter()
        frags = {rel: to_fragments(cols, f"recovery-{rel}")
                 for rel, cols in window.items()}
        for fs in frags.values():
            for f in fs:
                backend.write(0, f)
        write_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(root) for f in files)
        lost = len(frags["bid"]) // 2
        arena = Arena()
        for rel, fs in frags.items():
            for f in fs + fs[:1]:
                if not (rel == "bid" and f.fragment.seq_num == lost):
                    arena.collect(f)
        t0 = time.perf_counter()
        missing = arena.missing(("recovery-bid", 0))
        if missing != [lost]:
            raise AssertionError(f"recovery: missing {missing}, not [{lost}]")
        for seq in missing:
            status = arena.collect(backend.read("recovery-bid", 0, 0, seq))
        if status is not WindowStatus.READY:
            raise AssertionError(f"recovery: {status} after the read")
        tables = {rel: arena.take((f"recovery-{rel}", 0)) for rel in window}
        read_s = time.perf_counter() - t0
    if arena.collect(frags["bid"][0]) is not WindowStatus.PROCESSED:
        raise AssertionError("recovery: a re-delivered fragment was taken")
    for rel, cols in window.items():
        for k, v in cols.items():
            if not np.array_equal(tables[rel][k], v):
                raise AssertionError(f"recovery: {rel}.{k} differs")

    wrappers = zeroed_counters()
    syncs = ex.host_syncs
    with no_plain_on_card():
        t0 = time.perf_counter()
        got = ex.materialize(ex.execute_window(tables))
        local_s = time.perf_counter() - t0
    syncs = ex.host_syncs - syncs
    launches["recovery-q4"] = read_launches(wrappers)
    expect_launches("recovery-q4", launches["recovery-q4"], "q4", 1)
    _same_rows(got, want, names, "recovery-q4 vs the direct window")
    _same_row_set(got, numpy_q4(window), names, "recovery-q4 vs numpy")
    shards = [{rel: {k: v[i::DIST_SHARDS] for k, v in cols.items()}
               for rel, cols in tables.items()} for i in range(DIST_SHARDS)]
    dist = DistributedExecutor(spec, DIST_SHARDS, device="cuda")
    wrappers = zeroed_counters()
    with no_plain_on_card(fused_partial=True):
        t0 = time.perf_counter()
        got = materialize_columns(spec, dist.execute_window(shards))
        torch.cuda.synchronize()
        dist_s = time.perf_counter() - t0
    launches["recovery-dist-q4"] = read_launches(wrappers)
    expected = expected_launches(DIST_LAUNCHES["q4"], dist, DIST_SHARDS,
                                 launches["recovery-dist-q4"])
    if launches["recovery-dist-q4"] != expected or dist.fallback_runs \
            or dist.host_syncs != 1:
        raise AssertionError(f"recovery-dist-q4: launches "
                             f"{launches['recovery-dist-q4']}, predicted "
                             f"{expected}; {dist.host_syncs} syncs, "
                             f"{dist.fallback_runs} fallback runs")
    _same_row_set(got, want, names, "recovery-dist-q4 vs the direct window")
    print("recovery: " + json.dumps({
        "auction_rows": len(window["auction"]["a_id"]),
        "bid_rows": len(window["bid"]["auction"]),
        "granule": SYNC_GRANULE, "fragments": sum(map(len, frags.values())),
        "lost": missing, "checkpoint_bytes": ckpt_bytes,
        "write_s": write_s, "read_s": read_s, "local_execute_s": local_s,
        "direct_execute_s": direct_s,
        "dist_execute_s": dist_s, "launches": launches["recovery-q4"],
        "dist_launches": launches["recovery-dist-q4"],
        "host_syncs": syncs, "dist_host_syncs": dist.host_syncs,
        "fallback_runs": ex.fallback_runs + dist.fallback_runs,
        "card": card_line}), flush=True)


def _stacked_equals_per_window(label: str, ex, staged, out) -> list:
    """Window i of a stacked output equals ``execute_batches`` on window
    i, slot for slot; returns the per-window outputs' rows."""
    rows = []
    for i, w in enumerate(staged):
        one = ex.execute_batches(w)
        if not torch.equal(out.valid[i], one.valid) or any(
                not torch.equal(out.columns[c][i], t)
                for c, t in one.columns.items()):
            raise AssertionError(f"{label}: window {i} differs from "
                                 "execute_batches")
        rows.append(ex.materialize(one))
    return rows


def phase_stacked(epochs: list, card_line: str, launches: dict) -> None:
    """``execute_stacked`` over the 4 bench windows of q4 and of q9,
    staged at the driver's per-epoch capacities: one flag read for the set,
    the per-window passes' launches exactly, every window slot for slot
    ``execute_batches``' and its rows the bench run's (``RESULTS``); the
    stacked compute-only time beside the per-window pass's.  Then the G=3
    duplicates window (10 s x 350 events/s, 3 generators) between two clean
    one-generator windows of the same capacities: only it reruns on the
    fallback, and every window's rows are the per-window path's and
    numpy's."""
    from flock_tpu_torch.batch import round_up
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.executor import LocalExecutor
    from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
    from flock_tpu_torch.runtime.tables import concat_relations

    rels = ("auction", "bid")
    for q in (4, 9):
        label, spec = f"stacked-q{q}", get_query(q)
        caps = StreamDriver(spec, BENCH_SECONDS, device="cpu").epoch_caps(
            epochs)
        ex = LocalExecutor(spec, device="cuda")
        staged = [ex.prepare_window({r: e[r] for r in rels}, caps)
                  for e in epochs]
        wrappers = zeroed_counters()
        with no_plain_on_card():
            out, overflow = ex.execute_stacked(staged)
        torch.cuda.synchronize()
        launches[label] = read_launches(wrappers)
        syncs = ex.host_syncs
        wrappers = zeroed_counters()
        rows = _stacked_equals_per_window(label, ex, staged, out)
        per_window = read_launches(wrappers)
        expect_launches(label, launches[label], f"q{q}", len(staged),
                        per_window)
        if syncs != 1 or ex.fallback_runs or overflow.any():
            raise AssertionError(f"{label}: {syncs} host syncs, "
                                 f"{ex.fallback_runs} fallback runs")
        for got, res in zip(rows, RESULTS[f"q{q}"]):
            _same_rows(got, res.columns, spec.schema.names,
                       f"{label} {res.tag} vs the bench run")
        stacked_s = best_s(lambda: ex.execute_stacked(staged))
        per_window_s = best_s(lambda: [ex.execute_batches(w)
                                        for w in staged])
        print(f"{label}: " + json.dumps({
            "windows": len(staged), "caps": caps,
            "compute_ms": stacked_s * 1e3,
            "per_window_compute_ms": per_window_s * 1e3,
            "launches": launches[label],
            "per_window_launches": per_window, "host_syncs": syncs,
            "per_window_host_syncs": len(staged),
            "fallback_runs": ex.fallback_runs, "card": card_line}),
            flush=True)

    dup = concat_relations(generate_epochs(10, 350, 3), rels)
    clean = [concat_relations(generate_epochs(10, eps, 1), rels)
             for eps in (350, 700)]
    windows = [clean[0], dup, clean[1]]
    caps = {r: max(round_up(max(len(next(iter(w[r].values()))), 1), 128)
                   for w in windows) for r in rels}
    for q in (4, 9):
        label, spec = f"stacked-dup-q{q}", get_query(q)
        ex = LocalExecutor(spec, device="cuda")
        staged = [ex.prepare_window(w, caps) for w in windows]
        wrappers = zeroed_counters()
        with no_plain_on_card():
            out, overflow = ex.execute_stacked(staged)
        torch.cuda.synchronize()
        launches[label] = read_launches(wrappers)
        syncs, runs = ex.host_syncs, ex.fallback_runs
        if (syncs, runs) != (2, 1) or overflow.any():
            raise AssertionError(f"{label}: {syncs} host syncs, {runs} "
                                 "fallback runs for one escaped window")
        wrappers = zeroed_counters()
        rows = _stacked_equals_per_window(label, ex, staged, out)
        expect_launches(label, launches[label], f"q{q}", len(staged),
                        read_launches(wrappers), fallbacks=runs)
        for i, (got, w) in enumerate(zip(rows, windows)):
            _same_row_set(got, numpy_query(q, w), spec.schema.names,
                          f"{label} window {i} vs numpy")
        print(f"{label}: " + json.dumps({
            "windows": len(staged), "caps": caps,
            "launches": launches[label], "host_syncs": syncs,
            "fallback_runs": runs, "escaped": [1], "card": card_line}),
            flush=True)


def kernels_line(cases: list[dict], launches: dict[str, dict]) -> dict:
    """One entry per kernel: its cases on the main path summed, its
    launches over every query's main-path run (and per query)."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        mine = [c for c in cases if c["kernel"] == name]
        main = [c for c in mine if c["main_path"]]
        # a sum over a case the profiler missed is not measured (null)
        total = {k: None if any(c[k] is None for c in main)
                 else sum(c[k] for c in main)
                 for k in ("ms", "plain_ms", "library_ms", "kernel_device_ms",
                           "bound_ms", "bound_copy_ms")}
        by_query = {label: ln[name] for label, ln in launches.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_query.values()),
            "launches_by_query": by_query,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "exact": all(c["exact"] for c in mine),
            **total, "bound_by": "bytes"})
    return {"kernels": out}


def timed_numpy_q11(label: str, epochs: list) -> dict:
    from flock_tpu_torch.queries.nexmark import SESSION_GAP_S

    t0 = time.perf_counter()
    want = numpy_q11(epochs, SESSION_GAP_S)
    print(f"{label} numpy_q11: " + json.dumps({
        "sessions": len(want["bidder"]),
        "seconds": time.perf_counter() - t0}), flush=True)
    return want


@contextlib.contextmanager
def phase_seconds(name: str):
    """Prints the seconds the block took, as ``phase <name>: {...}``."""
    t0 = time.perf_counter()
    yield
    print(f"phase {name}: " + json.dumps(
        {"seconds": time.perf_counter() - t0}), flush=True)


def main() -> int:
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import generate_epochs

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card_line = card()
    with phase_seconds("env"):
        env = phase_env(card_line)
    with phase_seconds("kernels"):
        cases = phase_kernels(env)
    launches = {}
    inputs = {}   # the main paths' kernel calls that kernel cases take
    with phase_seconds("bench epochs"):
        t0 = time.perf_counter()
        epochs = generate_epochs(BENCH_SECONDS, BENCH_EPS, 1)
        gen_s = time.perf_counter() - t0
        for q in (4, 9, 13, 6, 0, 1, 2, 10):
            launches[f"q{q}"] = phase_stream(f"q{q}", get_query(q), epochs,
                                             BENCH_SECONDS, BENCH_EPS, gen_s,
                                             card_line, inputs=inputs)
        launches["q2-rows"] = phase_stream(
            "q2-rows",
            dataclasses.replace(get_query(2), window=("rows", ROWS_N)),
            epochs, BENCH_SECONDS, BENCH_EPS, gen_s, card_line)
    with phase_seconds("q11 bench"):
        launches["q11-bench"], _ = phase_q11(
            "q11-bench", epochs, BENCH_SECONDS, BENCH_EPS, gen_s, card_line,
            timed_numpy_q11("q11-bench", epochs), inputs)
    with phase_seconds("sql"):
        phase_sql(epochs, gen_s, card_line, launches)
        float_key_join(epochs, card_line)
        phase_cli(epochs, launches)
    with phase_seconds("dist clean"):
        phase_dist_clean(epochs, gen_s, card_line, launches)
    with phase_seconds("ingest"):
        phase_ingest(card_line, launches)
    with phase_seconds("recovery"):
        phase_recovery(epochs, card_line, launches)
    with phase_seconds("stacked"):
        phase_stacked(epochs, card_line, launches)
    RESULTS.clear()
    del epochs
    with phase_seconds("q3"):
        t0 = time.perf_counter()
        epochs = generate_epochs(BENCH_SECONDS, Q3_EPS, 1)
        gen_s = time.perf_counter() - t0
        launches["q3"] = phase_stream("q3", get_query(3), epochs,
                                      BENCH_SECONDS, Q3_EPS, gen_s, card_line)
        del epochs
    with phase_seconds("dist"):
        check_hash32()
        parts, merged, gen_s = dist_parts(BENCH_SECONDS)
        q4_by_shards = phase_dist_bench(parts, merged, gen_s, card_line,
                                        launches)
        del merged
    with phase_seconds("multihost"):
        phase_multihost(parts, q4_by_shards[4], card_line, launches)
        del parts, q4_by_shards
    with phase_seconds("windowed epochs"):
        t0 = time.perf_counter()
        epochs = generate_epochs(WIN_SECONDS, BENCH_EPS, 1)
        gen_s = time.perf_counter() - t0
        for q in (5, 7, 8):
            launches[f"q{q}"] = phase_stream(f"q{q}", get_query(q), epochs,
                                             WIN_SECONDS, BENCH_EPS, gen_s,
                                             card_line, inputs=inputs)
        for label, win, ep in (("q2-sliding", ("sliding", 4, 2), epochs),
                               ("q2-stagger", ("stagger", 3),
                                _blanked(epochs))):
            launches[label] = phase_stream(
                label, dataclasses.replace(get_query(2), window=win), ep,
                WIN_SECONDS, BENCH_EPS, gen_s, card_line)
    with phase_seconds("sql windows"):
        phase_sql_windows(epochs, gen_s, card_line, launches)
        RESULTS.clear()
    with phase_seconds("q12"):
        launches["q12"] = phase_q12(epochs, gen_s, card_line, inputs)
    with phase_seconds("q11 device tier"):
        want = timed_numpy_q11("q11", epochs)
        launches["q11"], device_results = phase_q11(
            "q11", epochs, WIN_SECONDS, BENCH_EPS, gen_s, card_line, want,
            inputs)
    with phase_seconds("q11 generic tier"):
        launches["q11-generic"], _ = phase_q11(
            "q11-generic", epochs, WIN_SECONDS, BENCH_EPS, gen_s, card_line,
            want, inputs, generic=True, cpu_check=False,
            device_results=device_results, reps=1)
    with phase_seconds("q11 resume"):
        phase_q11_resume(epochs, WIN_SECONDS, card_line, device_results)
    del epochs, want, device_results
    with phase_seconds("dist windowed"):
        phase_dist_windowed(card_line, launches)
    with phase_seconds("ysb"):
        ysb = ysb_windows()
        launches["ysb"] = phase_ysb(card_line, inputs, *ysb)
    with phase_seconds("dist ysb"):
        phase_dist_ysb(card_line, *ysb, launches)
    with phase_seconds("sql ysb"):
        launches["sql-ysb"] = phase_sql_ysb(card_line, *ysb)
        del ysb
    with phase_seconds("main-path kernel cases"):
        cases += time_cases(env, _windowed_cases(inputs))
        del inputs
        cases += time_cases(env, _k1_i64_cases())
    print(json.dumps(kernels_line(cases, launches)), flush=True)
    with phase_seconds("duplicates"):
        phase_duplicates()
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line driver — the port of ``flock_tpu/cli.py`` (the flock-cli
analogue, flock-cli/src/{main,nexmark,ysb}.rs):

  nexmark run  -q N [-s SECONDS] [-e EVENTS_PER_SEC] [-g GENERATORS]
               [--distributed] [--shards N] [--multihost [--coordinator
               HOST:PORT --num-processes P --process-id I]]
               [--show N] [--metrics] [--trace] [--sink KIND] [--device D]
  ysb run      [-s SECONDS] [-e EVENTS_PER_SEC] [-g GENERATORS] [--show N]
               [--device D]
  explain      [-q N | --sql SQL] [--dataset nexmark|ysb]
  fsql         [SQL] [--dataset nexmark|ysb] [-s] [-e] [-g] [--show N]
               [--device D]
  ingest       (--file PATH | --listen PORT) --lines N [-q N] [-s SECONDS]
               [--timeout S] [--show N] [--device D]
  produce      (--file PATH | --connect HOST:PORT) [-q N] [-s SECONDS]
               [-e EVENTS_PER_SEC] [-g GENERATORS] [--granule ROWS]
  bench        [--query N] [--seconds SECONDS] [--eps EVENTS_PER_SEC]
               [--device D]

    python -m flock_tpu_torch.cli nexmark run -q 4 -s 4 -e 4000000
    python -m flock_tpu_torch.cli nexmark run -q 4 -g 8 --distributed
    python -m flock_tpu_torch.cli bench --query 4 --seconds 4 --eps 4000000

Outputs per-window row counts and (with --show) decoded result rows, in
the reference's format.  Everything runs on the card unless ``--device
cpu`` is given (where the reference honours ``JAX_PLATFORMS``); without a
card and without it, every subcommand that runs a query raises.
``--distributed`` runs the sharded driver over ``--shards`` shards (on one
card all of them on it); ``--multihost`` runs one window over the shards
of every process (``--shards`` in all, split evenly), each process
generating only its own partitions.  ``produce`` writes a query's
generated relations as fragment lines to a file or a socket, and
``ingest`` runs the query over such a stream (a tailed file or a TCP
listener), on the card unless ``--device cpu``.  ``bench`` runs the
port's benchmark harness (``flock_tpu_torch.tools.bench``) for one query
and prints its metric line, as the reference's runs its JAX harness.
"""

from __future__ import annotations

import argparse
import sys
import time

from flock_tpu_torch import resolve_device


def _print_window(tag, cols, schema, show: int):
    n = len(next(iter(cols.values()))) if cols else 0
    print(f"window {tag}: {n} rows")
    if show and n:
        decoded = schema.decode(cols)
        names = schema.names
        head = {k: decoded[k][:show] for k in names}
        for i in range(min(show, n)):
            print("  ", {k: head[k][i] for k in names})


def cmd_nexmark(args) -> int:
    from flock_tpu_torch.queries.nexmark import QUERIES, get_query
    from flock_tpu_torch.runtime.sink import make_sink
    from flock_tpu_torch.runtime.stream import run_nexmark
    from flock_tpu_torch.utils.metrics import METRICS, device_trace, trace_dir

    if args.query not in QUERIES:
        print(f"error: unknown query q{args.query} "
              f"(available: {sorted(QUERIES)})", file=sys.stderr)
        return 2
    sink = make_sink(args.sink) if args.sink else None
    t0 = time.perf_counter()
    spec = get_query(args.query)
    name = f"nexmark_q{args.query}"
    if args.trace:
        print(f"profiler trace → {trace_dir(name)}")
    if args.multihost:
        with device_trace(name, enabled=args.trace):
            rc = _run_nexmark_multihost(args, spec, sink)
        print(f"elapsed: {time.perf_counter() - t0:.2f}s")
        if args.metrics:
            print(METRICS.report())
        return rc
    with device_trace(name, enabled=args.trace):
        if args.distributed:
            from flock_tpu_torch.parallel.stream import DistStreamDriver
            from flock_tpu_torch.runtime.stream import generate_epoch_parts

            parts = generate_epoch_parts(args.seconds, args.eps,
                                         args.generators)
            results = DistStreamDriver(spec, args.seconds, args.shards,
                                       device=args.device).run(parts)
        else:
            results = run_nexmark(args.query, args.seconds, args.eps,
                                  args.generators, device=args.device)
    total = 0
    for r in results:
        total += len(next(iter(r.columns.values()))) if r.columns else 0
        _print_window(r.tag, r.columns, spec.schema, args.show)
        if sink:
            sink.write(r.tag, r.columns, spec.schema)
    if args.distributed:
        print(f"q{args.query} distributed×{args.shards}: {len(results)} "
              f"windows, {total} output rows")
    else:
        print(f"q{args.query}: {len(results)} windows, {total} output rows")
        if sink:
            print(f"sink[{args.sink}]: {sink.read()}")
    print(f"elapsed: {time.perf_counter() - t0:.2f}s")
    if args.metrics:
        print(METRICS.report())
    return 0


def _run_nexmark_multihost(args, spec, sink) -> int:
    """One window over every shard of every process; each process
    generates ONLY the generator partitions its shards own (the
    reference's one-command-per-host deployment).  The whole run executes
    as one window; process 0 prints it.  The process group is made here
    (gloo on the CPU, NCCL on the card) and torn down after."""
    import torch.distributed as dist

    from flock_tpu_torch.datagen.native_gen import nexmark_generate_partition
    from flock_tpu_torch.datagen.nexmark import NexmarkConfig
    from flock_tpu_torch.parallel.mesh import make_multihost_mesh
    from flock_tpu_torch.parallel.multihost import (MultiHostExecutor,
                                                    init_distributed,
                                                    local_partition_ids)
    from flock_tpu_torch.runtime.executor import materialize_columns
    from flock_tpu_torch.runtime.tables import (concat_relations,
                                                default_side_input,
                                                epoch_to_relations,
                                                window_relations)

    if spec.window[0] in ("session", "global"):
        print("error: --multihost supports range/elementwise windows "
              "(session/processing-time bookkeeping is single-host for now)",
              file=sys.stderr)
        return 2
    rank, world = init_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend="gloo" if args.device.type == "cpu" else "nccl")
    try:
        mesh = make_multihost_mesh(max(args.shards // world, 1), args.device)
        n_shards = mesh.n_shards
        gens = max(args.generators, n_shards)
        cfg = NexmarkConfig(events_per_second=args.eps,
                            num_event_generators=gens)
        rels = window_relations(spec.relations)
        ex = MultiHostExecutor(spec, mesh=mesh)
        per_shard = {s: [] for s in ex.local_shards}
        for p in local_partition_ids(gens, mesh):
            for e in nexmark_generate_partition(cfg, args.seconds, p):
                if e.epoch < args.seconds:
                    per_shard[p % n_shards].append(epoch_to_relations(e))
        local_tables = []
        for s in ex.local_shards:
            st = dict(concat_relations(per_shard[s], rels))
            if "side_input" in spec.relations:
                si = default_side_input()
                st["side_input"] = si if s == 0 else \
                    {k: v[:0] for k, v in si.items()}
            local_tables.append(st)
        cols = materialize_columns(spec, ex.execute_window(local_tables))
    finally:
        dist.destroy_process_group()
    n = len(next(iter(cols.values()))) if cols else 0
    if rank == 0:
        tag = ("multihost", 0, args.seconds)
        _print_window(tag, cols, spec.schema, args.show)
        if sink:
            sink.write(tag, cols, spec.schema)
        print(f"q{args.query} multihost: {world} process(es) × "
              f"{n_shards} shards, {n} output rows")
    return 0


def cmd_explain(args) -> int:
    """Show a query's stage DAG (the reference's EXPLAIN)."""
    from flock_tpu_torch.planner import plan_query_stages

    if args.sql:
        from flock_tpu_torch.sql.catalog import nexmark_catalog, ysb_catalog
        from flock_tpu_torch.sql.lower import sql_to_spec

        cat = ysb_catalog() if args.dataset == "ysb" else nexmark_catalog()
        spec = sql_to_spec(args.sql, cat)
        print(f"-- SQL plan ({args.dataset})")
    else:
        from flock_tpu_torch.queries.nexmark import QUERIES, get_query

        if args.query not in QUERIES:
            print(f"error: unknown query q{args.query}", file=sys.stderr)
            return 2
        spec = get_query(args.query)
        print(f"-- q{args.query} (window={spec.window})")
    print(plan_query_stages(spec.plan).explain())
    return 0


def cmd_ysb(args) -> int:
    from flock_tpu_torch.datagen.ysb import YsbConfig
    from flock_tpu_torch.queries.ysb import run_ysb, ysb_query

    t0 = time.perf_counter()
    cfg = YsbConfig(seconds=args.seconds, events_per_second=args.eps,
                    threads=args.generators)
    results = run_ysb(cfg, device=args.device)
    spec = ysb_query()
    for r in results:
        _print_window(r.tag, r.columns, spec.schema, args.show)
    print(f"ysb: {len(results)} windows; elapsed {time.perf_counter()-t0:.2f}s")
    return 0


def cmd_fsql(args) -> int:
    """Run SQL over generated NEXMark (or YSB) data, one window of the
    whole stream — the fsql REPL analogue (flock-cli/src/fsql.rs)."""
    import numpy as np

    from flock_tpu_torch.runtime.executor import LocalExecutor
    from flock_tpu_torch.runtime.stream import generate_epochs
    from flock_tpu_torch.runtime.tables import (concat_relations,
                                                default_side_input)
    from flock_tpu_torch.sql.catalog import nexmark_catalog, ysb_catalog
    from flock_tpu_torch.sql.lower import sql_to_spec

    if args.dataset == "nexmark":
        catalog = nexmark_catalog()
        epochs = generate_epochs(args.seconds, args.eps, args.generators)
        window = concat_relations(epochs, ("person", "auction", "bid"))
        window["side_input"] = default_side_input()
    else:
        from flock_tpu_torch.datagen.ysb import YsbConfig
        from flock_tpu_torch.queries.ysb import (campaign_table,
                                                 generate_ysb_epochs)

        catalog = ysb_catalog()
        cfg = YsbConfig(seconds=args.seconds, events_per_second=args.eps,
                        threads=args.generators)
        ys = generate_ysb_epochs(cfg)
        window = {
            "ad_event": {k: np.concatenate([e["ad_event"][k] for e in ys])
                         for k in ys[0]["ad_event"]},
            "campaign": campaign_table(cfg),
        }

    def run_one(sql: str):
        t0 = time.perf_counter()
        spec = sql_to_spec(sql, catalog)
        ex = LocalExecutor(spec, device=args.device,
                           side_input=window.get("side_input"))
        tables = {r: window[r] for r in spec.relations if r != "side_input"}
        out = ex.materialize(ex.execute_window(tables))
        n = len(next(iter(out.values()))) if out else 0
        _print_window(("sql",), out, spec.schema, args.show or 10)
        print(f"{n} rows in {time.perf_counter() - t0:.2f}s")

    if args.query:
        run_one(args.query)
        return 0
    import readline  # noqa: F401  (history/line editing)

    print(f"fsql — {args.dataset} tables loaded "
          f"({args.seconds}s × {args.eps} events/s). Ctrl-D to exit.")
    while True:
        try:
            line = input("fsql> ").strip()
        except EOFError:
            print()
            return 0
        if not line:
            continue
        try:
            run_one(line)
        except Exception as e:  # noqa: BLE001
            print(f"error: {e}")


def cmd_ingest(args) -> int:
    """Run a query over an EXTERNAL fragment stream (the kafka-trigger
    ingestion analogue, datasource/kafka.rs): fragments arrive as line JSON
    over a TCP socket or an append-only file, reassemble through the arena,
    and the windowed driver executes epochs as they complete."""
    from flock_tpu_torch.datagen.ingest import (FileTailSource, IngestDriver,
                                                SocketIngestServer)
    from flock_tpu_torch.queries.nexmark import get_query

    if (args.file is None) == (args.listen is None):
        print("error: pass exactly one of --file or --listen",
              file=sys.stderr)
        return 2
    spec = get_query(args.query)
    driver = IngestDriver(spec, args.seconds, f"q{args.query}",
                          device=args.device)
    t0 = time.perf_counter()
    if args.listen is not None:
        srv = SocketIngestServer(port=args.listen)
        try:
            host, port = srv.address
            print(f"listening on {host}:{port} for {args.lines} fragments",
                  flush=True)
            results = driver.run(srv.lines(args.lines, timeout_s=args.timeout))
        finally:
            srv.close()
    else:
        results = driver.run(FileTailSource(args.file, n_lines=args.lines,
                                            timeout_s=args.timeout))
    total = 0
    for r in results:
        total += len(next(iter(r.columns.values()))) if r.columns else 0
        _print_window(r.tag, r.columns, spec.schema, args.show)
    print(f"q{args.query} ingest: {len(results)} windows, {total} output "
          f"rows; elapsed {time.perf_counter() - t0:.2f}s")
    return 0


def cmd_produce(args) -> int:
    """Produce a fragment stream from the generator (the source-function
    side): write line-JSON fragments to a file or a socket endpoint."""
    from flock_tpu_torch.datagen.ingest import fragment_lines, send_fragments
    from flock_tpu_torch.queries.nexmark import get_query
    from flock_tpu_torch.runtime.stream import generate_epochs
    from flock_tpu_torch.runtime.tables import window_relations

    spec = get_query(args.query)
    epochs = generate_epochs(args.seconds, args.eps, args.generators)
    lines = fragment_lines(epochs, f"q{args.query}", granule=args.granule,
                           relations=window_relations(spec.relations))
    if args.connect:
        host, _, port = args.connect.rpartition(":")
        send_fragments((host or "127.0.0.1", int(port)), lines)
        print(f"sent {len(lines)} fragments to {args.connect}")
    else:
        with open(args.file, "a") as f:
            for line in lines:
                f.write(line + "\n")
        print(f"appended {len(lines)} fragments to {args.file}")
    return 0


def cmd_bench(args) -> int:
    from flock_tpu_torch.tools import bench

    return bench.main(["--query", str(args.query), "--seconds",
                       str(args.seconds), "--eps", str(args.eps),
                       "--device", str(args.device)])


def main(argv=None) -> int:
    from flock_tpu_torch.config import CONFIG

    ap = argparse.ArgumentParser(prog="flock-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=None,
                     help="cuda (the default) or cpu (the plain PyTorch "
                     "path)")

    nm = sub.add_parser("nexmark")
    nm_sub = nm.add_subparsers(dest="sub", required=True)
    nr = nm_sub.add_parser("run", parents=[dev])
    nr.add_argument("-q", "--query", type=int, required=True)
    nr.add_argument("-s", "--seconds", type=int, default=4)
    nr.add_argument("-e", "--eps", type=int, default=10_000)
    nr.add_argument("-g", "--generators", type=int, default=1)
    nr.add_argument("--distributed", action="store_true")
    nr.add_argument("--multihost", action="store_true",
                    help="run ONE window over every process's shards (the "
                    "same command in every process; --coordinator or "
                    "torch's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK wire "
                    "the processes together)")
    nr.add_argument("--coordinator", default=None,
                    help="host:port of process 0")
    nr.add_argument("--num-processes", type=int, default=None)
    nr.add_argument("--process-id", type=int, default=None)
    nr.add_argument("--shards", type=int, default=CONFIG.target_partitions)
    nr.add_argument("--show", type=int, default=0)
    nr.add_argument("--metrics", action="store_true",
                    help="print the per-query metrics registry after the run")
    nr.add_argument("--trace", action="store_true",
                    help="write a torch.profiler Chrome trace of the run to "
                    "<tempdir>/flock_tpu_torch_trace/")
    nr.add_argument("--sink", choices=["blackhole", "memory", "file"],
                    default=None)
    nr.set_defaults(fn=cmd_nexmark)

    yb = sub.add_parser("ysb")
    yb_sub = yb.add_subparsers(dest="sub", required=True)
    yr = yb_sub.add_parser("run", parents=[dev])
    yr.add_argument("-s", "--seconds", type=int, default=20)
    yr.add_argument("-e", "--eps", type=int, default=10_000)
    yr.add_argument("-g", "--generators", type=int, default=1)
    yr.add_argument("--show", type=int, default=0)
    yr.set_defaults(fn=cmd_ysb)

    ex = sub.add_parser("explain")
    ex.add_argument("-q", "--query", type=int, default=4)
    ex.add_argument("--sql", default=None)
    ex.add_argument("--dataset", choices=["nexmark", "ysb"], default="nexmark")
    ex.set_defaults(fn=cmd_explain, device="cpu")

    fq = sub.add_parser("fsql", parents=[dev])
    fq.add_argument("query", nargs="?", default=None,
                    help="one-shot SQL; omit for a REPL")
    fq.add_argument("--dataset", choices=["nexmark", "ysb"], default="nexmark")
    fq.add_argument("-s", "--seconds", type=int, default=2)
    fq.add_argument("-e", "--eps", type=int, default=5_000)
    fq.add_argument("-g", "--generators", type=int, default=1)
    fq.add_argument("--show", type=int, default=0)
    fq.set_defaults(fn=cmd_fsql)

    be = sub.add_parser("bench", parents=[dev])
    be.add_argument("--query", type=int, default=4)
    be.add_argument("--seconds", type=int, default=4)
    be.add_argument("--eps", type=int, default=1_000_000)
    be.set_defaults(fn=cmd_bench)

    ig = sub.add_parser("ingest", parents=[dev],
                        help="run a query over an external fragment stream "
                        "(socket or tailed file)")
    ig.add_argument("-q", "--query", type=int, default=2)
    ig.add_argument("-s", "--seconds", type=int, default=2)
    ig.add_argument("--file", default=None, help="tail this fragment log")
    ig.add_argument("--listen", type=int, default=None,
                    help="TCP port to listen on (0 = ephemeral)")
    ig.add_argument("--lines", type=int, required=True,
                    help="number of fragment lines to consume")
    ig.add_argument("--timeout", type=float, default=60.0)
    ig.add_argument("--show", type=int, default=0)
    ig.set_defaults(fn=cmd_ingest)

    pr = sub.add_parser("produce", help="emit generator fragments to a "
                        "file or socket (the source-function side)")
    pr.add_argument("-q", "--query", type=int, default=2)
    pr.add_argument("-s", "--seconds", type=int, default=2)
    pr.add_argument("-e", "--eps", type=int, default=1_000)
    pr.add_argument("-g", "--generators", type=int, default=1)
    pr.add_argument("--granule", type=int, default=1024)
    pr.add_argument("--file", default=None)
    pr.add_argument("--connect", default=None, help="HOST:PORT to send to")
    pr.set_defaults(fn=cmd_produce, device="cpu")

    args = ap.parse_args(argv)
    # before any data is made (and outside fsql's REPL error handler): no
    # card and no --device cpu raises (explain and produce run no query:
    # plain Python)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

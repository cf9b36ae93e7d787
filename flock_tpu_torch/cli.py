"""Command-line driver — the port of ``flock_tpu/cli.py``'s single-device
subcommands (the flock-cli analogue, flock-cli/src/{main,nexmark,ysb}.rs):

  nexmark run  -q N [-s SECONDS] [-e EVENTS_PER_SEC] [-g GENERATORS]
               [--show N] [--metrics] [--trace] [--sink KIND] [--device D]
  ysb run      [-s SECONDS] [-e EVENTS_PER_SEC] [-g GENERATORS] [--show N]
               [--device D]
  fsql         [SQL] [--dataset nexmark|ysb] [-s] [-e] [-g] [--show N]
               [--device D]

    python -m flock_tpu_torch.cli nexmark run -q 4 -s 4 -e 4000000

Outputs per-window row counts and (with --show) decoded result rows, in
the reference's format.  Everything runs on the card unless ``--device
cpu`` is given (where the reference honours ``JAX_PLATFORMS``); without a
card and without it, every subcommand raises.  The reference's
``--distributed``/``--multihost`` flags and its ``explain``, ``bench``,
``ingest`` and ``produce`` subcommands come with the modules they need
(the sharded executor, the planner, ingestion), so argparse refuses them
until then.
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
    with device_trace(name, enabled=args.trace):
        results = run_nexmark(args.query, args.seconds, args.eps,
                              args.generators, device=args.device)
    total = 0
    for r in results:
        total += len(next(iter(r.columns.values()))) if r.columns else 0
        _print_window(r.tag, r.columns, spec.schema, args.show)
        if sink:
            sink.write(r.tag, r.columns, spec.schema)
    print(f"q{args.query}: {len(results)} windows, {total} output rows")
    if sink:
        print(f"sink[{args.sink}]: {sink.read()}")
    print(f"elapsed: {time.perf_counter() - t0:.2f}s")
    if args.metrics:
        print(METRICS.report())
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


def main(argv=None) -> int:
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

    fq = sub.add_parser("fsql", parents=[dev])
    fq.add_argument("query", nargs="?", default=None,
                    help="one-shot SQL; omit for a REPL")
    fq.add_argument("--dataset", choices=["nexmark", "ysb"], default="nexmark")
    fq.add_argument("-s", "--seconds", type=int, default=2)
    fq.add_argument("-e", "--eps", type=int, default=5_000)
    fq.add_argument("-g", "--generators", type=int, default=1)
    fq.add_argument("--show", type=int, default=0)
    fq.set_defaults(fn=cmd_fsql)

    args = ap.parse_args(argv)
    # before any data is made (and outside fsql's REPL error handler): no
    # card and no --device cpu raises
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

"""The control of the comparison that decides ``correct``: the reference,
put in the program's place, over windows whose events are each delivered
twice (the configuration's exactly-once delivery broken), compared by the
same rule and limits as a run.  It has to come out as not correct.  A
query whose answer a replay leaves as it was (q4's maxima and their
average) names its own control in its reference module:
``control(tables, config)``, the reference with one stated guarantee
broken, such as its average computed in the next precision below.

    python3 -m flockbench.control --workload NAME --seeds N [N ...]

prints, for each seed, the numbers compared beside their limits and whether
the control came out correct, and exits 1 if any seed's did.  It runs at the
cell's own size; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from flockbench.compare import checks, correct, replayed, rows_unequal
from flockbench.run import Cell, load_cell, make_ring, window_tables


def control_checks(cell: Cell, seed: int) -> dict:
    """The numbers a run compares, with the control's rows in place of the
    program's: one output per distinct window of the cell's ring."""
    epochs, _, windows = make_ring(cell, seed)
    ref = cell.reference()
    control = getattr(ref, "control", None) or \
        (lambda tables, config: ref.reference(replayed(tables), config))
    rows = unequal = 0
    for rng, _ in windows:
        tables = window_tables(epochs, rng)
        d = rows_unequal(control(tables, cell.config),
                         ref.reference(tables, cell.config))
        rows += d
        unequal += d > 0
    compared = checks(0, unequal, rows)
    return {"seed": seed, "correct": correct(compared), "checks": compared}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flockbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    any_correct = False
    for seed in args.seeds:
        got = control_checks(cell, seed)
        any_correct |= got["correct"]
        print(json.dumps({"workload": cell.name, **got}), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())

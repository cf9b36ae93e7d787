"""Test utilities — copy of ``flock_tpu/utils/testing.py``, the
assert_batches_eq / pretty printing analogues (flock/src/test_util.rs:32-84)."""

from __future__ import annotations

import numpy as np


def sorted_rows(cols: dict, names: list[str]) -> list[tuple]:
    arrays = [np.asarray(cols[n]) for n in names]
    if not arrays or not len(arrays[0]):
        return []
    return sorted(zip(*(a.tolist() for a in arrays)))


def assert_columns_equal(got: dict, want: dict, names: list[str],
                         msg: str = "") -> None:
    """Sorted multiset row compare (assert_batches_sorted_eq! analogue)."""
    g, w = sorted_rows(got, names), sorted_rows(want, names)
    if g != w:
        raise AssertionError(
            f"{msg} row mismatch: {len(g)} vs {len(w)} rows\n"
            f"got head:  {g[:5]}\nwant head: {w[:5]}")


def pretty_format(cols: dict, names: list[str], limit: int = 20) -> str:
    """ASCII table rendering (pretty_format_batches analogue)."""
    n = len(next(iter(cols.values()))) if cols else 0
    widths = {c: max(len(c), *(len(str(cols[c][i])) for i in range(min(n, limit)))
                     ) if n else len(c) for c in names}
    sep = "+" + "+".join("-" * (widths[c] + 2) for c in names) + "+"
    lines = [sep,
             "|" + "|".join(f" {c:<{widths[c]}} " for c in names) + "|",
             sep]
    for i in range(min(n, limit)):
        lines.append("|" + "|".join(
            f" {str(cols[c][i]):<{widths[c]}} " for c in names) + "|")
    lines.append(sep)
    if n > limit:
        lines.append(f"… {n - limit} more rows")
    return "\n".join(lines)

"""The comparison that decides ``correct``, and its control.

A window's rows are compared with the reference's as multisets of rows,
over the columns the reference returns, each value exactly: an integer
column as an int64, a float column (where either side's is one) by the
bits of its f64 value, so that an average the sink divides from exact
sums reads unequal at its last bit.  ``rows_unequal`` counts the rows that
one side has and the other lacks, so an exact match reads 0.

The control breaks the configuration's delivery guarantee, exactly-once
windows: it is the reference, put in the program's place, over a window
whose events are each delivered twice (at-least-once delivery, a whole
replay left undeduplicated).
"""

from __future__ import annotations

import numpy as np


def _exact(v, as_float: bool) -> np.ndarray:
    """A column's values as int64s that are equal where the values are:
    an f64's bits, or the integer."""
    if as_float:
        return np.asarray(v, np.float64).view(np.int64)
    return np.asarray(v).astype(np.int64)


def _rows(cols: dict, names: list[str], floats: set) -> np.ndarray:
    n = len(cols[names[0]]) if names else 0
    if not n:
        return np.empty((0, len(names)), np.int64)
    return np.stack([_exact(cols[c], c in floats) for c in names], 1)


def rows_unequal(got: dict | None, want: dict) -> int:
    """Rows in one multiset and not the other (0 when the row sets are
    equal); every wanted row when ``got`` is missing or lacks a column."""
    names = sorted(want)
    floats = {c for c in names if np.asarray(want[c]).dtype.kind == "f"
              or got is not None and c in got
              and np.asarray(got[c]).dtype.kind == "f"}
    b = _rows(want, names, floats)
    if got is None or any(c not in got for c in names):
        return len(b) + (len(next(iter(got.values()))) if got else 0)
    a = _rows(got, names, floats)
    if not len(a) and not len(b):
        return 0
    both = np.concatenate([a, b])
    sign = np.concatenate([np.ones(len(a), np.int64),
                           -np.ones(len(b), np.int64)])
    _, inv = np.unique(both, axis=0, return_inverse=True)
    net = np.zeros(int(inv.max()) + 1, np.int64)
    np.add.at(net, inv.reshape(-1), sign)
    return int(np.abs(net).sum())


def checks(raised: int, windows_unequal: int, rows: int) -> dict:
    """The numbers a run compares, each beside its limit (0: exact)."""
    return {"windows_raised": {"value": raised, "limit": 0},
            "windows_unequal": {"value": windows_unequal, "limit": 0},
            "rows_unequal": {"value": rows, "limit": 0}}


def correct(compared: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())


def replayed(tables: dict) -> dict:
    """The window's tables with every event delivered twice; static tables
    (YSB's campaign table) once."""
    return {rel: cols if rel == "campaign" else
            {c: np.concatenate([v, v]) for c, v in cols.items()}
            for rel, cols in tables.items()}

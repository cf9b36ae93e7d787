"""The comparison that decides ``correct``: float columns by the bits of
their f64 values, integer columns as int64s, as they were compared
before."""

from collections import Counter

import numpy as np
import pytest

from fbhelp import CELLS, tiny_cell
from flockbench.compare import rows_unequal
from flockbench.run import make_ring, window_tables


def _as_int64(got, want):
    """The rule integer columns were compared by before float columns had
    their own: every column cast to int64, rows as multisets."""
    def rows(cols):
        return Counter(zip(*(np.asarray(cols[c]).astype(np.int64).tolist()
                             for c in sorted(want))))

    a, b = rows(got), rows(want)
    return sum(((a - b) + (b - a)).values())


def test_averages_that_differ_after_the_point_are_unequal():
    want = {"category": np.array([10, 11]),
            "avg_final": np.array([2.0, 7.25])}
    got = {"category": np.array([10, 11]),
           "avg_final": np.array([2.5, 7.25])}
    assert rows_unequal(got, want) == 2
    last_bit = dict(got, avg_final=np.array([2.0, np.nextafter(7.25, 8)]))
    assert rows_unequal(last_bit, want) == 2
    assert rows_unequal({k: v.copy() for k, v in want.items()}, want) == 0
    # a float32 average that rounds is not the f64 one
    f32 = dict(want, avg_final=np.array([2.0, 7.1], np.float32))
    assert rows_unequal(f32, dict(want, avg_final=np.array([2.0, 7.1]))) == 2


def test_a_float_on_the_programs_side_is_not_truncated():
    want = {"k": np.array([1, 2]), "v": np.array([3, 4])}
    assert rows_unequal({"k": np.array([1, 2]),
                         "v": np.array([3.5, 4.0])}, want) == 2


@pytest.mark.parametrize("name", CELLS)
def test_integer_cells_compare_as_before(name):
    """YSB's, q5's and q7's columns are integers: every row set and every
    perturbation of it counts as it did under the int64 cast."""
    cell = tiny_cell(name)
    epochs, _, windows = make_ring(cell, 2**31 + 3)
    ref = cell.reference()
    for rng, _ in windows:
        want = ref.reference(window_tables(epochs, rng), cell.config)
        assert all(np.asarray(v).dtype.kind in "iu" for v in want.values())
        first = next(iter(want))
        bumped = dict(want, **{first: want[first] + np.arange(
            len(want[first])) % 2})
        dropped = {c: v[1:] for c, v in want.items()}
        for got in (want, bumped, dropped):
            assert rows_unequal(got, want) == _as_int64(got, want)

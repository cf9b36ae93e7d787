"""The control of the comparison comes out as not correct: the reference
in the program's place, over windows whose events are each delivered twice
(exactly-once broken), on three seeds, at a size a test run holds.  On the
card the same control runs at the cells' own sizes
(``python3 -m flockbench.control``)."""

import pytest

from fbhelp import CELLS, Q4_JOIN, added_cell, tiny_cell
from flockbench.control import control_checks


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 4_000_000_007])
def test_control_is_not_correct(name, seed):
    got = control_checks(tiny_cell(name), seed)
    assert got["correct"] is False
    assert got["checks"]["rows_unequal"]["value"] > 0
    assert got["checks"]["windows_unequal"]["value"] == 2


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 4_000_000_007])
def test_the_join_cells_control_is_not_correct(tmp_path, seed):
    """q4's own control (its average divided in f32) comes out as not
    correct, where a replay of the window's events would not: q4's maxima
    and their average are the same over every event delivered twice."""
    from flockbench.compare import replayed, rows_unequal
    from flockbench.run import make_ring, window_tables

    cell = added_cell(tmp_path, Q4_JOIN)
    got = control_checks(cell, seed)
    assert got["correct"] is False
    assert got["checks"]["windows_unequal"]["value"] == Q4_JOIN["ring_epochs"]
    epochs, _, windows = make_ring(cell, seed)
    ref = cell.reference()
    for rng, _ in windows:
        tables = window_tables(epochs, rng)
        assert rows_unequal(ref.reference(replayed(tables), cell.config),
                            ref.reference(tables, cell.config)) == 0

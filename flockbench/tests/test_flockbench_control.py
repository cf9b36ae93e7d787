"""The control of the comparison comes out as not correct: the reference
in the program's place, over windows whose events are each delivered twice
(exactly-once broken), on three seeds, at a size a test run holds.  On the
card the same control runs at the cells' own sizes
(``python3 -m flockbench.control``)."""

import pytest

from fbhelp import CELLS, tiny_cell
from flockbench.control import control_checks


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 4_000_000_007])
def test_control_is_not_correct(name, seed):
    got = control_checks(tiny_cell(name), seed)
    assert got["correct"] is False
    assert got["checks"]["rows_unequal"]["value"] > 0
    assert got["checks"]["windows_unequal"]["value"] == 2

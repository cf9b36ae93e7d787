"""On the card: each cell at a small rate through the whole run, traced,
with every metric it lists read (run these with
``python3 -m pytest flockbench/tests -m cuda`` on a machine with a card)."""

import pytest

from fbhelp import CELLS, tiny_cell
from flockbench.run import run_cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cell = tiny_cell(name, eps=1_000_000)
    line, notes, _ = run_cell(cell, 2**31 + 3, 1.0, True, device=card)
    assert line["correct"] is True
    assert {m["name"] for m in cell.per_layer} == set(line["metrics"])
    share = line["metrics"]["kernel_roofline"]["value"]
    assert 0 < share <= 100
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert notes["h2d_bytes_in_stretch"] < 1 << 20

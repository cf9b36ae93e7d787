"""A run with the timed path broken underneath comes out as not correct:
the harness's look for a card skipped, the rest of a run driven on the CPU
at a tiny size, once for each fault a one-card cell can have:

* ``stale``: the window step returns the state it had (every window
  answers with the ring's first window's output);
* ``half``: half of each window's rows left out (every other row's
  ``valid`` cleared).  q7's answer is the window's highest bids alone, so
  it changes, and the run is not correct, only where a highest bid is among
  the rows left out: the test holds each run to exactly that;
* ``altered``: one answer altered where it is produced (the sink's first
  row).

The join cell added by new files alone (q4 over element-wise windows,
``fbhelp.added_cell``) is held to ``stale`` and ``altered`` too, and to
``winner``: one winning bid dropped from each window's input (the highest
bid that falls inside its auction's run), so that its auction's winning
price, and its category's average, change.

(The exchange between cards is no fault of a one-card cell.)"""

import numpy as np
import pytest
import torch

from fbhelp import CELLS, Q4_JOIN, added_cell, tiny_cell
from flock_tpu_torch.batch import Batch
from flock_tpu_torch.runtime.executor import LocalExecutor
from flockbench.run import run_cell


def _stale(monkeypatch):
    orig = LocalExecutor.execute_epochs
    first = {}

    def execute_epochs(self, epoch_tables, check_overflow=True):
        out = orig(self, epoch_tables, check_overflow)
        return first.setdefault("out", out)

    monkeypatch.setattr(LocalExecutor, "execute_epochs", execute_epochs)


def _half(monkeypatch):
    orig = LocalExecutor.execute_epochs

    def execute_epochs(self, epoch_tables, check_overflow=True):
        cut = []
        for et in epoch_tables:
            cut.append({r: b if r == "campaign" else
                        Batch(b.columns, b.valid & (torch.arange(
                            b.capacity) % 2 == 0))
                        for r, b in et.items()})
        return orig(self, cut, check_overflow)

    monkeypatch.setattr(LocalExecutor, "execute_epochs", execute_epochs)


def _altered(monkeypatch):
    orig = LocalExecutor.materialize

    def materialize(self, out):
        rows = orig(self, out)
        last = list(rows)[-1]
        rows[last] = rows[last].copy()
        rows[last][:1] += 1
        return rows

    monkeypatch.setattr(LocalExecutor, "materialize", materialize)


def _winner(monkeypatch):
    orig = LocalExecutor.execute_epochs

    def execute_epochs(self, epoch_tables, check_overflow=True):
        cut = []
        for et in epoch_tables:
            auc, bid = et["auction"], et["bid"]
            a = {c: v.numpy() for c, v in auc.columns.items()}
            b = {c: v.numpy() for c, v in bid.columns.items()}
            live = np.flatnonzero(auc.valid.numpy())
            by_id = dict(zip(a["a_id"][live].tolist(), live.tolist()))
            best, drop = -1, None
            for j in np.flatnonzero(bid.valid.numpy()).tolist():
                k = by_id.get(int(b["auction"][j]))
                if k is not None \
                        and a["a_date_time"][k] <= b["b_date_time"][j] \
                        <= a["expires"][k] and b["price"][j] > best:
                    best, drop = int(b["price"][j]), j
            valid = bid.valid.clone()
            if drop is not None:
                valid[drop] = False
            cut.append(dict(et, bid=Batch(bid.columns, valid)))
        return orig(self, cut, check_overflow)

    monkeypatch.setattr(LocalExecutor, "execute_epochs", execute_epochs)


FAULTS = {"stale": _stale, "half": _half, "altered": _altered,
          "winner": _winner}


def _half_changes_an_answer(cell, seed) -> bool:
    """True when some window's reference answer over every other row of
    each epoch differs from its answer over all rows."""
    from flockbench.compare import rows_unequal
    from flockbench.run import make_ring, window_tables

    epochs, _, windows = make_ring(cell, seed)
    halved = [{r: cols if r == "campaign" else
               {c: v[::2] for c, v in cols.items()}
               for r, cols in e.items()} for e in epochs]
    ref = cell.reference()
    return any(rows_unequal(
        ref.reference(window_tables(halved, rng), cell.config),
        ref.reference(window_tables(epochs, rng), cell.config))
        for rng, _ in windows)


@pytest.mark.parametrize("name", CELLS)
def test_half_left_out_is_caught_where_it_changes_an_answer(monkeypatch,
                                                             name):
    _half(monkeypatch)
    cell = tiny_cell(name)
    caught = []
    for seed in (11, 12, 13, 14):
        changed = _half_changes_an_answer(cell, seed)
        line, _, _ = run_cell(cell, seed, 0.2, False, device="cpu")
        assert line["correct"] is (not changed), seed
        caught.append(changed)
    assert any(caught)
    if name != "nexmark-q7-tumble":
        assert all(caught)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_a_broken_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    line, _, _ = run_cell(tiny_cell(name), 11, 0.2, False, device="cpu")
    assert line["correct"] is False
    assert line["failed"] > 0
    assert line["checks"]["rows_unequal"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_path_is_correct(name):
    line, _, _ = run_cell(tiny_cell(name), 11, 0.2, False, device="cpu")
    assert line["correct"] is True


@pytest.mark.parametrize("fault", ["winner", "altered", "stale"])
def test_a_broken_join_path_is_not_correct(monkeypatch, tmp_path, fault):
    cell = added_cell(tmp_path, Q4_JOIN)
    FAULTS[fault](monkeypatch)
    line, _, _ = run_cell(cell, 11, 0.2, False, device="cpu")
    assert line["correct"] is False
    assert line["failed"] > 0
    assert line["checks"]["rows_unequal"]["value"] > 0

"""The per-layer metrics that read the program's own spans and staging
counters (``flockbench/spans.py``) from the run's ``Record``: a traced run
reports each, an untraced run records no span, and on a record without
spans each reader returns None, in a fresh process and after a traced
run alike."""

import json
import os
import subprocess
import sys

from fbhelp import tiny_cell
from flockbench.run import ROOT, Record, run_cell

NEW = ("dispatch_ms_per_window", "flags_wait_ms_per_window",
       "emit_copy_ms_per_window", "emit_host_ms_per_window",
       "stage_ms_per_epoch")


def _spans() -> dict:
    from flock_tpu_torch.utils.metrics import METRICS
    return {k: list(v) for k, v in METRICS.spans.items()}


def test_traced_run_reports_the_span_metrics():
    cell = tiny_cell("ysb-campaigns")
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    line, notes, rec = run_cell(cell, 2**31 + 11, 0.2, True, device="cpu")
    assert line["correct"] is True
    for name in NEW:
        v = line["metrics"][name]["value"]
        assert isinstance(v, float) and v > 0, name
    assert line["metrics"]["host_syncs_per_window"]["value"] == 1.0
    # the record holds the stretch's spans: one execute span a profiled
    # window, each formed as a view of its staged epochs
    n = rec.profile_windows
    assert rec.stretch["execute:count"] == n
    assert rec.stretch["execute.flags:count"] == n
    assert rec.stretch["execute.form_views"] == n
    assert rec.stretch["execute.form_copies"] == 0
    assert notes["windows_formed_in_stretch"] == {
        "execute.form_views": n, "execute.form_copies": 0}
    assert rec.setup_counters["stage.epochs"] == notes["ring_epochs"]


def test_readers_return_none_on_a_record_without_spans():
    """After a traced run in this process filled the program's registry,
    a record without spans (an untraced run's) still reads None."""
    run_cell(tiny_cell("ysb-campaigns"), 3, 0.2, True, device="cpu")
    assert _spans()
    cell = tiny_cell("ysb-campaigns")
    _, _, rec = run_cell(cell, 4, 0.2, False, device="cpu")
    assert not any(k.endswith(":count") and v for k, v in rec.stretch.items())
    for m in NEW:
        assert cell.reader(m).read(rec) is None, m
        assert cell.reader(m).read(Record()) is None, m


def test_untraced_run_records_no_span():
    before = _spans()
    line, _, rec = run_cell(tiny_cell("ysb-campaigns"), 5, 0.2, False,
                            device="cpu")
    assert line["correct"] is True and rec.windows > 0
    assert _spans() == before


_FRESH = r"""
import json
from flockbench.run import Record, load_cell
cell = load_cell("ysb-campaigns")
print(json.dumps({m: cell.reader(m).read(Record()) for m in %r}))
"""


def test_readers_return_none_before_a_traced_run():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _FRESH % (NEW,)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip()
    assert json.loads(out.splitlines()[-1]) == {m: None for m in NEW}

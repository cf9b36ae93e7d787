"""Range windows formed as views of the staged epochs (PyTorch port, CPU).

``StreamDriver.stage_epochs`` lays the epochs end to end in one buffer per
relation and column, and ``LocalExecutor.execute_epochs`` forms a window of
consecutive epochs as a view of those buffers.  For tumbling q7 and YSB,
hopping 10/5 q5, sliding 4/2 q2 and element-wise q3: every multi-epoch
window shares its columns' storage with the staged buffers and counts in
``execute.form_views``; its device output equals, bit for bit, the copy
that epochs staged one by one (``stage_chunk``) or passed out of order
take, and equals flock_tpu's ``execute_epochs``; no window writes through
its view; and a forced widen stages into new buffers that windows still
view."""

import dataclasses

import numpy as np
import pytest
import torch

from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.queries.ysb import ysb_query as ref_ysb_query
from flock_tpu.runtime.executor import LocalExecutor as RefExecutor
from flock_tpu.runtime.stream import StreamDriver as RefDriver
from flock_tpu_torch.datagen.ysb import YsbConfig
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.queries.ysb import (campaign_table, generate_ysb_epochs,
                                         ysb_query)
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
from flock_tpu_torch.utils.metrics import METRICS
from test_torch_windows import (_repeated_persons, _same_results,
                                _wide_span_epochs)

torch.set_num_threads(1)

# name -> (port spec, reference spec, seconds, events/s); YSB is tumbling 10
CASES = {
    "q7-tumbling": (7, None, 20, 300),
    "ysb-tumbling": ("ysb", None, 20, 1500),
    "q5-hopping": (5, None, 15, 300),
    "q2-sliding": (2, ("sliding", 4, 2), 10, 300),
    "q3-elementwise": (3, None, 4, 300),
}


def _specs(q, win):
    if q == "ysb":
        return ysb_query(), ref_ysb_query()
    spec, ref = get_query(q), ref_get_query(q)
    if win is not None:
        spec = dataclasses.replace(spec, window=win)
        ref = dataclasses.replace(ref, window=win)
    return spec, ref


def _epochs(q, seconds, eps):
    if q != "ysb":
        return generate_epochs(seconds, eps, 1)
    cfg = YsbConfig(seconds=seconds, events_per_second=eps, threads=2)
    camp = campaign_table(cfg)
    epochs = generate_ysb_epochs(cfg)
    for t, e in enumerate(epochs):
        # the campaign table rides with each window's first epoch
        e["campaign"] = camp if t % 10 == 0 else \
            {k: v[:0] for k, v in camp.items()}
    return epochs


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The driver, its epochs, their ranges, the staged buffers, the same
    epochs staged one by one, and the reference's per-epoch Batches."""
    q, win, seconds, eps = CASES[request.param]
    spec, ref_spec = _specs(q, win)
    epochs = _epochs(q, seconds, eps)
    driver = StreamDriver(spec, seconds, device="cpu")
    caps = driver.epoch_caps(epochs)
    ranges = [[t for t in rng if t < len(epochs)]
              for _, rng in driver.epoch_ranges(epochs)]
    ring = driver.stage_epochs(epochs, caps)
    single = [{r: driver.executor.stage_chunk(e[r], c)
               for r, c in caps.items()} for e in epochs]
    ref = RefExecutor(ref_spec)
    ref_staged = [ref.prepare_window({r: e[r] for r in caps}, caps)
                  for e in epochs]
    return dict(name=request.param, driver=driver, caps=caps, ranges=ranges,
                ring=ring, single=single, ref=ref, ref_staged=ref_staged)


def _forms():
    return (METRICS.counters.get("execute.form_views", 0),
            METRICS.counters.get("execute.form_copies", 0))


def _run_seen(executor, epoch_tables, monkeypatch):
    """(the window's output, the tables its plan ran over)."""
    seen = []
    orig = executor._run

    def spy(tables, *a, **k):
        seen.append(tables)
        return orig(tables, *a, **k)

    monkeypatch.setattr(executor, "_run", spy)
    out = executor.execute_epochs(epoch_tables)
    monkeypatch.undo()
    return out, seen[0]


def _assert_bitwise(got, want, what):
    assert got.capacity == want.capacity, what
    assert torch.equal(got.valid, want.valid), what
    assert list(got.columns) == list(want.columns), what
    for name, col in want.columns.items():
        assert got.columns[name].dtype == col.dtype, (what, name)
        assert torch.equal(got.columns[name], col), (what, name)


def test_windows_are_views_of_the_staged_epochs(case, monkeypatch):
    """Every multi-epoch window's columns and ``valid`` are one stretch of
    the staged buffers, each window counts once in ``execute.form_views``
    and none in ``execute.form_copies``; a one-epoch window runs on its
    epoch's Batches as staged."""
    ex, ring, caps = case["driver"].executor, case["ring"], case["caps"]
    multi = sum(len(rng) > 1 for rng in case["ranges"])
    if case["name"] == "q3-elementwise":
        assert multi == 0
    else:
        assert multi == len(case["ranges"]) > 0
    views0, copies0 = _forms()
    for rng in case["ranges"]:
        _, tables = _run_seen(ex, [ring[t] for t in rng], monkeypatch)
        for rel, cap in caps.items():
            first = ring[rng[0]][rel]
            if len(rng) == 1:
                assert tables[rel] is first
                continue
            got = tables[rel]
            assert got.capacity == len(rng) * cap
            for name, t in [*got.columns.items(), ("valid", got.valid)]:
                src = first.valid if name == "valid" else first.columns[name]
                assert t.untyped_storage().data_ptr() == \
                    src.untyped_storage().data_ptr(), (rng, rel, name)
                assert t.data_ptr() == src.data_ptr(), (rng, rel, name)
    views, copies = _forms()
    assert (views - views0, copies - copies0) == (multi, 0)


def test_views_equal_the_copy_and_the_reference(case):
    """Each window's device output over its views equals the copy's (the
    epochs staged one by one) in capacity, ``valid`` and every column, bit
    for bit, and flock_tpu's in capacity, validity and valid rows."""
    ex, ref = case["driver"].executor, case["ref"]
    multi = sum(len(rng) > 1 for rng in case["ranges"])
    views0, copies0 = _forms()
    for rng in case["ranges"]:
        got = ex.execute_epochs([case["ring"][t] for t in rng])
        copied = ex.execute_epochs([case["single"][t] for t in rng])
        _assert_bitwise(got, copied, rng)
        r = ref.execute_epochs([case["ref_staged"][t] for t in rng])
        rv = np.asarray(r.valid)
        assert got.capacity == rv.shape[0]
        np.testing.assert_array_equal(got.valid.numpy(), rv, err_msg=str(rng))
        assert set(got.columns) == set(r.columns)
        for name, col in r.columns.items():
            gc = got.columns[name].numpy()
            assert gc.dtype == np.asarray(col).dtype, name
            np.testing.assert_array_equal(gc[rv], np.asarray(col)[rv],
                                          err_msg=f"{rng} {name}")
    views, copies = _forms()
    assert (views - views0, copies - copies0) == (multi, multi)


def test_epochs_out_of_order_take_the_copy(case):
    """Staged epochs passed out of order (each window's reversed, epochs 1
    then 0, and 0 then 2) are not one stretch: the window copies, counts in
    ``execute.form_copies``, and equals the copy of the same epochs staged
    one by one, bit for bit."""
    ex, ring, single = case["driver"].executor, case["ring"], case["single"]
    windows = [rng[::-1] for rng in case["ranges"] if len(rng) > 1]
    windows += [[1, 0], [0, 2]]
    views0, copies0 = _forms()
    for rng in windows:
        got = ex.execute_epochs([ring[t] for t in rng])
        _assert_bitwise(got, ex.execute_epochs([single[t] for t in rng]),
                        rng)
    views, copies = _forms()
    assert (views - views0, copies - copies0) == (0, 2 * len(windows))


def test_no_window_writes_through_its_view(case):
    """Every staged column and ``valid`` keeps its bytes after each window
    runs over its views, in each of two passes, and both passes give equal
    rows."""
    ex, ring = case["driver"].executor, case["ring"]
    before = [{rel: (b.valid.clone(),
                     {c: t.clone() for c, t in b.columns.items()})
               for rel, b in epoch.items()} for epoch in ring]
    passes = []
    for _ in range(2):
        rows = []
        for rng in case["ranges"]:
            rows.append(ex.materialize(
                ex.execute_epochs([ring[t] for t in rng])))
            for epoch, snap in zip(ring, before):
                for rel, b in epoch.items():
                    valid, cols = snap[rel]
                    assert torch.equal(b.valid, valid), (rng, rel)
                    for c, t in cols.items():
                        assert torch.equal(b.columns[c], t), (rng, rel, c)
        passes.append(rows)
    for a, b in zip(*passes):
        assert list(a) == list(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("q,make", [(5, _wide_span_epochs),
                                    (3, _repeated_persons)],
                         ids=["wide_span", "fan_out"])
def test_forced_widen_stages_new_buffers_that_windows_view(q, make,
                                                           monkeypatch):
    """Two-epoch tumbling windows over tests/test_torch_windows.py's forced
    widens: each widen stages every epoch again, at doubled capacities,
    into new buffers; the window that finally runs is a view of the last
    of them (``execute.form_views``, no copy), and the rows equal
    flock_tpu's driver's."""
    ep, win = make(), ("tumbling", 2)
    port = StreamDriver(dataclasses.replace(get_query(q), window=win), 2,
                        device="cpu")
    ref = RefDriver(dataclasses.replace(ref_get_query(q), window=win), 2)
    stagings, seen = [], []
    orig_stage, orig_run = port.stage_epochs, port.executor._run

    def stage(epochs, caps):
        staged = orig_stage(epochs, caps)
        stagings.append((caps, staged))
        return staged

    def run(tables, *a, **k):
        seen.append(tables)
        return orig_run(tables, *a, **k)

    monkeypatch.setattr(port, "stage_epochs", stage)
    monkeypatch.setattr(port.executor, "_run", run)
    views0, copies0 = _forms()
    got = port.run(ep)
    monkeypatch.undo()
    _same_results(got, ref.run(ep))
    assert len(stagings) > 1
    for (caps0, s0), (caps1, s1) in zip(stagings, stagings[1:]):
        assert caps1 == {r: 2 * c for r, c in caps0.items()}
        for rel in caps1:
            assert s1[0][rel].valid.untyped_storage().data_ptr() != \
                s0[0][rel].valid.untyped_storage().data_ptr()
    caps, last = stagings[-1]
    for rel, b in seen[-1].items():
        if rel not in caps:
            continue
        assert b.capacity == 2 * caps[rel]
        for name, t in [*b.columns.items(), ("valid", b.valid)]:
            src = last[0][rel].valid if name == "valid" \
                else last[0][rel].columns[name]
            assert t.data_ptr() == src.data_ptr(), (rel, name)
    views, copies = _forms()
    assert views - views0 == len(stagings) and copies == copies0


def test_an_epoch_of_another_dtype_stages_apart_and_copies():
    """An epoch whose column stages as another dtype (int16 here) cannot
    share its relation's buffers: that relation's epochs stage one by one,
    the window copies (``execute.form_copies``), and its output equals,
    bit for bit, the window over the same epochs with the column as int32,
    which stage end to end and view."""
    epochs = generate_epochs(10, 300, 1)
    odd = [dict(e) for e in epochs]
    bid = dict(odd[3]["bid"])
    bid["bidder"] = bid["bidder"].astype(np.int16)
    odd[3]["bid"] = bid
    driver = StreamDriver(get_query(7), 10, device="cpu")
    ex, caps = driver.executor, driver.epoch_caps(epochs)
    (_, rng), = driver.epoch_ranges(epochs)
    outs = []
    for eps in (epochs, odd):
        staged = driver.stage_epochs(eps, caps)
        views0, copies0 = _forms()
        outs.append(ex.execute_epochs([staged[t] for t in rng]))
        views, copies = _forms()
        outs.append((views - views0, copies - copies0))
    assert outs[1] == (1, 0) and outs[3] == (0, 1)
    assert staged[3]["bid"].columns["bidder"].dtype == torch.int16
    _assert_bitwise(outs[2], outs[0], "int16 bidder")


def _buffer():
    return torch.arange(40, dtype=torch.int32)


END_TO_END = {
    "adjoining": lambda b: [b[0:10], b[10:25], b[25:40]],
    "reversed": lambda b: [b[10:20], b[0:10]],
    "gap": lambda b: [b[0:10], b[11:20]],
    "other_dtype": lambda b: [b[0:10], b[10:20].view(torch.float32)],
    "strided": lambda b: [b[0:10], b[10:30:2]],
    "two_d": lambda b: [b[0:10].view(2, 5), b[10:20].view(2, 5)],
    "own_storage": lambda b: [b[0:10], b[10:20].clone()],
}


@pytest.mark.parametrize("how", list(END_TO_END))
def test_end_to_end_views_only_adjoining_tensors(how):
    """``_end_to_end`` views tensors that lie end to end in one storage
    (the view equals their ``torch.cat``) and refuses any other list."""
    from flock_tpu_torch.runtime.executor import _end_to_end

    b = _buffer()
    ts = END_TO_END[how](b)
    got = _end_to_end(ts)
    if how != "adjoining":
        assert got is None
        return
    assert torch.equal(got, torch.cat(ts))
    assert got.data_ptr() == b.data_ptr() and got.shape == (40,)

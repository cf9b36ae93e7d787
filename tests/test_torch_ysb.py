"""YSB end to end on the CPU: the port's native generator against its
scalar version and the reference's generator, the campaign table, and
``run_ysb`` against flock_tpu's ``run_ysb`` and tests/oracle.py at
tests/test_ysb.py's configuration (20 s × 2,000 events/s, 2 threads), the
window's device output included (PyTorch port, CPU)."""

import numpy as np
import pytest
import torch

import oracle
from flock_tpu.datagen.ysb import YsbConfig as RefConfig
from flock_tpu.datagen.ysb import generate_partition as ref_generate
from flock_tpu.queries.ysb import campaign_table as ref_campaign_table
from flock_tpu.queries.ysb import generate_ysb_epochs as ref_epochs
from flock_tpu.queries.ysb import run_ysb as ref_run_ysb
from flock_tpu.queries.ysb import ysb_query as ref_ysb_query
from flock_tpu.runtime.executor import LocalExecutor as RefExecutor
from flock_tpu_torch.datagen import ysb
from flock_tpu_torch.queries.ysb import (campaign_table, generate_ysb_epochs,
                                         run_ysb, ysb_capacities, ysb_query)
from flock_tpu_torch.runtime.executor import LocalExecutor

torch.set_num_threads(1)

ARGS = dict(seconds=20, events_per_second=2000, threads=2)


def _same_cols(a: dict, b: dict):
    assert list(a) == list(b)
    for k in b:
        bv = np.asarray(b[k])
        assert a[k].dtype == bv.dtype, k
        np.testing.assert_array_equal(a[k], bv, err_msg=k)


@pytest.mark.parametrize("args", [ARGS, dict(seconds=3, events_per_second=7,
                                             threads=3, campaigns=4,
                                             ads_per_campaign=3)])
def test_native_generator_equals_scalar_and_reference(args):
    cfg = ysb.YsbConfig(**args)
    for idx in range(cfg.threads):
        got = ysb.generate_partition(cfg, idx)
        _same_cols(got, ysb.scalar_generate_partition(cfg, idx))
        _same_cols(got, ref_generate(RefConfig(**args), idx))


def test_vocabularies_and_campaign_table_equal_reference():
    from flock_tpu.datagen import ysb as ref_ysb

    assert (ysb.AD_TYPES, ysb.EVENT_TYPES, ysb.EVENT_TYPE_VIEW) == \
        (ref_ysb.AD_TYPES, ref_ysb.EVENT_TYPES, ref_ysb.EVENT_TYPE_VIEW)
    cfg = ysb.YsbConfig(campaigns=7, ads_per_campaign=3)
    _same_cols(campaign_table(cfg), ref_campaign_table(RefConfig(
        campaigns=7, ads_per_campaign=3)))
    spec, ref = ysb_query(), ref_ysb_query()
    assert (spec.number, spec.window, spec.relations) == \
        (ref.number, ref.window, ref.relations)
    assert spec.schema.__dict__ == ref.schema.__dict__


@pytest.fixture(scope="module")
def runs():
    return run_ysb(ysb.YsbConfig(**ARGS), device="cpu"), \
        ref_run_ysb(RefConfig(**ARGS))


def test_run_ysb_equals_reference_and_oracle(runs):
    got, want = runs
    cfg = ysb.YsbConfig(**ARGS)
    epochs = generate_ysb_epochs(cfg)
    assert [r.tag for r in got] == [r.tag for r in want] == [
        ("win", 0, 10), ("win", 10, 20)]
    for k, (g, w) in enumerate(zip(got, want)):
        _same_cols(g.columns, w.columns)
        chunk = epochs[k * 10:(k + 1) * 10]
        events = {c: np.concatenate([e["ad_event"][c] for e in chunk])
                  for c in chunk[0]["ad_event"]}
        expected = oracle.ysb(events, cfg.ads_per_campaign)
        assert sorted(zip(g.columns["campaign_id"].tolist(),
                          g.columns["count"].tolist())) == \
            sorted(zip(expected["campaign_id"].tolist(),
                       expected["count"].tolist()))
        assert len(g.columns["count"]) > cfg.campaigns * 0.9


def test_epochs_and_device_columns_equal_reference():
    """The per-epoch tables and one window's device output (capacity,
    validity, values in valid rows) at the reference's capacities."""
    cfg = ysb.YsbConfig(**ARGS)
    epochs, ref = generate_ysb_epochs(cfg), ref_epochs(RefConfig(**ARGS))
    assert len(epochs) == len(ref) == cfg.seconds
    for e, r in zip(epochs, ref):
        _same_cols(e["ad_event"], r["ad_event"])
    cols = {c: np.concatenate([e["ad_event"][c] for e in epochs[:10]])
            for c in epochs[0]["ad_event"]}
    tables = {"ad_event": cols, "campaign": campaign_table(cfg)}
    caps = ysb_capacities(cfg, 10)
    assert caps == {"ad_event": 20_096, "campaign": 1024}
    g = LocalExecutor(ysb_query(), device="cpu").execute_window(tables, caps)
    r = RefExecutor(ref_ysb_query()).execute_window(tables, caps)
    rv = np.asarray(r.valid)
    np.testing.assert_array_equal(g.valid.numpy(), rv)
    assert set(g.columns) == set(r.columns)
    for name, col in r.columns.items():
        np.testing.assert_array_equal(g.columns[name].numpy()[rv],
                                      np.asarray(col)[rv], err_msg=name)

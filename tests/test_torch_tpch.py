"""The port's TPC-H schemas and .tbl loader against flock_tpu's, on the
reference's sample tables in tests/golden_ref/tpch/ (PyTorch port, CPU)."""

import os

import numpy as np
import pytest

from flock_tpu.datagen import tpch as ref_tpch
from flock_tpu_torch.datagen import tpch

TBL = os.path.join(os.path.dirname(__file__), "golden_ref", "tpch")


def test_schemas_equal_reference():
    assert tpch.TPCH_SCHEMAS == ref_tpch.TPCH_SCHEMAS
    assert tpch.TPCH_TABLES == ref_tpch.TPCH_TABLES


@pytest.mark.parametrize("table", ref_tpch.TPCH_TABLES)
def test_load_tbl_equals_reference(table):
    """Names in schema order, dtypes and values (strings as object
    arrays, dates as int32 days since the epoch)."""
    path = os.path.join(TBL, f"{table}.tbl")
    got, want = tpch.load_tbl(path, table), ref_tpch.load_tbl(path, table)
    assert list(got) == list(want) == [c for c, _ in
                                        ref_tpch.TPCH_SCHEMAS[table]]
    for name, col in want.items():
        assert got[name].dtype == col.dtype, name
        np.testing.assert_array_equal(got[name], col, err_msg=name)
    assert len(next(iter(got.values()))) > 0


def test_catalog_equals_reference():
    got, want = tpch.tpch_catalog(), ref_tpch.tpch_catalog()
    assert list(got.tables) == list(want.tables)
    for name, t in want.tables.items():
        g = got.tables[name]
        assert (g.columns, g.unique_key, g.hard_unique) == \
            (t.columns, t.unique_key, t.hard_unique), name

"""TPC-H schemas and the .tbl loader — a copy of ``TPCH_SCHEMAS``,
``TPCH_TABLES``, ``load_tbl`` and ``tpch_catalog`` from
``flock_tpu/datagen/tpch.py`` (numpy only), over the port's catalog.

Reference counterpart: flock/src/datasource/tpch/mod.rs:28-150 (the exact
column lists and types below) and the sample .tbl data the reference commits
under flock/src/tests/data/tpch/ (copied to tests/golden_ref/tpch/ with
provenance — see tests/golden_ref/README.md).  The reference registers
schemas without a generator; here the schemas are loadable from pipe-
delimited .tbl files into columnar batches, so TPC-H relations can feed the
engine's operators directly.
"""

from __future__ import annotations

from datetime import date

import numpy as np

from flock_tpu_torch.sql.catalog import Catalog, Table

# (column, kind) per table — kinds: i32, f64, str, date32 (days since epoch),
# transcribed from get_tpch_schema, tpch/mod.rs:34-121
TPCH_SCHEMAS: dict[str, tuple[tuple[str, str], ...]] = {
    "part": (("p_partkey", "i32"), ("p_name", "str"), ("p_mfgr", "str"),
             ("p_brand", "str"), ("p_type", "str"), ("p_size", "i32"),
             ("p_container", "str"), ("p_retailprice", "f64"),
             ("p_comment", "str")),
    "supplier": (("s_suppkey", "i32"), ("s_name", "str"),
                 ("s_address", "str"), ("s_nationkey", "i32"),
                 ("s_phone", "str"), ("s_acctbal", "f64"),
                 ("s_comment", "str")),
    "partsupp": (("ps_partkey", "i32"), ("ps_suppkey", "i32"),
                 ("ps_availqty", "i32"), ("ps_supplycost", "f64"),
                 ("ps_comment", "str")),
    "customer": (("c_custkey", "i32"), ("c_name", "str"),
                 ("c_address", "str"), ("c_nationkey", "i32"),
                 ("c_phone", "str"), ("c_acctbal", "f64"),
                 ("c_mktsegment", "str"), ("c_comment", "str")),
    "orders": (("o_orderkey", "i32"), ("o_custkey", "i32"),
               ("o_orderstatus", "str"), ("o_totalprice", "f64"),
               ("o_orderdate", "date32"), ("o_orderpriority", "str"),
               ("o_clerk", "str"), ("o_shippriority", "i32"),
               ("o_comment", "str")),
    "lineitem": (("l_orderkey", "i32"), ("l_partkey", "i32"),
                 ("l_suppkey", "i32"), ("l_linenumber", "i32"),
                 ("l_quantity", "f64"), ("l_extendedprice", "f64"),
                 ("l_discount", "f64"), ("l_tax", "f64"),
                 ("l_returnflag", "str"), ("l_linestatus", "str"),
                 ("l_shipdate", "date32"), ("l_commitdate", "date32"),
                 ("l_receiptdate", "date32"), ("l_shipinstruct", "str"),
                 ("l_shipmode", "str"), ("l_comment", "str")),
    "nation": (("n_nationkey", "i32"), ("n_name", "str"),
               ("n_regionkey", "i32"), ("n_comment", "str")),
    "region": (("r_regionkey", "i32"), ("r_name", "str"),
               ("r_comment", "str")),
}

TPCH_TABLES = tuple(TPCH_SCHEMAS)

_UNIQUE = {"orders": "o_orderkey", "customer": "c_custkey",
           "part": "p_partkey", "supplier": "s_suppkey",
           "nation": "n_nationkey", "region": "r_regionkey"}

_EPOCH = date(1970, 1, 1)


def _date32(s: str) -> int:
    y, m, d = s.split("-")
    return (date(int(y), int(m), int(d)) - _EPOCH).days


def load_tbl(path: str, table: str) -> dict[str, np.ndarray]:
    """Pipe-delimited .tbl → columnar batch per the reference schema.
    String columns come back as object arrays (dictionary-encode at the
    plan boundary the same way NEXMark strings do)."""
    schema = TPCH_SCHEMAS[table]
    cols: list[list] = [[] for _ in schema]
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("|")
            for i, (_, kind) in enumerate(schema):
                v = parts[i]
                cols[i].append(
                    int(v) if kind == "i32" else
                    float(v) if kind == "f64" else
                    _date32(v) if kind == "date32" else v)
    out = {}
    for (name, kind), vals in zip(schema, cols):
        dt = {"i32": np.int32, "f64": np.float64,
              "date32": np.int32}.get(kind, object)
        out[name] = np.array(vals, dt)
    return out


def tpch_catalog() -> Catalog:
    c = Catalog()
    for name, schema in TPCH_SCHEMAS.items():
        c.register(Table(name, tuple(col for col, _ in schema),
                         unique_key=_UNIQUE.get(name)))
    return c

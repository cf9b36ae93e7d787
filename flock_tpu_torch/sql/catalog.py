"""Table catalog: schemas, unique keys, functional dependencies, dictionaries
— a copy of ``Table``, ``Catalog``, ``nexmark_catalog`` and ``ysb_catalog``
from ``flock_tpu/sql/catalog.py``, with the vocabularies taken from the
port's ``datagen/nexmark.py``, ``datagen/ysb.py`` and ``queries/nexmark.py``.

Left out: the reference's planner statistics ``ID_DOMAIN``, ``key_s_loc``
and ``COLUMN_LIMBS`` (the TPU's key-locality windows and the factored
gather's limb hints); the port's ``Join`` and ``Aggregate`` have no fields
to carry them.

Reference counterpart: register_nexmark_tables (flock/src/datasource/nexmark/
mod.rs:102-141) plus the schema knowledge DataFusion keeps per MemTable.  The
planner additionally records:

* unique (primary) keys — drives lookup-join build-side selection,
* functional dependencies (key → dependent columns) — lets GROUP BY
  (p_id, name) lower to the dense single-key aggregation with dependent
  columns carried by max(),
* string dictionaries — string literals in SQL compare against dictionary
  codes on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from flock_tpu_torch.datagen.nexmark import US_CITIES, US_STATES
from flock_tpu_torch.datagen.ysb import AD_TYPES, EVENT_TYPES
from flock_tpu_torch.queries.nexmark import NAME_VOCAB


@dataclass
class Table:
    name: str
    columns: tuple[str, ...]
    unique_key: str | None = None
    # key → columns functionally determined by it
    functional_deps: dict[str, tuple[str, ...]] = field(default_factory=dict)
    dictionaries: dict[str, list[str]] = field(default_factory=dict)
    timestamp_cols: tuple[str, ...] = ()
    # STRUCTURALLY-guaranteed unique key (generated as a dense range, e.g.
    # side_input.key, campaign.c_ad_id) — stronger than ``unique_key``,
    # which only nominates the build side of joins: NEXMark's own id
    # arithmetic duplicates a_id/p_id at misaligned generator counts, so
    # those stay soft and keep the runtime fan-out armed
    hard_unique: bool = False


@dataclass
class Catalog:
    tables: dict[str, Table] = field(default_factory=dict)

    def register(self, t: Table) -> None:
        self.tables[t.name] = t

    def table_of_column(self, col: str, among: list[str]) -> str | None:
        for name in among:
            if col in self.tables[name].columns:
                return name
        return None


def nexmark_catalog() -> Catalog:
    c = Catalog()
    c.register(Table(
        "person",
        ("p_id", "name", "city", "state", "p_date_time"),
        unique_key="p_id",
        functional_deps={"p_id": ("name", "city", "state", "p_date_time")},
        dictionaries={"name": NAME_VOCAB, "city": US_CITIES,
                      "state": US_STATES},
        timestamp_cols=("p_date_time",),
    ))
    c.register(Table(
        "auction",
        ("a_id", "initial_bid", "reserve", "a_date_time", "expires",
         "seller", "category"),
        unique_key="a_id",
        functional_deps={"a_id": ("initial_bid", "reserve", "a_date_time",
                                  "expires", "seller", "category")},
        timestamp_cols=("a_date_time", "expires"),
    ))
    c.register(Table(
        "bid", ("auction", "bidder", "price", "b_date_time"),
        timestamp_cols=("b_date_time",),
    ))
    c.register(Table(
        "side_input", ("key", "value"), unique_key="key",
        functional_deps={"key": ("value",)}, hard_unique=True,
    ))
    return c


def ysb_catalog() -> Catalog:
    c = Catalog()
    c.register(Table(
        "ad_event",
        ("ad_id", "ad_type", "event_type", "event_time"),
        dictionaries={"ad_type": AD_TYPES, "event_type": EVENT_TYPES},
        timestamp_cols=("event_time",),
    ))
    c.register(Table(
        "campaign", ("c_ad_id", "campaign_id"), unique_key="c_ad_id",
        functional_deps={"c_ad_id": ("campaign_id",)}, hard_unique=True,
    ))
    return c

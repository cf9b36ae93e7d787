"""Relation tables: host-side columnar views over generated epochs and q13's
bounded side input — copies of ``epoch_to_relations``, ``concat_relations``,
``default_side_input`` and ``load_side_input_csv`` from
``flock_tpu/runtime/tables.py``.

Both executors take the same ``{relation: {column: np.ndarray}}`` dicts.
"""

from __future__ import annotations

import numpy as np

from flock_tpu_torch.datagen.nexmark import EpochColumns

RELATION_COLS = {
    "person": ("p_id", "name", "city", "state", "p_date_time"),
    "auction": ("a_id", "initial_bid", "reserve", "a_date_time", "expires",
                "seller", "category"),
    "bid": ("auction", "bidder", "price", "b_date_time"),
    "side_input": ("key", "value"),
}


def epoch_to_relations(e: EpochColumns) -> dict[str, dict[str, np.ndarray]]:
    return {
        "person": {
            "p_id": e.p_id, "name": e.p_name_code, "city": e.p_city_code,
            "state": e.p_state_code, "p_date_time": e.p_date_time,
        },
        "auction": {
            "a_id": e.a_id, "initial_bid": e.a_initial_bid,
            "reserve": e.a_reserve, "a_date_time": e.a_date_time,
            "expires": e.a_expires, "seller": e.a_seller,
            "category": e.a_category,
        },
        "bid": {
            "auction": e.b_auction, "bidder": e.b_bidder, "price": e.b_price,
            "b_date_time": e.b_date_time,
        },
    }


def concat_relations(parts: list[dict[str, dict[str, np.ndarray]]],
                     relations: tuple[str, ...]) -> dict[str, dict[str, np.ndarray]]:
    """Concatenate per-epoch relation columns into one window's tables."""
    out = {}
    for rel in relations:
        cols = {}
        for name in RELATION_COLS[rel]:
            arrays = [p[rel][name] for p in parts if rel in p]
            cols[name] = (np.concatenate(arrays) if arrays
                          else np.array([], dtype=np.int32))
        out[rel] = cols
    return out


def window_relations(relations: tuple[str, ...]) -> tuple[str, ...]:
    """The relations a window carries: all but the static side input, which
    is staged once per run and shared by every window."""
    return tuple(r for r in relations if r != "side_input")


def default_side_input(n: int = 10_000) -> dict[str, np.ndarray]:
    """Bounded side-input table for q13 (key int32, value int32).

    The reference fixture is a 2-column CSV keyed by auction id; this
    generates key=i, value=i for i in [1000, 1000+n) so hot and normal
    auction ids all find matches (first_auction_id = 1000).  Load a real CSV
    with ``load_side_input_csv``.
    """
    k = np.arange(1000, 1000 + n, dtype=np.int32)
    return {"key": k, "value": k.copy()}


def load_side_input_csv(path: str) -> dict[str, np.ndarray]:
    data = np.loadtxt(path, delimiter=",", dtype=np.int64, ndmin=2)
    return {"key": data[:, 0].astype(np.int32),
            "value": data[:, 1].astype(np.int32)}

"""ctypes wrapper over the native NEXMark and YSB generators — copy of
``nexmark_generate_partition`` and ``ysb_generate_partition`` from
``flock_tpu/datagen/native_gen.py``.

Produces columns directly in columnar (SoA) form, bit-identical to the
reference package's generators for the same configuration.
"""

from __future__ import annotations

import ctypes

import numpy as np

from flock_tpu_torch.datagen.nexmark import EpochColumns, NexmarkConfig
from flock_tpu_torch.native import get_lib

_CFG_FIELDS = [
    "active_people", "in_flight_auctions", "out_of_order_group_size",
    "hot_seller_ratio", "hot_auction_ratio", "hot_bidder_ratio",
    "first_event_id", "first_event_number", "base_time", "num_categories",
    "auction_id_lead", "hot_seller_ratio_2", "hot_auction_ratio_2",
    "hot_bidder_ratio_2", "person_proportion", "auction_proportion",
    "bid_proportion", "first_auction_id", "first_person_id",
    "first_category_id", "person_id_lead", "num_event_generators",
    "events_per_second",
]


def nexmark_generate_partition(
    cfg: NexmarkConfig, seconds: int, partition: int
) -> list[EpochColumns]:
    """Generate all epochs for one generator partition natively."""
    lib = get_lib()
    cfg_arr = np.array([getattr(cfg, f) for f in _CFG_FIELDS], dtype=np.int64)
    total = (seconds + 1) * (cfg.events_per_second // cfg.num_event_generators) + 64
    denom = cfg.proportion_denominator
    p_cap = total * cfg.person_proportion // denom + 64
    a_cap = total * cfg.auction_proportion // denom + 64
    b_cap = total * cfg.bid_proportion // denom + 64

    while True:
        p = {k: np.empty(p_cap, dt) for k, dt in (
            ("id", np.int32), ("name", np.int32), ("city", np.int32),
            ("state", np.int32), ("ts", np.int64), ("epoch", np.int32))}
        a = {k: np.empty(a_cap, dt) for k, dt in (
            ("id", np.int32), ("ib", np.int32), ("res", np.int32),
            ("ts", np.int64), ("exp", np.int64), ("seller", np.int32),
            ("cat", np.int32), ("epoch", np.int32))}
        b = {k: np.empty(b_cap, dt) for k, dt in (
            ("auc", np.int32), ("bid", np.int32), ("price", np.int32),
            ("ts", np.int64), ("epoch", np.int32))}
        p_n, a_n, b_n = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
        rc = lib.fg_nexmark_generate(
            cfg_arr.ctypes.data, seconds, partition,
            *[v.ctypes.data for v in p.values()], p_cap, ctypes.byref(p_n),
            *[v.ctypes.data for v in a.values()], a_cap, ctypes.byref(a_n),
            *[v.ctypes.data for v in b.values()], b_cap, ctypes.byref(b_n),
        )
        if rc == 0:
            break
        p_cap, a_cap, b_cap = p_n.value + 1, a_n.value + 1, b_n.value + 1

    p = {k: v[:p_n.value] for k, v in p.items()}
    a = {k: v[:a_n.value] for k, v in a.items()}
    b = {k: v[:b_n.value] for k, v in b.items()}
    all_epochs = np.unique(np.concatenate([p["epoch"], a["epoch"], b["epoch"]]))
    out = []
    for e in all_epochs.tolist():
        ps, pe = np.searchsorted(p["epoch"], [e, e + 1])
        as_, ae = np.searchsorted(a["epoch"], [e, e + 1])
        bs, be = np.searchsorted(b["epoch"], [e, e + 1])
        out.append(EpochColumns(
            epoch=int(e),
            p_id=p["id"][ps:pe].copy(),
            p_name_code=p["name"][ps:pe].copy(),
            p_city_code=p["city"][ps:pe].copy(),
            p_state_code=p["state"][ps:pe].copy(),
            p_date_time=p["ts"][ps:pe].copy(),
            a_id=a["id"][as_:ae].copy(),
            a_initial_bid=a["ib"][as_:ae].copy(),
            a_reserve=a["res"][as_:ae].copy(),
            a_date_time=a["ts"][as_:ae].copy(),
            a_expires=a["exp"][as_:ae].copy(),
            a_seller=a["seller"][as_:ae].copy(),
            a_category=a["cat"][as_:ae].copy(),
            b_auction=b["auc"][bs:be].copy(),
            b_bidder=b["bid"][bs:be].copy(),
            b_price=b["price"][bs:be].copy(),
            b_date_time=b["ts"][bs:be].copy(),
        ))
    return out


def ysb_generate_partition(
    seconds: int, events_per_second: int, threads: int, index: int,
    campaigns: int = 100, ads: int = 10,
) -> dict[str, np.ndarray]:
    """Generate YSB ad events for one partition: ``ad_id``/``ad_type``/
    ``event_type`` codes, ``event_time`` (ms) and the ``epoch`` tag, with
    campaign(ad) = ad // ads."""
    lib = get_lib()
    cap = seconds * events_per_second // threads + events_per_second + 64
    while True:
        cols = {k: np.empty(cap, dt) for k, dt in (
            ("ad_id", np.int32), ("ad_type", np.int32),
            ("event_type", np.int32), ("event_time", np.int64),
            ("epoch", np.int32))}
        n = ctypes.c_int64()
        rc = lib.fg_ysb_generate(
            seconds, events_per_second, threads, index, campaigns, ads,
            *[v.ctypes.data for v in cols.values()], cap, ctypes.byref(n))
        if rc == 0:
            break
        cap = n.value + 1
    return {k: v[:n.value].copy() for k, v in cols.items()}

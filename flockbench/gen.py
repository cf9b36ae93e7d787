"""The benchmark's stream generator: bindings of ``native/flockgen.cpp``,
the frozen copy of the NEXMark and YSB generators, seeded by a run's
``--seed``.

The library builds with ``g++`` into ``flockbench/build/`` on first use (a
fixed directory inside the checkout, so only a checkout's first run builds
it) and rebuilds when the source is newer.  Epochs generate in parallel
threads: ctypes releases the GIL while the native code runs.

An epoch is ``{relation: {column: np.ndarray}}`` under the program's
relation and column names, with absolute int64 millisecond timestamps, as
the program's own generator hands them to its stream driver.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "flockgen.cpp")
BUILD = os.path.join(_HERE, "build")
_LIB = os.path.join(BUILD, "libfbgen.so")

# the generator's configuration, 23 int64s in the order of its Config
CFG_FIELDS = (
    "active_people", "in_flight_auctions", "out_of_order_group_size",
    "hot_seller_ratio", "hot_auction_ratio", "hot_bidder_ratio",
    "first_event_id", "first_event_number", "base_time", "num_categories",
    "auction_id_lead", "hot_seller_ratio_2", "hot_auction_ratio_2",
    "hot_bidder_ratio_2", "person_proportion", "auction_proportion",
    "bid_proportion", "first_auction_id", "first_person_id",
    "first_category_id", "person_id_lead", "num_event_generators",
    "events_per_second",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib() -> ctypes.CDLL:
    """Build (when missing or older than its source) and load the
    generator library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) \
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                           check=True, capture_output=True)
            os.replace(tmp, _LIB)
        so = ctypes.CDLL(_LIB)
        vp, i64, u64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
        i64p = ctypes.POINTER(ctypes.c_int64)
        so.fb_nexmark_epoch_start.argtypes = [vp, i64]
        so.fb_nexmark_epoch_start.restype = i64
        so.fb_nexmark_range.argtypes = (
            [vp, u64, i64, i64, i64]
            + [vp] * 5 + [i64, i64p]
            + [vp] * 7 + [i64, i64p]
            + [vp] * 4 + [i64, i64p])
        so.fb_nexmark_range.restype = ctypes.c_int
        so.fb_ysb_epoch.argtypes = [u64, i64, i64, i64, i64] + [vp] * 4
        so.fb_ysb_epoch.restype = None
        _lib = so
        return so


_PERSON = (("p_id", np.int32), ("name", np.int32), ("city", np.int32),
           ("state", np.int32), ("p_date_time", np.int64))
_AUCTION = (("a_id", np.int32), ("initial_bid", np.int32),
            ("reserve", np.int32), ("a_date_time", np.int64),
            ("expires", np.int64), ("seller", np.int32),
            ("category", np.int32))
_BID = (("auction", np.int32), ("bidder", np.int32), ("price", np.int32),
         ("b_date_time", np.int64))


def _seed(seed: int) -> int:
    """The run's seed as the generator's unsigned 64-bit seed."""
    return int(seed) % (1 << 64)


def nexmark_epoch(gen: dict, seed: int, epoch: int) -> tuple[dict, int]:
    """(relation tables, events) of one epoch of the one generator."""
    so = lib()
    cfg = np.array([gen[f] for f in CFG_FIELDS], np.int64)
    lo = so.fb_nexmark_epoch_start(cfg.ctypes.data, epoch)
    hi = so.fb_nexmark_epoch_start(cfg.ctypes.data, epoch + 1)
    n = hi - lo
    denom = gen["person_proportion"] + gen["auction_proportion"] \
        + gen["bid_proportion"]
    caps = [n * gen[k] // denom + 64 for k in
            ("person_proportion", "auction_proportion", "bid_proportion")]
    while True:
        rels = [{c: np.empty(cap, dt) for c, dt in cols}
                for cols, cap in zip((_PERSON, _AUCTION, _BID), caps)]
        counts = [ctypes.c_int64() for _ in range(3)]
        args = []
        for cols, cap, cnt in zip(rels, caps, counts):
            args += [v.ctypes.data for v in cols.values()]
            args += [cap, ctypes.byref(cnt)]
        rc = so.fb_nexmark_range(cfg.ctypes.data, _seed(seed), 0, lo, hi,
                                 *args)
        if rc == 0:
            break
        caps = [c.value + 1 for c in counts]
    out = {name: {c: v[:cnt.value] for c, v in cols.items()}
           for name, cols, cnt in zip(("person", "auction", "bid"), rels,
                                      counts)}
    return out, n


def ysb_epoch(cfg: dict, seed: int, epoch: int) -> tuple[dict, int]:
    """(``{"ad_event": columns}``, events) of one YSB epoch."""
    n = cfg["events_per_second"]
    cols = {"ad_id": np.empty(n, np.int32), "ad_type": np.empty(n, np.int32),
            "event_type": np.empty(n, np.int32),
            "event_time": np.empty(n, np.int64)}
    lib().fb_ysb_epoch(_seed(seed), epoch, n, cfg["campaigns"],
                       cfg["ads_per_campaign"],
                       *[v.ctypes.data for v in cols.values()])
    return {"ad_event": cols}, n


def campaign_table(cfg: dict) -> dict:
    """YSB's campaign table: ad i belongs to campaign i // ads_per_campaign
    (the program's ``queries/ysb.campaign_table``)."""
    ad = np.arange(cfg["campaigns"] * cfg["ads_per_campaign"], dtype=np.int32)
    return {"c_ad_id": ad, "campaign_id": ad // cfg["ads_per_campaign"]}


THREADS = 8   # the chip's host has 8 cores a card


def generate(config: dict, seed: int, epochs: int, relations: tuple
             ) -> tuple[list[dict], list[int]]:
    """(per-epoch tables of ``relations``, events per epoch) of a ring of
    ``epochs`` epochs of the configuration's stream, one generator."""
    lib()   # build once, before the threads

    def one(t):
        if config["dataset"] == "nexmark":
            tables, n = nexmark_epoch(config["generator"], seed, t)
        else:
            tables, n = ysb_epoch(config["generator"], seed, t)
        return {r: tables[r] for r in relations if r in tables}, n

    with ThreadPoolExecutor(max_workers=max(1, min(THREADS, epochs))) as pool:
        got = list(pool.map(one, range(epochs)))
    return [g[0] for g in got], [g[1] for g in got]

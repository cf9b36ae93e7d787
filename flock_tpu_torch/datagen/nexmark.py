"""Deterministic NEXMark event generator — copy of
``flock_tpu/datagen/nexmark.py`` for the port.

Reference: flock/src/datasource/nexmark/{config.rs,event.rs,generator.rs}.

Every event is a pure function of its event id: the reference seeds
``SmallRng::seed_from_u64(id)`` per event (event.rs:89), draws a fixed
sequence of samples per event type, and computes timestamps with f32 math
(config.rs:248-272).  Two implementations share these semantics:

* ``ScalarGenerator`` (this file) — pure Python, the audited reference, and
  the only one that materializes the random strings (email, credit card,
  item name, description) for full-fidelity JSON export
  (``sources.dump_events_json``);
* the native generator (``native/flockgen.cpp``, a copy of the reference
  package's) — the fast path every query runs on.

``tests/test_torch_sources.py`` holds them to each other and to
``flock_tpu``'s generators column for column.  Vocabulary strings
(name/city/state) are dictionary codes.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field

import numpy as np

from flock_tpu_torch.utils.rng import SmallRng

BASE_TIME = 1_436_918_400_000  # config.rs:20

US_STATES = ["az", "ca", "id", "or", "wa", "wy"]
US_CITIES = [
    "phoenix", "los angeles", "san francisco", "boise", "portland",
    "bend", "redmond", "seattle", "kent", "cheyenne",
]
FIRST_NAMES = [
    "peter", "paul", "luke", "john", "saul", "vicky",
    "kate", "julie", "sarah", "deiter", "walter",
]
LAST_NAMES = [
    "shultz", "abrams", "spencer", "white", "bartels",
    "walton", "smith", "jones", "noris",
]

MIN_STRING_LENGTH = 3  # event.rs:26

_f32 = np.float32
_libm = None


def _powf(x, y) -> float:
    """powf(3) from libm, loaded on first use: Rust's f32::powf lowers to
    the same libm call on linux-gnu, so gen_price stays bit-exact with the
    reference."""
    global _libm
    if _libm is None:
        lib = ctypes.CDLL("libm.so.6")
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.powf.restype = ctypes.c_float
        _libm = lib
    return _libm.powf(x, y)


def _round_f32_half_away(x: float) -> int:
    """Rust ``f32::round`` (half away from zero) for non-negative f32 values.

    The f32 value is exact in f64, and +0.5 is exact in f64 below 2^52, so
    floor(x + 0.5) in f64 matches f32::round for the magnitudes NEXMark uses.
    """
    return math.floor(float(x) + 0.5)


@dataclass
class NexmarkConfig:
    """Replica of NEXMarkConfig (config.rs:119-245) with identical defaults."""

    active_people: int = 1000
    in_flight_auctions: int = 100
    out_of_order_group_size: int = 1
    hot_seller_ratio: int = 4
    hot_auction_ratio: int = 2
    hot_bidder_ratio: int = 4
    first_event_id: int = 0
    first_event_number: int = 0
    base_time: int = BASE_TIME
    num_categories: int = 5
    auction_id_lead: int = 10
    hot_seller_ratio_2: int = 100
    hot_auction_ratio_2: int = 100
    hot_bidder_ratio_2: int = 100
    person_proportion: int = 1
    auction_proportion: int = 3
    bid_proportion: int = 46
    first_auction_id: int = 1000
    first_person_id: int = 1000
    first_category_id: int = 10
    person_id_lead: int = 10
    sine_approx_steps: int = 10
    num_event_generators: int = 1
    events_per_second: int = 10_000
    # Derived (single-rate path; config.rs:171-208):
    inter_event_delays: list = field(default_factory=list)
    events_per_epoch: int = 0
    epoch_period: float = 0.0
    step_length: int = 0

    def __post_init__(self):
        if not self.inter_event_delays:
            # rate_to_period(r) = us_per_unit / r, f32; times generators (f32).
            delay = _f32(1_000_000) / _f32(self.events_per_second)
            self.inter_event_delays = [_f32(delay * _f32(self.num_event_generators))]

    @property
    def proportion_denominator(self) -> int:
        return self.person_proportion + self.auction_proportion + self.bid_proportion

    def event_timestamp(self, event_number: int) -> int:
        """config.rs:248-272 (single-rate path when one inter-event delay)."""
        if len(self.inter_event_delays) == 1:
            off = _f32(_f32(event_number) * self.inter_event_delays[0]) / _f32(1000.0)
            return self.base_time + _round_f32_half_away(off)
        raise NotImplementedError("multi-rate (sine/square) delays")

    def next_adjusted_event(self, events_so_far: int) -> int:
        """config.rs:275-279."""
        n = self.out_of_order_group_size
        event_number = self.first_event_number + events_so_far
        return (event_number // n) * n + (event_number * 953) % n


# ---------------------------------------------------------------------------
# Per-event field generation (exact draw order; event.rs)
# ---------------------------------------------------------------------------


def _gen_string(rng: SmallRng, max_len: int, materialize: bool) -> str | None:
    """event.rs:34-51: random length in [3, max), chars with 1/13 space odds, trim."""
    length = rng.gen_range_u64(max_len - MIN_STRING_LENGTH) + MIN_STRING_LENGTH
    chars = [] if materialize else None
    for _ in range(length):
        # `gen_range(0..13)` infers i32 → 32-bit sampling path.
        if rng.gen_range_u32(13) == 0:
            if materialize:
                chars.append(" ")
        else:
            c = rng.gen_range_u32(26)
            if materialize:
                chars.append(chr(ord("a") + c))
    return "".join(chars).strip() if materialize else None


def _gen_price(rng: SmallRng) -> int:
    """event.rs:53-56: round(powf(10, U*6) * 100) in f32."""
    u = _f32(rng.gen_f32())
    exponent = _f32(u * _f32(6.0))
    p = _f32(_powf(_f32(10.0), exponent))
    return _round_f32_half_away(_f32(p * _f32(100.0)))


def person_last_id(event_id: int, cfg: NexmarkConfig) -> int:
    """event.rs:177-184."""
    epoch = event_id // cfg.proportion_denominator
    offset = event_id % cfg.proportion_denominator
    if cfg.person_proportion <= offset:
        offset = cfg.person_proportion - 1
    return epoch * cfg.person_proportion + offset


def person_next_id(event_id: int, rng: SmallRng, cfg: NexmarkConfig) -> int:
    """event.rs:171-175."""
    people = person_last_id(event_id, cfg) + 1
    active = min(people, cfg.active_people)
    return people - active + rng.gen_range_u64(active + cfg.person_id_lead)


def auction_last_id(event_id: int, cfg: NexmarkConfig) -> int:
    """event.rs:283-295."""
    epoch = event_id // cfg.proportion_denominator
    offset = event_id % cfg.proportion_denominator
    if offset < cfg.person_proportion:
        epoch -= 1
        offset = cfg.auction_proportion - 1
    elif cfg.person_proportion + cfg.auction_proportion <= offset:
        offset = cfg.auction_proportion - 1
    else:
        offset -= cfg.person_proportion
    return epoch * cfg.auction_proportion + offset


def auction_next_id(event_id: int, rng: SmallRng, cfg: NexmarkConfig) -> int:
    """event.rs:273-281."""
    max_auction = auction_last_id(event_id, cfg)
    min_auction = 0 if max_auction < cfg.in_flight_auctions else max_auction - cfg.in_flight_auctions
    return min_auction + rng.gen_range_u64(
        max_auction - min_auction + 1 + cfg.auction_id_lead
    )


# ---------------------------------------------------------------------------
# Columnar epoch output
# ---------------------------------------------------------------------------



@dataclass
class EpochColumns:
    """One generator-partition's events for one epoch, in columnar form.

    Numeric columns mirror the reference Arrow schemas (event.rs:130-149,
    220-245, 336-352); vocabulary strings are dictionary codes.
    """

    epoch: int
    # persons
    p_id: np.ndarray
    p_name_code: np.ndarray   # first_idx * len(LAST_NAMES) + last_idx
    p_city_code: np.ndarray
    p_state_code: np.ndarray
    p_date_time: np.ndarray   # int64 ms
    # auctions
    a_id: np.ndarray
    a_initial_bid: np.ndarray
    a_reserve: np.ndarray
    a_date_time: np.ndarray
    a_expires: np.ndarray
    a_seller: np.ndarray
    a_category: np.ndarray
    # bids
    b_auction: np.ndarray
    b_bidder: np.ndarray
    b_price: np.ndarray
    b_date_time: np.ndarray
    # optional full-fidelity strings (lists of str) keyed by column name
    strings: dict = field(default_factory=dict)


class ScalarGenerator:
    """Pure-Python replica of NEXMarkGenerator (generator.rs:34-137).

    ``partition`` is the generator index ``p``; ids are offset by
    ``(100_000 / num_event_generators) * p`` (event.rs:86-88).
    """

    def __init__(self, cfg: NexmarkConfig, seconds: int, materialize_strings: bool = False):
        self.cfg = cfg
        self.seconds = seconds
        self.materialize = materialize_strings

    def generate_event(self, events_so_far: int, partition: int):
        cfg = self.cfg
        adj = cfg.next_adjusted_event(events_so_far)
        rem = adj % cfg.proportion_denominator
        timestamp = cfg.event_timestamp(adj)
        event_id = cfg.first_event_id + adj + (100_000 // cfg.num_event_generators) * partition
        rng = SmallRng(event_id)
        if rem < cfg.person_proportion:
            return ("person", self._person(event_id, timestamp, rng))
        if rem < cfg.person_proportion + cfg.auction_proportion:
            return ("auction", self._auction(events_so_far, event_id, timestamp, rng))
        return ("bid", self._bid(event_id, timestamp, rng))

    def _person(self, event_id: int, ts: int, rng: SmallRng):
        cfg = self.cfg
        first = rng.choose_index(len(FIRST_NAMES))
        last = rng.choose_index(len(LAST_NAMES))
        email_local = _gen_string(rng, 7, self.materialize)
        email_domain = _gen_string(rng, 5, self.materialize)
        cc = [rng.gen_range_u32(10000) for _ in range(4)]
        city = rng.choose_index(len(US_CITIES))
        state = rng.choose_index(len(US_STATES))
        row = {
            "p_id": person_last_id(event_id, cfg) + cfg.first_person_id,
            "name_code": first * len(LAST_NAMES) + last,
            "city_code": city,
            "state_code": state,
            "date_time": ts,
        }
        if self.materialize:
            row["name"] = f"{FIRST_NAMES[first]} {LAST_NAMES[last]}"
            row["email_address"] = f"{email_local}@{email_domain}.com"
            row["credit_card"] = " ".join(f"{c:04d}" for c in cc)
            row["city"] = US_CITIES[city]
            row["state"] = US_STATES[state]
        return row

    def _auction(self, events_so_far: int, event_id: int, ts: int, rng: SmallRng):
        cfg = self.cfg
        initial_bid = _gen_price(rng)
        if rng.gen_range_u64(cfg.hot_seller_ratio) > 0:
            seller = (person_last_id(event_id, cfg) // cfg.hot_seller_ratio_2) * cfg.hot_seller_ratio_2
        else:
            seller = person_next_id(event_id, rng, cfg)
        item_name = _gen_string(rng, 20, self.materialize)
        description = _gen_string(rng, 100, self.materialize)
        reserve = initial_bid + _gen_price(rng)
        # next_length (event.rs:297-310)
        current = cfg.next_adjusted_event(events_so_far)
        events_for_auctions = (cfg.in_flight_auctions * cfg.proportion_denominator) // cfg.auction_proportion
        horizon = cfg.event_timestamp(current + events_for_auctions) - ts
        length = 1 + rng.gen_range_u64(max(horizon * 2, 1))
        category = cfg.first_category_id + rng.gen_range_u64(cfg.num_categories)
        row = {
            "a_id": auction_last_id(event_id, cfg) + cfg.first_auction_id,
            "initial_bid": initial_bid,
            "reserve": reserve,
            "date_time": ts,
            "expires": ts + length,
            "seller": seller + cfg.first_person_id,
            "category": category,
        }
        if self.materialize:
            row["item_name"] = item_name
            row["description"] = description
        return row

    def _bid(self, event_id: int, ts: int, rng: SmallRng):
        cfg = self.cfg
        if rng.gen_range_u64(cfg.hot_auction_ratio) > 0:
            auction = (auction_last_id(event_id, cfg) // cfg.hot_auction_ratio_2) * cfg.hot_auction_ratio_2
        else:
            auction = auction_next_id(event_id, rng, cfg)
        if rng.gen_range_u64(cfg.hot_bidder_ratio) > 0:
            bidder = (person_last_id(event_id, cfg) // cfg.hot_bidder_ratio_2) * cfg.hot_bidder_ratio_2 + 1
        else:
            bidder = person_next_id(event_id, rng, cfg)
        price = _gen_price(rng)
        return {
            "auction": auction + cfg.first_auction_id,
            "bidder": bidder + cfg.first_person_id,
            "price": price,
            "date_time": ts,
        }

    def generate_partition(self, partition: int) -> list[EpochColumns]:
        """generator.rs:45-105: iterate events, split at epoch (second) boundaries."""
        cfg = self.cfg
        epochs: list[EpochColumns] = []
        events = 0
        persons: dict[str, list] = {k: [] for k in ("p_id", "name_code", "city_code", "state_code", "date_time")}
        auctions: dict[str, list] = {k: [] for k in ("a_id", "initial_bid", "reserve", "date_time", "expires", "seller", "category")}
        bids: dict[str, list] = {k: [] for k in ("auction", "bidder", "price", "date_time")}
        strings: dict[str, list] = {}
        cur_epoch = (cfg.event_timestamp(events + cfg.first_event_id) - cfg.base_time) // 1000

        def flush(epoch_no: int):
            epochs.append(
                EpochColumns(
                    epoch=epoch_no,
                    p_id=np.array(persons["p_id"], dtype=np.int32),
                    p_name_code=np.array(persons["name_code"], dtype=np.int32),
                    p_city_code=np.array(persons["city_code"], dtype=np.int32),
                    p_state_code=np.array(persons["state_code"], dtype=np.int32),
                    p_date_time=np.array(persons["date_time"], dtype=np.int64),
                    a_id=np.array(auctions["a_id"], dtype=np.int32),
                    a_initial_bid=np.array(auctions["initial_bid"], dtype=np.int32),
                    a_reserve=np.array(auctions["reserve"], dtype=np.int32),
                    a_date_time=np.array(auctions["date_time"], dtype=np.int64),
                    a_expires=np.array(auctions["expires"], dtype=np.int64),
                    a_seller=np.array(auctions["seller"], dtype=np.int32),
                    a_category=np.array(auctions["category"], dtype=np.int32),
                    b_auction=np.array(bids["auction"], dtype=np.int32),
                    b_bidder=np.array(bids["bidder"], dtype=np.int32),
                    b_price=np.array(bids["price"], dtype=np.int32),
                    b_date_time=np.array(bids["date_time"], dtype=np.int64),
                    strings={k: list(v) for k, v in strings.items()},
                )
            )
            for d in (persons, auctions, bids):
                for v in d.values():
                    v.clear()
            strings.clear()

        while True:
            ts = cfg.event_timestamp(events + cfg.first_event_id)
            next_epoch = (ts - cfg.base_time) // 1000
            if next_epoch >= self.seconds:
                break
            if next_epoch != cur_epoch:
                flush(cur_epoch)
                cur_epoch = next_epoch
            kind, row = self.generate_event(events, partition)
            events += 1
            if kind == "person":
                for k in persons:
                    persons[k].append(row[k])
                if self.materialize:
                    for k in ("name", "email_address", "credit_card", "city", "state"):
                        strings.setdefault("p_" + k, []).append(row[k])
            elif kind == "auction":
                for k in auctions:
                    auctions[k].append(row[k])
                if self.materialize:
                    for k in ("item_name", "description"):
                        strings.setdefault("a_" + k, []).append(row[k])
            else:
                for k in bids:
                    bids[k].append(row[k])
        if any(len(v) for d in (persons, auctions, bids) for v in d.values()):
            flush(cur_epoch)
        return epochs

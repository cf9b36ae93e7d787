"""Data-source layer: stream interfaces + reference-format JSON interop —
copy of ``flock_tpu/datagen/sources.py``.

Reference counterpart: the DataStream trait + per-source drivers
(flock/src/datasource/{mod.rs,kafka.rs,kinesis.rs}) and the line-delimited
JSON wire format the reference generator emits (serde_json rows,
generator.rs:70-99, decoded by event_bytes_to_batch, transmute.rs:255-266).

Sources:
* ``NexmarkSource`` / ``YsbSource`` — deterministic generators (native C++).
  Both return host tables: the driver that runs them takes the device.
* ``JsonFileSource`` — replays reference-format JSONL event files (the
  kafka/kinesis trigger analogue: external events → columnar batches); this
  also demonstrates generator parity: our engine can consume data produced by
  the reference's generator and vice versa (``dump_events_json``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from flock_tpu_torch.datagen.nexmark import (
    FIRST_NAMES,
    LAST_NAMES,
    US_CITIES,
    US_STATES,
    NexmarkConfig,
)


@dataclass
class NexmarkSource:
    """select_event_to_batches analogue over the native generator."""

    seconds: int = 10
    events_per_second: int = 10_000
    generators: int = 1

    def epochs(self):
        from flock_tpu_torch.runtime.stream import generate_epochs

        return generate_epochs(self.seconds, self.events_per_second,
                               self.generators)


@dataclass
class YsbSource:
    seconds: int = 10
    events_per_second: int = 10_000
    generators: int = 1

    def epochs(self):
        from flock_tpu_torch.datagen.ysb import YsbConfig
        from flock_tpu_torch.queries.ysb import generate_ysb_epochs

        return generate_ysb_epochs(YsbConfig(
            seconds=self.seconds, events_per_second=self.events_per_second,
            threads=self.generators))


# -- reference JSON wire format ---------------------------------------------

_PERSON_KEYS = ("p_id", "name", "email_address", "credit_card", "city",
                "state", "p_date_time")
_AUCTION_KEYS = ("a_id", "item_name", "description", "initial_bid", "reserve",
                 "a_date_time", "expires", "seller", "category")
_BID_KEYS = ("auction", "bidder", "price", "b_date_time")


def _parse_int_lines_native(lines, spec) -> dict[str, np.ndarray] | None:
    """All-integer line-JSON rows → columns via the native parser
    (native/jsonl.cpp — the engine's event_bytes_to_batch hot loop,
    transmute.rs:255-266); None on any non-conforming row (caller falls
    back to the Python path).  A library that does not build raises."""
    from flock_tpu_torch.native import jsonl_parse_int_columns

    if isinstance(lines, (list, tuple)):
        data = "\n".join(lines).encode()
        max_rows = len(lines)
    else:
        data = lines if isinstance(lines, bytes) else str(lines).encode()
        max_rows = data.count(b"\n") + 1
    if not max_rows:
        max_rows = 1
    cols = jsonl_parse_int_columns(data, [k for k, _ in spec], max_rows)
    if cols is None:
        return None
    return {k: cols[k].astype(dt) for k, dt in spec}


_BID_SPEC = (("auction", np.int32), ("bidder", np.int32),
             ("price", np.int32), ("b_date_time", np.int64))


def parse_bid_lines(lines) -> dict[str, np.ndarray]:
    """Reference serde_json Bid rows → columnar batch (event.rs:314-324).
    Native C parser fast path; Python fallback for non-conforming rows."""
    native = _parse_int_lines_native(lines, _BID_SPEC)
    if native is not None:
        return native
    rows = [json.loads(l) for l in lines if l.strip()]
    return {
        "auction": np.array([r["auction"] for r in rows], np.int32),
        "bidder": np.array([r["bidder"] for r in rows], np.int32),
        "price": np.array([r["price"] for r in rows], np.int32),
        "b_date_time": np.array([r["b_date_time"] for r in rows], np.int64),
    }


def parse_person_lines(lines) -> dict[str, np.ndarray]:
    """Reference Person rows → columnar with dictionary-coded strings."""
    rows = [json.loads(l) for l in lines if l.strip()]
    name_code = []
    for r in rows:
        first, last = r["name"].split(" ", 1)
        name_code.append(FIRST_NAMES.index(first) * len(LAST_NAMES)
                         + LAST_NAMES.index(last))
    return {
        "p_id": np.array([r["p_id"] for r in rows], np.int32),
        "name": np.array(name_code, np.int32),
        "city": np.array([US_CITIES.index(r["city"]) for r in rows], np.int32),
        "state": np.array([US_STATES.index(r["state"]) for r in rows], np.int32),
        "p_date_time": np.array([r["p_date_time"] for r in rows], np.int64),
    }


_AUCTION_SPEC = (("a_id", np.int32), ("initial_bid", np.int32),
                 ("reserve", np.int32), ("a_date_time", np.int64),
                 ("expires", np.int64), ("seller", np.int32),
                 ("category", np.int32))


def parse_auction_lines(lines) -> dict[str, np.ndarray]:
    """Auction rows (string fields item_name/description are skipped by the
    engine's columns; the native parser ignores unrequested strings)."""
    native = _parse_int_lines_native(lines, _AUCTION_SPEC)
    if native is not None:
        return native
    rows = [json.loads(l) for l in lines if l.strip()]
    out = {}
    for k, dt in _AUCTION_SPEC:
        out[k] = np.array([r[k] for r in rows], dt)
    return out


@dataclass
class JsonFileSource:
    """Replay a reference-format JSONL event file into per-epoch batches."""

    path: str
    relation: str = "bid"  # bid | person | auction

    def load(self) -> dict[str, np.ndarray]:
        with open(self.path) as f:
            lines = f.readlines()
        parser = {"bid": parse_bid_lines, "person": parse_person_lines,
                  "auction": parse_auction_lines}[self.relation]
        return parser(lines)


def dump_events_json(path_prefix: str, seconds: int, events_per_second: int,
                     partition: int = 0, generators: int = 1) -> dict[str, str]:
    """Write reference-format JSONL event files (full string fidelity via the
    scalar generator's materialize mode) — the inverse of JsonFileSource and
    the external proof of bit-exact generator parity."""
    from flock_tpu_torch.datagen.nexmark import ScalarGenerator

    cfg = NexmarkConfig(events_per_second=events_per_second,
                        num_event_generators=generators)
    gen = ScalarGenerator(cfg, seconds, materialize_strings=True)
    paths = {}
    files = {}
    for rel in ("person", "auction", "bid"):
        paths[rel] = f"{path_prefix}-{rel}.jsonl"
        files[rel] = open(paths[rel], "w")
    events = 0
    while True:
        ts = cfg.event_timestamp(events + cfg.first_event_id)
        if (ts - cfg.base_time) // 1000 >= seconds:
            break
        kind, row = gen.generate_event(events, partition)
        events += 1
        if kind == "person":
            obj = {"p_id": row["p_id"], "name": row["name"],
                   "email_address": row["email_address"],
                   "credit_card": row["credit_card"], "city": row["city"],
                   "state": row["state"], "p_date_time": row["date_time"]}
        elif kind == "auction":
            obj = {"a_id": row["a_id"], "item_name": row["item_name"],
                   "description": row["description"],
                   "initial_bid": row["initial_bid"], "reserve": row["reserve"],
                   "a_date_time": row["date_time"], "expires": row["expires"],
                   "seller": row["seller"], "category": row["category"]}
        else:
            obj = {"auction": row["auction"], "bidder": row["bidder"],
                   "price": row["price"], "b_date_time": row["date_time"]}
        files[kind if kind != "person" else "person"].write(
            json.dumps(obj) + "\n")
    for f in files.values():
        f.close()
    return paths

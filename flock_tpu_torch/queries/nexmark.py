"""NEXMark query plans with torch expressions — the counterpart of
``flock_tpu/queries/nexmark.py`` (``QuerySpec``, ``_winning_bid_interval``
and q0–q13).

Window per query, as in the reference (main.rs:116-122): q0–q4, q6, q9,
q10 and q13 element-wise (one window per epoch), q5 hopping (10 s, hop
5 s), q7 and q8 tumbling (10 s), q11 session (10 s gap), q12
processing-time (10 s of arrival).

- q0.sql: every bid (pass-through); q10.sql the same columns, projected.
- q1.sql: every bid with its price in another currency, ``0.908 * price``.
  The device computes it in f32 and carries the integer price; the sink
  recomputes the f64 value from it.
- q2.sql: auction and price of the bids on every 123rd auction.
- q3.sql: names, cities and states of sellers in Oregon, Idaho or
  California with an auction in category 10 (person ⋈ auction).
- q4.sql: the average winning price per category, where a bid wins an
  auction when it is the highest bid placed between the auction's start and
  expiry.  The device computes the average in f32 beside the exact integer
  sum and count; the sink recomputes it in f64 from those.
- q5.sql: the auctions with the most bids in each window.
- q6.sql: each seller's average winning price over their last 10 closed
  auctions.  The winning bid of an auction packs (price desc, time asc)
  into one int64 ``__order`` whose max the fused pass takes (kernel K1's
  int64 max); a Rank per seller by time keeps the last 10, and the
  average's exact integer sum and count reach the sink, which divides in
  f64.
- q7.sql: the bids at the window's highest price.
- q8.sql: the persons who opened an auction in the window (new persons ⋈
  distinct sellers, both slotted over person ids: ``kernels.slot_join``).
- q9.sql: the winning bids themselves (every bid whose price equals its
  auction's winning price).
- q11.sql: per bidder session (a bid more than 10 s after the session's
  last one opens a new session), the bids and the first and last bid time.
  The stream driver labels each closed session's rows with ``__session``;
  the device tier (``runtime/device_session.py``) never builds that column
  and aggregates sessions incrementally instead.
- q12.sql: per bidder, the bids and the first and last arrival second of
  each 10 s processing-time window (``p_time``, the arrival epoch in ms,
  made on the device by the executor's ``execute_consts``).
- q13.sql: every bid joined to a bounded side-input table on its auction id.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from flock_tpu_torch.batch import Schema
from flock_tpu_torch.datagen.nexmark import (FIRST_NAMES, LAST_NAMES,
                                             US_CITIES, US_STATES)
from flock_tpu_torch.plan import (Aggregate, Conj, Filter, Join, Node, Project,
                                  Rank, Scan)

# state dictionary codes (vocabulary order: az,ca,id,or,wa,wy)
_CA, _ID, _OR = US_STATES.index("ca"), US_STATES.index("id"), US_STATES.index("or")

NAME_VOCAB = [f"{f} {l}" for f in FIRST_NAMES for l in LAST_NAMES]

SESSION_GAP_S = 10   # q11's session gap (the reference's default)
PTIME_WINDOW_S = 10  # q12's processing-time window (the reference's default)


@dataclass(frozen=True)
class QuerySpec:
    number: int
    plan: Node
    window: tuple  # ("elementwise",) | ("tumbling", s) | ("hopping", w, h) |
    #               ("sliding", w, slide) | ("stagger", w) | ("rows", n) |
    #               ("session", gap) | ("global", s)
    #               — see flock_tpu_torch/window.py
    relations: tuple[str, ...]
    schema: Schema  # output schema (column order + dictionaries + ts cols)


def _winning_bid_interval(extra_take: tuple = ()) -> Node:
    """auction ⋈ bid ON a_id = auction AND b_date_time BETWEEN a_date_time
    AND expires — the shared core of q4/q6/q9.  The interval predicate is a
    ``Conj``, so the fused kernel can read it."""
    return Join(
        build=Scan("auction"), probe=Scan("bid"),
        build_key="a_id", probe_key="auction",
        take=(("a_date_time", "a_date_time"), ("expires", "expires")) + extra_take,
        post_filter=Conj((("b_date_time", ">=", "a_date_time"),
                          ("b_date_time", "<=", "expires"))),
    )


def q0() -> QuerySpec:
    return QuerySpec(
        0, Scan("bid"), ("elementwise",), ("bid",),
        Schema(["auction", "bidder", "price", "b_date_time"],
               timestamp_cols=("b_date_time",)))


def q1() -> QuerySpec:
    plan = Project(Scan("bid"), (
        ("auction", "auction"),
        ("bidder", "bidder"),
        ("price", lambda c: 0.908 * c["price"].to(torch.float32)),
        ("price_cents", "price"),   # exact basis for the sink's f64 recompute
        ("b_date_time", "b_date_time"),
    ))
    return QuerySpec(
        1, plan, ("elementwise",), ("bid",),
        Schema(["auction", "bidder", "price", "b_date_time"],
               timestamp_cols=("b_date_time",)))


def q2() -> QuerySpec:
    plan = Project(
        Filter(Scan("bid"), lambda c: c["auction"] % 123 == 0, "auction%123=0"),
        (("auction", "auction"), ("price", "price")),
    )
    return QuerySpec(2, plan, ("elementwise",), ("bid",),
                     Schema(["auction", "price"]))


def q3() -> QuerySpec:
    person = Filter(
        Scan("person"),
        lambda c: (c["state"] == _OR) | (c["state"] == _ID) | (c["state"] == _CA),
        "state in (or,id,ca)",
    )
    auction = Filter(Scan("auction"), lambda c: c["category"] == 10,
                     "category=10")
    plan = Project(
        Join(build=person, probe=auction, build_key="p_id", probe_key="seller",
             take=(("name", "name"), ("city", "city"), ("state", "state"))),
        (("name", "name"), ("city", "city"), ("state", "state"),
         ("a_id", "a_id")),
    )
    return QuerySpec(
        3, plan, ("elementwise",), ("person", "auction"),
        Schema(["name", "city", "state", "a_id"],
               dictionaries={"name": NAME_VOCAB, "city": US_CITIES,
                             "state": US_STATES}),
    )


def q4() -> QuerySpec:
    # GROUP BY a_id, category (q4.sql).  The fused clean pass groups by a_id
    # and carries category as a max (functionally dependent while auction ids
    # are unique); duplicate auction ids escape to the fan-out join plus the
    # two-key aggregation.
    per_auction = Aggregate(
        _winning_bid_interval((("category", "category"),)),
        group_keys=("auction", "category"),
        aggs=(("price", "max", "final"),),
    )
    per_category = Aggregate(
        per_auction,
        group_keys=("category",),
        aggs=(("final", "sum", "sum_final"), (None, "count", "cnt")),
        out_capacity=128,  # 5 categories (config.rs:130)
    )
    plan = Project(per_category, (
        ("category", "category"),
        ("avg_final", lambda c: c["sum_final"].to(torch.float32)
         / c["cnt"].clamp(min=1).to(torch.float32)),
        ("sum_final", "sum_final"),  # exact basis for the sink's f64 division
        ("cnt", "cnt"),
    ))
    return QuerySpec(4, plan, ("elementwise",), ("auction", "bid"),
                     Schema(["category", "avg_final"]))


def q5() -> QuerySpec:
    # the bid count per auction (K2), its max over the constant key __g (K2
    # again, 8 slots), gathered back to every auction (K3 from that slotted
    # build) and compared
    counts = Aggregate(Scan("bid"), group_keys=("auction",),
                       aggs=((None, "count", "num"),))
    with_const = Project(counts, (
        ("auction", "auction"), ("num", "num"),
        ("__g", lambda c: torch.zeros_like(c["num"])),
    ))
    maxn = Aggregate(with_const, group_keys=("__g",),
                     aggs=(("num", "max", "maxn"),), out_capacity=8)
    plan = Project(
        Join(build=maxn, probe=with_const, build_key="__g", probe_key="__g",
             take=(("maxn", "maxn"),),
             post_filter=Conj((("num", ">=", "maxn"),))),
        (("auction", "auction"), ("num", "num")),
    )
    return QuerySpec(5, plan, ("hopping", 10, 5), ("bid",),
                     Schema(["auction", "num"]))


def q6() -> QuerySpec:
    # the winning bid per auction is an argmax: (price desc, b_date_time
    # asc) packs into price << 32 | (2^32 - 1 - b_date_time), whose max per
    # auction the fused pass takes; __order reads only bid columns, so the
    # fused replay computes it on the probe side before K1
    joined = _winning_bid_interval((("seller", "seller"),))
    with_key = Project(joined, (
        ("auction", "auction"), ("seller", "seller"),
        ("__order", lambda c: (c["price"].to(torch.int64) << 32)
         | (0xFFFFFFFF - c["b_date_time"].to(torch.int64))),
    ))
    # seller rides a winner-carry (min seller over the rows at the max
    # __order): a plain max while auction ids are unique, and the SQL
    # tiebreak (price desc, time asc, seller asc) when duplicate auction
    # rows carry different sellers (the fan-out rerun)
    win_agg = Aggregate(with_key, group_keys=("auction",),
                        aggs=(("__order", "max", "__order"),
                              ("seller", "wmin:__order", "seller")))
    winners = Project(win_agg, (
        ("auction", "auction"), ("seller", "seller"),
        ("price", lambda c: (c["__order"] >> 32).to(torch.int32)),
        ("b_date_time", lambda c: (0xFFFFFFFF - (c["__order"] & 0xFFFFFFFF))
         .to(torch.int32)),
    ))
    time_rank = Rank(winners, group_key="seller", order_col="b_date_time",
                     descending=True, rank_name="time_rank",
                     tiebreak="auction")
    last10 = Filter(time_rank, lambda c: c["time_rank"] <= 10,
                    "time_rank<=10")
    # sorted by seller after the Rank: the sorted-segment aggregation
    per_seller = Aggregate(last10, group_keys=("seller",),
                           aggs=(("price", "sum", "sum_price"),
                                 (None, "count", "cnt")))
    plan = Project(per_seller, (
        ("seller", "seller"),
        ("avg_price", lambda c: c["sum_price"].to(torch.float32)
         / c["cnt"].clamp(min=1).to(torch.float32)),
        ("sum_price", "sum_price"),  # exact basis for the sink's f64 division
        ("cnt", "cnt"),
    ))
    return QuerySpec(6, plan, ("elementwise",), ("auction", "bid"),
                     Schema(["seller", "avg_price"]))


def q7() -> QuerySpec:
    # the max price over one constant key (K2), gathered to every bid (K3)
    with_const = Project(Scan("bid"), (
        ("auction", "auction"), ("bidder", "bidder"), ("price", "price"),
        ("b_date_time", "b_date_time"),
        ("__g", lambda c: torch.zeros_like(c["price"])),
    ))
    maxprice = Aggregate(with_const, group_keys=("__g",),
                         aggs=(("price", "max", "maxprice"),), out_capacity=8)
    plan = Project(
        Join(build=maxprice, probe=with_const, build_key="__g",
             probe_key="__g", take=(("maxprice", "maxprice"),),
             post_filter=Conj((("price", "==", "maxprice"),))),
        (("auction", "auction"), ("price", "price"), ("bidder", "bidder"),
         ("b_date_time", "b_date_time")),
    )
    return QuerySpec(7, plan, ("tumbling", 10), ("bid",),
                     Schema(["auction", "price", "bidder", "b_date_time"],
                            timestamp_cols=("b_date_time",)))


def q8() -> QuerySpec:
    # GROUP BY p_id, name ≡ GROUP BY p_id with name carried (dependent col).
    # Both aggregates slot over person ids, so the join lowers to the
    # shifted copy of kernels.slot_join
    people = Aggregate(Scan("person"), group_keys=("p_id",),
                       aggs=(("name", "max", "name"),))
    sellers = Aggregate(Scan("auction"), group_keys=("seller",), aggs=())
    plan = Project(
        Join(build=people, probe=sellers, build_key="p_id", probe_key="seller",
             take=(("name", "name"),)),
        (("p_id", lambda c: c["seller"]), ("name", "name")),
    )
    return QuerySpec(8, plan, ("tumbling", 10), ("person", "auction"),
                     Schema(["p_id", "name"],
                            dictionaries={"name": NAME_VOCAB}))


def q9() -> QuerySpec:
    # the fused winning-bid pass slots its output by auction id, so the second
    # join reuses those slots as its build side (kernels.lookup_join
    # build_slotted); its post-filter runs on the joined rows
    final_per_auction = Aggregate(
        _winning_bid_interval(),
        group_keys=("auction",),
        aggs=(("price", "max", "final"),),
    )
    plan = Project(
        Join(build=final_per_auction, probe=Scan("bid"),
             build_key="auction", probe_key="auction",
             take=(("final", "final"),),
             post_filter=lambda c: c["price"] == c["final"]),
        (("auction", "auction"), ("bidder", "bidder"), ("price", "price"),
         ("b_date_time", "b_date_time")),
    )
    return QuerySpec(9, plan, ("elementwise",), ("auction", "bid"),
                     Schema(["auction", "bidder", "price", "b_date_time"],
                            timestamp_cols=("b_date_time",)))


def q10() -> QuerySpec:
    plan = Project(Scan("bid"), (
        ("auction", "auction"), ("bidder", "bidder"), ("price", "price"),
        ("b_date_time", "b_date_time"),
    ))
    return QuerySpec(10, plan, ("elementwise",), ("bid",),
                     Schema(["auction", "bidder", "price", "b_date_time"],
                            timestamp_cols=("b_date_time",)))


def q11() -> QuerySpec:
    # The stream driver slices sessions per bidder and feeds closed sessions
    # with a __session id column; __session ids are unique per session, so
    # GROUP BY __session with the bidder carried is one row per session
    plan = Project(
        Aggregate(Scan("bid"), group_keys=("__session",),
                  aggs=(("bidder", "max", "bidder"),
                        (None, "count", "bid_count"),
                        ("b_date_time", "min", "start_time"),
                        ("b_date_time", "max", "end_time"))),
        (("bidder", "bidder"), ("bid_count", "bid_count"),
         ("start_time", "start_time"), ("end_time", "end_time")),
    )
    return QuerySpec(11, plan, ("session", SESSION_GAP_S), ("bid",),
                     Schema(["bidder", "bid_count", "start_time", "end_time"],
                            timestamp_cols=("start_time", "end_time")))


def q12() -> QuerySpec:
    # p_time is attached by the stream driver (the arrival epoch in ms, one
    # constant per staged chunk); the plan groups per bidder within the
    # processing-time window
    plan = Aggregate(Scan("bid"), group_keys=("bidder",),
                     aggs=((None, "count", "bid_count"),
                           ("p_time", "min", "start_time"),
                           ("p_time", "max", "end_time")))
    return QuerySpec(12, plan, ("global", PTIME_WINDOW_S), ("bid",),
                     Schema(["bidder", "bid_count", "start_time", "end_time"]))


def q13() -> QuerySpec:
    # q13.sql joins ON auction = key directly.  side_input is a bounded
    # (key int32, value int32) table the runtime stages once per run
    # (runtime/tables.default_side_input, or a CSV)
    plan = Project(
        Join(build=Scan("side_input"), probe=Scan("bid"),
             build_key="key", probe_key="auction",
             take=(("value", "value"),),
             unique_build=True),  # catalog fact: side-input keys are unique
        (("auction", "auction"), ("bidder", "bidder"), ("price", "price"),
         ("b_date_time", "b_date_time"), ("value", "value")),
    )
    return QuerySpec(13, plan, ("elementwise",), ("bid", "side_input"),
                     Schema(["auction", "bidder", "price", "b_date_time",
                             "value"], timestamp_cols=("b_date_time",)))


QUERIES = {0: q0, 1: q1, 2: q2, 3: q3, 4: q4, 5: q5, 6: q6, 7: q7, 8: q8,
           9: q9, 10: q10, 11: q11, 12: q12, 13: q13}


def get_query(n: int) -> QuerySpec:
    if n not in QUERIES:
        raise NotImplementedError(f"NEXMark q{n} is not ported yet")
    return QUERIES[n]()

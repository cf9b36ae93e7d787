"""Adversarial inputs for kernels K1 (fused join-aggregate, its int64 max
included), K2 (dense grouped aggregate) and K3 (probe-side gather), numpy
arrays made from a seed.  Shared by the CPU tests
(``test_torch_kernel_cases.py``, ``test_torch_gather_cases.py``,
``test_torch_join_agg_i64.py``: the plain versions against flock_tpu and
numpy), the card tests (``test_torch_cuda.py``: the kernels against their
plain versions, at sizes past K1's 1024-row tile and 2048-slot window) and
``chip_smoke.py`` (K1's int64 cases).  Imports neither JAX nor torch."""

import numpy as np

# q4's interval predicate and every aggregate kind over probe columns (the
# pair-by-pair path) and over slot columns (written from the pair count)
K1_TERMS = (("b_ts", ">=", "ats"), ("b_ts", "<=", "exp"))
K1_AGGS = [(None, "count", "c"), ("b_ts", "count_sum", "cs"),
           ("price", "sum", "s"), ("price", "min", "mn"),
           ("price", "max", "mx"), ("cat", "max", "cat"),
           ("ats", "count_sum", "acs"), ("exp", "sum", "es"),
           ("ats", "min", "amn")]

K1_CASES = (
    "one_slot",           # every probe key on one slot: every lane collides
    "uniform",            # keys uniform over the span: the window misses
    "behind_and_before",  # keys far behind the frontier, and before m
    "small_span",         # span below the window
    "n_odd",              # n below a tile, not a multiple of 4 or 16
    "n_1",
    "all_invalid",
)


def k1_case(name: str, span: int = 4096, n: int = 8192, seed: int = 0):
    """(slot_cols, present, m, probe_cols, probe_valid) for the probe key
    ``k``.  Sum values are non-negative: the reference's limb sums are exact
    only for those."""
    rng = np.random.default_rng(seed)
    span = {"small_span": 100}.get(name, span)
    n = {"n_odd": 1003, "n_1": 1}.get(name, n)
    m = 10_000
    present = rng.random(span) < 0.8
    ats = rng.integers(0, 500, span).astype(np.int32)
    exp = (ats + rng.integers(10, 400, span)).astype(np.int32)
    cat = rng.integers(10, 15, span).astype(np.int32)
    frontier = np.arange(n, dtype=np.int64) * span // max(n, 1)
    near = frontier - rng.integers(0, 100, n)
    if name in ("one_slot", "n_1"):   # a present slot every bid passes
        rel = np.full(n, span // 3)
        present[span // 3] = True
        ats[span // 3], exp[span // 3] = 0, 10**6
    elif name == "uniform":
        rel = rng.integers(-50, span + 50, n)
    elif name == "behind_and_before":
        r = rng.random(n)
        rel = np.where(r < 0.6, near,
                       np.where(r < 0.85, rng.integers(0, max(span // 8, 1), n),
                                -rng.integers(1, 3000, n)))
    else:
        rel = near
    probe = {"k": (m + rel).astype(np.int32),
             "price": rng.integers(0, 10**6, n).astype(np.int32),
             "b_ts": rng.integers(0, 900, n).astype(np.int32)}
    valid = (rng.random(n) < 0.9) | (name == "n_1")
    valid &= name != "all_invalid"
    return ({"ats": ats, "exp": exp, "cat": cat}, present, np.int32(m), probe,
            valid)


I64_MIN, I64_MAX = -(2**63), 2**63 - 1

# K1's int64 max (q6's __order): the int64 probe column "o" under max beside
# an int32 probe max and a slot-column carry, with q4's interval predicate
K1_I64_AGGS = [(None, "count", "c"), ("o", "max", "omax"),
               ("price", "max", "mx"), ("cat", "max", "cat")]

K1_I64_CASES = (
    "extremes",        # INT64_MIN, INT64_MAX and their neighbours among others
    "negative",        # every value negative
    "low_bits",        # equal high 32 bits: only the low words (some with
                       # their top bit set) decide
    "high_bits",       # equal low 32 bits: only the signed high words decide
    "one_slot",        # every pair on one slot
    "outside_window",  # keys far behind the frontier and before m: K1's
                       # window misses them (the global-atomic path)
    "all_invalid",
)


def k1_i64_case(name: str, span: int = 4096, n: int = 8192, seed: int = 0):
    """(slot_cols, present, m, probe_cols, probe_valid): ``k1_case``'s
    shapes with an int64 probe column ``o``."""
    # keys near the frontier unless the case says otherwise
    base = {"one_slot": "one_slot", "outside_window": "behind_and_before",
            "all_invalid": "all_invalid"}.get(name, "near")
    slots, present, m, probe, valid = k1_case(base, span, n, seed)
    rng = np.random.default_rng(seed + 1)
    if name == "extremes":
        pool = np.array([I64_MIN, I64_MIN + 1, I64_MAX, I64_MAX - 1, 0, -1],
                        np.int64)
        o = np.where(rng.random(n) < 0.5, pool[rng.integers(0, len(pool), n)],
                     rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64,
                                  endpoint=True))
    elif name == "negative":
        o = rng.integers(I64_MIN, 0, n, dtype=np.int64)
    elif name == "low_bits":
        o = (np.int64(-0x12345678) << 32) \
            | rng.integers(0, 2**32, n, dtype=np.int64)
    elif name == "high_bits":
        hi = rng.integers(-(2**31), 2**31, n, dtype=np.int64)
        o = (hi << 32) | np.int64(0x9ABCDEF0)
    else:
        o = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64, endpoint=True)
    return slots, present, m, dict(probe, o=o.astype(np.int64)), valid


def k1_i64_numpy(slots, present, m, probe, valid):
    """Max of ``o`` per slot over the pairs that pass q4's interval
    predicate, INT64_MIN where none does, and the pair count."""
    span = len(present)
    rel = probe["k"].astype(np.int64) - int(m)
    ok = valid & (rel >= 0) & (rel < span)
    r = np.where(ok, rel, 0)
    ok &= present[r] & (probe["b_ts"] >= slots["ats"][r]) \
        & (probe["b_ts"] <= slots["exp"][r])
    omax = np.full(span, I64_MIN, np.int64)
    np.maximum.at(omax, r[ok], probe["o"][ok])
    cnt = np.bincount(r[ok], minlength=span).astype(np.int32)
    return omax, cnt


# every aggregate kind: 24 bytes of shared memory per copy of a slot (sum 8,
# the row count 4, count_sum 4, min 4, max 4).  K2's lane-private variant
# (32 copies of every slot within its 32 KB budget, ops/dense_agg.py
# LANES_BYTES) takes caps up to 32 KB / (32 x 24) = 42, its block-shared one
# (one copy within 48 KB) up to 48 KB / 24 = 2048, and the global-atomics
# one from 2049
K2_AGGS = [(None, "count", "c"), ("v", "count_sum", "cs"), ("w", "sum", "s"),
           ("v", "min", "mn"), ("v", "max", "mx"), (None, "dups", "d")]
K2_LANES_CAP = 32 * 1024 // (32 * 24)
K2_SHARED_CAP = 48 * 1024 // 24
# YSB's count per campaign: the row count (and the duplicate flag) alone
K2_COUNT_AGGS = [(None, "count", "c"), (None, "dups", "d")]

K2_CASES = (
    "one_slot",          # every key equal: every lane collides
    "uniform",           # keys uniform over the capacity
    "n_odd",             # not a multiple of 4 or 16
    "n_1",
    "all_invalid",       # m stays the sentinel, every slot invalid
    "unique",            # ascending unique keys (build slotting): no duplicate
    "cap_lanes",         # the largest capacity of the lane-private variant
    "cap_lanes_plus1",   # the smallest of the block-shared one past it
    "cap_shared",        # the largest capacity of the shared-memory variant
    "cap_global",        # the smallest of the global-atomics variant
    "ysb_count",         # YSB's count (K2_COUNT_AGGS): 100 live slots of 128,
                         # a third of the rows valid, n one past a multiple of 4
)


def k2_aggs(name: str) -> list:
    """The aggregates case ``name`` runs with."""
    return K2_COUNT_AGGS if name == "ysb_count" else K2_AGGS


def k2_case(name: str, n: int = 8192, cap: int = 4096, seed: int = 0):
    """(keys, valid, cols, capacity).  ``w`` (summed) is non-negative: the
    reference's dense sums are exact only for those."""
    rng = np.random.default_rng(seed)
    n = {"n_odd": 1003, "n_1": 1, "ysb_count": n + 1}.get(name, n)
    cap = {"cap_lanes": K2_LANES_CAP,
           "cap_lanes_plus1": K2_LANES_CAP + 1,
           "cap_shared": K2_SHARED_CAP,
           "cap_global": K2_SHARED_CAP + 1,
           "ysb_count": 128}.get(name, cap)
    if name == "one_slot":
        keys = np.full(n, 77)
    elif name == "unique":
        keys = 5 + np.arange(n)
        cap = max(cap, n)
    elif name == "ysb_count":
        keys = 3 + rng.integers(0, 100, n)
    else:
        keys = 3 + rng.integers(0, cap, n)
    valid_p = {"all_invalid": 0.0, "ysb_count": 1 / 3}.get(name, 0.9)
    valid = rng.random(n) < valid_p
    cols = {"v": rng.integers(-(10**9), 10**9, n).astype(np.int32),
            "w": rng.integers(0, 10**6, n).astype(np.int32)}
    return keys.astype(np.int32), valid, cols, cap


K3_CASES = (
    "one_slot",      # every key on one present slot
    "all_miss",      # every key a miss: below, above the span, absent, invalid
    "far_above",     # m near INT32_MIN, keys near INT32_MAX
    "far_below",     # m near INT32_MAX, keys near INT32_MIN: key - m wraps
                     # into the span in 32 bits, never in 64
    "span_1",
    "n_1", "n_3", "n_4", "n_5", "n_1003",   # ragged and tiny quads
    "wide",          # one 8-byte column
    "mixed",         # 4- and 8-byte columns: the run-time signature
    "eight_cols",    # the most columns one launch takes
    "carry",         # q3's signature (three 4-byte columns) carrying mixed
                     # widths to E > n rows
    "carry_ragged",  # mixed columns, n and E not multiples of 4
)
# the cases whose columns are 4-byte and whose key - m fits in int32, which
# the reference's pallas_factored_gather (int32 planes, 32-bit difference)
# takes
K3_PALLAS_CASES = ("one_slot", "all_miss", "span_1", "n_1", "n_3", "n_4",
                   "n_5", "n_1003", "carry")
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def k3_case(name: str, span: int = 4096, n: int = 8192, seed: int = 0):
    """(slot_cols, present, m, keys, valid, out_rows, carry): ``out_rows``
    and ``carry`` are None unless the case carries probe columns."""
    rng = np.random.default_rng(seed)
    span = {"span_1": 1}.get(name, span)
    n = {"n_1": 1, "n_3": 3, "n_4": 4, "n_5": 5, "n_1003": 1003,
         "carry_ragged": 1003}.get(name, n)
    # far_below: slots 0..99 hold keys up to I32_MAX, the rest keys past it
    m = {"far_above": I32_MIN + 7, "far_below": I32_MAX - 99}.get(name, 1000)
    present = rng.random(span) < 0.8
    # keys near an advancing frontier, some behind m and past the span
    rel = np.arange(n, dtype=np.int64) * span // max(n, 1) \
        + rng.integers(-40, 40, n)
    if name == "one_slot":
        rel = np.full(n, span // 3)
        present[span // 3] = True
    elif name == "all_miss":
        r = rng.random(n)
        rel = np.where(r < 0.4, -rng.integers(1, 10**6, n),
                       np.where(r < 0.8, span + rng.integers(0, 10**6, n),
                                rel))
        present[:] = False
    elif name == "far_above":
        # far keys are I32_MAX - j: key - m is ~2^32 in 64 bits, < 0 in 32
        far = rng.random(n) < 0.5
        rel = np.where(far, I32_MAX - rng.integers(0, span, n) - m, rel)
    elif name == "far_below":
        # far keys are I32_MIN + j: key - m + 2^32 lands in [100, span)
        far = rng.random(n) < 0.5
        rel = np.where(far, I32_MIN + rng.integers(0, span - 100, n) - m,
                       rng.integers(0, 100, n))
    elif name == "span_1":
        rel = rng.integers(-1, 2, n)
        present[0] = True
    keys = (m + rel).astype(np.int32)
    valid = (rng.random(n) < 0.9) | (n == 1)
    if name == "all_miss":
        valid = rng.random(n) < 0.9
    i32 = rng.integers(I32_MIN, I32_MAX, span, endpoint=True).astype(np.int32)
    i64 = rng.integers(-(2**62), 2**62, span).astype(np.int64)
    if name in ("wide",):
        slots = {"ts": i64}
    elif name in ("mixed", "carry_ragged"):
        slots = {"a": i32, "ts": i64, "f": rng.random(span).astype(np.float32),
                 "d": rng.random(span)}
    elif name == "eight_cols":
        slots = {f"c{j}": (i64 + j if j % 3 == 0 else (i32 ^ j))
                 for j in range(8)}
    elif name == "carry":
        slots = {"name": rng.integers(0, 100, span).astype(np.int32),
                 "city": rng.integers(0, 10, span).astype(np.int32),
                 "state": i32}
    else:
        slots = {"v": i32}
    if not name.startswith("carry"):
        return slots, present, np.int32(m), keys, valid, None, None
    # the probe columns of a duplicate-faithful join: the key itself and
    # columns of every element width, padded to dup_expand_capacity(n)
    carry = {"seller": keys,
             "t64": rng.integers(-(2**62), 2**62, n).astype(np.int64),
             "flag": rng.random(n) < 0.5,
             "i16": rng.integers(-2**15, 2**15, n).astype(np.int16),
             "u8": rng.integers(0, 256, n).astype(np.uint8),
             "price": rng.integers(0, 10**8, n).astype(np.int32),
             "x": rng.random(n)}
    out_rows = n + max((n // 2 + 127) // 128 * 128, 128)
    if name == "carry_ragged":
        out_rows = n + 6
    return slots, present, np.int32(m), keys, valid, out_rows, carry

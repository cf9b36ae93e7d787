"""Adversarial inputs for kernels K1 (fused join-aggregate) and K2 (dense
grouped aggregate), numpy arrays made from a seed.  Shared by the CPU tests
(``test_torch_kernel_cases.py``: the plain versions against flock_tpu) and
the card tests (``test_torch_cuda.py``: the kernels against their plain
versions, at sizes past K1's 2048-row tile and 2048-slot window).  Imports
neither JAX nor torch."""

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


# every aggregate kind: 28 bytes of shared memory per slot (sum 8, count 4,
# count_sum 4, min 4, max 4), so K2's block-private variant takes caps up to
# 48 KB / 28 = 1755 slots and the global one from 1756
K2_AGGS = [(None, "count", "c"), ("v", "count_sum", "cs"), ("w", "sum", "s"),
           ("v", "min", "mn"), ("v", "max", "mx"), (None, "dups", "d")]
K2_SHARED_CAP = 48 * 1024 // 28

K2_CASES = (
    "one_slot",          # every key equal: every lane collides
    "uniform",           # keys uniform over the capacity
    "n_odd",             # not a multiple of 4 or 16
    "n_1",
    "all_invalid",       # m stays the sentinel, every slot invalid
    "unique",            # ascending unique keys (build slotting): no duplicate
    "cap_shared",        # the largest capacity of the shared-memory variant
    "cap_global",        # the smallest of the global-atomics variant
)


def k2_case(name: str, n: int = 8192, cap: int = 4096, seed: int = 0):
    """(keys, valid, cols, capacity).  ``w`` (summed) is non-negative: the
    reference's dense sums are exact only for those."""
    rng = np.random.default_rng(seed)
    n = {"n_odd": 1003, "n_1": 1}.get(name, n)
    cap = {"cap_shared": K2_SHARED_CAP,
           "cap_global": K2_SHARED_CAP + 1}.get(name, cap)
    if name == "one_slot":
        keys = np.full(n, 77)
    elif name == "unique":
        keys = 5 + np.arange(n)
        cap = max(cap, n)
    else:
        keys = 3 + rng.integers(0, cap, n)
    valid = rng.random(n) < 0.9 if name != "all_invalid" else np.zeros(n, bool)
    cols = {"v": rng.integers(-(10**9), 10**9, n).astype(np.int32),
            "w": rng.integers(0, 10**6, n).astype(np.int32)}
    return keys.astype(np.int32), valid, cols, cap

"""Kernel K2 (dense-key grouped aggregation): the port's plain version, as
the CPU path of ``dense_agg`` and of ``kernels.dense_group_aggregate``,
against the reference's ``dense_group_aggregate`` and against
``pallas_factored_agg`` in interpret mode.  Every comparison is exact, every
slot included (PyTorch port, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flock_tpu.ops import kernels as ref_kernels
from flock_tpu.pallas import factored
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.ops import dense_agg as dense_agg_module
from flock_tpu_torch.ops.dense_agg import dense_agg
from torch_kernel_cases import K2_AGGS, K2_LANES_CAP, K2_SHARED_CAP

torch.set_num_threads(1)

AGGS = [(None, "count", "c"), ("v", "count_sum", "cs"), ("w", "sum", "s"),
        ("v", "min", "mn"), ("v", "max", "mx")]


def _inputs(seed, n=8192, span=4096, valid_p=0.9, signed_sums=True):
    """Keys near an advancing frontier (the locality the TPU kernel's
    window needs, so its escape stays clear)."""
    rng = np.random.default_rng(seed)
    frontier = (np.arange(n, dtype=np.int64) * (span - 2048) // n).astype(np.int32)
    keys = (frontier + rng.integers(-120, 10, n)).clip(0).astype(np.int32) + 5
    v = rng.integers(-(10**8), 10**8, n).astype(np.int32)
    lo = -(10**6) if signed_sums else 0
    w = rng.integers(lo, 10**6, n).astype(np.int32)
    valid = rng.random(n) < valid_p
    return keys, valid, {"v": v, "w": w}


def _torch(keys, valid, cols):
    return (torch.from_numpy(keys), torch.from_numpy(valid),
            {k: torch.from_numpy(a) for k, a in cols.items()})


def _assert_same(got: dict, ref: dict, names):
    for k in names:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.dtype == r.dtype, (k, g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.mark.parametrize("seed,span", [(0, 4096), (1, 4096), (2, 2500)])
def test_matches_reference_dense_group_aggregate(seed, span):
    """The reference's dense path at these shapes (full one-hot) sums 8-bit
    limbs whose top limb is unsigned, so its int64 sums are exact only for
    non-negative values: the sum column is non-negative here."""
    keys, valid, cols = _inputs(seed, span=span, signed_sums=False)
    ref = ref_kernels.dense_group_aggregate(
        {"k": jnp.asarray(keys), **{c: jnp.asarray(a) for c, a in cols.items()}},
        jnp.asarray(valid), "k", AGGS, span)
    k, v, c = _torch(keys, valid, cols)
    got = kernels.dense_group_aggregate({"k": k, **c}, v, "k", AGGS, span)
    _assert_same(got[0], ref[0], ["k", "c", "cs", "s", "mn", "mx"])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert bool(got[2]) == bool(ref[2]) is False


@pytest.mark.parametrize("seed", [3, 4])
def test_matches_pallas_factored_agg(seed):
    """Signed values in the sum column: the factored kernel keeps its top
    limb signed, so int64 sums are exact for negative values too."""
    span = 4096
    keys, valid, cols = _inputs(seed, span=span)
    ref_out, ref_valid, esc = factored.pallas_factored_agg(
        jnp.asarray(keys), jnp.asarray(valid),
        {c: jnp.asarray(a) for c, a in cols.items()}, AGGS, span,
        s_loc=1024, interpret=True)
    assert not bool(esc)
    got, gvalid, ovf = dense_agg(*_torch(keys, valid, cols), AGGS, span)
    _assert_same(got, ref_out, ["__key", "c", "cs", "s", "mn", "mx"])
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(ref_valid))
    assert not bool(ovf)


def test_overflow():
    """Keys at or beyond min + out_capacity raise overflow and are dropped
    (the rows in range still aggregate, as in the reference)."""
    cap = 1024
    keys, valid, cols = _inputs(5, span=4096)
    ref = ref_kernels.dense_group_aggregate(
        {"k": jnp.asarray(keys), **{c: jnp.asarray(a) for c, a in cols.items()}},
        jnp.asarray(valid), "k", AGGS[:2] + AGGS[3:], cap)
    k, v, c = _torch(keys, valid, cols)
    got = kernels.dense_group_aggregate({"k": k, **c}, v, "k",
                                        AGGS[:2] + AGGS[3:], cap)
    assert bool(got[2]) and bool(ref[2])
    _assert_same(got[0], ref[0], ["k", "c", "cs", "mn", "mx"])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _, _, esc = factored.pallas_factored_agg(
        jnp.asarray(keys), jnp.asarray(valid),
        {c: jnp.asarray(a) for c, a in cols.items()}, AGGS, cap,
        s_loc=1024, interpret=True)
    _, _, ovf = dense_agg(k, v, c, AGGS, cap)
    assert bool(esc) and bool(ovf)


def test_all_invalid():
    """No valid row: every slot keeps its sentinel, nothing is valid,
    nothing overflows, and the key column wraps like the reference's."""
    keys, valid, cols = _inputs(6, span=2048, valid_p=0.0)
    ref = ref_kernels.dense_group_aggregate(
        {"k": jnp.asarray(keys), **{c: jnp.asarray(a) for c, a in cols.items()}},
        jnp.asarray(valid), "k", AGGS, 2048)
    k, v, c = _torch(keys, valid, cols)
    got = kernels.dense_group_aggregate({"k": k, **c}, v, "k", AGGS, 2048)
    _assert_same(got[0], ref[0], ["k", "c", "cs", "s", "mn", "mx"])
    assert not got[1].any() and not bool(got[2])
    assert got[0]["mn"].eq(2**31 - 1).all() and got[0]["mx"].eq(-(2**31)).all()


def test_slotting_shape():
    """q4's build slotting: ascending unique ids, max of the taken columns
    and a duplicate count, span = rows + margin (the global-atomics variant
    on the card)."""
    rng = np.random.default_rng(7)
    n, span = 6000, 6000 + 8192
    keys = (1000 + np.arange(n)).astype(np.int32)
    cols = {"a": rng.integers(0, 10**6, n).astype(np.int32),
            "cat": rng.integers(10, 15, n).astype(np.int32)}
    valid = np.arange(n) < n - 100
    aggs = [("a", "max", "a"), ("cat", "max", "cat"), (None, "count", "dup")]
    ref = ref_kernels.dense_group_aggregate(
        {"k": jnp.asarray(keys), **{c: jnp.asarray(x) for c, x in cols.items()}},
        jnp.asarray(valid), "k", aggs, span)
    k, v, c = _torch(keys, valid, cols)
    got = kernels.dense_group_aggregate({"k": k, **c}, v, "k", aggs, span)
    _assert_same(got[0], ref[0], ["k", "a", "cat", "dup"])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int(got[0]["dup"].max()) == 1


@pytest.mark.parametrize("n_aggs", [9, 17])
def test_more_aggregates_than_one_launch_holds(n_aggs, monkeypatch):
    """More kernel aggregates than one K2 launch holds (8) split over
    launches on the same keys: every output equals pallas_factored_agg's
    in interpret mode, count and out_valid from the first launch, and the
    plain version runs once per launch (ceil(n / 8)), the split the card
    takes."""
    span = 4096
    keys, valid, cols = _inputs(8 + n_aggs, span=span)
    fns = ("count_sum", "sum", "min", "max")
    aggs = [(None, "count", "c")] + [
        ("vw"[i % 2], fns[i % 4], f"a{i}") for i in range(n_aggs)]
    ref_out, ref_valid, esc = factored.pallas_factored_agg(
        jnp.asarray(keys), jnp.asarray(valid),
        {c: jnp.asarray(a) for c, a in cols.items()}, aggs, span,
        s_loc=1024, interpret=True)
    assert not bool(esc)
    launches = []
    plain = dense_agg_module.dense_agg_plain
    monkeypatch.setattr(dense_agg_module, "dense_agg_plain",
                        lambda *a: launches.append(a[3]) or plain(*a))
    got, gvalid, ovf = dense_agg(*_torch(keys, valid, cols), aggs, span)
    assert [sum(f != "count" for _, f, _ in a) for a in launches] \
        == [8] * (n_aggs // 8) + [n_aggs % 8]
    _assert_same(got, ref_out, ["__key", "c"] + [n for *_, n in aggs[1:]])
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(ref_valid))
    assert not bool(ovf)


# q4's build slotting: max of three taken columns and the duplicate count
# over 240,000 auctions + the join's 8,192-slot margin
SLOTTING_AGGS = [("a", "max", "a"), ("e", "max", "e"), ("cat", "max", "cat"),
                 (None, "count", "__dupcnt")]
COUNT_ONLY = [(None, "count", "count")]
PER_CATEGORY = [("final", "sum", "sum_final"), (None, "count", "cnt")]
# the largest count-only capacity whose 32 copies of a 4-byte slot fit
LANES_COUNT_CAP = dense_agg_module.LANES_BYTES // (32 * 4)


@pytest.mark.parametrize("cap,aggs,want", [
    (128, COUNT_ONLY, "lanes"),                      # YSB's count
    (128, COUNT_ONLY + [(None, "dups", "d")], "lanes"),
    (128, PER_CATEGORY, "shared"),                   # q4's per-category pass
    (8, [("price", "max", "maxprice")], "lanes"),    # q7's max on one key
    (LANES_COUNT_CAP, COUNT_ONLY, "lanes"),
    (LANES_COUNT_CAP + 1, COUNT_ONLY, "shared"),
    (K2_LANES_CAP, K2_AGGS, "lanes"),                # every aggregate kind
    (K2_LANES_CAP + 1, K2_AGGS, "shared"),
    (K2_SHARED_CAP, K2_AGGS, "shared"),
    (K2_SHARED_CAP + 1, K2_AGGS, "global"),
    (248_192, SLOTTING_AGGS, "global"),              # build slotting
    (36_808_192, [(None, "count", "num")], "global"),  # q5's count
])
def test_accumulator_variant(cap, aggs, want):
    """The variant K2 accumulates in is a function of the capacity and the
    aggregates' widths alone: lane-private copies where 32 of every slot
    fit the budget, one block-shared copy within 48 KB, else global
    atomics; ``count`` and ``dups`` take no accumulator of their own."""
    assert dense_agg_module.accumulator_variant(cap, aggs) == want


def test_cpu_path_counts_no_variant_launch():
    """The CPU path takes the plain version and counts no launch of any
    variant; the counter holds one entry per variant."""
    before = dict(dense_agg.variant_launches)
    keys, valid, cols = _inputs(11, span=256)
    dense_agg(*_torch(keys, valid, cols), COUNT_ONLY, 4096)
    assert dense_agg.variant_launches == before
    assert set(before) == set(dense_agg_module.VARIANTS) \
        == {"lanes", "shared", "global"}

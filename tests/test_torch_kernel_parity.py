"""The TPU kernels that no path of the port dispatches to a kernel of their
own, held against the port kernel that computes the same function: K1's
plain version (``join_aggregate`` on the CPU) against
``factored_join_agg_rebased`` (B2) and ``pallas_bcast_join_agg`` (B3), and
K2's (``dense_agg`` on the CPU) against ``pallas_local_agg`` (B5) and
``pallas_count_max_agg`` (B6).  The Pallas functions run in interpret mode
on tests/test_pallas.py's own inputs; every comparison is exact (PyTorch
port, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flock_tpu.pallas import agg as pallas_agg
from flock_tpu.pallas import factored
from flock_tpu_torch.ops.dense_agg import dense_agg
from flock_tpu_torch.ops.join_agg import join_aggregate
from flock_tpu_torch.plan import Conj

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_valid_rows(got, gvalid, ref, rvalid, names):
    rvalid = np.asarray(rvalid)
    np.testing.assert_array_equal(gvalid.numpy(), rvalid)
    assert rvalid.any()
    for c in names:
        g, r = got[c].numpy(), np.asarray(ref[c])
        assert g.dtype == r.dtype, (c, g.dtype, r.dtype)
        np.testing.assert_array_equal(g[rvalid], r[rvalid], err_msg=c)


def _b2_inputs():
    """test_pallas.py::test_factored_join_agg_matches_blocked_rebased: the
    q4 shape with absolute int64 ms timestamps."""
    rng = np.random.default_rng(23)
    span, n = 4096, 16384
    base_ms = 1_436_918_400_000
    present = rng.random(span) < 0.8
    ats = (base_ms + rng.integers(0, 500, span)).astype(np.int64)
    exp = ats + rng.integers(10, 400, span).astype(np.int64)
    m = np.int32(10_000)
    key = (m + np.clip(np.arange(n) // 8 + rng.integers(-64, 64, n),
                       0, span - 1)).astype(np.int32)
    price = rng.integers(1, 10**6, n).astype(np.int32)
    bts = (base_ms + rng.integers(0, 900, n)).astype(np.int64)
    pv = rng.random(n) < 0.9
    return ({"ats": ats, "exp": exp}, present, m,
            {"k": key, "price": price, "b_ts": bts}, pv, ("b_ts", "ats", "exp"))


def _b3_inputs():
    """test_pallas.py::test_bcast_join_agg_matches_blocked."""
    rng = np.random.default_rng(5)
    span, n = 8192, 16384
    pres = rng.random(span) < 0.85
    blo = rng.integers(0, 500, span).astype(np.int32)
    bhi = (blo + rng.integers(10, 1000, span)).astype(np.int32)
    fr = (np.arange(n, dtype=np.int64) * (span - 6144) // n).astype(np.int32)
    key = (fr + rng.integers(-120, 10, n)).clip(0).astype(np.int32)
    price = rng.integers(1, 10**6, n).astype(np.int32)
    pt = rng.integers(0, 1500, n).astype(np.int32)
    pv = rng.random(n) < 0.9
    return ({"blo": blo, "bhi": bhi}, pres, np.int32(0),
            {"k": key, "price": price, "pt": pt}, pv, ("pt", "blo", "bhi"))


JOIN_AGGS = [("price", "max", "final"), (None, "count", "cnt"),
             ("price", "sum", "total")]


@pytest.mark.parametrize("kernel", ["B2", "B3"])
def test_k1_equals_factored_join_kernels(kernel):
    slots, present, m, probe, pv, (t, lo, hi) = (
        _b2_inputs() if kernel == "B2" else _b3_inputs())

    def replay(bc, pair):
        return bc, pair & (bc[t] >= bc[lo]) & (bc[t] <= bc[hi])

    args = ({k: jnp.asarray(v) for k, v in slots.items()}, jnp.asarray(present),
            jnp.asarray(m), {k: jnp.asarray(v) for k, v in probe.items()},
            jnp.asarray(pv), "k", replay, JOIN_AGGS)
    if kernel == "B2":
        ref, rvalid, esc = factored.factored_join_agg_rebased(
            *args, s_loc=1024, interpret=True, limbs={"ats": 3, "exp": 3})
    else:
        ref, rvalid, esc = factored.pallas_bcast_join_agg(
            *args, s_loc=512, interpret=True)
    assert not bool(esc)
    got, gvalid, gesc = join_aggregate(
        {k: _t(v) for k, v in slots.items()}, _t(present),
        torch.tensor(int(m), dtype=torch.int32),
        {k: _t(v) for k, v in probe.items()}, _t(pv), "k",
        Conj(((t, ">=", lo), (t, "<=", hi))), JOIN_AGGS)
    assert not bool(gesc)
    _same_valid_rows(got, gvalid, ref, rvalid,
                     ["final", "cnt", "total", "__key"])


def _b5_inputs(case):
    """test_pallas.py's two pallas_local_agg tests."""
    if case == "all_fns":
        rng = np.random.default_rng(11)
        span, n = 6000, 8192
        keys = np.clip(np.arange(n) // 2 + rng.integers(-100, 100, n),
                       0, span - 1).astype(np.int32) + 500
        valid = rng.random(n) < 0.9
        vals = rng.integers(0, 2**31 - 1, n).astype(np.int32)
        aggs = [(None, "count", "c"), ("v", "sum", "s"), ("v", "min", "lo"),
                ("v", "max", "hi"), ("v", "count_sum", "cs")]
        return keys, valid, vals, aggs, span, 1024
    rng = np.random.default_rng(12)
    span, n = 9000, 4096
    keys = np.clip(np.arange(n) + rng.integers(-2000, 2000, n),
                   0, span - 1).astype(np.int32)
    valid = np.ones(n, bool)
    vals = rng.integers(0, 10**6, n).astype(np.int32)
    return keys, valid, vals, [("v", "sum", "s"), (None, "count", "c")], \
        span, 4608


@pytest.mark.parametrize("case", ["all_fns", "unaligned_s_loc"])
def test_k2_equals_pallas_local_agg(case):
    """B5; ``count_sum`` wraps in int32 in both (the column's sums exceed
    2³¹ here)."""
    keys, valid, vals, aggs, span, s_loc = _b5_inputs(case)
    ref, rvalid, esc = pallas_agg.pallas_local_agg(
        jnp.asarray(keys), jnp.asarray(valid), {"v": jnp.asarray(vals)},
        aggs, span, block=1024, s_loc=s_loc, interpret=True)
    assert not bool(esc)
    got, gvalid, ovf = dense_agg(_t(keys), _t(valid), {"v": _t(vals)}, aggs,
                                 span)
    assert not bool(ovf)
    _same_valid_rows(got, gvalid, ref, rvalid,
                     ["__key"] + [o for _, _, o in aggs])


def test_k2_count_max_equals_pallas_count_max_agg():
    """B6, every slot: K2 with ``[count, max]`` gives the count and the max
    per key over the same span, empty slots at 0 and INT32_MIN."""
    rng = np.random.default_rng(1)
    n, span = 8192, 4096
    keys = ((np.arange(n) // 3) + rng.integers(-50, 20, n)).clip(0).astype(np.int32)
    vals = rng.integers(1, 10**8, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    m = int(keys[valid].min())
    cnt, mx, esc = pallas_agg.pallas_count_max_agg(
        jnp.asarray(keys), jnp.asarray(valid), jnp.asarray(vals),
        jnp.int32(m), span, interpret=True)
    assert not int(np.asarray(esc)[0])
    got, gvalid, ovf = dense_agg(_t(keys), _t(valid), {"v": _t(vals)},
                                 [(None, "count", "cnt"), ("v", "max", "mx")],
                                 span)
    assert not bool(ovf) and int(got["__key"][0]) == m
    np.testing.assert_array_equal(got["cnt"].numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(got["mx"].numpy(), np.asarray(mx))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(cnt) > 0)

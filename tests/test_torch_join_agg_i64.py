"""Kernel K1's int64 max (q6's ``__order``) on the CPU path: the port's
plain version (``join_aggregate`` on CPU tensors) against the reference's
``blocked_join_aggregate``, whose replay computes ``__order`` and takes its
int64 accumulator from it (``fused_acc_dtypes``), and against numpy on the
adversarial int64 cases of ``torch_kernel_cases`` (extremes, negative
values, values that differ only in their low or only in their high 32 bits,
one slot, keys outside the kernel's window, no valid row).  The wrapper's
rule: an int64 probe column under max that nothing compares passes through
unrebased; every other int64 aggregate raises.  Every comparison is exact
(PyTorch port, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flock_tpu.ops import blocked
from flock_tpu_torch.ops.join_agg import join_aggregate, unsupported_aggs
from flock_tpu_torch.plan import Conj
from torch_kernel_cases import (I64_MIN, K1_I64_AGGS, K1_I64_CASES, K1_TERMS,
                                k1_i64_case, k1_i64_numpy)

torch.set_num_threads(1)

PRED = Conj(K1_TERMS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(slots, present, m, probe, pv, pred=PRED, aggs=K1_I64_AGGS):
    return join_aggregate({k: _t(v) for k, v in slots.items()}, _t(present),
                          torch.tensor(int(m), dtype=torch.int32),
                          {k: _t(v) for k, v in probe.items()}, _t(pv), "k",
                          pred, aggs)


def _blocked(slots, present, m, probe, pv, replay, aggs, s_loc, margin=0):
    span = len(present)
    n = len(pv)
    pad = (-n) % 1024
    pc = {k: jnp.pad(jnp.asarray(v), (0, pad)) for k, v in probe.items()}
    return blocked.blocked_join_aggregate(
        {k: jnp.asarray(v) for k, v in slots.items()}, jnp.asarray(present),
        jnp.asarray(m), pc, jnp.pad(jnp.asarray(pv), (0, pad)), "k", replay,
        aggs, span, block=1024, s_loc=s_loc, margin=margin)


def _interval(bc, pair):
    return bc, pair & (bc["b_ts"] >= bc["ats"]) & (bc["b_ts"] <= bc["exp"])


def _q6_inputs(seed, span=5000, n=8192):
    """q6's fused pass: auctions slotted by id (with the seller), bids near
    the advancing frontier, int32 window-relative times."""
    rng = np.random.default_rng(seed)
    present = rng.random(span) < 0.8
    ats = rng.integers(0, 500, span).astype(np.int32)
    slots = {"ats": ats,
             "exp": (ats + rng.integers(10, 400, span)).astype(np.int32),
             "seller": rng.integers(1000, 3000, span).astype(np.int32)}
    rel = np.clip(np.arange(n) // 2 + rng.integers(-64, 64, n), 0, span - 1)
    # few distinct prices: the time half of __order breaks the ties
    probe = {"k": (10_000 + rel).astype(np.int32),
             "price": rng.integers(1, 40, n).astype(np.int32) * 1000,
             "b_ts": rng.integers(0, 900, n).astype(np.int32)}
    return slots, present, np.int32(10_000), probe, rng.random(n) < 0.9


def _order(c):
    """price << 32 | (2^32 - 1 - b_ts), in the reference's replay."""
    return (c["price"].astype(jnp.int64) << 32) \
        | (jnp.int64(0xFFFFFFFF) - c["b_ts"].astype(jnp.int64))


@pytest.mark.parametrize("seed", [21, 22])
def test_q6_pass_equals_blocked_join_aggregate(seed):
    """The reference computes ``__order`` inside its replay; the port
    computes it on the probe side and hands K1 an int64 column."""
    slots, present, m, probe, pv = _q6_inputs(seed)
    aggs = [("__order", "max", "__order"), ("seller", "max", "seller"),
            (None, "count", "cnt")]

    def replay(bc, pair):
        bc, pair = _interval(bc, pair)
        return {"auction": bc["k"], "seller": bc["seller"],
                "__order": _order(bc)}, pair

    ref, rvalid, esc = _blocked(slots, present, m, probe, pv, replay, aggs,
                                s_loc=1024, margin=128)
    assert not bool(esc)
    order = (probe["price"].astype(np.int64) << 32) \
        | (0xFFFFFFFF - probe["b_ts"].astype(np.int64))
    got, gvalid, gesc = _port(slots, present, m, dict(probe, __order=order),
                              pv, aggs=aggs)
    assert not bool(gesc)
    rvalid = np.asarray(rvalid)
    np.testing.assert_array_equal(gvalid.numpy(), rvalid)
    assert rvalid.sum() > 1000
    for name in ["__order", "seller", "cnt", "__key"]:
        g, r = got[name].numpy(), np.asarray(ref[name])
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("case", K1_I64_CASES)
def test_adversarial_int64_max_equals_numpy_and_reference(case):
    slots, present, m, probe, pv = k1_i64_case(case)
    got, gvalid, esc = _port(slots, present, m, probe, pv)
    assert not bool(esc)
    omax, cnt = k1_i64_numpy(slots, present, m, probe, pv)
    assert got["omax"].dtype == torch.int64
    np.testing.assert_array_equal(got["omax"].numpy(), omax)
    np.testing.assert_array_equal(got["c"].numpy(), cnt)
    np.testing.assert_array_equal(gvalid.numpy(), cnt > 0)
    assert (cnt > 0).any() == (case != "all_invalid")
    if case != "all_invalid":
        assert (omax[cnt == 0] == I64_MIN).all() and (cnt == 0).any()
    # the reference, its window the whole span (no escape)
    ref, rvalid, resc = _blocked(slots, present, m, probe, pv, _interval,
                                 K1_I64_AGGS, s_loc=len(present))
    assert not bool(resc)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(rvalid))
    for _, _, name in K1_I64_AGGS:
        g, r = got[name].numpy(), np.asarray(ref[name])
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_int64_max_beside_rebased_timestamps():
    """Compared int64 timestamps rebase to int32 from one shared base; the
    aggregated int64 column passes through unrebased, its values exact."""
    slots, present, m, probe, pv = k1_i64_case("extremes")
    base = 1_436_918_400_000
    wide_slots = dict(slots, ats=slots["ats"] + np.int64(base),
                      exp=slots["exp"] + np.int64(base))
    wide_probe = dict(probe, b_ts=probe["b_ts"] + np.int64(base))
    got, gvalid, esc = _port(wide_slots, present, m, wide_probe, pv)
    assert not bool(esc)
    want, wvalid, _ = _port(slots, present, m, probe, pv)
    np.testing.assert_array_equal(gvalid.numpy(), wvalid.numpy())
    for _, _, name in K1_I64_AGGS:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())


@pytest.mark.parametrize("bad", ["sum", "min", "compared", "slot", "opaque"])
def test_other_int64_aggregates_raise(bad):
    """Only max over an int64 probe column that nothing compares is taken:
    int64 sum or min, an int64 column the predicate compares, an int64 slot
    column, and an int64 max under an opaque predicate all raise."""
    slots, present, m, probe, pv = k1_i64_case("negative", span=256, n=512)
    pred, aggs = PRED, [("o", "max", "x")]
    if bad in ("sum", "min"):
        aggs = [("o", bad, "x")]
    elif bad == "compared":
        pred = Conj(K1_TERMS + (("o", ">", "price"),))
    elif bad == "slot":
        slots = dict(slots, wide=np.arange(256, dtype=np.int64))
        aggs = [("wide", "max", "x")]
    else:
        pred = lambda c: c["b_ts"] >= 0
    assert unsupported_aggs({k: _t(v) for k, v in slots.items()},
                            {k: _t(v) for k, v in probe.items()}, pred,
                            aggs) != []
    with pytest.raises(NotImplementedError, match="int64"):
        _port(slots, present, m, probe, pv, pred=pred, aggs=aggs)

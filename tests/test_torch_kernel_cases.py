"""The plain versions of kernels K1 and K2 on adversarial inputs
(``torch_kernel_cases``) against flock_tpu: K1's against
``fused_join_aggregate`` in interpret mode with a window as wide as the
span, K2's against ``dense_group_aggregate``; K2's duplicate flag against the
reference's ``count > 1``; and the fused pass's output validity against the
reference's ``ovalid & present`` on a window with absent slots.  Every
comparison is exact (PyTorch port, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flock_tpu import plan as ref_plan
from flock_tpu.ops import kernels as ref_kernels
from flock_tpu.pallas import join_agg as ref_join_agg
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu_torch import plan
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.ops.dense_agg import dense_agg
from flock_tpu_torch.ops.join_agg import join_aggregate
from flock_tpu_torch.queries.nexmark import get_query
from torch_kernel_cases import (K1_AGGS, K1_CASES, K1_TERMS, K2_CASES,
                                k1_case, k2_aggs, k2_case)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _replay(bc, pair):
    for lhs, op, rhs in K1_TERMS:
        pair = pair & {">=": jnp.greater_equal, "<=": jnp.less_equal}[op](
            bc[lhs], bc[rhs])
    return bc, pair


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_plain_matches_pallas_on_adversarial_inputs(case):
    slots, present, m, probe, pv = k1_case(case)
    s_loc = max(1024, -(-present.shape[0] // 1024) * 1024)
    ref, rvalid, esc = ref_join_agg.fused_join_aggregate(
        {k: jnp.asarray(v) for k, v in slots.items()}, jnp.asarray(present),
        jnp.asarray(m), {k: jnp.asarray(v) for k, v in probe.items()},
        jnp.asarray(pv), "k", _replay, K1_AGGS, block=1024, s_loc=s_loc,
        interpret=True)
    assert not bool(esc)
    got, gvalid, gesc = join_aggregate(
        {k: _t(v) for k, v in slots.items()}, _t(present),
        torch.tensor(int(m), dtype=torch.int32),
        {k: _t(v) for k, v in probe.items()}, _t(pv), "k",
        plan.Conj(K1_TERMS), K1_AGGS)
    assert not bool(gesc)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(rvalid))
    assert gvalid.any() == (case != "all_invalid")
    for name in ["__key"] + [o for _, _, o in K1_AGGS]:
        g, r = got[name].numpy(), np.asarray(ref[name])
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("case", K2_CASES)
def test_k2_plain_matches_reference_on_adversarial_inputs(case):
    """Every slot, and the duplicate flag against the reference's count."""
    keys, valid, cols, cap = k2_case(case)
    aggs = [a for a in k2_aggs(case) if a[1] != "dups"]
    ref = ref_kernels.dense_group_aggregate(
        {"k": jnp.asarray(keys), **{c: jnp.asarray(a) for c, a in cols.items()}},
        jnp.asarray(valid), "k", aggs, cap)
    got, gvalid, ovf = dense_agg(_t(keys), _t(valid),
                                 {c: _t(a) for c, a in cols.items()},
                                 k2_aggs(case), cap)
    assert not bool(ovf) and not bool(ref[2])
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(ref[1]))
    for name in [o for _, _, o in aggs]:
        g, r = got[name].numpy(), np.asarray(ref[0][name])
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    np.testing.assert_array_equal(got["__key"].numpy(), np.asarray(ref[0]["k"]))
    dups = bool((np.asarray(ref[0]["c"]) > 1).any())
    assert got["d"].shape == () and bool(got["d"]) == dups
    assert dups == (case not in ("n_1", "all_invalid", "unique"))


@pytest.mark.parametrize("rebase", [True, False])
def test_dups_flag_through_dense_group_aggregate(rebase):
    """The flag rides along the int64 rebase branch and the scatter path."""
    keys = np.array([5, 9, 7, 9, 6], np.int32)
    cols = {"k": _t(keys), "t": _t(np.arange(5, dtype=np.int64) * 10**12)}
    valid = _t(np.array([True, True, True, False, True]))
    aggs = [("t", "max", "t"), (None, "dups", "d")]
    out, _, _, esc = kernels.dense_group_aggregate(cols, valid, "k", aggs, 8,
                                                   rebase=rebase)
    assert not bool(out["d"]) and bool(esc) == rebase
    valid[3] = True
    out, _, _, _ = kernels.dense_group_aggregate(cols, valid, "k", aggs, 8,
                                                 rebase=rebase)
    assert bool(out["d"])


def _fused_node(module, spec):
    """q4's FusedJoinAggregate node in ``module``'s plan."""
    root = module.fuse_join_aggregates(spec.plan)
    return next(n for n in module.walk(root)
                if isinstance(n, module.FusedJoinAggregate))


def _absent_slot_window(seed=3):
    """q4's fused pass inputs: auction ids 1000.. with a fifth of the rows
    invalid (absent slots) and bids near the frontier, many on absent slots
    — local enough for the reference's 512-slot probe window per block."""
    rng = np.random.default_rng(seed)
    na, n = 600, 8192
    a_ts = rng.integers(0, 500, na).astype(np.int32)
    b = {"a_id": (1000 + np.arange(na)).astype(np.int32), "a_date_time": a_ts,
         "expires": (a_ts + rng.integers(10, 900, na)).astype(np.int32),
         "category": rng.integers(10, 15, na).astype(np.int32)}
    bvalid = rng.random(na) < 0.8
    f = np.arange(n) * na // n
    p = {"auction": (1000 + np.clip(f - rng.integers(0, 30, n), 0, na - 1)
                     ).astype(np.int32),
         "price": rng.integers(1, 10**6, n).astype(np.int32),
         "b_date_time": rng.integers(0, 900, n).astype(np.int32)}
    return b, bvalid, p, rng.random(n) < 0.95


def test_fused_pass_valid_lies_within_present():
    """K1 counts only pairs on present slots: the fused pass's validity,
    with no ``& present``, equals the reference's ``ovalid & present`` on a
    window where many bids hit absent slots."""
    b, bvalid, p, pvalid = _absent_slot_window()
    node = _fused_node(plan, get_query(4))
    b_cols, p_cols = ({k: _t(v) for k, v in b.items()},
                      {k: _t(v) for k, v in p.items()})
    out, valid, ovf, esc = plan.fused_local_pass(
        node, b_cols, _t(bvalid), p_cols, _t(pvalid),
        plan.fused_replay(node, b_cols, p_cols))
    r_out, r_valid, _, r_esc, _ = ref_plan.fused_local_pass(
        _fused_node(ref_plan, ref_get_query(4)),
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.asarray(bvalid),
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(pvalid))
    assert not bool(esc) and not bool(r_esc) and not bool(ovf)
    r_valid = np.asarray(r_valid)
    np.testing.assert_array_equal(valid.numpy(), r_valid)
    assert r_valid.any()
    for name in ("auction", "final", "category"):
        np.testing.assert_array_equal(out[name].numpy()[r_valid],
                                      np.asarray(r_out[name])[r_valid])
    # bids on absent slots exist, and no valid slot holds an absent id
    absent_ids = b["a_id"][~bvalid]
    assert np.isin(p["auction"][pvalid], absent_ids).any()
    assert not np.isin(out["auction"].numpy()[r_valid], absent_ids).any()

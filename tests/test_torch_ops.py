"""The port's plain operators against ``flock_tpu.ops.kernels``:
``lookup_join`` in its three modes (duplicate-faithful, with the escape and
the fan-out of the rerun; slotted build; unique build), the multi-key
sort-based ``group_aggregate``, ``sort_rows`` and the scatter and
int64-rebase branches of ``dense_group_aggregate``.  Exact comparisons
(PyTorch port, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flock_tpu.ops import kernels as ref
from flock_tpu.plan import dup_expand_capacity as ref_dup_expand_capacity
from flock_tpu_torch.batch import Batch, Schema
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.plan import Aggregate, Scan, dup_expand_capacity
from flock_tpu_torch.queries.nexmark import QuerySpec
from flock_tpu_torch.runtime.executor import LocalExecutor

torch.set_num_threads(1)


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _assert_rows(got, want, names):
    """Same shape, same validity and the same values in every valid row;
    the port's escape flag stays clear."""
    gc, gv, go, ge = got
    assert not bool(ge)
    assert gv.shape == np.asarray(want[1]).shape
    wc, wv, wo = want
    gv, wv = gv.numpy(), np.asarray(wv)
    np.testing.assert_array_equal(gv, wv)
    assert bool(go) == bool(wo)
    for k in names:
        g, w = gc[k].numpy(), np.asarray(wc[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g[gv], w[wv], err_msg=k)


def _join_inputs(seed, dups: bool, nb=600, n=2000):
    rng = np.random.default_rng(seed)
    a_id = (5000 + np.arange(nb)).astype(np.int32)
    if dups:
        # id wraparound: some ids repeat up to 3 times
        a_id[nb // 2:] = a_id[: nb - nb // 2] + rng.integers(0, 2, nb - nb // 2)
    build = {"a_id": a_id,
             "a_ts": rng.integers(0, 1000, nb).astype(np.int32),
             "cat": rng.integers(10, 15, nb).astype(np.int32)}
    bvalid = rng.random(nb) < 0.95
    probe = {"auction": (5000 + rng.integers(-50, nb + 50, n)).astype(np.int32),
             "price": rng.integers(1, 10**6, n).astype(np.int32)}
    pvalid = rng.random(n) < 0.9
    return build, bvalid, probe, pvalid


def _lookup_join(build, bvalid, probe, pvalid, take, **kw):
    return kernels.lookup_join(_t(build), torch.from_numpy(bvalid), "a_id",
                               _t(probe), torch.from_numpy(pvalid), "auction",
                               take, **kw)


@pytest.mark.parametrize("seed,dups", [(0, True), (1, True), (2, False)])
def test_lookup_join_matches_reference(seed, dups):
    """Duplicate keys fan out in the rerun's mode (``fallback=True``), as
    the reference's duplicate branch; unique keys take the gather."""
    build, bvalid, probe, pvalid = _join_inputs(seed, dups)
    take = {"a_ts": "a_ts", "cat": "category"}
    cap = dup_expand_capacity(len(pvalid))
    assert cap == ref_dup_expand_capacity(len(pvalid))
    want = ref.lookup_join(_j(build), jnp.asarray(bvalid), "a_id", _j(probe),
                           jnp.asarray(pvalid), "auction", take,
                           out_capacity=cap)
    got = _lookup_join(build, bvalid, probe, pvalid, take, out_capacity=cap,
                       fallback=dups)
    assert got[1].shape[0] == cap
    _assert_rows(got, want, ["auction", "price", "a_ts", "category"])
    if dups:
        assert int(got[1].sum()) > int(torch.from_numpy(pvalid).sum()) // 2


@pytest.mark.parametrize("seed,dups", [(0, True), (2, False)])
def test_lookup_join_escapes_on_duplicates(seed, dups):
    """Outside the rerun, duplicate build keys set the escape flag and
    nothing is sorted; unique keys leave it clear, and the rerun's fan-out
    of a unique build equals the gather."""
    build, bvalid, probe, pvalid = _join_inputs(seed, dups)
    take = {"a_ts": "a_ts", "cat": "category"}
    cap = dup_expand_capacity(len(pvalid))
    got = _lookup_join(build, bvalid, probe, pvalid, take, out_capacity=cap)
    assert bool(got[3]) == dups and not bool(got[2])
    assert got[1].shape[0] == cap
    if not dups:
        fan = _lookup_join(build, bvalid, probe, pvalid, take,
                           out_capacity=cap, fallback=True)
        assert torch.equal(fan[1], got[1])
        for k in ("auction", "price", "a_ts", "category"):
            assert torch.equal(fan[0][k][fan[1]], got[0][k][got[1]]), k


@pytest.mark.parametrize("mode", ["slotted", "unique", "unique_dups"])
def test_lookup_join_slotted_and_unique_builds(mode):
    """A slotted build (a dense-slot aggregate output, slot i ↔ key
    ``bk[0] + i``) is gathered as it stands; a unique build keeps ``n`` rows
    and turns duplicate keys into overflow, never an escape."""
    build, bvalid, probe, pvalid = _join_inputs(3, mode == "unique_dups")
    take = {"a_ts": "a_ts", "cat": "category"}
    if mode == "slotted":
        # the aggregate output the reference's build_slotted reuses
        slot_cols, bvalid, _ = ref.dense_group_aggregate(
            _j(build), jnp.asarray(bvalid), "a_id",
            [("a_ts", "max", "a_ts"), ("cat", "max", "cat")], 1024)
        build = {k: np.array(v) for k, v in slot_cols.items()}
        bvalid = np.array(bvalid)
    kw = {"build_slotted": True} if mode == "slotted" else {"dup_expand": False}
    want = ref.lookup_join(_j(build), jnp.asarray(bvalid), "a_id", _j(probe),
                           jnp.asarray(pvalid), "auction", take, **kw)
    got = _lookup_join(build, bvalid, probe, pvalid, take, **kw)
    assert got[1].shape[0] == len(pvalid)
    if mode == "unique_dups":
        assert bool(got[2]) and bool(want[2]) and not bool(got[3])
        return
    _assert_rows(got, want, ["auction", "price", "a_ts", "category"])
    assert got[1].any()


def test_lookup_join_fan_out_overflows():
    """More duplicate extras than free output slots raise overflow."""
    nb, n = 64, 128
    build = {"k": np.zeros(nb, np.int32), "v": np.arange(nb, dtype=np.int32)}
    probe = {"k": np.zeros(n, np.int32)}
    want = ref.lookup_join(_j(build), jnp.ones(nb, bool), "k", _j(probe),
                           jnp.ones(n, bool), "k", {"v": "v"}, out_capacity=256)
    got = kernels.lookup_join(_t(build), torch.ones(nb, dtype=torch.bool), "k",
                              _t(probe), torch.ones(n, dtype=torch.bool), "k",
                              {"v": "v"}, out_capacity=256, fallback=True)
    assert bool(got[2]) and bool(want[2])


@pytest.mark.parametrize("seed", [3, 4])
def test_multi_key_group_aggregate_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    cols = {"a": rng.integers(0, 300, n).astype(np.int32),
            "c": rng.integers(10, 13, n).astype(np.int32),
            "p": rng.integers(-(10**6), 10**6, n).astype(np.int32),
            "q": rng.integers(0, 10**6, n).astype(np.int32)}
    valid = rng.random(n) < 0.8
    aggs = [("p", "max", "mx"), ("p", "min", "mn"), ("q", "sum", "s"),
            (None, "count", "cnt"), ("q", "count_sum", "cs"),
            ("p", "wmin:q", "w")]
    cap = 1024
    want = ref.group_aggregate(_j(cols), jnp.asarray(valid), ["a", "c"], aggs, cap)
    got = kernels.group_aggregate(_t(cols), torch.from_numpy(valid), ["a", "c"],
                                  aggs, cap)
    _assert_rows(got, want, ["a", "c", "mx", "mn", "s", "cnt", "cs", "w"])
    # overflow: fewer output rows than distinct (a, c) pairs
    want = ref.group_aggregate(_j(cols), jnp.asarray(valid), ["a", "c"], aggs, 128)
    got = kernels.group_aggregate(_t(cols), torch.from_numpy(valid), ["a", "c"],
                                  aggs, 128)
    _assert_rows(got, want, ["a", "c", "mx", "s", "cnt"])
    assert bool(got[2])


def test_sort_rows_matches_reference():
    rng = np.random.default_rng(5)
    n = 1000
    cols = {"x": rng.integers(0, 20, n).astype(np.int32),
            "y": rng.integers(-50, 50, n).astype(np.int32),
            "z": np.arange(n, dtype=np.int32)}
    valid = rng.random(n) < 0.7
    want = ref.sort_rows(_j(cols), jnp.asarray(valid), ["x", "y"], (False, True))
    got = kernels.sort_rows(_t(cols), torch.from_numpy(valid), ["x", "y"],
                            (False, True))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for k in cols:
        np.testing.assert_array_equal(got[0][k].numpy(), np.asarray(want[0][k]))


@pytest.mark.parametrize("kind", ["rebase", "rebase_too_wide", "wmin"])
def test_dense_group_aggregate_other_branches(kind):
    """int64 min/max/sum columns rebase to int32; past the int32 range the
    escape flag is set, and ``rebase=False`` (the escape rerun) gives the
    scatter answer; wmin takes the scatter path."""
    cols, valid, aggs, cap = _i64_inputs(kind)
    want = ref.dense_group_aggregate(_j(cols), jnp.asarray(valid), "k", aggs, cap)
    got = kernels.dense_group_aggregate(_t(cols), torch.from_numpy(valid), "k",
                                        aggs, cap)
    if kind == "rebase_too_wide":
        assert bool(got[3])
        got = kernels.dense_group_aggregate(_t(cols), torch.from_numpy(valid),
                                            "k", aggs, cap, rebase=False)
    _assert_rows(got, want, ["k"] + [o for _, _, o in aggs])


@pytest.mark.parametrize("kind", ["rebase", "rebase_too_wide"])
def test_rebase_escape_reruns_plan(kind):
    """Through the executor: an int64 range too wide for the rebase escapes
    once and the rerun gives the reference's rows; a narrow one never
    escapes."""
    cols, valid, aggs, cap = _i64_inputs(kind)
    spec = QuerySpec(4, Aggregate(Scan("r"), ("k",), tuple(aggs), cap),
                     ("elementwise",), ("r",),
                     Schema(["k"] + [o for _, _, o in aggs]))
    ex = LocalExecutor(spec, device="cpu")
    out = ex.execute_batches({"r": Batch(_t(cols), torch.from_numpy(valid))})
    assert ex.fallback_runs == (kind == "rebase_too_wide")
    want = ref.dense_group_aggregate(_j(cols), jnp.asarray(valid), "k", aggs, cap)
    wv = np.asarray(want[1])
    np.testing.assert_array_equal(out.valid.numpy(), wv)
    for _, _, o in aggs:
        np.testing.assert_array_equal(out.columns[o].numpy()[wv],
                                      np.asarray(want[0][o])[wv], err_msg=o)


def _i64_inputs(kind):
    rng = np.random.default_rng(6)
    n, cap = 2000, 1024
    keys = (100 + rng.integers(0, 900, n)).astype(np.int32)
    ts = 1_436_918_400_000 + rng.integers(0, 10**6, n)
    if kind == "rebase_too_wide":
        ts[::7] += 2**33
    cols = {"k": keys, "ts": ts.astype(np.int64),
            "v": rng.integers(0, 1000, n).astype(np.int32)}
    valid = rng.random(n) < 0.9
    if kind == "wmin":
        aggs = [("v", "wmin:ts", "w"), (None, "count", "c")]
    else:
        aggs = [("ts", "min", "first"), ("ts", "max", "last"),
                ("ts", "sum", "s"), ("v", "max", "mx")]
    return cols, valid, aggs, cap

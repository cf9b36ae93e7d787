"""The port's CUDA kernels against their plain versions on the card, and the
ported queries and windows on the card against the CPU path.  Skipped
without a CUDA card.

This file imports only ``flock_tpu_torch`` (no JAX), so it runs on a machine
without JAX; there, skip this directory's conftest (it configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from flock_tpu_torch import plan
from flock_tpu_torch.batch import Batch
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.ops.dense_agg import (accumulator_variant, dense_agg,
                                           dense_agg_plain)
from flock_tpu_torch.ops.gather import gather, gather_plain
from flock_tpu_torch.ops.join_agg import join_agg_plain, join_aggregate
from flock_tpu_torch.ops.lookup_agg import lookup_agg_plain, lookup_aggregate
from flock_tpu_torch.plan import Conj
from flock_tpu_torch.datagen.ysb import YsbConfig
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.queries.ysb import run_ysb
from flock_tpu_torch.runtime.stream import StreamDriver, generate_epochs
from torch_kernel_cases import (K1_AGGS, K1_CASES, K1_I64_AGGS, K1_I64_CASES,
                                K1_TERMS, K2_AGGS, K2_CASES, K2_LANES_CAP,
                                K3_CASES, K4_CASES, k1_case, k1_i64_case,
                                k1_i64_numpy, k2_aggs, k2_case, k3_case,
                                k4_case, k4_slots, k4_terms)

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

ALL_AGGS = [(None, "count", "c"), ("v", "count_sum", "cs"), ("v", "sum", "s"),
            ("v", "min", "mn"), ("v", "max", "mx")]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("cap", [1, 42, 43, 128, 4096, 300_000])
@pytest.mark.parametrize("valid_p", [0.0, 0.7, 1.0])
def test_dense_agg_kernel_equals_plain(dev, cap, valid_p):
    """The three kernel variants (lane-private copies in shared memory up
    to 42 slots of these 24 bytes, one block-shared copy to 48 KB, global
    atomics past it), every aggregate, negative values, overflowing keys,
    no valid row."""
    rng = np.random.default_rng(cap)
    n = 50_000
    keys = torch.from_numpy(rng.integers(3, 3 + 2 * cap, n).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < valid_p).to(dev)
    cols = {"v": torch.from_numpy(
        rng.integers(-(10**9), 10**9, n).astype(np.int32)).to(dev)}
    got = dense_agg(keys, valid, cols, ALL_AGGS, cap)
    want = dense_agg_plain(keys, valid, cols, ALL_AGGS, cap)
    _same(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert bool(got[2]) == bool(want[2]) == (valid_p > 0)


def test_dense_agg_hot_keys(dev):
    """250 k rows onto 5 keys: q4's per-category shape."""
    rng = np.random.default_rng(1)
    n = 250_000
    keys = torch.from_numpy(rng.integers(10, 15, n).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    cols = {"v": torch.from_numpy(rng.integers(0, 10**8, n).astype(np.int32)).to(dev)}
    aggs = [("v", "sum", "s"), (None, "count", "c")]
    got = dense_agg(keys, valid, cols, aggs, 128)
    want = dense_agg_plain(keys, valid, cols, aggs, 128)
    _same(got[0], want[0])
    assert not bool(got[2])


def _on(dev, x, offset=0):
    """numpy → a tensor on ``dev``; ``offset`` > 0 makes it a view that
    starts ``offset`` elements into its allocation (not 16-byte aligned)."""
    if isinstance(x, dict):
        return {k: _on(dev, v, offset) for k, v in x.items()}
    t = torch.from_numpy(np.ascontiguousarray(x))
    if offset:
        t = torch.cat([t[:1].repeat(offset), t])
    return t.to(dev)[offset:]


def _k1_same(dev, slots, present, m, probe, pvalid, offset=0):
    args = (_on(dev, slots), _on(dev, present),
            torch.tensor(int(m), dtype=torch.int32, device=dev),
            _on(dev, probe, offset), _on(dev, pvalid, offset), "k",
            Conj(K1_TERMS), K1_AGGS)
    got, gvalid, esc = join_aggregate(*args)
    want, wvalid = join_agg_plain(*args)
    _same(got, want)
    assert torch.equal(gvalid, wvalid) and not bool(esc)
    return gvalid


@pytest.mark.parametrize("case", K1_CASES)
def test_join_agg_adversarial_equals_plain(dev, case):
    """Past one 2048-row tile and one 2048-slot window: all lanes on one
    slot, keys the window misses, keys behind it and before m, a span
    below the window, ragged and tiny n, no valid row."""
    gvalid = _k1_same(dev, *k1_case(case, span=248_192, n=1_000_000,
                                    seed=len(case)))
    assert bool(gvalid.any()) == (case != "all_invalid")


@pytest.mark.parametrize("case", ["uniform", "n_odd"])
def test_join_agg_unaligned_columns_equal_plain(dev, case):
    """Probe columns that start off a 16-byte boundary take element loads."""
    _k1_same(dev, *k1_case(case, span=248_192, n=500_000), offset=1)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", K1_I64_CASES)
def test_join_agg_int64_max_equals_plain(dev, case, offset):
    """K1's int64 max (kMax64) at the card's size: extremes, negative
    values, values that differ only in their low or high 32 bits, one
    slot, keys K1's window misses (global 64-bit atomics), no valid row;
    also with the int32 probe columns off a 16-byte boundary.  Equal to the
    plain version and to numpy, INT64_MIN on every empty slot."""
    slots, present, m, probe, pvalid = k1_i64_case(
        case, span=248_192, n=1_000_000, seed=len(case))
    args = (_on(dev, slots), _on(dev, present),
            torch.tensor(int(m), dtype=torch.int32, device=dev),
            _on(dev, probe, offset), _on(dev, pvalid, offset), "k",
            Conj(K1_TERMS), K1_I64_AGGS)
    got, gvalid, esc = join_aggregate(*args)
    want, wvalid = join_agg_plain(*args)
    _same(got, want)
    assert torch.equal(gvalid, wvalid) and not bool(esc)
    omax, cnt = k1_i64_numpy(slots, present, m, probe, pvalid)
    np.testing.assert_array_equal(got["omax"].cpu().numpy(), omax)
    np.testing.assert_array_equal(got["c"].cpu().numpy(), cnt)


# the variant each boundary case of K2 takes (every other case: its
# capacity's)
K2_CASE_VARIANTS = {"cap_lanes": "lanes", "cap_lanes_plus1": "shared",
                    "cap_shared": "shared", "cap_global": "global",
                    "ysb_count": "lanes"}


@pytest.mark.parametrize("case", K2_CASES)
def test_dense_agg_adversarial_equals_plain(dev, case):
    """Every variant on both sides of its limit, every lane on one key,
    ragged and tiny n, no valid row (m the sentinel), YSB's count, and the
    duplicate flag."""
    keys, valid, cols, cap = k2_case(case, n=500_000, cap=300_000,
                                     seed=len(case))
    args = (_on(dev, keys), _on(dev, valid), _on(dev, cols), k2_aggs(case),
            cap)
    variant = accumulator_variant(cap, k2_aggs(case))
    assert variant == K2_CASE_VARIANTS.get(case, variant)
    before = dict(dense_agg.variant_launches)
    got, gvalid, ovf = dense_agg(*args)
    assert {v: n - before[v] for v, n in dense_agg.variant_launches.items()} \
        == {v: int(v == variant) for v in before}
    want, wvalid, wovf = dense_agg_plain(*args)
    _same(got, want)
    assert torch.equal(gvalid, wvalid) and bool(ovf) == bool(wovf)
    assert bool(got["d"]) == bool((want["c"] > 1).any())


@pytest.mark.parametrize("cap", [K2_LANES_CAP, 128, 300_000])
def test_dense_agg_unaligned_columns_equal_plain(dev, cap):
    keys, valid, cols, _ = k2_case("uniform", n=100_001, cap=cap)
    args = (_on(dev, keys, 1), _on(dev, valid, 1), _on(dev, cols, 1),
            K2_AGGS, cap)
    got, gvalid, _ = dense_agg(*args)
    want, wvalid, _ = dense_agg_plain(*args)
    _same(got, want)
    assert torch.equal(gvalid, wvalid)


def test_kernels_initialise_every_output(dev, monkeypatch):
    """Every output allocation of the wrappers (``torch.empty``) holds 0x7f
    bytes when the kernel starts — what a freed tensor of such bytes leaves
    for the caching allocator to hand back — and the outputs still equal the
    plain versions: the kernels write every output themselves."""
    empty = torch.empty

    def stale_empty(*shape, **kw):
        t = empty(*shape, **kw)
        t.view(torch.uint8).fill_(0x7f)
        return t

    span, n = 300_000, 1_000_000
    slots, present, m, probe, pvalid = k1_case("behind_and_before", span=span,
                                               n=n)
    keys, valid, cols, _ = k2_case("uniform", n=n, cap=span)
    k1_args = (_on(dev, slots), _on(dev, present),
               torch.tensor(int(m), dtype=torch.int32, device=dev),
               _on(dev, probe), _on(dev, pvalid), "k", Conj(K1_TERMS),
               K1_AGGS)
    # K2's lane-private, block-shared and global variants
    for cap in (K2_LANES_CAP, 128, span):
        k2_args = (_on(dev, keys % cap), _on(dev, valid), _on(dev, cols),
                   K2_AGGS, cap)
        for kernel, plain, args in ((join_aggregate, join_agg_plain, k1_args),
                                    (dense_agg, dense_agg_plain, k2_args)):
            want = plain(*args)
            with monkeypatch.context() as mp:
                mp.setattr(torch, "empty", stale_empty)
                got = kernel(*args)
            _same(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_fused_pass_valid_within_present_on_card(dev):
    """No ``& present`` after K1: on a window whose bids hit absent slots
    the fused pass on the card equals the CPU path, valid slots present."""
    rng = np.random.default_rng(8)
    na, n = 240_000, 1_000_000
    a_ts = rng.integers(0, 500, na).astype(np.int32)
    b = {"a_id": (1000 + np.arange(na)).astype(np.int32), "a_date_time": a_ts,
         "expires": (a_ts + rng.integers(10, 900, na)).astype(np.int32),
         "category": rng.integers(10, 15, na).astype(np.int32)}
    bvalid = rng.random(na) < 0.8
    f = np.arange(n) * na // n
    p = {"auction": (1000 + np.clip(f - rng.integers(0, 100, n), 0, na - 1)
                     ).astype(np.int32),
         "price": rng.integers(1, 10**6, n).astype(np.int32),
         "b_date_time": rng.integers(0, 900, n).astype(np.int32)}
    pvalid = rng.random(n) < 0.95
    node = next(x for x in plan.walk(plan.fuse_join_aggregates(
        get_query(4).plan)) if isinstance(x, plan.FusedJoinAggregate))

    def fused(d):
        b_cols, p_cols = _on(d, b), _on(d, p)
        return plan.fused_local_pass(node, b_cols, _on(d, bvalid), p_cols,
                                     _on(d, pvalid),
                                     plan.fused_replay(node, b_cols, p_cols))

    runs = [fused(d) for d in (dev, "cpu")]
    (gout, gvalid, _, gesc), (cout, cvalid, _, cesc) = runs
    assert not bool(gesc) and not bool(cesc)
    assert torch.equal(gvalid.cpu(), cvalid) and cvalid.any()
    for k in cout:
        assert torch.equal(gout[k].cpu(), cout[k]), k
    absent_ids = torch.from_numpy(b["a_id"][~bvalid])
    assert not torch.isin(cout["auction"][cvalid], absent_ids).any()


def _join_case(dev, seed, miss=False):
    rng = np.random.default_rng(seed)
    span, n = 20_000, 300_000
    slots = {"a": rng.integers(0, 1000, span).astype(np.int32),
             "e": rng.integers(500, 2000, span).astype(np.int32),
             "cat": rng.integers(10, 15, span).astype(np.int32)}
    present = rng.random(span) < 0.9
    rel = np.arange(n) * span // n - rng.integers(-20, 100, n)
    probe = {"k": (77 + rel + (2 * span if miss else 0)).astype(np.int32),
             "t": rng.integers(0, 2000, n).astype(np.int32),
             "price": rng.integers(-(10**9), 10**9, n).astype(np.int32)}
    pvalid = rng.random(n) < 0.95

    def t(x):
        return torch.from_numpy(x).to(dev)

    return ({k: t(v) for k, v in slots.items()}, t(present),
            torch.tensor(77, dtype=torch.int32, device=dev),
            {k: t(v) for k, v in probe.items()}, t(pvalid))


@pytest.mark.parametrize("op", ["<", "<=", ">", ">=", "==", "!="])
def test_join_agg_kernel_equals_plain(dev, op):
    slots, present, m, probe, pvalid = _join_case(dev, 2)
    pred = Conj((("t", ">=", "a"), ("t", op, "e")))
    aggs = [("price", "max", "mx"), ("price", "min", "mn"),
            ("price", "sum", "s"), ("t", "count_sum", "cs"),
            ("cat", "max", "cat"), (None, "count", "c")]
    got, gvalid, esc = join_aggregate(slots, present, m, probe, pvalid, "k",
                                      pred, aggs)
    want, wvalid = join_agg_plain(slots, present, m, probe, pvalid, "k",
                                  pred, aggs)
    _same(got, want)
    assert torch.equal(gvalid, wvalid) and not bool(esc)


def test_join_agg_no_hits_and_no_predicate(dev):
    slots, present, m, probe, pvalid = _join_case(dev, 3, miss=True)
    aggs = [("price", "max", "mx"), (None, "count", "c")]
    got, gvalid, _ = join_aggregate(slots, present, m, probe, pvalid, "k",
                                    None, aggs)
    assert not gvalid.any()
    _same(got, join_agg_plain(slots, present, m, probe, pvalid, "k", None,
                              aggs)[0])


def test_join_agg_refuses_opaque_predicate(dev):
    slots, present, m, probe, pvalid = _join_case(dev, 4)
    with pytest.raises(NotImplementedError):
        join_aggregate(slots, present, m, probe, pvalid, "k",
                       lambda c: c["t"] > 0, [(None, "count", "c")])


@pytest.mark.parametrize("span,n,m", [(248_192, 300_000, 1000),
                                       (18_304, 200_000, 1000), (7, 1000, -3)])
def test_gather_kernel_equals_plain(dev, span, n, m):
    """4- and 8-byte columns, signed values, misses on both sides of the
    span, absent slots, invalid rows, a negative m."""
    rng = np.random.default_rng(span)

    def t(x):
        return torch.from_numpy(x).to(dev)

    slots = {"a": t(rng.integers(-(2**31), 2**31, span).astype(np.int32)),
             "ts": t(rng.integers(-(2**62), 2**62, span).astype(np.int64)),
             "f": t(rng.random(span).astype(np.float32))}
    present = t(rng.random(span) < 0.8)
    keys = t((m + rng.integers(-50, span + 50, n)).astype(np.int32))
    valid = t(rng.random(n) < 0.9)
    mm = torch.tensor(m, dtype=torch.int32, device=dev)
    got, ghit = gather(slots, present, mm, keys, valid)
    want, whit = gather_plain(slots, present, mm, keys, valid)
    assert torch.equal(ghit, whit) and ghit.any() and not ghit.all()
    _same(got, want)


def _k3_args(dev, case, offset=0, span=248_192, n=1_000_000):
    """K3's adversarial case on ``dev`` at the card's size; ``offset`` > 0
    puts the probe side (keys, valid, carried columns) off a 16-byte
    boundary."""
    slots, present, m, keys, valid, out_rows, carry = k3_case(
        case, span=span, n=n, seed=len(case))
    return (_on(dev, slots), _on(dev, present),
            torch.tensor(int(m), dtype=torch.int32, device=dev),
            _on(dev, keys, offset), _on(dev, valid, offset), out_rows,
            None if carry is None else _on(dev, carry, offset))


def _k3_same(got, want):
    (g, ghit), (w, whit) = got, want
    assert list(g) == list(w)
    _same(g, w)
    assert ghit.dtype == torch.bool and torch.equal(ghit, whit)


@pytest.mark.parametrize("case", K3_CASES)
def test_gather_adversarial_equals_plain(dev, case):
    """Every row of every output bit-equal to the plain version: one hot
    slot, all misses, keys at the int32 extremes (32-bit wrap), a span of
    1, ragged and tiny n, 8-byte, mixed and eight columns (the run-time
    signature), and the carry to E > n rows."""
    args = _k3_args(dev, case)
    _k3_same(gather(*args), gather_plain(*args))


@pytest.mark.parametrize("case", ["one_slot", "n_5", "n_1003", "mixed",
                                  "carry", "carry_ragged"])
def test_gather_vector_and_scalar_paths_agree(dev, case):
    """Probe columns one element off a 16-byte boundary take the kernel's
    row-by-row path (and the carry's byte path): the same outputs as the
    aligned 16-byte path and the plain version."""
    aligned, shifted = _k3_args(dev, case), _k3_args(dev, case, offset=1)
    assert shifted[3].data_ptr() % 16 and shifted[4].data_ptr() % 16
    got = gather(*shifted)
    _k3_same(got, gather(*aligned))
    _k3_same(got, gather_plain(*shifted))


def test_gather_writes_every_output(dev, monkeypatch):
    """K3's output buffer (``torch.empty``) holds 0x7f bytes when the kernel
    starts: the kernel still writes every byte of every output, the padding
    rows and the carried columns included."""
    empty = torch.empty

    def stale_empty(*shape, **kw):
        t = empty(*shape, **kw)
        t.view(torch.uint8).fill_(0x7f)
        return t

    for case in ("carry", "carry_ragged", "mixed"):
        args = _k3_args(dev, case)
        want = gather_plain(*args)
        with monkeypatch.context() as mp:
            mp.setattr(torch, "empty", stale_empty)
            got = gather(*args)
        _k3_same(got, want)


def test_clean_lookup_join_is_one_gather_on_card(dev, monkeypatch):
    """A clean duplicate-faithful join (q3's person join) on the card: one
    K3 launch writes the whole E-row output, no ``torch.cat`` pads it, and
    every row equals the CPU path's."""
    slots, present, m, keys, valid, E, carry = k3_case(
        "carry", span=50_000, n=300_000)
    ids = (int(m) + np.flatnonzero(present)).astype(np.int32)
    build = {"p_id": ids, **{k: v[present] for k, v in slots.items()}}
    take = {k: k for k in slots}
    runs, cats = [], []
    for d in (dev, "cpu"):
        args = (_on(d, build), _on(d, np.ones(len(ids), bool)), "p_id",
                _on(d, carry), _on(d, valid), "seller", take)
        if d != "cpu":
            before = gather.launches
            with monkeypatch.context() as mp:
                mp.setattr(torch, "cat", lambda *a, **k: cats.append(1))
                runs.append(kernels.lookup_join(*args, out_capacity=E))
            assert gather.launches == before + 1 and not cats
        else:
            runs.append(kernels.lookup_join(*args, out_capacity=E))
    (gout, ghit, _, gesc), (cout, chit, _, cesc) = runs
    assert not bool(gesc) and not bool(cesc)
    assert ghit.shape == (E,) and torch.equal(ghit.cpu(), chit) and chit.any()
    assert list(gout) == list(cout)
    for k in cout:
        assert torch.equal(gout[k].cpu(), cout[k]), k


def _card_and_cpu(dev, q, seconds, eps, gens):
    epochs = generate_epochs(seconds, eps, gens)
    runs = []
    for device in (dev, "cpu"):
        driver = StreamDriver(get_query(q), seconds, device=device)
        if gens > 1:
            driver._window_epoch_ranges = lambda occupancy=None: [
                (("win", 0, seconds), list(range(seconds)))]
        runs.append((driver.run(epochs), driver.executor.fallback_runs))
    (gpu, gpu_fb), (cpu, cpu_fb) = runs
    assert gpu_fb == cpu_fb
    for g, c in zip(gpu, cpu):
        for name in get_query(q).schema.names:
            np.testing.assert_array_equal(g.columns[name], c.columns[name])
    return gpu_fb


@pytest.mark.parametrize("seconds,eps,gens", [(2, 20_000, 1), (10, 350, 3)])
def test_q4_on_the_card_equals_cpu(dev, seconds, eps, gens):
    assert _card_and_cpu(dev, 4, seconds, eps, gens) == (1 if gens > 1 else 0)


@pytest.mark.parametrize("q,seconds,eps,gens,reruns", [
    (9, 2, 20_000, 1, 0), (9, 10, 350, 3, 1), (3, 2, 20_000, 1, 0),
    (3, 10, 350, 3, 0), (13, 2, 20_000, 1, 0)])
def test_lookup_join_queries_on_the_card_equal_cpu(dev, q, seconds, eps, gens,
                                                   reruns):
    """q9's second join gathers through K3 from the fused pass's slots;
    q3's person join and q13's side-input join slot with K2 first.  Only
    q9's G=3 window holds duplicate build keys (auction ids)."""
    assert _card_and_cpu(dev, q, seconds, eps, gens) == reruns


@pytest.mark.parametrize("q,seconds,eps,gens,reruns", [
    (6, 2, 20_000, 1, 0), (6, 10, 350, 3, 1), (12, 12, 20_000, 1, 0)])
def test_q6_and_q12_on_the_card_equal_cpu(dev, q, seconds, eps, gens, reruns):
    """q6's fused pass (K2 slotting, K1 with the int64 max of ``__order``)
    and its rerun over duplicate auction ids; q12's processing-time windows
    (one K2 count per chunk)."""
    assert _card_and_cpu(dev, q, seconds, eps, gens) == reruns


def test_consts_runners_agree_on_the_card(dev):
    """q12's fast runner against the general one on the same staged chunks
    on the card, and both against the CPU's fast runner."""
    epochs = generate_epochs(10, 50_000, 1)
    outs = []
    for device in (dev, "cpu"):
        driver = StreamDriver(get_query(12), 10, device=device)
        staged = driver.prestage(epochs)
        consts = {"p_time": [t * 1000 for t in range(10)]}
        ex = driver.executor
        fast = ex.execute_consts(staged, consts, 300_000)
        general = ex._run_plan_consts(
            staged, "bid", ("p_time",),
            np.asarray([[p] for p in consts["p_time"]], np.int32), 300_000)
        outs += [fast, general]
    ref = outs[2]
    assert bool(ref.valid.any())
    for b in outs:
        assert torch.equal(b.valid.cpu(), ref.valid)
        for name, col in ref.columns.items():
            assert torch.equal(b.columns[name].cpu()[ref.valid],
                               col[ref.valid]), name


@pytest.mark.parametrize("n", [1, 1003, 2_000_000])
def test_dense_agg_one_hot_key_equals_plain(dev, n):
    """Every row on one key (q7's max price, q5's max count over the
    constant ``__g``): the warp combine folds whole warps onto one slot;
    count and max stay exact."""
    rng = np.random.default_rng(n)
    keys = torch.zeros(n, dtype=torch.int32, device=dev)
    valid = _on(dev, rng.random(n) < 0.95)
    cols = {"v": _on(dev, rng.integers(-(10**9), 10**9, n).astype(np.int32))}
    aggs = [("v", "max", "mx"), (None, "count", "c"), (None, "dups", "d")]
    got, gvalid, ovf = dense_agg(keys, valid, cols, aggs, 8)
    want, wvalid, wovf = dense_agg_plain(keys, valid, cols, aggs, 8)
    _same(got, want)
    assert torch.equal(gvalid, wvalid) and not bool(ovf) and not bool(wovf)
    assert int(got["c"][0]) == int(valid.sum())


@pytest.mark.parametrize("cap", [128, 300_000])
def test_dense_agg_without_aggregates_equals_plain(dev, cap):
    """``aggs=()`` (q8's distinct sellers): the packed argument array is
    empty; slot keys and validity still come out."""
    rng = np.random.default_rng(cap)
    n = 400_000
    keys = _on(dev, rng.integers(7, 7 + cap, n).astype(np.int32))
    valid = _on(dev, rng.random(n) < 0.8)
    got, gvalid, ovf = dense_agg(keys, valid, {}, [], cap)
    want, wvalid, wovf = dense_agg_plain(keys, valid, {}, [], cap)
    _same(got, want)
    assert list(got) == ["__key"]
    assert torch.equal(gvalid, wvalid) and bool(ovf) == bool(wovf)


def test_gather_every_probe_on_one_slot(dev):
    """q7's join: 8 slots, one present, every probe key on it."""
    rng = np.random.default_rng(7)
    n = 3_000_000
    slots = {"maxprice": _on(dev, rng.integers(0, 10**8, 8).astype(np.int32))}
    present = _on(dev, np.arange(8) == 0)
    m = torch.zeros((), dtype=torch.int32, device=dev)
    keys = torch.zeros(n, dtype=torch.int32, device=dev)
    valid = _on(dev, rng.random(n) < 0.9)
    got = gather(slots, present, m, keys, valid)
    _k3_same(got, gather_plain(slots, present, m, keys, valid))
    assert torch.equal(got[1], valid)


def test_execute_epochs_on_the_card_equals_cpu(dev):
    """q5's hopping windows through ``execute_epochs`` (the epochs staged
    end to end, each window a view of them): the card's device output
    equals the CPU path's in capacity, validity and every valid row."""
    epochs = generate_epochs(15, 20_000, 1)
    outs = []
    for device in (dev, "cpu"):
        driver = StreamDriver(get_query(5), 15, device=device)
        staged = driver.stage_epochs(epochs, driver.epoch_caps(epochs))
        outs.append([driver.executor.execute_epochs([staged[t] for t in rng])
                     for _, rng in driver.epoch_ranges(epochs)])
    assert len(outs[0]) == 2
    for g, c in zip(*outs):
        assert g.capacity == c.capacity and torch.equal(g.valid.cpu(), c.valid)
        assert bool(c.valid.any())
        for name, col in c.columns.items():
            assert torch.equal(g.columns[name].cpu()[c.valid], col[c.valid])


def test_windows_on_the_card_are_views_equal_to_the_copy(dev):
    """q5's hopping windows on the card: the epochs staged end to end hold
    the bytes of the epochs staged one by one; each window is a view of
    them (``execute.form_views``), and its device output equals, bit for
    bit, the copy that the epochs staged one by one take
    (``execute.form_copies``)."""
    from flock_tpu_torch.utils.metrics import METRICS

    epochs = generate_epochs(15, 20_000, 1)
    driver = StreamDriver(get_query(5), 15, device=dev)
    ex, caps = driver.executor, driver.epoch_caps(epochs)
    ring = driver.stage_epochs(epochs, caps)
    single = [{r: ex.stage_chunk(e[r], c) for r, c in caps.items()}
              for e in epochs]
    for a, b in zip(ring, single):
        for rel in caps:
            assert torch.equal(a[rel].valid, b[rel].valid)
            _same(a[rel].columns, b[rel].columns)

    def forms():
        return tuple(METRICS.counters.get(f"execute.form_{k}", 0)
                     for k in ("views", "copies"))

    before = forms()
    ranges = [rng for _, rng in driver.epoch_ranges(epochs)]
    for rng in ranges:
        got = ex.execute_epochs([ring[t] for t in rng])
        want = ex.execute_epochs([single[t] for t in rng])
        assert got.capacity == want.capacity
        assert torch.equal(got.valid, want.valid)
        _same(got.columns, want.columns)
    assert [a - b for a, b in zip(forms(), before)] == [len(ranges)] * 2


@pytest.mark.parametrize("q,win", [(5, None), (7, None), (8, None),
                                   (0, None), (1, None), (10, None),
                                   (2, ("sliding", 4, 2)), (2, ("stagger", 3)),
                                   (2, ("rows", 50_000))])
def test_windowed_queries_on_the_card_equal_cpu(dev, q, win):
    """Every new query and window kind through ``StreamDriver.run`` on the
    card: the same sink rows as the CPU path, no fallback."""
    import dataclasses

    epochs = generate_epochs(15, 20_000, 1)
    spec = get_query(q) if win is None else \
        dataclasses.replace(get_query(q), window=win)
    runs = [StreamDriver(spec, 15, device=d).run(epochs) for d in (dev, "cpu")]
    assert len(runs[0]) == len(runs[1]) >= 1
    for g, c in zip(*runs):
        assert g.tag == c.tag
        for name in spec.schema.names:
            assert g.columns[name].dtype == c.columns[name].dtype
            np.testing.assert_array_equal(g.columns[name], c.columns[name])


def test_ysb_on_the_card_equals_cpu(dev):
    cfg = YsbConfig(seconds=20, events_per_second=200_000, threads=2)
    lanes = dense_agg.variant_launches["lanes"]
    k4 = lookup_aggregate.launches
    gpu = run_ysb(cfg, device=dev)
    # each window's filter, lookup and count per campaign is one call of K4,
    # and K2 counts nothing by campaign (it only slots the campaign table)
    assert lookup_aggregate.launches - k4 == len(gpu)
    assert dense_agg.variant_launches["lanes"] == lanes
    cpu = run_ysb(cfg, device="cpu")
    assert len(gpu) == len(cpu) == 2
    for g, c in zip(gpu, cpu):
        for name in ("campaign_id", "count"):
            np.testing.assert_array_equal(g.columns[name], c.columns[name])
        assert len(g.columns["count"]) == cfg.campaigns


def _session_rows(results):
    names = ("bidder", "bid_count", "start_time", "end_time")
    return sorted(tuple(int(r.columns[c][i]) for c in names)
                  for r in results for i in range(len(r.columns["bidder"])))


@pytest.mark.parametrize("tier", ["device", "rollback", "generic"])
def test_q11_on_the_card_equals_cpu(dev, tier, monkeypatch):
    """q11 through ``StreamDriver.run`` on the card in each session tier
    (the device tier also with an emission buffer of 64 sessions, which
    forces rollbacks): the same tags and sink rows as the CPU path, and
    the rows of ``oracle.q11_sessions``."""
    import oracle
    from flock_tpu_torch.runtime import device_session

    epochs = generate_epochs(24, 20_000, 1)
    if tier == "rollback":
        monkeypatch.setattr(device_session, "CAP_OUT", 64)
    if tier == "generic":
        monkeypatch.setattr(device_session, "session_fast_spec",
                            lambda *a, **kw: None)
    drivers = [StreamDriver(get_query(11), 24, device=d) for d in (dev, "cpu")]
    gpu, cpu = (d.run(epochs) for d in drivers)
    assert [g.tag for g in gpu] == [c.tag for c in cpu] and len(gpu) > 1
    for g, c in zip(gpu, cpu):
        for name, col in c.columns.items():
            assert g.columns[name].dtype == col.dtype
            np.testing.assert_array_equal(g.columns[name], col)
    want = oracle.q11_sessions([e["bid"] for e in epochs], gap=10)
    assert _session_rows(gpu) == sorted(zip(*(
        want[n].tolist() for n in ("bidder", "bid_count", "start_time",
                                   "end_time"))))
    if tier == "rollback":
        assert drivers[0].session_stats.retries > 0


def test_device_session_resume_on_the_card(dev, tmp_path):
    """The device tier's checkpoint/resume on the card: epochs 0-7 through
    ``step_impl``, the open sessions through ``to_payloads`` and a file
    backend, a fresh driver resuming with ``run_device_sessions(...,
    resume_payloads=..., t_base=8)``; the union of the emissions equals
    the uninterrupted CPU run's rows."""
    from flock_tpu_torch.batch import TS_BASE, Batch
    from flock_tpu_torch.runtime import device_session as ds
    from flock_tpu_torch.runtime.state import FileStateBackend
    from flock_tpu_torch.runtime.stream import SessionState

    key, tcol = SessionState.key, SessionState.time_col
    epochs = generate_epochs(24, 20_000, 1)
    spec = get_query(11)
    gap, split = spec.window[1], 8
    want = _session_rows(StreamDriver(spec, 24, device="cpu").run(epochs))
    fs = ds.session_fast_spec(spec, key, "bid")
    ea, accs = ds._acc_plan(fs, key, tcol)
    ks = [e["bid"][key] for e in epochs]
    m, kmax = min(int(k.min()) for k in ks), max(int(k.max()) for k in ks)
    SE = ds._bucket(max(int(k.max()) - int(k.min()) + 1 for k in ks))
    state = ds.init_state(ds._bucket(kmax - m + 1 + 8192) + SE, accs, dev)
    rows = []
    for t in range(split):
        bid = {c: epochs[t]["bid"][c] for c in (key, tcol)}
        b = Batch.from_numpy(bid, len(bid[key]), dev)
        state, oc, _, ne, ovf = ds.step_impl(
            key, tcol, ea, accs, SE, 1 << 16, True, gap, t + 1 - gap, m,
            state, dict(b.columns), b.valid,
            (int(bid[key].min()), int(bid[key].max())))
        assert not bool(ovf)
        n = int(ne)
        host = ds.finish_names(fs, key, {c: a[:n].cpu().numpy()
                                         for c, a in oc.items()})
        rows += [(int(host["bidder"][i]), int(host["bid_count"][i]),
                  int(host["start_time"][i]) + TS_BASE,
                  int(host["end_time"][i]) + TS_BASE) for i in range(n)]
    backend = FileStateBackend(root=str(tmp_path))
    for p in ds.to_payloads(state, m, accs, "card", split):
        backend.write(0, p)
    payloads = [backend.read("card", 0, 0, s)
                for s in backend.list_seqs("card", 0, 0)]
    assert len(payloads[0].columns["__key"]) > 0
    res = ds.run_device_sessions(StreamDriver(spec, 24, device=dev),
                                 epochs[split:], None, fs,
                                 resume_payloads=payloads, t_base=split)
    assert sorted(rows + _session_rows(res)) == want


# -- the SQL frontend and the CLI (slice 8) ----------------------------------

SQL_TEXTS = {
    4: ("SELECT category, Avg(final) AS avg_final FROM (SELECT Max(price) AS "
        "final, category FROM auction INNER JOIN bid ON a_id = auction WHERE "
        "b_date_time BETWEEN a_date_time AND expires GROUP BY a_id, category"
        ") AS Q GROUP BY category;"),
    9: ("SELECT auction, bidder, price, b_date_time FROM bid JOIN (SELECT "
        "a_id AS id, Max(price) AS final FROM auction INNER JOIN bid ON "
        "a_id = auction WHERE b_date_time BETWEEN a_date_time AND expires "
        "GROUP BY a_id) AS Q ON auction = id AND price = final;"),
    13: ("SELECT auction, bidder, price, b_date_time, value FROM bid JOIN "
         "side_input ON auction = key;"),
}


@pytest.mark.parametrize("q,seconds,eps,gens,reruns", [
    (4, 2, 20_000, 1, 0), (4, 10, 350, 3, 1), (9, 2, 20_000, 1, 0),
    (13, 2, 20_000, 1, 0)])
def test_sql_on_the_card_equals_cpu_and_hand_plan(dev, q, seconds, eps, gens,
                                                  reruns):
    """SQL q4, q9 and q13 lowered by ``sql_to_spec``: the card's rows equal
    the CPU path's and the hand plan's on the card, with the same reruns;
    SQL q4 and q9 launch K1 (the fused pass kept its Conj), q13 K3."""
    from flock_tpu_torch.sql.catalog import nexmark_catalog
    from flock_tpu_torch.sql.lower import sql_to_spec

    spec = sql_to_spec(SQL_TEXTS[q], nexmark_catalog())
    hand = get_query(q)
    epochs = generate_epochs(seconds, eps, gens)
    whole = [(("win", 0, seconds), list(range(seconds)))]
    runs = []
    for s, device in ((spec, dev), (spec, "cpu"), (hand, dev)):
        driver = StreamDriver(s, seconds, device=device)
        if gens > 1:
            driver._window_epoch_ranges = lambda occupancy=None: whole
        before = {"join_agg": join_aggregate.launches,
                  "gather": gather.launches}
        res = driver.run(epochs)
        runs.append((res, driver.executor.fallback_runs,
                     {k: w.launches - before[k] for k, w in
                      (("join_agg", join_aggregate), ("gather", gather))}))
    (gpu, gfb, gl), (cpu, cfb, _), (hnd, hfb, hl) = runs
    assert gfb == cfb == hfb == reruns
    assert bool(gl["join_agg"]) == (q in (4, 9)) == bool(hl["join_agg"])
    if q == 13:
        assert gl["gather"] > 0
    for g, c, h in zip(gpu, cpu, hnd):
        for name, hname in zip(spec.schema.names, hand.schema.names):
            np.testing.assert_array_equal(g.columns[name], c.columns[name])
            np.testing.assert_array_equal(g.columns[name], h.columns[hname])


@pytest.mark.parametrize("n_build,n_probe", [(8, 10), (10_000, 1_000_000)])
def test_float_key_join_on_the_card_equals_cpu(dev, n_build, n_probe):
    """The sorted lookup join (plain PyTorch) on float32 keys: misses,
    invalid build rows, a duplicate key, a NaN probe and -0.0 against 0.0,
    row for row the CPU path's."""
    rng = np.random.default_rng(n_build)
    bk = rng.permutation(n_build).astype(np.float32) * 0.5
    bk[:2] = (-0.0, bk[2])          # -0.0 and a duplicate of row 2's key
    pk = bk[rng.integers(0, n_build, n_probe)] + np.float32(0.25) * (
        rng.random(n_probe) < 0.2)  # ~20 % miss
    pk[:3] = (np.nan, 0.0, -0.0)
    build = {"k": torch.from_numpy(bk),
             "v": torch.arange(n_build, dtype=torch.int32)}
    bvalid = torch.from_numpy(rng.random(n_build) < 0.9)
    probe = {"k": torch.from_numpy(pk),
             "p": torch.arange(n_probe, dtype=torch.int32)}
    pvalid = torch.ones(n_probe, dtype=torch.bool)
    cout, chit = kernels.sorted_lookup_join(build, bvalid, "k", probe, pvalid,
                                            "k", {"v": "v"})
    gout, ghit = kernels.sorted_lookup_join(
        {c: t.to(dev) for c, t in build.items()}, bvalid.to(dev), "k",
        {c: t.to(dev) for c, t in probe.items()}, pvalid.to(dev), "k",
        {"v": "v"})
    assert torch.equal(ghit.cpu(), chit) and not bool(chit[0])
    for c in cout:
        assert torch.equal(gout[c].cpu()[chit], cout[c][chit]), c


def test_cli_fsql_on_the_card(dev, capsys):
    """``fsql`` one-shot on the card prints the CPU path's window."""
    from flock_tpu_torch import cli

    out = []
    for device in ("cuda", "cpu"):
        assert cli.main(["fsql", SQL_TEXTS[4], "-s", "2", "-e", "20000",
                         "--device", device]) == 0
        out.append([ln for ln in capsys.readouterr().out.splitlines()
                    if " rows in " not in ln])
    assert out[0] == out[1] and out[0][0] == "window ('sql',): 5 rows"


# -- the sharded executor on the card ------------------------------------------


def _dist_rows(results, names):
    return [[np.asarray(r.columns[n]) for n in names] for r in results]


@pytest.mark.parametrize("q,seconds,eps,gens", [
    (4, 2, 20_000, 8), (9, 2, 20_000, 8), (4, 10, 350, 3), (6, 2, 20_000, 8),
    (11, 12, 5_000, 8), (5, 12, 5_000, 8)])
def test_distributed_on_the_card_equals_cpu(dev, q, seconds, eps, gens):
    """DistStreamDriver over 8 shards on one card: the CPU path's windows,
    row for row (K1, K2 and K3 launched per shard; q4 and q9 at G=3 rerun
    on the fan-out)."""
    from flock_tpu_torch.parallel.stream import DistStreamDriver
    from flock_tpu_torch.runtime.stream import generate_epoch_parts

    parts = generate_epoch_parts(seconds, eps, gens)
    spec = get_query(q)
    got = []
    for device in (dev, "cpu"):
        driver = DistStreamDriver(spec, seconds, 8, device=device)
        got.append((driver.run(parts), driver.executor.fallback_runs))
    (gpu, gfb), (cpu, cfb) = got
    assert gfb == cfb and [r.tag for r in gpu] == [r.tag for r in cpu]
    for g, c in zip(_dist_rows(gpu, spec.schema.names),
                    _dist_rows(cpu, spec.schema.names)):
        for a, b in zip(g, c):
            np.testing.assert_array_equal(a, b)


def test_hash32_on_the_card_equals_cpu(dev):
    from flock_tpu_torch.parallel.shuffle import hash32

    rng = np.random.default_rng(4)
    k32 = torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 20)
                           .astype(np.int32))
    k64 = torch.from_numpy(rng.integers(-2**62, 2**62, 1 << 20))
    for keys in ([k32], [k64], [k32, k64]):
        assert torch.equal(hash32([k.to(dev) for k in keys]).cpu(),
                           hash32(keys))


def test_distributed_widen_on_the_card(dev):
    """Duplicate auction ids (G=3) in one window over 8 shards: the fused
    pass escapes, the fan-out's rows overflow a shuffle bucket, and the
    window widens and reruns — on the card as on the CPU, to the same
    rows."""
    from flock_tpu_torch.parallel.executor import DistributedExecutor
    from flock_tpu_torch.runtime.stream import generate_epoch_parts
    from flock_tpu_torch.runtime.tables import concat_relations

    parts = generate_epoch_parts(10, 350, 3)
    shards = [dict(concat_relations(
        [p for e in parts for j, p in enumerate(e) if j % 8 == i],
        ("auction", "bid"))) for i in range(8)]
    out = []
    for device in (dev, "cpu"):
        ex = DistributedExecutor(get_query(4), 8, device=device)
        out.append((ex.execute_window(shards), ex.host_syncs,
                    ex.fallback_runs))
    (g, *gn), (c, *cn) = out
    assert gn == cn and cn[0] > 2      # more than one attempt
    for k in c:
        np.testing.assert_array_equal(g[k], c[k])


def test_one_process_nccl_multihost_on_the_card(dev):
    """MultiHostExecutor in a one-process NCCL group holding 4 shards on
    the card: the in-process 4-shard executor's rows."""
    import socket

    import torch.distributed as dist

    from flock_tpu_torch.parallel.executor import DistributedExecutor
    from flock_tpu_torch.parallel.mesh import make_multihost_mesh
    from flock_tpu_torch.parallel.multihost import MultiHostExecutor
    from flock_tpu_torch.runtime.stream import generate_epoch_parts
    from flock_tpu_torch.runtime.tables import concat_relations

    parts = generate_epoch_parts(2, 20_000, 4)
    shards = [dict(concat_relations([e[i] for e in parts],
                                    ("auction", "bid"))) for i in range(4)]
    want = DistributedExecutor(get_query(4), 4, device=dev).execute_window(
        shards)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        ex = MultiHostExecutor(get_query(4), mesh=make_multihost_mesh(4))
        got = ex.execute_window(shards)
    finally:
        dist.destroy_process_group()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_mesh_across_cards_equals_one_card(dev):
    """With as many cards as shards, shard i lives on ``cuda:i`` (the
    exchange copies between cards): q9's rows equal the one-card mesh's.
    Needs at least two cards."""
    from flock_tpu_torch.parallel.executor import DistributedExecutor
    from flock_tpu_torch.parallel.mesh import make_mesh
    from flock_tpu_torch.runtime.stream import generate_epoch_parts
    from flock_tpu_torch.runtime.tables import concat_relations

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    mesh = make_mesh(n)
    assert [d.index for d in mesh.devices] == list(range(n))
    parts = generate_epoch_parts(2, 20_000, n)
    shards = [dict(concat_relations([e[i] for e in parts],
                                    ("auction", "bid"))) for i in range(n)]
    got = DistributedExecutor(get_query(9), n, mesh=mesh).execute_window(
        shards)
    want = DistributedExecutor(
        get_query(9), n, mesh=make_mesh(n, device="cuda:0")).execute_window(
        shards)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- slice 10: stacked windows, fragment recovery, ingestion -----------------


@pytest.mark.parametrize("q", [4, 9])
def test_execute_stacked_on_the_card_equals_cpu(dev, q):
    """Four clean windows and a G=3 window stacked: the card's stacked
    output equals the CPU's slot for slot, with one flag read for the
    clean windows and one more for the escaped window's rerun."""
    from flock_tpu_torch.runtime.executor import LocalExecutor
    from flock_tpu_torch.runtime.tables import concat_relations

    epochs = generate_epochs(4, 40_000)
    dup = concat_relations(generate_epochs(10, 350, 3), ("auction", "bid"))
    windows = [{r: e[r] for r in ("auction", "bid")} for e in epochs]
    caps = {"auction": 8192, "bid": 65536}
    outs = []
    for device in (dev, "cpu"):
        ex = LocalExecutor(get_query(q), device=device)
        clean = ex.execute_stacked([ex.prepare_window(w, caps)
                                    for w in windows])
        mixed = ex.execute_stacked([ex.prepare_window(w, caps)
                                    for w in (windows[0], dup, windows[1])])
        outs.append((clean, mixed, ex.host_syncs, ex.fallback_runs))
    (g_clean, g_mixed, *gn), (c_clean, c_mixed, *cn) = outs
    assert gn == cn == [3, 1]
    for (g, gov), (c, cov) in ((g_clean, c_clean), (g_mixed, c_mixed)):
        assert torch.equal(gov.cpu(), cov)
        assert torch.equal(g.valid.cpu(), c.valid)
        for k in c.columns:
            assert torch.equal(g.columns[k].cpu(), c.columns[k]), k


def test_recovered_window_on_the_card_equals_cpu(dev, tmp_path):
    """A q4 window checkpointed as fragments, one lost and pulled back
    from the file backend: its rows on the card (single-card and 8
    shards) equal the CPU's."""
    from flock_tpu_torch.parallel.executor import DistributedExecutor
    from flock_tpu_torch.runtime.arena import Arena, WindowStatus
    from flock_tpu_torch.runtime.executor import (LocalExecutor,
                                                  materialize_columns)
    from flock_tpu_torch.runtime.payload import to_fragments
    from flock_tpu_torch.runtime.state import FileStateBackend
    from flock_tpu_torch.runtime.tables import concat_relations

    window = concat_relations(generate_epochs(2, 200_000),
                              ("auction", "bid"))
    backend = FileStateBackend(root=str(tmp_path))
    arena = Arena()
    for rel in ("auction", "bid"):
        frags = to_fragments(window[rel], f"rq-{rel}", granule=20_000)
        for f in frags:
            backend.write(0, f)
        for f in frags[1:] + frags[:1]:
            if f.fragment.seq_num != 2:
                arena.collect(f)
    for seq in arena.missing(("rq-bid", 0)):
        assert arena.collect(backend.read("rq-bid", 0, 0, seq)) \
            is WindowStatus.READY
    tables = {rel: arena.take((f"rq-{rel}", 0)) for rel in ("auction", "bid")}
    shards = [{rel: {k: v[i::8] for k, v in cols.items()}
               for rel, cols in tables.items()} for i in range(8)]
    got = []
    for device in (dev, "cpu"):
        ex = LocalExecutor(get_query(4), device=device)
        dist = DistributedExecutor(get_query(4), 8, device=device)
        got.append((ex.materialize(ex.execute_window(tables)),
                    materialize_columns(get_query(4),
                                        dist.execute_window(shards))))
    (g1, g8), (c1, c8) = got
    for k in c1:
        np.testing.assert_array_equal(g1[k], c1[k])
        np.testing.assert_array_equal(g8[k], c8[k])


def test_ingest_q4_on_the_card_equals_cpu(dev):
    """q4 over scrambled, duplicated fragment lines: the IngestDriver on
    the card gives the CPU's rows, window for window."""
    import random

    from flock_tpu_torch.datagen.ingest import IngestDriver, fragment_lines

    epochs = generate_epochs(3, 20_000)
    lines = fragment_lines(epochs, "q4", granule=512,
                           relations=("auction", "bid"))
    random.Random(3).shuffle(lines)
    lines += lines[:7]
    got = IngestDriver(get_query(4), 3, "q4", device=dev).run(lines)
    want = IngestDriver(get_query(4), 3, "q4", device="cpu").run(lines)
    assert [r.tag for r in got] == [r.tag for r in want]
    for g, w in zip(got, want):
        for k in w.columns:
            np.testing.assert_array_equal(g.columns[k], w.columns[k])


# -- more aggregates than one kernel launch holds ------------------------------

# nine aggregates by one int32 key (one more than a K2 launch holds), the
# BETWEEN chain with nine (one more than K1 takes), five int64 sums by
# auction (ten K2 sums in a sharded final)
MANY_AGGS_SQL = (
    "SELECT auction, Max(price), Min(price), Sum(price), Max(b_date_time), "
    "Min(b_date_time), Max(bidder), Min(bidder), Sum(bidder), "
    "Sum(b_date_time) FROM bid GROUP BY auction")
MANY_AGGS_JOIN_SQL = (
    "SELECT a_id, Max(price), Min(price), Sum(price), Max(bidder), "
    "Min(bidder), Sum(bidder), Max(b_date_time), Min(b_date_time), "
    "Sum(b_date_time) FROM auction INNER JOIN bid ON a_id = auction WHERE "
    "b_date_time BETWEEN a_date_time AND expires GROUP BY a_id")
FIVE_SUMS_SQL = ("SELECT auction, Sum(price) AS s1, Sum(price) AS s2, "
                 "Sum(price) AS s3, Sum(price) AS s4, Sum(price) AS s5 "
                 "FROM bid GROUP BY auction;")


@pytest.fixture
def no_plain_on_card(monkeypatch):
    """A card tensor reaching a plain K2 version fails the test."""
    from flock_tpu_torch.ops import dense_agg as dense_agg_module

    for mod in (dense_agg_module, kernels):
        plain = mod.dense_agg_plain

        def guarded(keys, *a, plain=plain):
            assert not keys.is_cuda, "a card tensor reached dense_agg_plain"
            return plain(keys, *a)

        monkeypatch.setattr(mod, "dense_agg_plain", guarded)


@pytest.mark.parametrize("n_aggs", [9, 17])
def test_dense_agg_splits_aggregates_over_launches(dev, n_aggs,
                                                   no_plain_on_card):
    """More kernel aggregates than one launch holds (8): ceil(n / 8)
    launches on the same keys, every output equal to the plain version's
    (run on the CPU), and no plain version on a card tensor."""
    rng = np.random.default_rng(n_aggs)
    n, cap = 500_000, 300_000
    keys = rng.integers(3, 3 + cap + 100, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    cols = {c: rng.integers(-(10**9), 10**9, n).astype(np.int32)
            for c in "vw"}
    fns = ("count_sum", "sum", "min", "max")
    aggs = [(None, "count", "c")] + [
        ("vw"[i % 2], fns[i % 4], f"a{i}") for i in range(n_aggs)]
    want = dense_agg(torch.from_numpy(keys), torch.from_numpy(valid),
                     {c: torch.from_numpy(v) for c, v in cols.items()},
                     aggs, cap)
    before = dense_agg.launches
    got = dense_agg(torch.from_numpy(keys).to(dev),
                    torch.from_numpy(valid).to(dev),
                    {c: torch.from_numpy(v).to(dev) for c, v in cols.items()},
                    aggs, cap)
    assert dense_agg.launches - before == -(-n_aggs // 8)
    _same({k: v.cpu() for k, v in got[0].items()}, want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert bool(got[2]) == bool(want[2]) is True


def _sql_window(sql, device, seconds=2, eps=20_000):
    from flock_tpu_torch.runtime.executor import LocalExecutor
    from flock_tpu_torch.runtime.tables import concat_relations
    from flock_tpu_torch.sql.catalog import nexmark_catalog
    from flock_tpu_torch.sql.lower import sql_to_spec

    spec = sql_to_spec(sql, nexmark_catalog())
    window = concat_relations(generate_epochs(seconds, eps),
                              spec.relations)
    ex = LocalExecutor(spec, device=device)
    return spec, ex.materialize(ex.execute_window(window))


@pytest.mark.parametrize("sql,launches", [
    (MANY_AGGS_SQL, {"join_agg": 0, "dense_agg": 2, "gather": 0}),
    (MANY_AGGS_JOIN_SQL, {"join_agg": 0, "dense_agg": 3, "gather": 1})])
def test_many_aggregates_sql_on_the_card_equals_cpu(dev, sql, launches,
                                                    no_plain_on_card):
    """Nine aggregates by auction take K2 in two launches; the BETWEEN
    chain with nine takes the unfused path (the join's slotting on K2 and
    gather on K3, the aggregate's two K2 launches), with no K1 launch: the
    card's rows equal the CPU path's."""
    wrappers = {"join_agg": join_aggregate, "dense_agg": dense_agg,
                "gather": gather}
    before = {k: w.launches for k, w in wrappers.items()}
    spec, got = _sql_window(sql, dev)
    assert {k: w.launches - before[k]
            for k, w in wrappers.items()} == launches
    _, want = _sql_window(sql, "cpu")
    assert len(want[spec.schema.names[0]]) > 0
    for name in spec.schema.names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_five_wide_sums_sharded_on_the_card_equal_cpu(dev, no_plain_on_card):
    """Five int64 sums by auction over 8 shards: each shard's partial is
    one K2 launch and its final (ten K2 sums by 31-bit halves) two; the
    rows equal the CPU path's."""
    from flock_tpu_torch.parallel.executor import DistributedExecutor
    from flock_tpu_torch.runtime.stream import generate_epoch_parts
    from flock_tpu_torch.runtime.tables import concat_relations
    from flock_tpu_torch.sql.catalog import nexmark_catalog
    from flock_tpu_torch.sql.lower import sql_to_spec

    spec = sql_to_spec(FIVE_SUMS_SQL, nexmark_catalog())
    shards = [[] for _ in range(8)]
    for epoch in generate_epoch_parts(2, 20_000, 8):
        for p, part in enumerate(epoch):
            shards[p].append(part)
    tables = [concat_relations(ps, ("bid",)) for ps in shards]
    got = []
    for device in (dev, "cpu"):
        before = dense_agg.launches
        dist = DistributedExecutor(spec, 8, device=device)
        got.append(dist.execute_window(tables))
        if device is dev:
            assert dense_agg.launches - before == 8 + 8 * 2
    assert len(got[1]["auction"]) > 0
    for name in spec.schema.names:
        np.testing.assert_array_equal(got[0][name], got[1][name],
                                      err_msg=name)


# K4's cases on the card: the adversarial ones of torch_kernel_cases, plus
# YSB's shape at 4 M events with n one past a multiple of 4
K4_CARD_CASES = K4_CASES + ("ysb_4m",)


def _k4_args(dev, case, offset=0):
    name, n = ("ysb", 4 * 2**20 + 1) if case == "ysb_4m" else (case, 8192)
    build, events, cap = k4_case(name, n=n)
    taken, present, m = k4_slots(build)
    cols = {c: _on(dev, events[c], offset) for c in ("et", "x", "y")}
    return (_on(dev, taken), _on(dev, present),
            torch.tensor(int(m), dtype=torch.int32, device=dev),
            _on(dev, events["ad"], offset), _on(dev, events["valid"], offset),
            cols, Conj(k4_terms(name)), cap)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", K4_CARD_CASES)
def test_lookup_agg_kernel_equals_plain(dev, case, offset):
    """K4 against its plain version on the same card tensors: counts, slot
    keys, validity and the escape flag, bit for bit; ``offset`` 1 takes
    the element-wise loads (columns off the 16-byte boundary)."""
    args = _k4_args(dev, case, offset)
    before = lookup_aggregate.launches
    got = lookup_aggregate(*args)
    want = lookup_agg_plain(*args)
    assert lookup_aggregate.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_lookup_agg_writes_every_output(dev, monkeypatch):
    """K4's outputs and scratch (``torch.empty``) hold 0x7f bytes when the
    kernels start, and still equal the plain version's."""
    empty = torch.empty

    def stale_empty(*shape, **kw):
        t = empty(*shape, **kw)
        t.view(torch.uint8).fill_(0x7f)
        return t

    args = _k4_args(dev, "misses")
    want = lookup_agg_plain(*args)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "empty", stale_empty)
        got = lookup_aggregate(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", K4_CASES)
def test_lookup_aggregate_node_on_the_card_equals_cpu(dev, case):
    """The fused node's lowering (K2's build slotting, then K4) on the card
    against the CPU's: every column, the validity and both flags."""
    build, events, cap = k4_case(case)
    views = plan.Filter(plan.Scan("ev"), Conj(k4_terms(case)))
    node = plan.fuse_join_aggregates(plan.Aggregate(
        plan.Join(build=plan.Scan("camp"), probe=views, build_key="k",
                  probe_key="ad", take=(("cid", "cid"),), unique_build=True),
        ("cid",), ((None, "count", "n"),), out_capacity=cap))
    assert isinstance(node, plan.FusedLookupAggregate)
    outs = []
    for d in (dev, torch.device("cpu")):
        tables = {rel: Batch({c: _on(d, v) for c, v in t.items()
                              if c != "valid"}, _on(d, t["valid"]))
                  for rel, t in (("camp", build), ("ev", events))}
        outs.append(plan.lower(node, tables))
    g, c = outs
    _same({k: v.cpu() for k, v in g.cols.items()}, c.cols)
    assert torch.equal(g.valid.cpu(), c.valid)
    assert bool(g.overflow) == bool(c.overflow)
    assert bool(g.escape) == bool(c.escape)

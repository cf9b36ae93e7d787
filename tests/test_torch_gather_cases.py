"""Kernel K3 (probe-side gather) on adversarial inputs
(``torch_kernel_cases``): the port's CPU path (``gather_plain``) against an
independent numpy version on every case and against the reference's
``pallas_factored_gather`` in interpret mode where its int32 planes allow;
the join output of ``out_rows``/``carry`` against the reference's
``lookup_join`` clean branch row for row, capacity included; and the lookup
join's call site (one gather for the whole clean output).  Exact comparisons
(PyTorch port, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flock_tpu.ops import kernels as ref_kernels
from flock_tpu.pallas import factored
from flock_tpu_torch.ops import kernels
from flock_tpu_torch.ops.gather import gather
from flock_tpu_torch.plan import dup_expand_capacity
from torch_kernel_cases import K3_CASES, K3_PALLAS_CASES, k3_case

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(slots, present, m, keys, valid, out_rows, carry):
    return ({k: _t(v) for k, v in slots.items()}, _t(present),
            torch.tensor(int(m), dtype=torch.int32), _t(keys), _t(valid),
            out_rows, None if carry is None else {k: _t(v)
                                                  for k, v in carry.items()})


def _numpy_gather(slots, present, m, keys, valid, out_rows, carry):
    """The contract in numpy: key - m in 64 bits, misses gather 0, carried
    columns copied, every output zero-padded to ``out_rows``."""
    n = len(keys)
    rows = n if out_rows is None else out_rows
    rel = keys.astype(np.int64) - np.int64(m)
    hit = np.zeros(rows, bool)
    for i in range(n):
        hit[i] = valid[i] and 0 <= rel[i] < len(present) and present[rel[i]]
    out = {}
    for k, v in slots.items():
        out[k] = np.zeros(rows, v.dtype)
        out[k][:n][hit[:n]] = v[rel[:n][hit[:n]]]
    for k, v in (carry or {}).items():
        out[k] = np.zeros(rows, v.dtype)
        out[k][:n] = v
    return out, hit


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_plain_matches_numpy_on_adversarial_inputs(case):
    args = k3_case(case)
    got, ghit = gather(*_port(*args))
    want, whit = _numpy_gather(*args)
    np.testing.assert_array_equal(ghit.numpy(), whit)
    assert ghit.dtype == torch.bool
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert whit.any() == (case != "all_miss")


@pytest.mark.parametrize("case", K3_PALLAS_CASES)
def test_k3_plain_matches_pallas_on_adversarial_inputs(case):
    """Every row of hit, and the gathered values on every hit (the
    reference leaves them unspecified under a miss); a window as wide as the
    span, so no block escapes."""
    slots, present, m, keys, valid, out_rows, carry = k3_case(case)
    s_loc = max(1024, -(-len(present) // 1024) * 1024)
    # one 8-bit limb plane for byte-sized codes (the reference's hint), so
    # q3's three columns fit its plane budget
    limbs = {k: 1 for k, v in slots.items() if v.min() >= 0 and v.max() < 256}
    g, h, esc = factored.pallas_factored_gather(
        {k: jnp.asarray(v) for k, v in slots.items()}, jnp.asarray(present),
        jnp.int32(m), jnp.asarray(keys), jnp.asarray(valid), list(slots),
        s_loc=s_loc, interpret=True, limbs=limbs or None)
    assert not bool(esc)
    got, ghit = gather(*_port(slots, present, m, keys, valid, None, None))
    h = np.asarray(h)
    np.testing.assert_array_equal(ghit.numpy(), h)
    for k in slots:
        np.testing.assert_array_equal(got[k].numpy()[h], np.asarray(g[k])[h],
                                      err_msg=k)


def _join_inputs(seed, n=3000, nb=800):
    """A unique build (a clean window) and probe columns of several
    widths, q3's shape: the key, a bool, an int64 and int32 columns."""
    rng = np.random.default_rng(seed)
    build = {"p_id": (2000 + rng.permutation(nb)).astype(np.int32),
             "name": rng.integers(0, 100, nb).astype(np.int32),
             "city": rng.integers(0, 10, nb).astype(np.int32)}
    bvalid = rng.random(nb) < 0.7
    probe = {"a_id": np.arange(n, dtype=np.int32),
             "seller": (2000 + rng.integers(-100, nb + 100, n)).astype(np.int32),
             "reserve": rng.integers(0, 10**8, n).astype(np.int32),
             "ts": rng.integers(0, 2**40, n).astype(np.int64),
             "flag": rng.random(n) < 0.3,
             "name": rng.integers(-5, 5, n).astype(np.int32)}  # replaced
    return build, bvalid, probe, rng.random(n) < 0.9


@pytest.mark.parametrize("seed", [0, 1])
def test_clean_join_output_equals_reference_clean_branch(seed):
    """The duplicate-faithful join of a unique build at E =
    dup_expand_capacity(n): every carried column and hit row for row over
    all E rows, the gathered columns on every hit and zero on the padding —
    the reference's clean_branch; a taken column named like a probe column
    replaces it, as there."""
    build, bvalid, probe, pvalid = _join_inputs(seed)
    take = {"name": "name", "city": "p_city"}
    E = dup_expand_capacity(len(pvalid))
    want, whit, wovf = ref_kernels.lookup_join(
        {k: jnp.asarray(v) for k, v in build.items()}, jnp.asarray(bvalid),
        "p_id", {k: jnp.asarray(v) for k, v in probe.items()},
        jnp.asarray(pvalid), "seller", take, out_capacity=E)
    got, ghit, govf, gesc = kernels.lookup_join(
        {k: _t(v) for k, v in build.items()}, _t(bvalid), "p_id",
        {k: _t(v) for k, v in probe.items()}, _t(pvalid), "seller", take,
        out_capacity=E)
    assert not bool(wovf) and not bool(govf) and not bool(gesc)
    whit = np.asarray(whit)
    assert ghit.shape == (E,) and whit.shape == (E,) and whit.any()
    np.testing.assert_array_equal(ghit.numpy(), whit)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.shape == w.shape == (E,) and g.dtype == w.dtype, k
        if k in take.values():
            np.testing.assert_array_equal(g[whit], w[whit], err_msg=k)
            assert not g[len(pvalid):].any() and not w[len(pvalid):].any()
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("mode", ["clean", "slotted", "unique"])
def test_lookup_join_gathers_its_whole_output_once(mode, monkeypatch):
    """The clean duplicate-faithful pass makes one K3 call that writes every
    output at E rows (the probe columns carried, a replaced one left out);
    a slotted or unique build keeps n rows, and its probe columns pass
    through uncopied."""
    calls = []
    orig = kernels.gather

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(kernels, "gather", spy)
    build, bvalid, probe, pvalid = _join_inputs(2)
    n = len(pvalid)
    kw = {"clean": {"out_capacity": dup_expand_capacity(n)},
          "slotted": {"build_slotted": True},
          "unique": {"dup_expand": False}}[mode]
    if mode == "slotted":
        build = {"p_id": np.arange(2000, 2800, dtype=np.int32),
                 "name": build["name"], "city": build["city"]}
    tprobe = {k: _t(v) for k, v in probe.items()}
    out, hit, _, _ = kernels.lookup_join(
        {k: _t(v) for k, v in build.items()}, _t(bvalid), "p_id", tprobe,
        _t(pvalid), "seller", {"name": "name", "city": "p_city"}, **kw)
    assert len(calls) == 1
    if mode == "clean":
        assert calls[0]["out_rows"] == dup_expand_capacity(n)
        assert list(calls[0]["carry"]) == ["a_id", "seller", "reserve", "ts",
                                           "flag"]
        assert hit.shape == (dup_expand_capacity(n),)
    else:
        assert calls[0]["out_rows"] == n and calls[0]["carry"] is None
        assert all(out[k] is tprobe[k] for k in probe if k != "name")
    assert list(out) == list(probe) + ["p_city"]


@pytest.mark.parametrize("ncarry", [32, 33])
def test_clean_join_carries_up_to_32_probe_columns(ncarry):
    """K3's carry limit as ``lookup_join`` meets it: a clean
    duplicate-faithful join carries 32 probe columns besides the taken ones,
    each copied and zero-padded to E rows; the 33rd is refused by name, on
    the CPU as on the card."""
    build, bvalid, probe, pvalid = _join_inputs(3)
    n, E = len(pvalid), dup_expand_capacity(len(pvalid))
    wide = {"seller": probe["seller"],
            **{f"c{i}": probe["reserve"] + i for i in range(ncarry - 1)}}
    args = ({k: _t(v) for k, v in build.items()}, _t(bvalid), "p_id",
            {k: _t(v) for k, v in wide.items()}, _t(pvalid), "seller",
            {"name": "name"})
    if ncarry > 32:
        with pytest.raises(NotImplementedError, match="32 carried"):
            kernels.lookup_join(*args, out_capacity=E)
        return
    out, hit, _, esc = kernels.lookup_join(*args, out_capacity=E)
    assert not bool(esc) and hit.shape == (E,) and hit.any()
    assert list(out) == list(wide) + ["name"]
    for k, v in wide.items():
        np.testing.assert_array_equal(out[k].numpy()[:n], v, err_msg=k)
        assert not out[k].numpy()[n:].any(), k

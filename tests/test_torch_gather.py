"""Kernel K3 (probe-side gather of a lookup join): the port's plain version,
the CPU path of ``gather``, against the reference's
``pallas_factored_gather`` in interpret mode and its XLA formulation
``blocked_local_join`` on tests/test_pallas.py's inputs (signed values,
misses, absent slots), an 8-byte column, and the wrapper's input checks.
Every comparison is exact (PyTorch port, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flock_tpu.ops import blocked
from flock_tpu.pallas import factored
from flock_tpu_torch.ops.gather import gather, gather_plain

torch.set_num_threads(1)


def _inputs(seed=22, span=8192, n=16384):
    """tests/test_pallas.py::test_factored_gather_matches_blocked's inputs."""
    rng = np.random.default_rng(seed)
    pres = rng.random(span) < 0.9
    a = rng.integers(-(2**31), 2**31, span).astype(np.int32)
    b = rng.integers(0, 100, span).astype(np.int32)
    key = np.clip(np.arange(n) // 16 + rng.integers(-100, 50, n),
                  -50, span + 50).astype(np.int32)   # some misses
    pv = rng.random(n) < 0.95
    return {"a": a, "b": b}, pres, key, pv


def _port(slots, pres, m, key, pv):
    return ({k: torch.from_numpy(v) for k, v in slots.items()},
            torch.from_numpy(pres), torch.tensor(m, dtype=torch.int32),
            torch.from_numpy(key), torch.from_numpy(pv))


def _assert_same(got, ref_g, ref_h):
    g, h = got
    ref_h = np.asarray(ref_h)
    np.testing.assert_array_equal(h.numpy(), ref_h)
    assert h.dtype == torch.bool
    for c, v in g.items():
        r = np.asarray(ref_g[c])
        assert v.numpy().dtype == r.dtype, c
        np.testing.assert_array_equal(v.numpy()[ref_h], r[ref_h], err_msg=c)
        assert not v.numpy()[~ref_h].any(), c   # misses gather 0


@pytest.mark.parametrize("ref", ["pallas_interpret", "blocked"])
def test_matches_reference(ref):
    slots, pres, key, pv = _inputs()
    js = {k: jnp.asarray(v) for k, v in slots.items()}
    if ref == "blocked":
        g, h, e = blocked.blocked_local_join(
            js, jnp.asarray(pres), jnp.int32(0), jnp.asarray(key),
            jnp.asarray(pv), ["a", "b"], block=4096, s_loc=512)
    else:
        g, h, e = factored.pallas_factored_gather(
            js, jnp.asarray(pres), jnp.int32(0), jnp.asarray(key),
            jnp.asarray(pv), ["a", "b"], s_loc=512, interpret=True,
            limbs={"b": 1})
    assert not bool(e)
    got = gather(*_port(slots, pres, 0, key, pv))
    _assert_same(got, g, h)
    # the case covers hits, misses below the span, absent slots, invalid rows
    assert got[1].any() and (key < 0).any() and not pv.all()
    assert (~pres[np.clip(key, 0, len(pres) - 1)] & pv).any()


def test_offset_span_and_eight_byte_column():
    """A span starting at m = 1000 and an int64 column (absolute ms
    timestamps) against numpy."""
    rng = np.random.default_rng(5)
    span, n, m = 3000, 10_000, 1000
    pres = rng.random(span) < 0.8
    ts = (1_436_918_400_000 + rng.integers(0, 10**9, span)).astype(np.int64)
    code = rng.integers(-5, 5, span).astype(np.int32)
    key = (m + rng.integers(-200, span + 200, n)).astype(np.int32)
    pv = rng.random(n) < 0.9
    g, h = gather(*_port({"ts": ts, "code": code}, pres, m, key, pv))
    rel = key.astype(np.int64) - m
    ok = pv & (rel >= 0) & (rel < span)
    want_h = ok & pres[np.where(ok, rel, 0)]
    np.testing.assert_array_equal(h.numpy(), want_h)
    idx = rel[want_h]
    assert g["ts"].dtype == torch.int64 and g["code"].dtype == torch.int32
    np.testing.assert_array_equal(g["ts"].numpy()[want_h], ts[idx])
    np.testing.assert_array_equal(g["code"].numpy()[want_h], code[idx])
    assert not g["ts"].numpy()[~want_h].any()


def test_keys_far_from_the_span_miss():
    """Keys at the int32 extremes: key − m is taken in 64 bits and never
    wraps into the span."""
    slots = {"v": np.arange(4, dtype=np.int32)}
    pres = np.ones(4, bool)
    key = np.array([-(2**31), 2**31 - 1, 5, 6, 9], np.int32)
    g, h = gather(*_port(slots, pres, -(2**31) + 4, key, np.ones(5, bool)))
    assert h.tolist() == [False, False, False, False, False]
    g, h = gather(*_port(slots, pres, 2**31 - 4, key, np.ones(5, bool)))
    assert h.tolist() == [False, True, False, False, False]
    assert g["v"].tolist() == [0, 3, 0, 0, 0]


@pytest.mark.parametrize("bad", ["key_dtype", "valid_shape", "present_dtype",
                                 "col_shape", "col_width", "m", "noncontig",
                                 "empty_span"])
def test_checks_its_inputs(bad):
    slots = {"v": torch.arange(8, dtype=torch.int32)}
    present = torch.ones(8, dtype=torch.bool)
    m = torch.tensor(0, dtype=torch.int32)
    keys = torch.arange(16, dtype=torch.int32)
    valid = torch.ones(16, dtype=torch.bool)
    if bad == "key_dtype":
        keys = keys.to(torch.int64)
    elif bad == "valid_shape":
        valid = valid[:8]
    elif bad == "present_dtype":
        present = present.to(torch.int32)
    elif bad == "col_shape":
        slots = {"v": torch.arange(9, dtype=torch.int32)}
    elif bad == "col_width":
        slots = {"v": torch.arange(8, dtype=torch.int16)}
    elif bad == "m":
        m = torch.tensor([0], dtype=torch.int32)
    elif bad == "noncontig":
        keys = torch.arange(32, dtype=torch.int32)[::2]
    else:
        slots, present = {}, torch.ones(0, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        gather(slots, present, m, keys, valid)


def test_plain_version_is_the_cpu_path():
    slots, pres, key, pv = _inputs(seed=3, span=512, n=2048)
    args = _port(slots, pres, 0, key, pv)
    g1, h1 = gather(*args)
    g2, h2 = gather_plain(*args)
    assert torch.equal(h1, h2)
    for k in g2:
        assert torch.equal(g1[k], g2[k])

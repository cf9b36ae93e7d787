"""tests/test_dup_join.py's seven cases through the port: the duplicate
build-key fan-out of ``kernels.lookup_join`` and the ``wmin:`` winner
carries of ``kernels.group_aggregate``, against flock_tpu's functions on
the same inputs and against numpy.  Every SQL join on a soft key (a_id,
p_id) takes this fan-out when its build keys repeat.

The port's duplicate-faithful join runs in two passes where the reference
branches on the device: the clean pass raises ``escape`` on duplicate keys
(and, for a build declared unique, ``overflow``), and the executor's rerun
with ``fallback=True`` fans out (PyTorch port, CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flock_tpu.ops import kernels as RK
from flock_tpu_torch.ops import kernels as K

torch.set_num_threads(1)


def _rows(out, hit):
    hit = np.asarray(hit)
    o = {c: np.asarray(a) for c, a in out.items()}
    return sorted((int(o["k"][i]), int(o["tag"][i]), int(o["bval"][i]))
                  for i in range(len(hit)) if hit[i])


def _ref_join(build, probe, out_capacity=None, **kw):
    out, hit, ovf = RK.lookup_join(
        {"k": jnp.asarray(np.asarray(build["k"], np.int32)),
         "v": jnp.asarray(np.asarray(build["v"], np.int32))},
        jnp.asarray(np.asarray(build["valid"], bool)), "k",
        {"k": jnp.asarray(np.asarray(probe["k"], np.int32)),
         "tag": jnp.asarray(np.asarray(probe["tag"], np.int32))},
        jnp.asarray(np.asarray(probe["valid"], bool)), "k",
        {"v": "bval"}, out_capacity=out_capacity, **kw)
    return _rows(out, hit), bool(ovf)


def _port_join(build, probe, out_capacity=None, fallback=False, **kw):
    def t(a, dt):
        return torch.from_numpy(np.asarray(a, dt))

    out, hit, ovf, esc = K.lookup_join(
        {"k": t(build["k"], np.int32), "v": t(build["v"], np.int32)},
        t(build["valid"], bool), "k",
        {"k": t(probe["k"], np.int32), "tag": t(probe["tag"], np.int32)},
        t(probe["valid"], bool), "k", {"v": "bval"},
        out_capacity=out_capacity, fallback=fallback, **kw)
    return _rows(out, hit), bool(ovf), bool(esc)


def _fanout(build, probe, out_capacity):
    """The port's two passes: the clean one escapes (duplicates), the
    rerun fans out.  Returns the rerun's (rows, overflow)."""
    _, ovf, esc = _port_join(build, probe, out_capacity)
    assert esc and not ovf
    rows, ovf, _ = _port_join(build, probe, out_capacity, fallback=True)
    return rows, ovf


def _numpy_join(build, probe):
    rows = []
    for i in range(len(probe["k"])):
        if not probe["valid"][i]:
            continue
        for j in range(len(build["k"])):
            if build["valid"][j] and build["k"][j] == probe["k"][i]:
                rows.append((int(probe["k"][i]), int(probe["tag"][i]),
                             int(build["v"][j])))
    return sorted(rows)


def test_fanout_matches_numpy_reference():
    rng = np.random.default_rng(7)
    n_b, n_p = 64, 128
    build = {"k": rng.integers(100, 120, n_b), "v": rng.integers(0, 1000, n_b),
             "valid": rng.random(n_b) < 0.9}
    probe = {"k": rng.integers(95, 125, n_p), "tag": np.arange(n_p),
             "valid": rng.random(n_p) < 0.9}
    rows, ovf = _fanout(build, probe, n_p * 8)
    assert not ovf
    assert rows == _numpy_join(build, probe) == \
        _ref_join(build, probe, out_capacity=n_p * 8)[0]


def test_fanout_unbounded_multiplicity():
    # one key duplicated 6x: sort-merge expansion has no layer bound
    build = {"k": [10, 11, 11] + [12] * 6 + [0],
             "v": [100, 200, 201, 300, 301, 302, 303, 304, 305, 0],
             "valid": [True] * 9 + [False]}
    probe = {"k": [11, 12, 10, 13, 12] + [0] * 27,
             "tag": list(range(32)),
             "valid": [True] * 5 + [False] * 27}
    rows, ovf = _fanout(build, probe, 48)
    assert not ovf
    assert rows == _numpy_join(build, probe) == \
        _ref_join(build, probe, out_capacity=48)[0]


def test_fanout_overflow_when_extras_exceed_free_slots():
    build = {"k": [10] * 8, "v": list(range(8)), "valid": [True] * 8}
    probe = {"k": [10, 10, 10, 10], "tag": [0, 1, 2, 3],
             "valid": [True] * 4}
    # 4 probes x 7 extras = 28 extras, zero free slots at capacity 4
    _, ovf = _fanout(build, probe, 4)
    assert ovf and _ref_join(build, probe, out_capacity=4)[1]
    # and fits once the caller widens (the driver's retry posture)
    rows, ovf = _fanout(build, probe, 64)
    assert not ovf
    assert len(rows) == 32
    assert rows == _ref_join(build, probe, out_capacity=64)[0]


def test_unique_build_declaration_flags_duplicates():
    build = {"k": [10, 10, 11, 12], "v": [1, 2, 3, 4], "valid": [True] * 4}
    probe = {"k": [10, 11], "tag": [0, 1], "valid": [True] * 2}
    _, ovf, esc = _port_join(build, probe, dup_expand=False)
    assert ovf and not esc, \
        "declared-unique build with duplicates must overflow"
    assert _ref_join(build, probe, dup_expand=False)[1]
    build["k"] = [10, 13, 11, 12]
    rows, ovf, esc = _port_join(build, probe, dup_expand=False)
    assert not ovf and not esc
    assert (rows, ovf) == _ref_join(build, probe, dup_expand=False)


def _both_group_aggregate(cols, keys, aggs, cap):
    """(port rows, reference rows) of one grouped aggregate over all-valid
    rows: (keys..., o, s) per valid output slot."""
    out, ovalid, ovf, esc = K.group_aggregate(
        {k: torch.from_numpy(v) for k, v in cols.items()},
        torch.ones(len(cols["g"]), dtype=torch.bool), keys, aggs, cap)
    assert not bool(ovf) and not bool(esc)
    rout, rvalid, rovf = RK.group_aggregate(
        {k: jnp.asarray(v) for k, v in cols.items()},
        jnp.asarray(np.ones(len(cols["g"]), bool)), keys, aggs, cap)
    assert not bool(rovf)
    names = keys + ["o", "s"]

    def rows(o, valid):
        valid = np.asarray(valid)
        return sorted(tuple(int(np.asarray(o[n])[i]) for n in names)
                      for i in range(cap) if valid[i])

    return rows(out, ovalid), rows(rout, rvalid)


def test_wmin_winner_carry_scatter():
    # groups: key 5 -> orders [9, 9, 4] carries [30, 20, 1] => winner min 20
    #         key 6 -> orders [7]       carries [40]        => 40
    cols = {"g": np.array([5, 5, 5, 6], np.int32),
            "o": np.array([9, 9, 4, 7], np.int32),
            "s": np.array([30, 20, 1, 40], np.int32)}
    got, want = _both_group_aggregate(
        cols, ["g"], [("o", "max", "o"), ("s", "wmin:o", "s")], 8)
    assert got == want == [(5, 9, 20), (6, 7, 40)]


def test_wmin_multikey_sorted_path():
    # multi-key grouping exercises the sort-based scatter path
    cols = {"g": np.array([1, 1, 1, 2], np.int32),
            "h": np.array([0, 0, 1, 0], np.int32),
            "o": np.array([5, 8, 8, 3], np.int32),
            "s": np.array([7, 9, 2, 4], np.int32)}
    got, want = _both_group_aggregate(
        cols, ["g", "h"], [("o", "max", "o"), ("s", "wmin:o", "s")], 8)
    assert got == want == [(1, 0, 8, 9), (1, 1, 8, 2), (2, 0, 3, 4)]


@pytest.mark.parametrize("fallback", [False, True])
def test_wmin_int64_order_rebase(fallback):
    # int64 order column rides the rebase path (the escape rerun's
    # unrebased scatter too); wmin recursion stays exact
    big = np.int64(3) << 40
    cols = {"g": np.array([1, 1, 2], np.int32),
            "o": np.array([big + 5, big + 5, big + 1], np.int64),
            "s": np.array([12, 11, 30], np.int32)}
    aggs = [("o", "max", "o"), ("s", "wmin:o", "s")]
    if fallback:
        out, ovalid, ovf, esc = K.group_aggregate(
            {k: torch.from_numpy(v) for k, v in cols.items()},
            torch.ones(3, dtype=torch.bool), ["g"], aggs, 4, rebase=False)
        v = ovalid.numpy()
        got = sorted((int(out["g"][i]), int(out["o"][i]), int(out["s"][i]))
                     for i in range(4) if v[i])
        want = _both_group_aggregate(cols, ["g"], aggs, 4)[1]
    else:
        got, want = _both_group_aggregate(cols, ["g"], aggs, 4)
    assert got == want == [(1, int(big + 5), 11), (2, int(big + 1), 30)]

"""The sharded executor on the CPU against flock_tpu's on its 8-device CPU
mesh: ``hash32`` and the all-to-all layout bit for bit (a forced
per-destination overflow included), the byte record, every NEXMark query
against the port's ``LocalExecutor``, q3, q4, q6, q9, YSB and both Sort
paths row for row in the reference's order, duplicate build keys at G=3,
and one shard against eight (PyTorch port, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import flock_tpu.parallel.shuffle as ref_shuffle
from flock_tpu.batch import Schema as RefSchema
from flock_tpu.parallel.executor import DistributedExecutor as RefDist
from flock_tpu.parallel.mesh import AXIS, make_mesh as ref_make_mesh
from flock_tpu.plan import Scan as RefScan, Sort as RefSort
from flock_tpu.queries.nexmark import QuerySpec as RefSpec
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.queries.ysb import ysb_query as ref_ysb_query
from flock_tpu.runtime.executor import materialize_columns as ref_materialize
from flock_tpu.sql.catalog import nexmark_catalog as ref_catalog
from flock_tpu.sql.lower import sql_to_spec as ref_sql_to_spec
from flock_tpu_torch.batch import Schema
from flock_tpu_torch.datagen.ysb import YsbConfig
from flock_tpu_torch.parallel import shuffle
from flock_tpu_torch.parallel.executor import DistributedExecutor
from flock_tpu_torch.parallel.mesh import make_mesh
from flock_tpu_torch.plan import Scan, Sort
from flock_tpu_torch.queries.nexmark import QuerySpec, get_query
from flock_tpu_torch.queries.ysb import (campaign_table, generate_ysb_epochs,
                                         ysb_query)
from flock_tpu_torch.runtime.executor import (LocalExecutor,
                                              materialize_columns)
from flock_tpu_torch.runtime.stream import generate_epoch_parts
from flock_tpu_torch.runtime.tables import concat_relations, default_side_input
from flock_tpu_torch.sql.catalog import nexmark_catalog
from flock_tpu_torch.sql.lower import sql_to_spec

torch.set_num_threads(1)

N = 8
SECONDS, EPS, GENERATORS = 3, 1000, 8
SORT_SQL = ("SELECT auction, price FROM bid WHERE auction % 123 = 0 "
            "ORDER BY price DESC, auction;")


@pytest.fixture(scope="module")
def parts():
    return generate_epoch_parts(SECONDS, EPS, GENERATORS)


def rows(cols, names):
    arrays = [np.asarray(cols[n]) for n in names]
    if not len(arrays[0]):
        return []
    return sorted(zip(*(a.tolist() for a in arrays)))


def shard_window(parts, relations, broadcast=None, n=N):
    """Generator p → shard p % n over every epoch; bounded side tables on
    shard 0, empty copies elsewhere (tests/test_distributed.py's)."""
    shards = [[] for _ in range(n)]
    for epoch in parts:
        for p, part in enumerate(epoch):
            shards[p % n].append(part)
    out = []
    for i, ps in enumerate(shards):
        tables = dict(concat_relations(ps, relations))
        for rel, cols in (broadcast or {}).items():
            tables[rel] = cols if i == 0 else \
                {k: v[:0] for k, v in cols.items()}
        out.append(tables)
    return out


def _augment(tables):
    """The driver-attached columns as tests/test_distributed.py makes
    them: ``__session`` (q11) and ``p_time`` (q12)."""
    bid = dict(tables["bid"])
    bid["__session"] = (bid["bidder"] % 7).astype(np.int32)
    bid["p_time"] = (bid["b_date_time"] // 1000 % 100_000).astype(
        np.int32) * 1000
    return {**tables, "bid": bid}


# -- the exchange, bit for bit -------------------------------------------------


def test_hash32_equals_reference():
    rng = np.random.default_rng(3)
    k32 = np.concatenate([
        rng.integers(-2**31, 2**31, 5000, dtype=np.int64),
        [0, 1, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    k64 = np.concatenate([
        rng.integers(-2**62, 2**62, 5000, dtype=np.int64),
        [2**31, 2**31 + 5, -2**31 - 1, 2**40, -2**63, 2**63 - 1]])
    for keys in ([k32], [k64], [k32[:len(k64)], k64[:len(k32)]]):
        want = np.asarray(ref_shuffle.hash32([jnp.asarray(k) for k in keys]))
        got = shuffle.hash32([torch.from_numpy(k) for k in keys]).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _ref_all_to_all(cols, valid, per_dest_cap):
    """The reference's all_to_all_shuffle by key ``k`` under shard_map on
    its 8-device mesh: per-shard output columns, valid and overflow."""
    names = sorted(cols)
    mesh = ref_make_mesh(N)

    def local(*flat):
        c = {nm: a[0] for nm, a in zip(names, flat[:-1])}
        out, v, ovf = ref_shuffle.all_to_all_shuffle(
            c, flat[-1][0], ["k"], N, per_dest_cap=per_dest_cap)
        return tuple(out[nm][None] for nm in names) + (
            v[None], ovf.reshape(1, 1))

    fm = jax.jit(jax.shard_map(local, mesh=mesh,
                               in_specs=tuple([P(AXIS, None)] * (len(names)
                                                                  + 1)),
                               out_specs=P(AXIS, None)))
    outs = fm(*[np.stack(cols[nm]) for nm in names], np.stack(valid))
    return ({nm: np.asarray(o) for nm, o in zip(names, outs)},
            np.asarray(outs[-2]), np.asarray(outs[-1]))


@pytest.mark.parametrize("per_dest_cap", [None, 64, 16],
                         ids=["full", "quarter", "overflow"])
def test_all_to_all_layout_equals_reference(per_dest_cap):
    """Destination j receives, in source-shard order, ``per_dest_cap``
    rows from each source in the stable order of the destination sort;
    rows beyond a bucket drop and set every shard's overflow flag."""
    rng = np.random.default_rng(11)
    cap = 256
    cols = {"k": [rng.integers(-10**6, 10**6, cap).astype(np.int32)
                  for _ in range(N)],
            "v": [rng.integers(-2**40, 2**40, cap) for _ in range(N)],
            "f": [rng.standard_normal(cap).astype(np.float32)
                  for _ in range(N)]}
    valid = [rng.random(cap) < 0.7 for _ in range(N)]
    want_cols, want_valid, want_ovf = _ref_all_to_all(cols, valid,
                                                      per_dest_cap)
    mesh = make_mesh(N, device="cpu")
    got_cols, got_valid, got_ovf = shuffle.all_to_all_shuffle(
        mesh, [{nm: torch.from_numpy(cols[nm][i]) for nm in cols}
               for i in range(N)],
        [torch.from_numpy(v) for v in valid], ["k"], per_dest_cap)
    for i in range(N):
        np.testing.assert_array_equal(got_valid[i].numpy(), want_valid[i])
        for nm in cols:
            np.testing.assert_array_equal(got_cols[i][nm].numpy(),
                                          want_cols[nm][i])
        assert bool(got_ovf[i]) == bool(want_ovf[i, 0])
    assert bool(want_ovf.any()) == (per_dest_cap == 16)


def test_byte_tally_equals_reference():
    """The byte record for the reference's 4-shard, 256-row case: one
    int32 key column and the valid mask; each moves (n - 1) / n of its
    [n * per_dest_cap] buffer."""
    mesh = make_mesh(4, device="cpu")
    cap = 256
    shuffle.TALLY = records = []
    try:
        shuffle.all_to_all_shuffle(
            mesh, [{"k": torch.arange(cap, dtype=torch.int32)}] * 4,
            [torch.ones(cap, dtype=torch.bool)] * 4, ["k"])
    finally:
        shuffle.TALLY = None

    ref_mesh = ref_make_mesh(4)

    def local(cols_k, valid):
        out, v, ovf = ref_shuffle.all_to_all_shuffle(
            {"k": cols_k[0]}, valid[0], ["k"], 4)
        return out["k"][None], v[None], ovf.reshape(1, 1)

    fm = jax.jit(jax.shard_map(local, mesh=ref_mesh,
                               in_specs=(P(AXIS, None), P(AXIS, None)),
                               out_specs=P(AXIS, None)))
    ref_shuffle.TALLY = ref_records = []
    try:
        jax.eval_shape(fm, jax.ShapeDtypeStruct((4, cap), jnp.int32),
                       jax.ShapeDtypeStruct((4, cap), jnp.bool_))
    finally:
        ref_shuffle.TALLY = None
    assert [(r["op"], r["bytes_per_shard"], r["detail"]) for r in records] \
        == [(r["op"], r["ici_bytes_per_shard"], r["detail"])
            for r in ref_records] \
        == [("all_to_all", 4 * cap * 4 * 3 // 4, "k"),
            ("all_to_all", 4 * cap * 3 // 4, "valid")]


# -- every query against the port's single-device executor ---------------------


@pytest.mark.parametrize("qnum", range(14))
def test_distributed_matches_local(qnum, parts):
    spec = get_query(qnum)
    rels = tuple(r for r in spec.relations if r != "side_input")
    tables = dict(concat_relations([p for e in parts for p in e], rels))
    broadcast = {}
    if "side_input" in spec.relations:
        broadcast["side_input"] = tables["side_input"] = default_side_input()
    if qnum in (11, 12):
        tables = _augment(tables)
    local = LocalExecutor(spec, device="cpu")
    want = local.materialize(local.execute_window(tables))
    shard_tables = shard_window(parts, rels, broadcast)
    if qnum in (11, 12):
        shard_tables = [_augment(st) for st in shard_tables]
    dist = DistributedExecutor(spec, N, device="cpu")
    got = materialize_columns(spec, dist.execute_window(shard_tables))
    names = spec.schema.names
    assert rows(got, names) == rows(want, names), f"q{qnum}"
    assert dist.fallback_runs == 0
    assert dist.host_syncs == 1      # one read of every shard's flags


# -- row for row, in order, against the reference's executor -------------------


def _range_sort_tables():
    rng = np.random.default_rng(7)
    n_per = 9_000    # 8 × 9k rows > the 64k gather-everything threshold
    return [{"bid": {
        "price": rng.integers(0, 50_000, n_per).astype(np.int64),
        "auction": rng.integers(0, 10_000, n_per).astype(np.int64)}}
        for _ in range(N)]


def _ysb_tables():
    cfg = YsbConfig(seconds=2, events_per_second=4000, threads=8)
    epochs = generate_ysb_epochs(cfg)
    camp = campaign_table(cfg)
    events = {k: np.concatenate([e["ad_event"][k] for e in epochs])
              for k in epochs[0]["ad_event"]}
    return [{"ad_event": {k: v[i::N] for k, v in events.items()},
             "campaign": camp if i == 0 else
             {k: v[:0] for k, v in camp.items()}} for i in range(N)]


def _in_order_case(case, parts):
    """(port spec, reference spec, shard tables) of one in-order case."""
    if case == "ysb":
        return ysb_query(), ref_ysb_query(), _ysb_tables()
    if case == "sql-sort":
        return (sql_to_spec(SORT_SQL, nexmark_catalog()),
                ref_sql_to_spec(SORT_SQL, ref_catalog()),
                shard_window(parts, ("bid",)))
    if case == "range-sort":
        return (QuerySpec(99, Sort(Scan("bid"), ("price", "auction"),
                                   (True, False)), ("elementwise",),
                          ("bid",), Schema(["price", "auction"])),
                RefSpec(99, RefSort(RefScan("bid"), ("price", "auction"),
                                    (True, False)), ("elementwise",),
                        ("bid",), RefSchema(["price", "auction"])),
                _range_sort_tables())
    q = int(case[1:])
    spec = get_query(q)
    rels = tuple(r for r in spec.relations if r != "side_input")
    return spec, ref_get_query(q), shard_window(parts, rels)


@pytest.mark.parametrize("case", ["q3", "q4", "q6", "q9", "ysb", "sql-sort",
                                  "range-sort"])
def test_distributed_equals_reference_in_order(case, parts):
    """The same rows in the same (shard-major) order as flock_tpu's
    DistributedExecutor, every column of the sink exact."""
    spec, ref_spec, shard_tables = _in_order_case(case, parts)
    want = ref_materialize(ref_spec, RefDist(ref_spec, N).execute_window(
        shard_tables))
    dist = DistributedExecutor(spec, N, device="cpu")
    got = materialize_columns(spec, dist.execute_window(shard_tables))
    assert len(got[spec.schema.names[0]]) > 0
    for name in spec.schema.names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got[name].dtype == want[name].dtype, name
    assert dist.fallback_runs == 0


FIVE_SUMS_SQL = ("SELECT auction, Sum(price) AS s1, Sum(price) AS s2, "
                 "Sum(price) AS s3, Sum(price) AS s4, Sum(price) AS s5 "
                 "FROM bid GROUP BY auction;")


def test_final_of_five_wide_sums_splits_over_k2_launches(parts, monkeypatch):
    """Five int64 ``Sum(price)`` by auction: the final turns each partial
    sum into two K2 sums by 31-bit halves (ten), which K2 takes in two
    launches on each shard (8 + 2; the plain version per launch here, as
    the kernel on the card), and the rows equal the reference's
    DistributedExecutor's, in order."""
    from flock_tpu_torch.ops import dense_agg

    spec = sql_to_spec(FIVE_SUMS_SQL, nexmark_catalog())
    ref_spec = ref_sql_to_spec(FIVE_SUMS_SQL, ref_catalog())
    shard_tables = shard_window(parts, ("bid",))
    want = ref_materialize(ref_spec, RefDist(ref_spec, N).execute_window(
        shard_tables))
    sizes = []
    plain = dense_agg.dense_agg_plain
    monkeypatch.setattr(dense_agg, "dense_agg_plain", lambda *a: sizes.append(
        sum(f in dense_agg.AGG_CODES for _, f, _ in a[3])) or plain(*a))
    dist = DistributedExecutor(spec, N, device="cpu")
    got = materialize_columns(spec, dist.execute_window(shard_tables))
    assert sizes == [5] * N + [8, 2] * N
    assert len(got["auction"]) > 0
    for name in spec.schema.names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert got[name].dtype == want[name].dtype, name


# -- duplicate build keys, and the mesh's width --------------------------------


@pytest.mark.parametrize("qnum", [3, 4, 6, 9])
def test_distributed_duplicate_build_keys(qnum):
    """Duplicate auction ids (misaligned G=3): the broadcast build carries
    them to every shard, the window reruns on the fan-out branch (q3's
    person ids never repeat: it stays clean) and the rows equal the
    single-device executor's (tests/test_distributed.py's case)."""
    dup_parts = generate_epoch_parts(10, 350, 3)
    spec = get_query(qnum)
    rels = tuple(r for r in spec.relations if r != "side_input")
    tables = dict(concat_relations([p for e in dup_parts for p in e], rels))
    local = LocalExecutor(spec, device="cpu")
    want = local.materialize(local.execute_window(tables))
    dist = DistributedExecutor(spec, N, device="cpu")
    got = materialize_columns(spec, dist.execute_window(
        shard_window(dup_parts, rels)))
    names = spec.schema.names
    assert rows(got, names) == rows(want, names), f"q{qnum}"
    # an overflow of the fan-out widens and reruns the window: its first
    # attempt escapes, the later ones lower on the fallback at once
    assert local.fallback_runs == (qnum != 3)
    assert (dist.fallback_runs > 0) == (qnum != 3)
    assert dist.host_syncs - dist.fallback_runs == 1


@pytest.mark.parametrize("qnum", [4, 6, 9, 13])
def test_one_shard_equals_eight(qnum, parts):
    spec = get_query(qnum)
    rels = tuple(r for r in spec.relations if r != "side_input")
    si = {"side_input": default_side_input()} \
        if "side_input" in spec.relations else {}
    got = {}
    for n in (1, N):
        dist = DistributedExecutor(spec, n, device="cpu")
        got[n] = rows(materialize_columns(spec, dist.execute_window(
            shard_window(parts, rels, si, n))), spec.schema.names)
    assert got[1] == got[N] and got[1]


def test_compact_equals_reference():
    """``kernels.compact`` against the reference's (live rows first, in
    order; cut or zero-padded to the output capacity; overflow)."""
    from flock_tpu.ops import kernels as ref_kernels
    from flock_tpu_torch.ops import kernels

    rng = np.random.default_rng(5)
    cols = {"a": rng.integers(0, 100, 300).astype(np.int32),
            "b": rng.standard_normal(300).astype(np.float32)}
    valid = rng.random(300) < 0.4
    for cap in (64, 128, 512):
        got = kernels.compact({k: torch.from_numpy(v) for k, v in
                               cols.items()}, torch.from_numpy(valid), cap)
        want = ref_kernels.compact({k: jnp.asarray(v) for k, v in
                                    cols.items()}, jnp.asarray(valid), cap)
        for k in cols:
            np.testing.assert_array_equal(got[0][k].numpy(),
                                          np.asarray(want[0][k]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert bool(got[2]) == bool(want[2])


def test_final_aggregate_takes_wide_int64_partials_exactly():
    """The two-phase final over int64 partials wider than int32 (sums by
    31-bit halves, max/min by high then low words) equals the plain
    scatter, with no escape."""
    from flock_tpu_torch.ops import kernels
    from flock_tpu_torch.parallel.executor import _final_aggregate

    rng = np.random.default_rng(9)
    n, cap = 4000, 600
    keys = torch.from_numpy(rng.integers(100, 600, n).astype(np.int32))
    big = torch.from_numpy(rng.integers(-2**62, 2**62, n))
    small = torch.from_numpy(rng.integers(-2**33, 2**33, n))
    valid = torch.from_numpy(rng.random(n) < 0.8)
    cols = {"k": keys, "s": small, "x": big, "y": big.clone(), "c": keys}
    aggs = [("s", "sum", "s"), ("x", "max", "x"), ("y", "min", "y"),
            ("c", "count_sum", "c")]
    got, gv, go, ge = _final_aggregate(cols, valid, ["k"], aggs, cap)
    want, wv, wo, _ = kernels.group_aggregate(cols, valid, ["k"], aggs, cap,
                                              rebase=False)
    assert not bool(ge) and not bool(go) and not bool(wo)
    assert torch.equal(gv, wv)
    for name in ("k", "s", "x", "y", "c"):
        assert torch.equal(got[name][gv], want[name][wv]), name


def test_final_aggregate_carries_wmin_on_the_k2_slots():
    """A fallback final's ``wmin:`` carry beside int64 max and sum
    partials: the carry scatters onto K2's slots and equals the plain
    scatter's, column for column."""
    from flock_tpu_torch.ops import kernels
    from flock_tpu_torch.parallel.executor import _final_aggregate

    rng = np.random.default_rng(11)
    n, cap = 3000, 400
    keys = torch.from_numpy(rng.integers(50, 420, n).astype(np.int32))
    # few distinct orders, so several rows attain a slot's max
    order = torch.from_numpy(rng.integers(0, 4, n) * 2**40)
    seller = torch.from_numpy(rng.integers(0, 1000, n).astype(np.int32))
    total = torch.from_numpy(rng.integers(-2**40, 2**40, n))
    valid = torch.from_numpy(rng.random(n) < 0.7)
    cols = {"a_id": keys, "__order": order, "seller": seller, "t": total}
    aggs = [("__order", "max", "__order"), ("seller", "wmin:__order", "seller"),
            ("t", "sum", "t")]
    got, gv, go, ge = _final_aggregate(cols, valid, ["a_id"], aggs, cap)
    want, wv, wo, _ = kernels.group_aggregate(cols, valid, ["a_id"], aggs,
                                              cap, rebase=False)
    assert not bool(ge) and not bool(go) and not bool(wo)
    assert torch.equal(gv, wv)
    for name in ("a_id", "__order", "seller", "t"):
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name][gv], want[name][wv]), name


@pytest.mark.parametrize("qnum", [4, 6, 9])
def test_fallback_lowering_scatters_only_the_fused_partial(qnum,
                                                           monkeypatch):
    """On a window whose build keys repeat, the fallback lowering's only
    plain scatter (``dense_agg_plain``, which a card tensor would meet too)
    is the fused node's partial on its unfused branch — the reference's
    ``allow_blocked=False`` aggregate; every two-phase final, int64
    partials and ``wmin:`` carries included, stays on K2's path."""
    import sys

    from flock_tpu_torch.ops import kernels

    callers = []
    plain = kernels.dense_agg_plain

    def recorded(*args, **kw):
        f = sys._getframe(1)
        while f.f_code.co_name in ("dense_group_aggregate", "group_aggregate"):
            f = f.f_back
        callers.append(f.f_code.co_name)
        return plain(*args, **kw)

    monkeypatch.setattr(kernels, "dense_agg_plain", recorded)
    dup_parts = generate_epoch_parts(10, 350, 3)
    spec = get_query(qnum)
    rels = tuple(r for r in spec.relations if r != "side_input")
    dist = DistributedExecutor(spec, N, device="cpu")
    dist.execute_window(shard_window(dup_parts, rels))
    assert dist.fallback_runs > 0
    assert set(callers) <= {"_lower_fused_dist"}, callers

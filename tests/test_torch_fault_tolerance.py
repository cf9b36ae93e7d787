"""Fragment recovery in the port against flock_tpu's: the arena
(out-of-order arrival, duplicates, ``PROCESSED``), ``to_fragments``, both
state backends (tests/test_runtime_aux.py:84-121), and lost-fragment
recovery — checkpoint, lose one fragment, pull it back from the backend —
into the port's ``LocalExecutor`` and its 8-shard ``DistributedExecutor``,
each against the reference's rows (tests/test_fault_tolerance.py)
(PyTorch port, CPU)."""

import numpy as np
import pytest
import torch

from flock_tpu.config import CONFIG as REF_CONFIG
from flock_tpu.parallel.executor import \
    DistributedExecutor as RefDistributedExecutor
from flock_tpu.queries.nexmark import get_query as ref_get_query
from flock_tpu.runtime import payload as ref_payload
from flock_tpu.runtime.arena import Arena as RefArena
from flock_tpu.runtime.executor import LocalExecutor as RefLocalExecutor
from flock_tpu.runtime.executor import \
    materialize_columns as ref_materialize_columns
from flock_tpu.runtime.state import MemoryStateBackend as RefMemoryBackend
from flock_tpu_torch.parallel.executor import DistributedExecutor
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime.arena import Arena, Bitmap, WindowStatus
from flock_tpu_torch.runtime.executor import (LocalExecutor,
                                              materialize_columns)
from flock_tpu_torch.runtime.payload import (SYNC_GRANULE, FragmentId,
                                             Payload, to_fragments)
from flock_tpu_torch.runtime.state import FileStateBackend, MemoryStateBackend
from flock_tpu_torch.runtime.stream import generate_epochs
from flock_tpu_torch.runtime.tables import concat_relations

torch.set_num_threads(1)


def _cols(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(0, 1000, n).astype(np.int32),
            "b": rng.integers(0, 1 << 40, n).astype(np.int64)}


def test_sync_granule_is_the_references():
    assert SYNC_GRANULE == REF_CONFIG.sync_granule


@pytest.mark.parametrize("n,granule", [(1000, 300), (0, 300), (900, 300),
                                       (100_000, None)])
def test_fragment_slicing_equals_reference(n, granule):
    kw = {} if granule is None else {"granule": granule}
    cols = _cols(n)
    frags = to_fragments(cols, "qid", shuffle_id=3, metadata={"m": 1}, **kw)
    ref = ref_payload.to_fragments(cols, "qid", shuffle_id=3,
                                   metadata={"m": 1}, **kw)
    g = granule or SYNC_GRANULE
    assert len(frags) == len(ref) == max(1, -(-n // g))
    for f, r in zip(frags, ref):
        assert (f.fragment.qid, f.fragment.seq_num, f.fragment.seq_len,
                f.fragment.shuffle_id) == (r.fragment.qid, r.fragment.seq_num,
                                           r.fragment.seq_len,
                                           r.fragment.shuffle_id)
        assert f.metadata == r.metadata == {"m": 1}
        for k in cols:
            assert np.array_equal(f.columns[k], r.columns[k])
    assert sum(len(f.columns["a"]) for f in frags) == n


def test_arena_out_of_order_and_dedup():
    cols = _cols(900, seed=1)
    frags = to_fragments(cols, "w1", granule=300)
    arena, ref = Arena(), RefArena()
    for i in (2, 0, 2):     # out of order, with a duplicate
        assert arena.collect(frags[i]) is WindowStatus.NOT_READY
        assert ref.collect(frags[i]).value == "not_ready"
    assert arena.missing(("w1", 0)) == ref.missing(("w1", 0)) == [1]
    assert arena.missing(("nope", 0)) == []
    assert arena.collect(frags[1]) is WindowStatus.READY
    merged = arena.take(("w1", 0))
    for k in cols:
        assert np.array_equal(merged[k], cols[k])
    # re-delivery after processing short-circuits
    assert arena.collect(frags[0]) is WindowStatus.PROCESSED
    b = Bitmap(3)
    assert b.set(1) and not b.set(1) and b.missing() == [0, 2]


@pytest.mark.parametrize("backend_fn", [
    lambda tmp: MemoryStateBackend(),
    lambda tmp: FileStateBackend(root=str(tmp)),
], ids=["memory", "file"])
def test_state_backend_checkpoint_recovery(backend_fn, tmp_path):
    be = backend_fn(tmp_path)
    frags = to_fragments(_cols(600, seed=2), "q5-run", granule=200)
    for f in frags:
        be.write(plan_idx=1, payload=f)
    assert be.list_seqs("q5-run", 1, 0) == [0, 1, 2]
    assert be.list_seqs("q5-run", 2, 0) == []
    got = be.read("q5-run", 1, 0, 2)
    assert np.array_equal(got.columns["a"], frags[2].columns["a"])
    assert got.fragment == frags[2].fragment
    assert be.read("q5-run", 1, 0, 99) is None


def test_memory_backend_holds_the_references_bytes():
    """The memory backend stores encoded payloads: the reference's bytes
    for the same fragment, which the reference decodes."""
    p = Payload(FragmentId("q", 1, 4, 2), _cols(50, seed=3), {"k": "v"})
    mine, ref = MemoryStateBackend(), RefMemoryBackend()
    mine.write(0, p)
    ref.write(0, ref_payload.Payload(
        ref_payload.FragmentId("q", 1, 4, 2), p.columns, {"k": "v"}))
    assert mine.store == ref.store
    back = ref_payload.decode(mine.store[("q", 0, 2, 1)])
    assert np.array_equal(back.columns["b"], p.columns["b"])


def _recovered_window(backend, qid: str, window: dict, lose: int,
                      granule: int = 500):
    """Checkpoint the window's fragments, deliver them less bid fragment
    ``lose`` (and fragment 0 twice), pull the missing one from the
    backend; returns the reassembled tables and the arena."""
    frags = {}
    for rel in ("auction", "bid"):
        frags[rel] = to_fragments(window[rel], f"{qid}-{rel}",
                                  granule=granule)
        for f in frags[rel]:
            backend.write(plan_idx=0, payload=f)      # checkpoint ∥ send
    arena = Arena()
    delivered = {"auction": frags["auction"],
                 "bid": [f for i, f in enumerate(frags["bid"]) if i != lose]
                 + [frags["bid"][0]]}
    status = {}
    for rel, fs in delivered.items():
        for f in fs:
            status[rel] = arena.collect(f)
    assert status["bid"] is WindowStatus.NOT_READY
    missing = arena.missing((f"{qid}-bid", 0))
    assert missing == [lose]
    for seq in missing:
        status["bid"] = arena.collect(backend.read(f"{qid}-bid", 0, 0, seq))
    assert status["bid"] is WindowStatus.READY
    tables = {rel: arena.take((f"{qid}-{rel}", 0))
              for rel in ("auction", "bid")}
    for rel in tables:
        for k, v in window[rel].items():
            assert np.array_equal(tables[rel][k], v)
    assert arena.collect(frags["bid"][0]) is WindowStatus.PROCESSED
    return tables


@pytest.fixture(scope="module")
def window():
    return concat_relations(generate_epochs(2, 1000), ("auction", "bid"))


def test_lost_fragment_recovery(tmp_path, window):
    tables = _recovered_window(FileStateBackend(root=str(tmp_path)),
                               "q4-test-run", window, lose=1)
    ex = LocalExecutor(get_query(4), device="cpu")
    got = ex.materialize(ex.execute_window(tables))
    ref = RefLocalExecutor(ref_get_query(4))
    want = ref.materialize(ref.execute_window(window))
    for k in get_query(4).schema.names:
        assert np.array_equal(got[k], want[k]), k
    assert len(got["category"])


def _shards(tables: dict, n: int) -> list:
    return [{rel: {k: np.asarray(v)[np.arange(len(v)) % n == i]
                   for k, v in cols.items()}
             for rel, cols in tables.items()} for i in range(n)]


def test_lost_fragment_recovery_distributed(tmp_path, window):
    """The recovered window row-sharded round robin over 8 shards: the
    port's DistributedExecutor gives the reference's rows, row for row
    in its order, and the single-card executor's as a set."""
    tables = _recovered_window(MemoryStateBackend(), "q4-dist-run", window,
                               lose=2)
    spec = get_query(4)
    dist = DistributedExecutor(spec, 8, device="cpu")
    got = materialize_columns(spec, dist.execute_window(_shards(tables, 8)))
    ref = RefDistributedExecutor(ref_get_query(4), 8)
    want = ref_materialize_columns(
        ref_get_query(4), ref.execute_window(_shards(window, 8)))
    ex = LocalExecutor(spec, device="cpu")
    local = ex.materialize(ex.execute_window(window))
    names = spec.schema.names
    for k in names:
        assert np.array_equal(got[k], want[k]), k
    order = lambda c: np.lexsort([c[k] for k in names[::-1]])  # noqa: E731
    for k in names:
        assert np.array_equal(got[k][order(got)], local[k][order(local)])
    assert dist.host_syncs == 1 and dist.fallback_runs == 0

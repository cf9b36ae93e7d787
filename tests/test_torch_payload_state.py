"""Checkpoint plumbing of the port on the CPU: ``runtime/payload.py``,
``runtime/state.py`` and ``utils/retry.py`` against flock_tpu's.  Every
codec round-trips; the port decodes the reference's ``encode`` bytes and
the reference decodes the port's, column dtypes and values exact; the
file state backend stores, lists and reads back like the reference's, and
each engine reads what the other wrote; and ``with_retry`` keeps the
reference's policy (PyTorch port, CPU)."""

import numpy as np
import pytest

from flock_tpu.runtime import payload as ref_payload
from flock_tpu.runtime import state as ref_state
from flock_tpu.utils import retry as ref_retry
from flock_tpu_torch.config import CONFIG
from flock_tpu_torch.runtime import payload, state
from flock_tpu_torch.utils import retry

CODECS = ("zstd", "zlib", "lz4", "snappy", "none")


def _cols(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    return {"bidder": rng.integers(1000, 1100, n).astype(np.int64),
            "b_date_time": np.sort(rng.integers(0, 10**12, n)),
            "price": rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            "flag": rng.random(n) < 0.5,
            "money": rng.random(n).astype(np.float32)}


def _frag(mod, seed=0, n=5000, seq=3):
    return mod.Payload(mod.FragmentId("q11", seq, 9, shuffle_id=2),
                       _cols(seed, n), metadata={"epoch": 7, "bidder": 1042})


def _same_payload(a, b):
    assert (a.fragment.qid, a.fragment.seq_num, a.fragment.seq_len,
            a.fragment.shuffle_id) == (b.fragment.qid, b.fragment.seq_num,
                                       b.fragment.seq_len,
                                       b.fragment.shuffle_id)
    assert a.metadata == b.metadata
    assert list(a.columns) == list(b.columns)
    for k, v in b.columns.items():
        assert a.columns[k].dtype == v.dtype, k
        np.testing.assert_array_equal(a.columns[k], v, err_msg=k)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("n", [0, 1, 5000])
def test_round_trip_every_codec(codec, n):
    p = _frag(payload, n=n)
    blob = payload.encode(p, codec=codec)
    _same_payload(payload.decode(blob), p)


@pytest.mark.parametrize("codec", CODECS)
def test_cross_engine_bytes(codec):
    """The header and body are the reference's: the same payload encodes to
    the same bytes, and each engine decodes the other's."""
    mine, ref = _frag(payload, seed=1), _frag(ref_payload, seed=1)
    b_mine = payload.encode(mine, codec=codec)
    b_ref = ref_payload.encode(ref, codec=codec)
    assert b_mine == b_ref
    _same_payload(payload.decode(b_ref), ref)
    _same_payload(ref_payload.decode(b_mine), mine)


def test_native_codecs_equal_reference():
    from flock_tpu import native as ref_native
    from flock_tpu_torch import native

    rng = np.random.default_rng(2)
    for data in (b"", b"a", bytes(rng.integers(0, 4, 70_000, np.uint8)),
                 rng.bytes(9_999), b"abcabcabc" * 5000):
        for comp, dec, rcomp in (
                (native.lz4_compress, native.lz4_decompress,
                 ref_native.lz4_compress),
                (native.snappy_compress, native.snappy_decompress,
                 ref_native.snappy_compress)):
            c = comp(data)
            assert c == rcomp(data)
            assert dec(c, len(data)) == data


def test_unknown_codec_and_default():
    with pytest.raises(ValueError, match="unknown codec"):
        payload.encode(_frag(payload), codec="brotli")
    assert payload.DEFAULT_CODEC == "zstd"
    assert payload._default_codec() == ref_payload._default_codec()


@pytest.mark.parametrize("codec", ["lz4", "none"])
def test_default_codec_is_the_module_constant(codec, monkeypatch):
    """``encode`` with no codec takes ``DEFAULT_CODEC`` and records it in
    the header, so the reference decodes the payload with no setting."""
    monkeypatch.setattr(payload, "DEFAULT_CODEC", codec)
    blob = payload.encode(_frag(payload))
    assert blob == payload.encode(_frag(payload), codec=codec)
    _same_payload(ref_payload.decode(blob), _frag(ref_payload))


def test_missing_zstandard_falls_back_to_zlib(monkeypatch):
    """Without the zstandard package the default codec is zlib (recorded
    in the header), and an explicit zstd raises, as in the reference."""
    import builtins

    real = builtins.__import__

    def no_zstd(name, *a, **kw):
        if name == "zstandard":
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_zstd)
    with pytest.warns(UserWarning, match="zlib"):
        blob = payload.encode(_frag(payload))
    _same_payload(ref_payload.decode(blob), _frag(ref_payload))
    with pytest.raises(ImportError):
        payload.encode(_frag(payload), codec="zstd")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_state_backends_equal_reference(writer, tmp_path):
    """Both engines' file backends store, list and read back alike, and
    the key layout is the reference's: each engine reads the other's."""
    mine = state.FileStateBackend(root=str(tmp_path / "port"))
    ref = ref_state.FileStateBackend(root=str(tmp_path / "ref"))
    for seq in (4, 0, 11):
        mine.write(2, _frag(payload, seed=seq, n=100, seq=seq))
        ref.write(2, _frag(ref_payload, seed=seq, n=100, seq=seq))
    assert mine.list_seqs("q11", 2, 2) == ref.list_seqs("q11", 2, 2) \
        == [0, 4, 11]
    assert mine.list_seqs("q11", 2, 0) == [] and mine.list_seqs("x", 0, 0) == []
    assert mine.read("q11", 2, 2, 5) is None
    for seq in (0, 4, 11):
        _same_payload(mine.read("q11", 2, 2, seq), ref.read("q11", 2, 2, seq))
    if writer == "port":
        reader, mod = ref_state.FileStateBackend(root=mine.root), ref_payload
    else:
        reader, mod = state.FileStateBackend(root=ref.root), payload
    assert reader.list_seqs("q11", 2, 2) == [0, 4, 11]
    for seq in (0, 4, 11):
        _same_payload(reader.read("q11", 2, 2, seq),
                      _frag(mod, seed=seq, n=100, seq=seq))
    assert not list(tmp_path.rglob("*.tmp"))


def test_file_backend_default_root_is_the_ports_own():
    assert state.FileStateBackend().root == CONFIG.state_dir
    assert CONFIG.state_dir != ref_state.FileStateBackend().root
    assert CONFIG.state_dir.endswith("flock_tpu_torch/state")


def test_file_backend_retries_transient_faults(tmp_path, monkeypatch):
    """A write that fails twice with OSError publishes on the third try."""
    import os

    real = os.replace
    fails = {"n": 2}

    def flaky(a, b):
        if fails["n"]:
            fails["n"] -= 1
            raise OSError("transient")
        return real(a, b)

    monkeypatch.setattr(retry.random, "randint", lambda a, b: 0)
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    monkeypatch.setattr(os, "replace", flaky)
    be = state.FileStateBackend(root=str(tmp_path))
    be.write(0, _frag(payload, n=10, seq=0))
    assert fails["n"] == 0 and be.list_seqs("q11", 0, 2) == [0]


@pytest.mark.parametrize("mod", [retry, ref_retry], ids=["port", "ref"])
def test_with_retry_policy(mod, monkeypatch):
    """The reference's linear-random backoff: sleep(2·attempt + jitter) ms
    between attempts, only the retryable exceptions retried, and the
    budget's exhaustion raised with the last fault chained."""
    monkeypatch.setattr(mod.random, "randint", lambda a, b: b)
    sleeps, calls = [], []

    def fn():
        calls.append(1)
        if len(calls) < 4:
            raise KeyError("again")
        return "done"

    assert mod.with_retry(fn, max_retries=5, base_ms=2, max_jitter_ms=10,
                          retryable=(KeyError,), sleep=sleeps.append) == "done"
    assert sleeps == [0.010, 0.012, 0.014]
    with pytest.raises(ValueError):
        mod.with_retry(lambda: (_ for _ in ()).throw(ValueError("x")),
                       retryable=(KeyError,), sleep=sleeps.append)

    def never():
        raise KeyError("never")

    with pytest.raises(mod.RetryBudgetExceeded) as e:
        mod.with_retry(never, max_retries=3, retryable=(KeyError,),
                       sleep=lambda s: None)
    assert isinstance(e.value.__cause__, KeyError)
    assert "3 retries" in str(e.value)

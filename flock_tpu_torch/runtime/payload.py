"""Payload wire format: serialized, compressed columnar fragments — copy of
``flock_tpu/runtime/payload.py`` (``FragmentId``, ``Payload``, ``encode``,
``decode``, ``to_fragments`` and the five codecs).  The bytes are the
reference's, so either engine decodes the other's payloads.

Reference counterpart: flock/src/runtime/payload.rs — Arrow-Flight frames,
per-batch compressed (zstd/lz4/snappy, flock/src/encoding.rs:27-112),
addressed by ``Uuid{qid, seq_num, seq_len}`` so an arena can reassemble a
window from N fragments.

Live data stays on the device, so this format serves the *persistence*
paths: window-state checkpoints, the state backend (S3 analogue), and
host-to-host spill.

Codecs (the full Encoding enum): ``zstd`` (the reference's default, level
3, via the image's zstandard package), ``zlib`` (stdlib), ``lz4`` and
``snappy`` (both from-scratch native block codecs, native/codec.cpp and
native/snappy.cpp — snappy implements the public block-format spec), and
``none``.  The codec rides in the fragment header so any decoder handles
any producer's payloads.  The default codec is the module constant
``DEFAULT_CODEC`` (the reference reads it from its config; the header
carries the codec, so a decoder needs no setting, and ``encode(codec=...)``
names any other).
"""

from __future__ import annotations

import io
import json
import zlib
from dataclasses import dataclass, field

import numpy as np

CODECS = ("zstd", "zlib", "lz4", "snappy", "none")
# persistence codec (encoding.rs Encoding analogue), the reference's default
DEFAULT_CODEC = "zstd"
# rows per fragment of ``to_fragments`` (the reference's
# ``CONFIG.sync_granule``, the payload granule of flock.toml:59-61)
SYNC_GRANULE = 74_304


def _default_codec() -> str:
    if DEFAULT_CODEC == "zstd":
        # environments without the zstandard package fall back to stdlib
        # zlib (recorded in the fragment header, so decode stays correct);
        # an EXPLICIT codec="zstd" still raises, like the native codecs
        # when the toolchain is absent
        try:
            import zstandard  # noqa: F401
        except ImportError:
            import warnings

            warnings.warn("zstandard unavailable; default payload codec "
                          "falling back to zlib", stacklevel=2)
            return "zlib"
    return DEFAULT_CODEC


@dataclass(frozen=True)
class FragmentId:
    """Reference Uuid (payload.rs:34-100): query id + fragment seq."""

    qid: str
    seq_num: int
    seq_len: int
    shuffle_id: int = 0


@dataclass
class Payload:
    """One columnar fragment + addressing + free-form metadata."""

    fragment: FragmentId
    columns: dict[str, np.ndarray]
    metadata: dict = field(default_factory=dict)


def _compress(raw: bytes, codec: str, level: int) -> bytes:
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdCompressor(level=level).compress(raw)
    if codec == "zlib":
        return zlib.compress(raw, level)
    if codec == "lz4":
        from flock_tpu_torch.native import lz4_compress

        return lz4_compress(raw)
    if codec == "snappy":
        from flock_tpu_torch.native import snappy_compress

        return snappy_compress(raw)
    if codec == "none":
        return raw
    raise ValueError(f"unknown codec {codec!r} (expected one of {CODECS})")


def _decompress(body: bytes, codec: str, nbytes: int) -> bytes:
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            body, max_output_size=max(nbytes, 1))
    if codec == "zlib":
        return zlib.decompress(body)
    if codec == "lz4":
        from flock_tpu_torch.native import lz4_decompress

        return lz4_decompress(body, nbytes)
    if codec == "snappy":
        from flock_tpu_torch.native import snappy_decompress

        return snappy_decompress(body, nbytes)
    if codec == "none":
        return body
    raise ValueError(f"unknown codec {codec!r} (expected one of {CODECS})")


def encode(payload: Payload, level: int = 3, codec: str | None = None) -> bytes:
    """Serialize + compress one payload.  ``codec`` defaults to
    ``DEFAULT_CODEC``; the choice is recorded in the header."""
    codec = codec or _default_codec()
    buf = io.BytesIO()
    np.savez(buf, **payload.columns)
    raw = buf.getvalue()
    header = json.dumps({
        "qid": payload.fragment.qid,
        "seq_num": payload.fragment.seq_num,
        "seq_len": payload.fragment.seq_len,
        "shuffle_id": payload.fragment.shuffle_id,
        "metadata": payload.metadata,
        "nbytes": len(raw),
        "codec": codec,
    }).encode()
    body = _compress(raw, codec, level)
    return len(header).to_bytes(4, "little") + header + body


def decode(data: bytes) -> Payload:
    hlen = int.from_bytes(data[:4], "little")
    header = json.loads(data[4:4 + hlen])
    raw = _decompress(data[4 + hlen:], header.get("codec", "zlib"),
                      header["nbytes"])
    with np.load(io.BytesIO(raw)) as z:
        cols = {k: z[k] for k in z.files}
    return Payload(
        fragment=FragmentId(header["qid"], header["seq_num"],
                            header["seq_len"], header["shuffle_id"]),
        columns=cols,
        metadata=header["metadata"],
    )


def to_fragments(cols: dict[str, np.ndarray], qid: str,
                 granule: int = SYNC_GRANULE,
                 shuffle_id: int = 0, metadata: dict | None = None
                 ) -> list[Payload]:
    """Slice a window's columns into granule-sized fragments (the payload
    granularity analogue, flock.toml:59-61)."""
    n = len(next(iter(cols.values()))) if cols else 0
    seq_len = max(1, -(-n // granule))
    out = []
    for i in range(seq_len):
        sl = slice(i * granule, min((i + 1) * granule, n))
        out.append(Payload(
            fragment=FragmentId(qid, i, seq_len, shuffle_id),
            columns={k: v[sl] for k, v in cols.items()},
            metadata=dict(metadata or {}),
        ))
    return out

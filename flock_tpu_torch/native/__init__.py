"""Build and load the host-side native libraries (C++ → .so via g++, ctypes).

Cut-down copy of ``flock_tpu/native/__init__.py`` for the port: the NEXMark
and YSB generators (``flockgen.cpp``), the window staging pass
(``stage.cpp``), the per-epoch session key statistics (``session.cpp``),
the LZ4 and Snappy payload codecs (``codec.cpp``, ``snappy.cpp``) and the
ingest path's line-JSON parser (``jsonl.cpp``), all copies of the reference
package's sources.  Libraries compile on first use into
``flock_tpu_torch/build/``; a stale library (older than its source)
rebuilds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "build")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _load(src_name: str, lib_name: str) -> ctypes.CDLL:
    with _lock:
        if lib_name in _libs:
            return _libs[lib_name]
        src = os.path.join(_HERE, src_name)
        path = os.path.join(_BUILD, lib_name)
        if not os.path.exists(path) \
                or os.path.getmtime(path) < os.path.getmtime(src):
            os.makedirs(_BUILD, exist_ok=True)
            # build beside, then rename: concurrent test workers never load
            # a half-written library
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     "-pthread", "-o", tmp, src, "-lm"],
                    check=True, capture_output=True)
                os.replace(tmp, path)
            except (OSError, subprocess.CalledProcessError) as e:
                raise RuntimeError(f"could not build {lib_name}: {e}") from e
        _libs[lib_name] = ctypes.CDLL(path)
        return _libs[lib_name]


def get_lib() -> ctypes.CDLL:
    """Compile (if stale/missing) and load libflockgen.so."""
    lib = _load("flockgen.cpp", "libflockgen.so")
    if not getattr(lib, "_flock_argtypes", False):
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fg_nexmark_generate.argtypes = (
            [vp, i64, i64]
            + [vp] * 6 + [i64, i64p]       # persons
            + [vp] * 8 + [i64, i64p]       # auctions
            + [vp] * 5 + [i64, i64p])      # bids
        lib.fg_nexmark_generate.restype = ctypes.c_int
        lib.fg_ysb_generate.argtypes = [i64] * 6 + [vp] * 5 + [i64, i64p]
        lib.fg_ysb_generate.restype = ctypes.c_int
        lib._flock_argtypes = True
    return lib


def _stage_lib() -> ctypes.CDLL:
    lib = _load("stage.cpp", "libflockstage.so")
    if not getattr(lib, "_flock_argtypes", False):
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.flock_min_i64.argtypes = [vp, i64]
        lib.flock_min_i64.restype = i64
        lib.flock_stage_sub_i64_i32.argtypes = [vp, vp, i64, i64, i64]
        lib.flock_stage_sub_i64_i32.restype = None
        lib.flock_stage_copy.argtypes = [vp, vp, i64, i64]
        lib.flock_stage_copy.restype = None
        lib._flock_argtypes = True
    return lib


def stage_column(arr: np.ndarray, capacity: int, rebase_base: int | None,
                 out: np.ndarray | None = None) -> np.ndarray:
    """One staged transfer buffer for a host column: int64 sources narrow to
    int32 (minus ``rebase_base`` when given — the timestamp rebase) and every
    dtype zero-pads to ``capacity`` rows, all in one native pass.  ``out``
    (e.g. a view of a pinned host tensor) receives the result when given."""
    lib = _stage_lib()
    arr = np.ascontiguousarray(arr)
    n = len(arr)
    dtype = np.int32 if arr.dtype == np.int64 else arr.dtype
    dst = np.empty(capacity, dtype) if out is None else out
    if dst.shape != (capacity,) or dst.dtype != dtype \
            or not dst.flags.c_contiguous:
        raise ValueError(f"staging buffer must be contiguous {dtype}[{capacity}]")
    if arr.dtype == np.int64:
        lib.flock_stage_sub_i64_i32(arr.ctypes.data, dst.ctypes.data,
                                    n, capacity, rebase_base or 0)
    else:
        lib.flock_stage_copy(arr.ctypes.data, dst.ctypes.data,
                             n * arr.itemsize, capacity * arr.itemsize)
    return dst


def min_i64(arr: np.ndarray) -> int:
    arr = np.ascontiguousarray(arr, np.int64)
    return int(_stage_lib().flock_min_i64(arr.ctypes.data, len(arr)))


def _codec_lib(src_name: str, lib_name: str, prefix: str) -> ctypes.CDLL:
    lib = _load(src_name, lib_name)
    if not getattr(lib, "_flock_argtypes", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        getattr(lib, f"{prefix}_max_compressed").restype = ctypes.c_int64
        getattr(lib, f"{prefix}_max_compressed").argtypes = [ctypes.c_int64]
        for fn in ("compress", "decompress"):
            f = getattr(lib, f"{prefix}_{fn}")
            f.restype = ctypes.c_int64
            f.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
        lib._flock_argtypes = True
    return lib


def _compress(lib, prefix: str, data: bytes) -> bytes:
    cap = getattr(lib, f"{prefix}_max_compressed")(len(data))
    dst = ctypes.create_string_buffer(cap)
    src = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(data or b"\0")
    n = getattr(lib, f"{prefix}_compress")(
        ctypes.cast(src, ctypes.POINTER(ctypes.c_uint8)), len(data),
        ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError(f"{prefix} compression failed")
    return dst.raw[:n]


def _decompress(lib, prefix: str, data: bytes, out_size: int) -> bytes:
    dst = ctypes.create_string_buffer(max(out_size, 1))
    src = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(data or b"\0")
    n = getattr(lib, f"{prefix}_decompress")(
        ctypes.cast(src, ctypes.POINTER(ctypes.c_uint8)), len(data),
        ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)), out_size)
    if n != out_size:
        raise ValueError(f"{prefix} decompression failed ({n} != {out_size})")
    return dst.raw[:n]


def lz4_compress(data: bytes) -> bytes:
    """LZ4 block format (``codec.cpp``)."""
    return _compress(_codec_lib("codec.cpp", "libflockcodec.so", "flock_lz4"),
                     "flock_lz4", data)


def lz4_decompress(data: bytes, out_size: int) -> bytes:
    return _decompress(_codec_lib("codec.cpp", "libflockcodec.so",
                                  "flock_lz4"), "flock_lz4", data, out_size)


def snappy_compress(data: bytes) -> bytes:
    """Snappy block format (``snappy.cpp``)."""
    return _compress(_codec_lib("snappy.cpp", "libflocksnappy.so",
                                "flock_snappy"), "flock_snappy", data)


def snappy_decompress(data: bytes, out_size: int) -> bytes:
    return _decompress(_codec_lib("snappy.cpp", "libflocksnappy.so",
                                  "flock_snappy"), "flock_snappy", data,
                       out_size)


def _jsonl_lib() -> ctypes.CDLL:
    lib = _load("jsonl.cpp", "libflockjsonl.so")
    if not getattr(lib, "_flock_argtypes", False):
        lib.flock_jsonl_parse_ints.restype = ctypes.c_int64
        lib.flock_jsonl_parse_ints.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib._flock_argtypes = True
    return lib


def jsonl_parse_int_columns(data: bytes, keys: list[str], max_rows: int):
    """Parse newline-delimited JSON objects into int64 columns for ``keys``
    (C-speed decode of the ingestion hot loop — transmute.rs:255-266
    analogue).  Returns {key: np.int64 array} or None when the rows are not
    flat integer objects (the caller takes the Python parser)."""
    out = np.empty((len(keys), max_rows), np.int64)
    n = _jsonl_lib().flock_jsonl_parse_ints(
        data, len(data), "\n".join(keys).encode(), len(keys),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_rows)
    if n < 0:
        return None
    return {k: out[i, :n].copy() for i, k in enumerate(keys)}


def _session_lib() -> ctypes.CDLL:
    lib = _load("session.cpp", "libflocksession.so")
    if not getattr(lib, "_flock_argtypes", False):
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.flock_session_stats.argtypes = [
            i64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p]
        lib.flock_session_stats.restype = ctypes.c_int64
        lib._flock_argtypes = True
    return lib


def session_stats(keys, times, kmin: int, span: int):
    """(first_sec, last_sec) dense int64[span] tables for one epoch's rows
    (-1 where the key is absent), or None when a key lies outside
    ``[kmin, kmin + span)`` (the caller then takes its numpy path)."""
    lib = _session_lib()
    keys = np.ascontiguousarray(keys, np.int64)
    times = np.ascontiguousarray(times, np.int64)
    first = np.full(span, -1, np.int64)
    last = np.full(span, -1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.flock_session_stats(
        keys.ctypes.data_as(i64p), times.ctypes.data_as(i64p),
        len(keys), kmin, span,
        first.ctypes.data_as(i64p), last.ctypes.data_as(i64p))
    if rc != 0:
        return None
    return first, last

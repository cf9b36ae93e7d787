"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source has a plain C entry point that launches its kernel on the given
stream and returns the launch's ``cudaError_t``.  K1 and K2 launch
cooperatively (``cudaLaunchCooperativeKernel``, a grid-wide sync from
``cooperative_groups``), which needs no flag beyond the usual ones (no
``-rdc``).  Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``flock_tpu_torch/build/`` on first use — a few seconds per file, since no
PyTorch header is included — and loaded with ctypes.  A library older than
its source or than a shared header (``csrc/*.cuh``) rebuilds.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.  (The reference has no counterpart: its Pallas
kernels compile inside ``jax.jit``.)
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _paths(name: str) -> tuple[str, str]:
    return os.path.join(CSRC, f"{name}.cu"), os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header (``csrc/*.cuh``)."""
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src, *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return os.path.getmtime(lib) < max(map(os.path.getmtime, deps))


def _start(name: str) -> tuple[subprocess.Popen, str]:
    src, lib = _paths(name)
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _paths(name)[1])
    return log


def build_all(names: list[str]) -> dict[str, str]:
    """Compile every stale source at once (one ``nvcc`` per file, started
    together).  Returns ``{name: compiler log}`` (``-Xptxas -v`` prints each
    kernel's registers and shared memory)."""
    with _lock:
        started = {n: _start(n) for n in names if _stale(n)}
        return {n: _finish(n, *pt) for n, pt in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/{name}.cu``, built first if stale."""
    with _lock:
        if name not in _libs:
            if _stale(name):
                _finish(name, *_start(name))
            _libs[name] = ctypes.CDLL(_paths(name)[1])
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch (every
    source exports ``flock_error_string`` for the message)."""
    if rc != 0:
        lib.flock_error_string.restype = ctypes.c_char_p
        lib.flock_error_string.argtypes = [ctypes.c_int]
        msg = lib.flock_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def on_device(dev):
    """The context a launch on ``dev`` runs in: the entry points launch on
    the current device, so a tensor on another card (a mesh's shard i on
    ``cuda:i``) makes ``dev`` current for the call; on the current card it
    is a no-op."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)

"""K3's wrapper and kernel designs side by side on one CUDA card, in one
process, so that host costs are compared on the same host at the same time.

    python3 flock_tpu_torch/tools/gather_ab.py [NAME=TREE ...]

Each TREE is another checkout of this repository (a ``git archive`` of
another commit, say).  Its ``flock_tpu_torch.ops.gather`` is loaded beside
this checkout's, and each builds its kernel into its own tree.  This
checkout's wrapper runs with its own output allocator (one block per dtype)
and with each alternative of ``ALLOCATORS``.

The shapes are those of one bench window:
  * q9: 3.68 M bids on the auction frontier, 248,192 slots, one column;
  * q13: the same bids, 18,304 slots of which 10,000 present;
  * q3: 960 k sellers over 328,192 slots (half present), three columns
    gathered and the seven auction columns carried to 1,440,000 rows.
A ``gather`` that takes no ``carry`` (an older tree) runs q3 as the gather
alone.

Every variant is first held against this checkout's ``gather_plain``
(exact).  Then, in ``ROUNDS`` interleaved rounds, each variant is timed at
each shape:
  * ``ms``: the whole call, the median of CUDA-event timings;
  * ``kernel_ms``: the CUDA kernel alone, the profiler's mean;
  * ``host_us``: the host's own time per call, a host clock around ``CALLS``
    back-to-back calls with no synchronisation (Python, the allocations and
    the launch; the device queue absorbs the kernels).
It prints the card's name and power limit, then one JSON line per round,
shape and variant.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROUNDS, CALLS, SEED = 4, 200, 1234
HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def per_output(slot_cols, carry, rows, dev):
    """One ``torch.empty`` per output."""
    out = {k: torch.empty(rows, dtype=v.dtype, device=dev)
           for cols in (slot_cols, carry) for k, v in cols.items()}
    return out, torch.empty(rows, dtype=torch.bool, device=dev)


def carved(slot_cols, carry, rows, dev):
    """One byte buffer carved into typed views, each 16-byte aligned, the
    hit flag last."""
    cols = [*slot_cols.items(), *carry.items()]
    pitch = [(rows * v.element_size() + 15) & ~15 for _, v in cols]
    buf = torch.empty(sum(pitch) + rows, dtype=torch.uint8, device=dev)
    out, at = {}, 0
    for (k, v), p in zip(cols, pitch):
        out[k] = buf[at:at + rows * v.element_size()].view(v.dtype)
        at += p
    return out, buf[at:].view(torch.bool)


ALLOCATORS = {"per_output": per_output, "carved": carved}


def load_gather(tree: str):
    """``flock_tpu_torch.ops.gather`` of the checkout at ``tree``, imported
    apart from any other: its functions keep their own module globals (its
    build directory among them) after the package leaves ``sys.modules``."""
    def ours():
        return [k for k in sys.modules
                if k == "flock_tpu_torch" or k.startswith("flock_tpu_torch.")]

    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, os.path.abspath(tree))
    try:
        return importlib.import_module("flock_tpu_torch.ops.gather")
    finally:
        sys.path.pop(0)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)


def shapes(dev) -> dict:
    """name -> (slot_cols, present, m, keys, valid, out_rows, carry)."""
    rng = np.random.default_rng(SEED)
    m0 = 1_000

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def m(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    # bids: half to the hot auction of their 100-id group, the rest just
    # behind the auction frontier, 1 % to the previous window
    na, n = 240_000, 3_680_000
    f = np.arange(n, dtype=np.int64) * na // n
    rel = np.where(rng.random(n) < 0.5, f // 100 * 100,
                   f - rng.integers(0, 100, n) + rng.integers(0, 10, n))
    rel = np.where(rng.random(n) < 0.01, -rng.integers(1, 5000, n), rel)
    keys = t((m0 + rel).astype(np.int32))
    valid = t(np.arange(n) < n - 1_000)
    span9 = na + 8_192
    q9 = ({"final": t(rng.integers(100, 10**8, span9).astype(np.int32))},
          t((rng.random(span9) < 0.9) & (np.arange(span9) < na)), m(m0),
          keys, valid, None, None)
    span13 = 10_000 + 8_304
    q13 = ({"value": t((m0 + np.arange(span13)).astype(np.int32))},
           t(np.arange(span13) < 10_000), m(m0), keys, valid, None, None)
    np_, na3 = 320_000, 960_000
    span3 = np_ + 8_192
    sellers = t((m0 + rng.integers(-2_000, span3 + 2_000, na3))
                .astype(np.int32))
    a_ts = np.sort(rng.integers(0, 1000, na3)).astype(np.int32)
    carry = {"a_id": t((m0 + np.arange(na3)).astype(np.int32)),
             "initial_bid": t(rng.integers(1, 10**6, na3).astype(np.int32)),
             "reserve": t(rng.integers(1, 10**7, na3).astype(np.int32)),
             "a_date_time": t(a_ts),
             "expires": t(a_ts + rng.integers(1, 20_000, na3)
                          .astype(np.int32)),
             "seller": sellers,
             "category": t(np.where(rng.random(na3) < 0.2, 10, 11)
                           .astype(np.int32))}
    q3 = ({"name": t(rng.integers(0, 100, span3).astype(np.int32)),
           "city": t(rng.integers(0, 10, span3).astype(np.int32)),
           "state": t(rng.integers(0, 6, span3).astype(np.int32))},
          t(rng.random(span3) < 0.5), m(m0), sellers,
          t(rng.random(na3) < 0.2), na3 * 3 // 2, carry)
    return {"q9": q9, "q13": q13, "q3": q3}


def variants(trees: dict[str, str]) -> dict:
    """name -> (gather module, allocator or None)."""
    this = load_gather(HERE)
    out = {"this": (this, this._empty_outputs)}
    out.update({f"this:{a}": (this, fn) for a, fn in ALLOCATORS.items()})
    for name, tree in trees.items():
        out[name] = (load_gather(tree), None)
    return out


def call(mod, alloc, args):
    """One call of ``mod.gather`` with ``alloc`` as its output allocator."""
    slots, present, m, keys, valid, out_rows, carry = args
    if alloc is not None:
        mod._empty_outputs = alloc
    if "carry" in mod.gather.__code__.co_varnames:
        return mod.gather(slots, present, m, keys, valid, out_rows, carry)
    return mod.gather(slots, present, m, keys, valid)


def check(mod, alloc, args, plain) -> None:
    """Exact against the plain version; a tree without ``carry`` on the
    gathered columns and hit of its first n rows."""
    out, hit = call(mod, alloc, args)
    want, whit = plain(*args)
    n = hit.shape[0]
    if not torch.equal(hit, whit[:n]):
        raise AssertionError("hit differs")
    for k, v in out.items():
        if not torch.equal(v, want[k][:n]):
            raise AssertionError(f"{k} differs")


def cuda_ms(fn, reps: int = 15) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, reps: int = 10) -> float:
    """Mean device time of the gather kernel per call (profiler); a session
    that recorded none is run again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and "gather" in e.key)
        if us:
            return us / reps / 1e3
    raise RuntimeError("the profiler saw no gather kernel")


def host_us(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / CALLS * 1e6


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("gather_ab: CUDA is not available", file=sys.stderr)
        return 1
    trees = dict(a.split("=", 1) for a in argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cases = shapes(dev)
    runs = variants(trees)
    plain = runs["this"][0].gather_plain
    for mod, alloc in runs.values():
        for args in cases.values():
            check(mod, alloc, args, plain)
    for r in range(ROUNDS):
        order = list(runs) if r % 2 == 0 else list(runs)[::-1]
        for shape, args in cases.items():
            for name in order:
                mod, alloc = runs[name]

                def fn():
                    call(mod, alloc, args)

                rec = {"round": r, "shape": shape, "variant": name,
                       "ms": cuda_ms(fn), "kernel_ms": kernel_ms(fn),
                       "host_us": host_us(fn)}
                print("gather_ab: " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

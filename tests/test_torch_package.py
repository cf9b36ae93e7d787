"""The port stands apart: it imports nothing of JAX or flock_tpu, and it
never carries on on the CPU unless asked (PyTorch port)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flock_tpu_torch
from flock_tpu_torch.ops import dense_agg, gather, join_agg
from flock_tpu_torch.plan import Conj
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime.executor import LocalExecutor
from flock_tpu_torch.runtime.stream import StreamDriver, run_nexmark

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import flock_tpu_torch
for m in pkgutil.walk_packages(flock_tpu_torch.__path__, "flock_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flock_tpu"))
print(len([m for m in sys.modules if m.startswith("flock_tpu_torch")]))
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_flock_tpu():
    r = subprocess.run([sys.executable, "-c", _PROBE.format(root=ROOT)],
                       capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 16   # every submodule was imported


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    assert flock_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            flock_tpu_torch.resolve_device(dev)
    with pytest.raises(ValueError):
        flock_tpu_torch.resolve_device("meta")


@pytest.mark.parametrize("entry", ["executor", "driver", "batch", "run",
                                   "cli", "sql"])
def test_no_silent_cpu_fallback(no_cuda, entry):
    """Without CUDA, every entry point called with no device raises."""
    from flock_tpu_torch import cli
    from flock_tpu_torch.batch import Batch
    from flock_tpu_torch.sql.catalog import nexmark_catalog
    from flock_tpu_torch.sql.lower import sql_to_spec

    spec = get_query(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "executor":
            LocalExecutor(spec)
        elif entry == "driver":
            StreamDriver(spec, 2)
        elif entry == "batch":
            Batch.from_numpy({"x": np.arange(3, dtype=np.int32)})
        elif entry == "run":
            run_nexmark(4, seconds=1, events_per_second=100)
        elif entry == "cli":
            cli.main(["fsql", "SELECT * FROM bid;", "-s", "1", "-e", "100"])
        else:
            StreamDriver(sql_to_spec("SELECT * FROM bid;", nexmark_catalog()),
                         2)


def test_fused_kernel_refuses_an_opaque_predicate():
    """K1 reads Conj terms; any other predicate raises on the kernel path
    instead of falling back to the plain version."""
    n, span = 8, 4
    args = ({"a": torch.zeros(span, dtype=torch.int32)},
            torch.ones(span, dtype=torch.bool), torch.tensor(0, dtype=torch.int32),
            {"k": torch.zeros(n, dtype=torch.int32)},
            torch.ones(n, dtype=torch.bool), "k")
    with pytest.raises(NotImplementedError, match="conjunctions"):
        join_agg._launch(*args, lambda c: c["k"] >= 0, [(None, "count", "c")])
    # the plain version evaluates any callable
    out, valid = join_agg.join_agg_plain(*args, lambda c: c["k"] >= c["a"],
                                         [(None, "count", "c")])
    assert out["c"].tolist() == [n, 0, 0, 0]


def test_conj_predicate():
    c = {"x": torch.tensor([1, 2, 3]), "y": torch.tensor([2, 2, 2])}
    p = Conj((("x", "<=", "y"), ("x", "!=", "y")))
    assert p(c).tolist() == [True, False, False]
    for bad in ((), (("x", "~", "y"),)):
        with pytest.raises(ValueError):
            Conj(bad)


@pytest.mark.parametrize("bad", ["dtype", "shape", "fn"])
def test_dense_agg_checks_its_inputs(bad):
    keys = torch.arange(8, dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    cols = {"v": torch.ones(8, dtype=torch.int32)}
    aggs = [("v", "sum", "s")]
    if bad == "dtype":
        keys = keys.to(torch.int64)
    elif bad == "shape":
        valid = valid[:4]
    else:
        aggs = [("v", "wmin:v", "s")]
    with pytest.raises((TypeError, NotImplementedError)):
        dense_agg.dense_agg(keys, valid, cols, aggs, 16)


def test_kernel_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card reaches no plain version."""
    meta = {"dtype": torch.int32, "device": "meta"}
    with pytest.raises(TypeError, match="unsupported device"):
        gather.gather({"v": torch.empty(4, **meta)},
                      torch.empty(4, dtype=torch.bool, device="meta"),
                      torch.empty((), **meta), torch.empty(8, **meta),
                      torch.empty(8, dtype=torch.bool, device="meta"))

"""A run loads no module whose top-level name is JAX's or the JAX
package's, compared whole: ``flock_tpu_torch`` starts with ``flock_tpu``
and is not it."""

import os
import subprocess
import sys

from flockbench.run import FORBIDDEN, ROOT, forbidden_modules

_RUN = r"""
import copy, dataclasses, json, sys
from flockbench.run import forbidden_modules, load_cell, run_cell
cell = load_cell("ysb-campaigns")
cfg = copy.deepcopy(cell.config)
cfg["generator"]["events_per_second"] = 5000
line, _, _ = run_cell(dataclasses.replace(cell, config=cfg), 7, 0.2, True,
                      device="cpu")
print(json.dumps({"correct": line["correct"],
                  "tops": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": forbidden_modules()}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    import json

    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _RUN], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.strip().splitlines()[-1]
    got = json.loads(out)
    assert got["correct"] is True
    assert got["forbidden"] == []
    assert "flock_tpu_torch" in got["tops"]
    assert not set(got["tops"]) & set(FORBIDDEN)


def test_names_are_compared_whole():
    assert forbidden_modules(["flock_tpu_torch", "flock_tpu_torch.batch",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["flock_tpu.batch", "jax.numpy", "jaxlib",
                              "flax.linen"]) == ["flax", "flock_tpu", "jax",
                                                 "jaxlib"]

"""Multi-process execution: N processes × local shards, one global mesh —
the counterpart of ``flock_tpu/parallel/multihost.py``.

Reference counterpart: the reference scales by deploying more Lambda
instances and splitting the generator into per-partition threads; here a
``torch.distributed`` process group holds one mesh of ``world ×
local_shards`` shards, and each process generates and feeds ONLY the
partitions that map to its own shards.

Usage (the same command in every process; a coordinator address, the
process count and each process's id, or torch's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` where the reference reads
``JAX_COORDINATOR_ADDRESS`` and the like):

    python -m flock_tpu_torch.cli nexmark run -q 4 --distributed \\
        --multihost --coordinator HOST:PORT --num-processes 2 --process-id 0
    # or from code:
    init_distributed("HOST:PORT", 2, 0)
    ex = MultiHostExecutor(spec, mesh=make_multihost_mesh(local_shards=4))
    host = ex.execute_window(local_shard_tables)   # this process's shards

The exchanges are gloo collectives for CPU tensors and NCCL collectives for
CUDA tensors (one process per card: NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from flock_tpu_torch.batch import Batch
from flock_tpu_torch.parallel.executor import (DistributedExecutor,
                                               merged_host)
from flock_tpu_torch.parallel.mesh import Mesh, make_multihost_mesh
from flock_tpu_torch.parallel.shuffle import all_gather


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout_s: float | None = None) -> tuple[int, int]:
    """``dist.init_process_group`` for this process; returns
    (process_index, process_count).  ``coordinator`` ("host:port") with
    ``num_processes`` and ``process_id`` names the group; without them
    torch's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` do, and
    without those the group is this process alone (on a free local port).
    ``backend`` defaults to NCCL where CUDA is available, else gloo;
    ``timeout_s`` bounds every collective's wait.  Idempotent."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if coordinator:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                **kw)
    elif "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
            world_size=1, rank=0, **kw)
    return dist.get_rank(), dist.get_world_size()


def local_partition_ids(generators: int, mesh: Mesh) -> list[int]:
    """Generator partitions THIS process must generate: partition p feeds
    shard p % n (the single-process driver's mapping), so a process owns
    the partitions landing on its shards."""
    mine = set(mesh.local_shards)
    return [p for p in range(generators) if p % mesh.n_shards in mine]


@dataclass
class MultiHostExecutor:
    """The DistributedExecutor over a multi-process mesh: every process
    supplies its own shards' tables, the capacities are max-reduced over
    the processes before any exchange, and each process reads back its
    shards' rows — or, with ``gather``, every shard's rows in shard order
    (the same merged output in every process)."""

    spec: object
    mesh: Mesh | None = None
    agg_capacity: int | None = None

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_multihost_mesh()
        self.n_shards = self.mesh.n_shards
        self.local_shards = list(self.mesh.local_shards)
        self._inner = DistributedExecutor(self.spec, self.n_shards,
                                          mesh=self.mesh,
                                          agg_capacity=self.agg_capacity)

    def execute_window(self, local_shard_tables: list[dict],
                       capacities: dict[str, int] | None = None,
                       gather: bool = True) -> dict[str, np.ndarray]:
        """``local_shard_tables[i]``: host columns of this process's i-th
        shard.  Returns host columns (merged shard-major)."""
        outs = self._inner.execute_widening(local_shard_tables, capacities)
        if gather and self.mesh.process_count > 1:
            # every process's shards, in global shard order
            cols = {nm: all_gather(self.mesh, [o.columns[nm] for o in outs])[0]
                    for nm in outs[0].columns}
            outs = [Batch(cols, all_gather(self.mesh,
                                           [o.valid for o in outs])[0])]
        return merged_host(outs, self._inner.device)

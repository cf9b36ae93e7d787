"""Shard meshes — the counterpart of ``flock_tpu/parallel/mesh.py``.

The engine shards relations row-wise over a 1-D axis of ``n`` shards
(partition id == shard id, as in the reference).  Where the reference's
mesh is ``n`` JAX devices, the port's is ``n`` shards, each with the torch
device its tensors live on: on one card every shard is ``cuda:0``; with as
many cards as shards, shard i is ``cuda:i``.  A mesh may also span
processes through a ``torch.distributed`` process group
(``make_multihost_mesh``): each process then holds the consecutive block of
shards ``local_shards`` on its one device, and the exchanges of
``parallel/shuffle.py`` go through the group's collectives (gloo for CPU
tensors, NCCL for CUDA tensors).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from flock_tpu_torch import resolve_device

AXIS = "shards"


@dataclass(frozen=True)
class Mesh:
    """``n_shards`` shards over ``process_count`` processes; this process
    holds the global shards ``local_shards`` on ``devices`` (one device per
    local shard).  ``group`` is the process group of a multi-process mesh
    (``None``: every shard is in this process)."""

    n_shards: int
    devices: tuple
    local_shards: tuple
    process_index: int = 0
    process_count: int = 1
    group: object = None

    @property
    def device(self) -> torch.device:
        """The device of this process's first shard."""
        return self.devices[0]

    @property
    def one_device(self) -> bool:
        return all(d == self.devices[0] for d in self.devices)


def make_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """A mesh of ``n_shards`` shards in this process (default
    ``CONFIG.target_partitions``).  ``device=None`` means the card: every
    shard on ``cuda:0``, or shard i on ``cuda:i`` where there are as many
    cards as shards; it raises without CUDA.  ``device="cpu"`` puts every
    shard on the CPU (the plain PyTorch path)."""
    from flock_tpu_torch.config import CONFIG

    n = n_shards or CONFIG.target_partitions
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.device_count() >= n > 1:
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        devices = (dev,) * n
    return Mesh(n, devices, tuple(range(n)))


def make_multihost_mesh(local_shards: int = 1, device=None,
                        group=None) -> Mesh:
    """A mesh over every process of the initialised ``torch.distributed``
    group (``init_distributed``): ``local_shards`` shards per process, all
    on this process's device, process r holding global shards
    ``r * local_shards`` to ``(r + 1) * local_shards - 1``.  ``device=None``
    means this process's card (``cuda:(rank % cards)``) and raises without
    CUDA; the group's backend must suit it (NCCL for the card, gloo for the
    CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_multihost_mesh needs init_distributed() "
                           "first")
    rank = dist.get_rank(group)
    world = dist.get_world_size(group)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    first = rank * local_shards
    return Mesh(world * local_shards, (dev,) * local_shards,
                tuple(range(first, first + local_shards)), rank, world,
                group if group is not None else dist.group.WORLD)

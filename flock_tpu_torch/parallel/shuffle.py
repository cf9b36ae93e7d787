"""Distributed shuffle: hash partition + all-to-all over a mesh's shards —
the counterpart of ``flock_tpu/parallel/shuffle.py``.

Reference counterpart: Flock's shuffle sends partition *i* of every
producer's output to group member ``(base+i) mod G``.  The reference does
it as one tiled ``lax.all_to_all`` of bucket-major buffers; here every
collective takes and returns one value per local shard.  Inside a process
the exchange is tensor copies on the shards' devices (one stack and one
transpose per column when the shards share a device).  Across the
processes of a multi-process mesh it is ``dist.all_to_all_single`` /
``dist.all_gather_into_tensor`` on the process's device.

The layout is the tiled ``all_to_all``'s: destination shard j receives, in
global source-shard order, ``per_dest_cap`` rows from each source; within a
source the rows are in the stable order of their destination sort, padding
(invalid rows) after them.  The bucketing (a stable sort by destination,
``searchsorted`` bucket starts, a scatter into ``[n, per_dest_cap]``
buffers with a drop slot at ``n * per_dest_cap``) is plain PyTorch, as the
reference computes it outside Pallas.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from flock_tpu_torch.parallel.mesh import Mesh

# The collective byte record: when a list is installed here, every
# collective below appends one record with the bytes it moves per shard
# (the reference's formula), at run time — the port has no trace time.
TALLY: list | None = None


def _tally(op: str, bytes_per_shard: int, detail: str = "") -> None:
    if TALLY is not None:
        TALLY.append({"op": op, "bytes_per_shard": int(bytes_per_shard),
                      "detail": detail})


def hash32(keys: list[torch.Tensor]) -> torch.Tensor:
    """Deterministic int32 hash combine (Fibonacci mix per key), bit for
    bit the reference's: int32 wraparound in the products and ``h << 6``,
    an arithmetic ``h >> 2``, wider keys wrapped to int32 first."""
    h = torch.zeros_like(keys[0], dtype=torch.int32)
    for k in keys:
        k = k.to(torch.int32)
        h = (h ^ (k * -1640531527)) * -1028477387 + (h << 6) + (h >> 2)
    return h & 0x7FFFFFFF


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A bool tensor as bytes for the collectives (gloo takes no bool)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _exchange(mesh: Mesh, bufs: list[torch.Tensor], P: int
              ) -> list[torch.Tensor]:
    """The tiled all-to-all of one column: ``bufs[s]`` is local shard s's
    ``[n * P]`` bucket-major buffer; local shard j gets the ``[n * P]``
    concatenation of every global source's bucket j, in source order."""
    n = mesh.n_shards
    if mesh.group is not None:
        L = len(bufs)
        W = mesh.process_count
        # [L_src, n_dst, P] → by destination process, local destination,
        # local source: what each process receives unpacks into source order
        send = torch.stack([_wire(b).view(n, P) for b in bufs]) \
            .transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv.view(-1), send.view(-1),
                               group=mesh.group)
        out = recv.view(W, L, L, P).transpose(0, 1).contiguous() \
            .view(L, n * P)
        return [o.view(bufs[0].dtype) if bufs[0].dtype == torch.bool else o
                for o in out]
    if mesh.one_device:
        out = torch.stack([b.view(n, P) for b in bufs]).transpose(0, 1) \
            .contiguous().view(n, n * P)
        return list(out)
    return [torch.cat([b.view(n, P)[j].to(dev) for b in bufs])
            for j, dev in enumerate(mesh.devices)]


def global_flag(mesh: Mesh, flags: list[torch.Tensor]) -> list[torch.Tensor]:
    """OR of one 0-d flag per local shard over every shard of the mesh
    (the reference's ``psum(flag) > 0``), one copy per local shard; a
    device value, never read by the host here."""
    dev = mesh.device
    f = torch.stack([x.to(dev) for x in flags]).any()
    if mesh.group is not None:
        t = f.to(torch.int32).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        f = t[0] > 0
    return [f if d == dev else f.to(d) for d in mesh.devices]


def all_to_all_shuffle(mesh: Mesh, cols: list[dict], valid: list,
                       keys: list[str], per_dest_cap: int | None = None):
    """Exchange rows so that equal keys land on one shard (hash routing):
    each shard's ``[cap]`` columns → ``[n, per_dest_cap]`` buckets →
    all-to-all → ``[n * per_dest_cap]`` columns.  Returns (cols, valid,
    overflow), one of each per local shard."""
    n = mesh.n_shards
    dest = [hash32([c[k] for k in keys]) % n for c in cols]
    return all_to_all_by_dest(mesh, cols, valid, dest, per_dest_cap)


def all_to_all_by_dest(mesh: Mesh, cols: list[dict], valid: list,
                       dest: list, per_dest_cap: int | None = None):
    """Exchange rows to explicit destinations (the range-partitioned Sort
    routes by sampled splitters; hash shuffles wrap this with ``hash32``).
    Rows beyond ``per_dest_cap`` for one destination are dropped and set
    the overflow flag, which every shard then reports."""
    n = mesh.n_shards
    cap = valid[0].shape[0]
    P = per_dest_cap or cap
    names = list(cols[0])
    bufs = {nm: [] for nm in names}
    vbufs, ovfs = [], []
    for c, v, d in zip(cols, valid, dest):
        dev = v.device
        d = torch.where(v, d.to(torch.int32), n)   # invalid rows sort last
        sdest, order = torch.sort(d, stable=True)
        svalid = v[order]
        # rank within the destination bucket
        starts = torch.searchsorted(
            sdest, torch.arange(n + 1, dtype=torch.int32, device=dev))
        r = torch.arange(cap, device=dev) - starts[sdest.to(torch.int64)]
        in_range = svalid & (r < P)
        ovfs.append((svalid & (r >= P)).any())
        slot = torch.where(in_range, sdest.to(torch.int64) * P + r, n * P)
        for nm in names:
            buf = torch.zeros(n * P + 1, dtype=c[nm].dtype, device=dev)
            bufs[nm].append(buf.scatter_(0, slot, c[nm][order])[:n * P])
        vbuf = torch.zeros(n * P + 1, dtype=torch.bool, device=dev)
        vbufs.append(vbuf.scatter_(0, slot, in_range)[:n * P])
    out_cols = [{} for _ in cols]
    for nm in names:
        _tally("all_to_all", bufs[nm][0].nbytes * (n - 1) // max(n, 1), nm)
        for i, o in enumerate(_exchange(mesh, bufs[nm], P)):
            out_cols[i][nm] = o
    _tally("all_to_all", vbufs[0].nbytes * (n - 1) // max(n, 1), "valid")
    return out_cols, _exchange(mesh, vbufs, P), global_flag(mesh, ovfs)


def all_gather(mesh: Mesh, parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every shard's tensor concatenated in global shard order, one copy
    per local shard (shards on one device share it)."""
    dev = mesh.device
    local = torch.cat([_wire(p).to(dev) for p in parts])
    if mesh.group is not None:
        g = torch.empty(local.shape[0] * mesh.process_count,
                        dtype=local.dtype, device=dev)
        dist.all_gather_into_tensor(g, local, group=mesh.group)
        local = g
    if parts[0].dtype == torch.bool:
        local = local.view(torch.bool)
    return [local if d == dev else local.to(d) for d in mesh.devices]


def broadcast_gather(mesh: Mesh, cols: list[dict], valid: list):
    """All-gather every shard's rows (the broadcast build of lookup joins):
    each shard gets the whole relation.  Returns (cols, valid) per local
    shard."""
    n = mesh.n_shards
    out_cols = [{} for _ in cols]
    for nm in cols[0]:
        # each shard receives n - 1 remote copies of the buffer
        _tally("all_gather", cols[0][nm].nbytes * max(n - 1, 0), nm)
        for i, g in enumerate(all_gather(mesh, [c[nm] for c in cols])):
            out_cols[i][nm] = g
    return out_cols, all_gather(mesh, valid)

"""The few collectives the mesh path of the cascade runs, on local shards.

A tensor sharded by the logical rules is a ``DTensor`` here used as a
container: its global shape, its mesh and placements, and this rank's
block (``to_local()``), on the rank's compute device.  The rows it moves
are sharded on dim 0 only (an example axis, or a tier's stacked member
axis): over the mesh dims whose placement is ``Shard(0)``, the first the
major, as DTensor lays them out.  Blocks move point to point, from the
rank that holds them to the rank that needs them, so a hop or a gather
costs the bytes it moves and needs no group beyond the world.

Every collective runs on the process group's own device: host tensors
under ``gloo`` (the tensor is staged through the host and back), the
rank's card under ``nccl``.  Each function is called by every rank of the
world (a rank outside the mesh returns at once, or joins the world
broadcast), in the same order.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.sharding.mesh import mesh_ranks


def wire_device(device) -> torch.device:
    """Where a collective's buffers live: the host under ``gloo``, the
    rank's ``device`` under any other backend."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else torch.device(device)


def in_mesh(mesh) -> bool:
    """True on a rank of ``mesh`` (always, with no mesh)."""
    return mesh is None or mesh.get_coordinate() is not None


def _row_dims(mesh, placements) -> list:
    from torch.distributed.tensor import Shard

    dims = []
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            if p.dim != 0:
                raise ValueError(f"rows move sharded on dim 0 only, not {placements}")
            dims.append(j)
    return dims


def row_blocks(mesh, placements) -> int:
    """How many row blocks ``placements`` cut dim 0 into on ``mesh``."""
    n = 1
    for j in _row_dims(mesh, placements):
        n *= mesh.mesh.shape[j]
    return n


def block_of(mesh, placements, coord: Sequence[int]) -> int:
    """The row block the rank at mesh coordinate ``coord`` holds."""
    b = 0
    for j in _row_dims(mesh, placements):
        b = b * mesh.mesh.shape[j] + coord[j]
    return b


def _coords(mesh):
    """(rank, mesh coordinate) of every rank of ``mesh``, in its order."""
    shape = tuple(mesh.mesh.shape)
    out = []
    for flat, r in enumerate(mesh_ranks(mesh)):
        coord, rem = [], flat
        for s in reversed(shape):
            coord.append(rem % s)
            rem //= s
        out.append((r, tuple(reversed(coord))))
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def as_dtensor(local: torch.Tensor, mesh, placements, shape, dtype):
    """A ``DTensor`` of global ``shape`` over ``local`` (this rank's block; an
    empty meta tensor on a rank outside the mesh).  No communication."""
    from torch.distributed.tensor import DTensor

    if local is None:
        local = torch.empty((0,) + tuple(shape)[1:], dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def local_block(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of a tensor every rank of ``mesh`` holds whole."""
    n = row_blocks(mesh, placements)
    if n == 1:
        return full
    rows = full.shape[0] // n
    b = block_of(mesh, placements, mesh.get_coordinate())
    return full[b * rows:(b + 1) * rows]


def scatter_rows(full: Optional[torch.Tensor], src: int, mesh, placements, shape, dtype, device):
    """Rank ``src``'s ``full`` tensor (global ``shape``; ``src`` may lie
    outside ``mesh``) to ``mesh`` in ``placements``: each rank of the mesh
    receives its block only, and gets it on ``device``.  Returns the
    ``DTensor`` on every rank."""
    me = dist.get_rank()
    here = mesh.get_coordinate() is not None
    n = row_blocks(mesh, placements)
    rows = shape[0] // n
    local = None
    if me == src:
        wire = full.to(wire_device(device))
        works = []
        for r, coord in _coords(mesh):
            b = block_of(mesh, placements, coord)
            block = wire[b * rows:(b + 1) * rows].contiguous()
            if r == me:
                local = block.to(device, copy=True)
            else:
                works.append(dist.isend(block, r))
        for w in works:
            w.wait()
    elif here:
        buf = torch.empty((rows,) + tuple(shape)[1:], dtype=dtype, device=wire_device(device))
        dist.recv(buf, src)
        local = buf.to(device)
    return as_dtensor(local, mesh, placements, shape, dtype)


def gather_rows(x, dst: int) -> Optional[torch.Tensor]:
    """The whole of ``x`` (a ``DTensor``) on rank ``dst`` of its mesh, on the
    device of ``x``'s local block; None on every other rank.  Each block
    travels once, from the first rank (in mesh order) that holds it."""
    mesh, placements = x.device_mesh, x.placements
    if mesh.get_coordinate() is None:
        return None
    me = dist.get_rank()
    local = x.to_local()
    n = row_blocks(mesh, placements)
    holders = {}
    for r, coord in _coords(mesh):
        holders.setdefault(block_of(mesh, placements, coord), r)
    if me != dst:
        if holders[block_of(mesh, placements, mesh.get_coordinate())] == me:
            dist.send(local.to(wire_device(local.device)).contiguous(), dst)
        return None
    blocks = []
    for b in range(n):
        if holders[b] == me:
            blocks.append(local)
        else:
            buf = torch.empty(tuple(local.shape), dtype=local.dtype, device=wire_device(local.device))
            dist.recv(buf, holders[b])
            blocks.append(buf.to(local.device))
    return blocks[0] if n == 1 else torch.cat(blocks)


def materialize(x) -> Optional[torch.Tensor]:
    """The whole of ``x`` (a ``DTensor``) on every rank of its mesh (None
    outside it): gathered on the mesh's first rank, then sent to the rest."""
    mesh = x.device_mesh
    if mesh.get_coordinate() is None:
        return None
    if row_blocks(mesh, x.placements) == 1:
        return x.to_local()
    ranks = mesh_ranks(mesh)
    first, me = ranks[0], dist.get_rank()
    full = gather_rows(x, first)
    dev = x.to_local().device
    if me == first:
        wire = full.to(wire_device(dev)).contiguous()
        works = [dist.isend(wire, r) for r in ranks[1:]]
        for w in works:
            w.wait()
        return full
    buf = torch.empty(tuple(x.shape), dtype=x.dtype, device=wire_device(dev))
    dist.recv(buf, first)
    return buf.to(dev)


def broadcast(t: Optional[torch.Tensor], src: int, shape, dtype, device) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of the world, on the wire device
    (``wire_device(device)``); the other ranks pass ``t=None`` and the
    ``shape`` and ``dtype`` it has."""
    wire = wire_device(device)
    buf = t.to(wire).contiguous() if dist.get_rank() == src else torch.empty(tuple(shape), dtype=dtype, device=wire)
    dist.broadcast(buf, src)
    return buf


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of every rank of ``group`` (a mesh dim's group), concatenated
    on dim 0 in the group's rank order, on ``t``'s device."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    wire = t.to(wire_device(t.device)).contiguous()
    out = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(out, wire, group=group)
    return torch.cat(out).to(t.device)

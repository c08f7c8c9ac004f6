"""Mesh helpers (port of ``repro.sharding.mesh``): a ``DeviceMesh`` over
the ranks of the process group, one rank a device."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import rank_device


def ensure_process_group(device) -> None:
    """Start a one-rank process group when none is up: ``gloo`` for the CPU,
    ``nccl`` for the card.  A group started by the caller (``torchrun``,
    ``init_process_group``) is used as it is, whatever its backend."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def device_mesh(device, shape: Sequence[int], axis_names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` over ranks 0 .. prod(shape) - 1, the
    ranks laid out in row-major order, on ``device``'s type (``rank_device``:
    None means the card, raising without one).  On the card the rank's card
    is made current first.  Every rank of the world calls it: building the
    mesh's groups is collective."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = rank_device(device)
    ensure_process_group(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(axis_names))


def local_mesh(axis_names: Sequence[str] = ("data", "model"), device=None):
    """Every rank of the world on the first axis, size-1 trailing axes: on
    one rank, the degenerate mesh the same sharded code runs on."""
    import torch.distributed as dist

    dev = rank_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    return device_mesh(dev, (n,) + (1,) * (len(axis_names) - 1), axis_names)


def mesh_axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of a ``DeviceMesh`` or a ``{name: size}``
    mapping."""
    from repro_torch.sharding.logical import mesh_axis_sizes

    return mesh_axis_sizes(mesh)[name]


def mesh_ranks(mesh) -> list:
    """The global ranks of ``mesh``, in its row-major order."""
    return mesh.mesh.flatten().tolist()


def first_rank(mesh) -> int:
    """The first rank of ``mesh`` (its source for a hop it sends)."""
    return int(mesh.mesh.flatten()[0])

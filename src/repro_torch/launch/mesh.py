"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  A mesh is a ``torch.distributed`` ``DeviceMesh``, one rank
a device, so the production meshes need a world of that many ranks (under
``torchrun`` or a launcher of its kind); shape-only work on the production
sizes (``sharding.logical_to_pspec``) takes the ``{axis: size}`` mapping
``production_axis_sizes`` gives instead.
"""
from __future__ import annotations

from repro_torch.sharding.mesh import device_mesh


def production_axis_sizes(*, multi_pod: bool = False) -> dict:
    """``{axis name: size}`` of the production mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod.

    Axes: ('data', 'model') single-pod; ('pod', 'data', 'model')
    multi-pod.  The 'pod' axis carries the ensemble's members (DESIGN.md
    §3) and folds into data parallelism for single-model steps.  Raises
    unless the world has exactly that many ranks."""
    import torch.distributed as dist

    sizes = production_axis_sizes(multi_pod=multi_pod)
    n = 1
    for s in sizes.values():
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(f"the production mesh {tuple(sizes.values())} needs {n} ranks; the world has {world}")
    return device_mesh(device, tuple(sizes.values()), tuple(sizes))


def pod_submeshes(mesh, n_slices: int):
    """Carve a mesh with a leading 'pod' axis into ``n_slices`` contiguous
    pod slices (DESIGN.md §3: tier placement).  Each slice keeps all three
    axes: its share of pods, so a tier's 'ensemble' logical axis still maps
    onto 'pod', and its 'data' axis, which a deferral payload's rows shard
    over on arrival (``serve.transport.ShardedDevicePutTransport``).
    Distinct slices own disjoint ranks.  Every rank of the world calls it,
    as building each slice's groups requires."""
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(mesh.mesh_dim_names)
    if names[0] != "pod":
        raise ValueError(f"pod_submeshes needs a leading 'pod' axis, got {names}")
    n_pods = mesh.mesh.shape[0]
    if n_pods % n_slices:
        raise ValueError(f"{n_pods} pods do not split into {n_slices} slices")
    per = n_pods // n_slices
    return [DeviceMesh(mesh.device_type, mesh.mesh[i * per:(i + 1) * per], mesh_dim_names=names)
            for i in range(n_slices)]

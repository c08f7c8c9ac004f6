"""Sharding substrate (port of ``repro.sharding``): logical-axis rules over
``torch.distributed`` device meshes."""
from repro_torch.sharding.logical import (
    RULES_DECODE,
    RULES_PREFILL,
    RULES_TRAIN,
    LogicalAxisRules,
    NamedSharding,
    PartitionSpec,
    logical_placements,
    logical_sharding,
    logical_to_pspec,
    rules_for,
    tree_pspecs,
    with_logical_constraint,
)
from repro_torch.sharding.mesh import local_mesh, mesh_axis_size

__all__ = [
    "LogicalAxisRules",
    "NamedSharding",
    "PartitionSpec",
    "logical_placements",
    "logical_to_pspec",
    "logical_sharding",
    "tree_pspecs",
    "with_logical_constraint",
    "RULES_TRAIN",
    "RULES_PREFILL",
    "RULES_DECODE",
    "rules_for",
    "local_mesh",
    "mesh_axis_size",
]

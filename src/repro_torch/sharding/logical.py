"""Logical-axis sharding rules (port of ``repro.sharding.logical``).

Every parameter and hot activation carries a tuple of *logical* axis names
(``('embed', 'mlp')``, ``('act_batch', 'act_seq', 'act_embed')``, ...): the
port's trees give them through ``models.api.param_axes`` / ``cache_axes``
and ``core.ensemble.ensemble_axes``.  A rule table maps each logical name to
zero or more *mesh* axes, and ``logical_to_pspec`` translates a logical
tuple into a ``PartitionSpec``, dropping any mesh axis that does not divide
the concrete dimension, so the same rules hold on a one-rank mesh and on
the 512-rank production mesh.

A mesh is a ``torch.distributed.DeviceMesh`` (one rank a device) or, where
no process group of that size exists, a ``{axis name: size}`` mapping; the
translation reads only the axis sizes.  ``logical_placements`` turns a spec
into DTensor placements, one per mesh dim.

The port's model code runs on the local shards of its tensors (a tier's
members on its slice, its rows on arrival) and calls no ``constrain``:
``constrain`` exists for code that holds ``DTensor``s, where it
redistributes to the active rule table's placements; without rules, or on
a plain tensor, it is a no-op.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
LogicalAxisRules = Mapping[str, MeshAxes]


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (sharded over their product, the first the major).
    Equal, entry for entry, to JAX's ``PartitionSpec`` for the same rules."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A mesh and a spec: where each block of a tensor lives."""

    mesh: object
    spec: PartitionSpec

    def placements(self, ndim: int):
        return logical_placements(self.spec, self.mesh, ndim)


class _RulesContext(threading.local):
    def __init__(self):
        self.rules: Optional[LogicalAxisRules] = None
        self.mesh = None


_CTX = _RulesContext()


@contextlib.contextmanager
def axis_rules(rules: Optional[LogicalAxisRules], mesh=None):
    """Install a logical -> mesh rule table (and optionally the mesh) for the
    duration of the context, on this thread."""
    prev_rules, prev_mesh = _CTX.rules, _CTX.mesh
    _CTX.rules, _CTX.mesh = rules, mesh
    try:
        yield
    finally:
        _CTX.rules, _CTX.mesh = prev_rules, prev_mesh


def current_rules() -> Optional[LogicalAxisRules]:
    return _CTX.rules


def current_mesh():
    return _CTX.mesh


def _as_tuple(spec: MeshAxes) -> Tuple[str, ...]:
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(spec)


def mesh_axis_sizes(mesh) -> Mapping[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def logical_to_pspec(
    axes: Sequence[Optional[str]],
    rules: LogicalAxisRules,
    *,
    shape: Optional[Sequence[int]] = None,
    mesh=None,
) -> PartitionSpec:
    """Translate a logical-axis tuple into a ``PartitionSpec``.

    With ``shape`` and ``mesh`` a mesh axis is kept only while the product
    of the kept axes divides the dimension (greedily, left to right), so
    the spec is always valid.  A mesh axis appears at most once in the
    result: a later logical dim loses an axis an earlier one took."""
    sizes = mesh_axis_sizes(mesh) if mesh is not None else {}
    used: set = set()
    entries = []
    for i, name in enumerate(axes):
        mesh_axes = [a for a in _as_tuple(rules.get(name)) if a not in used] if name else []
        if shape is not None and mesh is not None and mesh_axes:
            kept = []
            prod = 1
            for a in mesh_axes:
                if shape[i] % (prod * sizes[a]) == 0:
                    kept.append(a)
                    prod *= sizes[a]
            mesh_axes = kept
        used.update(mesh_axes)
        if not mesh_axes:
            entries.append(None)
        elif len(mesh_axes) == 1:
            entries.append(mesh_axes[0])
        else:
            entries.append(tuple(mesh_axes))
    return PartitionSpec(*entries)


def logical_placements(spec: Sequence[MeshAxes], mesh, ndim: int) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where tensor dim d lists that mesh axis, else
    ``Replicate()``.  DTensor shards a dim over its mesh dims in the mesh's
    order (the first the major), so a spec that lists a dim's axes in
    another order has no placements and raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} has more entries than the tensor's {ndim} dims")
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _as_tuple(entry)]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {_as_tuple(entry)}, not in the mesh's order {tuple(names)}")
        for j in idx:
            out[j] = Shard(d)
    return out


def logical_sharding(mesh, shape: Sequence[int], axes: Sequence[Optional[str]], rules: LogicalAxisRules) -> NamedSharding:
    return NamedSharding(mesh, logical_to_pspec(axes, rules, shape=shape, mesh=mesh))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_pspecs(axes_tree, rules: LogicalAxisRules, shapes_tree=None, mesh=None):
    """Map a tree (dicts and lists) of logical-axis tuples to the same tree
    of ``PartitionSpec``s; ``shapes_tree`` (leaves with a ``shape``) and
    ``mesh`` drop the axes that do not divide."""
    def walk(a, s):
        if _is_axes(a):
            return logical_to_pspec(a, rules, shape=None if s is None else tuple(s.shape), mesh=mesh)
        if isinstance(a, dict):
            return {k: walk(v, None if s is None else s[k]) for k, v in a.items()}
        return [walk(v, None if s is None else s[j]) for j, v in enumerate(a)]

    return walk(axes_tree, shapes_tree)


def with_logical_constraint(x, axes: Sequence[Optional[str]]):
    """Redistribute a ``DTensor`` to the active rule table's placements on
    its own mesh.  A no-op with no rules installed, on a plain tensor, or
    when the tensor's rank does not match the annotation."""
    rules = _CTX.rules
    if rules is None:  # the serving and training paths: no rule table, no import
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or len(axes) != x.ndim:
        return x
    spec = logical_to_pspec(axes, rules, shape=x.shape, mesh=x.device_mesh)
    return x.redistribute(x.device_mesh, logical_placements(spec, x.device_mesh, x.ndim))


# Shorthand, as in the JAX package.
constrain = with_logical_constraint


# ---------------------------------------------------------------------------
# Rule tables (the JAX package's, verbatim).  Mesh axes: ('pod',) 'data', 'model'.
# ---------------------------------------------------------------------------

def _base_rules(pod: bool) -> dict:
    data = ("pod", "data") if pod else ("data",)
    return {
        # -- weights ---------------------------------------------------
        "embed": None,          # overridden to FSDP axis for train
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "qkv": None,
        "vocab": "model",
        "experts": "model",
        # fallback: when n_experts doesn't divide the model axis (mixtral's
        # 8 on a 16-wide axis) the experts dim drops and the expert FFN dim
        # takes 'model' instead (TP within experts) — logical_to_pspec's
        # first-come-first-served axis assignment arbitrates
        "expert_mlp": "model",
        "layers": None,
        "ensemble": "pod" if pod else None,
        "norm": None,
        "ssm_inner": "model",
        "ssm_state": None,
        "ssm_heads": "model",
        "ssm_group": None,
        "conv_kernel": None,
        "rwkv_lora": None,
        # -- activations ----------------------------------------------
        "act_batch": data,
        "act_seq": None,
        "act_embed": None,
        "act_mlp": "model",
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_head_dim": None,
        "act_vocab": "model",
        "act_experts": "model",
        # expert capacity buffers: shard capacity over 'data' so the scatter
        # dispatch never all-reduces the full (E, C, D) buffer
        "act_capacity": ("data",),
        "act_ensemble": "pod" if pod else None,
        # -- kv cache ---------------------------------------------------
        "kv_batch": data,
        "kv_seq": None,
        "cache_kv_heads": "model",
    }


def make_rules(kind: str, *, pod: bool = False) -> dict:
    """Rule table for a shape kind: 'train' | 'prefill' | 'decode' | 'decode_long'."""
    r = _base_rules(pod)
    if kind == "train":
        # FSDP: weight embed dim over the data axis (ZeRO-3 style)
        r["embed"] = ("data",)
    elif kind == "prefill":
        r["embed"] = ("data",)  # weights stay fully sharded; long seq amortizes gathers
        r["act_seq"] = None
        # the produced KV cache is stored seq-sharded, matching the decode
        # rules it will be consumed under (and bounding output residency)
        r["kv_seq"] = "model"
        r["cache_kv_heads"] = None
    elif kind == "decode":
        r["embed"] = ("data",)
        r["kv_seq"] = "model"      # GQA kv_heads (2/8) rarely divisible by 16
        r["cache_kv_heads"] = None
    elif kind == "decode_long":
        r["embed"] = ("data",)
        r["kv_seq"] = ("data", "model")  # batch=1: spread the 500k cache everywhere
        r["cache_kv_heads"] = None
        r["act_batch"] = None
    else:
        raise ValueError(f"unknown rule kind: {kind}")
    return r


RULES_TRAIN = make_rules("train")
RULES_PREFILL = make_rules("prefill")
RULES_DECODE = make_rules("decode")


def rules_for(kind: str, *, pod: bool = False, batch: Optional[int] = None) -> dict:
    if kind == "decode" and batch == 1:
        kind = "decode_long"
    return make_rules(kind, pod=pod)

"""Calls that take plain tensors, given ``DTensor``s: the dry run's placed
pass (``launch/dryrun.py``) hands them to the kernel entries' meta routes
and to the aten ops DTensor has no sharding strategy for.

The inputs are redistributed to what the call reads on each rank (the
all-gathers a partitioner would issue around an opaque call, counted by an
active ``launch.op_cost.OpCounter``), the call runs on the local blocks,
and its outputs come back as ``DTensor``s.  Nothing here runs on the
serving path.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def _dtensors(a):
    if isinstance(a, DTensor):
        yield a
    elif isinstance(a, (list, tuple)):
        for x in a:
            yield from _dtensors(x)
    elif isinstance(a, dict):
        for x in a.values():
            yield from _dtensors(x)


def has_dtensor(*args) -> bool:
    """True when a ``DTensor`` lies in ``args`` (in lists, tuples, dicts)."""
    return next(_dtensors(args), None) is not None


def redistributed(x: DTensor, placements) -> DTensor:
    """``x`` redistributed to ``placements``.  A shard DTensor cannot move
    as asked (an uneven shard it pads wrong) goes whole first, one mesh dim
    at a time from the last; a partial sum, reduced by then, stays whole."""
    try:
        return x.redistribute(x.device_mesh, placements)
    except RuntimeError:
        cur = list(x.placements)
        for j in reversed(range(len(cur))):
            cur[j] = Replicate()
            x = x.redistribute(x.device_mesh, cur)
        return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p for p in placements])


def replicated_call(fn, *args, **kwargs):
    """``fn`` over ``DTensor`` arguments (in lists and dicts too): each is
    redistributed to ``Replicate``, ``fn`` runs on the local tensors, and
    its tensor outputs come back replicated on the first argument's
    mesh."""
    mesh = next(_dtensors((args, kwargs))).device_mesh
    rep = [Replicate()] * mesh.ndim

    def local(a):
        if isinstance(a, DTensor):
            return redistributed(a, rep).to_local()
        if isinstance(a, (list, tuple)):
            return type(a)(local(x) for x in a)
        if isinstance(a, dict):
            return {k: local(v) for k, v in a.items()}
        return a

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return DTensor.from_local(o, mesh, rep, run_check=False)
        if isinstance(o, (tuple, list)):
            return type(o)(wrap(x) for x in o)
        if isinstance(o, dict):
            return {k: wrap(v) for k, v in o.items()}
        return o

    return wrap(fn(*local(args), **local(kwargs)))


def attention_call(fn, q, kvs, kv_head_dim: int, *rest, **kwargs):
    """An attention call over ``DTensor``s: q (batch first, heads at dim 2)
    keeps its batch and head shards and is reduced elsewhere; each of
    ``kvs`` is brought to q's batch shards with every head and sliced to
    the heads q's local heads read (``H / KVH`` query heads share one);
    the other tensor arguments are gathered whole.  ``fn(q, *kvs, *rest,
    **kwargs)`` runs on the local blocks and its output keeps q's
    placements."""
    mesh = q.device_mesh
    qp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in q.placements]
    kvp = [Shard(0) if p == Shard(0) else Replicate() for p in qp]
    H, KVH = q.shape[2], kvs[0].shape[kv_head_dim]
    n, c = 1, 0
    coord = mesh.get_coordinate()
    for j, p in enumerate(qp):
        if p == Shard(2):
            n, c = n * mesh.mesh.shape[j], c * mesh.mesh.shape[j] + coord[j]
    h0, Hl, G = c * (H // n), H // n, H // KVH
    heads = slice(h0 // G, (h0 + Hl - 1) // G + 1)

    def kv(t):
        t = t.redistribute(mesh, kvp).to_local() if isinstance(t, DTensor) else t
        return t[(slice(None),) * kv_head_dim + (heads,)]

    def whole(t):
        return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local() if isinstance(t, DTensor) else t

    out = fn(q.redistribute(mesh, qp).to_local(), *(kv(t) for t in kvs), *(whole(t) for t in rest),
             **{k: whole(v) for k, v in kwargs.items()})
    return DTensor.from_local(out, mesh, qp, run_check=False)


def kernel_call(fn, args, kwargs, kv_head_dim=None):
    """A kernel entry's meta route ``fn`` (``obs.op_charges.meta_call``) on
    each rank's blocks: ``attention_call`` where ``kv_head_dim`` marks an
    attention call, ``replicated_call`` otherwise, and ``fn`` as called
    where no argument is a ``DTensor``."""
    if not has_dtensor(args, kwargs):
        return fn(*args, **kwargs)
    if kv_head_dim is not None:
        return attention_call(fn, args[0], args[1:3], kv_head_dim, *args[3:], **kwargs)
    return replicated_call(fn, *args, **kwargs)

"""Calls that take plain tensors, given ``DTensor``s: the dry run's placed
pass (``launch/dryrun.py``) hands them to the kernel entries' meta routes
and to the aten ops DTensor has no sharding strategy for.

The inputs are redistributed to what the call reads on each rank (the
all-gathers a partitioner would issue around an opaque call, counted by an
active ``launch.op_cost.OpCounter``), the call runs on the local blocks,
and its outputs come back as ``DTensor``s; a decode over a cache sharded
along its sequence merges each rank's partial softmax instead
(``lse_merge``).  ``ce_chunk_vocab_sharded`` is the loss's chunk sums
with the vocabulary kept sharded.  Nothing here runs on the serving path.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding.logical import constrain


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


def lse_merge(o, m, l, groups):
    """The merge of a softmax over an axis sharded across ``groups`` (each a
    ``(mesh, dim)`` of the functional collectives): every rank's partial
    (o (B, 1, H, hd) unnormalised, m and l (B, H), all f32) is rescaled to
    the all-reduced row maximum, then the sums and outputs are all-reduced
    — the log-sum-exp reduction a partitioner issues.  Returns the
    normalised output (zeros where no rank saw a key), f32."""
    import torch.distributed._functional_collectives as funcol

    M = m
    for grp in groups:
        M = funcol.all_reduce(M, "max", grp)
    scale = torch.where(m == -torch.inf, 0.0, torch.exp(m - torch.where(M == -torch.inf, 0.0, M)))
    l, o = l * scale, o * scale[:, None, :, None]
    for grp in groups:
        l = funcol.all_reduce(l, "sum", grp)
        o = funcol.all_reduce(o, "sum", grp)
    return o / torch.where(l == 0, 1.0, l)[:, None, :, None]


def attention_call(fn, q, kvs, kv_head_dim: int, *rest, seq_partial=None, **kwargs):
    """An attention call over ``DTensor``s: q (batch first, heads at dim 2)
    keeps its batch and head shards and is reduced elsewhere; each of
    ``kvs`` is brought to q's batch shards with every head and sliced to
    the heads q's local heads read (``H / KVH`` query heads share one);
    the other tensor arguments are gathered whole, a per-row one (B,) cut
    to q's local rows.  ``fn(q, *kvs, *rest,
    **kwargs)`` runs on the local blocks and its output keeps q's
    placements (q, where it holds every row, first takes the rows of the
    cache's shards).

    With ``seq_partial`` (the dense decode: caches (B, KVH, S, hd)), a
    cache sharded along its sequence stays so: on each mesh dim that
    shards it, q is gathered whole (O(B·H·hd), never the O(S) cache),
    ``seq_partial`` attends each rank's slice of keys at its global offset
    and ``lse_merge`` all-reduces the partial softmaxes over those dims."""
    mesh = q.device_mesh
    seq = []
    if seq_partial is not None and isinstance(kvs[0], DTensor):
        seq = [j for j, p in enumerate(kvs[0].placements) if p == Shard(2)]
    keep = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in q.placements]
    # where q holds every row and the cache is cut by rows (q a partial sum
    # or replicated), q goes to the cache's row shards: O(B·H·hd) moved,
    # where gathering the cache's rows would move all of it
    kv_place = kvs[0].placements if isinstance(kvs[0], DTensor) else [Replicate()] * mesh.ndim
    keep = [Shard(0) if j not in seq and not p.is_shard() and kv_place[j] == Shard(0) else p
            for j, p in enumerate(keep)]
    qp = [Replicate() if j in seq else p for j, p in enumerate(keep)]
    kvp = [Shard(2) if j in seq else Shard(0) if p == Shard(0) else Replicate() for j, p in enumerate(qp)]
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

    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    (n_rows, *_), (row0, *_) = compute_local_shape_and_global_offset(q.shape, mesh, qp)

    def rows(t):  # a per-row argument (cur_len, starts: (B,)) cut to q's local rows
        t = whole(t)
        return t[row0:row0 + n_rows] if isinstance(t, torch.Tensor) and t.ndim and t.shape[0] == q.shape[0] else t

    q_local, kv_local = q.redistribute(mesh, qp).to_local(), [kv(t) for t in kvs]
    rest, kwargs = [rows(t) for t in rest], {k: rows(v) for k, v in kwargs.items()}
    if not seq:
        return DTensor.from_local(fn(q_local, *kv_local, *rest, **kwargs), mesh, qp, run_check=False)
    offset = compute_local_shape_and_global_offset(kvs[0].shape, mesh, kvp)[1][2]
    o, m, l = seq_partial(q_local, *kv_local, *rest, key_offset=offset, **kwargs)
    out = lse_merge(o, m, l, [(mesh, j) for j in seq]).to(q.dtype)
    # replicated over the sequence's dims: q's own head shards are local slices of it
    return DTensor.from_local(out, mesh, qp, run_check=False).redistribute(mesh, keep)


def kernel_call(fn, args, kwargs, kv_head_dim=None, seq_partial=None):
    """A kernel entry's meta route ``fn`` (``obs.op_charges.meta_call``) on
    each rank's blocks: ``attention_call`` where ``kv_head_dim`` marks an
    attention call, ``replicated_call`` otherwise, and ``fn`` as called
    where no argument is a ``DTensor``."""
    if not has_dtensor(args, kwargs):
        return fn(*args, **kwargs)
    if kv_head_dim is not None:
        return attention_call(fn, args[0], args[1:3], kv_head_dim, *args[3:], seq_partial=seq_partial, **kwargs)
    return replicated_call(fn, *args, **kwargs)


def ce_chunk_vocab_sharded(h, head, t, m):
    """``models.api._ce_chunk``'s sums (nll, z, mask, correct) on
    ``DTensor``s with the vocabulary sharded, as the JAX package constrains
    the logits ("act_vocab"): the head's embedding dim is gathered (a
    weight) and the hidden rows kept whole on it, so the product comes out
    sharded by vocabulary with no partial sum (whose gradient would gather
    the logits).  Every reduction over the vocabulary is then a local one
    and an all-reduce of (B, c): its max, its sum of exponentials, the
    target's logit picked by a one-hot mask, and the first index of the
    maximum (a min over the indices where the maximum lies), where a gather
    or an argmax would gather the logits whole.  A row is correct when that
    index is its target, as ``argmax`` decides a tie."""
    h = constrain(h, ("act_batch", "act_seq", None))
    head = constrain(head, (None, "vocab"))
    logits = constrain((h @ head).float(), ("act_batch", "act_seq", "act_vocab"))
    V = logits.shape[-1]
    mx = logits.amax(-1)
    logz = (logits - mx[..., None]).exp().sum(-1).log() + mx
    idx = torch.arange(V, device=t.device)
    tgt = torch.where(idx == t[..., None], logits, 0.0).sum(-1)
    first = torch.where(logits == mx[..., None], idx, V).amin(-1)
    acc = (first == t).float()
    return torch.stack([((logz - tgt) * m).sum(), (logz.square() * m).sum(), m.sum(), (acc * m).sum()])

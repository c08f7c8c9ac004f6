"""Cascade execution (Algorithm 1), ported from ``repro.core.cascade``.

``cascade_apply_dense``  — masked form: every tier evaluates the whole
    batch and the first agreeing tier's answer is selected.  The reference
    semantics.

``cascade_apply_routed`` — compacting form: after tier i only the deferred
    examples flow to tier i+1.  Compaction (defer mask -> prefix sum ->
    dense payload + index map) runs on the device through
    ``kernels/compaction``; the host reads ONE scalar per tier transition
    (the deferred count) to pick power-of-two bucket chunks.  Every
    intentional device->host read goes through the metered ``host_fetch``.

Tier callables map a batch slice to logits (E, B, V) or, for black-box
generation, to answer ids (E, B).  When tiers are placed on different hosts
(``serve/placement.py``), the compacted payload takes an explicit
``Transport`` hop (``serve/transport.py``) whose bytes and latency are
metered, and answers produced on another device are moved next to the
result accumulators before they are scattered.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import deferral
from repro_torch.device import resolve_device
from repro_torch.kernels.compaction import ops as compaction_ops
from repro_torch.obs import global_registry


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One cascade level: an ensemble of k models + its deferral rule."""

    name: str
    rule: str  # a key of deferral.RULES
    theta: float
    k: int = 1
    cost: float = 1.0  # per-example cost in the scenario's unit


@dataclasses.dataclass
class CascadeResult:
    pred: np.ndarray  # (B,)
    tier_of: np.ndarray  # (B,) index of the answering tier
    scores: np.ndarray  # (B,) deferral score at the answering tier
    tier_counts: np.ndarray  # (n_tiers,) examples answered per tier
    evaluated: np.ndarray  # (n_tiers,) examples evaluated per tier
    cost: float  # total cost under the specs' per-example costs


def cascade_apply_dense(tier_fns: Sequence[Callable], specs: Sequence[TierSpec], batch):
    """Masked cascade.  Returns (pred, tier_of, scores) tensors."""
    n = len(tier_fns)
    pred = tier_of = score_out = decided = None
    for i, (fn, spec) in enumerate(zip(tier_fns, specs)):
        out = deferral.apply_rule(spec.rule, fn(batch), spec.theta)
        take = ~out.defer | (i == n - 1)
        if pred is None:
            pred, tier_of, score_out, decided = out.pred, torch.zeros_like(out.pred), out.score, take
        else:
            newly = ~decided & take
            pred = torch.where(newly, out.pred, pred)
            tier_of = torch.where(newly, torch.full_like(tier_of, i), tier_of)
            score_out = torch.where(newly, out.score, score_out)
            decided = decided | take
    return pred, tier_of, score_out


def bucket_size(n: int, floor: int = 8) -> int:
    """Power-of-two batch bucket (>= floor)."""
    p = max(1, floor)
    while p < n:
        p *= 2
    return p


def bucket_chunks(n: int, floor: int = 8) -> List[int]:
    """Greedy power-of-two decomposition of ``n`` rows into chunks that are
    power-of-two multiples of ``floor``; the last may overshoot (padding)."""
    sizes: List[int] = []
    rem = n
    while rem > 0:
        c = max(1, floor)
        while c * 2 <= rem:
            c *= 2
        sizes.append(c)
        rem -= c
    return sizes


def prompt_chunks(n: int, max_chunk: int = 256) -> List[int]:
    """Exact power-of-two cover of ``n`` prompt tokens, largest first."""
    sizes: List[int] = []
    while n >= max_chunk:
        sizes.append(max_chunk)
        n -= max_chunk
    if n > 0:
        sizes.extend(bucket_chunks(n, floor=1))
    return sizes


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Edge-pad a tensor's leading axis to ``n`` rows."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x[-1:].expand((n - x.shape[0],) + tuple(x.shape[1:]))], 0)


# ---------------------------------------------------------------------------
# metered host fetch: every intentional device->host read on the serving
# path goes through here and is counted (calls) and byte-metered
# ---------------------------------------------------------------------------

_C_FETCH_BYTES = global_registry().counter("host_fetch.bytes")
_C_FETCH_CALLS = global_registry().counter("host_fetch.calls")


def host_fetch_stats() -> dict:
    return {"bytes": _C_FETCH_BYTES.value, "calls": _C_FETCH_CALLS.value}


def reset_host_fetch_stats() -> None:
    _C_FETCH_BYTES.reset()
    _C_FETCH_CALLS.reset()


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        _C_FETCH_BYTES.add(tree.numel() * tree.element_size())
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        _C_FETCH_BYTES.add(int(tree.nbytes))
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def host_fetch(tree):
    """Metered explicit fetch: numpy leaves out, one call and the leaves'
    bytes counted."""
    _C_FETCH_CALLS.add(1)
    return _to_host(tree)


def cascade_apply_routed(
    tier_fns: Sequence[Callable],
    specs: Sequence[TierSpec],
    batch: dict,
    *,
    pad_to: int = 8,
    device=None,
    transport=None,
    hosts: Optional[Sequence[str]] = None,
) -> CascadeResult:
    """Device-routed cascade with on-device compaction between tiers.

    ``batch`` is a dict of arrays with a leading example axis; it moves to
    ``device`` once and is never gathered back.  Cost accounting charges
    ``spec.cost`` per example evaluated, bucket padding included.

    ``transport`` (optional) is a ``serve/transport.py`` backend: one
    transport for every tier boundary, or one a boundary (None entries:
    same-host hops).  Only the compacted deferral payload, padded to its
    bucket cover, with its int32 index map, is sent; batch mode has no
    admission point to overlap the hop with, so its handle is drained at
    once.  ``hosts`` names the tiers' hosts for the hop metering (default:
    the tier names).  The result accumulators stay on ``device``."""
    device = resolve_device(device)
    n = len(tier_fns)
    cur = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
    B = next(iter(cur.values())).shape[0]
    hop_transports = list(transport) if isinstance(transport, (list, tuple)) else [transport] * (n - 1)
    assert len(hop_transports) >= n - 1, (len(hop_transports), n)
    hop_names = list(hosts) if hosts is not None else [s.name for s in specs]

    pred = torch.zeros((B,), dtype=torch.int32, device=device)
    tier_of = torch.full((B,), -1, dtype=torch.int32, device=device)
    scores = torch.zeros((B,), dtype=torch.float32, device=device)
    tier_counts_dev: List[torch.Tensor] = []
    evaluated = np.zeros((n,), np.int64)
    cost = 0.0

    active_idx = torch.arange(B, dtype=torch.int32, device=device)  # local row -> original row
    m = B
    for i, (fn, spec) in enumerate(zip(tier_fns, specs)):
        defer_c, p_c, s_c = [], [], []
        charged = off = 0
        rows = next(iter(cur.values())).shape[0]
        for c in bucket_chunks(m, pad_to):
            take = min(c, m - off)
            if off == 0 and c == rows:
                fed = cur  # the payload is exactly this chunk
            else:
                fed = {k: _pad_rows(v[off:off + take], c) for k, v in cur.items()}
            out = deferral.apply_rule(spec.rule, fn(fed), spec.theta)
            defer_c.append(out.defer[:take])
            p_c.append(out.pred[:take])
            s_c.append(out.score[:take])
            charged += c
            off += take
        defer, p, s = (torch.cat(t) for t in (defer_c, p_c, s_c))
        evaluated[i] = charged
        cost += spec.cost * charged

        last = i == n - 1
        take_m = ~defer | last
        # answers produced on another host's device move next to the
        # accumulators first (device to device; the same tensors when the
        # tier shares the accumulators' device)
        take_l, p_l, s_l = (t.to(device) for t in (take_m, p, s))
        idx = active_idx.to(device).long()
        pred[idx] = torch.where(take_l, p_l, pred[idx])
        tier_of[idx] = torch.where(take_l, torch.full_like(p_l, i), tier_of[idx])
        scores[idx] = torch.where(take_l, s_l, scores[idx])
        tier_counts_dev.append(take_l.sum().to(torch.int32))
        if last:
            break
        # compaction of the defer path on the device: dense payload + index
        # map straight from the mask (cur may carry bucket-padding rows past
        # the m real ones)
        real = {k: v[:m] for k, v in cur.items()}
        ctree, _, count = compaction_ops.compact_tree({**real, "__idx": active_idx}, defer.to(active_idx.device))
        n_defer = int(host_fetch(count))  # the ONLY per-tier host read
        if n_defer == 0:
            break
        n_padded = min(sum(bucket_chunks(n_defer, pad_to)), m)
        payload = {k: v[:n_padded] for k, v in ctree.items()}
        tr = hop_transports[i]
        if tr is not None:
            payload = tr.send_async(hop_names[i], hop_names[i + 1], payload, n_examples=n_defer).result()
        active_idx = payload.pop("__idx")[:n_defer]
        cur = payload
        m = n_defer

    while len(tier_counts_dev) < n:
        tier_counts_dev.append(torch.zeros((), dtype=torch.int32, device=device))
    pred_h, tier_h, scores_h, counts_h = host_fetch((pred, tier_of, scores, tier_counts_dev))
    return CascadeResult(
        pred=pred_h,
        tier_of=tier_h,
        scores=scores_h,
        tier_counts=np.asarray(counts_h, np.int64),
        evaluated=evaluated,
        cost=cost,
    )

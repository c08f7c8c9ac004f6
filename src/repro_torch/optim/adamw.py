"""AdamW with global-norm clipping (port of ``repro.optim.adamw``); optional
bf16 moments for the low-memory variant.

Plain functions on nested dicts of tensors, with the reference's arithmetic
rather than ``torch.optim.AdamW``'s: the clip scale is
min(1, clip_norm / (norm + 1e-9)); the bias corrections come from the int32
step ``count``; every update runs in f32 and is cast back to the
parameter's dtype; weight decay applies to every leaf, norms included; the
moments are stored in ``moment_dtype``.  The leaf updates go through the
multi-tensor ``torch._foreach_*`` calls, which compute the same values as
the per-leaf expressions (one kernel for many leaves).  The metrics are
device tensors: nothing is read back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.params import torch_dtype, tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"  # 'bfloat16' for the low-memory variant


def adamw_init(params, cfg: OptimConfig):
    mdt = torch_dtype(cfg.moment_dtype)
    zeros = lambda: tree_unflatten(params, [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in tree_leaves(params)])
    anchor = tree_leaves(params)[0]
    return {"m": zeros(), "v": zeros(), "count": torch.zeros((), dtype=torch.int32, device=anchor.device)}


GROUP_ELEMENTS = 1 << 26  # elements an update or a norm takes at once: bounds its f32 temporaries


def _pieces(leaves, limit: int):
    """Every leaf flattened and cut into consecutive slices of at most
    ``limit`` elements: (leaf index, start, stop)."""
    return [(i, a, min(a + limit, t.numel())) for i, t in enumerate(leaves)
            for a in range(0, max(t.numel(), 1), limit)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, a slice of at most
    ``GROUP_ELEMENTS`` at a time (each slice's f32 square is a temporary)."""
    flat = [g.reshape(-1) for g in tree_leaves(tree)]
    sq = [flat[i][a:b].float().square().sum() for i, a, b in _pieces(flat, GROUP_ELEMENTS)]
    return torch.stack(sq).sum().sqrt()


def _groups(sizes, limit: int = GROUP_ELEMENTS):
    """Consecutive index ranges of leaves whose element counts sum to at most
    ``limit`` (a larger leaf alone)."""
    out, lo, acc = [], 0, 0
    for i, n in enumerate(sizes):
        if i > lo and acc + n > limit:
            out.append(range(lo, i))
            lo, acc = i, 0
        acc += n
    if lo < len(sizes):
        out.append(range(lo, len(sizes)))
    return out


def adamw_update(grads, state, params, cfg: OptimConfig, lr_scale=1.0):
    """Returns (params, state, metrics {grad_norm, lr}) with the new values
    written into the tensors of ``params`` and ``state`` (under no_grad):
    the JAX package returns new trees of the same values; updating in place
    keeps a train step from holding two copies of the moments (at
    qwen2.5-3b's width, 27 GB of f32 moments a copy).  A leaf larger than
    ``GROUP_ELEMENTS`` is updated a slice at a time (at that width a
    36-layer MLP stack holds 812 M elements, 3 GiB for each f32 temporary);
    the parameters and moments must be contiguous."""
    flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
    flat_m, flat_v = tree_leaves(state["m"]), tree_leaves(state["v"])
    pieces = _pieces(flat_p, GROUP_ELEMENTS)

    def cut(leaves):
        return [leaves[i][a:b] for i, a, b in pieces]

    flat_g = cut([g.reshape(-1) for g in flat_g])  # a gradient may be a non-contiguous view: copied once
    flat_p, flat_m, flat_v = (cut([t.view(-1) for t in leaves]) for leaves in (flat_p, flat_m, flat_v))
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) if cfg.clip_norm is not None else None

    count = state["count"] + 1
    cf = count.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device), cf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device), cf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=cf.device)

    with torch.no_grad():
        for idx in _groups([p.numel() for p in flat_p], GROUP_ELEMENTS):
            g = [flat_g[i] for i in idx]
            if scale is not None:  # the clip multiplies in the gradient's own dtype
                g = [x * scale.to(x.dtype) for x in g]
            gf = [x.float() for x in g]
            pf = [flat_p[i].float() for i in idx]
            # m = m b1 + g (1 - b1); v = v b2 + g^2 (1 - b2)
            mf = torch._foreach_add(torch._foreach_mul([flat_m[i].float() for i in idx], cfg.b1),
                                    torch._foreach_mul(gf, 1 - cfg.b1))
            vf = torch._foreach_add(torch._foreach_mul([flat_v[i].float() for i in idx], cfg.b2),
                                    torch._foreach_mul(torch._foreach_mul(gf, gf), 1 - cfg.b2))
            del gf
            # step = (m / b1c) / (sqrt(v / b2c) + eps) + wd p;  p' = p - lr step
            den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(vf, b2c)), cfg.eps)
            step = torch._foreach_div(torch._foreach_div(mf, b1c), den)
            del den
            step = torch._foreach_add(step, torch._foreach_mul(pf, cfg.weight_decay))
            pf = torch._foreach_sub(pf, torch._foreach_mul(step, lr))
            del step
            for j, i in enumerate(idx):  # into the leaves' slices; copy_ casts to the leaf's dtype
                flat_p[i].copy_(pf[j])
                flat_m[i].copy_(mf[j])
                flat_v[i].copy_(vf[j])
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}

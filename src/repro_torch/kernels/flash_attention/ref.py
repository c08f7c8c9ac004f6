"""Naive oracle for flash attention (port of
``repro.kernels.flash_attention.ref``): expands KV heads and materialises
the full logits; fully-masked rows come out as zeros."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, starts=None):
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qf = q.float() / math.sqrt(hd)
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= (rows - cols) < window
    mask = mask[None].expand(B, Sq, Sk)
    if starts is not None:
        mask = mask & (cols[None] >= starts.to(q.device)[:, None, None])
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, -1), nan=0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)

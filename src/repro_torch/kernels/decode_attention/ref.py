"""Naive oracle for single-token GQA decode attention (port of
``repro.kernels.decode_attention.ref``), over the kernel-native cache
layout (B, KVH, S, hd)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def decode_attention_ref(q, k_cache, v_cache, cur_len, *, window: Optional[int] = None,
                         softcap: Optional[float] = None, starts=None):
    B, _, H, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qf = q.float()[:, 0] / math.sqrt(hd)  # (B, H, hd)
    kf = k_cache.float().repeat_interleave(G, dim=1)  # (B, H, S, hd)
    vf = v_cache.float().repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", qf, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(S, device=q.device)
    cur = torch.as_tensor(cur_len, device=q.device).expand(B)
    mask = cols[None] < cur[:, None]
    if window is not None:
        mask &= cols[None] >= (cur - window)[:, None]
    if starts is not None:
        mask &= cols[None] >= starts.to(q.device)[:, None]
    s = s.masked_fill(~mask[:, None], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, -1), nan=0.0)
    return torch.einsum("bhs,bhsd->bhd", p, vf)[:, None].to(q.dtype)

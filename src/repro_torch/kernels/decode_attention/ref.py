"""Naive oracles for single-token GQA decode attention (port of
``repro.kernels.decode_attention.ref``), over the kernel-native cache
layout (B, KVH, S, hd) and over a block-paged pool."""
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


def decode_attention_paged_ref(q, k_pool, v_pool, pages, cur_len, *, window: Optional[int] = None,
                               softcap: Optional[float] = None):
    """Paged oracle: gather each slot's pages of the (P, KVH, page_size, hd)
    pools into a dense (B, KVH, n_pg * page_size, hd) view (unmapped -1
    entries as zero rows) and defer to the dense oracle."""
    P, KVH, ps, hd = k_pool.shape
    B, n_pg = pages.shape
    safe = torch.where(pages >= 0, pages, 0).long()
    mapped = (pages >= 0)[:, :, None, None, None]

    def view(pool):
        rows = torch.where(mapped, pool[safe], torch.zeros((), dtype=pool.dtype))  # (B, n_pg, KVH, ps, hd)
        return rows.permute(0, 2, 1, 3, 4).reshape(B, KVH, n_pg * ps, hd)

    return decode_attention_ref(q, view(k_pool), view(v_pool), cur_len, window=window, softcap=softcap)

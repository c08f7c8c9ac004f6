"""Flash attention (prefill, forward only).

``flash_attention(q, k, v)`` with q (B, Sq, H, hd) and k, v (B, Sk, KVH,
hd) — the JAX package's public layout.  Causal masking, sliding window,
tanh softcap and per-row ``starts`` (the left-pad carve-out: row b attends
no column < starts[b]; rows that are pure padding emit zeros).

On a CUDA tensor it launches ``csrc/flash_attention.cu`` (bf16, hd in
{64, 80, 128}, any Sq and Sk), which replaces
``src/repro/kernels/flash_attention/kernel.py`` ``flash_attention_bhsd``;
its bound is the tensor-core operations for long prompts and the q/k/v/out
bytes for short ones.  On a CPU tensor the plain version runs — the same
masked softmax as the JAX package's ``impl='xla'`` path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_LAUNCHES = build.launch_counter("flash_attention")
NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None, starts=None):
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= (rows - cols) < window
    if starts is not None:
        maskb = mask[None] & (cols[None] >= starts[:, None, None])  # (B, Sq, Sk)
        s = torch.where(maskb[:, None, None], s, NEG_INF)
    elif causal or window is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, -1)
    if starts is not None:
        p = torch.where(maskb[:, None, None], p, 0.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def _flash_cuda(q, k, v, *, causal, window, softcap, starts):
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require_cuda(t, f"flash_attention {name}", (torch.bfloat16,))
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if hd not in (64, 80, 128) or H % KVH or k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    if starts is not None:
        starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    rc = lib.flash_attention_fwd(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        ctypes.c_void_p(None if starts is None else starts.data_ptr()),
        ctypes.c_int(B), ctypes.c_int(Sq), ctypes.c_int(Sk), ctypes.c_int(H),
        ctypes.c_int(KVH), ctypes.c_int(hd), ctypes.c_int(int(causal)),
        ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_float(1.0 / math.sqrt(hd)), build.stream_ptr(q),
    )
    build.check(lib, rc, "flash_attention_fwd")
    _LAUNCHES.add(1)
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    starts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap, starts=starts
        )
    return _flash_cuda(q, k, v, causal=causal, window=window, softcap=softcap, starts=starts)

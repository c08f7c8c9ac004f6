"""Decode attention over the kernel-native dense cache layout.

``decode_attention_bksd(q, k_cache, v_cache, cur_len)`` — q (B, 1, H, hd),
caches (B, KVH, S, hd), ``cur_len`` a scalar or (B,) count of valid cache
rows, optional ``starts`` (B,) (cache columns before a row's prompt start
stay invisible), sliding window and tanh softcap.

On a CUDA tensor it launches ``csrc/decode_attention.cu`` (bf16, hd in
{64, 128}, G = H / KVH in {1, 2, 4, 8, 16}, any S), which replaces
``src/repro/kernels/decode_attention/kernel.py`` ``decode_attention_bkgd``
and is bound by the cache bytes it reads.  On a CPU tensor the plain
version runs — the JAX package's ``_xla_decode_bksd``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_LAUNCHES = build.launch_counter("decode_attention")
NEG_INF = -1e30


def decode_attention_plain(q, k_cache, v_cache, cur_len, *, window=None, softcap=None, starts=None):
    B, _, H, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = q.reshape(B, KVH, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(S, device=q.device)
    cur = torch.as_tensor(cur_len, device=q.device)
    if cur.ndim == 0:
        mask = (cols < cur)[None, :]
    else:
        mask = cols[None, :] < cur[:, None]
    if window is not None:
        lo = (cur - window)[..., None] if cur.ndim else cur - window
        mask = mask & (cols[None, :] >= lo)
    if starts is not None:
        mask = mask & (cols[None, :] >= starts[:, None])
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, -1)
    if starts is not None:
        p = torch.where(mask[:, None, None, :], p, 0.0)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _decode_cuda(q, k_cache, v_cache, cur_len, *, window, softcap, starts):
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        build.require_cuda(t, f"decode_attention {name}", (torch.bfloat16,))
    B, _, H, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    if (hd not in (64, 128) or G not in (1, 2, 4, 8, 16) or H % KVH
            or k_cache.shape != v_cache.shape or k_cache.shape[0] != B):
        raise ValueError(
            f"decode_attention: unsupported shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)}"
        )
    if isinstance(cur_len, int):  # shared position: passed by value, no host->device copy
        cur, cur_scalar = None, cur_len
    else:
        cur = torch.as_tensor(cur_len, device=q.device).to(torch.int32).expand(B).contiguous()
        cur_scalar = 0
    if starts is not None:
        starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = build.library("decode_attention")
    rc = lib.decode_attention_fwd(
        build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), build.ptr(out),
        ctypes.c_void_p(None if cur is None else cur.data_ptr()), ctypes.c_int(cur_scalar),
        ctypes.c_void_p(None if starts is None else starts.data_ptr()),
        ctypes.c_int(B), ctypes.c_int(KVH), ctypes.c_int(G), ctypes.c_int(S), ctypes.c_int(hd),
        ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_float(1.0 / math.sqrt(hd)), build.stream_ptr(q),
    )
    build.check(lib, rc, "decode_attention_fwd")
    _LAUNCHES.add(1)
    return out


def decode_attention_bksd(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    starts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, cur_len, window=window, softcap=softcap, starts=starts
        )
    return _decode_cuda(q, k_cache, v_cache, cur_len, window=window, softcap=softcap, starts=starts)

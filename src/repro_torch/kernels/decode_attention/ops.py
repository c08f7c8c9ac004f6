"""Decode attention over the kernel-native dense cache layout and over
block-paged KV pools.

``decode_attention_bksd(q, k_cache, v_cache, cur_len)`` — q (B, 1, H, hd),
caches (B, KVH, S, hd), ``cur_len`` a scalar or (B,) count of valid cache
rows, optional ``starts`` (B,) (cache columns before a row's prompt start
stay invisible), sliding window and tanh softcap.

``decode_attention_paged(q, k_pool, v_pool, pages, cur_len)`` — pools
(P, KVH, page_size, hd) shared by every slot, ``pages`` the (B, n_pg)
int32 page table (-1 = unmapped, reads as zero rows), ``cur_len`` (B,).
The pools may carry a leading member axis, (E, P, KVH, page_size, hd),
with q (E*B, 1, H, hd): row r of q is slot r % B of member plane r // B,
and the ONE table serves every plane.  No ``starts``.

On a CUDA tensor each launches its kernel of ``csrc/decode_attention.cu``
(hd a multiple of 8 from 8 to 128, zero-padded to the next of the built
widths 32, 64, 80 and 128; G = H / KVH from 1 to ``MAX_GROUP``; any S or
page_size; bf16 on the tensor cores or f32 on the SIMT cores, the inputs
never rounded), which replace
``src/repro/kernels/decode_attention/kernel.py`` ``decode_attention_bkgd``
and ``decode_attention_paged_bkgd``; both are bound by the cache bytes
they read.  Any other shape or dtype raises: there is no fallback.  On a
CPU tensor the plain versions run — the JAX package's
``_xla_decode_bksd`` and ``_xla_decode_paged`` (gather each slot's view
of exactly ``n_pg * page_size`` rows, then the dense sweep).  On a meta
tensor (the dry run) nothing is computed: each returns the output's shape
and charges the active op counter its ``cost`` (``paged_cost``), every
cache row counted where ``cur_len`` is unknown.  Both kernels are inference-only: a CUDA input that
requires grad under grad mode raises (``build.inference_only``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.obs import op_charges
from repro_torch.kernels.compaction.ops import gather_rows_plain, member_pool, paged_pool_view
from repro_torch.kernels.flash_attention.ops import head_size_ok, same_dtype

# the largest head group the kernels take: the bf16 body pads G to 16 MMA rows
MAX_GROUP = 16
_LAUNCHES = build.launch_counter("decode_attention")
_PAGED_LAUNCHES = build.launch_counter("decode_attention_paged")
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
    build.inference_only("decode_attention", q, k_cache, v_cache)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        build.require_cuda(t, f"decode_attention {name}", same_dtype(q))
    B, _, H, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    if (not head_size_ok(hd) or not 1 <= G <= MAX_GROUP or H % KVH or k_cache.shape[3] != hd
            or k_cache.shape != v_cache.shape or k_cache.shape[0] != B):
        raise ValueError(
            f"decode_attention: unsupported shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)} "
            f"(hd a multiple of 8 from 8 to 128, G = H / KVH from 1 to {MAX_GROUP})"
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
    rc = (lib.decode_attention_fwd_f32 if q.dtype == torch.float32 else lib.decode_attention_fwd)(
        build.ptr(q), build.ptr(k_cache), build.ptr(v_cache), build.ptr(out),
        ctypes.c_void_p(None if cur is None else cur.data_ptr()), ctypes.c_int(cur_scalar),
        ctypes.c_void_p(None if starts is None else starts.data_ptr()),
        ctypes.c_int(B), ctypes.c_int(KVH), ctypes.c_int(G), ctypes.c_int(S), ctypes.c_int(hd),
        ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_float(1.0 / math.sqrt(hd)), build.stream_ptr(q),
    )
    build.check(lib, rc, f"decode_attention_fwd ({q.dtype})")
    _LAUNCHES.add(1)
    return out


def _rows_len(cur_len, B: int, S: int, window=None) -> int:
    """Cache rows a call reads over its B rows: each row's ``cur_len``
    (every row of the cache where it is unknown, a meta tensor), at most
    the window."""
    if isinstance(cur_len, torch.Tensor) and cur_len.device.type == "meta":
        cur = np.full(B, S, np.int64)
    else:
        cur = np.broadcast_to(np.asarray(cur_len.cpu() if isinstance(cur_len, torch.Tensor) else cur_len,
                                         np.int64), (B,))
    if window:
        cur = np.minimum(cur, window)
    return int(cur.sum())


def cost(q, k_cache, v_cache, cur_len, *, window=None) -> dict:
    """A dense call's work: q read and the output written, the K and V rows
    of every row's ``cur_len`` read once; 4·hd operations a visible row and
    head."""
    B, _, H, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    rows = _rows_len(cur_len, B, S, window)
    return build.kernel_cost(2 * build.nbytes(q) + 2 * rows * KVH * hd * k_cache.element_size(), 4 * H * rows * hd,
                             "bf16" if q.dtype == torch.bfloat16 else "f32")


def paged_cost(q, k_pool, v_pool, pages, cur_len, *, window=None) -> dict:
    """A paged call's work: q read and the output written, every member
    plane's K and V rows of each slot's ``cur_len`` read once, the table
    and the lengths read; 4·hd operations a visible row and head."""
    E, P, KVH, ps, hd = member_pool(k_pool).shape
    B, n_pg = pages.shape
    H = q.shape[2]
    visible = E * _rows_len(cur_len, B, n_pg * ps, window)
    return build.kernel_cost(2 * build.nbytes(q) + 2 * visible * KVH * hd * k_pool.element_size()
                             + build.nbytes(pages, cur_len), 4 * H * hd * visible,
                             "bf16" if q.dtype == torch.bfloat16 else "f32")


def _decode_meta(q, k_cache, v_cache, cur_len, *, window, softcap, starts):
    op_charges.charge_kernel("decode_attention", cost(q, k_cache, v_cache, cur_len, window=window))
    return torch.empty_like(q)


def _paged_meta(q, k_pool, v_pool, pages, cur_len, *, window):
    op_charges.charge_kernel("decode_attention_paged", paged_cost(q, k_pool, v_pool, pages, cur_len, window=window))
    return torch.empty_like(q)


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
    if q.device.type == "meta":
        return op_charges.meta_call(_decode_meta, q, k_cache, v_cache, cur_len, kv_head_dim=1, window=window,
                                    softcap=softcap, starts=starts)
    return _decode_cuda(q, k_cache, v_cache, cur_len, window=window, softcap=softcap, starts=starts)


# ---------------------------------------------------------------------------
# block-paged pools
# ---------------------------------------------------------------------------


def decode_attention_paged_plain(q, k_pool, v_pool, pages, cur_len, *, window=None, softcap=None):
    E = member_pool(k_pool).shape[0]
    cur = torch.as_tensor(cur_len, device=q.device).reshape(-1).repeat(E)
    return decode_attention_plain(
        q, paged_pool_view(k_pool, pages, gather_rows_plain),
        paged_pool_view(v_pool, pages, gather_rows_plain), cur, window=window, softcap=softcap,
    )


def _paged_cuda(q, k_pool, v_pool, pages, cur_len, *, window, softcap):
    build.inference_only("decode_attention_paged", q, k_pool, v_pool)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        build.require_cuda(t, f"decode_attention_paged {name}", same_dtype(q))
    # the table and positions must already be on the card: the caller moves
    # them once per decode step, not once per layer
    build.require_cuda(pages, "decode_attention_paged pages", (torch.int32,), align=4)
    build.require_cuda(cur_len, "decode_attention_paged cur_len", (torch.int32,), align=4)
    pool = member_pool(k_pool)
    E, P, KVH, ps, hd = pool.shape
    B, n_pg = pages.shape
    H = q.shape[2]
    G = H // KVH
    if not head_size_ok(hd) or not 1 <= G <= MAX_GROUP or H % KVH or q.shape[3] != hd:
        raise ValueError(
            f"decode_attention_paged: unsupported shapes q {tuple(q.shape)} pool {tuple(k_pool.shape)} "
            f"(hd a multiple of 8 from 8 to 128, G = H / KVH from 1 to {MAX_GROUP})"
        )
    out = torch.empty_like(q)
    lib = build.library("decode_attention")
    rc = (lib.decode_attention_paged_fwd_f32 if q.dtype == torch.float32 else lib.decode_attention_paged_fwd)(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool), build.ptr(out),
        build.ptr(cur_len), build.ptr(pages),
        ctypes.c_int(E), ctypes.c_int(B), ctypes.c_int(P), ctypes.c_int(KVH), ctypes.c_int(G),
        ctypes.c_int(ps), ctypes.c_int(n_pg), ctypes.c_int(hd),
        ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_float(1.0 / math.sqrt(hd)), build.stream_ptr(q),
    )
    build.check(lib, rc, f"decode_attention_paged_fwd ({q.dtype})")
    _PAGED_LAUNCHES.add(1)
    return out


def decode_attention_paged(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pages: torch.Tensor,
    cur_len: torch.Tensor,
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention against block-paged pools; see the module
    docstring for the layouts."""
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"pool mismatch: k {tuple(k_pool.shape)} v {tuple(v_pool.shape)}")
    if q.shape[0] != member_pool(k_pool).shape[0] * pages.shape[0] or cur_len.shape != pages.shape[:1]:
        raise ValueError(
            f"decode_attention_paged: q {tuple(q.shape)}, pool {tuple(k_pool.shape)}, page table "
            f"{tuple(pages.shape)} and cur_len {tuple(cur_len.shape)} do not agree"
        )
    if q.device.type == "cpu":
        return decode_attention_paged_plain(
            q, k_pool, v_pool, pages, cur_len, window=window, softcap=softcap
        )
    if q.device.type == "meta":
        return op_charges.meta_call(_paged_meta, q, k_pool, v_pool, pages, cur_len, window=window)
    return _paged_cuda(q, k_pool, v_pool, pages, cur_len, window=window, softcap=softcap)

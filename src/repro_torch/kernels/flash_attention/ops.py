"""Flash attention (prefill), with the training gradient.

``flash_attention(q, k, v)`` with q (B, Sq, H, hd) and k, v (B, Sk, KVH,
hd) — the JAX package's public layout.  Causal masking, sliding window,
tanh softcap and per-row ``starts`` (the left-pad carve-out: row b attends
no column < starts[b]; rows that are pure padding emit zeros).

On a CUDA tensor it launches ``csrc/flash_attention.cu``, which replaces
``src/repro/kernels/flash_attention/kernel.py`` ``flash_attention_bhsd``:
any Sq and Sk, any GQA group, any hd up to ``MAX_HEAD``: to 256 in bf16 or
f16 on the tensor cores (built at widths 32, 64, 80, 128 and 256; a
smaller hd runs zero-padded to the next inside the kernel, and an hd off
the multiples of 8 is zero-padded to one here first: the scale stays
1/sqrt of the real hd) or in f32 on the SIMT cores (plain FFMA: the inputs
are not rounded, as the reference computes them in f32); past 256, in any
of the three, a SIMT body that takes a query row a block and its keys one
at a time (``attention_common.cuh`` ``attend_any``: no published
configuration has such heads, and no speed is claimed for it).  Its bound
is the tensor-core operations for long prompts and the q/k/v/out bytes
for short ones.  Inputs of two of those types run in f32, the output in q's type.
Any other shape or dtype raises: there is no fallback.  On a CPU tensor the
plain version runs — the same masked softmax as the JAX package's
``impl='xla'`` path.  On a meta tensor (the dry run, ``launch/dryrun.py``)
it computes nothing: it returns the output's shape and charges the active
op counter ``cost(...)``, the work the kernel would do
(``obs.op_charges.meta_call``: the dry run's ``DTensor`` inputs are taken
by each rank's rows and heads).

Training: when grad mode is on and q, k or v requires grad,
``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``, the port of the JAX package's ``_flash_diff``
custom VJP).  Its forward is the kernel with its log-sum-exp output on a
CUDA tensor (the plain version with ``return_lse`` on a CPU tensor); its
backward (``flash_attention_bwd``) is plain PyTorch on both devices, the
port of ``_flash_diff_bwd``: per block of up to 512 queries it recomputes
P = exp(s - lse), with delta = sum(dO * O), the softcap's 1 - tanh^2 factor
and the causal and window masks, and accumulates dk and dv across blocks
(no (Sq, Sk) matrix in either direction).  A backward kernel is later
work.  ``starts`` (the serving carve-out) is inference-only, as in the
JAX package, and raises under grad.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.obs import op_charges

_LAUNCHES = build.launch_counter("flash_attention")
DTYPES = (torch.bfloat16, torch.float16, torch.float32)  # the kernels' routes: tensor cores (two), SIMT f32
BUILT_HEAD = 256  # the widest head the tiled bodies are built for (Gemma 2 and 3)
MAX_HEAD = 28 * 1024  # the widest attend_any takes: q and the f32 output (8 bytes a column) in shared memory
NEG_INF = -1e30
BWD_BLOCK_Q = 512  # the backward's query block, ``_flash_diff_bwd``'s constant


def _mask(Sq: int, Sk: int, causal: bool, window, device, q0: int = 0):
    """(rows, Sk) visibility of query positions [q0, q0 + rows)."""
    rows = q0 + torch.arange(Sq, device=device)[:, None]
    cols = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= (rows - cols) < window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None, starts=None, return_lse=False):
    """The masked softmax in f32; with ``return_lse`` also each row's
    log-sum-exp of its scaled (softcapped) scores, f32 (B, Sq, H), the
    masked scores counted at -1e30 as in the JAX package."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qg = q.reshape(B, Sq, KVH, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(Sq, Sk, causal, window, q.device)
    if starts is not None:
        cols = torch.arange(Sk, device=q.device)[None, :]
        maskb = mask[None] & (cols[None] >= starts[:, None, None])  # (B, Sq, Sk)
        s = torch.where(maskb[:, None, None], s, NEG_INF)
    elif causal or window is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, -1)
    if starts is not None:
        p = torch.where(maskb[:, None, None], p, 0.0)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()).reshape(B, Sq, H, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, -1).permute(0, 3, 1, 2).reshape(B, Sq, H)
    return o


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, window=None, softcap=None):
    """(dq, dk, dv) of the attention output, in q's, k's and v's dtypes:
    the port of the JAX package's ``_flash_diff_bwd``, plain PyTorch on
    every device.  Over blocks of ``min(BWD_BLOCK_Q, Sq)`` queries (the last
    may be shorter) it recomputes P = exp(s - lse) from (q, k, lse) in f32,
    ds = P (dP - delta) with delta = sum(dO * O) (times 1 - tanh^2 under a
    softcap), and accumulates dk and dv."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(hd)
    bq_max = min(BWD_BLOCK_Q, Sq)
    kf, vf = k.float(), v.float()
    delta = (do.float() * out.float()).sum(-1)  # (B, Sq, H)
    dq = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, KVH, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, bq_max):
        bq = min(bq_max, Sq - q0)
        blk = lambda t: t[:, q0:q0 + bq].float().reshape((B, bq, KVH, G) + tuple(t.shape[3:]))
        qb, dob = blk(q), blk(do)
        db, lb = blk(delta).permute(0, 2, 3, 1)[..., None], blk(lse).permute(0, 2, 3, 1)[..., None]
        s = torch.einsum("bqkgd,bskd->bkgqs", qb * scale, kf)
        dcap = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s, dcap = softcap * t, 1.0 - t.square()
        if causal or window is not None:
            s = torch.where(_mask(bq, Sk, causal, window, q.device, q0), s, NEG_INF)
        p = torch.exp(s - lb)  # (B, KVH, G, bq, Sk)
        dv += torch.einsum("bkgqs,bqkgd->bskd", p, dob)
        ds = p * (torch.einsum("bqkgd,bskd->bkgqs", dob, vf) - db)
        if dcap is not None:
            ds = ds * dcap
        dq[:, q0:q0 + bq] = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(B, bq, H, hd) * scale
        dk += torch.einsum("bkgqs,bqkgd->bskd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def visible_pairs(Sq: int, Sk: int, causal: bool, window=None) -> int:
    """(query, key) pairs the masks leave visible, of one (row, head):
    query i sees keys j < Sk with j <= i (causal) and i - j < window."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Sk - 1) if causal else np.full(Sq, Sk - 1, np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(q, k, v, *, causal=True, window=None, return_lse=False) -> dict:
    """A call's work: q, k and v read once, the output (and the lse) written
    once; 4·hd operations a visible (query, key) pair and head (the two
    products), on the tensor cores in bf16, the CUDA cores in f32.  A row's
    ``starts`` hides more: this counts the masks' pairs."""
    B, Sq, H, hd = q.shape
    pairs = B * H * visible_pairs(Sq, k.shape[1], causal, window)
    out = build.nbytes(q) + (B * Sq * H * 4 if return_lse else 0)
    return build.kernel_cost(build.nbytes(q, k, v) + out, 4 * hd * pairs, unit_of(q.dtype))


def _flash_meta(q, k, v, *, causal, window, return_lse=False):
    op_charges.charge_kernel("flash_attention", cost(q, k, v, causal=causal, window=window, return_lse=return_lse))
    out = torch.empty_like(q)
    if return_lse:
        return out, q.new_empty(q.shape[:3], dtype=torch.float32)
    return out


def unit_of(dtype) -> str:
    """The unit an attention kernel's operations run on in ``dtype``: the
    tensor cores ('bf16', 'f16': the same peak) or the CUDA cores ('f32')."""
    return {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dtype, "f32")


def head_size_ok(hd: int) -> bool:
    """The head sizes the attention kernels take (flash and decode): 1 to
    ``MAX_HEAD``."""
    return 1 <= hd <= MAX_HEAD


def padded_head(hd: int, dtype) -> int:
    """The head size a kernel runs ``hd`` at: the 16-bit tiled routes copy
    rows of 16 bytes, so their hd goes up to a multiple of 8 (zero columns,
    which add nothing to a dot product); the f32 route and any hd past
    ``BUILT_HEAD`` (``attend_any``) read element by element."""
    return hd if dtype == torch.float32 or hd > BUILT_HEAD else -(-hd // 8) * 8


def pad_head(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``hd`` (itself where it is)."""
    return t if t.shape[-1] == hd else torch.nn.functional.pad(t, (0, hd - t.shape[-1])).contiguous()


def entry_for(lib, fn: str, dtype):
    """The C entry of ``fn`` for ``dtype``: ``fn`` (bf16), ``fn_f16`` or ``fn_f32``."""
    return getattr(lib, fn + {torch.bfloat16: "", torch.float16: "_f16"}.get(dtype, "_f32"))


def same_dtype(q) -> tuple:
    """The dtypes a kernel's other inputs may have: q's, when q's is one of
    ``DTYPES`` (else ``DTYPES``, so that q itself is refused)."""
    return (q.dtype,) if q.dtype in DTYPES else DTYPES


def mixed(*ts) -> bool:
    """Inputs of more than one of ``DTYPES``: a kernel then runs them all in
    f32 (exact: bf16 and f16 widen without rounding, as the plain versions
    compute) and casts its output to q's dtype."""
    types = {t.dtype for t in ts}
    return len(types) > 1 and types <= set(DTYPES)


def _flash_cuda(q, k, v, *, causal, window, softcap, starts, return_lse=False):
    if mixed(q, k, v):
        out = _flash_cuda(q.float(), k.float(), v.float(), causal=causal, window=window, softcap=softcap,
                          starts=starts, return_lse=return_lse)
        return (out[0].to(q.dtype), out[1]) if return_lse else out.to(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require_cuda(t, f"flash_attention {name}", same_dtype(q))
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if not head_size_ok(hd) or H % KVH or k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"(hd from 1 to {MAX_HEAD}, H a multiple of KVH)")
    if starts is not None:
        starts = starts.to(device=q.device, dtype=torch.int32).contiguous()
    hp = padded_head(hd, q.dtype)
    q_in, k, v = pad_head(q, hp), pad_head(k, hp), pad_head(v, hp)
    out = torch.empty_like(q_in)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device) if return_lse else None
    lib = build.library("flash_attention")
    rc = entry_for(lib, "flash_attention_fwd", q.dtype)(
        build.ptr(q_in), build.ptr(k), build.ptr(v), build.ptr(out),
        ctypes.c_void_p(None if lse is None else lse.data_ptr()),
        ctypes.c_void_p(None if starts is None else starts.data_ptr()),
        ctypes.c_int(B), ctypes.c_int(Sq), ctypes.c_int(Sk), ctypes.c_int(H),
        ctypes.c_int(KVH), ctypes.c_int(hp), ctypes.c_int(int(causal)),
        ctypes.c_int(window or 0), ctypes.c_float(softcap or 0.0),
        ctypes.c_float(1.0 / math.sqrt(hd)), build.stream_ptr(q),
    )
    build.check(lib, rc, f"flash_attention_fwd ({q.dtype})")
    _LAUNCHES.add(1)
    if hp != hd:
        out = out[..., :hd].contiguous()
    return (out, lse) if return_lse else out


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is ``flash_attention_bwd``: the forward
    keeps (q, k, v, out, lse), as ``_flash_diff_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap, return_lse=True)
        elif q.device.type == "meta":
            out, lse = _flash_meta(q, k, v, causal=causal, window=window, return_lse=True)
        else:
            out, lse = _flash_cuda(q, k, v, causal=causal, window=window, softcap=softcap, starts=None,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


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
    kw = dict(causal=causal, window=window, softcap=softcap, starts=starts)
    if q.device.type == "meta":  # the dry run: rows and heads are independent, so DTensors go by blocks
        return op_charges.meta_call(_flash_attention, q, k, v, kv_head_dim=2, **kw)
    return _flash_attention(q, k, v, **kw)


def _flash_attention(q, k, v, *, causal, window, softcap, starts):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if starts is not None:
            raise RuntimeError("flash_attention: starts (the left-pad carve-out) is inference-only; "
                               "it has no gradient route")
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap, starts=starts
        )
    if q.device.type == "meta":
        return _flash_meta(q, k, v, causal=causal, window=window)
    return _flash_cuda(q, k, v, causal=causal, window=window, softcap=softcap, starts=starts)

"""Shared building blocks: norms, RoPE, MLP, GQA attention, LM head.

Ports ``repro.models.layers`` for the dense family.  Every function carries
the ensemble axis E explicitly: activations are (E, B, S, ...) and each
parameter leaf has a leading E axis, where the JAX package ``vmap``s a
single-model function.  The weight products are batched matmuls over E
(``torch.einsum``); around the attention kernels E folds into the batch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.params import Initializer


def _per_member(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape an (E, *tail) parameter to broadcast against x (E, ..., *tail)."""
    return w.reshape((w.shape[0],) + (1,) * (x.ndim - w.ndim) + tuple(w.shape[1:]))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(ini: Initializer, cfg: ModelConfig, d: int):
    if cfg.norm_type == "rmsnorm":
        return {"scale": ini.ones((d,), dtype=torch.float32)}
    if cfg.norm_type == "layernorm":
        return {
            "scale": ini.ones((d,), dtype=torch.float32),
            "bias": ini.zeros((d,), dtype=torch.float32),
        }
    if cfg.norm_type == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(p, x, cfg: ModelConfig):
    """Computes in f32 and casts back to x's dtype (as the JAX package)."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * _per_member(p["scale"], xf)
    else:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        if cfg.norm_type == "layernorm":
            y = y * _per_member(p["scale"], xf) + _per_member(p["bias"], xf)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half convention)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(ini: Initializer, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_activation == "silu":
        return {
            "w_gate": ini.normal((d, f)),
            "w_up": ini.normal((d, f)),
            "w_down": ini.normal((f, d)),
        }
    return {
        "w_in": ini.normal((d, f)),
        "b_in": ini.zeros((f,)),
        "w_out": ini.normal((f, d)),
        "b_out": ini.zeros((d,)),
    }


def apply_mlp(p, x, cfg: ModelConfig):
    """x (E, B, S, D)."""
    if cfg.mlp_activation == "silu":
        h = F.silu(torch.einsum("ebsd,edf->ebsf", x, p["w_gate"])) * torch.einsum(
            "ebsd,edf->ebsf", x, p["w_up"]
        )
        return torch.einsum("ebsf,efd->ebsd", h, p["w_down"])
    h = F.gelu(torch.einsum("ebsd,edf->ebsf", x, p["w_in"]) + _per_member(p["b_in"], x), approximate="tanh")
    return torch.einsum("ebsf,efd->ebsd", h, p["w_out"]) + _per_member(p["b_out"], x)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def init_attention(ini: Initializer, cfg: ModelConfig):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ini.normal((d, H, hd)),
        "wk": ini.normal((d, K, hd)),
        "wv": ini.normal((d, K, hd)),
        "wo": ini.normal((H, hd, d), std=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((H, hd))
        p["bk"] = ini.zeros((K, hd))
        p["bv"] = ini.zeros((K, hd))
    if cfg.attn_out_bias:
        p["bo"] = ini.zeros((d,))
    return p


def qkv_project(p, x, cfg: ModelConfig, positions):
    """x (E, B, S, D) -> q (E, B, S, H, hd), k and v (E, B, S, KVH, hd)."""
    q = torch.einsum("ebsd,edhk->ebshk", x, p["wq"])
    k = torch.einsum("ebsd,edhk->ebshk", x, p["wk"])
    v = torch.einsum("ebsd,edhk->ebshk", x, p["wv"])
    if "bq" in p:
        q = q + _per_member(p["bq"], q)
        k = k + _per_member(p["bk"], k)
        v = v + _per_member(p["bv"], v)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_output(p, ctx, cfg: ModelConfig):
    out = torch.einsum("ebshk,ehkd->ebsd", ctx, p["wo"])
    if "bo" in p:
        out = out + _per_member(p["bo"], out)
    return out


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(E, B, ...) -> (E*B, ...) for the attention kernels."""
    return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


def attention_layer(p, x, cfg: ModelConfig, *, causal: bool, positions=None,
                    sliding_window: Optional[int] = None, starts=None):
    """Full-sequence (prefill) attention.  ``starts`` (B,) is the left-pad
    carve-out: row b attends no column < starts[b]; callers pass positions
    taken relative to it.  Returns (out, (k, v))."""
    E, B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = qkv_project(p, x, cfg, positions)
    ctx = flash_ops.flash_attention(
        _fold(q), _fold(k), _fold(v), causal=causal, window=sliding_window,
        softcap=cfg.attn_logit_softcap,
        starts=None if starts is None else starts.repeat(E),
    )
    return attn_output(p, ctx.reshape(q.shape), cfg), (k, v)


def attention_decode(p, x, cfg: ModelConfig, k_cache, v_cache, cur_index: int, *,
                     sliding_window: Optional[int] = None, starts=None):
    """Single-token decode at a shared scalar position.  Caches (E, B, KVH,
    S_max, hd) are the kernel-native layout, updated IN PLACE at row
    ``cur_index`` (the JAX package returns new caches; writing one row in
    place saves a copy of the whole cache per step).  Returns out."""
    E, B = x.shape[:2]
    positions = torch.full((B, 1), int(cur_index), device=x.device)
    if starts is not None:
        positions = positions - starts[:, None]
    q, k, v = qkv_project(p, x, cfg, positions)
    k_cache[:, :, :, cur_index, :] = k[:, :, 0].to(k_cache.dtype)
    v_cache[:, :, :, cur_index, :] = v[:, :, 0].to(v_cache.dtype)
    ctx = dec_ops.decode_attention_bksd(
        _fold(q), _fold(k_cache), _fold(v_cache), cur_len=int(cur_index) + 1,
        window=sliding_window, softcap=cfg.attn_logit_softcap,
        starts=None if starts is None else starts.repeat(E),
    )
    return attn_output(p, ctx.reshape(q.shape), cfg)


def project_logits(params, x, cfg: ModelConfig):
    """Final norm + LM head: x (E, ..., D) -> f32 logits (E, ..., V).  The
    product runs in the weights' dtype and is cast to f32 afterwards."""
    x = apply_norm(params["final_norm"], x, cfg)
    head = params["lm_head"] if "lm_head" in params else params["embed"].transpose(-1, -2)
    E, D = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(E, -1, D), head)
    return out.reshape(tuple(x.shape[:-1]) + (head.shape[-1],)).float()

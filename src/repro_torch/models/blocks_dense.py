"""Transformer layer (dense, MoE and encoder flavours): prefill, decode,
chunked prefill and their block-paged forms (port of
``repro.models.blocks_dense``).  A layer whose parameters hold ``moe``
runs the MoE block where the others run the MLP."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import Initializer
from repro_torch.sharding.logical import constrain


def init_dense_layer(ini: Initializer, cfg: ModelConfig, *, moe: bool = False):
    p = {
        "ln1": L.init_norm(ini, cfg, cfg.d_model),
        "attn": L.init_attention(ini, cfg),
        "ln2": L.init_norm(ini, cfg, cfg.d_model),
    }
    if moe:
        p["moe"] = L.init_moe(ini, cfg)
    else:
        p["mlp"] = L.init_mlp(ini, cfg)
    return p


def _mlp_residual(p, x, cfg: ModelConfig, *, with_aux: bool = False):
    """x + MLP (or MoE) of the normed x; with ``with_aux`` (x, aux), aux
    the MoE's (E,) load-balancing term (zeros for an MLP layer)."""
    h = L.apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        out = L.apply_moe(p["moe"], h, cfg, with_aux=with_aux)
        if with_aux:
            return x + out[0], out[1]
        return x + out
    x = constrain(x + L.apply_mlp(p["mlp"], h, cfg), ("act_ensemble", "act_batch", "act_seq", "act_embed"))
    return (x, x.new_zeros((x.shape[0],), dtype=torch.float32)) if with_aux else x


def dense_layer_fwd(p, x, cfg: ModelConfig, *, causal: bool = True,
                    sliding_window: Optional[int] = None, positions=None, starts=None,
                    with_aux: bool = False):
    """Full-sequence forward.  Returns (x, (k, v)); with ``with_aux`` (the
    training forward) (x, aux (E,) f32, (k, v)), as the JAX package's
    ``dense_layer_fwd`` returns (x, aux, kv)."""
    h, kv = L.attention_layer(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, causal=causal,
        positions=positions, sliding_window=sliding_window, starts=starts,
    )
    if with_aux:
        x, aux = _mlp_residual(p, x + h, cfg, with_aux=True)
        return x, aux, kv
    return _mlp_residual(p, x + h, cfg), kv


def dense_layer_decode(p, x, cfg: ModelConfig, k_cache, v_cache, cur_index, *,
                       sliding_window: Optional[int] = None, starts=None):
    """Single-token decode at a scalar or per-slot (B,) position.
    x (E, B, 1, D); caches updated in place."""
    x = x + L.attention_decode(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, k_cache, v_cache, cur_index,
        sliding_window=sliding_window, starts=starts,
    )
    return _mlp_residual(p, x, cfg)


def dense_layer_prefill_chunk(p, x, cfg: ModelConfig, k_cache, v_cache, slot, start, *,
                              sliding_window: Optional[int] = None):
    """Chunked prefill for one slot.  x (E, 1, C, D); the layer's
    (E, n_slots, KVH, S_max, hd) caches are written in place; ``slot`` and
    ``start`` (1,) int64 device tensors."""
    x = x + L.attention_prefill_chunk(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, k_cache, v_cache, slot, start,
        sliding_window=sliding_window,
    )
    return _mlp_residual(p, x, cfg)


def dense_layer_prefill_chunk_paged(p, x, cfg: ModelConfig, k_pool, v_pool, start, pages_row, *,
                                    sliding_window: Optional[int] = None):
    """Chunked prefill for one slot against the layer's (E, P, KVH,
    page_size, hd) pools, through the slot's (n_pg,) table row; ``start`` a
    (1,) int64 device tensor."""
    x = x + L.attention_prefill_chunk_paged(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, k_pool, v_pool, start, pages_row,
        sliding_window=sliding_window,
    )
    return _mlp_residual(p, x, cfg)


def dense_layer_decode_paged(p, x, cfg: ModelConfig, k_pool, v_pool, step: L.PagedStep, *,
                             sliding_window: Optional[int] = None):
    """Single-token decode against the layer's paged pools.  x (E, B, 1, D)."""
    x = x + L.attention_decode_paged(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, k_pool, v_pool, step,
        sliding_window=sliding_window,
    )
    return _mlp_residual(p, x, cfg)

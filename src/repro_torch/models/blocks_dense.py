"""Dense transformer layer: prefill and decode paths (port of
``repro.models.blocks_dense`` for the dense family)."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.params import Initializer


def init_dense_layer(ini: Initializer, cfg: ModelConfig):
    return {
        "ln1": L.init_norm(ini, cfg, cfg.d_model),
        "attn": L.init_attention(ini, cfg),
        "ln2": L.init_norm(ini, cfg, cfg.d_model),
        "mlp": L.init_mlp(ini, cfg),
    }


def dense_layer_fwd(p, x, cfg: ModelConfig, *, causal: bool = True,
                    sliding_window: Optional[int] = None, positions=None, starts=None):
    """Full-sequence forward.  Returns (x, (k, v))."""
    h, kv = L.attention_layer(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, causal=causal,
        positions=positions, sliding_window=sliding_window, starts=starts,
    )
    x = x + h
    x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg)
    return x, kv


def dense_layer_decode(p, x, cfg: ModelConfig, k_cache, v_cache, cur_index: int, *,
                       sliding_window: Optional[int] = None, starts=None):
    """Single-token decode.  x (E, B, 1, D); caches updated in place."""
    x = x + L.attention_decode(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, k_cache, v_cache, cur_index,
        sliding_window=sliding_window, starts=starts,
    )
    return x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg)

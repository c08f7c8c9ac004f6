"""Model API for the dense family (port of ``repro.models.api``).

    params = init_params(cfg, generator, device)
    logits, cache = prefill(params, batch, cfg)          # (B, V), caches
    logits, cache = decode_step(params, token, cache, pos, cfg)
    logits = forward_logits(params, batch, cfg)          # (B, S, V)

The single-model functions take the JAX package's parameter tree and cache
layout (k, v: (L, B, KVH, S, hd)).  Each is a thin wrapper over a
``*_members`` function that carries the ensemble axis E explicitly:
parameters (E, ...) with the stacked layer axis second, caches
(L, E, B, KVH, S, hd) — layer-major, so one layer's (E*B, KVH, S, hd) slab
is contiguous for the decode kernel.  A Python loop over layers takes the
place of ``lax.scan``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks_dense as BD
from repro_torch.models import layers as L
from repro_torch.models.params import Initializer, torch_dtype, tree_map


def _require_dense(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.is_encoder or cfg.n_vision_tokens:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def init_params(cfg: ModelConfig, generator: torch.Generator, device, *, lead=()):
    """Seeded parameters; ``lead=(k,)`` stacks k ensemble members."""
    _require_dense(cfg)
    ini = Initializer(generator, cfg.dtype, device, lead)
    p = {"embed": ini.normal((cfg.vocab_size, cfg.d_model), std=0.02)}
    p["layers"] = BD.init_dense_layer(ini.stacked(cfg.n_layers), cfg)
    p["final_norm"] = L.init_norm(ini, cfg, cfg.d_model)
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.normal((cfg.d_model, cfg.vocab_size), std=0.02)
    return p


def _members(params):
    return tree_map(lambda t: t[None], params)


def _layer(params, l: int):
    return tree_map(lambda t: t[:, l], params["layers"])


def _tokens(batch, device) -> torch.Tensor:
    return torch.as_tensor(batch["tokens"], device=device).to(torch.int64)


def embed_inputs(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) shared by all members, or (E, B, S) per member ->
    hidden (E, B, S, D)."""
    emb = params["embed"]
    if tokens.ndim == 2:
        return emb[:, tokens]
    return emb[torch.arange(emb.shape[0], device=emb.device)[:, None, None], tokens]


def _pad_carveout(batch, S: int, device):
    """(positions, starts) for a left-padded batch, or (None, None):
    positions are taken relative to each row's prompt start."""
    starts = batch.get("starts")
    if starts is None:
        return None, None
    starts = torch.as_tensor(starts, device=device).to(torch.int32)
    return torch.arange(S, device=device)[None, :] - starts[:, None], starts


def backbone_fwd(params, x, cfg: ModelConfig, *, positions=None, starts=None, cache=None):
    """Runs every layer over x (E, B, S, D).  With ``cache`` (k, v tensors
    (L, E, B, KVH, S', hd), S' >= S) each layer's K/V are written into
    rows [0, S)."""
    for l in range(cfg.n_layers):
        x, (k, v) = BD.dense_layer_fwd(
            _layer(params, l), x, cfg, causal=True, sliding_window=cfg.sliding_window,
            positions=positions, starts=starts,
        )
        if cache is not None:
            S = k.shape[2]
            cache["k"][l, :, :, :, :S] = k.permute(0, 1, 3, 2, 4)
            cache["v"][l, :, :, :, :S] = v.permute(0, 1, 3, 2, 4)
    return x


def forward_logits_members(params, batch, cfg: ModelConfig):
    """Full logits (E, B, S, V)."""
    _require_dense(cfg)
    device = params["embed"].device
    x = embed_inputs(params, _tokens(batch, device))
    positions, starts = _pad_carveout(batch, x.shape[2], device)
    x = backbone_fwd(params, x, cfg, positions=positions, starts=starts)
    return L.project_logits(params, x, cfg)


def init_cache_members(cfg: ModelConfig, E: int, batch: int, max_seq: int, device, dtype=None):
    shape = (cfg.n_layers, E, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    dtype = dtype or torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def prefill_members(params, batch, cfg: ModelConfig, *, collect_kv=True):
    """Prompt prefill for E members sharing the batch.  Returns
    (last-token logits (E, B, V), caches (L, E, B, KVH, S, hd) or None)."""
    _require_dense(cfg)
    device = params["embed"].device
    x = embed_inputs(params, _tokens(batch, device))
    E, B, S, _ = x.shape
    positions, starts = _pad_carveout(batch, S, device)
    cache = (
        init_cache_members(cfg, E, B, S, device, dtype=x.dtype) if collect_kv else None
    )
    x = backbone_fwd(params, x, cfg, positions=positions, starts=starts, cache=cache)
    return L.project_logits(params, x[:, :, -1], cfg), cache


def decode_step_members(params, token, cache, pos: int, cfg: ModelConfig, *, starts=None):
    """One new token per member at the shared scalar position ``pos``.
    token (E, B, 1); cache (L, E, B, KVH, S, hd), updated in place.
    Returns (logits (E, B, V), cache)."""
    _require_dense(cfg)
    device = params["embed"].device
    if starts is not None:
        starts = torch.as_tensor(starts, device=device).to(torch.int32)
    x = embed_inputs(params, torch.as_tensor(token, device=device).to(torch.int64))
    for l in range(cfg.n_layers):
        x = BD.dense_layer_decode(
            _layer(params, l), x, cfg, cache["k"][l], cache["v"][l], pos,
            sliding_window=cfg.sliding_window, starts=starts,
        )
    return L.project_logits(params, x[:, :, 0], cfg), cache


# ---------------------------------------------------------------------------
# single-model API (the JAX package's signatures and cache layout)
# ---------------------------------------------------------------------------


def forward_logits(params, batch, cfg: ModelConfig):
    """Full logits (B, S, V)."""
    return forward_logits_members(_members(params), batch, cfg)[0]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device, dtype=None):
    """Zero caches, k and v (L, B, KVH, max_seq, hd)."""
    c = init_cache_members(cfg, 1, batch, max_seq, device, dtype)
    return {k: v[:, 0] for k, v in c.items()}


def prefill(params, batch, cfg: ModelConfig):
    """Returns (last-token logits (B, V), cache {k, v: (L, B, KVH, S, hd)}).
    ``batch['starts']`` (B,), optional, is the left-pad carve-out."""
    logits, cache = prefill_members(_members(params), batch, cfg)
    return logits[0], {k: v[:, 0] for k, v in cache.items()}


def decode_step(params, token, cache, pos: int, cfg: ModelConfig, *,
                starts: Optional[torch.Tensor] = None):
    """token (B, 1); cache from ``prefill``/``init_cache`` (updated in
    place); ``pos`` the scalar position of the new token.  Returns
    (logits (B, V), cache)."""
    token = torch.as_tensor(token)
    logits, _ = decode_step_members(
        _members(params), token[None], {k: v[:, None] for k, v in cache.items()}, pos, cfg,
        starts=starts,
    )
    return logits[0], cache

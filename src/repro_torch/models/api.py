"""Model API for the dense family (port of ``repro.models.api``).

    params = init_params(cfg, generator, device)
    logits, cache = prefill(params, batch, cfg)          # (B, V), caches
    logits, cache = decode_step(params, token, cache, pos, cfg)
    logits = forward_logits(params, batch, cfg)          # (B, S, V)

and the slot surface of continuous batching:

    cache = prefill_into_slot(params, tokens, cache, slot, start, cfg)
    pool = init_paged_pool(cfg, n_pages, page_size, device)
    logits, pool = decode_step_paged(params, token, pool, pos, pages, cfg)
    pool = prefill_into_slot_paged(params, tokens, pool, pages_row, start, cfg)
    pool = copy_pool_page(pool, src, dst)

The single-model functions take the JAX package's parameter tree and cache
layouts (k, v: (L, B, KVH, S, hd); pools (L, P, KVH, page_size, hd)).  Each
is a thin wrapper over a ``*_members`` function that carries the ensemble
axis E explicitly: parameters (E, ...) with the stacked layer axis second,
caches (L, E, B, KVH, S, hd) and pools (L, E, P, KVH, page_size, hd) —
layer-major, so one layer's slab is contiguous for the decode kernels, and
one page table serves all E member planes.  A Python loop over layers
takes the place of ``lax.scan``.  Caches and pools are updated IN PLACE
(and returned, so call sites read like the JAX package's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
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


def _positions(pos, device):
    """A shared scalar position stays an int; a (B,) per-slot vector goes
    to the device once, as int64."""
    if isinstance(pos, (int, np.integer)) or (isinstance(pos, torch.Tensor) and pos.ndim == 0):
        return int(pos)
    return torch.as_tensor(pos, device=device).to(torch.int64)


def decode_step_members(params, token, cache, pos, cfg: ModelConfig, *, starts=None):
    """One new token per member.  ``pos`` is the shared scalar position or
    a (B,) vector of per-slot positions (continuous batching).  token
    (E, B, 1); cache (L, E, B, KVH, S, hd), updated in place.  Returns
    (logits (E, B, V), cache)."""
    _require_dense(cfg)
    device = params["embed"].device
    pos = _positions(pos, device)
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
# slot-stream support: chunked prefill into one slot, block-paged pools
# ---------------------------------------------------------------------------


def has_slot_state(cfg: ModelConfig) -> bool:
    """True for families whose slot cache carries state the position mask
    does not hide (SSM/RWKV, hybrid); none of them is ported yet."""
    return cfg.family in ("ssm_mamba2", "ssm_rwkv6", "hybrid")


def reset_slot(cache, slot, cfg: ModelConfig):
    """Zero one slot's constant-state leaves at admission.  Attention KV
    rows need nothing (the per-slot position mask hides a previous
    occupant's rows), so for the dense family this returns ``cache``."""
    if has_slot_state(cfg):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return cache


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked-prefill admission: every ported (dense, decoder) family."""
    return cfg.family == "dense" and not cfg.is_encoder


def supports_paging(cfg: ModelConfig) -> bool:
    """Block-paged KV pools serve the attention-cache families; of those,
    the port has the dense family."""
    return cfg.family == "dense" and not cfg.is_encoder


def prefill_into_slot_members(params, tokens, cache, slot: int, start: int, cfg: ModelConfig):
    """Consume a C-token chunk of one slot's prompt, positions
    [start, start+C), into every member's slot rows of the dense slot cache
    (L, E, n_slots, KVH, S, hd), in place.  No logits: the last prompt
    token always goes through the decode step, whose logits pick the first
    output token — which keeps chunked and decode-only admission
    token-identical.  Returns the cache."""
    _require_dense(cfg)
    device = params["embed"].device
    x = embed_inputs(params, torch.as_tensor(tokens, device=device).to(torch.int64)[None])
    for l in range(cfg.n_layers):
        x = BD.dense_layer_prefill_chunk(
            _layer(params, l), x, cfg, cache["k"][l], cache["v"][l], int(slot), int(start),
            sliding_window=cfg.sliding_window,
        )
    return cache


def init_paged_pool_members(cfg: ModelConfig, E: int, n_pages: int, page_size: int, device, dtype=None):
    """Zero pools, k and v (L, E, n_pages, KVH, page_size, hd): HBM is
    bound by pages, not slots x max_seq; page contents keep the
    kernel-native (KVH, seq, hd) tile layout."""
    assert supports_paging(cfg), cfg.family
    shape = (cfg.n_layers, E, n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    dtype = dtype or torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def copy_pool_page(pool, src: int, dst: int):
    """Device half of a copy-on-write split: copy page ``src`` to ``dst``
    on every leaf, layer and member plane, in place.  The page axis is
    found from the trailing (P, KVH, page_size, hd) layout, so engine pools
    and member-stacked tier pools take the same call."""
    for t in pool.values():
        ax = t.ndim - 4
        t.select(ax, int(dst)).copy_(t.select(ax, int(src)))
    return pool


def decode_step_paged_members(params, token, pool, pos, pages, cfg: ModelConfig):
    """One decode token per member and slot against the paged pools.

    token (E, B, 1); pos (B,) per-slot positions; pages (B, n_pg) int32
    table (-1 = unmapped), shared by the E member planes; pool from
    ``init_paged_pool_members``, updated in place.  Positions and table go
    to the device once for all layers.  Returns (logits (E, B, V), pool)."""
    _require_dense(cfg)
    device = params["embed"].device
    _, E, P = pool["k"].shape[:3]
    step = L.paged_step(pos, pages, E=E, n_pages=P, page_size=pool["k"].shape[-2], device=device)
    x = embed_inputs(params, torch.as_tensor(token, device=device).to(torch.int64))
    for l in range(cfg.n_layers):
        x = BD.dense_layer_decode_paged(
            _layer(params, l), x, cfg, pool["k"][l], pool["v"][l], step,
            sliding_window=cfg.sliding_window,
        )
    return L.project_logits(params, x[:, :, 0], cfg), pool


def prefill_into_slot_paged_members(params, tokens, pool, pages_row, start: int, cfg: ModelConfig):
    """Paged counterpart of ``prefill_into_slot_members``: the chunk's K/V
    rows land in the pool pages the slot's (n_pg,) table row maps.  Returns
    the pool (updated in place)."""
    _require_dense(cfg)
    device = params["embed"].device
    pages_row = torch.as_tensor(pages_row, device=device).to(torch.int32)
    x = embed_inputs(params, torch.as_tensor(tokens, device=device).to(torch.int64)[None])
    for l in range(cfg.n_layers):
        x = BD.dense_layer_prefill_chunk_paged(
            _layer(params, l), x, cfg, pool["k"][l], pool["v"][l], int(start), pages_row,
            sliding_window=cfg.sliding_window,
        )
    return pool


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


def decode_step(params, token, cache, pos, cfg: ModelConfig, *,
                starts: Optional[torch.Tensor] = None):
    """token (B, 1); cache from ``prefill``/``init_cache`` (updated in
    place); ``pos`` the scalar position of the new token or a (B,) vector
    of per-slot positions.  Returns (logits (B, V), cache)."""
    token = torch.as_tensor(token)
    logits, _ = decode_step_members(
        _members(params), token[None], _member_cache(cache), pos, cfg, starts=starts,
    )
    return logits[0], cache


def _member_cache(cache):
    """A single-model cache or pool as a one-member view (writes go
    through)."""
    return {k: v[:, None] for k, v in cache.items()}


def prefill_into_slot(params, tokens, cache, slot: int, start: int, cfg: ModelConfig):
    """tokens (C,) for positions [start, start+C) of ``slot``; cache the
    (L, n_slots, KVH, S, hd) slot cache (updated in place).  Returns the
    cache."""
    prefill_into_slot_members(_members(params), tokens, _member_cache(cache), slot, start, cfg)
    return cache


def init_paged_pool(cfg: ModelConfig, n_pages: int, page_size: int, device, dtype=None):
    """Zero pools, k and v (L, n_pages, KVH, page_size, hd)."""
    pool = init_paged_pool_members(cfg, 1, n_pages, page_size, device, dtype)
    return {k: v[:, 0] for k, v in pool.items()}


def decode_step_paged(params, token, pool, pos, pages, cfg: ModelConfig):
    """token (B, 1); pos (B,); pages (B, n_pg) int32; pool from
    ``init_paged_pool`` (updated in place).  Returns (logits (B, V), pool)."""
    token = torch.as_tensor(token)
    logits, _ = decode_step_paged_members(_members(params), token[None], _member_cache(pool), pos, pages, cfg)
    return logits[0], pool


def prefill_into_slot_paged(params, tokens, pool, pages_row, start: int, cfg: ModelConfig):
    """tokens (C,) for positions [start, start+C); pages_row the slot's
    (n_pg,) table row.  Returns the pool (updated in place)."""
    prefill_into_slot_paged_members(_members(params), tokens, _member_cache(pool), pages_row, start, cfg)
    return pool

"""Model API (port of ``repro.models.api``) for the dense family and the
three constant-state families: ``ssm_rwkv6``, ``ssm_mamba2`` and
``hybrid`` (a Mamba2 backbone with one shared attention block applied
every ``attn_every`` layers).

    params = init_params(cfg, generator, device)
    logits, cache = prefill(params, batch, cfg)          # (B, V), caches
    logits, cache = decode_step(params, token, cache, pos, cfg)
    logits = forward_logits(params, batch, cfg)          # (B, S, V)

and the slot surface of continuous batching:

    cache = prefill_into_slot(params, tokens, cache, slot, start, cfg)
    cache = reset_slot(cache, slot, cfg)                 # state families
    pool = init_paged_pool(cfg, n_pages, page_size, device)   # dense only
    logits, pool = decode_step_paged(params, token, pool, pos, pages, cfg)
    pool = prefill_into_slot_paged(params, tokens, pool, pages_row, start, cfg)
    pool = copy_pool_page(pool, src, dst)

The single-model functions take the JAX package's parameter tree and cache
layouts: dense k, v (L, B, KVH, S, hd); mamba2 conv (L, B, K-1, conv_dim)
and ssm (L, B, nh, N, P) f32; rwkv6 tm_x, cm_x (L, B, D) and wkv (L, B, H,
hd, hd) f32; hybrid the mamba2 leaves plus ``attn_k``/``attn_v``, one
(B, KVH, S, hd) leaf per shared-attention invocation; dense pools (L,
n_pages, KVH, page_size, hd).  Each is a thin wrapper over a ``*_members``
function that carries the ensemble axis E explicitly: parameters (E, ...)
with the stacked layer axis second, caches layer-major with E second —
(L, E, B, ...) — so one layer's slab is contiguous for the kernels, the
hybrid's per-invocation leaves (E, B, KVH, S, hd), and pools (L, E, P,
KVH, page_size, hd) under one page table.  A Python loop over layers takes
the place of ``lax.scan``.  Caches and pools are updated IN PLACE (and
returned, so call sites read like the JAX package's).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks_dense as BD
from repro_torch.models import blocks_mamba2 as BM
from repro_torch.models import blocks_rwkv6 as BR
from repro_torch.models import layers as L
from repro_torch.models.params import Initializer, torch_dtype, tree_map

PORTED_FAMILIES = ("dense", "ssm_mamba2", "ssm_rwkv6", "hybrid")


def _require_ported(cfg: ModelConfig):
    if cfg.family not in PORTED_FAMILIES or cfg.is_encoder or cfg.n_vision_tokens:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def init_params(cfg: ModelConfig, generator: torch.Generator, device, *, lead=()):
    """Seeded parameters; ``lead=(k,)`` stacks k ensemble members."""
    _require_ported(cfg)
    ini = Initializer(generator, cfg.dtype, device, lead)
    p = {"embed": ini.normal((cfg.vocab_size, cfg.d_model), std=0.02)}
    layers = ini.stacked(cfg.n_layers)
    if cfg.family == "dense":
        p["layers"] = BD.init_dense_layer(layers, cfg)
    elif cfg.family == "ssm_rwkv6":
        p["layers"] = BR.init_rwkv6_block(layers, cfg)
    else:
        p["layers"] = BM.init_mamba2_block(layers, cfg)
    if cfg.family == "hybrid" and cfg.attn_every:
        p["shared_attn"] = BD.init_dense_layer(ini, cfg)  # one block, shared by depth
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


def _pad_carveout(batch, S: int, cfg: ModelConfig, device):
    """(positions, starts) for a left-padded batch, or (None, None):
    positions are taken relative to each row's prompt start.  Recurrent
    families sweep the sequence unconditionally, so the carve-out cannot
    apply there."""
    starts = batch.get("starts")
    if starts is None:
        return None, None
    _require_carveout(cfg)
    starts = torch.as_tensor(starts, device=device).to(torch.int32)
    return torch.arange(S, device=device)[None, :] - starts[:, None], starts


def _require_carveout(cfg: ModelConfig):
    if cfg.family != "dense":
        raise ValueError(f"left-pad carve-out unsupported for family {cfg.family}")


def _state_keys(cfg: ModelConfig):
    """The constant-size recurrent state leaves: everything that is not
    position-masked, so a slot that admits a new request must zero them."""
    return ("tm_x", "cm_x", "wkv") if cfg.family == "ssm_rwkv6" else ("conv", "ssm")


def _attn_after(cfg: ModelConfig, l: int) -> bool:
    """True where the hybrid applies its shared attention block, after
    layer l; invocation ``l // attn_every`` owns that call's KV leaf."""
    return cfg.family == "hybrid" and bool(cfg.attn_every) and (l + 1) % cfg.attn_every == 0


def _recurrent_layer(params, l: int, x, cfg: ModelConfig, state, *, step: bool = False):
    """Layer l of a constant-state family over a sequence or chunk x
    (E, B, S, D), continuing ``state`` (None at a sequence start); with
    ``step`` the single-token decode form (x (E, B, 1, D)).  Returns
    (x, new state)."""
    lp = _layer(params, l)
    if cfg.family == "ssm_rwkv6":
        if step:
            return BR.rwkv6_step(lp, x, cfg, state)
        return BR.rwkv6_layer_fwd(lp, x, cfg, state=state)
    if step:
        out, state = BM.mamba2_step(lp, x, cfg, state)
    else:
        out, state = BM.mamba2_fwd(lp, x, cfg, initial=state)
    return x + out, state


def _write_kv(k_cache, v_cache, k, v):
    """Prefill K/V (E, B, S, KVH, hd) into rows [0, S) of (E, B, KVH, S', hd)."""
    S = k.shape[2]
    k_cache[:, :, :, :S] = k.permute(0, 1, 3, 2, 4)
    v_cache[:, :, :, :S] = v.permute(0, 1, 3, 2, 4)


def backbone_fwd(params, x, cfg: ModelConfig, *, positions=None, starts=None, cache=None):
    """Runs every layer over x (E, B, S, D).  With ``cache`` (from
    ``init_cache_members``, KV rows S' >= S) each dense layer's K/V are
    written into rows [0, S), each recurrent layer's final state into its
    layer slab, and each hybrid attention invocation's K/V into its
    leaf."""
    if cfg.family == "dense":
        for l in range(cfg.n_layers):
            x, (k, v) = BD.dense_layer_fwd(
                _layer(params, l), x, cfg, causal=True, sliding_window=cfg.sliding_window,
                positions=positions, starts=starts,
            )
            if cache is not None:
                _write_kv(cache["k"][l], cache["v"][l], k, v)
        return x
    for l in range(cfg.n_layers):
        x, st = _recurrent_layer(params, l, x, cfg, None)
        if cache is not None:
            for name, t in st.items():
                cache[name][l] = t
        if _attn_after(cfg, l):
            x, (k, v) = BD.dense_layer_fwd(
                params["shared_attn"], x, cfg, causal=True, sliding_window=cfg.sliding_window,
            )
            if cache is not None:
                inv = l // cfg.attn_every
                _write_kv(cache["attn_k"][inv], cache["attn_v"][inv], k, v)
    return x


def forward_logits_members(params, batch, cfg: ModelConfig):
    """Full logits (E, B, S, V)."""
    _require_ported(cfg)
    device = params["embed"].device
    x = embed_inputs(params, _tokens(batch, device))
    positions, starts = _pad_carveout(batch, x.shape[2], cfg, device)
    x = backbone_fwd(params, x, cfg, positions=positions, starts=starts)
    return L.project_logits(params, x, cfg)


def init_cache_members(cfg: ModelConfig, E: int, batch: int, max_seq: int, device, dtype=None):
    """Zero member caches, layer-major: dense k, v (L, E, B, KVH, max_seq,
    hd); mamba2 conv (L, E, B, K-1, conv_dim) and ssm (L, E, B, nh, N, P)
    f32; rwkv6 tm_x, cm_x (L, E, B, D) and wkv (L, E, B, H, hd, hd) f32;
    hybrid the mamba2 leaves plus ``attn_k``/``attn_v`` lists of one
    (E, B, KVH, max_seq, hd) leaf per shared-attention invocation."""
    _require_ported(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    Lyr = cfg.n_layers
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    if cfg.family == "dense":
        shape = (Lyr, E, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    init_state = BR.init_rwkv6_state if cfg.family == "ssm_rwkv6" else BM.init_mamba2_state
    layer = init_state(cfg, E, batch, dtype, device)  # one layer's state, for its shapes
    cache = {name: t.new_zeros((Lyr,) + tuple(t.shape)) for name, t in layer.items()}
    if cfg.family == "hybrid":
        n_inv = Lyr // cfg.attn_every
        kv = (E, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
        cache["attn_k"] = [zeros(*kv) for _ in range(n_inv)]
        cache["attn_v"] = [zeros(*kv) for _ in range(n_inv)]
    return cache


def prefill_members(params, batch, cfg: ModelConfig, *, collect_kv=True, cache=None):
    """Prompt prefill for E members sharing the batch.  Returns
    (last-token logits (E, B, V), member caches as ``init_cache_members``
    lays them out with S KV rows, or None).  With ``cache`` (from
    ``init_cache_members``, KV rows S' >= S) the prompt's K/V land in rows
    [0, S) and the recurrent state in its leaves, in place, and that cache
    is returned: the static cache of a captured batch generation, whose
    decode steps write rows S.. of the same memory."""
    _require_ported(cfg)
    device = params["embed"].device
    x = embed_inputs(params, _tokens(batch, device))
    E, B, S, _ = x.shape
    positions, starts = _pad_carveout(batch, S, cfg, device)
    if cache is None and collect_kv:
        cache = init_cache_members(cfg, E, B, S, device, dtype=x.dtype)
    x = backbone_fwd(params, x, cfg, positions=positions, starts=starts, cache=cache)
    return L.project_logits(params, x[:, :, -1], cfg), cache


def _positions(pos, B: int, device):
    """A Python or numpy int stays an int (the shared scalar position); a
    tensor or array, 0-d or (B,), becomes a (B,) int64 vector on the device
    (sent once, or used in place when it is there already).  A tensor is
    never read back to the host: inside a captured decode step that read
    would freeze the position."""
    if isinstance(pos, (int, np.integer)):
        return int(pos)
    return torch.as_tensor(pos, device=device).to(torch.int64).reshape(-1).expand(B)


def decode_step_members(params, token, cache, pos, cfg: ModelConfig, *, starts=None):
    """One new token per member.  ``pos`` is the shared scalar position (a
    Python int) or a (B,) vector of per-row positions (continuous batching,
    and every captured decode step: a 0-d tensor broadcasts to it).  token
    (E, B, 1); cache from ``init_cache_members``/``prefill_members``,
    updated in place.  Token and a vector ``pos`` already on the device
    are used as they are (no copy), as a captured decode step needs.
    Returns (logits (E, B, V), cache)."""
    _require_ported(cfg)
    device = params["embed"].device
    pos = _positions(pos, token.shape[1], device)
    if starts is not None:
        _require_carveout(cfg)
        starts = torch.as_tensor(starts, device=device).to(torch.int32)
    x = embed_inputs(params, torch.as_tensor(token, device=device).to(torch.int64))
    if cfg.family == "dense":
        for l in range(cfg.n_layers):
            x = BD.dense_layer_decode(
                _layer(params, l), x, cfg, cache["k"][l], cache["v"][l], pos,
                sliding_window=cfg.sliding_window, starts=starts,
            )
        return L.project_logits(params, x[:, :, 0], cfg), cache
    for l in range(cfg.n_layers):
        x, st = _recurrent_layer(params, l, x, cfg, {n: cache[n][l] for n in _state_keys(cfg)}, step=True)
        # written in place into the stacked leaf (never rebound): a
        # captured decode step writes the same addresses at every replay
        for name, t in st.items():
            cache[name][l] = t
        if _attn_after(cfg, l):
            inv = l // cfg.attn_every
            x = BD.dense_layer_decode(
                params["shared_attn"], x, cfg, cache["attn_k"][inv], cache["attn_v"][inv], pos,
                sliding_window=cfg.sliding_window,
            )
    return L.project_logits(params, x[:, :, 0], cfg), cache


# ---------------------------------------------------------------------------
# slot-stream support: chunked prefill into one slot, block-paged pools
# ---------------------------------------------------------------------------


def has_slot_state(cfg: ModelConfig) -> bool:
    """True for families whose slot cache carries state the position mask
    does not hide: SSM/RWKV and hybrid."""
    return cfg.family in ("ssm_mamba2", "ssm_rwkv6", "hybrid")


def _zero_slot(cache, slot, cfg: ModelConfig, axis: int):
    if has_slot_state(cfg):
        for name in _state_keys(cfg):
            cache[name].select(axis, int(slot)).zero_()
    return cache


def reset_slot(cache, slot, cfg: ModelConfig):
    """Zero one slot's constant-state leaves at admission, in place, in a
    single-model slot cache (slot axis 1 of every stacked leaf).  Attention
    KV rows need nothing (the per-slot position mask hides a previous
    occupant's rows), so the dense family's cache and the hybrid's
    ``attn_k``/``attn_v`` leaves are left as they are.  Returns ``cache``."""
    return _zero_slot(cache, slot, cfg, 1)


def reset_slot_members(cache, slot, cfg: ModelConfig):
    """``reset_slot`` over member caches (L, E, n_slots, ...): the slot of
    every member."""
    return _zero_slot(cache, slot, cfg, 2)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked-prefill admission: every ported decoder family."""
    return cfg.family in PORTED_FAMILIES and not cfg.is_encoder


def supports_paging(cfg: ModelConfig) -> bool:
    """Block-paged KV pools serve the dense family.  Constant-state
    families have O(1) per-slot state, nothing to page, and the hybrid's
    per-invocation KV leaves keep the dense slot layout, as in the JAX
    package."""
    return cfg.family == "dense" and not cfg.is_encoder


def slot_index(v, device) -> torch.Tensor:
    """A slot index or chunk offset as a (1,) int64 tensor on ``device``: a
    device tensor passes through without a copy (a captured chunk program
    reads it at every replay); a Python or numpy int is sent once."""
    if isinstance(v, torch.Tensor) and v.device == torch.device(device):
        return v.reshape(1).to(torch.int64)
    return torch.tensor([int(v)], dtype=torch.int64, device=device)


def prefill_into_slot_members(params, tokens, cache, slot, start, cfg: ModelConfig):
    """Consume a C-token chunk of one slot's prompt, positions
    [start, start+C), into every member's slot of the member slot cache
    (``init_cache_members`` with batch = n_slots), in place.  ``slot`` and
    ``start`` are ints or (1,) device tensors (``slot_index``), ``tokens``
    (C,) host or device: with device inputs nothing is copied from the host
    and no value is read back, so the call can be captured.  Attention
    layers write K/V rows at the slot's offset; constant-state layers
    continue the slot's recurrent state (its rows selected and written back
    by index) through the full-sequence block forwards.  No logits: the
    last prompt token always goes through the decode step, whose logits
    pick the first output token — which keeps chunked and decode-only
    admission token-identical.  Returns the cache."""
    _require_ported(cfg)
    device = params["embed"].device
    slot, start = slot_index(slot, device), slot_index(start, device)
    x = embed_inputs(params, torch.as_tensor(tokens, device=device).to(torch.int64)[None])
    if cfg.family == "dense":
        for l in range(cfg.n_layers):
            x = BD.dense_layer_prefill_chunk(
                _layer(params, l), x, cfg, cache["k"][l], cache["v"][l], slot, start,
                sliding_window=cfg.sliding_window,
            )
        return cache
    for l in range(cfg.n_layers):
        x, st = _recurrent_layer(params, l, x, cfg, {n: cache[n][l].index_select(1, slot) for n in _state_keys(cfg)})
        for name, t in st.items():
            cache[name][l].index_copy_(1, slot, t.to(cache[name].dtype))
        if _attn_after(cfg, l):
            inv = l // cfg.attn_every
            x = BD.dense_layer_prefill_chunk(
                params["shared_attn"], x, cfg, cache["attn_k"][inv], cache["attn_v"][inv], slot, start,
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
    assert supports_paging(cfg), cfg.family
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


def prefill_into_slot_paged_members(params, tokens, pool, pages_row, start, cfg: ModelConfig):
    """Paged counterpart of ``prefill_into_slot_members``: the chunk's K/V
    rows land in the pool pages the slot's (n_pg,) table row maps.
    ``start`` an int or (1,) device tensor; tokens and table row host or
    device (device inputs are used without a copy).  Returns the pool
    (updated in place)."""
    assert supports_paging(cfg), cfg.family
    device = params["embed"].device
    pages_row = torch.as_tensor(pages_row, device=device).to(torch.int32)
    start = slot_index(start, device)
    x = embed_inputs(params, torch.as_tensor(tokens, device=device).to(torch.int64)[None])
    for l in range(cfg.n_layers):
        x = BD.dense_layer_prefill_chunk_paged(
            _layer(params, l), x, cfg, pool["k"][l], pool["v"][l], start, pages_row,
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
    """Zero caches in the JAX package's layout (see the module docstring)."""
    return _single_cache(init_cache_members(cfg, 1, batch, max_seq, device, dtype))


def prefill(params, batch, cfg: ModelConfig, *, cache=None):
    """Returns (last-token logits (B, V), cache in the JAX layout, with S KV
    rows).  ``batch['starts']`` (B,), optional, is the left-pad carve-out
    (dense family only).  ``cache`` (``init_cache`` with S' >= S rows): the
    prompt is written into it in place and it is returned."""
    if cache is not None:
        logits, _ = prefill_members(_members(params), batch, cfg, cache=_member_cache(cache))
        return logits[0], cache
    logits, cache = prefill_members(_members(params), batch, cfg)
    return logits[0], _single_cache(cache)


def last_logits(params, batch, cfg: ModelConfig):
    """Last-token logits (B, V) of a prompt batch, no cache kept (the
    classifier head)."""
    return prefill_members(_members(params), batch, cfg, collect_kv=False)[0][0]


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
    through): E enters at axis 1 of stacked leaves, axis 0 of the hybrid's
    per-invocation leaves."""
    return {k: [t[None] for t in v] if isinstance(v, list) else v[:, None] for k, v in cache.items()}


def _single_cache(cache):
    """The inverse of ``_member_cache`` for a one-member cache."""
    return {k: [t[0] for t in v] if isinstance(v, list) else v[:, 0] for k, v in cache.items()}


def prefill_into_slot(params, tokens, cache, slot, start, cfg: ModelConfig):
    """tokens (C,) for positions [start, start+C) of ``slot``; cache the
    single-model slot cache (``init_cache`` with batch = n_slots, updated
    in place).  Returns the cache."""
    prefill_into_slot_members(_members(params), tokens, _member_cache(cache), slot, start, cfg)
    return cache


def init_paged_pool(cfg: ModelConfig, n_pages: int, page_size: int, device, dtype=None):
    """Zero pools, k and v (L, n_pages, KVH, page_size, hd)."""
    return _single_cache(init_paged_pool_members(cfg, 1, n_pages, page_size, device, dtype))


def decode_step_paged(params, token, pool, pos, pages, cfg: ModelConfig):
    """token (B, 1); pos (B,); pages (B, n_pg) int32; pool from
    ``init_paged_pool`` (updated in place).  Returns (logits (B, V), pool)."""
    token = torch.as_tensor(token)
    logits, _ = decode_step_paged_members(_members(params), token[None], _member_cache(pool), pos, pages, cfg)
    return logits[0], pool


def prefill_into_slot_paged(params, tokens, pool, pages_row, start, cfg: ModelConfig):
    """tokens (C,) for positions [start, start+C); pages_row the slot's
    (n_pg,) table row.  Returns the pool (updated in place)."""
    prefill_into_slot_paged_members(_members(params), tokens, _member_cache(pool), pages_row, start, cfg)
    return pool

"""Stacked-weight ensembles with the member axis E explicit (port of
``repro.core.ensemble``).  Every parameter leaf carries a leading E axis;
the members run as one batched program (E-batched weight products, E
folded into the batch around the attention, SSD and WKV kernels) where the
JAX package ``vmap``s.  Member caches are layer-major, (L, E, B, ...):
dense (L, E, B, KVH, S, hd), recurrent state leaves (L, E, B, ...) and the
hybrid's per-invocation attention leaves (E, B, KVH, S, hd); member pools
are (L, E, P, KVH, page_size, hd) under one page table."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def init_ensemble(cfg: ModelConfig, k: int, generator: torch.Generator, device):
    """k members' parameters, stacked on a leading axis, drawn in one pass."""
    return api.init_params(cfg, generator, device, lead=(k,))


def ensemble_logits(values, batch, cfg: ModelConfig):
    """Full-sequence logits per member: (E, B, S, V).  ``batch`` as
    ``api.forward_logits`` takes it: ``tokens``, and ``embeds`` for the
    encoder's frames or the VLM's patch prefix."""
    return api.forward_logits_members(values, batch, cfg)


def ensemble_last_logits(values, batch, cfg: ModelConfig):
    """Last-token logits per member: (E, B, V); ``embeds`` as
    ``ensemble_logits`` takes them."""
    return api.prefill_members(values, batch, cfg, collect_kv=False)[0]


def ensemble_prefill(values, batch, cfg: ModelConfig, *, cache=None):
    """(logits (E, B, V), member caches as ``api.init_cache_members`` lays
    them out, with S KV rows; or ``cache``, S' >= S rows, written in
    place)."""
    return api.prefill_members(values, batch, cfg, cache=cache)


def ensemble_decode_step(values, token, caches, pos, cfg: ModelConfig):
    """token (E, B, 1) per member; ``pos`` the shared scalar position (an
    int) or a (B,) per-row vector on the device (a captured step's); caches
    updated in place.  Returns
    (logits (E, B, V), caches)."""
    return api.decode_step_members(values, token, caches, pos, cfg)


def ensemble_prefill_into_slot(values, tokens, caches, slot, start, cfg: ModelConfig):
    """Chunked prefill of one slot for every member (member slot caches
    from ``api.init_cache_members``, in place); ``slot`` and ``start`` ints
    or (1,) device tensors, as ``api.prefill_into_slot_members`` takes
    them."""
    return api.prefill_into_slot_members(values, tokens, caches, slot, start, cfg)


def ensemble_prefill_into_slot_logits(values, tokens, caches, slot, start, cfg: ModelConfig):
    """``ensemble_prefill_into_slot`` that also scores every chunk position
    (the speculative verify pass): ``(logits (E, C, V) f32, caches)``."""
    return api.prefill_into_slot_logits_members(values, tokens, caches, slot, start, cfg)


def init_ensemble_paged_pool(values, cfg: ModelConfig, n_pages: int, page_size: int):
    """E member planes of paged pools, (L, E, P, KVH, page_size, hd), on the
    members' device, under one page table."""
    return api.init_paged_pool_members(cfg, member_count(values), n_pages, page_size, api.param_device(values))


def ensemble_decode_step_paged(values, token, pools, pos, pages, cfg: ModelConfig):
    """One decode token per member and slot against the member-stacked
    pools, one (B, n_pg) table.  Returns (logits (E, B, V), pools)."""
    return api.decode_step_paged_members(values, token, pools, pos, pages, cfg)


def ensemble_prefill_into_slot_paged(values, tokens, pools, pages_row, start, cfg: ModelConfig):
    """Chunked prefill of one slot into every member plane of the pools;
    ``start`` an int or a (1,) device tensor."""
    return api.prefill_into_slot_paged_members(values, tokens, pools, pages_row, start, cfg)


def ensemble_prefill_into_slot_paged_logits(values, tokens, pools, pages_row, start, cfg: ModelConfig):
    """Paged twin of ``ensemble_prefill_into_slot_logits``: ``(logits (E,
    C, V) f32, pools)``."""
    return api.prefill_into_slot_paged_logits_members(values, tokens, pools, pages_row, start, cfg)


def member_count(values) -> int:
    return api.member_count(values)

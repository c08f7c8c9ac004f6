"""Stacked-weight ensembles with the member axis E explicit (port of
``repro.core.ensemble``).  Every parameter leaf carries a leading E axis;
the members run as one batched program (E-batched weight products, E
folded into the batch around the attention kernels) where the JAX package
``vmap``s.  Member caches are (L, E, B, KVH, S, hd)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def init_ensemble(cfg: ModelConfig, k: int, generator: torch.Generator, device):
    """k members' parameters, stacked on a leading axis, drawn in one pass."""
    return api.init_params(cfg, generator, device, lead=(k,))


def ensemble_last_logits(values, batch, cfg: ModelConfig):
    """Last-token logits per member: (E, B, V)."""
    return api.prefill_members(values, batch, cfg, collect_kv=False)[0]


def ensemble_prefill(values, batch, cfg: ModelConfig):
    """(logits (E, B, V), caches (L, E, B, KVH, S, hd))."""
    return api.prefill_members(values, batch, cfg)


def ensemble_decode_step(values, token, caches, pos: int, cfg: ModelConfig):
    """token (E, B, 1) per member, shared scalar ``pos``; caches updated in
    place.  Returns (logits (E, B, V), caches)."""
    return api.decode_step_members(values, token, caches, pos, cfg)


def member_count(values) -> int:
    return values["embed"].shape[0]

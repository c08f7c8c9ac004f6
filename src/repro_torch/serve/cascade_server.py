"""CascadeServer: ABC as a serving runtime (port of
``repro.serve.cascade_server``, batch modes).

* ``classify`` — each tier's ensemble produces last-token logits; the
  agreement rule (Eq. 3/4) selects or defers; deferred rows are compacted
  on the device and re-batched for the next tier.
* ``generate`` — black-box flavour: every member of a tier generates
  greedily, all members in one batched program per decode step; answers
  become stable crc32 digests and are compared by vote
  (``vote_rule_from_preds``).

Continuous batching, placement/transports and sampling (temperature > 0)
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import CascadeResult, TierSpec, cascade_apply_routed, host_fetch
from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.serve.engine import grow_cache


def stable_digest(tokens) -> int:
    """Process-independent canonical id for a token sequence: crc32 of the
    little-endian int32 encoding, masked to 30 bits so every digest stays
    below ``vote_rule_from_preds``'s 2**30 sentinel."""
    row = np.ascontiguousarray(np.asarray(host_fetch(tokens), np.int32)).astype("<i4")
    return zlib.crc32(row.tobytes()) & 0x3FFFFFFF


def digest_generations(out: np.ndarray) -> np.ndarray:
    """(E, B, T) member generations -> (E, B) int32 canonical answer ids."""
    E, B = out.shape[:2]
    return np.asarray([[stable_digest(out[e, b]) for b in range(B)] for e in range(E)], np.int32)


@functools.lru_cache(maxsize=None)
def tier_programs(cfg: ModelConfig, temperature: float) -> SimpleNamespace:
    """The batch programs of one tier: ``last_logits(values, batch)``,
    ``prefill(values, batch) -> (tok (E, B, 1), caches)`` and
    ``decode(values, tok, caches, pos) -> (tok, caches)``, greedy."""
    if temperature > 0.0:
        raise NotImplementedError("sampling (temperature > 0) is not ported yet")

    def _greedy(logits):
        return logits.argmax(-1).to(torch.int32)[..., None]

    def last_logits(values, batch):
        return ens.ensemble_last_logits(values, batch, cfg)

    def prefill(values, batch):
        logits, caches = ens.ensemble_prefill(values, batch, cfg)
        return _greedy(logits), caches

    def decode(values, tok, caches, pos):
        logits, caches = ens.ensemble_decode_step(values, tok, caches, pos, cfg)
        return _greedy(logits), caches

    return SimpleNamespace(last_logits=last_logits, prefill=prefill, decode=decode)


@dataclasses.dataclass
class CascadeTier:
    """One cascade level: a stacked k-member ensemble (``values`` with a
    leading member axis) plus its ``TierSpec`` deferral rule.  ``device``
    None means the card."""

    cfg: ModelConfig
    values: dict
    spec: TierSpec
    temperature: float = 0.0
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.values = tree_map(lambda t: t.to(self.device), self.values)
        self.k = ens.member_count(self.values)
        programs = tier_programs(self.cfg, float(self.temperature))
        self._last_logits = programs.last_logits
        self._prefill = programs.prefill
        self._decode = programs.decode

    def generate(self, tokens: np.ndarray, max_new_tokens: int, seed: int = 0) -> np.ndarray:
        """Greedy ensemble generation: tokens (B, S) -> (E, B, max_new).
        ``seed`` is unused until sampling is ported."""
        assert max_new_tokens >= 1, max_new_tokens
        B, S = tokens.shape
        tok, caches = self._prefill(self.values, {"tokens": torch.as_tensor(tokens, device=self.device)})
        caches = grow_cache(caches, max_new_tokens, self.cfg)
        out = [host_fetch(tok)[..., 0]]
        for t in range(max_new_tokens - 1):
            tok, caches = self._decode(self.values, tok, caches, S + t)
            out.append(host_fetch(tok)[..., 0])
        return np.stack(out, axis=2)  # (E, B, T)


class CascadeServer:
    """The ABC serving runtime over a tier list on one device."""

    def __init__(self, tiers: Sequence[CascadeTier], *, pad_to: int = 8, device=None):
        self.device = resolve_device(device)
        self.tiers = list(tiers)
        for t in self.tiers:
            if t.device != self.device:
                raise ValueError(f"tier {t.spec.name} lives on {t.device}, server on {self.device}")
        self.pad_to = pad_to

    def classify(self, tokens: np.ndarray) -> CascadeResult:
        """tokens (B, S) -> CascadeResult with per-tier routing stats."""

        def tier_fn(tier: CascadeTier):
            def fn(batch):
                return tier._last_logits(tier.values, {"tokens": batch["tokens"]})

            return fn

        return cascade_apply_routed(
            [tier_fn(t) for t in self.tiers], [t.spec for t in self.tiers],
            {"tokens": tokens}, pad_to=self.pad_to, device=self.device,
        )

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 8, seed: int = 0) -> CascadeResult:
        """Each tier's members generate greedily; answers are digested to
        stable ids and vote-compared."""

        def tier_fn(tier: CascadeTier):
            def fn(batch):
                toks = host_fetch(batch["tokens"])
                out = tier.generate(toks, max_new_tokens, seed=seed)
                return torch.as_tensor(digest_generations(out), device=self.device)

            return fn

        specs = [dataclasses.replace(t.spec, rule="vote_preds") for t in self.tiers]
        return cascade_apply_routed(
            [tier_fn(t) for t in self.tiers], specs, {"tokens": tokens},
            pad_to=self.pad_to, device=self.device,
        )

    def tier_fractions(self, result: CascadeResult) -> np.ndarray:
        """(n_tiers,) fraction of examples answered by each tier."""
        return result.tier_counts / max(1, result.tier_counts.sum())

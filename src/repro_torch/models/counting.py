"""Analytic parameter counts (port of ``repro.models.counting``): the
shapes come from the port's own ``init_params`` on the ``meta`` device, so
no weight is materialised."""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig


@functools.lru_cache(maxsize=64)
def _shapes(cfg: ModelConfig) -> dict:
    """{path: shape} of every parameter leaf."""
    from repro_torch.models.api import init_params

    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = tuple(t.shape)

    walk(init_params(cfg, torch.Generator(), "meta"), ())
    return out


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = 0
    for path, shape in _shapes(cfg).items():
        n = 1
        for d in shape:
            n *= d
        if active_only and cfg.n_experts and "moe" in path and any(k in ("w_gate", "w_up", "w_down") for k in path):
            # only top_k of n_experts are active per token
            n = int(n * cfg.top_k / cfg.n_experts)
        total += n
    return total


def embedding_params(cfg: ModelConfig) -> int:
    n = cfg.vocab_size * cfg.d_model
    has_head = ("lm_head",) in _shapes(cfg)
    return n * (2 if has_head else 1)


def model_flops_per_token(cfg: ModelConfig) -> float:
    """6·N per token, N the active non-embedding parameters."""
    n_active = count_params(cfg, active_only=True) - embedding_params(cfg)
    return 6.0 * max(n_active, 0)

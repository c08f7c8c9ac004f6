"""Serving-engine helpers ported so far from ``repro.serve.engine``."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def grow_cache(cache, pad: int, cfg: ModelConfig):
    """Pad the sequence axis (second to last) of an attention KV cache by
    ``pad`` zero rows — any leading axes (layers, members, batch) pass
    through, so single-model and member caches grow alike."""
    if pad <= 0:
        return cache
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return {k: F.pad(v, (0, 0, 0, pad)) for k, v in cache.items()}

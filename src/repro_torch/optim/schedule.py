"""LR schedules (pure functions of the step counter; port of
``repro.optim.schedule``).  ``step`` is a Python int or a device tensor;
with a tensor the result is an f32 tensor on its device, computed there
(nothing is read back to the host)."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int):
    return torch.clamp((_f32(step) + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0, final_frac: float = 0.1):
    warm = linear_warmup(step, warmup_steps)
    t = torch.clamp((_f32(step) - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos

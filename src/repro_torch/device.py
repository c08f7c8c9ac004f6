"""Device resolution for the port's entry points.

``None`` means the card: an entry point never falls back to the CPU on its
own.  Tests and CPU callers ask for ``"cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is present); anything else
    is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)

"""Device resolution for the port's entry points.

``None`` means the card: an entry point never falls back to the CPU on its
own.  Tests and CPU callers ask for ``"cpu"`` explicitly.
"""
from __future__ import annotations

import os

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


def rank_device(device=None) -> torch.device:
    """This rank's device of ``device``'s type (``resolve_device``): on the
    card ``cuda:{local_rank % device_count}``, the local rank taken from
    ``LOCAL_RANK`` (torchrun) or else the process group's rank, so ranks
    that outnumber the cards share them (every rank of a one-card host gets
    ``cuda:0``); the CPU as it is."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())

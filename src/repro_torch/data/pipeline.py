"""Host-side data pipeline: deterministic sharded batching + LM packing
(a copy of ``repro.data.pipeline``: numpy only, the same batches for every
seed, ``host_id`` and ``host_count``), and ``to_device``, which moves a
numpy batch onto the device a train step runs on."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class TokenDataset:
    """In-memory token corpus (rows of equal length)."""

    tokens: np.ndarray  # (N, S+1) int32

    def __len__(self):
        return len(self.tokens)


def make_lm_batch(rows: np.ndarray) -> dict:
    """Next-token prediction: inputs rows[:, :-1], targets rows[:, 1:]."""
    return {
        "tokens": rows[:, :-1].astype(np.int32),
        "targets": rows[:, 1:].astype(np.int32),
        "mask": np.ones_like(rows[:, 1:], np.float32),
    }


def batches(
    ds: TokenDataset,
    batch_size: int,
    *,
    seed: int = 0,
    epochs: Optional[int] = None,
    host_id: int = 0,
    host_count: int = 1,
) -> Iterator[dict]:
    """Shuffled epochs, sharded across hosts by interleaving (each host sees
    rows where (index % host_count) == host_id): every host feeds its local
    slice of the global batch."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(ds))
        local = order[host_id::host_count]
        per_host = batch_size // host_count
        for i in range(0, len(local) - per_host + 1, per_host):
            rows = ds.tokens[local[i : i + per_host]]
            yield make_lm_batch(rows)
        epoch += 1


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: integer leaves (tokens,
    targets) as int64, floating ones (mask, embeds) in their own dtype.
    Tensors pass through, moved if they lie elsewhere."""
    out = {}
    for name, a in batch.items():
        t = torch.as_tensor(a)
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[name] = t.to(device, non_blocking=True)
    return out

"""Requests and the FIFO batch queue (port of ``repro.serve.batching``)."""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.core.cascade import bucket_size

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One serving request: an (S,) int32 prompt plus a generation budget.
    The engine fills ``output`` (the generated tokens), ``tier`` (which
    cascade tier answered, -1 outside a cascade) and ``truncated``."""

    tokens: np.ndarray  # (S,) int32 prompt
    max_new_tokens: int = 16
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    # filled by the engine:
    output: Optional[np.ndarray] = None
    tier: int = -1
    # True when the slot hit the cache wall (pos >= max_seq - 1, or a paged
    # pool that could not grow) before the full max_new_tokens budget was
    # generated: ``output`` is short, not silently complete.
    truncated: bool = False
    # True when open-loop admission control rejected the request under
    # overload: it still comes back to the caller (never silently dropped),
    # with ``output=None`` and this flag set.
    shed: bool = False
    # speculative deferral (serve/speculative.py): the previous tier's
    # agreeing generation, set by the cascade when ``ServeConfig.
    # speculative`` is on; consumed (and cleared) at admission by the
    # receiving SlotStream's verify pass.
    draft: Optional[np.ndarray] = None


class RequestQueue:
    """FIFO queue that emits fixed-shape batches."""

    def __init__(self, max_batch: int = 32, pad_token: int = 0):
        self.max_batch = max_batch
        self.pad_token = pad_token
        self._q: deque = deque()

    def submit(self, req: Request):
        """Enqueue one request (FIFO)."""
        self._q.append(req)

    def __len__(self):
        return len(self._q)

    def next_batch(self) -> Optional[List[Request]]:
        """Pop up to ``max_batch`` requests, or None when empty."""
        if not self._q:
            return None
        batch = []
        while self._q and len(batch) < self.max_batch:
            batch.append(self._q.popleft())
        return batch

    def pad_batch_with_starts(self, batch: List[Request]):
        """Returns (tokens (B', S') int32, starts (B',) int32, n_real) with
        B'/S' padded to powers of two: prompts are right-aligned, row i's
        prompt occupies columns [starts[i], S') (the attention left-pad
        carve-out) and pad rows repeat the last real row."""
        n = len(batch)
        B = bucket_size(n)
        S = bucket_size(max(len(r.tokens) for r in batch))
        toks = np.full((B, S), self.pad_token, np.int32)
        starts = np.zeros((B,), np.int32)
        for i, r in enumerate(batch):
            toks[i, S - len(r.tokens):] = r.tokens  # right-align prompts
            starts[i] = S - len(r.tokens)
        for i in range(n, B):
            toks[i] = toks[n - 1]
            starts[i] = starts[n - 1]
        return toks, starts, n

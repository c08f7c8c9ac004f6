"""Temperature sampling for the serving programs: a counter-based Gumbel-max
draw (the port's counterpart of the JAX package's ``jax.random`` keys in
``repro.serve.cascade_server``: ``_slot_sampler`` and the batch ``_sample``).

JAX's PRNG cannot be reproduced in PyTorch, so the port draws its own bits:
every draw is a pure function of a 32-bit key, a position, a member and a
vocabulary index, computed with integer tensor operations (xor, shift, a
multiply and a mask, all in int64 with every product below 2**63) that give
the same bits on the CPU and on the card.  A token is

    argmax_v (logits[v] / T + g[v]),  g = -log(-log(u)),  u in (0, 1)

from the top 23 bits of the draw: a sample of ``softmax(logits / T)``.  The
sampler holds no generator state, so a captured program that samples draws
fresh values at each replay only through its staged key and position
inputs.

Keys:

* continuous batching (``TierBackend``): a slot's key is
  ``fold_in(base_key(seed), admission_seq)``, set when the pool admits the
  slot, so a slot's sampled trajectory depends on its occupant's admission
  order and its own positions only — not on the slot index, ``n_slots``,
  or which other slots share its decode steps;
* batch generation (``CascadeTier.generate``): row b's key is
  ``fold_in(base_key(seed), b)``, the draw position the fed token's.

Member e of a tier draws on its index in the tier's stacked order, so a
rank that holds members ``[offset, offset + E)`` of a tier split over a
mesh's 'pod' axis passes ``member_offset=offset`` and draws what the
unplaced tier draws for those members.  Likewise ``batch_keys(seed, B,
rows=...)`` keys rows by their index in the whole batch.

``T <= 0`` is greedy: the first index of the largest logit.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
# two-round 32-bit integer hash (xor-shift-multiply); both multipliers are
# below 2**31, so every product of a 32-bit value stays below 2**63 in int64
_MUL1, _MUL2 = 0x21F0AAAD, 0x735A2D97
_GOLDEN = 0x9E3779B9
_ROOT = 0x5EED


def mix32(x):
    """A bijective 32-bit hash of ``x`` in [0, 2**32): Python ints, numpy
    int64 arrays and int64 tensors alike, bitwise the same everywhere."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & M32
    return x ^ (x >> 15)


def fold_in(key, data):
    """A new 32-bit key from ``key`` and ``data`` (ints or arrays of them,
    broadcast)."""
    return mix32((key ^ mix32((data + _GOLDEN) & M32)) & M32)


def base_key(seed: int) -> int:
    """The root key of ``seed``."""
    return int(fold_in(_ROOT, int(seed) & M32))


def batch_keys(seed: int, B: int, rows=None) -> np.ndarray:
    """(B,) int64 row keys of a batch generation under ``seed``: row b
    keyed by ``rows[b]`` (default b), its index in the whole batch."""
    rows = np.arange(B, dtype=np.int64) if rows is None else np.asarray(rows, np.int64)
    assert rows.shape == (B,), (rows.shape, B)
    return fold_in(np.int64(base_key(seed)), rows)


def draw_bits(keys: torch.Tensor, pos: torch.Tensor, E: int, V: int, member_offset: int = 0) -> torch.Tensor:
    """(E, B, V) int64 draws in [0, 2**32) for row keys (B,) at positions
    (B,), member ``member_offset + e`` and vocabulary index v."""
    dev = keys.device
    kp = fold_in(keys.to(torch.int64), pos.to(torch.int64))  # (B,)
    members = torch.arange(member_offset, member_offset + E, device=dev, dtype=torch.int64)
    ke = fold_in(kp[None, :], members[:, None])  # (E, B)
    vcode = mix32((torch.arange(V, device=dev, dtype=torch.int64) + _GOLDEN) & M32)  # (V,)
    return mix32(ke[..., None] ^ vcode)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel noise, float32, from 32-bit draws: u = (top 23 bits + 1/2) /
    2**23, exact in float32 and strictly inside (0, 1) (24 bits would round
    the largest draw up to 1)."""
    u = ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, keys, pos, temperature: float, member_offset: int = 0) -> torch.Tensor:
    """Tokens (E, B) int32 from member logits (E, B, V): greedy at
    ``temperature <= 0``, else the Gumbel-max draw of row keys ``keys`` (B,)
    at positions ``pos`` ((B,) or one int for every row), member e drawn
    as the tier's member ``member_offset + e``."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    E, B, V = logits.shape
    keys = torch.as_tensor(keys, device=logits.device)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(torch.int64)
    elif np.ndim(pos) == 0:  # a fill, no host copy (a captured prefill's position is its bucket's)
        pos = torch.full((B,), int(pos), dtype=torch.int64, device=logits.device)
    else:
        pos = torch.as_tensor(np.asarray(pos, np.int64), device=logits.device)
    pos = pos.expand(B)
    g = gumbel(draw_bits(keys, pos, E, V, member_offset))
    return (logits.float() / temperature + g).argmax(-1).to(torch.int32)

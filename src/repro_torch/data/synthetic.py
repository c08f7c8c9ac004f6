"""Synthetic tasks with controllable easy/hard structure (a copy of
``repro.data.synthetic``, numpy only: the same samples for every seed).

ABC's premise is that a sizable subset of inference data is 'easy' — solvable
by small models.  Offline (no external datasets), we generate tasks where
that structure is explicit and tunable, so the paper's claims (selection
rates, drop-in accuracy, Fig. 2/3/7 shapes) are checkable quantitatively:

* :class:`MixtureTask` — classification over token sequences.  'Easy'
  examples reveal the label through a dedicated marker token at the read
  position (any small model learns it in ~100 steps); 'hard' examples hide
  it in a bag-of-tokens linear feature over the whole sequence that needs
  far more capacity/steps.  Calibrated so a small ensemble is accurate and
  *in agreement* exactly on the easy subset — the structure ABC exploits.

* :func:`sequence_task` — next-token LM data over a Markov chain with
  per-position entropy spikes, used by the train CLI.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MixtureTask:
    vocab: int = 256
    n_classes: int = 16
    seq_len: int = 64
    easy_frac: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # marker ids are exclusive (regular tokens never collide with them)
        self.markers = np.arange(self.n_classes, 2 * self.n_classes)
        self.w = rng.normal(0, 1, (self.vocab, self.n_classes))

    def sample(self, n: int, seed: int = 1):
        rng = np.random.default_rng(seed)
        lo = 2 * self.n_classes
        toks = rng.integers(lo, self.vocab, (n, self.seq_len))
        feats = np.zeros((n, self.vocab))
        np.add.at(feats, (np.arange(n)[:, None], toks), 1.0)
        labels = np.argmax(feats @ self.w + rng.gumbel(0, 0.5, (n, self.n_classes)), -1)
        easy = rng.random(n) < self.easy_frac
        toks[easy, -1] = self.markers[labels[easy]]  # marker at read position
        return (
            toks.astype(np.int32),
            labels.astype(np.int32),
            easy,
        )


def sequence_task(
    n: int, seq_len: int, vocab: int = 512, order: int = 2, seed: int = 0
):
    """Markov-chain LM data: tokens (n, seq_len+1) for input/target split."""
    rng = np.random.default_rng(seed)
    # sparse transition structure: each context maps to ~8 likely tokens
    n_ctx = 4096
    probs = np.zeros((n_ctx, vocab), np.float64)
    for c in range(n_ctx):
        support = rng.choice(vocab, 8, replace=False)
        probs[c, support] = rng.dirichlet(np.ones(8) * 0.5)
    out = np.zeros((n, seq_len + 1), np.int64)
    state = rng.integers(0, vocab, (n, order))
    for t in range(seq_len + 1):
        ctx = (state[:, -2] * 31 + state[:, -1]) % n_ctx
        cum = probs[ctx].cumsum(axis=1)
        u = rng.random((n, 1))
        tok = (u < cum).argmax(axis=1)
        out[:, t] = tok
        state = np.concatenate([state[:, 1:], tok[:, None]], axis=1)
    return out.astype(np.int32)

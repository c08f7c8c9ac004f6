"""Trained-router baselines (paper §2.2; port of
``repro.core.router_baselines``) — the setups ABC competes with.

A small learned router à la FrugalGPT: a logistic scorer on feature
vectors (here the tier's logits summarised by ``logits_features``) trained
to predict "is the tier's answer right", used exactly like a score-based
deferral rule.  ``train_router`` is plain gradient descent on the logistic
loss through ``torch.autograd``; its cost is the per-task setup cost the
paper notes the baselines pay.  The margin rule lives with the other rules
in ``core.deferral``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.deferral import RuleOutput
from repro_torch.device import resolve_device


@dataclasses.dataclass
class LearnedRouter:
    w: torch.Tensor  # (F,)
    b: torch.Tensor  # ()
    mu: torch.Tensor  # (F,) feature normalisation
    sd: torch.Tensor  # (F,)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        z = (feats.to(self.w.device) - self.mu) / self.sd
        return torch.sigmoid(z @ self.w + self.b)


def logits_features(logits: torch.Tensor) -> torch.Tensor:
    """Router features from tier logits (B, V): top-1 probability, top-1
    minus top-2, normalised entropy and logsumexp."""
    lf = logits.float()
    p = torch.softmax(lf, -1)
    top2 = p.topk(2, dim=-1).values
    ent = -(p * torch.log(p + 1e-9)).sum(-1) / math.log(lf.shape[-1])
    lse = torch.logsumexp(lf, -1)
    return torch.stack([top2[:, 0], top2[:, 0] - top2[:, 1], ent, lse], -1)


def _router_loss(w, b, Xn, y):
    z = Xn @ w + b
    return (torch.relu(z) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()


def train_router(
    feats: np.ndarray,  # (N, F)
    correct: np.ndarray,  # (N,) bool — was the tier's answer right?
    *,
    steps: int = 300,
    lr: float = 0.1,
    seed: int = 0,
    device=None,
) -> LearnedRouter:
    """Logistic regression by ``steps`` steps of gradient descent from
    weights drawn N(0, 0.01²) by a ``torch.Generator`` seeded ``seed``."""
    device = resolve_device(device)
    X = torch.as_tensor(np.array(feats, np.float32), device=device)
    y = torch.as_tensor(np.asarray(correct, np.float32), device=device)
    mu, sd = X.mean(0), X.std(0, unbiased=False) + 1e-6
    Xn = (X - mu) / sd
    g = torch.Generator(device=device).manual_seed(seed)
    w = (torch.randn(X.shape[1], generator=g, device=device) * 0.01).requires_grad_()
    b = torch.zeros((), device=device, requires_grad=True)
    for _ in range(steps):
        gw, gb = torch.autograd.grad(_router_loss(w, b, Xn, y), (w, b))
        with torch.no_grad():
            w -= lr * gw
            b -= lr * gb
    return LearnedRouter(w=w.detach(), b=b.detach(), mu=mu, sd=sd)


def router_rule(router: LearnedRouter, logits: torch.Tensor, theta: float) -> RuleOutput:
    """A trained router used as a deferral rule (FrugalGPT-style)."""
    if logits.ndim == 3:
        logits = logits[0]
    s = router.score(logits_features(logits))
    return RuleOutput(pred=logits.argmax(-1).to(torch.int32), score=s, defer=s <= theta)

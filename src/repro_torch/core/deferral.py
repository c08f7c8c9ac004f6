"""Deferral rules (port of ``repro.core.deferral``).

  vote (Eq. 3)   defer when the majority vote fraction <= theta
  score (Eq. 4)  defer when the mean majority-class probability <= theta
  confidence     single-model max-softmax <= theta
  entropy        1 - normalised entropy <= theta
  margin         top-1 minus top-2 probability <= theta
  vote_preds     Eq. 3 on member answer ids (E, B) — black-box generation

Each rule maps statistics to a (B,) bool defer mask plus the prediction the
tier would emit.  vote and score go through the agreement kernel.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.agreement import ops as agree_ops


@dataclasses.dataclass(frozen=True)
class RuleOutput:
    pred: torch.Tensor  # (B,) int32 tier prediction
    score: torch.Tensor  # (B,) f32 the statistic s(x)
    defer: torch.Tensor  # (B,) bool r(x)=1


def vote_rule(logits: torch.Tensor, theta: float) -> RuleOutput:
    stats = agree_ops.agreement(logits)
    s = stats["vote_frac"]
    return RuleOutput(pred=stats["pred"], score=s, defer=s <= theta)


def vote_rule_from_preds(preds: torch.Tensor, theta: float) -> RuleOutput:
    """preds (E, B) member answers; tie-break: most votes, then the
    smallest id (ids must stay below 2**30)."""
    E = preds.shape[0]
    votes = (preds[:, None, :] == preds[None, :, :]).sum(0)
    vmax = votes.max(0, keepdim=True).values
    pred = torch.where(votes == vmax, preds, 2**30).min(0).values.to(torch.int32)
    s = vmax[0].float() / E
    return RuleOutput(pred=pred, score=s, defer=s <= theta)


def score_rule(logits: torch.Tensor, theta: float) -> RuleOutput:
    stats = agree_ops.agreement(logits)
    s = stats["mean_score"]
    return RuleOutput(pred=stats["pred"], score=s, defer=s <= theta)


def confidence_rule(logits: torch.Tensor, theta: float) -> RuleOutput:
    if logits.ndim == 3:
        logits = logits[0]
    s = torch.softmax(logits.float(), -1).amax(-1)
    return RuleOutput(pred=logits.argmax(-1).to(torch.int32), score=s, defer=s <= theta)


def entropy_rule(logits: torch.Tensor, theta: float) -> RuleOutput:
    if logits.ndim == 3:
        logits = logits.mean(0)
    logp = torch.log_softmax(logits.float(), -1)
    ent = -(logp.exp() * logp).sum(-1) / math.log(logits.shape[-1])
    s = 1.0 - ent
    return RuleOutput(pred=logits.argmax(-1).to(torch.int32), score=s, defer=s <= theta)


def margin_rule(logits: torch.Tensor, theta: float) -> RuleOutput:
    """Top-1/top-2 probability margin (``core.router_baselines.margin_rule``)."""
    if logits.ndim == 3:
        logits = logits.mean(0)
    top2 = torch.softmax(logits.float(), -1).topk(2, dim=-1).values
    s = top2[:, 0] - top2[:, 1]
    return RuleOutput(pred=logits.argmax(-1).to(torch.int32), score=s, defer=s <= theta)


RULES = {
    "vote": vote_rule,
    "score": score_rule,
    "confidence": confidence_rule,
    "entropy": entropy_rule,
    "margin": margin_rule,
    "vote_preds": vote_rule_from_preds,
}


def apply_rule(kind: str, logits: torch.Tensor, theta: float) -> RuleOutput:
    return RULES[kind](logits, theta)

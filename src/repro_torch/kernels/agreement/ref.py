"""Naive oracle for the ABC agreement reduce (port of
``repro.kernels.agreement.ref``): full softmax, argmax, majority vote with
the canonical tie-break (most votes, then the smallest class id)."""
from __future__ import annotations

import torch


def agreement_ref(logits: torch.Tensor):
    E = logits.shape[0]
    lf = logits.float()
    top1 = lf.argmax(-1).to(torch.int32)  # (E, B)
    votes = (top1[:, None, :] == top1[None, :, :]).sum(0)
    vmax = votes.max(0, keepdim=True).values
    pred = torch.where(votes == vmax, top1, 2**30).min(0).values.to(torch.int32)
    probs = torch.softmax(lf, -1)
    p_maj = probs.gather(2, pred.long()[None, :, None].expand(E, -1, 1))[..., 0]
    return {
        "pred": pred,
        "vote_frac": vmax[0].float() / E,
        "mean_score": p_maj.mean(0),
    }

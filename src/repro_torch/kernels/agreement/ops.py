"""Agreement reduce: ``agreement(logits)`` with logits (E, B, V) returns
``{'pred', 'vote_frac', 'mean_score'}`` per example — the inputs to the
paper's deferral rules r_v (Eq. 3) and r_s (Eq. 4).

``member_stats`` is the V sweep (max, first-index argmax, sum exp(x-max)
per member).  On a CUDA tensor it launches ``csrc/agreement.cu``, which
replaces ``src/repro/kernels/agreement/kernel.py`` ``member_stats_pallas``
and is bound by the E*B*V*4 bytes it reads (each row split over a cluster
of up to 8 blocks, one launch); on a CPU tensor it runs the plain version
below.  The O(E^2 B) vote epilogue is plain PyTorch on
either device, as in the JAX package.  The kernel is inference-only: on
a CUDA tensor that requires grad under grad mode it raises
(``build.inference_only``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.obs import op_charges

_LAUNCHES = build.launch_counter("agreement")


def member_stats_plain(logits: torch.Tensor):
    lf = logits.float()
    m = lf.amax(-1)
    idx = lf.argmax(-1).to(torch.int32)
    l = torch.exp(lf - m[..., None]).sum(-1)
    return m, idx, l


def _member_stats_cuda(logits: torch.Tensor):
    build.inference_only("member_stats", logits)
    build.require_cuda(logits, "member_stats logits", (torch.float32,), align=4)
    if logits.ndim != 3:
        raise ValueError(f"member_stats: expected logits (E, B, V), got {tuple(logits.shape)}")
    E, B, V = logits.shape
    m = torch.empty((E, B), dtype=torch.float32, device=logits.device)
    l = torch.empty_like(m)
    idx = torch.empty((E, B), dtype=torch.int32, device=logits.device)
    rc = build.entry("agreement", "agreement_member_stats")(
        logits.data_ptr(), m.data_ptr(), idx.data_ptr(), l.data_ptr(), E * B, V, build.stream_ptr(logits),
    )
    if rc:
        build.check(build.library("agreement"), rc, "agreement_member_stats")
    _LAUNCHES.add(1)
    return m, idx, l


def cost(logits: torch.Tensor) -> dict:
    """The V sweep's work: the logits read once, (m, idx, l) written (12
    bytes a row), 4 f32 operations a logit (max, compare, exp, add)."""
    E, B = logits.shape[:2]
    return build.kernel_cost(build.nbytes(logits) + E * B * 12, 4 * logits.numel(), "f32")


def member_stats(logits: torch.Tensor):
    """(m, idx, l), each (E, B): per-member max, argmax (first index on
    ties) and sum exp(x - max) over V.  On meta tensors: outputs of these
    shapes, the call's ``cost`` charged to the active op counter."""
    if logits.device.type == "cpu":
        return member_stats_plain(logits)
    if logits.device.type == "meta":
        return op_charges.meta_call(_member_stats_meta, logits)
    return _member_stats_cuda(logits)


def _member_stats_meta(logits: torch.Tensor):
    op_charges.charge_kernel("agreement", cost(logits))
    m = logits.new_empty(logits.shape[:2], dtype=torch.float32)
    return m, logits.new_empty(logits.shape[:2], dtype=torch.int32), torch.empty_like(m)


def _epilogue(logits, m, idx, l):
    """Majority vote + mean majority-class probability from member stats
    (E, B).  Tie-break: most votes, then the smallest class id."""
    E = logits.shape[0]
    votes = (idx[:, None, :] == idx[None, :, :]).sum(0)  # (E, B)
    vmax = votes.max(0, keepdim=True).values
    pred = torch.where(votes == vmax, idx, 2**30).min(0).values.to(torch.int32)
    lm = logits.float().gather(2, pred.long()[None, :, None].expand(E, -1, 1))[..., 0]
    p_maj = torch.exp(lm - m) / l
    return {
        "pred": pred,
        "vote_frac": vmax[0].float() / E,
        "mean_score": p_maj.mean(0),
    }


def agreement(logits: torch.Tensor):
    m, idx, l = member_stats(logits)
    return _epilogue(logits, m, idx, l)

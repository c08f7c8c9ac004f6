"""Naive host-loop oracle for deferral compaction (port of
``repro.kernels.compaction.ref``): row d of the output is the d-th deferred
row of ``x``; rows past the count are zero; index_map is -1 there."""
from __future__ import annotations

import numpy as np
import torch


def compact_ref(x: torch.Tensor, mask: torch.Tensor):
    xs = x.detach().cpu()
    ms = mask.detach().cpu().numpy().astype(bool)
    B = xs.shape[0]
    out = torch.zeros_like(xs)
    index_map = np.full((B,), -1, np.int32)
    d = 0
    for i in range(B):
        if ms[i]:
            out[d] = xs[i]
            index_map[d] = i
            d += 1
    return out, torch.from_numpy(index_map), torch.tensor(d, dtype=torch.int32)


def scatter_back_ref(values: torch.Tensor, index_map: torch.Tensor, total: int):
    vs = values.detach().cpu()
    im = index_map.detach().cpu().numpy()
    out = torch.zeros((total,) + tuple(vs.shape[1:]), dtype=vs.dtype)
    for d in range(vs.shape[0]):
        if im[d] >= 0:
            out[int(im[d])] = vs[d]
    return out

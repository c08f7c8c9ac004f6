"""Deferral compaction: a defer mask becomes a dense compacted payload plus
an index map without the payload visiting the host.

  out (B, ...)      rows [0, count) are the deferred rows of ``x`` in
                    original order; rows past the count are zero
  index_map (B,)    original row index per output row, -1 past the count
  count ()          number of deferred rows (the one scalar a router reads)

On a CUDA tensor ``compact_indices`` launches the scan and ``gather_rows``
the row copy of ``csrc/compaction.cu`` (which replaces
``src/repro/kernels/compaction/kernel.py`` ``compact_pallas``; bound by
the payload bytes read and written).  The copy is byte-exact for every
dtype, so unlike the JAX package's one-hot f32 matmul there is no separate
integer route: ``compact_tree`` scans the mask once and gathers every leaf
through the shared map.  On a CPU tensor the plain versions below run.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_LAUNCHES = build.launch_counter("compaction")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def compact_indices_plain(mask: torch.Tensor):
    m = mask.to(torch.int32)
    B = m.shape[0]
    pos = torch.cumsum(m, 0, dtype=torch.int32) - m
    dst = torch.where(mask.bool(), pos, B).long()
    index_map = torch.full((B + 1,), -1, dtype=torch.int32, device=mask.device)
    index_map[dst] = torch.arange(B, dtype=torch.int32, device=mask.device)
    return index_map[:B], m.sum().to(torch.int32)


def gather_rows_plain(x: torch.Tensor, index_map: torch.Tensor):
    safe = torch.where(index_map >= 0, index_map, 0).long()
    keep = (index_map >= 0).reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x[safe], torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _compact_indices_cuda(mask: torch.Tensor):
    mask = mask.to(torch.bool)
    build.require_cuda(mask, "compaction mask", (torch.bool,), align=1)
    B = mask.shape[0]
    index_map = torch.empty((B,), dtype=torch.int32, device=mask.device)
    count = torch.empty((), dtype=torch.int32, device=mask.device)
    lib = build.library("compaction")
    rc = lib.compaction_scan(
        build.ptr(mask), build.ptr(index_map), build.ptr(count),
        ctypes.c_int(B), build.stream_ptr(mask),
    )
    build.check(lib, rc, "compaction_scan")
    _LAUNCHES.add(1)
    return index_map, count


def _gather_rows_cuda(x: torch.Tensor, index_map: torch.Tensor):
    row_bytes = math.prod(x.shape[1:]) * x.element_size()
    word = next(w for w in (16, 4, 2, 1) if row_bytes % w == 0)
    build.require_cuda(x, "gather_rows payload", (x.dtype,), align=word)
    build.require_cuda(index_map, "gather_rows index_map", (torch.int32,), align=4)
    out = torch.empty((index_map.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    lib = build.library("compaction")
    rc = lib.compaction_gather(
        build.ptr(x), build.ptr(index_map), build.ptr(out),
        ctypes.c_int(index_map.shape[0]), ctypes.c_long(row_bytes),
        ctypes.c_int(word), build.stream_ptr(x),
    )
    build.check(lib, rc, "compaction_gather")
    _LAUNCHES.add(1)
    return out


# ---------------------------------------------------------------------------
# public API (dispatch by device)
# ---------------------------------------------------------------------------


def compact_indices(mask: torch.Tensor):
    """(index_map (B,) i32, count () i32) for a (B,) defer mask."""
    if mask.device.type == "cpu":
        return compact_indices_plain(mask)
    return _compact_indices_cuda(mask)


def gather_rows(x: torch.Tensor, index_map: torch.Tensor):
    """out[i] = x[index_map[i]], zero rows where index_map[i] < 0; exact
    for every dtype.  The output has index_map's row count."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, index_map)
    return _gather_rows_cuda(x, index_map)


def compact(x: torch.Tensor, mask: torch.Tensor):
    """x: (B, ...); mask: (B,) bool.  Returns (out, index_map, count), all
    on x's device, ``out`` shaped and typed like ``x``."""
    index_map, count = compact_indices(mask)
    return gather_rows(x, index_map), index_map, count


def compact_tree(tree: dict, mask: torch.Tensor):
    """Compact every (B, ...) leaf of a flat dict under one defer mask:
    one scan, then one row gather per leaf.  Returns (tree, index_map,
    count)."""
    index_map, count = compact_indices(mask)
    return {k: gather_rows(v, index_map) for k, v in tree.items()}, index_map, count


def scatter_back(values: torch.Tensor, index_map: torch.Tensor, total: int):
    """out[index_map[d]] = values[d] for every d with index_map[d] >= 0 —
    a (B,)-sized scatter, plain PyTorch on every device (as in JAX)."""
    dst = torch.where(index_map >= 0, index_map, total).long()
    out = torch.zeros((total + 1,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    out[dst] = values
    return out[:total]

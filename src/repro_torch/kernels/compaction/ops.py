"""Deferral compaction: a defer mask becomes a dense compacted payload plus
an index map without the payload visiting the host.

  out (B, ...)      rows [0, count) are the deferred rows of ``x`` in
                    original order; rows past the count are zero
  index_map (B,)    original row index per output row, -1 past the count
  count ()          number of deferred rows (the one scalar a router reads)

On CUDA tensors every call is one launch of ``csrc/compaction.cu`` (which
replaces ``src/repro/kernels/compaction/kernel.py`` ``compact_pallas``;
bound by the payload bytes read and written): ``compact_tree`` scans the
mask and copies every leaf through the shared map in that launch (a
further launch for each further 8 leaves), ``compact_indices`` is the scan
alone and ``gather_rows`` the copy through a given map.  The copy is
byte-exact for every dtype, so unlike the JAX package's one-hot f32 matmul
there is no separate integer route.  ``paged_kv_view`` gathers chunked
prefill's K and V views of a block-paged pool in one launch of the same
source.  On CPU tensors the plain versions below run.  Every CUDA entry
is inference-only: a CUDA input that requires grad under grad mode raises
(``build.inference_only``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.obs import op_charges

_LAUNCHES = build.launch_counter("compaction")
MAX_LEAVES = 8  # leaves one launch copies (kMaxLeaves in csrc/compaction.cu)


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


def pool_row_index(pages: torch.Tensor, E: int, P: int) -> torch.Tensor:
    """(E * B * n_pg,) row index into a member-stacked pool flattened to
    (E * P, ...): member e's copy of table entry p is row e * P + p; -1
    (unmapped) stays -1."""
    flat = pages.reshape(-1).to(torch.int32)
    off = torch.arange(E, dtype=torch.int32, device=pages.device)[:, None] * P
    return torch.where(flat >= 0, flat[None, :] + off, -1).reshape(-1)


def member_pool(pool: torch.Tensor) -> torch.Tensor:
    """A 4-D pool (P, KVH, page_size, hd) as one member plane."""
    return pool[None] if pool.ndim == 4 else pool


def paged_pool_view(pool: torch.Tensor, pages: torch.Tensor, gather) -> torch.Tensor:
    """(E*B, KVH, n_pg * page_size, hd) per-slot contiguous view of an
    (E, P, KVH, page_size, hd) pool (or a 4-D pool, E = 1) through the
    (B, n_pg) table; unmapped entries come out as zero rows.  ``gather`` is
    the row gather: ``gather_rows`` or its plain version."""
    pool = member_pool(pool)
    E, P, KVH, ps, hd = pool.shape
    B, n_pg = pages.shape
    rows = gather(pool.reshape(E * P, KVH, ps, hd), pool_row_index(pages, E, P))
    return (
        rows.reshape(E * B, n_pg, KVH, ps, hd)
        .permute(0, 2, 1, 3, 4)
        .reshape(E * B, KVH, n_pg * ps, hd)
    )


def paged_kv_view_plain(k_pool: torch.Tensor, v_pool: torch.Tensor, pages: torch.Tensor):
    return paged_pool_view(k_pool, pages, gather_rows_plain), paged_pool_view(v_pool, pages, gather_rows_plain)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _check(rc: int, what: str) -> None:
    if rc:
        build.check(build.library("compaction"), rc, what)


def _word(row_bytes: int, *ptrs: int) -> int:
    """The widest copy word (16, 8, 4, 2 or 1 bytes) that divides the row
    and aligns every pointer."""
    word = 16
    while row_bytes % word or any(p % word for p in ptrs):
        word //= 2
    return word


def _leaf(src: torch.Tensor, rows: int, what: str):
    """(output, its descriptor) for one leaf: src, dst, row bytes, word."""
    if not src.is_cuda or not src.is_contiguous() or src.ndim == 0 or src.shape[0] != rows:
        raise ValueError(f"{what}: expected a contiguous CUDA tensor of {rows} rows, got "
                         f"{tuple(src.shape)} on {src.device}")
    dst = torch.empty_like(src)
    row_bytes = math.prod(src.shape[1:]) * src.element_size()
    s, d = src.data_ptr(), dst.data_ptr()
    return dst, (s, d, row_bytes, _word(row_bytes, s, d))


def _leaf_table(descs):
    return (ctypes.c_longlong * (4 * len(descs)))(*(v for d in descs for v in d))


def _launches(n_leaves: int) -> int:
    return max(1, -(-n_leaves // MAX_LEAVES))


def _compact_tree_cuda(tree: dict, mask: torch.Tensor):
    build.inference_only("compact", *tree.values())
    if mask.dtype != torch.bool:
        mask = mask.to(torch.bool)
    if not mask.is_cuda or mask.ndim != 1 or not mask.is_contiguous():
        raise ValueError(f"compaction mask: expected a contiguous (B,) CUDA tensor, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    B, dev = mask.shape[0], mask.get_device()
    outs, descs = {}, []
    for k, v in tree.items():
        if v.get_device() != dev:
            raise ValueError(f"compaction leaf {k}: on {v.device}, the mask on {mask.device}")
        outs[k], desc = _leaf(v, B, f"compaction leaf {k}")
        descs.append(desc)
    imc = torch.empty((B + 1,), dtype=torch.int32, device=mask.device)  # index map, then the count
    rc = build.entry("compaction", "compaction_compact")(
        mask.data_ptr(), B, imc.data_ptr(), imc.data_ptr() + 4 * B, _leaf_table(descs), len(descs),
        build.stream_ptr(mask),
    )
    _check(rc, "compaction_compact")
    _LAUNCHES.add(_launches(len(descs)))
    return outs, imc[:B], imc[B]


def _gather_rows_cuda(x: torch.Tensor, index_map: torch.Tensor):
    build.inference_only("gather_rows", x)
    build.require_cuda(index_map, "gather_rows index_map", (torch.int32,), align=4)
    rows = index_map.shape[0]
    if not x.is_cuda or not x.is_contiguous() or x.ndim == 0:
        raise ValueError(f"gather_rows payload: expected a contiguous CUDA tensor, got {x.device}")
    out = torch.empty((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    row_bytes = math.prod(x.shape[1:]) * x.element_size()
    desc = (x.data_ptr(), out.data_ptr(), row_bytes, _word(row_bytes, x.data_ptr(), out.data_ptr()))
    rc = build.entry("compaction", "compaction_gather")(
        index_map.data_ptr(), rows, _leaf_table([desc]), 1, build.stream_ptr(x),
    )
    _check(rc, "compaction_gather")
    if rows:
        _LAUNCHES.add(1)
    return out


def _paged_kv_view_cuda(k_pool: torch.Tensor, v_pool: torch.Tensor, pages: torch.Tensor):
    build.inference_only("paged_kv_view", k_pool, v_pool)
    kp, vp = member_pool(k_pool), member_pool(v_pool)
    for name, t in (("k_pool", kp), ("v_pool", vp)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"paged_kv_view {name}: expected a contiguous CUDA tensor")
    build.require_cuda(pages, "paged_kv_view pages", (torch.int32,), align=4)
    E, P, KVH, ps, hd = kp.shape
    if vp.shape != kp.shape or vp.dtype != kp.dtype or pages.ndim != 2:
        raise ValueError(f"paged_kv_view: pools {tuple(kp.shape)} / {tuple(vp.shape)} and table "
                         f"{tuple(pages.shape)} do not agree")
    B, n_pg = pages.shape
    out = torch.empty((2, E * B, KVH, n_pg * ps, hd), dtype=kp.dtype, device=kp.device)
    tile = ps * hd * kp.element_size()
    o = out.data_ptr()
    half = o + out.nbytes // 2
    rc = build.entry("compaction", "compaction_paged_kv_view")(
        kp.data_ptr(), vp.data_ptr(), pages.data_ptr(), o, half, E, P, KVH, B, n_pg, tile,
        _word(tile, kp.data_ptr(), vp.data_ptr(), o, half), build.stream_ptr(kp),
    )
    _check(rc, "compaction_paged_kv_view")
    if out.numel():
        _LAUNCHES.add(1)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# public API (dispatch by device)
# ---------------------------------------------------------------------------


def compact_cost(tree: dict, mask: torch.Tensor, count=None) -> dict:
    """``compact_tree``'s work: the mask read, the index map and count
    written, the ``count`` deferred rows of every leaf read and the
    compacted leaves written (all B rows, zeros past the count).  ``count``
    None (a meta call): every row deferred."""
    B = mask.shape[0]
    n = B if count is None else int(count)
    row_bytes = sum(v[0].numel() * v.element_size() for v in tree.values())
    return build.kernel_cost(B * mask.element_size() + 4 * B + 4 + n * row_bytes + B * row_bytes, 0, "f32")


def gather_cost(x: torch.Tensor, index_map: torch.Tensor) -> dict:
    """``gather_rows``' work: the map read, each output row read and written."""
    row_bytes = math.prod(x.shape[1:]) * x.element_size()
    return build.kernel_cost(build.nbytes(index_map) + 2 * index_map.shape[0] * row_bytes, 0, "f32")


def paged_kv_view_cost(k_pool: torch.Tensor, v_pool: torch.Tensor, pages: torch.Tensor, mapped=None) -> dict:
    """``paged_kv_view``'s work: the ``mapped`` pages of both pools read
    (default: every table entry), both views written whole, the table
    read."""
    E, P, KVH, ps, hd = member_pool(k_pool).shape
    B, n_pg = pages.shape
    n = B * n_pg if mapped is None else int(mapped)
    tile = ps * hd * k_pool.element_size()
    return build.kernel_cost(2 * (E * n * KVH * tile + E * B * n_pg * KVH * tile) + build.nbytes(pages), 0, "f32")


def _meta_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return x.new_empty((rows,) + tuple(x.shape[1:]))


def _gather_rows_meta(x, index_map):
    op_charges.charge_kernel("compaction", gather_cost(x, index_map))
    return _meta_rows(x, index_map.shape[0])


def _compact_tree_meta(tree, mask):
    op_charges.charge_kernel("compaction", compact_cost(tree, mask))
    B = mask.shape[0]
    return ({k: _meta_rows(v, B) for k, v in tree.items()}, mask.new_empty((B,), dtype=torch.int32),
            mask.new_empty((), dtype=torch.int32))


def _paged_kv_view_meta(k_pool, v_pool, pages):
    op_charges.charge_kernel("compaction", paged_kv_view_cost(k_pool, v_pool, pages))
    E, P, KVH, ps, hd = member_pool(k_pool).shape
    B, n_pg = pages.shape
    return tuple(k_pool.new_empty((E * B, KVH, n_pg * ps, hd)) for _ in range(2))


def compact_indices(mask: torch.Tensor):
    """(index_map (B,) i32, count () i32) for a (B,) defer mask."""
    if mask.device.type == "cpu":
        return compact_indices_plain(mask)
    _, index_map, count = compact_tree({}, mask)
    return index_map, count


def gather_rows(x: torch.Tensor, index_map: torch.Tensor):
    """out[i] = x[index_map[i]], zero rows where index_map[i] < 0; exact
    for every dtype.  The output has index_map's row count."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, index_map)
    if x.device.type == "meta":
        return op_charges.meta_call(_gather_rows_meta, x, index_map)
    return _gather_rows_cuda(x, index_map)


def compact(x: torch.Tensor, mask: torch.Tensor):
    """x: (B, ...); mask: (B,) bool.  Returns (out, index_map, count), all
    on x's device, ``out`` shaped and typed like ``x``."""
    out, index_map, count = compact_tree({"x": x}, mask)
    return out["x"], index_map, count


def compact_tree(tree: dict, mask: torch.Tensor):
    """Compact every (B, ...) leaf of a flat dict under one defer mask.
    Returns (tree, index_map, count).  On the card: one launch for the scan
    and up to 8 leaves."""
    if mask.device.type == "cpu":
        index_map, count = compact_indices_plain(mask)
        return {k: gather_rows_plain(v, index_map) for k, v in tree.items()}, index_map, count
    if mask.device.type == "meta":
        return op_charges.meta_call(_compact_tree_meta, tree, mask)
    return _compact_tree_cuda(tree, mask)


def paged_kv_view(k_pool: torch.Tensor, v_pool: torch.Tensor, pages: torch.Tensor):
    """(k_view, v_view), each (E*B, KVH, n_pg * page_size, hd): the per-slot
    contiguous views of one layer's (E, P, KVH, page_size, hd) pools (or 4-D
    pools, E = 1) through the (B, n_pg) int32 table, unmapped entries as zero
    rows — bitwise ``paged_pool_view`` of each pool.  One launch on the card."""
    if k_pool.device.type == "cpu":
        return paged_kv_view_plain(k_pool, v_pool, pages)
    if k_pool.device.type == "meta":
        return op_charges.meta_call(_paged_kv_view_meta, k_pool, v_pool, pages)
    return _paged_kv_view_cuda(k_pool, v_pool, pages)


def scatter_back(values: torch.Tensor, index_map: torch.Tensor, total: int):
    """out[index_map[d]] = values[d] for every d with index_map[d] >= 0 —
    a (B,)-sized scatter, plain PyTorch on every device (as in JAX)."""
    dst = torch.where(index_map >= 0, index_map, total).long()
    out = torch.zeros((total + 1,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    out[dst] = values
    return out[:total]

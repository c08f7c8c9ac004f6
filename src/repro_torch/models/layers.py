"""Shared building blocks: norms, RoPE, MLP, GQA attention, LM head.

Ports ``repro.models.layers``: the dense layer's pieces and the MoE
block (``init_moe``/``apply_moe``).  Every function carries
the ensemble axis E explicitly: activations are (E, B, S, ...) and each
parameter leaf has a leading E axis, where the JAX package ``vmap``s a
single-model function.  The weight products are batched matmuls over E
(``torch.einsum``); around the attention kernels E folds into the batch.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.compaction import ops as compaction_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.params import Initializer


def _per_member(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape an (E, *tail) parameter to broadcast against x (E, ..., *tail)."""
    return w.reshape((w.shape[0],) + (1,) * (x.ndim - w.ndim) + tuple(w.shape[1:]))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(ini: Initializer, cfg: ModelConfig, d: int):
    if cfg.norm_type == "rmsnorm":
        return {"scale": ini.ones((d,), dtype=torch.float32)}
    if cfg.norm_type == "layernorm":
        return {
            "scale": ini.ones((d,), dtype=torch.float32),
            "bias": ini.zeros((d,), dtype=torch.float32),
        }
    if cfg.norm_type == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(p, x, cfg: ModelConfig):
    """Computes in f32 and casts back to x's dtype (as the JAX package)."""
    xf = x.float()
    if cfg.norm_type == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * _per_member(p["scale"], xf)
    else:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        if cfg.norm_type == "layernorm":
            y = y * _per_member(p["scale"], xf) + _per_member(p["bias"], xf)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half convention)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(ini: Initializer, cfg: ModelConfig, d: Optional[int] = None, d_ff: Optional[int] = None):
    d, f = d or cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_activation == "silu":
        return {
            "w_gate": ini.normal((d, f)),
            "w_up": ini.normal((d, f)),
            "w_down": ini.normal((f, d)),
        }
    return {
        "w_in": ini.normal((d, f)),
        "b_in": ini.zeros((f,)),
        "w_out": ini.normal((f, d)),
        "b_out": ini.zeros((d,)),
    }


def apply_mlp(p, x, cfg: ModelConfig):
    """x (E, B, S, D)."""
    if cfg.mlp_activation == "silu":
        h = F.silu(torch.einsum("ebsd,edf->ebsf", x, p["w_gate"])) * torch.einsum(
            "ebsd,edf->ebsf", x, p["w_up"]
        )
        return torch.einsum("ebsf,efd->ebsd", h, p["w_down"])
    h = F.gelu(torch.einsum("ebsd,edf->ebsf", x, p["w_in"]) + _per_member(p["b_in"], x), approximate="tanh")
    return torch.einsum("ebsf,efd->ebsd", h, p["w_out"]) + _per_member(p["b_out"], x)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity-dropped, scatter dispatch)
# ---------------------------------------------------------------------------


def init_moe(ini: Initializer, cfg: ModelConfig):
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": ini.normal((d, n), dtype=torch.float32),
        "w_gate": ini.normal((n, d, f)),
        "w_up": ini.normal((n, d, f)),
        "w_down": ini.normal((n, f, d)),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(ini, cfg, d, f * cfg.n_shared_experts)
    return p


def moe_capacity(T: int, S: int, cfg: ModelConfig) -> int:
    """Rows of each expert's buffer for T tokens of sequence length S: a
    2x balance slack (at least 8, at most T) for a decode step (S == 1),
    ``capacity_factor`` of the even share for a sequence."""
    n, K = cfg.n_experts, cfg.top_k
    if S == 1:
        return min(T, max(8, int(math.ceil(T * K / n * 2.0))))
    return max(1, int(math.ceil(T * K / n * cfg.capacity_factor)))


def top_k_first(probs: torch.Tensor, K: int):
    """The K largest values along the last axis and their indices, largest
    first and, among equal values, the lowest index first (the order of
    ``lax.top_k``): K rounds of argmax, each masking the index it took.
    ``torch.topk`` leaves the order of ties open."""
    vals, idx, rest = [], [], probs
    for _ in range(K):
        i = rest.argmax(-1, keepdim=True)  # the first of the maxima
        vals.append(probs.gather(-1, i))
        idx.append(i)
        rest = rest.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


def router_probs(p, xt):
    """Softmax of the f32 router over the experts: xt (E, T, D) -> (E, T, n)."""
    return torch.softmax(torch.bmm(xt.float(), p["router"]), -1)


def moe_route(p, xt, S: int, cfg: ModelConfig, probs=None):
    """The routing of ``apply_moe`` for tokens xt (E, T, D) of sequence
    length S (``probs``: their ``router_probs``, computed here if not
    given): (gates (E, T, K) f32 renormalised, experts (E, T, K) int64,
    each (token, k)'s position in its expert's buffer (E, T*K), capacity);
    a choice is kept where its position is below the capacity.  The gates
    are values of ``probs``, so a loss reaches the router through them."""
    E, T, _ = xt.shape
    n, K = cfg.n_experts, cfg.top_k
    probs = router_probs(p, xt) if probs is None else probs
    gate, expert = top_k_first(probs, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = (expert.reshape(E, T * K, 1) == torch.arange(n, device=xt.device)).to(torch.int32)
    pos = ((torch.cumsum(onehot, 1) - onehot) * onehot).sum(-1)  # exclusive running count
    return gate, expert, pos, moe_capacity(T, S, cfg)


def load_balance_loss(probs, expert, cfg: ModelConfig):
    """Switch-style load-balancing term of each member over its own T
    tokens: n_experts * sum_e(mean router prob of e * share of the T*K
    choices that picked e) * router_aux_coef -> (E,) f32.  The choice
    shares carry no gradient; the mean probabilities do."""
    E, T, n = probs.shape
    picked = (expert.reshape(E, -1, 1) == torch.arange(n, device=probs.device)).sum(1)
    share = picked.to(torch.float32) / expert[0].numel()
    return n * (probs.mean(1) * share).sum(-1) * cfg.router_aux_coef


def apply_moe(p, x, cfg: ModelConfig, *, with_aux: bool = False):
    """x (E, B, S, D) -> out (E, B, S, D); with ``with_aux`` (out, aux),
    aux the (E,) ``load_balance_loss`` (training asks for it; the serving
    paths never compute it).

    Per member, as the JAX package's ``apply_moe`` under ``vmap``: the
    T = B * S tokens of ONE member route among themselves.  Each token
    picks its top-k experts from a softmax of the f32 router, the gates
    renormalised to sum to one; its position in an expert's buffer is the
    exclusive running count of earlier (token, k) choices of that expert;
    a choice at or past ``moe_capacity`` rows is dropped (its zeroed row
    added into the buffer's last row, which leaves a kept row there
    unchanged).  The experts run as batched products over (member,
    expert) on the (E, n_experts, capacity, D) buffers; each token sums its
    kept choices' outputs times their gates, plus the shared expert where
    the config has one.  Static shapes and no value read back to the host,
    so the call can be captured in a CUDA graph."""
    E, B, S, D = x.shape
    n, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(E, T, D)
    probs = router_probs(p, xt)
    gate, expert, pos, capacity = moe_route(p, xt, S, cfg, probs)
    keep = (pos < capacity).to(x.dtype)
    slot = expert.reshape(E, T * K) * capacity + pos.clamp(max=capacity - 1)  # row of (n * capacity)
    contrib = (xt[:, :, None, :] * keep.reshape(E, T, K, 1)).reshape(E, T * K, D)
    rows = slot[..., None].expand(E, T * K, D)
    buf = torch.zeros((E, n * capacity, D), dtype=x.dtype, device=x.device).scatter_add_(1, rows, contrib)
    h = buf.reshape(E, n, capacity, D)
    a = F.silu(torch.matmul(h, p["w_gate"])) * torch.matmul(h, p["w_up"])
    out = torch.matmul(a, p["w_down"]).reshape(E, n * capacity, D)
    picked = out.gather(1, rows).reshape(E, T, K, D)
    combined = (picked * (gate.to(x.dtype) * keep.reshape(E, T, K))[..., None]).sum(2)
    if cfg.n_shared_experts:
        combined = combined + apply_mlp(p["shared"], xt[:, None], cfg)[:, 0]
    out = combined.reshape(E, B, S, D)
    return (out, load_balance_loss(probs, expert, cfg)) if with_aux else out


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def init_attention(ini: Initializer, cfg: ModelConfig):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": ini.normal((d, H, hd)),
        "wk": ini.normal((d, K, hd)),
        "wv": ini.normal((d, K, hd)),
        "wo": ini.normal((H, hd, d), std=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((H, hd))
        p["bk"] = ini.zeros((K, hd))
        p["bv"] = ini.zeros((K, hd))
    if cfg.attn_out_bias:
        p["bo"] = ini.zeros((d,))
    return p


def qkv_project(p, x, cfg: ModelConfig, positions):
    """x (E, B, S, D) -> q (E, B, S, H, hd), k and v (E, B, S, KVH, hd)."""
    q = torch.einsum("ebsd,edhk->ebshk", x, p["wq"])
    k = torch.einsum("ebsd,edhk->ebshk", x, p["wk"])
    v = torch.einsum("ebsd,edhk->ebshk", x, p["wv"])
    if "bq" in p:
        q = q + _per_member(p["bq"], q)
        k = k + _per_member(p["bk"], k)
        v = v + _per_member(p["bv"], v)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_output(p, ctx, cfg: ModelConfig):
    out = torch.einsum("ebshk,ehkd->ebsd", ctx, p["wo"])
    if "bo" in p:
        out = out + _per_member(p["bo"], out)
    return out


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(E, B, ...) -> (E*B, ...) for the attention kernels."""
    return t.reshape((t.shape[0] * t.shape[1],) + tuple(t.shape[2:]))


def attention_layer(p, x, cfg: ModelConfig, *, causal: bool, positions=None,
                    sliding_window: Optional[int] = None, starts=None):
    """Full-sequence (prefill) attention.  ``starts`` (B,) is the left-pad
    carve-out: row b attends no column < starts[b]; callers pass positions
    taken relative to it.  Returns (out, (k, v))."""
    E, B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = qkv_project(p, x, cfg, positions)
    ctx = flash_ops.flash_attention(
        _fold(q), _fold(k), _fold(v), causal=causal, window=sliding_window,
        softcap=cfg.attn_logit_softcap,
        starts=None if starts is None else starts.repeat(E),
    )
    return attn_output(p, ctx.reshape(q.shape), cfg), (k, v)


def attention_decode(p, x, cfg: ModelConfig, k_cache, v_cache, cur_index, *,
                     sliding_window: Optional[int] = None, starts=None):
    """Single-token decode.  Caches (E, B, KVH, S_max, hd) are the
    kernel-native layout, updated IN PLACE (the JAX package returns new
    caches; writing one row in place saves a copy of the whole cache per
    step).  ``cur_index`` is the shared scalar position (an int) or a (B,)
    int64 tensor of per-slot positions on the cache's device (continuous
    batching): each slot writes its row at its own position and attends
    rows ``< pos + 1``.  Returns out."""
    E, B = x.shape[:2]
    vector_pos = isinstance(cur_index, torch.Tensor)
    if vector_pos:
        positions = cur_index[:, None]
    else:
        positions = torch.full((B, 1), int(cur_index), device=x.device)
    if starts is not None:
        positions = positions - starts[:, None]
    q, k, v = qkv_project(p, x, cfg, positions)
    if vector_pos:
        members = torch.arange(E, device=x.device)[:, None]
        rows = torch.arange(B, device=x.device)[None, :]
        k_cache[members, rows, :, cur_index[None, :]] = k[:, :, 0].to(k_cache.dtype)
        v_cache[members, rows, :, cur_index[None, :]] = v[:, :, 0].to(v_cache.dtype)
        cur_len = (cur_index + 1).to(torch.int32).repeat(E)
    else:
        k_cache[:, :, :, cur_index, :] = k[:, :, 0].to(k_cache.dtype)
        v_cache[:, :, :, cur_index, :] = v[:, :, 0].to(v_cache.dtype)
        cur_len = int(cur_index) + 1
    ctx = dec_ops.decode_attention_bksd(
        _fold(q), _fold(k_cache), _fold(v_cache), cur_len=cur_len,
        window=sliding_window, softcap=cfg.attn_logit_softcap,
        starts=None if starts is None else starts.repeat(E),
    )
    return attn_output(p, ctx.reshape(q.shape), cfg)


def chunk_positions(start: torch.Tensor, C: int) -> torch.Tensor:
    """(1, C) int64 positions [start, start + C) of a chunk whose first
    position is the (1,) device tensor ``start``: built on the device, so a
    captured chunk program reads a new offset at every replay."""
    return start.reshape(1, 1).to(torch.int64) + torch.arange(C, device=start.device)[None, :]


def attention_prefill_chunk(p, x, cfg: ModelConfig, k_cache, v_cache, slot: torch.Tensor, start: torch.Tensor, *,
                            sliding_window: Optional[int] = None):
    """Chunked-prefill attention for one slot (continuous batching).

    x: (E, 1, C, D) — a C-token chunk of one request's prompt; caches are
    the layer's (E, n_slots, KVH, S_max, hd) slabs; ``slot`` and ``start``
    (the absolute position of the chunk's first token) are (1,) int64
    tensors on the cache's device, so nothing here is a Python int a graph
    would freeze.  Writes the chunk's K/V at rows [start, start+C) of
    ``slot`` IN PLACE (an index write) and attends each chunk token
    causally over the slot's rows — row t is visible to chunk token j iff
    t <= start+j, so stale rows of a slot's previous occupant stay
    invisible.  Returns out (E, 1, C, D)."""
    E, _, C, _ = x.shape
    positions = chunk_positions(start, C)  # (1, C)
    q, k, v = qkv_project(p, x, cfg, positions)
    # (n_slots, S_max, E, KVH, hd) views: rows (slot, start + j) take token j
    at = (slot, positions[0])
    k_cache.permute(1, 3, 0, 2, 4).index_put_(at, k[:, 0].transpose(0, 1).to(k_cache.dtype))
    v_cache.permute(1, 3, 0, 2, 4).index_put_(at, v[:, 0].transpose(0, 1).to(v_cache.dtype))
    # the slot's (E, KVH, S_max, hd) rows, contiguous like the paged path's
    # gathered view, so both reach the same matmuls and stay bitwise equal
    k_view = k_cache.index_select(1, slot)[:, 0]
    v_view = v_cache.index_select(1, slot)[:, 0]
    ctx = _chunk_attend(_fold(q), k_view, v_view, positions, cfg, sliding_window)
    return attn_output(p, ctx.reshape(q.shape), cfg)


def _chunk_attend(q, k_view, v_view, positions, cfg: ModelConfig, sliding_window):
    """Masked-softmax chunk attention over a (B, KVH, S, hd) cache view —
    the one implementation behind both the dense and the paged chunk
    prefill, which is what makes their outputs bitwise identical: masked
    lanes are pinned to -1e30 so their softmax weight underflows to exactly
    0.0, hiding stale dense rows and unmapped paged rows alike.  Plain
    PyTorch on every device, as in the JAX package (no kernel computes
    it)."""
    B, C, H, hd = q.shape
    KVH, S = k_view.shape[1], k_view.shape[2]
    G = H // KVH
    qg = q.reshape(B, C, KVH, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bckgd,bksd->bkgcs", qg, k_view.float())
    if cfg.attn_logit_softcap is not None:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    cols = torch.arange(S, device=q.device)[None, :]  # (1, S)
    rows = positions[0][:, None]  # (C, 1)
    mask = cols <= rows
    if sliding_window is not None:
        mask &= cols > rows - sliding_window
    s = torch.where(mask[None, None, None], s, dec_ops.NEG_INF)
    pr = torch.softmax(s, -1)
    ctx = torch.einsum("bkgcs,bksd->bckgd", pr, v_view.float())
    return ctx.reshape(B, C, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# block-paged attention (serve/paging.py owns the table)
# ---------------------------------------------------------------------------


class PagedStep(NamedTuple):
    """One decode step's addressing of the paged pools, built once per step
    by ``paged_step`` and shared by every layer: nothing here is re-sent to
    the device, and nothing is read back, inside the layer loop."""

    positions: torch.Tensor  # (B, 1) int64 RoPE positions
    cur_len: torch.Tensor  # (B,) int32 = pos + 1
    pages: torch.Tensor  # (B, n_pg) int32 page table
    members: torch.Tensor  # (E, 1) int64 member-plane index
    write_page: torch.Tensor  # (1, B) int64, the overflow sink where unmapped
    write_off: torch.Tensor  # (1, B) int64 row inside the page


def paged_step(pos, pages, *, E: int, n_pages: int, page_size: int, device) -> PagedStep:
    """``pos`` (B,) per-slot positions and ``pages`` the (B, n_pg) table,
    host numpy or tensors: each goes to ``device`` once."""
    pos = torch.as_tensor(pos, device=device).to(torch.int64)
    pages = torch.as_tensor(pages, device=device).to(torch.int32)
    pg = torch.gather(pages, 1, (pos // page_size)[:, None])[:, 0].to(torch.int64)
    return PagedStep(
        positions=pos[:, None],
        cur_len=(pos + 1).to(torch.int32),
        pages=pages,
        members=torch.arange(E, device=device)[:, None],
        write_page=torch.where(pg >= 0, pg, n_pages - 1)[None, :],  # overflow sink
        write_off=(pos % page_size)[None, :],
    )


def attention_decode_paged(p, x, cfg: ModelConfig, k_pool, v_pool, step: PagedStep, *,
                           sliding_window: Optional[int] = None):
    """Single-token decode against a block-paged KV pool.

    x (E, B, 1, D); pools (E, P, KVH, page_size, hd), one layer's slabs,
    under ONE page table for all E member planes.  The new K/V row
    scatters IN PLACE into each slot's current page (an unmapped row lands
    on the overflow sink — the last pool page); attention runs page by page
    through the table (``decode_attention_paged``), bitwise the dense slot
    cache on the card and on the CPU.  Returns out."""
    q, k, v = qkv_project(p, x, cfg, step.positions)
    k_pool[step.members, step.write_page, :, step.write_off] = k[:, :, 0].to(k_pool.dtype)
    v_pool[step.members, step.write_page, :, step.write_off] = v[:, :, 0].to(v_pool.dtype)
    ctx = dec_ops.decode_attention_paged(
        _fold(q), k_pool, v_pool, step.pages, step.cur_len,
        window=sliding_window, softcap=cfg.attn_logit_softcap,
    )
    return attn_output(p, ctx.reshape(q.shape), cfg)


def attention_prefill_chunk_paged(p, x, cfg: ModelConfig, k_pool, v_pool, start: torch.Tensor, pages_row, *,
                                  sliding_window: Optional[int] = None):
    """Chunked-prefill attention for one slot against the paged pool.

    x: (E, 1, C, D); pools (E, P, KVH, page_size, hd); ``start`` the (1,)
    int64 position of the chunk's first token and ``pages_row`` the slot's
    (n_pg,) int32 table row, both on the pool's device.  The chunk's K/V
    rows scatter IN PLACE into the mapped pages at their in-page offsets,
    then the chunk attends over the slot's gathered view through the same
    ``_chunk_attend`` as the dense path — bitwise what the dense slot row
    computes.  Returns out (E, 1, C, D)."""
    E, _, C, _ = x.shape
    ps = k_pool.shape[-2]
    positions = chunk_positions(start, C)  # (1, C)
    q, k, v = qkv_project(p, x, cfg, positions)
    pg = pages_row[positions[0] // ps].to(torch.int64)
    pg = torch.where(pg >= 0, pg, k_pool.shape[1] - 1)[None, :]  # overflow sink
    off = (positions % ps)
    members = torch.arange(E, device=x.device)[:, None]
    k_pool[members, pg, :, off] = k[:, 0].to(k_pool.dtype)
    v_pool[members, pg, :, off] = v[:, 0].to(v_pool.dtype)
    k_view, v_view = compaction_ops.paged_kv_view(k_pool, v_pool, pages_row[None])  # (E, KVH, S, hd)
    ctx = _chunk_attend(_fold(q), k_view, v_view, positions, cfg, sliding_window)
    return attn_output(p, ctx.reshape(q.shape), cfg)


def project_logits(params, x, cfg: ModelConfig):
    """Final norm + LM head: x (E, ..., D) -> f32 logits (E, ..., V).  The
    product runs in the weights' dtype and is cast to f32 afterwards."""
    x = apply_norm(params["final_norm"], x, cfg)
    head = params["lm_head"] if "lm_head" in params else params["embed"].transpose(-1, -2)
    E, D = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(E, -1, D), head)
    return out.reshape(tuple(x.shape[:-1]) + (head.shape[-1],)).float()

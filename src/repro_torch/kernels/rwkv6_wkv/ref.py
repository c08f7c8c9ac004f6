"""Naive per-step recurrence oracle for RWKV6 (Finch) WKV (port of
``repro.kernels.rwkv6_wkv.ref``).

Per head with channel dim D (state S: D_k x D_v):
    y_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
with data-dependent per-channel decay w_t = exp(logw_t) in (0, 1]; inputs
carry logw directly as log(w_t) <= 0.

``u`` is the (H, D) bonus of one model, or (E, H, D) for E members whose
rows are stacked member-major along the batch: row b reads member
b // (B / E).
"""
from __future__ import annotations

import torch


def u_rows(u: torch.Tensor, B: int) -> torch.Tensor:
    """(H, D) or (E, H, D) bonus -> (B, H, D) f32, one row per batch row."""
    u = u.float()
    if u.ndim == 2:
        return u[None].expand(B, *u.shape)
    E = u.shape[0]
    if B % E:
        raise ValueError(f"batch {B} is not a multiple of the {E} members of u")
    return u.repeat_interleave(B // E, 0)


def wkv6_ref(r, k, v, logw, u, *, initial_state=None, return_final_state=False):
    """r, k, v, logw (B, S, H, D); u (H, D) or (E, H, D); initial_state
    (B, H, D, D) [key, value]."""
    B, S, H, D = r.shape
    rf, kf, vf = (a.float() for a in (r, k, v))
    wf = torch.exp(logw.float())
    uf = u_rows(u, B)
    s = torch.zeros((B, H, D, D), device=r.device) if initial_state is None else initial_state.float()
    ys = []
    for t in range(S):
        kv = torch.einsum("bhi,bhj->bhij", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], s + uf[..., None] * kv))
        s = s * wf[:, t, ..., None] + kv
    y = torch.stack(ys, 1).to(r.dtype)
    return (y, s) if return_final_state else y


def wkv6_step_ref(r, k, v, logw, u, state):
    """Single decode step: r, k, v, logw (B, H, D); state (B, H, D, D)."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    wf = torch.exp(logw.float())
    uf = u_rows(u, r.shape[0])
    kv = torch.einsum("bhi,bhj->bhij", kf, vf)
    y = torch.einsum("bhi,bhij->bhj", rf, state + uf[..., None] * kv)
    new = state * wf[..., None] + kv
    return y.to(r.dtype), new

"""Naive per-step recurrence oracle for the Mamba2 SSD (port of
``repro.kernels.mamba2_ssd.ref``).

Recurrence (per batch b, head h):
    a_t = exp(A_h * dt_t)                                (scalar decay)
    H_t = a_t * H_{t-1} + dt_t * B_t x_t^T               (H: N x P)
    y_t = C_t^T H_t                                      (P,)
with B_t, C_t in R^N shared across the heads of a group.

``A`` is the (H,) decay of one model, or (E, H) for E members whose rows
are stacked member-major along the batch: row b reads member b // (B / E).
"""
from __future__ import annotations

import torch


def a_rows(A: torch.Tensor, B: int) -> torch.Tensor:
    """(H,) or (E, H) decay -> (B, H) f32, one row per batch row."""
    A = A.float()
    if A.ndim == 1:
        return A[None].expand(B, A.shape[0])
    E = A.shape[0]
    if B % E:
        raise ValueError(f"batch {B} is not a multiple of the {E} members of A")
    return A.repeat_interleave(B // E, 0)


def ssd_ref(x, dt, A, Bm, Cm, *, initial_state=None, return_final_state=False):
    """x (B, S, H, P); dt (B, S, H) > 0; A (H,) or (E, H) < 0; Bm, Cm
    (B, S, G, N); initial_state (B, H, N, P)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf, dtf = x.float(), dt.float()
    Bf = Bm.float().repeat_interleave(rep, 2)  # (B, S, H, N)
    Cf = Cm.float().repeat_interleave(rep, 2)
    Af = a_rows(A, B)
    h = torch.zeros((B, H, N, P), device=x.device) if initial_state is None else initial_state.float()
    ys = []
    for t in range(S):
        a = torch.exp(Af * dtf[:, t])  # (B, H)
        h = h * a[..., None, None] + torch.einsum("bhn,bhp->bhnp", Bf[:, t], xf[:, t] * dtf[:, t, :, None])
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], h))
    y = torch.stack(ys, 1).to(x.dtype)
    return (y, h) if return_final_state else y


def ssd_step_ref(x, dt, A, Bm, Cm, state):
    """Single decode step: x (B, H, P), dt (B, H), Bm/Cm (B, G, N), state
    (B, H, N, P) -> (y, new_state)."""
    H, G = x.shape[1], Bm.shape[1]
    rep = H // G
    Bf = Bm.float().repeat_interleave(rep, 1)
    Cf = Cm.float().repeat_interleave(rep, 1)
    dtf = dt.float()
    a = torch.exp(a_rows(A, x.shape[0]) * dtf)
    new = state * a[..., None, None] + torch.einsum("bhn,bhp->bhnp", Bf, x.float() * dtf[..., None])
    y = torch.einsum("bhn,bhnp->bhp", Cf, new)
    return y.to(x.dtype), new

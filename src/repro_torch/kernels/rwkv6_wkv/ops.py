"""Chunked RWKV6 WKV: ``wkv6(r, k, v, logw, u)`` with r, k, v, logw
(B, S, H, D) — the JAX package's public layout — and the bonus ``u`` as
(H, D) or (E, H, D) for E members folded member-major into the batch
(row b reads member b // (B / E)).

On a CUDA tensor it launches ``csrc/rwkv6_wkv.cu`` (r, k, v bf16 or f32,
logw f32, any D, any S including 1), which replaces
``src/repro/kernels/rwkv6_wkv/kernel.py`` ``wkv6_pallas``: the exact
per-step recurrence, register-tiled at D in {16, 32, 64} (a thread owns 16
keys of 4 value columns, or 8 of 2 when the call has few (row, head)
pairs), a thread a value column with D read at run time at any other D;
bound by its f32 operations at S > 1, by the state's bytes at S = 1.  Its inputs
are read with 16-byte loads, so a view off a 16-byte boundary is copied
first.  On a CPU tensor the plain version runs: the JAX package's
``_xla_wkv6``, chunk 32, exact pairwise decay exp(ecum_t - cum_s) (every
exponent <= 0) and zero padding of a ragged last chunk.  ``wkv6_step`` (one
decode step) is plain PyTorch on every device, as in the JAX package; the
models' decode goes through ``wkv6`` at S = 1 instead, as the TPU path does.

Training: when grad mode is on and an input requires grad, a CUDA call
goes through ``WKV6Function`` (a ``torch.autograd.Function``): its forward
is the kernel; its backward recomputes ``wkv6_plain`` on the same inputs
under autograd and takes ``torch.autograd.grad`` of it — the counterpart
of XLA differentiating ``_xla_wkv6`` in the JAX package.  A backward
kernel is later work.  On a CPU tensor autograd runs through the plain
version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.obs import op_charges
from repro_torch.kernels.rwkv6_wkv.ref import u_rows, wkv6_step_ref

_LAUNCHES = build.launch_counter("rwkv6_wkv")


def _chunk_body(s, r, k, v, logw, u):
    """One chunk: r, k, v, logw (B, H, L, D) f32; u (B, H, D); s (B, H, D, D)."""
    L = r.shape[2]
    cum = torch.cumsum(logw, 2)  # inclusive
    ecum = cum - logw  # exclusive: sum_{s<t}
    diff = ecum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, H, L, L, D)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), -1)[None, None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    A = torch.einsum("bhtd,bhsd,bhtsd->bhts", r, k, decay)
    diag = torch.einsum("bhtd,bhd,bhtd->bht", r, u, k)  # bonus-u self term
    A = A + diag[..., None] * torch.eye(L, device=r.device)[None, None]
    y = torch.einsum("bhts,bhsd->bhtd", A, v)
    y = y + torch.einsum("bhtd,bhde->bhte", r * torch.exp(ecum), s)
    w_end = torch.exp(cum[:, :, -1:, :] - cum)
    s = s * torch.exp(cum[:, :, -1, :])[..., None] + torch.einsum("bhsd,bhse->bhde", k * w_end, v)
    return s, y


def wkv6_plain(r, k, v, logw, u, *, chunk: int = 32, initial_state=None):
    """The chunked pairwise form.  Returns (y (B, S, H, D) r.dtype, sT
    (B, H, D, D) f32)."""
    B, S, H, D = r.shape
    L = min(chunk, S)
    pad = (-S) % L
    # zero k/v and zero log-decay padding is exact: it adds nothing to the
    # outputs and leaves the final state untouched
    to = lambda a: F.pad(a.float(), (0, 0, 0, 0, 0, pad)).reshape(B, -1, L, H, D).permute(1, 0, 3, 2, 4)
    rc, kc, vc, lc = (to(a) for a in (r, k, v, logw))
    uf = u_rows(u, B)
    s = torch.zeros((B, H, D, D), device=r.device) if initial_state is None else initial_state.float()
    ys = []
    for i in range(rc.shape[0]):
        s, y = _chunk_body(s, rc[i], kc[i], vc[i], lc[i], uf)
        ys.append(y)
    y = torch.stack(ys, 0).permute(1, 0, 3, 2, 4).reshape(B, S + pad, H, D)[:, :S]
    return y.to(r.dtype), s


def _aligned_or_copy(t):
    """``t`` contiguous and on a 16-byte boundary, as the kernel's 16-byte
    loads need: a view at an odd storage offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _wkv6_cuda(r, k, v, logw, u, *, initial_state):
    B, S, H, D = r.shape
    r, k, v, logw = (_aligned_or_copy(t) for t in (r, k, v, logw))
    for name, t in (("r", r), ("k", k), ("v", v)):
        build.require_cuda(t, f"wkv6 {name}", (torch.bfloat16, torch.float32))
    build.require_cuda(logw, "wkv6 logw", (torch.float32,))
    if not (k.shape == v.shape == logw.shape == r.shape) or not (k.dtype == v.dtype == r.dtype):
        raise ValueError(f"wkv6: unsupported shapes r {tuple(r.shape)} logw {tuple(logw.shape)} or dtypes")
    uu = _aligned_or_copy((u[None] if u.ndim == 2 else u).to(device=r.device, dtype=torch.float32))
    E = uu.shape[0]
    if uu.shape[1:] != (H, D) or B % E:
        raise ValueError(f"wkv6: u {tuple(u.shape)} does not fit batch {B}, heads {H}, D {D}")
    if initial_state is not None:
        initial_state = _aligned_or_copy(initial_state.to(torch.float32))
        build.require_cuda(initial_state, "wkv6 initial_state", (torch.float32,))
        if initial_state.shape != (B, H, D, D):
            raise ValueError(f"wkv6: initial_state {tuple(initial_state.shape)} != {(B, H, D, D)}")
    y = torch.empty_like(r)
    sT = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    lib = build.library("rwkv6_wkv")
    rc = lib.rwkv6_wkv_fwd(
        build.ptr(r), build.ptr(k), build.ptr(v), build.ptr(logw), build.ptr(uu),
        ctypes.c_void_p(None if initial_state is None else initial_state.data_ptr()),
        build.ptr(y), build.ptr(sT),
        ctypes.c_int(B), ctypes.c_int(S), ctypes.c_int(H), ctypes.c_int(D), ctypes.c_int(B // E),
        ctypes.c_int(int(r.dtype == torch.bfloat16)), build.stream_ptr(r),
    )
    build.check(lib, rc, "rwkv6_wkv_fwd")
    _LAUNCHES.add(1)
    return y, sT


def cost(r, k, v, logw, u, *, initial_state=None) -> dict:
    """A call's work: r, k, v, logw, u (and the initial state) read once, y
    and the final f32 state written once; the per-step recurrence's 5 f32
    operations a state element and step (k v, S w + k v, r S)."""
    B, S, H, D = r.shape
    n_bytes = build.nbytes(r, k, v, logw, u, initial_state) + build.nbytes(r) + B * H * D * D * 4
    return build.kernel_cost(n_bytes, 5 * B * S * H * D * D, "f32")


def _wkv6_meta(r, k, v, logw, u, *, initial_state):
    op_charges.charge_kernel("rwkv6_wkv", cost(r, k, v, logw, u, initial_state=initial_state))
    B, S, H, D = r.shape
    return torch.empty_like(r), r.new_empty((B, H, D, D), dtype=torch.float32)


def _wkv6_on_meta(r, k, v, logw, u, initial_state):
    """The meta route: under grad through ``WKV6Function``, so that its
    backward (the plain version's recompute) is counted too."""
    if build.needs_grad(r, k, v, logw, u, initial_state):
        return WKV6Function.apply(r, k, v, logw, u, initial_state)
    return _wkv6_meta(r, k, v, logw, u, initial_state=initial_state)


class WKV6Function(torch.autograd.Function):
    """(y, sT) of the kernel forward, gradients by recompute of ``wkv6_plain``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, initial_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, initial_state)
        return (_wkv6_meta if r.device.type == "meta" else _wkv6_cuda)(r, k, v, logw, u, initial_state=initial_state)

    @staticmethod
    def backward(ctx, gy, gsT):
        plain = lambda r, k, v, logw, u, s0: wkv6_plain(r, k, v, logw, u, initial_state=s0)
        return build.recompute_grads(ctx, plain, ctx.saved_tensors, (gy, gsT))


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,
    u: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    return_final_state: bool = False,
):
    """y (B, S, H, D) in r's dtype, and with ``return_final_state`` the
    final (B, H, D, D) f32 state."""
    if r.device.type == "cpu":
        y, sT = wkv6_plain(r, k, v, logw, u, initial_state=initial_state)
    elif r.device.type == "meta":
        y, sT = op_charges.meta_call(_wkv6_on_meta, r, k, v, logw, u, initial_state)
    elif build.needs_grad(r, k, v, logw, u, initial_state):
        y, sT = WKV6Function.apply(r, k, v, logw, u, initial_state)
    else:
        y, sT = _wkv6_cuda(r, k, v, logw, u, initial_state=initial_state)
    return (y, sT) if return_final_state else y


def wkv6_step(r, k, v, logw, u, state):
    """Single decode step, plain on every device: r, k, v, logw (B, H, D);
    state (B, H, D, D) -> (y (B, H, D), new state)."""
    return wkv6_step_ref(r, k, v, logw, u, state)

"""Chunked Mamba2 SSD (state-space dual): ``ssd(x, dt, A, Bm, Cm)`` with x
(B, S, H, P), dt (B, S, H), Bm and Cm (B, S, G, N) — the JAX package's
public layout — and the decay ``A`` as (H,) or (E, H) for E members folded
member-major into the batch (row b reads member b // (B / E)).

On a CUDA tensor ``ssd`` launches ``csrc/mamba2_ssd.cu``, which replaces
``src/repro/kernels/mamba2_ssd/kernel.py`` ``ssd_pallas`` and reads x, B
and C in place with their strides (views of the block's xBC tensor), dt and
A as they come: the pre-scaling x~ = dt·x, l = A·dt is fused into it, so a
call is one device launch.  x, B and C share one dtype.  bf16 takes the
chunked dual form on the tensor cores (TF32, P in {32, 64}, N in {16, 32,
64}); f32 the exact per-step recurrence (P <= 128, N in {8, 16, 32, 64});
any G dividing H, any S.  On a CPU tensor the plain version runs: the JAX
package's ``_xla_ssd``, chunk 128, with intra-chunk (C·Bᵀ ⊙ exp(cum_t -
cum_s))·x~, inter-chunk C·e^cum·h and the state update h·e^total +
(B·e^(total-cum))ᵀ·x~ (every exponent <= 0), and zero padding of a ragged
last chunk.  ``ssd_step`` (one decode step) is plain PyTorch on every
device, as in the JAX package.  On a meta tensor (the dry run) ``ssd``
computes nothing: it returns the outputs' shapes and charges the active op
counter its ``cost``.

Training: when grad mode is on and an input requires grad, a CUDA call
goes through ``SSDFunction`` (a ``torch.autograd.Function``): its forward
is the kernel; its backward recomputes ``ssd_plain`` on the same inputs
under autograd and takes ``torch.autograd.grad`` of it — the counterpart
of XLA differentiating ``_xla_ssd`` in the JAX package.  A backward kernel
is later work.  On a CPU tensor autograd runs through the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.obs import op_charges
from repro_torch.kernels.mamba2_ssd.ref import a_rows, ssd_step_ref

_LAUNCHES = build.launch_counter("mamba2_ssd")


def prescale(x, dt, A):
    """(x~ = dt·x (B, S, H, P) f32, l = A·dt (B, S, H) f32)."""
    dtf = dt.float()
    return x.float() * dtf[..., None], a_rows(A, x.shape[0])[:, None, :] * dtf


def ssd_plain(x, dt, A, Bm, Cm, *, chunk: int = 128, initial_state=None):
    """The chunked dual form.  Returns (y (B, S, H, P) x.dtype, hT
    (B, H, N, P) f32)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = min(chunk, S)
    pad = (-S) % L
    nc = (S + pad) // L
    xf, lf = prescale(x, dt, A)
    # zero x~ / zero l padding is exact: decay exp(0) = 1 and zero input
    # leave the state untouched; padded outputs are discarded
    ch = lambda a: F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad)).reshape(B, nc, L, *a.shape[2:]).transpose(0, 1)
    xc, lc, Bc, Cc = ch(xf), ch(lf), ch(Bm.float()), ch(Cm.float())
    h = torch.zeros((B, H, N, P), device=x.device) if initial_state is None else initial_state.float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    ys = []
    for i in range(nc):
        cum = torch.cumsum(lc[i].transpose(1, 2), -1)  # (B, H, L)
        total = cum[..., -1:]
        gmat = torch.einsum("blgn,bsgn->bgls", Cc[i], Bc[i]).repeat_interleave(rep, 1)  # (B, H, L, L)
        diff = cum[..., :, None] - cum[..., None, :]
        decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        xh = xc[i].transpose(1, 2)  # (B, H, L, P)
        y = torch.einsum("bhls,bhsp->bhlp", gmat * decay, xh)
        crep = Cc[i].repeat_interleave(rep, 2).transpose(1, 2)  # (B, H, L, N)
        y = y + torch.einsum("bhln,bhnp->bhlp", crep * torch.exp(cum)[..., None], h)
        brep = Bc[i].repeat_interleave(rep, 2).transpose(1, 2)
        h = h * torch.exp(total)[..., None] + torch.einsum(
            "bhln,bhlp->bhnp", brep * torch.exp(total - cum)[..., None], xh)
        ys.append(y.transpose(1, 2))  # (B, L, H, P)
    y = torch.stack(ys, 1).reshape(B, nc * L, H, P)[:, :S]
    return y.to(x.dtype), h


def _aligned(t):
    """True when every row the dual kernel copies by 16-byte cp.async starts
    on a 16-byte boundary: the data pointer and every stride but the last."""
    return t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0 for st in t.stride()[:-1])


def _ssd_cuda(x, dt, A, Bm, Cm, *, initial_state):
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dual = x.dtype == torch.bfloat16  # the chunked dual form on the tensor cores; f32: per step
    fits = (P in (32, 64) and N in (16, 32, 64)) if dual else (P <= 128 and N in (8, 16, 32, 64))
    if not fits or H % G or Bm.shape != Cm.shape or Bm.shape[:2] != (B, S) or dt.shape != (B, S, H):
        raise ValueError(f"ssd: unsupported shapes x {tuple(x.shape)} ({x.dtype}) dt {tuple(dt.shape)} "
                         f"B {tuple(Bm.shape)} C {tuple(Cm.shape)}")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd {name}: expected a CUDA tensor, got {t.device}")
    # the Mamba2 block hands x, B and C over as views of one xBC tensor
    if x.dtype not in (torch.bfloat16, torch.float32) or not (Bm.dtype == Cm.dtype == x.dtype):
        raise TypeError(f"ssd: x, B, C dtypes {x.dtype}, {Bm.dtype}, {Cm.dtype}: one of (bf16, f32) for all three")
    # x, B and C are read in place with their strides (the Mamba2 block hands
    # over views of one xBC tensor); a view whose innermost dim is strided,
    # whose B and C strides differ, or (dual form) whose rows miss 16-byte
    # boundaries is copied first, in its own dtype
    if x.stride(-1) != 1 or (dual and not _aligned(x)):
        x = x.contiguous()
    if Bm.stride() != Cm.stride() or Bm.stride(-1) != 1 or (dual and not (_aligned(Bm) and _aligned(Cm))):
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    dt = dt.float().contiguous()
    A = (A[None] if A.ndim == 1 else A).to(device=x.device, dtype=torch.float32).contiguous()
    E = A.shape[0]
    if A.shape[1] != H or B % E:
        raise ValueError(f"ssd: A {tuple(A.shape)} does not fit batch {B}, heads {H}")
    build.require_cuda(dt, "ssd dt", (torch.float32,))
    if initial_state is not None:
        initial_state = initial_state.to(torch.float32).contiguous()
        build.require_cuda(initial_state, "ssd initial_state", (torch.float32,))
        if initial_state.shape != (B, H, N, P):
            raise ValueError(f"ssd: initial_state {tuple(initial_state.shape)} != {(B, H, N, P)}")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    hT = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    lib = build.library("mamba2_ssd")
    rc = lib.mamba2_ssd_fwd(
        build.ptr(x), build.ptr(dt), build.ptr(A), build.ptr(Bm), build.ptr(Cm),
        ctypes.c_void_p(None if initial_state is None else initial_state.data_ptr()),
        build.ptr(y), build.ptr(hT),
        *(ctypes.c_int(n) for n in (B, S, H, P, G, N, B // E)),
        *(ctypes.c_long(n) for n in (*x.stride()[:3], *Bm.stride()[:3])),
        ctypes.c_int(int(dual)), build.stream_ptr(x),
    )
    build.check(lib, rc, "mamba2_ssd_fwd")
    _LAUNCHES.add(1)
    return y, hT


def dual_flops(B, S, H, N, P, L=64):
    """Operations of the chunked dual form the bf16 kernel runs, for chunks
    of L steps at this run's length: per chunk of m steps and head the
    causal C·Bᵀ and M·x (m(m+1)/2 · (N + P) multiply-adds), C·h and the state
    update (2·m·N·P)."""
    full, m = divmod(S, L)
    macs = full * (L * (L + 1) // 2 * (N + P) + 2 * L * N * P) + m * (m + 1) // 2 * (N + P) + 2 * m * N * P
    return 2 * B * H * macs


def cost(x, dt, A, Bm, Cm, *, initial_state=None) -> dict:
    """A call's work: x, dt, A, B, C (and the initial state) read once in
    their own dtypes, y and the final f32 state written once; the dual form
    on the TF32 tensor cores in bf16 (``dual_flops``), the per-step
    recurrence's 5 f32 operations a state element and step in f32."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    n_bytes = build.nbytes(x, dt, A, Bm, Cm, initial_state) + build.nbytes(x) + B * H * N * P * 4
    if x.dtype == torch.bfloat16:
        return build.kernel_cost(n_bytes, dual_flops(B, S, H, N, P), "tf32")
    return build.kernel_cost(n_bytes, 5 * B * S * H * N * P, "f32")


class SSDFunction(torch.autograd.Function):
    """(y, hT) of the kernel forward, gradients by recompute of ``ssd_plain``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        return (_ssd_meta if x.device.type == "meta" else _ssd_cuda)(x, dt, A, Bm, Cm, initial_state=initial_state)

    @staticmethod
    def backward(ctx, gy, ghT):
        plain = lambda x, dt, A, Bm, Cm, h0: ssd_plain(x, dt, A, Bm, Cm, initial_state=h0)
        return build.recompute_grads(ctx, plain, ctx.saved_tensors, (gy, ghT))


def _ssd_meta(x, dt, A, Bm, Cm, *, initial_state):
    op_charges.charge_kernel("mamba2_ssd", cost(x, dt, A, Bm, Cm, initial_state=initial_state))
    B, S, H, P = x.shape
    return x.new_empty((B, S, H, P)), x.new_empty((B, H, Bm.shape[-1], P), dtype=torch.float32)


def _ssd_on_meta(x, dt, A, Bm, Cm, initial_state):
    """The meta route: under grad through ``SSDFunction``, so that its
    backward (the plain version's recompute) is counted too."""
    if build.needs_grad(x, dt, A, Bm, Cm, initial_state):
        return SSDFunction.apply(x, dt, A, Bm, Cm, initial_state)
    return _ssd_meta(x, dt, A, Bm, Cm, initial_state=initial_state)


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    initial_state: Optional[torch.Tensor] = None,
    return_final_state: bool = False,
):
    """y (B, S, H, P) in x's dtype, and with ``return_final_state`` the
    final (B, H, N, P) f32 state."""
    if x.device.type == "cpu":
        y, hT = ssd_plain(x, dt, A, Bm, Cm, initial_state=initial_state)
    elif x.device.type == "meta":
        y, hT = op_charges.meta_call(_ssd_on_meta, x, dt, A, Bm, Cm, initial_state)
    elif build.needs_grad(x, dt, A, Bm, Cm, initial_state):
        y, hT = SSDFunction.apply(x, dt, A, Bm, Cm, initial_state)
    else:
        y, hT = _ssd_cuda(x, dt, A, Bm, Cm, initial_state=initial_state)
    return (y, hT) if return_final_state else y


def ssd_step(x, dt, A, Bm, Cm, state):
    """Single decode step, plain on every device: x (B, H, P), dt (B, H),
    Bm/Cm (B, G, N), state (B, H, N, P) -> (y (B, H, P), new state)."""
    return ssd_step_ref(x, dt, A, Bm, Cm, state)

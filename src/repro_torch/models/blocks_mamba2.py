"""Mamba2 block (Zamba2's SSM backbone), full-sequence and decode paths
(port of ``repro.models.blocks_mamba2``).

in_proj -> [z | x | B | C | dt]; causal depthwise conv over [x|B|C];
y = SSD(x·dt, A·dt, B, C) + D·x;  out = out_proj(RMSNorm(y · silu(z))).

The member axis E is explicit: activations are (E, B, S, D), every
parameter leaf has a leading E axis, and E folds into the batch around the
SSD kernel (with the per-member decay ``A`` as (E, nh)).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models.layers import _per_member
from repro_torch.models.params import Initializer


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    nh = cfg.ssm_nheads
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = d_in + 2 * G * N
    proj_dim = 2 * d_in + 2 * G * N + nh
    return d_in, nh, G, N, conv_dim, proj_dim


def init_mamba2_block(ini: Initializer, cfg: ModelConfig):
    d_in, nh, G, N, conv_dim, proj_dim = _dims(cfg)
    f32 = torch.float32
    return {
        "in_proj": ini.normal((cfg.d_model, proj_dim)),
        "conv_w": ini.normal((cfg.ssm_conv, conv_dim), std=0.5),
        "conv_b": ini.zeros((conv_dim,)),
        "A_log": ini.const(torch.log(torch.linspace(1.0, 16.0, nh)), dtype=f32),
        "D": ini.ones((nh,), dtype=f32),
        "dt_bias": ini.const(torch.full((nh,), math.log(math.expm1(1e-2))), dtype=f32),
        "norm": ini.ones((d_in,), dtype=f32),
        "out_proj": ini.normal((d_in, cfg.d_model)),
    }


def _split_proj(proj, cfg: ModelConfig):
    d_in, nh, G, N, _, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * G * N, nh], dim=-1)  # z, xBC, dt


def _gated_out(p, y, z, cfg: ModelConfig):
    """y, z (E, ..., d_in) -> (E, ..., D)."""
    g = y * F.silu(z)
    gf = g.float()
    var = gf.square().mean(-1, keepdim=True)
    g = (gf * torch.rsqrt(var + cfg.norm_eps) * _per_member(p["norm"], gf)).to(y.dtype)
    E, D = g.shape[0], g.shape[-1]
    out = torch.bmm(g.reshape(E, -1, D), p["out_proj"])
    return out.reshape(*g.shape[:-1], out.shape[-1])


def _in_proj(p, x):
    E, D = x.shape[0], x.shape[-1]
    out = torch.bmm(x.reshape(E, -1, D), p["in_proj"])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def mamba2_fwd(p, x, cfg: ModelConfig, *, initial=None):
    """Full-sequence forward.  x (E, B, S, D); ``initial`` None (a sequence
    start) or dict(conv (E, B, K-1, conv_dim), ssm (E, B, nh, N, P) f32).
    Returns (out (E, B, S, D), state of the same form)."""
    E, B, S, _ = x.shape
    d_in, nh, G, N, conv_dim, _ = _dims(cfg)
    K, P = cfg.ssm_conv, cfg.ssm_head_dim

    z, xBC, dt = _split_proj(_in_proj(p, x), cfg)
    # causal depthwise conv over the sequence
    prev = (
        torch.zeros((E, B, K - 1, conv_dim), dtype=xBC.dtype, device=x.device)
        if initial is None else initial["conv"].to(xBC.dtype)
    )
    padded = torch.cat([prev, xBC], 2)
    conv = 0
    for i in range(K):
        conv = conv + padded[:, :, i:i + S].float() * p["conv_w"][:, i][:, None, None].float()
    xBC = F.silu(conv.to(xBC.dtype) + _per_member(p["conv_b"], xBC))
    # the last K-1 rows of [prev | chunk], which also holds for chunks
    # shorter than K-1
    conv_state = padded[:, :, S:] if K > 1 else prev

    xs, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(E * B, S, nh, P)
    Bm = Bm.reshape(E * B, S, G, N)
    Cm = Cm.reshape(E * B, S, G, N)
    dt = F.softplus(dt.float() + _per_member(p["dt_bias"], dt)).reshape(E * B, S, nh)
    A = -torch.exp(p["A_log"])  # (E, nh)

    ssm0 = None if initial is None else initial["ssm"].reshape(E * B, nh, N, P)
    y, ssm_state = ssd_ops.ssd(xs, dt, A, Bm, Cm, initial_state=ssm0, return_final_state=True)
    y = y + xs * p["D"].repeat_interleave(B, 0)[:, None, :, None]
    y = y.reshape(E, B, S, d_in).to(x.dtype)
    out = _gated_out(p, y, z, cfg)
    return out, {"conv": conv_state, "ssm": ssm_state.reshape(E, B, nh, N, P)}


def init_mamba2_state(cfg: ModelConfig, E: int, batch: int, dtype, device):
    d_in, nh, G, N, conv_dim, _ = _dims(cfg)
    return {
        "conv": torch.zeros((E, batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((E, batch, nh, N, cfg.ssm_head_dim), dtype=torch.float32, device=device),
    }


def mamba2_step(p, x, cfg: ModelConfig, state):
    """Single-token decode.  x (E, B, 1, D) -> (out (E, B, 1, D), new
    state)."""
    E, B = x.shape[:2]
    d_in, nh, G, N, conv_dim, _ = _dims(cfg)
    P = cfg.ssm_head_dim

    z, xBC, dt = _split_proj(_in_proj(p, x[:, :, 0]), cfg)  # (E, B, ...)
    window = torch.cat([state["conv"].to(xBC.dtype), xBC[:, :, None]], 2)  # (E, B, K, conv_dim)
    conv = torch.einsum("ebkc,ekc->ebc", window.float(), p["conv_w"].float()).to(xBC.dtype)
    xBC = F.silu(conv + _per_member(p["conv_b"], conv))
    new_conv = window[:, :, 1:]

    xs, Bm, Cm = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(E * B, nh, P)
    dt = F.softplus(dt.float() + _per_member(p["dt_bias"], dt)).reshape(E * B, nh)
    A = -torch.exp(p["A_log"])
    y, ssm = ssd_ops.ssd_step(
        xs, dt, A, Bm.reshape(E * B, G, N), Cm.reshape(E * B, G, N), state["ssm"].reshape(E * B, nh, N, P)
    )
    y = y + xs * p["D"].repeat_interleave(B, 0)[:, :, None]
    out = _gated_out(p, y.reshape(E, B, d_in).to(x.dtype), z, cfg)
    return out[:, :, None], {"conv": new_conv, "ssm": ssm.reshape(E, B, nh, N, P)}

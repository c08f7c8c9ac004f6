"""RWKV6 (Finch) block: data-dependent-decay time mix + channel mix (port
of ``repro.models.blocks_rwkv6``).

Token-shift ddlerp with a shared low-rank adapter for the five mix
coefficients (r, k, v, w, g), a LoRA'd data-dependent per-channel decay,
the WKV recurrence (``kernels/rwkv6_wkv``), per-head GroupNorm and the
squared-ReLU channel mix.  The member axis E is explicit: activations are
(E, B, S, D), every parameter leaf has a leading E axis, weight products
are E-batched einsums, and E folds into the batch around the WKV kernel
(with the per-member bonus ``u`` as (E, H, D)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.layers import _per_member
from repro_torch.models.params import Initializer

_MIX = 5  # r, k, v, w, g


def init_rwkv6_block(ini: Initializer, cfg: ModelConfig):
    D, R, hd = cfg.d_model, cfg.rwkv_lora_rank, cfg.ssm_head_dim
    H = D // hd
    f32 = torch.float32
    return {
        "ln1": {"scale": ini.ones((D,), ("norm",), dtype=f32), "bias": ini.zeros((D,), ("norm",), dtype=f32)},
        "ln2": {"scale": ini.ones((D,), ("norm",), dtype=f32), "bias": ini.zeros((D,), ("norm",), dtype=f32)},
        "tm": {
            "mu_base": ini.zeros((D,), ("embed",)),
            "mu": ini.normal((_MIX, D), (None, "embed"), std=0.2),
            "lora_w1": ini.normal((D, _MIX * R), ("embed", "rwkv_lora")),
            "lora_w2": ini.normal((_MIX, R, D), (None, "rwkv_lora", "embed"), std=0.01),
            "wr": ini.normal((D, D), ("embed", "mlp")),
            "wk": ini.normal((D, D), ("embed", "mlp")),
            "wv": ini.normal((D, D), ("embed", "mlp")),
            "wg": ini.normal((D, D), ("embed", "mlp")),
            "wo": ini.normal((D, D), ("mlp", "embed")),
            "decay_base": ini.const(torch.full((D,), -6.0), ("embed",), dtype=f32),
            "decay_w1": ini.normal((D, R), ("embed", "rwkv_lora")),
            "decay_w2": ini.normal((R, D), ("rwkv_lora", "embed"), std=0.01),
            "u": ini.normal((H, hd), ("ssm_heads", "head_dim"), std=0.5),
            "gn_scale": ini.ones((D,), ("norm",), dtype=f32),
            "gn_bias": ini.zeros((D,), ("norm",), dtype=f32),
        },
        "cm": {
            "mu_k": ini.normal((D,), ("embed",), std=0.2),
            "mu_r": ini.normal((D,), ("embed",), std=0.2),
            "wk": ini.normal((D, cfg.d_ff), ("embed", "mlp")),
            "wv": ini.normal((cfg.d_ff, D), ("mlp", "embed")),
            "wr": ini.normal((D, D), ("embed", "mlp")),
        },
    }


def _mm(x, w):
    """(E, B, S, K) @ (E, K, M) -> (E, B, S, M), one product per member."""
    return torch.einsum("ebsk,ekm->ebsm", x, w)


def _ln(p, x, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps) * _per_member(p["scale"], xf) + _per_member(p["bias"], xf)
    return y.to(x.dtype)


def _group_norm(tm, y, H, hd, eps):
    """Per-head LayerNorm (RWKV's GroupNorm with groups=H); y (E, B, S, D)."""
    yf = y.float().reshape(*y.shape[:-1], H, hd)
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yf = ((yf - mean) * torch.rsqrt(var + eps)).reshape(y.shape)
    return (yf * _per_member(tm["gn_scale"], yf) + _per_member(tm["gn_bias"], yf)).to(y.dtype)


def _shift_delta(x, prev_x):
    """x (E, B, S, D) shifted one step right, with ``prev_x`` (E, B, D)
    (zeros at a sequence start) in front, minus x."""
    if prev_x is None:
        prev_x = torch.zeros_like(x[:, :, 0])
    return torch.cat([prev_x[:, :, None].to(x.dtype), x[:, :, :-1]], 2) - x


def _ddlerp(tm, x, delta):
    """Data-dependent lerp for the five mix channels: (E, B, S, 5, D)."""
    base = x + delta * _per_member(tm["mu_base"], x)
    lora = torch.tanh(_mm(base, tm["lora_w1"]))  # (E, B, S, 5R)
    lora = lora.reshape(*lora.shape[:3], _MIX, -1)
    adj = torch.einsum("ebsmr,emrd->ebsmd", lora, tm["lora_w2"])
    mix = tm["mu"][:, None, None] + adj
    return x[:, :, :, None] + delta[:, :, :, None] * mix


def time_mix(tm, x, cfg: ModelConfig, *, prev_x=None, wkv_state=None):
    """x (E, B, S, D); prev_x (E, B, D) the carried shift token; wkv_state
    (E, B, H, hd, hd) f32.  Returns (out, (last x (E, B, D), final WKV
    state))."""
    E, B, S, D = x.shape
    hd = cfg.ssm_head_dim
    H = D // hd
    delta = _shift_delta(x, prev_x)
    mixed = _ddlerp(tm, x, delta)
    xr, xk, xv, xw, xg = (mixed[:, :, :, i] for i in range(_MIX))
    fold = lambda t: t.reshape(E * B, S, H, hd)
    r, k, v = fold(_mm(xr, tm["wr"])), fold(_mm(xk, tm["wk"])), fold(_mm(xv, tm["wv"]))
    g = F.silu(_mm(xg, tm["wg"]))
    logw = -torch.exp(
        _per_member(tm["decay_base"], xw)
        + _mm(torch.tanh(_mm(xw.float(), tm["decay_w1"].float())), tm["decay_w2"].float())
    )  # (E, B, S, D) <= 0
    s0 = None if wkv_state is None else wkv_state.reshape(E * B, H, hd, hd)
    y, sT = wkv_ops.wkv6(r, k, v, fold(logw), tm["u"], initial_state=s0, return_final_state=True)
    y = _group_norm(tm, y.reshape(E, B, S, D), H, hd, cfg.norm_eps)
    out = _mm(y * g, tm["wo"])
    return out, (x[:, :, -1], sT.reshape(E, B, H, hd, hd))


def channel_mix(cm, x, *, prev_x=None):
    """Returns (out, last x (E, B, D))."""
    delta = _shift_delta(x, prev_x)
    xk = x + delta * _per_member(cm["mu_k"], x)
    xr = x + delta * _per_member(cm["mu_r"], x)
    k = torch.square(F.relu(_mm(xk, cm["wk"])))
    return torch.sigmoid(_mm(xr, cm["wr"])) * _mm(k, cm["wv"]), x[:, :, -1]


def rwkv6_layer_fwd(p, x, cfg: ModelConfig, *, state=None):
    """x (E, B, S, D); state dict(tm_x, cm_x (E, B, D), wkv (E, B, H, hd,
    hd)) or None (a sequence start).  Returns (x, new state)."""
    st = state or {}
    h, (tm_x, wkv) = time_mix(
        p["tm"], _ln(p["ln1"], x, cfg.norm_eps), cfg,
        prev_x=st.get("tm_x"), wkv_state=st.get("wkv"),
    )
    x = x + h
    h, cm_x = channel_mix(p["cm"], _ln(p["ln2"], x, cfg.norm_eps), prev_x=st.get("cm_x"))
    return x + h, {"tm_x": tm_x, "cm_x": cm_x, "wkv": wkv}


def init_rwkv6_state(cfg: ModelConfig, E: int, batch: int, dtype, device):
    D, hd = cfg.d_model, cfg.ssm_head_dim
    return {
        "tm_x": torch.zeros((E, batch, D), dtype=dtype, device=device),
        "cm_x": torch.zeros((E, batch, D), dtype=dtype, device=device),
        "wkv": torch.zeros((E, batch, D // hd, hd, hd), dtype=torch.float32, device=device),
    }


def rwkv6_step(p, x, cfg: ModelConfig, state):
    """Single-token decode via the length-1 sequence path (the WKV kernel at
    S = 1, as on the TPU).  x (E, B, 1, D)."""
    return rwkv6_layer_fwd(p, x, cfg, state=state)

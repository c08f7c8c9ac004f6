"""Carry the JAX package's weights into the port, leaf for leaf.

``params_from_numpy`` takes an unboxed values tree whose leaves are numpy
arrays (float32, or ``ml_dtypes`` bfloat16 as ``np.asarray`` returns them
from a bf16 JAX array) and returns the same nested dicts of torch tensors.
The stacked-layer axis and the leading ensemble axis pass through
unchanged.  bfloat16 leaves go through float32, which every bf16 value
survives exactly, so the port computes on the very weights the reference
holds.  Converting JAX arrays to numpy is the caller's job: this module
never imports JAX.

``params_to_numpy`` is the inverse: a tree of tensors (on any device) as
numpy leaves, bfloat16 carried exactly through float32 into ``ml_dtypes``
bfloat16 arrays (the dtype JAX takes and ``params_from_numpy`` reads).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import interleaved_moe


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    if a.dtype not in (np.float32, np.int32):
        raise TypeError(f"unsupported weight dtype {a.dtype}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _layer_rows(cfg: ModelConfig, path) -> int:
    """Rows of the stacked layer axis of a ``layers`` leaf: ``n_layers``,
    or for llama4's interleave n_groups * (moe_every - 1) under
    ``layers/dense`` and n_groups under ``layers/moe``."""
    if interleaved_moe(cfg):
        n_groups = cfg.n_layers // cfg.moe_every
        return n_groups * (cfg.moe_every - 1) if path[1] == "dense" else n_groups
    return cfg.n_layers


def params_from_numpy(tree, cfg: ModelConfig, device=None):
    """Nested dict of numpy leaves -> nested dict of torch tensors on
    ``device``.  ``tree['layers']`` leaves must carry the stacked layer
    axis first, or second behind an ensemble axis, with ``cfg.n_layers``
    rows (or llama4's interleaved stack sizes, ``_layer_rows``); the
    hybrid's ``shared_attn`` block and the ``frontend`` projection have no
    layer axis and pass through as they are (behind the ensemble axis
    where there is one)."""
    device = resolve_device(device)
    anchor = tree["embed"] if "embed" in tree else tree["frontend"]["proj"]  # the encoder has no embed
    lead = np.ndim(anchor) - 2  # 1 when the tree is a stacked ensemble

    def conv(t, path):
        if isinstance(t, dict):
            return {k: conv(v, path + (k,)) for k, v in t.items()}
        if path[0] == "layers" and np.shape(t)[lead] != _layer_rows(cfg, path):
            raise ValueError(
                f"{'/'.join(path)}: layer axis {np.shape(t)[lead]} != "
                f"{_layer_rows(cfg, path)} (n_layers {cfg.n_layers})"
            )
        return _leaf(t, device)

    return conv(tree, ())


def params_to_numpy(tree):
    """Nested dict (or list) of tensors -> the same nesting of numpy arrays
    on the host.  Every bf16 value survives: bf16 -> f32 is exact."""
    import ml_dtypes

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy().astype(ml_dtypes.bfloat16)
        return t.numpy().copy()

    return conv(tree)


def cache_from_numpy(cache, device=None, *, members: bool = True):
    """Carry a JAX cache tree — a KV pool, a dense slot cache or a
    recurrent state tree — into the port's layout.

    ``cache`` is a dict of numpy leaves, or of lists of them (the hybrid's
    per-invocation ``attn_k``/``attn_v``).  With ``members`` the leaves are
    member-stacked as the JAX ``TierBackend`` holds them: stacked leaves
    (E, L, ...) come out layer-major, (L, E, ...) — (L, E, P, KVH,
    page_size, hd) for a pool, (L, E, n_slots, nh, N, P) for an SSM state —
    so one layer's slab of every member is contiguous for the kernels; the
    per-invocation leaves (E, n_slots, KVH, S, hd) are already the port's
    layout.  Without, single-model leaves (L, ...) pass through.  The page
    table needs no conversion: the port's API takes the same (n_slots,
    n_pg) int32 numpy array and moves it to the device once per step."""
    device = resolve_device(device)
    out = {}
    for k, a in cache.items():
        if isinstance(a, (list, tuple)):
            out[k] = [_leaf(x, device) for x in a]
            continue
        t = _leaf(a, device)
        out[k] = t.transpose(0, 1).contiguous() if members else t
    return out


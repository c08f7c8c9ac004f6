"""Checkpoints in the JAX package's file format (port of
``repro.checkpoint.io``).

One ``ckpt_{step:08d}.npz`` per step with '/'-joined tree paths as keys
(dict keys, list indices), bfloat16 leaves stored as their ``uint16`` bit
pattern, and a JSON sidecar ``ckpt_{step:08d}.npz.json`` recording the step
and every leaf's dtype.  The port's parameter tree has the JAX tree's
nesting, so a checkpoint written by either package restores in the other.
Leaves are pulled to the host as whole arrays.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """[(path, leaf)] in the tree's key order (a dict's insertion order, as
    the port builds the JAX package's trees)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _to_numpy(t):
    """(array, dtype name): bf16 as its uint16 bits."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(t)
    return a, str(a.dtype)


def save_checkpoint(directory: str, step: int, tree) -> str:
    os.makedirs(directory, exist_ok=True)
    arrays, meta = {}, {}
    for path, leaf in _flatten(tree):
        key = "/".join(path)
        arrays[key], meta[key] = _to_numpy(leaf)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    np.savez(path, **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"step": step, "dtypes": meta}, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory) if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _from_numpy(a: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def restore_checkpoint(directory: str, template, step: Optional[int] = None):
    """Restore into the structure of ``template`` (values replaced; each
    leaf lands on its template leaf's device, in the stored dtype)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with open(path + ".json") as f:
        meta = json.load(f)["dtypes"]
    data = np.load(path)

    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + (str(i),)) for i, v in enumerate(t))
        key = "/".join(prefix)
        return _from_numpy(data[key], meta[key], t)

    return build(template, ())

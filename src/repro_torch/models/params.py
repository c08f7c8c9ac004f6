"""Seeded parameter initialisation with the JAX package's shapes and stds.

``Initializer.normal`` draws N(0, std) with std = 1/sqrt(fan_in), fan_in
the second-to-last axis of the per-layer shape (the last for a vector) —
the rule of ``repro.models.params.Initializer`` — straight into a tensor of
the target dtype on the target device, from an explicit
``torch.Generator``.  ``lead`` axes (a stacked layer axis, an ensemble
axis) are prepended to every leaf and do not enter fan_in.  The numbers
differ from JAX's PRNG; parity tests carry JAX's weights over with
``repro_torch.bridge`` instead.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class Initializer:
    """Draws each leaf; ``axes`` (the leaf's logical axes, as the JAX
    package's ``Box`` carries them) is what ``AxesInitializer`` records."""

    def __init__(self, generator: torch.Generator, dtype, device, lead: Tuple[int, ...] = ()):
        self.generator = generator
        self.dtype = dtype if isinstance(dtype, torch.dtype) else torch_dtype(dtype)
        self.device = torch.device(device)
        self.lead = tuple(lead)

    def stacked(self, n: int) -> "Initializer":
        """The same stream with one more leading (layer) axis of size n."""
        return Initializer(self.generator, self.dtype, self.device, self.lead + (n,))

    def normal(self, shape, axes, *, std: Optional[float] = None, dtype=None) -> torch.Tensor:
        if std is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = 1.0 / math.sqrt(fan_in)
        t = torch.empty(self.lead + tuple(shape), dtype=dtype or self.dtype, device=self.device)
        if t.is_meta:  # shapes only: nothing to draw
            return t
        return t.normal_(0.0, std, generator=self.generator)

    def zeros(self, shape, axes, dtype=None) -> torch.Tensor:
        return torch.zeros(self.lead + tuple(shape), dtype=dtype or self.dtype, device=self.device)

    def ones(self, shape, axes, dtype=None) -> torch.Tensor:
        return torch.ones(self.lead + tuple(shape), dtype=dtype or self.dtype, device=self.device)

    def const(self, value, axes, dtype=None) -> torch.Tensor:
        """A fixed per-layer value, repeated over the lead axes."""
        v = torch.as_tensor(value, dtype=dtype or self.dtype, device=self.device)
        return v.expand(self.lead + tuple(v.shape)).clone()


class AxesInitializer:
    """The init functions' tree with each leaf's logical axes in place of a
    tensor: ``lead_axes`` first (``'layers'`` for each stacked axis), then
    the leaf's own.  Nothing is drawn."""

    def __init__(self, lead_axes: Tuple[Optional[str], ...] = ()):
        self.lead_axes = tuple(lead_axes)

    def stacked(self, n: int) -> "AxesInitializer":
        return AxesInitializer(self.lead_axes + ("layers",))

    def normal(self, shape, axes, **_):
        return self.lead_axes + tuple(axes)

    zeros = ones = const = normal


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in its key order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves):
    """A nested dict shaped like ``template`` holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return next(it)

    return build(template)


def param_count(tree) -> int:
    n = 0

    def add(t):
        nonlocal n
        n += t.numel()

    tree_map(add, tree)
    return n

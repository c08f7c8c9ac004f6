"""train_step: loss -> grads -> AdamW (port of ``repro.train.step``).

The step is eager PyTorch: the forward builds the autograd graph (the
attention layers through the flash kernel's log-sum-exp forward, the
scans through their kernels under autograd wrappers, on the card), one
``torch.autograd.grad`` takes every parameter's gradient, and AdamW
updates the state's tensors in place.  Capturing the step as a CUDA graph
is later work.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import OptimConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: dict
    step: torch.Tensor  # () int32 on the parameters' device


def init_train_state(params, ocfg: OptimConfig) -> TrainState:
    opt = adamw_init(params, ocfg)
    return TrainState(params=params, opt=opt, step=torch.zeros((), dtype=torch.int32, device=opt["count"].device))


def make_train_step(
    cfg: ModelConfig,
    ocfg: OptimConfig,
    *,
    total_steps: int = 10_000,
    warmup_steps: int = 100,
    window_override: Optional[int] = None,
):
    """``train_step(state, batch) -> (state, metrics)``: metrics ``loss``,
    ``ce``, ``z_loss``, ``acc``, ``aux``, ``grad_norm``, ``lr`` and
    ``step``, all device tensors (nothing is read back to the host).  The
    returned state holds the input state's tensors, updated in place, so
    the moments are never held twice; ``step`` is a new tensor."""

    def train_step(state: TrainState, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        with torch.enable_grad():
            loss, metrics = api.loss_fn(tree_unflatten(state.params, leaves), batch, cfg, window_override=window_override)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach (none in the model trees) gets a zero gradient
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        lr_scale = cosine_schedule(state.step, total_steps, warmup_steps)
        params, opt, om = adamw_update(tree_unflatten(state.params, grads), state.opt, state.params, ocfg,
                                       lr_scale=lr_scale)
        metrics = dict(metrics, loss=loss.detach(), **om, step=state.step)
        return TrainState(params, opt, state.step + 1), {k: v.detach() for k, v in metrics.items()}

    return train_step

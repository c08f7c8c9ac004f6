#!/usr/bin/env python3
"""Time the full-width training step on one GPU with AdamW and the gradient
norm taking a large leaf in slices of ``GROUP_ELEMENTS`` (the port's code)
against taking it whole, alternating in one process, so that both meet the
same card, host and process state.

    python3 chip_adamw_compare.py [--rounds 3] [--steps 3] [--seed N]
                                  [--out results.json]

qwen2.5-3b at published width (36 layers, d 2048, remat, f32 moments),
bf16 weights from ``--seed``, 4 x 1024 tokens of ``sequence_task`` a step.
Each round runs ``make_train_step`` ``--steps`` times with each variant
(order whole, sliced, sliced, whole), the first step of a turn a warm-up,
and reads the step's wall and peak device memory; then one AdamW update
alone on the next batch's gradient, timed with CUDA events.  "Whole" is
the same code with ``optim.adamw._pieces`` returning one piece a leaf: a
leaf above ``GROUP_ELEMENTS`` goes alone, as the update did before it was
sliced.  Prints the card's name and power limit and one JSON object of
medians; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_adamw_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, batches, sequence_task, to_device
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.optim import OptimConfig
    from repro_torch.optim import adamw as A
    from repro_torch.train import init_train_state, make_train_step

    build.build_all()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sliced = A._pieces
    variants = {"whole": lambda leaves, limit: [(i, 0, t.numel()) for i, t in enumerate(leaves)], "sliced": sliced}
    cfg = get_config("qwen2.5-3b")
    ocfg = OptimConfig(lr=3e-4)
    state = init_train_state(api.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev), ocfg)
    n = args.rounds * 4 * (args.steps + 1)
    it = batches(TokenDataset(sequence_task(4 * n, 1024, vocab=512, seed=args.seed)), 4, seed=args.seed)
    out = {k: {"step_s": [], "peak_gib": [], "update_ms": []} for k in variants}
    for name in ["whole", "sliced", "sliced", "whole"] * args.rounds:
        A._pieces = variants[name]
        step = make_train_step(cfg, ocfg, total_steps=n, warmup_steps=1)
        for i in range(args.steps):
            b = to_device(next(it), dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, _ = step(state, b)
            torch.cuda.synchronize()
            if i:
                out[name]["step_s"].append(time.perf_counter() - t0)
                out[name]["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
        with torch.enable_grad():
            loss, _ = api.loss_fn(tree_unflatten(state.params, leaves), to_device(next(it), dev), cfg)
            grads = tree_unflatten(state.params, list(torch.autograd.grad(loss, leaves)))
        del loss, leaves
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        A.adamw_update(grads, state.opt, state.params, ocfg)
        e1.record()
        torch.cuda.synchronize()
        out[name]["update_ms"].append(e0.elapsed_time(e1))
        del grads
    A._pieces = sliced
    summary = {k: {"median_step_s": float(np.median(v["step_s"])), "median_update_ms": float(np.median(v["update_ms"])),
                   "peak_gib": max(v["peak_gib"])} for k, v in out.items()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, runs=out, summary=summary), indent=1))
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

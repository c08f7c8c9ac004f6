"""Quickstart (port of examples/quickstart.py): build a 2-tier ABC cascade
from the arch registry (reduced configs), calibrate the agreement threshold
on ~100 samples, and serve a batch.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import calibration, deferral
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec
from repro_torch.device import resolve_device
from repro_torch.serve import CascadeServer, CascadeTier


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. two tiers from the assigned-architecture registry -------------
    small_cfg = get_config("qwen2.5-3b").reduced()
    big_cfg = get_config("internlm2-1.8b").reduced()
    small = ens.init_ensemble(small_cfg, 3, torch.Generator(device=device).manual_seed(0), device)
    big = ens.init_ensemble(big_cfg, 1, torch.Generator(device=device).manual_seed(1), device)

    # --- 2. calibrate the tier-1 agreement threshold (paper App. B) --------
    rng = np.random.default_rng(0)
    vocab = min(small_cfg.vocab_size, big_cfg.vocab_size)
    cal_toks = rng.integers(0, vocab, (100, 32)).astype(np.int32)
    cal_y = rng.integers(0, vocab, 100)  # untrained demo: labels are arbitrary
    with torch.no_grad():
        logits = ens.ensemble_last_logits(small, {"tokens": cal_toks}, small_cfg)
    out = deferral.vote_rule(logits, theta=0.0)
    theta, info = calibration.estimate_threshold(
        out.score.float().cpu().numpy(), out.pred.cpu().numpy() == cal_y, epsilon=0.05
    )
    print(f"calibrated theta={theta:.3f} selection_rate={info['selection_rate']:.2f}")

    # --- 3. serve a batch through the cascade ------------------------------
    server = CascadeServer([
        CascadeTier(small_cfg, small, TierSpec("small", "vote", theta, k=3, cost=1.0), device=device),
        CascadeTier(big_cfg, big, TierSpec("big", "confidence", -1.0, k=1, cost=25.0), device=device),
    ], device=device)
    toks = rng.integers(0, vocab, (32, 32)).astype(np.int32)
    with torch.no_grad():
        res = server.classify(toks)
    print(f"tier fractions: {np.round(server.tier_fractions(res), 2).tolist()}")
    print(f"cost: {res.cost:.1f} vs all-big {25.0 * len(toks):.1f}")
    print("(untrained members rarely agree -> most requests defer; see "
          "repro_torch.examples.train_then_cascade for the trained behaviour)")
    return dict(theta=theta, info=info, server=server, tokens=toks, result=res)


if __name__ == "__main__":
    main()

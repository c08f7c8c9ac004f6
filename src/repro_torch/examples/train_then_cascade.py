"""End-to-end driver (port of examples/train_then_cascade.py, the
paper-shaped workflow): TRAIN tier models on a mixture-difficulty task for
a few hundred steps, CALIBRATE the agreement threshold on ~100 held-out
samples (App. B), then SERVE a drop-in cascade and report the paper's
headline quantities: accuracy against the large model (Prop 4.1.1) and
cost against always-large (Prop 4.1.2).  The members are the reference's
widths: head size 24 (d 48, 2 heads) and 40 (d 160, 4 heads).

    PYTHONPATH=src python -m repro_torch.examples.train_then_cascade [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import calibration, deferral
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec
from repro_torch.data import MixtureTask
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.params import tree_map
from repro_torch.optim import OptimConfig
from repro_torch.serve import CascadeServer, CascadeTier
from repro_torch.train import init_train_state, make_train_step

SMALL = ModelConfig(name="ex-small", family="dense", n_layers=1, d_model=48,
                    d_ff=96, vocab_size=256, n_heads=2, n_kv_heads=2, remat=False)
BIG = ModelConfig(name="ex-big", family="dense", n_layers=3, d_model=160,
                  d_ff=320, vocab_size=256, n_heads=4, n_kv_heads=4, remat=False)
TASK = MixtureTask(vocab=256, n_classes=16, seq_len=32, easy_frac=0.6, seed=0)


def train_classifier(cfg, task, steps, seed, device, ocfg, *, batch=64, log_every=100):
    """``cfg`` trained ``steps`` steps on ``task``'s labels at the last
    position (the other positions masked out), weights and batches from
    ``seed``.  Returns (params, the loss of every step as numpy)."""
    toks, labels, _ = task.sample(4096, seed=seed + 100)
    state = init_train_state(api.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device), ocfg)
    step = make_train_step(cfg, ocfg, total_steps=steps, warmup_steps=20)
    rng = np.random.default_rng(seed)
    mask = np.zeros((batch, task.seq_len), np.float32)
    mask[:, -1] = 1.0
    losses = []
    for i in range(steps):
        idx = rng.integers(0, len(toks), batch)
        tgt = np.zeros((batch, task.seq_len), np.int32)
        tgt[:, -1] = labels[idx]
        state, m = step(state, {"tokens": toks[idx], "targets": tgt, "mask": mask})
        losses.append(m["loss"])
        if log_every and (i + 1) % log_every == 0:
            print(f"  [{cfg.name} seed {seed}] step {i + 1}: loss {float(m['loss']):.3f}")
    return state.params, torch.stack(losses).float().cpu().numpy()


def stack_members(trees):
    """Single-model trees -> one tree with a leading member axis."""
    if isinstance(trees[0], dict):
        return {k: stack_members([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def calibrate(values, cfg, task, seed, n=100):
    """theta of the vote rule on ``n`` held-out samples at epsilon 0.05
    (App. B): (theta, the estimate's info)."""
    cal_toks, cal_y, _ = task.sample(n, seed=seed)
    with torch.no_grad():
        out = deferral.vote_rule(ens.ensemble_last_logits(values, {"tokens": cal_toks}, cfg), theta=0.0)
    return calibration.estimate_threshold(out.score.float().cpu().numpy(), out.pred.cpu().numpy() == cal_y,
                                          epsilon=0.05)


def train_tiers(args, device):
    """The three small members (seeds 0-2) and the big model (seed 7):
    (stacked small values, big values with a member axis, losses by seed)."""
    ocfg = OptimConfig(lr=2e-3, weight_decay=0.01)
    trained = {s: train_classifier(cfg, TASK, steps, s, device, ocfg)
               for cfg, steps, s in ((SMALL, args.steps, 0), (SMALL, args.steps, 1), (SMALL, args.steps, 2),
                                     (BIG, args.big_steps, 7))}
    stacked = stack_members([trained[s][0] for s in (0, 1, 2)])
    big = tree_map(lambda t: t[None], trained[7][0])
    return stacked, big, {s: v[1] for s, v in trained.items()}


def serve(stacked, big, theta, device):
    """1024 fresh requests through the cascade and through the big model
    alone; prints the report.  Returns its numbers and the result."""
    test_toks, test_y, easy = TASK.sample(1024, seed=1234)
    server = CascadeServer([
        CascadeTier(SMALL, stacked, TierSpec("small-x3", "vote", theta, k=3, cost=1.0), device=device),
        CascadeTier(BIG, big, TierSpec("big", "confidence", -1.0, k=1, cost=25.0), device=device),
    ], device=device)
    with torch.no_grad():
        res = server.classify(test_toks)
        big_pred = ens.ensemble_last_logits(big, {"tokens": test_toks}, BIG)[0].argmax(-1).cpu().numpy()

    acc_c = float((res.pred == test_y).mean())
    acc_b = float((big_pred == test_y).mean())
    fr = server.tier_fractions(res)
    print("\n=== drop-in cascade report ===")
    print(f"accuracy: cascade {acc_c:.3f} vs large-only {acc_b:.3f} "
          f"(Prop 4.1.1: within calibrated eps)")
    print(f"tier fractions: small {fr[0]:.2f} / big {fr[1]:.2f}")
    print(f"cost: {res.cost:.0f} vs always-large {25.0 * len(test_toks):.0f} "
          f"({25.0 * len(test_toks) / res.cost:.2f}x cheaper)")
    sel = res.tier_of == 0
    if sel.any():
        print(f"easy-fraction at tier1 exits {easy[sel].mean():.2f} vs deferred "
              f"{easy[~sel].mean():.2f} (ABC routes by difficulty)")
    return dict(server=server, tokens=test_toks, labels=test_y, easy=easy, result=res, big_pred=big_pred,
                accuracy_cascade=acc_c, accuracy_big_only=acc_b, tier_fractions=fr)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--big-steps", type=int, default=600)
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    print("training 3 small tier members + 1 large model ...")
    stacked, big, losses = train_tiers(args, device)
    print("calibrating theta on 100 held-out samples ...")
    theta, info = calibrate(stacked, SMALL, TASK, seed=999)
    print(f"  theta={theta:.3f}  selection_rate={info['selection_rate']:.2f}  "
          f"failure_rate={info['failure_rate']:.3f}")
    print("serving 1024 fresh requests through the cascade ...")
    return dict(serve(stacked, big, theta, device), small=stacked, big=big, losses=losses, theta=theta,
                calibration=info)


if __name__ == "__main__":
    main()

"""Cascade serving CLI (port of ``repro.launch.serve``): stand up an ABC
cascade from the arch registry and serve a batched synthetic workload,
reporting per-tier routing and cost.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --tiers qwen2.5-3b:2 internlm2-1.8b:1 --reduced --requests 64 [--device cpu]

The reference's flags and printed lines, plus ``--device``: the card by
default, raising without one, as every entry point of the port does.
Weights are drawn from ``--seed`` (one ``torch.Generator`` for all tiers,
in tier order); ``build_tiers`` also takes a values tree per tier, so a
caller can serve weights made elsewhere (the tests pass the JAX package's
``init_ensemble`` weights through ``bridge.params_from_numpy``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec
from repro_torch.device import resolve_device
from repro_torch.serve import CascadeServer, CascadeTier


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--tiers", nargs="+", required=True,
        help="arch:k per tier, cheapest first, e.g. qwen2.5-3b:2 command-r-plus-104b:1",
    )
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--theta", type=float, default=0.67)
    ap.add_argument("--rule", default="vote", choices=["vote", "score"])
    ap.add_argument("--mode", default="classify", choices=["classify", "generate"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    return ap.parse_args(argv)


def tier_configs(args):
    """[(arch, k, ModelConfig)] of ``--tiers``, reduced with ``--reduced``."""
    out = []
    for t in args.tiers:
        arch, k = t.rsplit(":", 1)
        cfg = get_config(arch)
        out.append((arch, int(k), cfg.reduced() if args.reduced else cfg))
    return out


def build_tiers(args, values=None):
    """The cascade's tiers, cheapest first, on ``args.device``: tier i an
    ``int(k)``-member ensemble under ``args.rule`` at ``args.theta``; the
    last tier answers everything (``confidence`` at theta -1 when it has one
    member).  ``values``: one stacked values tree per tier (None: drawn from
    ``args.seed``).  Prints one line a tier, as the reference does."""
    device = resolve_device(args.device)
    g = torch.Generator(device=device).manual_seed(args.seed)
    specs = tier_configs(args)
    tiers = []
    for i, (arch, k, cfg) in enumerate(specs):
        vals = ens.init_ensemble(cfg, k, g, device) if values is None else values[i]
        cost = cfg.active_param_count() * k / 1e6  # MFLOP-ish units
        last = i == len(specs) - 1
        spec = TierSpec(
            name=arch,
            rule="confidence" if (last and k == 1) else args.rule,
            theta=-1.0 if last else args.theta,
            k=k,
            cost=cost,
        )
        tiers.append(CascadeTier(cfg, vals, spec, device=device))
        print(f"tier {i}: {arch} k={k} cost/ex={cost:.1f}")
    return tiers


def serve(args, tiers):
    """One batch of ``args.requests`` random prompts of ``args.seq`` tokens
    (numpy, from ``args.seed``) through the cascade; prints the
    reference's report.  Returns the ``CascadeResult``."""
    server = CascadeServer(tiers, device=tiers[0].device)
    vocab = min(t.cfg.vocab_size for t in tiers)
    toks = np.random.default_rng(args.seed).integers(
        0, vocab, (args.requests, args.seq)
    ).astype(np.int32)
    with torch.no_grad():
        if args.mode == "classify":
            res = server.classify(toks)
        else:
            res = server.generate(toks, max_new_tokens=8)
    fr = server.tier_fractions(res)
    print(f"tier fractions: {np.round(fr, 3).tolist()}")
    print(f"evaluated per tier: {res.evaluated.tolist()}")
    print(f"total cost: {res.cost:.1f}  vs all-top-tier: "
          f"{tiers[-1].spec.cost * args.requests:.1f}")
    return res


def main(argv=None, values=None):
    args = parse_args(argv)
    return serve(args, build_tiers(args, values))


if __name__ == "__main__":
    main()

"""Batched request serving through the queue-driven engine, then the
black-box generation cascade (port of examples/serve_cascade.py; the
§5.2.3 API flavor: agreement = exact-match voting over stable digests of
member generations, no logits needed).

Every tier's members generate together, one batched program per decode
step (stacked weights), and on the card every program is a CUDA graph
captured once: the second batch below replays them with zero new
captures (on the CPU a program counts once, at its first call).

    PYTHONPATH=src python -m repro_torch.examples.serve_cascade [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec
from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServingEngine
from repro_torch.serve.graphs import trace_count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731

    small_cfg = get_config("olmo-1b").reduced()
    big_cfg = get_config("internlm2-1.8b").reduced()
    rng = np.random.default_rng(0)
    vocab = min(small_cfg.vocab_size, big_cfg.vocab_size)

    # --- queue-driven single-model serving ---------------------------------
    member = ens.init_ensemble(small_cfg, 1, gen(0), device)
    engine = ServingEngine(small_cfg, tree_map(lambda t: t[0], member), max_batch=8, device=device)
    for _ in range(12):
        engine.queue.submit(Request(
            tokens=rng.integers(0, vocab, rng.integers(8, 24)).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 6)),
        ))
    with torch.no_grad():
        done = engine.serve_pending()
    print(f"served {len(done)} requests in {engine.stats['batches']} batches; "
          f"stats: {dict(engine.stats)}")
    print(f"  e.g. request {done[0].rid}: generated {done[0].output.tolist()}")

    # --- black-box generation cascade (vote on sampled answers, Eq. 3) -----
    small3 = ens.init_ensemble(small_cfg, 3, gen(1), device)
    big1 = ens.init_ensemble(big_cfg, 1, gen(2), device)
    server = CascadeServer([
        CascadeTier(small_cfg, small3, TierSpec("small-x3", "vote", 0.67, k=3, cost=1.0),
                    temperature=0.7, device=device),
        CascadeTier(big_cfg, big1, TierSpec("big", "confidence", -1.0, k=1, cost=25.0), device=device),
    ], device=device)
    prompts = rng.integers(0, vocab, (16, 16)).astype(np.int32)
    with torch.no_grad():
        res = server.generate(prompts, max_new_tokens=4)
    print(f"\nblack-box cascade: tier counts {res.tier_counts.tolist()}, "
          f"cost {res.cost:.0f} vs all-big {25.0 * len(prompts):.0f}")
    print("(untrained members rarely agree on sampled text -> most defer, "
          "mirroring the paper's safety behaviour)")

    # --- compile-once: serving the same traffic again captures nothing (same
    # prompts + same seed -> identical routing, so every program bucket is
    # already captured)
    before = trace_count()
    with torch.no_grad():
        again = server.generate(prompts, max_new_tokens=4)
    new = trace_count() - before
    print(f"\nsecond batch: {new} new traces "
          f"(all programs replayed what the first batch captured)")
    return dict(engine=engine, done=done, server=server, prompts=prompts, result=res, again=again,
                new_traces=new)


if __name__ == "__main__":
    main()

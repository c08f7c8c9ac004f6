"""Continuous batching demo (port of examples/continuous_batching.py): a
stream of requests with different prompt lengths and generation budgets
flows through a fixed set of decode slots (one ``SlotStream`` state
machine, serve/slot_stream.py); finished slots are refilled mid-stream,
and admission consumes each prompt's prefix in bucketed power-of-two
prefill chunks, so a long prompt costs a handful of chunk calls instead of
one decode step per token.

Then the cascade-aware flavor: every tier runs its own SlotStream, tiers
are stepped round-robin, and a slot freed by tier-1 agreement admits work
while tier 0 is still decoding; requests whose members disagree are
re-queued on the next tier with their prompt intact.

    PYTHONPATH=src python -m repro_torch.examples.continuous_batching [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import TierSpec
from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    cfg = get_config("qwen2.5-3b").reduced()
    stacked = ens.init_ensemble(cfg, 3, torch.Generator(device=device).manual_seed(0), device)
    member = tree_map(lambda t: t[0], stacked)
    rng = np.random.default_rng(0)
    vocab = cfg.vocab_size

    def make_requests(n):
        return [
            Request(
                tokens=rng.integers(0, vocab, rng.integers(4, 20)).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 8)),
            )
            for _ in range(n)
        ]

    requests = make_requests(24)
    # one long prompt to show chunked admission off the decode path
    requests.append(Request(tokens=rng.integers(0, vocab, 100).astype(np.int32), max_new_tokens=4))

    eng = ServingEngine(cfg, member, max_seq=128, device=device)
    with torch.no_grad():
        t0 = time.perf_counter()
        done = eng.serve_continuous(list(requests), ServeConfig(n_slots=8))
        sync()
        dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in done)
    st = eng.last_stream_stats
    print(f"served {len(done)} requests / {total_new} generated tokens in {dt:.1f}s "
          f"with 8 slots ({st['decode_tokens']} slot-steps; "
          f"{st['chunk_tokens']} prompt tokens admitted via {st['chunk_calls']} "
          f"prefill chunks instead of decode steps)")
    print(f"e.g. request {done[0].rid}: prompt[{len(done[0].tokens)}] -> "
          f"{done[0].output.tolist()}")

    # the same workload, one request at a time (no batching)
    eng2 = ServingEngine(cfg, member, device=device)
    with torch.no_grad():
        t0 = time.perf_counter()
        sequential = {r.rid: eng2.generate(r.tokens[None, :], r.max_new_tokens)[0] for r in requests}
        sync()
        dt2 = time.perf_counter() - t0
    print(f"sequential per-request baseline: {dt2:.1f}s "
          f"({dt2 / dt:.1f}x slower than continuous batching)")

    # --- cascade-aware continuous batching ---------------------------------
    big_cfg = get_config("olmo-1b").reduced()
    big1 = ens.init_ensemble(big_cfg, 1, torch.Generator(device=device).manual_seed(1), device)
    server = CascadeServer([
        CascadeTier(cfg, stacked, TierSpec("small-x3", "vote", 0.67, k=3, cost=1.0), device=device),
        CascadeTier(big_cfg, big1, TierSpec("big", "confidence", -1.0, k=1, cost=25.0), device=device),
    ], device=device)
    stream = make_requests(12)
    with torch.no_grad():
        t0 = time.perf_counter()
        cascade_done = server.serve_continuous(stream, ServeConfig(n_slots=4, max_seq=64))
        sync()
        dt = time.perf_counter() - t0
    tiers = np.bincount([r.tier for r in cascade_done], minlength=2)
    print(f"\ncascade continuous: {len(cascade_done)} requests in {dt:.1f}s; "
          f"answered per tier: {tiers.tolist()} "
          f"(disagreements were re-queued onto tier 2 mid-stream)")
    return dict(done=done, sequential=sequential, stream_stats=dict(st), cascade=cascade_done,
                tier_counts=tiers)


if __name__ == "__main__":
    main()

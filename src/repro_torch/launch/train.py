"""Training CLI (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \
      --steps 200 --batch 16 --seq 128 [--device cpu]

Trains on ``sequence_task`` (Markov LM data made from ``--seed``) with
AdamW under a cosine schedule, seeded weights (``api.init_params``), a
checkpoint at half way and at the end with ``--ckpt-dir``.  ``--device``
defaults to the card: with no GPU and no ``--device cpu`` it raises, as
every entry point of the port does.  The encoder trains on one-hot frame
embeddings of the tokens, as in the reference.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenDataset, batches, to_device
from repro_torch.data.synthetic import sequence_task
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim.adamw import OptimConfig
from repro_torch.train import init_train_state, make_train_step, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-examples", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"arch={cfg.name} family={cfg.family} params≈{cfg.param_count():,} device={device}")

    params = api.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    ocfg = OptimConfig(lr=args.lr)
    state = init_train_state(params, ocfg)
    step = make_train_step(cfg, ocfg, total_steps=args.steps, warmup_steps=min(50, args.steps // 10 + 1))

    rows = sequence_task(args.n_examples, args.seq, vocab=min(cfg.vocab_size, 512), seed=args.seed)
    rows = rows % cfg.vocab_size
    it = batches(TokenDataset(rows), args.batch)

    def prepare(b):
        b = to_device(b, device)
        if cfg.is_encoder:
            # encoder: frame embeddings carrying the token identity
            emb = torch.nn.functional.one_hot(b["tokens"] % cfg.frontend_dim, cfg.frontend_dim).float()
            return {"embeds": emb, "targets": b["targets"], "mask": b["mask"]}
        return b

    ckpt_fn = None
    if args.ckpt_dir:
        ckpt_fn = lambda st, i: save_checkpoint(args.ckpt_dir, i, st.params)  # noqa: E731
    state, hist = train_loop(
        step, state, map(prepare, it), steps=args.steps, checkpoint_every=max(1, args.steps // 2),
        checkpoint_fn=ckpt_fn,
    )
    print(f"final loss {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()

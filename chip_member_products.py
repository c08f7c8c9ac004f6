#!/usr/bin/env python3
"""Whether one ensemble member's bf16 product gives the same bits stacked
with two others (one batched einsum over E = 3, as a tier holding all
three members runs it) as alone (E = 1, as a rank holding that member
alone over a mesh placement runs it), at qwen2.5-3b's product shapes and
a serve step's row counts.

    python3 chip_member_products.py [--out results.json]

Prints the card's name and power limit, then one JSON object: for each
(K, N) product and M rows, true where member 0's output is bitwise the
same both ways.  Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys

import torch

SHAPES = ((2048, 2048), (2048, 256), (2048, 11008), (11008, 2048), (2048, 151936))  # (K, N): q/o, k/v, up, down, logits
ROWS = (1, 2, 4, 8, 16, 128)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_member_products: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for K, N in SHAPES:
        for M in ROWS:
            x = torch.randn(3, 1, M, K, device="cuda", generator=g).bfloat16()
            w = (torch.randn(3, K, N, device="cuda", generator=g) * 0.02).bfloat16()
            stacked = torch.einsum("ebsk,ekm->ebsm", x, w)[0]
            alone = torch.einsum("ebsk,ekm->ebsm", x[:1], w[:1])[0]
            out[f"K{K} N{N} M{M}"] = bool(torch.equal(stacked, alone))
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

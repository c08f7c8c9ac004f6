#!/usr/bin/env python3
"""Whether one ensemble member's bf16 weight products give the same bits
stacked with two others (E = 3, as a tier holding all three members runs
them) as alone (E = 1, as a rank holding that member alone over a mesh
placement runs them), for every weight product of a dense tier at
qwen2.5-3b's widths and every row count the serving paths run.

    python3 chip_member_products.py [--out results.json]

For each product (the layers' names: wq, wk, wv, wo, w_gate, w_up, w_down,
lm_head) and M rows (1-128: decode steps and a serve chunk's rows; 256: an
admission chunk; 1024: generate's 8 x 128 prefill; 8192: classify's 32 x
256) it reports two comparisons of member 0's output, stacked against
alone:

  batched — the product as ``repro_torch.models.layers`` runs it, one
            batched call over E (``torch.einsum`` / ``torch.bmm``, for
            which cuBLAS picks a kernel by batch count);
  member  — the product as E 2-D products, one ``torch.mm`` a member on
            contiguous (rows, K) x (K, N) slices, which reach cuBLAS with
            the same shape and strides stacked and alone.

Prints the card's name and power limit, then one JSON object.  Needs one
CUDA card.
"""
import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# qwen2.5-3b: d 2048, 16 heads on 2 KV heads of 128, d_ff 11008, vocabulary
# 151936 (tied embeddings: the head is the embedding's transpose)
D, H, KVH, HD, F, V = 2048, 16, 2, 128, 11008, 151936
PRODUCTS = {  # name: (einsum of the layers, x shape after (E, 1, M), w shape after E)
    "wq": ("ebsd,edhk->ebshk", (D,), (D, H, HD)),
    "wk": ("ebsd,edhk->ebshk", (D,), (D, KVH, HD)),
    "wv": ("ebsd,edhk->ebshk", (D,), (D, KVH, HD)),
    "wo": ("ebshk,ehkd->ebsd", (H, HD), (H, HD, D)),
    "w_gate": ("ebsd,edf->ebsf", (D,), (D, F)),
    "w_up": ("ebsd,edf->ebsf", (D,), (D, F)),
    "w_down": ("ebsf,efd->ebsd", (F,), (F, D)),
    "lm_head": ("ebd,edv->ebv", (D,), None),
}
ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 8192)


def member_by_member(eq, x, w):
    """``torch.einsum(eq, x, w)`` (E leading on both, the contracted dims
    last in x and next in w) as E 2-D products on contiguous slices."""
    lhs, rhs = eq.split("->")[0].split(",")
    nk = len((set(lhs) & set(rhs)) - {"e"})
    E, kd, nd = x.shape[0], tuple(x.shape[x.ndim - nk:]), tuple(w.shape[1 + nk:])
    xs = x.reshape(E, -1, math.prod(kd)).contiguous()
    ws = w.reshape(E, math.prod(kd), math.prod(nd))
    out = torch.stack([torch.mm(xs[e], ws[e]) for e in range(E)])
    return out.reshape(tuple(x.shape[:x.ndim - nk]) + nd)


def product_bits(g):
    """{product: {M: {"batched": bool, "member": bool}}}: member 0 stacked
    three deep against alone."""
    out = {}
    for name, (eq, xs, ws) in PRODUCTS.items():
        out[name] = {}
        for M in ROWS:
            if name == "lm_head":
                x = torch.randn(3, M, *xs, device="cuda", generator=g).bfloat16()
                w = (torch.randn(3, V, D, device="cuda", generator=g) * 0.02).bfloat16().transpose(-1, -2)
                batched = lambda a, b: torch.bmm(a, b)  # noqa: E731
            else:
                x = torch.randn(3, 1, M, *xs, device="cuda", generator=g).bfloat16()
                w = (torch.randn(3, *ws, device="cuda", generator=g) * 0.02).bfloat16()
                batched = lambda a, b, eq=eq: torch.einsum(eq, a, b)  # noqa: E731
            member = lambda a, b, eq=eq: member_by_member(eq, a, b)  # noqa: E731
            with torch.no_grad():
                out[name][M] = {kind: bool(torch.equal(fn(x, w)[0], fn(x[:1], w[:1])[0]))
                                for kind, fn in (("batched", batched), ("member", member))}
            del x, w
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_member_products: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    bits = product_bits(torch.Generator(device="cuda").manual_seed(args.seed))
    out = {
        "products": bits,
        "batched_differs": {n: [m for m, r in rows.items() if not r["batched"]] for n, rows in bits.items()},
        "member_differs": {n: [m for m, r in rows.items() if not r["member"]] for n, rows in bits.items()},
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

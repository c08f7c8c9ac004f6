#!/usr/bin/env python3
"""Compare this tree's SSD and WKV6 scans with another tree's on one GPU, in
one process, so that both meet the same card, host and process state.

    python3 chip_scan_compare.py --other DIR [--rounds 6] [--kernels-only]
                                 [--seed N] [--out results.json]

DIR is a checkout of another commit (``git archive <commit> | tar -x -C
DIR``; under ``build/`` it is ignored by git).  Its
``kernels/mamba2_ssd/ops.py`` and ``kernels/rwkv6_wkv/ops.py`` are loaded
beside this tree's, each tree with its own ``kernels/build.py``, so DIR's
sources build into DIR's ``build/torch_kernels``.  Both trees' wrappers tick
the same launch counters.

1. kernels — cold-L2 device ms (``chip_smoke.device_ms``) and host µs a call
   (``chip_smoke.host_us``) of each tree's ``ssd`` and ``wkv6`` at the main
   path's shapes (those of ``chip_smoke.py`` phase 2), the two trees taken in
   turn ``rounds`` times, the first tree alternating.
2. generate (left out with ``--kernels-only``) — the second cascade of
   ``chip_smoke.py`` phase 4 (3 x zamba2-2.7b -> rwkv6-7b) at published
   widths and full depth, bf16 weights from ``--seed``, built once; its
   ``generate`` call (8 prompts of 128 tokens, 16 new) with each of the four
   pairings of the two trees' scans, in an order rotated every round,
   ``rounds`` times each, with the host seconds spent inside the scans'
   wrappers; then two ``generate`` calls of each tree's own pairing under
   torch.profiler (in the order A B B A), and the operators whose host or
   device time differs most between the two trees.

Prints one line per measurement and, last, a JSON summary; ``--out`` also
writes everything to a file.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def log(*a):
    print(*a, flush=True)


def load_tree_scans(root: Path):
    """The ``ops`` modules of the SSD and WKV6 scans of the checkout at
    ``root``, bound to that checkout's own ``build`` module."""
    import repro_torch.kernels as kpkg

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    src = root / "src" / "repro_torch" / "kernels"
    other_build = load("other_tree_build", src / "build.py")
    saved = kpkg.build
    kpkg.build = other_build  # what ``from repro_torch.kernels import build`` finds while loading
    try:
        ssd = load("other_tree_mamba2_ssd_ops", src / "mamba2_ssd" / "ops.py")
        wkv = load("other_tree_rwkv6_wkv_ops", src / "rwkv6_wkv" / "ops.py")
    finally:
        kpkg.build = saved
    return other_build, ssd, wkv


def summary(xs):
    return dict(min=min(xs), median=statistics.median(xs), max=max(xs), n=len(xs), all=xs)


def scan_cases(dev, g):
    """The main path's scan calls, as ``chip_smoke.py`` phase 2 times them:
    name -> (scan, args, kwargs)."""
    import torch.nn.functional as F

    def ssd_in(B, S, h0):  # zamba2-2.7b: 80 heads of P 64, G 1, N 64; x, B, C views of xBC
        H, P, G, N = 80, 64, 1, 64
        t = torch.randn(B, S, H * P + 2 * G * N, device=dev, generator=g).to(torch.bfloat16)
        x, Bm, Cm = (t[..., :H * P].reshape(B, S, H, P), t[..., H * P:H * P + G * N].reshape(B, S, G, N),
                     t[..., H * P + G * N:].reshape(B, S, G, N))
        dt = F.softplus(torch.randn(B, S, H, device=dev, generator=g) - 4.0)
        A = -torch.exp(torch.randn(3, H, device=dev, generator=g) * 0.3)
        s0 = torch.randn(B, H, N, P, device=dev, generator=g).mul(0.2) if h0 else None
        return (x, dt, A, Bm, Cm), dict(initial_state=s0, return_final_state=True)

    def wkv_in(B, S, h0):  # rwkv6-7b: 64 heads of 64
        H, D = 64, 64
        r, k, v = (torch.randn(B, S, H, D, device=dev, generator=g).to(torch.bfloat16) for _ in range(3))
        logw = -torch.exp(torch.randn(B, S, H, D, device=dev, generator=g) * 0.5 - 4.0)
        u = torch.randn(1, H, D, device=dev, generator=g).mul(0.5)
        s0 = torch.randn(B, H, D, D, device=dev, generator=g).mul(0.1) if h0 else None
        return (r, k, v, logw, u), dict(initial_state=s0, return_final_state=True)

    return {
        "ssd classify (96, 256, 80, 64)": ("ssd", *ssd_in(96, 256, False)),
        "ssd admission (3, 256, 80, 64) + state": ("ssd", *ssd_in(3, 256, True)),
        "ssd admission (3, 16, 80, 64) + state": ("ssd", *ssd_in(3, 16, True)),
        "wkv6 prefill (16, 256, 64, 64)": ("wkv6", *wkv_in(16, 256, False)),
        "wkv6 admission (1, 256, 64, 64) + state": ("wkv6", *wkv_in(1, 256, True)),
        "wkv6 admission (1, 16, 64, 64) + state": ("wkv6", *wkv_in(1, 16, True)),
        "wkv6 decode (8, 1, 64, 64) + state": ("wkv6", *wkv_in(8, 1, True)),
    }


def compare_kernels(trees, dev, seed, rounds):
    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (scan, args, kw) in scan_cases(dev, g).items():
        fns = {t: (lambda f=getattr(mods[scan], scan): f(*args, **kw)) for t, mods in trees.items()}
        ys = {t: fn() for t, fn in fns.items()}
        a, b = ys.values()
        agree = max(((p.float() - q.float()).abs().max() / q.float().abs().max().clamp_min(1e-30)).item()
                    for p, q in zip(a, b))
        dms = {t: [] for t in trees}
        hus = {t: [] for t in trees}
        for i in range(rounds):
            order = list(trees) if i % 2 == 0 else list(trees)[::-1]
            for t in order:
                dms[t].append(chip_smoke.device_ms(fns[t]))
                hus[t].append(chip_smoke.host_us(fns[t]))
        out[name] = {t: dict(device_ms=summary(dms[t]), host_us=summary(hus[t])) for t in trees}
        out[name]["normwise_between_trees"] = agree
        log(f"kernel {name}: " + "; ".join(
            f"{t} device ms {min(dms[t]):.4f}-{max(dms[t]):.4f} (median {statistics.median(dms[t]):.4f}), "
            f"host us median {statistics.median(hus[t]):.1f}" for t in trees)
            + f"; outputs between trees normwise {agree:.2e}")
    return out


def op_table(prof):
    """Operator name -> (calls, self host us, self device us) from a profile."""
    rows = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        rows[e.key] = (e.count, e.self_cpu_time_total, dev_us)
    return rows


def compare_generate(trees, dev, seed, rounds):
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.serve import CascadeServer, CascadeTier
    from torch.profiler import ProfilerActivity, profile

    spec = chip_smoke.CASCADES["zamba2-2.7b x3 -> rwkv6-7b"]
    a1, a2 = spec["tier1"], spec["tier2"]
    c1, c2 = get_config(a1), get_config(a2)
    g = torch.Generator(device=dev).manual_seed(seed)
    v1 = ens.init_ensemble(c1, 3, g, dev)
    v2 = ens.init_ensemble(c2, 1, g, dev)
    rng = np.random.default_rng(seed)
    vocab = min(c1.vocab_size, c2.vocab_size)
    server = CascadeServer([
        CascadeTier(c1, v1, TierSpec(f"{a1}-x3", "vote", 0.5, k=3, cost=3.0), device=dev),
        CascadeTier(c2, v2, TierSpec(a2, "confidence", -1.0, k=1, cost=1.0), device=dev),
    ], device=dev)
    toks = rng.integers(0, vocab, (8, 128)).astype(np.int32)

    # host seconds inside each scan wrapper, whichever tree's it is
    spent = {"ssd": 0.0, "wkv6": 0.0}

    def metered(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    names = list(trees)
    pairings = {f"ssd {s} + wkv6 {w}": (s, w) for s, w in itertools.product(names, names)}
    own = [f"ssd {t} + wkv6 {t}" for t in names]
    # the functions themselves, taken before this tree's module attributes are swapped
    scans = {t: dict(ssd=metered("ssd", m["ssd"].ssd), wkv6=metered("wkv6", m["wkv6"].wkv6))
             for t, m in trees.items()}

    def use(pairing):
        s, w = pairings[pairing]
        ssd_ops.ssd, wkv_ops.wkv6 = scans[s]["ssd"], scans[w]["wkv6"]

    def run():
        for k in spent:
            spent[k] = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = server.generate(toks, 16)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    originals = ssd_ops.ssd, wkv_ops.wkv6
    walls = {p: [] for p in pairings}
    scan_host = {p: {"ssd": [], "wkv6": []} for p in pairings}
    tokens = {}
    try:
        with torch.no_grad():
            server.generate(toks[:8, :16], 16)  # warm-up at a small shape, as chip_smoke does
            for p in pairings:  # and once at the timed shape with each pairing
                use(p)
                run()
            order = list(pairings)
            for i in range(rounds):
                for p in order[i % len(order):] + order[:i % len(order)]:
                    use(p)
                    wall, res = run()
                    walls[p].append(wall)
                    for k in spent:
                        scan_host[p][k].append(spent[k])
                    tokens[p] = (res.tier_counts.tolist(), res.pred.tolist())
                    log(f"generate round {i} {p}: wall {wall:.4f} s, host in ssd {spent['ssd']:.4f} s, "
                        f"in wkv6 {spent['wkv6']:.4f} s, tier counts {res.tier_counts.tolist()}")
            # each tree profiled twice, in the order A B B A, so that neither
            # always meets the profiler first; a tree's two tables are summed
            tables, profiled = {p: {} for p in own}, []
            for p in own + own[::-1]:
                use(p)
                run()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    wall, _ = run()
                t = op_table(prof)
                for k, row in t.items():
                    tables[p][k] = tuple(x + y for x, y in zip(tables[p].get(k, (0, 0.0, 0.0)), row))
                profiled.append(dict(pairing=p, wall_s=wall, host_us=sum(r[1] for r in t.values()),
                                     device_us=sum(r[2] for r in t.values())))
                log(f"profiled generate {p}: wall {wall:.4f} s, self host {profiled[-1]['host_us'] / 1e6:.4f} s, "
                    f"self device {profiled[-1]['device_us'] / 1e6:.4f} s")
    finally:
        ssd_ops.ssd, wkv_ops.wkv6 = originals

    a, b = (tables[p] for p in own)
    keys = set(a) | set(b)
    zero = (0, 0.0, 0.0)
    diff = [dict(op=k, calls=(a.get(k, zero)[0], b.get(k, zero)[0]),
                 host_us=(a.get(k, zero)[1], b.get(k, zero)[1]),
                 device_us=(a.get(k, zero)[2], b.get(k, zero)[2])) for k in keys]
    totals = {p: dict(calls=sum(r[0] for r in t.values()), host_us=sum(r[1] for r in t.values()),
                      device_us=sum(r[2] for r in t.values())) for p, t in tables.items()}
    by_host = sorted(diff, key=lambda d: -abs(d["host_us"][0] - d["host_us"][1]))[:20]
    by_dev = sorted(diff, key=lambda d: -abs(d["device_us"][0] - d["device_us"][1]))[:12]
    log(f"profiled totals over both profiles (self host us, self device us, calls): {json.dumps(totals)}")
    for title, rows in (("host", by_host), ("device", by_dev)):
        log(f"operators by self {title} time difference, {own[0]} vs {own[1]}, both profiles summed:")
        for d in rows:
            log(f"  {d['op'][:70]:70s} calls {d['calls'][0]:6d} {d['calls'][1]:6d}  "
                f"host us {d['host_us'][0]:12.1f} {d['host_us'][1]:12.1f}  "
                f"device us {d['device_us'][0]:12.1f} {d['device_us'][1]:12.1f}")
    same_tokens = len({json.dumps(v) for v in tokens.values()}) == 1
    return dict(walls={p: summary(w) for p, w in walls.items()},
                scan_host_s={p: {k: summary(v) for k, v in d.items()} for p, d in scan_host.items()},
                same_tier_counts_and_preds=same_tokens, profiled=profiled, profiled_totals=totals,
                by_host=by_host, by_device=by_dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, help="a checkout of the other commit")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--kernels-only", action="store_true", help="leave out the generate comparison")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_scan_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE))
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    other_build, other_ssd, other_wkv = load_tree_scans(Path(args.other).resolve())
    t0 = time.perf_counter()
    build.build_all()
    other_build.build_all()
    log(f"build: both trees in {time.perf_counter() - t0:.1f} s")
    trees = {"this": {"ssd": ssd_ops, "wkv6": wkv_ops}, "other": {"ssd": other_ssd, "wkv6": other_wkv}}
    result = dict(card=card, other=str(args.other), rounds=args.rounds)
    result["kernels"] = compare_kernels(trees, dev, args.seed, args.rounds)
    if not args.kernels_only:
        result["generate"] = compare_generate(trees, dev, args.seed, args.rounds)
        for p, s in result["generate"]["walls"].items():
            log(f"generate {p}: wall s min {s['min']:.4f} median {s['median']:.4f} max {s['max']:.4f}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    log(json.dumps({"card": card, "kernels": {k: {t: v[t]["device_ms"]["median"] for t in trees}
                                              for k, v in result["kernels"].items()},
                    "generate": {p: s["median"] for p, s in result.get("generate", {}).get("walls", {}).items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

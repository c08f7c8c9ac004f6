#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, in order; any failure raises and exits non-zero:

1. build — compiles every CUDA kernel of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all in parallel) and prints the build seconds and
   the card's name and power limit.
2. kernels — holds each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge cases (ragged vocabulary, forced
   argmax ties, all/none deferred, left-pad ``starts`` with pure-pad rows,
   window/softcap, ragged Sk, vector ``cur_len``), with the tolerance stated
   beside each check; times kernel, plain version and one library call (the
   yardstick; the port never calls it) with CUDA events.
3. reference — the port on the card (kernels) against the port on the CPU
   (plain versions) with the same bf16 weights at reduced width.
4. main path — the cascade at published widths and full depth: tier 1 a k=3
   ensemble of qwen2.5-3b (score rule, theta = median tier-1 mean score on a
   calibration batch; for generate the digest vote with theta = 0.5), tier 2
   internlm2-1.8b (confidence, theta = -1), bf16 weights drawn from ``--seed``.  ``classify`` on 32 prompts of 256 tokens and
   greedy ``generate`` on 8 prompts of 128 tokens with 16 new tokens, each run
   with the launch counters zeroed just before and read just after.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # dense tensor-core bf16
F32_FLOPS = 67e12  # f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_agreement(dev, g):
    from repro_torch.kernels.agreement import ops

    def run(E, B, V, ties):
        x = torch.randn(E, B, V, device=dev, generator=g)
        if ties:  # the max hit twice in a row (first index wins) incl. the ragged tail
            x[:, : B // 2, V // 3] = x[:, : B // 2, V - 1] = 40.0
            x[0, -1, 11] = x[1, -1, 11] = x[2 % E, -1, 5] = 60.0  # vote tie: smallest id
        m, idx, l = ops.member_stats(x)
        pm, pidx, pl = ops.member_stats_plain(x)
        require(torch.equal(idx, pidx), f"agreement argmax differs at V={V}")
        require(torch.equal(m, pm), f"agreement max differs at V={V}")
        rel = ((l - pl).abs() / pl).max().item()
        require(rel <= 1e-5, f"agreement sumexp rel err {rel} > 1e-5 at V={V}")
        got, ref = ops._epilogue(x, m, idx, l), ops._epilogue(x, pm, pidx, pl)
        require(torch.equal(got["pred"], ref["pred"]), "agreement vote differs")
        return x, (l - pl).abs().max().item()

    for V in (500, 92544):
        run(4, 8, V, ties=True)
    x, err = run(3, 32, 151936, ties=True)  # tier-1 classify logits
    E, B, V = x.shape
    n_bytes = nbytes(x) + E * B * 12
    b_ms, b_by = bound(n_bytes, 4 * x.numel(), F32_FLOPS)
    return dict(
        name="agreement", tol="argmax and max exact, sumexp rel 1e-5",
        shape=[E, B, V], max_abs_err=err,
        ms=time_ms(lambda: ops.member_stats(x)),
        plain_ms=time_ms(lambda: ops.member_stats_plain(x)),
        library_ms=time_ms(lambda: (torch.max(x, -1), torch.logsumexp(x, -1))),
        bound_ms=b_ms, bound_by=b_by,
    )


def check_compaction(dev, g):
    from repro_torch.kernels.compaction import ops

    def run(tree, mask):
        out, im, cnt = ops.compact_tree(tree, mask)
        p_im, p_cnt = ops.compact_indices_plain(mask)
        require(torch.equal(im, p_im) and int(cnt) == int(p_cnt), "compaction index map differs")
        for k, v in tree.items():
            require(torch.equal(out[k], ops.gather_rows_plain(v, p_im)), f"compaction payload {k} differs")
        return int(cnt)

    for B in (32, 1500):
        for kind in ("all", "none", "random"):
            mask = (torch.rand(B, device=dev, generator=g) < 0.5) if kind == "random" else torch.full((B,), kind == "all", device=dev)
            tree = {
                "f32": torch.randn(B, 33, device=dev, generator=g),
                "bf16": torch.randn(B, 7, device=dev, generator=g).to(torch.bfloat16),
                "i32": torch.randint(-2**31, 2**31 - 1, (B, 3), device=dev, generator=g, dtype=torch.int32),
            }
            run(tree, mask)
    # the classify transition: {tokens (32, 256) i32, __idx (32,) i32}
    B = 32
    tree = {
        "tokens": torch.randint(0, 92544, (B, 256), device=dev, generator=g, dtype=torch.int32),
        "__idx": torch.arange(B, dtype=torch.int32, device=dev),
    }
    mask = torch.rand(B, device=dev, generator=g) < 0.5
    n = run(tree, mask)
    row_bytes = sum(v[0].numel() * v.element_size() for v in tree.values())
    n_bytes = B + 4 * B + 4 + n * row_bytes + B * row_bytes

    def library():
        idx = torch.nonzero(mask).flatten()
        return {k: v.index_select(0, idx) for k, v in tree.items()}

    def plain():
        im, _ = ops.compact_indices_plain(mask)
        return {k: ops.gather_rows_plain(v, im) for k, v in tree.items()}

    b_ms, b_by = bound(n_bytes, 0, F32_FLOPS)
    return dict(
        name="compaction", tol="exact", shape={"tokens": [B, 256], "__idx": [B], "deferred": n},
        max_abs_err=0.0,
        ms=time_ms(lambda: ops.compact_tree(tree, mask)),
        plain_ms=time_ms(plain), library_ms=time_ms(library),
        bound_ms=b_ms, bound_by=b_by,
    )


FLASH_TOL = 2e-2  # bf16 in/out, P rounded to bf16 before the PV product


def check_flash(dev, g):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    def qkv(B, Sq, Sk, H, KVH, hd):
        mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
        return mk(B, Sq, H, hd), mk(B, Sk, KVH, hd), mk(B, Sk, KVH, hd)

    def run(q, k, v, **kw):
        got = ops.flash_attention(q, k, v, **kw).float()
        ref = ops.flash_attention_plain(q, k, v, **kw).float()
        err = (got - ref).abs().max().item()
        require(math.isfinite(err) and err <= FLASH_TOL, f"flash err {err} > {FLASH_TOL} ({kw})")
        if kw.get("starts") is not None:
            for b, s in enumerate(kw["starts"].tolist()):
                require(not got[b, :s].any(), "flash pure-pad rows not zero")
        return err

    st = torch.tensor([0, 37, 150, 200], dtype=torch.int32, device=dev)
    run(*qkv(4, 200, 200, 8, 2, 64), causal=True, starts=st)
    run(*qkv(4, 200, 200, 8, 2, 128), causal=True, window=48, softcap=30.0)
    run(*qkv(4, 200, 200, 8, 2, 128), causal=True, window=48, starts=st)
    run(*qkv(2, 77, 200, 8, 8, 64), causal=False)
    run(*qkv(16, 256, 256, 16, 8, 128), causal=True)  # tier 2 prefill
    q, k, v = qkv(96, 256, 256, 16, 2, 128)  # tier 1 prefill: E*B = 3*32 rows
    err = run(q, k, v, causal=True)
    B, S, H, hd = q.shape
    pairs = B * H * S * (S + 1) // 2
    b_ms, b_by = bound(nbytes(q, k, v, q), 4 * hd * pairs, BF16_FLOPS)  # q, k, v read; out written
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return dict(
        name="flash_attention", tol=f"abs {FLASH_TOL}", shape={"q": list(q.shape), "kv": list(k.shape)},
        max_abs_err=err,
        ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        plain_ms=time_ms(lambda: ops.flash_attention_plain(q, k, v, causal=True), iters=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    )


DECODE_TOL = 2e-2


def check_decode(dev, g):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops

    def inputs(B, H, KVH, S, hd):
        mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
        return mk(B, 1, H, hd), mk(B, KVH, S, hd), mk(B, KVH, S, hd)

    def run(q, kc, vc, cur, **kw):
        got = ops.decode_attention_bksd(q, kc, vc, cur, **kw).float()
        ref = ops.decode_attention_plain(q, kc, vc, cur, **kw).float()
        err = (got - ref).abs().max().item()
        require(math.isfinite(err) and err <= DECODE_TOL, f"decode err {err} > {DECODE_TOL} ({kw})")
        return err

    q, kc, vc = inputs(4, 16, 2, 300, 128)
    cur = torch.tensor([1, 64, 300, 177], dtype=torch.int32, device=dev)
    run(q, kc, vc, cur)
    run(q, kc, vc, cur, starts=torch.tensor([0, 64, 10, 100], dtype=torch.int32, device=dev))  # row 1: pure pad
    run(q, kc, vc, 250, window=32, softcap=20.0)
    run(*inputs(3, 8, 8, 100, 64), 100, starts=torch.tensor([5, 0, 99], dtype=torch.int32, device=dev))
    run(*inputs(8, 16, 8, 144, 128), 143)  # tier 2 generate decode
    q, kc, vc = inputs(24, 16, 2, 144, 128)  # tier 1: E*B = 3*8 rows, last step
    cur = 143
    err = run(q, kc, vc, cur)
    B, _, H, hd = q.shape
    KVH = kc.shape[1]
    n_bytes = 2 * nbytes(q) + 2 * B * KVH * cur * hd * 2
    b_ms, b_by = bound(n_bytes, 4 * B * H * cur * hd, BF16_FLOPS)
    qt, ks, vs = q.transpose(1, 2), kc[:, :, :cur], vc[:, :, :cur]
    return dict(
        name="decode_attention", tol=f"abs {DECODE_TOL}", shape={"q": list(q.shape), "cache": list(kc.shape), "cur_len": cur},
        max_abs_err=err,
        ms=time_ms(lambda: ops.decode_attention_bksd(q, kc, vc, cur)),
        plain_ms=time_ms(lambda: ops.decode_attention_plain(q, kc, vc, cur)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, ks, vs, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
    )


# ---------------------------------------------------------------------------
# phase 3: card (kernels) against CPU (plain versions) on the same weights
# ---------------------------------------------------------------------------

REF_TOL = 5e-2  # normwise, bf16 through two layers with bf16 rounding at other places


def check_reference(dev, seed):
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.models.params import tree_map
    from repro_torch.serve.engine import grow_cache

    errs = {}
    for arch, k in (("qwen2.5-3b", 3), ("internlm2-1.8b", 1)):
        cfg = get_config(arch).reduced()
        vals = ens.init_ensemble(cfg, k, torch.Generator().manual_seed(seed), "cpu")
        gvals = tree_map(lambda t: t.to(dev), vals)
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
        batch = {"tokens": toks, "starts": np.array([0, 3, 17, 39], np.int32)}
        outs = []
        for v in (vals, gvals):
            logits, cache = ens.ensemble_prefill(v, batch, cfg)
            cache = grow_cache(cache, 2, cfg)
            tok = torch.as_tensor(np.full((k, 4, 1), 7, np.int32), device=logits.device)
            step, _ = ens.ensemble_decode_step(v, tok, cache, 40, cfg)
            outs.append((logits.float().cpu(), step.float().cpu()))
        for name, a, b in (("prefill", outs[0][0], outs[1][0]), ("decode", outs[0][1], outs[1][1])):
            err = ((a - b).abs().max() / a.abs().max()).item()
            require(math.isfinite(err) and err <= REF_TOL, f"{arch} {name} card vs cpu normwise err {err} > {REF_TOL}")
            errs[f"{arch}/{name}"] = err
    return errs


# ---------------------------------------------------------------------------
# phase 4: the main path at published widths
# ---------------------------------------------------------------------------

CLASSIFY_KERNELS = ("agreement", "compaction", "flash_attention")
GENERATE_KERNELS = ("compaction", "flash_attention", "decode_attention")


def main_path(dev, seed):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec, host_fetch_stats, reset_host_fetch_stats
    from repro_torch.kernels.agreement import ops as agree_ops
    from repro_torch.models.params import param_count
    from repro_torch.serve import CascadeServer, CascadeTier

    c1, c2 = get_config("qwen2.5-3b"), get_config("internlm2-1.8b")
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    v1 = ens.init_ensemble(c1, 3, g, dev)
    v2 = ens.init_ensemble(c2, 1, g, dev)
    torch.cuda.synchronize()
    log(f"weights: tier1 {param_count(v1) / 1e9:.3f}B params, tier2 {param_count(v2) / 1e9:.3f}B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    vocab = min(c1.vocab_size, c2.vocab_size)

    with torch.no_grad():
        cal = rng.integers(0, vocab, (32, 256)).astype(np.int32)
        s = agree_ops.agreement(ens.ensemble_last_logits(v1, {"tokens": cal}, c1))["mean_score"]
        theta = float(s.median())
        log(f"calibration: tier-1 mean_score median theta={theta:.6g} (min {s.min().item():.4g}, max {s.max().item():.4g})")
        tier2 = CascadeTier(c2, v2, TierSpec("internlm2-1.8b", "confidence", -1.0, k=1, cost=1.0), device=dev)
        servers = {  # generate votes on answer digests: defer unless 2 of 3 members agree
            "classify": CascadeServer([
                CascadeTier(c1, v1, TierSpec("qwen2.5-3b-x3", "score", theta, k=3, cost=3.0), device=dev), tier2,
            ], device=dev),
            "generate": CascadeServer([
                CascadeTier(c1, v1, TierSpec("qwen2.5-3b-x3", "vote", 0.5, k=3, cost=3.0), device=dev), tier2,
            ], device=dev),
        }
        results, launches = {}, {}
        for mode, B, S, args, need in (
            ("classify", 32, 256, (), CLASSIFY_KERNELS),
            ("generate", 8, 128, (16,), GENERATE_KERNELS),
        ):
            server = servers[mode]
            toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
            getattr(server, mode)(toks[:8, :16], *args)  # warm-up at a small shape
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_host_fetch_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = getattr(server, mode)(toks, *args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            launches[mode] = counts
            for name in need:
                require(counts[name] > 0, f"{mode}: kernel {name} was not launched on the main path")
            require(res.tier_counts.sum() == B and res.pred.shape == (B,), f"{mode}: bad result shapes")
            require(np.isfinite(res.scores).all(), f"{mode}: non-finite scores")
            require(set(np.unique(res.tier_of)) <= {0, 1}, f"{mode}: bad tier_of")
            if mode == "classify":
                require(((res.pred >= 0) & (res.pred < max(c1.vocab_size, c2.vocab_size))).all(), "classify: bad class ids")
            results[mode] = dict(
                batch=[B, S], wall_s=wall, tier_counts=res.tier_counts.tolist(), evaluated=res.evaluated.tolist(),
                cost=res.cost, host_fetch=host_fetch_stats(), launches=counts,
                max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
            )
            log(f"{mode}: {json.dumps(results[mode])}")
    return results, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write every number to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} kernels in {build_s:.1f}s -> {sorted(str(p.name) for p in libs.values())}")

    g = torch.Generator(device=dev).manual_seed(args.seed)
    checks = []
    for fn in (check_agreement, check_compaction, check_flash, check_decode):
        r = fn(dev, g)
        log(f"kernel {r['name']}: {json.dumps(r)}")
        checks.append(r)
    ref = check_reference(dev, args.seed)
    log(f"reference (card vs cpu, normwise, tol {REF_TOL}): {json.dumps(ref)}")
    results, launches = main_path(dev, args.seed)

    sources = {
        "agreement": ("src/repro_torch/csrc/agreement.cu", "src/repro/kernels/agreement/kernel.py:67"),
        "compaction": ("src/repro_torch/csrc/compaction.cu", "src/repro/kernels/compaction/kernel.py:56"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:179"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu", "src/repro/kernels/decode_attention/kernel.py:226"),
    }
    line = {"kernels": [
        {
            "name": c["name"], "route": "cuda", "source": sources[c["name"]][0],
            "replaces": sources[c["name"]][1],
            "launches": sum(launches[m][c["name"]] for m in launches),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        }
        for c in checks
    ]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, build_s=build_s, checks=checks, reference=ref, main_path=results, line=line,
        ), indent=1))
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, in order; any failure raises and exits non-zero:

1. build — compiles every CUDA source of the port from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all in parallel, the Mamba2 SSD and RWKV6 WKV
   scans included) and prints the build seconds and the card's name and
   power limit.
2. kernels — holds each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge cases (ragged vocabulary, rows
   off 16 bytes, forced argmax ties, also across the agreement kernel's
   cluster slices; all/none deferred, B up to 5000, 11 leaves of mixed
   dtypes and the paged K/V view of chunked admission at both tiers'
   shapes, with compaction, agreement and the view held to 1 device launch
   a call, the view also timed against the two ``paged_pool_view`` calls
   it replaced; left-pad ``starts`` with pure-pad rows,
   window/softcap, ragged Sk, vector ``cur_len``, hd 80 with G = 1 at
   zamba2's shapes for flash and dense decode; for the paged decode kernel
   shuffled page tables, unmapped pages past and inside ``cur_len``,
   ``cur_len`` off the page grid, page sizes 16 and 64, hd 64 with G = 1,
   both tiers' serving shapes (G = 8 and G = 2 at hd 128), and bitwise
   equality with the dense decode kernel on the gathered view; for the SSD
   scan (``check_ssd``) ragged S, an initial state, G > 1, per-member A,
   P/N at 64/64 and 32/16, the f32 route and x, B, C as views of one xBC
   tensor, and at most 2 device launches a call; for the WKV6 scan
   (``check_wkv6``) S = 1 with a state, ragged S, strongly negative
   log-decay, per-member u and D 32 and 64; both scans also at
   serve_continuous's chunked-admission shapes, a full 256-token chunk and a
   16-token one), with
   the tolerance stated beside each check; times kernel, plain
   version and one library call where one computes the same function (the
   yardstick; the port never calls it) with CUDA events (``ms``), and by
   device time with a cold L2 (``device_ms``: a CUDA graph of 20 calls,
   each after a read of twice the L2's size, replayed, less a graph of the
   reads alone; for a library call that waits on the device,
   torch.profiler's kernel durations, the reads' taken off the same way),
   host cost a call (``host_us``) and device kernels a call.
   The redesigned attention kernels are also held at long ragged shapes:
   flash with Sq, Sk of 1000 and more and a single K tile, dense decode at
   S 512, 2048 and 4096 with window/starts edges across split boundaries,
   and paged decode bitwise the dense kernel at S 4096.
3. reference — the port on the card (kernels) against the port on the CPU
   (plain versions) with the same bf16 weights at reduced width: prefill and
   decode, paged decode and paged chunked prefill for the dense tiers;
   prefill, decode and chunked prefill into a slot followed by a decode step
   for rwkv6-7b and zamba2-2.7b, and the same again in float32 (rwkv6-7b,
   and zamba2-2.7b's Mamba2 backbone) at a tight tolerance, where only
   summation order differs; then short ``serve_continuous`` runs on the
   card, each with the eager oracle and with the graphed slot programs:
   the dense cascade with block-paged pools and with the dense slot cache,
   the recurrent cascade with dense slot caches; all must emit equal
   tokens.  Then the batch programs (``check_batch_programs_on_card``) and
   the single-model engine (``check_engine_on_card``: classify, generate
   and a sampled serve_continuous, graphed == eager).
4. main path — two cascades at published widths and full depth, bf16
   weights drawn from ``--seed``, the second built after the first one's
   tensors are freed by reference counting alone (the cyclic collector is
   off, and device memory that outlives a cascade fails the run).  First: tier 1 a k=3 ensemble of qwen2.5-3b, tier 2
   internlm2-1.8b.  Second: tier 1 a k=3 ensemble of zamba2-2.7b (Mamba2
   backbone, shared attention every 6th layer), tier 2 rwkv6-7b — the path
   that runs the SSD and WKV6 kernels.  Each: tier 1 uses the score rule
   for classify (theta = median tier-1 mean score on a calibration batch)
   and the digest vote with theta = 0.5 for generate and serve_continuous;
   tier 2 answers (confidence, theta = -1).  ``classify`` on 32 prompts of
   256 tokens, greedy ``generate`` on 8 prompts of 128 tokens with 16 new
   tokens, and ``serve_continuous`` (8 slots, max_seq 512, chunked
   prefill; 16-token pages where the family pages, dense slot caches for
   the recurrent tiers) on 32 requests of 16-384 prompt tokens, 8 of them
   sharing a 128-token prefix, 16 new tokens each: once with the eager
   oracle, then twice with each tier's decode step and chunk buckets
   captured as CUDA graphs (the first graphed run captures, the second
   must capture nothing: ``trace_counts()`` flat); the three runs must
   emit bitwise equal tokens, tiers and pool counters, launch every kernel
   as often, and a graphed run peak within 2 GiB of the eager run's device
   memory.  Each run with the launch counters zeroed just before and read
   just after; the kernels line takes the second graphed run's.  Then one
   chunked-admission call of each paged tier under torch.profiler: its
   host operators, device kernels and compaction launches, with the
   one-launch K/V view, with the two ``paged_pool_view`` calls it
   replaced, and as a CUDA-graph replay (device kernels equal to the eager
   call's).  Last, tier 1's generate over more (S, max_new) shapes than
   the tier keeps batch buckets (``bucket_memory_check``): device memory
   level once the tier is full.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import gc
import hashlib
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
TF32_FLOPS = 495e12  # dense tensor-core TF32
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


@functools.cache
def l2_flush():
    """A call that reads a buffer twice the card's L2 size, leaving in the L2
    nothing a timed call uses: the main path's kernels find their inputs in
    HBM (each layer's cache and weights are read once a step), so a timed
    call must too."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    buf, sink = torch.ones(2 * l2 // 4, device="cuda"), torch.empty((), device="cuda")
    return lambda: torch.sum(buf, dim=0, out=sink)


def _graph(fn, iters):
    """``iters`` calls of ``fn`` captured in one CUDA graph (the wrappers'
    ctypes launches go on the current stream, which is the capture stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def device_ms(fn, iters=20, reps=5):
    """Device time of one call with a cold L2: a graph of ``iters`` calls,
    each after an L2 flush, and a graph of the flushes alone are replayed in
    turn ``reps`` times between CUDA events; the difference over ``iters``.
    Host issue is out of the measurement; the gaps between a call's own
    kernels are in it."""
    flush = l2_flush()
    fn()
    torch.cuda.synchronize()
    both, alone = _graph(lambda: (flush(), fn()), iters), _graph(flush, iters)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t_both = t_alone = 0.0
    for _ in range(reps):
        ev[0].record()
        both.replay()
        ev[1].record()
        alone.replay()
        ev[2].record()
        torch.cuda.synchronize()
        t_both += ev[0].elapsed_time(ev[1])
        t_alone += ev[1].elapsed_time(ev[2])
    del both, alone
    return (t_both - t_alone) / (iters * reps)


def profiled(fn, iters=20):
    """(device ms, kernel launches) of one call from torch.profiler's CUDA
    records: the summed durations of the call's kernels and copies, and the
    count of its kernels.  None, None when the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then holds no device records: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            break
    else:
        return None, None
    kernels = [e for e in dev if not e.name.lower().startswith(("memcpy", "memset"))]
    return sum(e.time_range.elapsed_us() for e in dev) / iters / 1e3, len(kernels) / iters


def profiled_cold_ms(fn):
    """Device time of one call with a cold L2 by the profiler, for a call that
    a graph cannot hold (one that waits on the device, like ``nonzero``):
    each call after an L2 flush, less the flushes alone."""
    flush = l2_flush()
    both, alone = profiled(lambda: (flush(), fn()))[0], profiled(flush)[0]
    return None if both is None or alone is None else both - alone


def host_us(fn, calls=100, batches=3):
    """Host cost of one call: the median over batches of the mean wall time
    of ``calls`` back-to-back calls, with no synchronisation inside a batch
    (the device runs behind; the queue does not fill at this count)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(out)[len(out) // 2]


def timings(kernel, plain, library, *, plain_iters=20, library_graph=True):
    """Every time phase 2 records for a kernel: CUDA-event ``ms`` over 20
    back-to-back calls (as in earlier slices), ``device_ms`` (cold L2),
    ``host_us``, device launches a call (profiler), the plain version's event
    time and the library call's event and device times (``library`` None:
    no single PyTorch call computes the function)."""
    _, per_call = profiled(kernel)
    out = dict(
        ms=time_ms(kernel), device_ms=device_ms(kernel), host_us=host_us(kernel),
        device_launches_per_call=per_call, plain_ms=time_ms(plain, iters=plain_iters),
        library_ms=None, library_device_ms=None, library_device_method=None,
    )
    if library is not None:
        out["library_ms"] = time_ms(library)
        if library_graph:
            out["library_device_ms"], out["library_device_method"] = device_ms(library), "graph"
        else:
            out["library_device_ms"], out["library_device_method"] = profiled_cold_ms(library), "profiler"
    return out


def bound(n_bytes, n_ops, peak_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def outputs_digest(*arrays):
    """sha256 (16 hex digits) of the arrays as int64: equal digests, equal
    outputs — a run's tokens compared with another tree's run."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.asarray(a, np.int64).tobytes())
    return h.hexdigest()[:16]


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def slice_edges(V, clusters=(2, 4, 8)):
    """Element indices where the agreement kernel's V slices meet (a row
    over a cluster of C blocks, ceil(V / 4 / C) float4s a block)."""
    n4 = V // 4
    return sorted({4 * -(-n4 // C) * r for C in clusters for r in range(1, C)} - {V})


def check_agreement(dev, g, gx):
    from repro_torch.kernels.agreement import ops

    def run(E, B, V, ties, gen=g):
        x = torch.randn(E, B, V, device=dev, generator=gen)
        if ties:  # the max hit twice in a row (first index wins) incl. the ragged tail
            x[:, : B // 2, V // 3] = x[:, : B // 2, V - 1] = 40.0
            for r, edge in enumerate(slice_edges(V)):  # and on both sides of every slice edge
                x[:, B // 2 + r % (B - B // 2), edge - 1] = x[:, B // 2 + r % (B - B // 2), edge] = 20.0 + r
            x[0, -1, 11] = x[1, -1, 11] = x[2 % E, -1, 5] = 60.0  # vote tie: smallest id
        m, idx, l = ops.member_stats(x)
        pm, pidx, pl = ops.member_stats_plain(x)
        require(torch.equal(idx, pidx), f"agreement argmax differs at {(E, B, V)}")
        require(torch.equal(m, pm), f"agreement max differs at {(E, B, V)}")
        rel = ((l - pl).abs() / pl).max().item()
        require(rel <= 1e-5, f"agreement sumexp rel err {rel} > 1e-5 at {(E, B, V)}")
        got, ref = ops._epilogue(x, m, idx, l), ops._epilogue(x, pm, pidx, pl)
        require(torch.equal(got["pred"], ref["pred"]), "agreement vote differs")
        return x, (l - pl).abs().max().item()

    for V in (500, 92544):
        run(4, 8, V, ties=True)
    # E*B 24 (clusters of 8 at long V), V ragged (151937 starts rows off 16 bytes)
    for E, B, V in ((3, 8, 151936), (3, 8, 151937), (3, 32, 151937)):
        run(E, B, V, ties=True, gen=gx)
    x, err = run(3, 32, 151936, ties=True)  # tier-1 classify logits (clusters of 4)
    E, B, V = x.shape
    n_bytes = nbytes(x) + E * B * 12
    b_ms, b_by = bound(n_bytes, 4 * x.numel(), F32_FLOPS)
    out = dict(
        name="agreement", tol="argmax and max exact, sumexp rel 1e-5",
        shape=[E, B, V], max_abs_err=err,
        **timings(lambda: ops.member_stats(x), lambda: ops.member_stats_plain(x),
                  lambda: (torch.max(x, -1), torch.logsumexp(x, -1))),
        bound_ms=b_ms, bound_by=b_by,
    )
    require(out["device_launches_per_call"] == 1, f"agreement: {out['device_launches_per_call']} device launches a call")
    # the card's read rate at this size: one PyTorch reduction over the same logits
    out["sum_device_ms"] = device_ms(lambda: torch.sum(x))
    return out


def path_times(fn):
    """``ms`` by events, cold-L2 ``device_ms``, ``host_us`` and device
    launches a call of a call that is not a kernel's wrapper."""
    return dict(ms=time_ms(fn), device_ms=device_ms(fn), host_us=host_us(fn),
                device_launches_per_call=profiled(fn)[1])


def check_compaction(dev, g, gx):
    from repro_torch.kernels.compaction import ops

    def run(tree, mask):
        out, im, cnt = ops.compact_tree(tree, mask)
        p_im, p_cnt = ops.compact_indices_plain(mask)
        require(torch.equal(im, p_im) and int(cnt) == int(p_cnt), "compaction index map differs")
        for k, v in tree.items():
            require(torch.equal(out[k], ops.gather_rows_plain(v, p_im)), f"compaction payload {k} differs")
        return int(cnt)

    for B in (1, 32, 1500, 5000):
        gen = g if B in (32, 1500) else gx
        for kind in ("all", "none", "random"):
            mask = (torch.rand(B, device=dev, generator=gen) < 0.5) if kind == "random" else torch.full((B,), kind == "all", device=dev)
            tree = {
                "f32": torch.randn(B, 33, device=dev, generator=gen),
                "bf16": torch.randn(B, 7, device=dev, generator=gen).to(torch.bfloat16),
                "i32": torch.randint(-2**31, 2**31 - 1, (B, 3), device=dev, generator=gen, dtype=torch.int32),
            }
            tree["u8"] = torch.randint(0, 256, (B, 5), device=dev, generator=gx, dtype=torch.uint8)
            run(tree, mask)
            # 11 leaves: a second launch for the last three
            run({f"{k}{i}": v for i in range(3) for k, v in tree.items() if i < 2 or k != "u8"}, mask)
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
    out = dict(
        name="compaction", tol="exact", shape={"tokens": [B, 256], "__idx": [B], "deferred": n},
        max_abs_err=0.0,
        # nonzero waits for the device (a graph cannot hold it): its device time is the profiler's
        **timings(lambda: ops.compact_tree(tree, mask), plain, library, library_graph=False),
        bound_ms=b_ms, bound_by=b_by,
    )
    require(out["device_launches_per_call"] == 1, f"compaction: {out['device_launches_per_call']} device launches a call")
    out["paged_kv_view"] = check_paged_kv_view(dev, gx)
    return out


def check_paged_kv_view(dev, g):
    """The K/V view one layer of a chunked-admission call reads, at both
    tiers' shapes (8 slots of max_seq 512 in 16-row pages: n_pg 32, a pool
    of 257 pages; the slot maps 24 shuffled pages, a 384-token prompt, -1
    past them): exact against the plain version, timed beside the bytes
    bound, ``index_select`` + ``.contiguous()`` (the yardstick) and the two
    ``paged_pool_view`` calls through ``gather_rows`` it replaced."""
    from repro_torch.kernels.compaction import ops

    res = {}
    for tier, E, KVH in (("qwen2.5-3b", 3, 2), ("internlm2-1.8b", 1, 8)):
        ps, hd, n_pg, P = 16, 128, 32, 8 * 32 + 1
        kp, vp = (torch.randn(E, P, KVH, ps, hd, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        pages = torch.full((1, n_pg), -1, dtype=torch.int32, device=dev)
        pages[0, :24] = torch.randperm(P - 1, device=dev, generator=g)[:24].to(torch.int32)
        views = ops.paged_kv_view(kp, vp, pages)
        plain = ops.paged_kv_view_plain(kp, vp, pages)

        def two_calls():
            return ops.paged_pool_view(kp, pages, ops.gather_rows), ops.paged_pool_view(vp, pages, ops.gather_rows)

        require(all(torch.equal(a, b) for a, b in zip(views, plain)), f"paged K/V view differs ({tier})")
        require(all(torch.equal(a, b) for a, b in zip(two_calls(), plain)), f"paged_pool_view differs ({tier})")
        mapped = int((pages >= 0).sum())
        tile = ps * hd * 2
        n_bytes = 2 * (E * mapped * KVH * tile + E * n_pg * KVH * tile) + nbytes(pages)
        b_ms, b_by = bound(n_bytes, 0, F32_FLOPS)
        idx = ops.pool_row_index(pages, E, P).clamp(min=0).long()

        def library():
            return tuple(t.reshape(E * P, KVH, ps, hd).index_select(0, idx).reshape(E, n_pg, KVH, ps, hd)
                         .transpose(1, 2).contiguous() for t in (kp, vp))

        r = dict(
            shape={"pool": list(kp.shape), "pages": list(pages.shape), "mapped": mapped},
            **timings(lambda: ops.paged_kv_view(kp, vp, pages), lambda: ops.paged_kv_view_plain(kp, vp, pages),
                      library),
            bound_ms=b_ms, bound_by=b_by, two_paged_view_calls=path_times(two_calls),
        )
        require(r["device_launches_per_call"] == 1, f"paged K/V view: {r['device_launches_per_call']} device launches a call")
        res[tier] = r
    return res


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
        if kw.get("starts") is not None and kw.get("causal"):  # causal rows before the start see nothing
            for b, s in enumerate(kw["starts"].tolist()):
                require(not got[b, :s].any(), "flash pure-pad rows not zero")
        return err

    st = torch.tensor([0, 37, 150, 200], dtype=torch.int32, device=dev)
    run(*qkv(4, 200, 200, 8, 2, 64), causal=True, starts=st)
    run(*qkv(4, 200, 200, 8, 2, 128), causal=True, window=48, softcap=30.0)
    run(*qkv(4, 200, 200, 8, 2, 128), causal=True, window=48, starts=st)
    run(*qkv(2, 77, 200, 8, 8, 64), causal=False)
    run(*qkv(16, 256, 256, 16, 8, 128), causal=True)  # tier 2 prefill
    run(*qkv(4, 200, 200, 8, 8, 80), causal=True, starts=st)  # hd 80, G 1
    run(*qkv(3, 77, 150, 4, 4, 80), causal=False)
    # long and ragged: Sq, Sk of 1000 and more, not multiples of the tiles, so
    # the two-stage ring wraps many times; starts mid-ring; a single K tile
    st2 = torch.tensor([500, 3], dtype=torch.int32, device=dev)
    run(*qkv(2, 1100, 1100, 8, 2, 128), causal=True)
    run(*qkv(2, 1037, 1100, 8, 2, 128), causal=False, starts=st2)
    run(*qkv(2, 1100, 1100, 8, 2, 64), causal=True, starts=st2, window=300)
    run(*qkv(2, 1000, 1000, 4, 4, 80), causal=True, starts=st2)
    run(*qkv(2, 1000, 1037, 4, 4, 80), causal=False, window=77)
    run(*qkv(3, 50, 20, 8, 2, 128), causal=False)  # one K tile
    run(*qkv(3, 20, 20, 4, 4, 80), causal=True, softcap=5.0)

    def timed(q, k, v):
        B, S, H, hd = q.shape
        pairs = B * H * S * (S + 1) // 2
        b_ms, b_by = bound(nbytes(q, k, v, q), 4 * hd * pairs, BF16_FLOPS)  # q, k, v read; out written
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        return dict(
            **timings(lambda: ops.flash_attention(q, k, v, causal=True),
                      lambda: ops.flash_attention_plain(q, k, v, causal=True),
                      lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
                      plain_iters=5),
            bound_ms=b_ms, bound_by=b_by,
        )

    q80 = qkv(96, 256, 256, 32, 32, 80)  # zamba2 tier 1 prefill: E*B = 3*32 rows, hd 80, G 1
    err80 = run(*q80, causal=True)
    q, k, v = qkv(96, 256, 256, 16, 2, 128)  # qwen2.5-3b tier 1 prefill: E*B = 3*32 rows
    err = run(q, k, v, causal=True)
    return dict(
        name="flash_attention", tol=f"abs {FLASH_TOL}", shape={"q": list(q.shape), "kv": list(k.shape)},
        max_abs_err=max(err, err80), hd128_err=err, **timed(q, k, v),
        hd80=dict(shape={"q": list(q80[0].shape), "kv": list(q80[1].shape)}, max_abs_err=err80, **timed(*q80)),
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
        if kw.get("starts") is not None:  # rows with nothing visible are exact zeros
            pad = kw["starts"] >= torch.as_tensor(cur, device=dev).expand(q.shape[0])
            require(not got[pad].any(), "decode pure-pad rows not zero")
        return err

    q, kc, vc = inputs(4, 16, 2, 300, 128)
    cur = torch.tensor([1, 64, 300, 177], dtype=torch.int32, device=dev)
    run(q, kc, vc, cur)
    run(q, kc, vc, cur, starts=torch.tensor([0, 64, 10, 100], dtype=torch.int32, device=dev))  # row 1: pure pad
    run(q, kc, vc, 250, window=32, softcap=20.0)
    run(*inputs(3, 8, 8, 100, 64), 100, starts=torch.tensor([5, 0, 99], dtype=torch.int32, device=dev))
    run(*inputs(8, 16, 8, 144, 128), 143)  # tier 2 generate decode
    run(*inputs(3, 4, 4, 100, 80), 100, window=30, starts=torch.tensor([5, 0, 99], dtype=torch.int32, device=dev))
    # zamba2 serve_continuous decode: 3*8 slots of max_seq 512, per-slot cur_len
    run(*inputs(24, 32, 32, 512, 80), torch.randint(1, 513, (24,), device=dev, generator=g, dtype=torch.int32))
    # long caches, split across a cluster: window and starts edges inside and
    # across split boundaries, splits with nothing visible, cur_len 1, pure pad
    T = lambda *xs: torch.tensor(xs, dtype=torch.int32, device=dev)
    for S in (512, 2048, 4096):
        run(*inputs(3, 16, 2, S, 128), T(1, S // 2 + 7, S), starts=T(0, 100, S - 3))
        run(*inputs(3, 16, 2, S, 128), T(S, S - 1, 65), window=S // 3)
        run(*inputs(3, 16, 2, S, 128), T(S, 129, 1), starts=T(S - 1, 128, 1))  # row 2: pure pad
        run(*inputs(3, 4, 2, S, 64), T(513, S, 1), starts=T(0, 513, 0), softcap=20.0)
        run(*inputs(2, 4, 4, S, 80), T(S, 300), window=200)

    def timed(q, kc, vc, cur):
        B, _, H, hd = q.shape
        KVH = kc.shape[1]
        n_bytes = 2 * nbytes(q) + 2 * B * KVH * cur * hd * 2
        b_ms, b_by = bound(n_bytes, 4 * B * H * cur * hd, BF16_FLOPS)
        qt, ks, vs = q.transpose(1, 2), kc[:, :, :cur], vc[:, :, :cur]
        return dict(
            **timings(lambda: ops.decode_attention_bksd(q, kc, vc, cur),
                      lambda: ops.decode_attention_plain(q, kc, vc, cur),
                      lambda: F.scaled_dot_product_attention(qt, ks, vs, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by,
        )

    cur = 143  # the last generate step
    q80 = inputs(24, 32, 32, 144, 80)  # zamba2 tier 1: E*B = 3*8 rows, hd 80, G 1
    err80 = run(*q80, cur)
    q, kc, vc = inputs(24, 16, 2, 144, 128)  # qwen2.5-3b tier 1: E*B = 3*8 rows
    err = run(q, kc, vc, cur)
    return dict(
        name="decode_attention", tol=f"abs {DECODE_TOL}", shape={"q": list(q.shape), "cache": list(kc.shape), "cur_len": cur},
        max_abs_err=max(err, err80), hd128_err=err, **timed(q, kc, vc, cur),
        hd80=dict(shape={"q": list(q80[0].shape), "cache": list(q80[1].shape), "cur_len": cur}, max_abs_err=err80,
                  **timed(*q80, cur)),
    )


def check_decode_paged(dev, g):
    import torch.nn.functional as F

    from repro_torch.kernels.compaction.ops import gather_rows_plain, pool_row_index
    from repro_torch.kernels.decode_attention import ops

    mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)

    def table(cur, n_pg, ps, P, holes=()):
        """A shuffled, non-monotone table: slot b maps ceil(cur[b] / ps)
        distinct random pages, -1 past its length and at ``holes``."""
        perm = torch.randperm(P - 1, device=dev, generator=g)
        pages = torch.full((len(cur), n_pg), -1, dtype=torch.int32, device=dev)
        used = 0
        for b, c in enumerate(cur):
            n = -(-c // ps)
            pages[b, :n] = perm[used:used + n].to(torch.int32)
            used += n
        for b, i in holes:
            pages[b, i] = -1
        return pages

    def run(E, B, H, KVH, hd, P, ps, n_pg, cur, holes=(), **kw):
        q = mk(E * B, 1, H, hd)
        kp, vp = mk(E, P, KVH, ps, hd), mk(E, P, KVH, ps, hd)
        pages = table(cur, n_pg, ps, P, holes)
        cur_t = torch.tensor(cur, dtype=torch.int32, device=dev)
        got = ops.decode_attention_paged(q, kp, vp, pages, cur_t, **kw)
        ref = ops.decode_attention_paged_plain(q, kp, vp, pages, cur_t, **kw)
        err = (got.float() - ref.float()).abs().max().item()
        require(math.isfinite(err) and err <= DECODE_TOL, f"paged decode err {err} > {DECODE_TOL} ({kw})")
        # the same tiles in the same order: bitwise the dense kernel on the gathered view
        kv, vv = (ops.paged_pool_view(t, pages, gather_rows_plain) for t in (kp, vp))
        dense = ops.decode_attention_bksd(q, kv, vv, cur_t.repeat(E), **kw)
        require(torch.equal(got, dense), f"paged decode is not bitwise the dense kernel on the gathered view ({kw})")
        return q, kp, vp, pages, cur_t, err

    run(1, 4, 16, 2, 128, 40, 16, 8, [1, 37, 128, 70])  # cur_len off the page grid
    run(2, 3, 16, 2, 128, 40, 16, 8, [100, 5, 128], holes=[(0, 2), (2, 7)])  # unmapped pages inside cur_len
    run(3, 3, 8, 8, 128, 20, 64, 4, [200, 64, 1])  # page_size 64
    run(1, 4, 16, 2, 128, 40, 16, 8, [120, 33, 128, 9], window=40, softcap=20.0)
    run(2, 3, 4, 4, 64, 30, 16, 8, [17, 128, 60])  # hd 64, G = 1
    run(2, 3, 16, 2, 128, 3 * 256 + 1, 16, 256, [4096, 1000, 2049])  # S 4096: an 8-split cluster
    run(1, 3, 16, 8, 128, 3 * 256 + 1, 16, 256, [1, 4095, 2048], window=1000)
    # the main path's shapes, 8 slots of max_seq 512 in 16-row pages: tier 2
    # (internlm2-1.8b, E = 1, G = 2), then tier 1 (3 x qwen2.5-3b, G = 8), timed
    E, B, n_pg, ps = 3, 8, 32, 16
    cur2 = torch.randint(1, 513, (B,), generator=torch.Generator().manual_seed(1)).tolist()
    err2 = run(1, B, 16, 8, 128, B * n_pg + 1, ps, n_pg, cur2)[-1]
    cur = torch.randint(1, 513, (B,), generator=torch.Generator().manual_seed(0)).tolist()
    q, kp, vp, pages, cur_t, err = run(E, B, 16, 2, 128, B * n_pg + 1, ps, n_pg, cur)
    H, hd, KVH = q.shape[2], q.shape[3], kp.shape[2]
    visible = E * sum(cur)  # K/V rows the kernel must read
    n_bytes = 2 * nbytes(q) + 2 * visible * KVH * hd * 2 + nbytes(pages, cur_t)
    b_ms, b_by = bound(n_bytes, 4 * H * hd * visible, BF16_FLOPS)
    idx = pool_row_index(pages, E, kp.shape[1]).clamp(min=0).long()
    S = n_pg * ps
    valid = (torch.arange(S, device=dev)[None, :] < cur_t.repeat(E)[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)

    def library():
        kv, vv = (
            t.reshape(-1, KVH, ps, hd).index_select(0, idx).reshape(E * B, n_pg, KVH, ps, hd)
            .transpose(1, 2).reshape(E * B, KVH, S, hd) for t in (kp, vp)
        )
        return F.scaled_dot_product_attention(qt, kv, vv, attn_mask=valid, enable_gqa=True)

    return dict(
        name="decode_attention_paged", tol=f"abs {DECODE_TOL}, bitwise the dense kernel on the gathered view",
        shape={"q": list(q.shape), "pool": list(kp.shape), "pages": list(pages.shape), "cur_len": cur,
               "tier2_cur_len": cur2},
        max_abs_err=max(err, err2), tier1_err=err, tier2_err=err2,
        **timings(lambda: ops.decode_attention_paged(q, kp, vp, pages, cur_t),
                  lambda: ops.decode_attention_paged_plain(q, kp, vp, pages, cur_t), library),
        bound_ms=b_ms, bound_by=b_by,
    )


# The scans: the WKV6 kernel and the SSD's f32 route run the per-step
# recurrence, the SSD's bf16 route the chunked dual form on TF32 tensor
# cores (bf16 x, B, C exact; the decayed tiles round once, 2**-11), the plain
# versions the chunked form in f32 (the JAX package's XLA route).  Outputs
# normwise: 1e-5 in f32; 2**-7 in bf16, where the two results each round to
# bf16 and may land one bf16 step apart (at most 2**-7 of the element, so of
# the largest value).  Final states normwise 1e-3.
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
STATE_TOL = 1e-3
# Under strong decay (log-decay down to -exp(9)) the chunked plain version's
# exponents lose up to ~|cum| * 6e-8 ~ 6e-3: there the kernel is held to the
# plain version at this bound and to the per-step ref at SCAN_TOL.
STRONG_DECAY_TOL = 2e-2
SCAN_TOL_TEXT = ("output normwise 1e-5 (f32) / 2**-7 (bf16), state normwise 1e-3; strong decay: "
                 "2e-2 against the plain version and the above against the per-step ref")


def normwise_err(got, ref):
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def check_scan(name, got, ref, tol=None):
    """got and ref (y, final state): normwise errors, held to the stated
    tolerances (``tol`` overrides both).  Returns (y normwise err, state
    normwise err, y max abs err)."""
    (y, s), (py, ps) = got, ref
    ey, es = normwise_err(y, py), normwise_err(s, ps)
    ty, ts = (tol, tol) if tol else (SCAN_TOL[y.dtype], STATE_TOL)
    require(math.isfinite(ey) and ey <= ty, f"{name}: output normwise err {ey} > {ty}")
    require(math.isfinite(es) and es <= ts, f"{name}: state normwise err {es} > {ts}")
    return ey, es, (y.float() - py.float()).abs().max().item()


def ssd_dual_flops(B, S, H, N, P, L=64):
    """Operations of the chunked dual form the bf16 SSD kernel runs, for
    chunks of L steps at this run's length: per chunk of m steps and head the
    causal C·Bᵀ and M·x (m(m+1)/2 · (N + P) multiply-adds), C·h and the state
    update (2·m·N·P)."""
    macs = 0
    for t0 in range(0, S, L):
        m = min(L, S - t0)
        macs += m * (m + 1) // 2 * (N + P) + 2 * m * N * P
    return 2 * B * H * macs


def check_ssd(dev, g):
    import torch.nn.functional as F

    from repro_torch.kernels.mamba2_ssd import ops

    def inputs(B, S, H, P, G, N, E, dtype, h0, dt_shift=0.0, xbc=False):
        if xbc:  # views of one (B, S, H P + 2 G N) tensor, as the Mamba2 block hands them over
            t = torch.randn(B, S, H * P + 2 * G * N, device=dev, generator=g).to(dtype)
            x, Bm, Cm = (t[..., :H * P].reshape(B, S, H, P), t[..., H * P:H * P + G * N].reshape(B, S, G, N),
                         t[..., H * P + G * N:].reshape(B, S, G, N))
        else:
            x = torch.randn(B, S, H, P, device=dev, generator=g).to(dtype)
            Bm, Cm = (torch.randn(B, S, G, N, device=dev, generator=g).mul(0.5).to(dtype) for _ in range(2))
        dt = F.softplus(torch.randn(B, S, H, device=dev, generator=g) + dt_shift)
        A = -torch.exp(torch.randn(E, H, device=dev, generator=g) * 0.3)
        s0 = torch.randn(B, H, N, P, device=dev, generator=g).mul(0.2) if h0 else None
        return (x, dt, A, Bm, Cm), s0

    def run(args, s0):
        got = ops.ssd(*args, initial_state=s0, return_final_state=True)
        return check_scan("ssd", got, ops.ssd_plain(*args, initial_state=s0))

    errs = [
        run(*inputs(2, 300, 8, 64, 1, 64, 2, torch.bfloat16, True)),  # ragged S, P/N 64/64, per-member A
        run(*inputs(3, 130, 8, 32, 2, 16, 3, torch.float32, True)),  # G > 1, P/N 32/16
        run(*inputs(4, 77, 4, 32, 4, 16, 1, torch.bfloat16, False)),
        run(*inputs(6, 1, 8, 64, 1, 64, 3, torch.bfloat16, True)),  # a single step
        run(*inputs(2, 65, 8, 64, 2, 64, 2, torch.float32, True, xbc=True)),  # the f32 route on views
    ]
    # the main path: zamba2-2.7b tier-1 classify, E*B = 3*32 rows, S 256, 80
    # heads of P 64, G 1, N 64; bf16 x, B and C as views of xBC, as the block
    # gives them, dt near softplus(dt_bias) as initialised
    args, _ = inputs(96, 256, 80, 64, 1, 64, 3, torch.bfloat16, False, dt_shift=-4.0, xbc=True)
    errs.append(run(args, None))
    # and serve_continuous's chunked admission: one slot of each of the 3
    # members continuing the slot's state, a full 256-token chunk (max_chunk)
    # and a short one (most of a tier's chunk calls are short)
    adm, adm_s0 = inputs(3, 256, 80, 64, 1, 64, 3, torch.bfloat16, True, dt_shift=-4.0, xbc=True)
    adm16, adm16_s0 = inputs(3, 16, 80, 64, 1, 64, 3, torch.bfloat16, True, dt_shift=-4.0, xbc=True)
    errs += [run(adm, adm_s0), run(adm16, adm16_s0)]

    def timed(args, s0):
        x, dt, A, Bm, Cm = args
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        y, hT = ops.ssd(*args, initial_state=s0, return_final_state=True)
        # bytes the kernel reads and writes: x, B, C in their own dtype, dt f32 (the prescale is fused)
        n_bytes = nbytes(*args, y, hT, *(() if s0 is None else (s0,)))
        if x.dtype == torch.bfloat16:  # the dual form on TF32 tensor cores
            b_ms, b_by = bound(n_bytes, ssd_dual_flops(B, S, H, N, P), TF32_FLOPS)
        else:  # the per-step form on the f32 cores
            b_ms, b_by = bound(n_bytes, 5 * B * S * H * N * P, F32_FLOPS)
        out = dict(
            shape={"x": list(x.shape), "B": list(Bm.shape), "E": A.shape[0], "initial_state": s0 is not None},
            **timings(lambda: ops.ssd(*args, initial_state=s0, return_final_state=True),
                      lambda: ops.ssd_plain(*args, initial_state=s0), None,  # no single PyTorch call computes the scan
                      plain_iters=5),
            bound_ms=b_ms, bound_by=b_by,
            # the per-step form's f32 operations alone, the yardstick of a per-step kernel
            f32_step_bound_ms=5 * B * S * H * N * P / F32_FLOPS * 1e3,
        )
        launches = out["device_launches_per_call"]
        require(launches is not None and launches <= 2, f"ssd: {launches} device launches a call (at most 2)")
        return out

    return dict(
        name="mamba2_ssd", tol=SCAN_TOL_TEXT,
        max_abs_err=max(e[2] for e in errs), normwise_err=max(e[0] for e in errs),
        state_normwise_err=max(e[1] for e in errs), **timed(args, None), admission=timed(adm, adm_s0),
        admission_s16=timed(adm16, adm16_s0),
    )


def check_wkv6(dev, g):
    from repro_torch.kernels.rwkv6_wkv import ops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

    def inputs(B, S, H, D, E, dtype, h0, scale=0.5, shift=0.0):
        r, k, v = (torch.randn(B, S, H, D, device=dev, generator=g).to(dtype) for _ in range(3))
        logw = -torch.exp(torch.randn(B, S, H, D, device=dev, generator=g) * scale + shift)
        u = torch.randn(E, H, D, device=dev, generator=g).mul(0.5)
        s0 = torch.randn(B, H, D, D, device=dev, generator=g).mul(0.1) if h0 else None
        return (r, k, v, logw, u), s0

    def run(args, s0, strong=False):
        got = ops.wkv6(*args, initial_state=s0, return_final_state=True)
        if strong:
            check_scan("wkv6 (per-step ref)", got, wkv6_ref(*args, initial_state=s0, return_final_state=True))
        return check_scan("wkv6", got, ops.wkv6_plain(*args, initial_state=s0), STRONG_DECAY_TOL if strong else None)

    errs = [
        run(*inputs(8, 1, 64, 64, 1, torch.bfloat16, True)),  # S = 1 with a state
        run(*inputs(3, 77, 8, 32, 3, torch.float32, True)),  # ragged S, per-member u, D 32
        run(*inputs(4, 70, 4, 64, 2, torch.bfloat16, True, scale=3.0), strong=True),  # strongly negative logw
        run(*inputs(2, 45, 4, 32, 1, torch.float32, False, scale=2.0), strong=True),
        # 320 (row, head) pairs take the kernel's larger tile (the cases above its smaller one)
        run(*inputs(5, 70, 64, 64, 5, torch.bfloat16, True, scale=3.0), strong=True),
        run(*inputs(5, 77, 64, 32, 1, torch.float32, True)),
    ]

    def timed(args, s0):
        r, k, v, logw, u = args
        B, S, H, D = r.shape
        y, sT = ops.wkv6(*args, initial_state=s0, return_final_state=True)
        ins = (r, k, v, logw, u) + (() if s0 is None else (s0,))
        # the per-step form on the f32 cores: k v, S w + k v, r S (5 operations a state element a step)
        b_ms, b_by = bound(nbytes(*ins, y, sT), 5 * B * S * H * D * D, F32_FLOPS)
        return dict(
            shape={"r": list(r.shape), "initial_state": s0 is not None},
            **timings(lambda: ops.wkv6(*args, initial_state=s0, return_final_state=True),
                      lambda: ops.wkv6_plain(*args, initial_state=s0), None,  # no single PyTorch call computes the scan
                      plain_iters=5),
            bound_ms=b_ms, bound_by=b_by,
        )

    # the main path: rwkv6-7b tier-2 prefill (16 deferred rows of 256
    # tokens, 64 heads of 64), its decode step (8 rows, S = 1, a state) and
    # serve_continuous's chunked admission (one slot continuing its state, a
    # full 256-token chunk and a short one); log-decay near
    # -exp(decay_base) as initialised
    pre, _ = inputs(16, 256, 64, 64, 1, torch.bfloat16, False, shift=-4.0)
    dec, dec_s0 = inputs(8, 1, 64, 64, 1, torch.bfloat16, True, shift=-4.0)
    adm, adm_s0 = inputs(1, 256, 64, 64, 1, torch.bfloat16, True, shift=-4.0)
    adm16, adm16_s0 = inputs(1, 16, 64, 64, 1, torch.bfloat16, True, shift=-4.0)
    errs += [run(pre, None), run(dec, dec_s0), run(adm, adm_s0), run(adm16, adm16_s0)]
    return dict(
        name="rwkv6_wkv", tol=SCAN_TOL_TEXT,
        max_abs_err=max(e[2] for e in errs), normwise_err=max(e[0] for e in errs),
        state_normwise_err=max(e[1] for e in errs), **timed(pre, None), decode=timed(dec, dec_s0),
        admission=timed(adm, adm_s0), admission_s16=timed(adm16, adm16_s0),
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
            errs[f"{arch}/{name}"] = normwise(a, b, f"{arch} {name} card vs cpu")
        errs.update(check_reference_paged(arch, cfg, k, vals, gvals, seed))
    return errs


# Card against CPU end to end, for the recurrent families: a bf16 drift of
# ~3e-3 a recurrent layer grows about tenfold through a dense block of these
# random-weight models (qwen2.5-3b's second layer does the same to its
# input's drift), so end-to-end outputs are held at this looser bound and
# every layer, fed the CPU's own input and state, at REF_TOL.
E2E_TOL = 0.15
# The same end-to-end run with bf16 rounding removed: float32 weights and
# activations (TF32 off), where card and CPU differ only in summation order
# (~1e-6 a layer).  It separates rounding from a fault.  The hybrid's shared
# attention cannot run so (the flash and decode kernels take bf16 only, as
# the TPU kernels do), so zamba2 runs its Mamba2 backbone alone.
F32_TOL = 1e-4


def layer_by_layer(cfg, vals, gvals, dev, x, cache=None, *, step=False, slot=None, start=0, pos=None):
    """Walk the recurrent stack on the CPU from hidden x (E, B, S, D); feed
    each layer's CPU input and state (and the hybrid's KV leaves) to the same
    layer on the card and hold its output, new state and written KV against
    the CPU's.  ``cache`` None is a prefill; otherwise a member cache (CPU,
    updated in place) continued by a decode step (``step``, ``pos``) or by a
    chunk into ``slot`` at ``start``.  Returns (worst normwise error, final
    CPU hidden)."""
    from repro_torch.models import api
    from repro_torch.models import blocks_dense as BD

    row = slice(None) if slot is None else slice(slot, slot + 1)
    worst = 0.0

    def hold(got, ref, what):
        nonlocal worst
        worst = max(worst, normwise(ref, got, f"{cfg.name} {what} card vs cpu, same input"))

    for l in range(cfg.n_layers):
        st = None if cache is None else {n: cache[n][l][:, row] for n in api._state_keys(cfg)}
        gst = None if st is None else {n: t.to(dev) for n, t in st.items()}
        y, new = api._recurrent_layer(vals, l, x, cfg, st, step=step)
        gy, gnew = api._recurrent_layer(gvals, l, x.to(dev), cfg, gst, step=step)
        hold(gy, y, f"layer {l}")
        for n, t in new.items():
            hold(gnew[n], t, f"layer {l} {n}")
            if cache is not None:
                cache[n][l][:, row] = t
        x = y
        if not api._attn_after(cfg, l):
            continue
        shared, gshared = vals["shared_attn"], gvals["shared_attn"]
        if cache is None:
            y = BD.dense_layer_fwd(shared, x, cfg, causal=True, sliding_window=cfg.sliding_window)[0]
            gy = BD.dense_layer_fwd(gshared, x.to(dev), cfg, causal=True, sliding_window=cfg.sliding_window)[0]
        else:
            inv = l // cfg.attn_every
            kc, vc = cache["attn_k"][inv], cache["attn_v"][inv]
            gk, gv = kc.to(dev), vc.to(dev)  # copies, before the CPU writes its rows
            if step:
                y = BD.dense_layer_decode(shared, x, cfg, kc, vc, api._positions(pos, x.shape[1], "cpu"))
                gy = BD.dense_layer_decode(gshared, x.to(dev), cfg, gk, gv, api._positions(pos, x.shape[1], dev))
            else:
                at = lambda d: (api.slot_index(slot, d), api.slot_index(start, d))  # noqa: E731
                y = BD.dense_layer_prefill_chunk(shared, x, cfg, kc, vc, *at(x.device))
                gy = BD.dense_layer_prefill_chunk(gshared, x.to(dev), cfg, gk, gv, *at(gk.device))
            hold(gk, kc, f"attention {inv} k")
            hold(gv, vc, f"attention {inv} v")
        hold(gy, y, f"attention after layer {l}")
        x = y
    return worst, x


def check_reference_recurrent(dev, seed):
    """rwkv6-7b (k=1) and zamba2-2.7b (k=3) reduced, card against CPU on
    the same bf16 weights: prefill logits, a decode step, and a 33-token
    chunk into slot 1 of a 3-slot cache followed by a decode step at
    per-slot positions (logits and every state leaf) — end to end at
    E2E_TOL, and layer by layer on the CPU's own inputs at REF_TOL; then
    end to end in float32 at F32_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.models import api
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import grow_cache

    errs = {}
    for arch, k in (("zamba2-2.7b", 3), ("rwkv6-7b", 1)):
        cfg = get_config(arch).reduced()
        vals, gvals, e2e = recurrent_end_to_end(cfg, k, dev, seed, E2E_TOL)
        errs.update({f"{arch}/{name}": e for name, e in e2e.items()})
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
        step_tok = np.full((k, 4, 1), 7, np.int32)
        chunk = rng.integers(0, cfg.vocab_size, 33).astype(np.int32)
        tok = rng.integers(0, cfg.vocab_size, (k, 3, 1)).astype(np.int32)
        slot_pos = np.array([0, 33, 0], np.int32)
        # layer by layer, each stage from the CPU's own inputs and states
        head = lambda x: (L.project_logits(vals, x, cfg), L.project_logits(gvals, x.to(dev), cfg))
        embed = lambda t: api.embed_inputs(vals, torch.as_tensor(t).to(torch.int64))
        worst, x = layer_by_layer(cfg, vals, gvals, dev, embed(toks))
        worst = max(worst, normwise(*head(x[:, :, -1]), f"{arch} prefill head card vs cpu"))
        _, cache = ens.ensemble_prefill(vals, {"tokens": toks}, cfg)
        w, x = layer_by_layer(cfg, vals, gvals, dev, embed(step_tok), grow_cache(cache, 2, cfg), step=True, pos=40)
        worst = max(worst, w, normwise(*head(x[:, :, 0]), f"{arch} decode head card vs cpu"))
        slots = api.init_cache_members(cfg, k, 3, 64, "cpu")
        w, _ = layer_by_layer(cfg, vals, gvals, dev, embed(chunk[None]), slots, slot=1, start=0)
        worst = max(worst, w)
        w, x = layer_by_layer(cfg, vals, gvals, dev, embed(tok), slots, step=True, pos=slot_pos)
        worst = max(worst, w, normwise(*head(x[:, :, 0]), f"{arch} slot decode head card vs cpu"))
        errs[f"{arch}/layer_by_layer_worst"] = worst
    require(not torch.backends.cuda.matmul.allow_tf32, "float32 card-vs-cpu needs TF32 off")
    for arch, k, family in (("zamba2-2.7b", 3, "ssm_mamba2"), ("rwkv6-7b", 1, "ssm_rwkv6")):
        cfg = dataclasses.replace(get_config(arch).reduced(), family=family, dtype="float32")
        e2e = recurrent_end_to_end(cfg, k, dev, seed, F32_TOL)[2]
        errs.update({f"{arch}/f32_{family}_{name}": e for name, e in e2e.items()})
    return errs


def recurrent_end_to_end(cfg, k, dev, seed, tol):
    """Prefill logits, a decode step, and a 33-token chunk into slot 1 of a
    3-slot cache followed by a decode step at per-slot positions (logits
    and every state leaf), on the card and on the CPU from the same seeded
    weights, held normwise at ``tol``.  Returns (cpu weights, card weights,
    errors)."""
    from repro_torch.core import ensemble as ens
    from repro_torch.models import api
    from repro_torch.models.params import tree_map
    from repro_torch.serve.engine import grow_cache

    vals = ens.init_ensemble(cfg, k, torch.Generator().manual_seed(seed), "cpu")
    gvals = tree_map(lambda t: t.to(dev), vals)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
    step_tok = np.full((k, 4, 1), 7, np.int32)
    chunk = rng.integers(0, cfg.vocab_size, 33).astype(np.int32)
    tok = rng.integers(0, cfg.vocab_size, (k, 3, 1)).astype(np.int32)
    slot_pos = np.array([0, 33, 0], np.int32)
    outs = []
    for v in (vals, gvals):
        logits, cache = ens.ensemble_prefill(v, {"tokens": toks}, cfg)
        cache = grow_cache(cache, 2, cfg)
        step, _ = ens.ensemble_decode_step(v, step_tok, cache, 40, cfg)
        slots = api.init_cache_members(cfg, k, 3, 64, v["embed"].device)
        slots = ens.ensemble_prefill_into_slot(v, chunk, slots, 1, 0, cfg)
        slot_step, slots = ens.ensemble_decode_step(v, tok, slots, slot_pos, cfg)
        outs.append(dict(prefill=logits, decode=step, slot_decode=slot_step,
                         **{f"slot_{n}": t for n, t in slots.items() if not isinstance(t, list)}))
    errs = {name: normwise(outs[0][name], outs[1][name], f"{cfg.name} {name} card vs cpu", tol) for name in outs[0]}
    return vals, gvals, errs


def normwise(a, b, what, tol=REF_TOL):
    a, b = a.float().cpu(), b.float().cpu()
    err = ((a - b).abs().max() / a.abs().max()).item()
    require(math.isfinite(err) and err <= tol, f"{what} normwise err {err} > {tol}")
    return err


def check_reference_paged(arch, cfg, k, vals, gvals, seed):
    """Paged chunked prefill into one slot, then one paged decode step over
    every slot, on the card and on the CPU from the same random pools."""
    from repro_torch.core import ensemble as ens

    rng = np.random.default_rng(seed + 1)
    n_slots, ps, n_pg = 3, 16, 4  # max_seq 64
    pages = np.full((n_slots, n_pg), -1, np.int32)
    pages[0, :3], pages[1, :2], pages[2, :4] = [4, 0, 9], [7, 2], [1, 11, 5, 3]
    chunk = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    tok = rng.integers(0, cfg.vocab_size, (k, n_slots, 1)).astype(np.int32)
    pos = np.array([33, 20, 50], np.int32)
    pool0 = ens.init_ensemble_paged_pool(vals, cfg, n_slots * n_pg + 1, ps)
    gen = torch.Generator().manual_seed(seed)
    pool0 = {name: torch.randn(t.shape, generator=gen).to(t.dtype) for name, t in pool0.items()}
    outs = []
    for v in (vals, gvals):
        pool = {name: t.to(v["embed"].device) for name, t in pool0.items()}
        pool = ens.ensemble_prefill_into_slot_paged(v, chunk, pool, pages[0], 1, cfg)
        logits, pool = ens.ensemble_decode_step_paged(v, tok, pool, pos, pages, cfg)
        outs.append((logits, pool["k"], pool["v"]))
    return {
        f"{arch}/paged_{name}": normwise(a, b, f"{arch} paged {name} card vs cpu")
        for name, a, b in zip(("decode_logits", "pool_k", "pool_v"), outs[0], outs[1])
    }


def serve_requests(rng, n, vocab, lo, hi, max_new, *, n_prefix=0, prefix_len=0):
    """Seeded requests: prompt lengths drawn from [lo, hi]; the first
    ``n_prefix`` share one ``prefix_len``-token prefix."""
    from repro_torch.serve import Request

    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    reqs = []
    for i in range(n):
        toks = rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).astype(np.int32)
        if i < n_prefix:
            toks = np.concatenate([prefix, toks[: max(1, len(toks) - prefix_len)]])
        reqs.append(Request(tokens=toks, max_new_tokens=max_new))
    return reqs


def check_batch_programs_on_card(dev, seed):
    """The batch programs at reduced width on the card: a decode step at a
    (B,) position vector (the captured route) bitwise the step at the int
    position, for qwen2.5-3b x3 with left-pad starts and zamba2-2.7b x3;
    the sampler's integer draws bitwise the CPU's at qwen2.5-3b's
    vocabulary; and both cascades' classify and generate (greedy, and
    sampled at T = 0.8), eager and graphed twice: equal pred, tier_of and
    member tokens, the second graphed call capturing nothing."""
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.models import api
    from repro_torch.serve import CascadeServer, CascadeTier, sampling
    from repro_torch.serve.graphs import trace_counts

    out = {}
    for arch in ("qwen2.5-3b", "zamba2-2.7b"):
        cfg = get_config(arch).reduced()
        vals = ens.init_ensemble(cfg, 3, torch.Generator(device=dev).manual_seed(seed), dev)
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
        batch, kw = {"tokens": toks}, {}
        if cfg.family == "dense":
            batch["starts"] = np.array([0, 3, 17, 39], np.int32)
            kw["starts"] = torch.as_tensor(batch["starts"], device=dev)
        cache = api.init_cache_members(cfg, 3, 4, 48, dev)
        ens.ensemble_prefill(vals, batch, cfg, cache=cache)
        tok = torch.full((3, 4, 1), 7, dtype=torch.int32, device=dev)
        steps = []
        for pos in (40, torch.full((4,), 40, dtype=torch.int64, device=dev)):
            c = {n: [t.clone() for t in v] if isinstance(v, list) else v.clone() for n, v in cache.items()}
            logits, _ = api.decode_step_members(vals, tok, c, pos, cfg, **kw)
            steps.append([logits] + [t for v in c.values() for t in (v if isinstance(v, list) else [v])])
        require(all(torch.equal(a, b) for a, b in zip(*steps)),
                f"{arch}: the decode step at a (B,) position differs from the step at the int position")
        out[f"{arch}/vector_position_decode_bitwise"] = True
    V = get_config("qwen2.5-3b").vocab_size
    keys, pos = sampling.batch_keys(seed, 8), np.arange(300, 308)
    card = sampling.draw_bits(torch.as_tensor(keys, device=dev), torch.as_tensor(pos, device=dev), 3, V)
    cpu = sampling.draw_bits(torch.as_tensor(keys), torch.as_tensor(pos), 3, V)
    require(torch.equal(card.cpu(), cpu), "the sampler's integer draws on the card differ from the CPU's")
    out["sampler_draws_bitwise_cpu"] = list(card.shape)
    for a1, a2 in (("qwen2.5-3b", "internlm2-1.8b"), ("zamba2-2.7b", "rwkv6-7b")):
        c1, c2 = get_config(a1).reduced(), get_config(a2).reduced()
        gen = torch.Generator(device=dev).manual_seed(seed)
        v1, v2 = ens.init_ensemble(c1, 3, gen, dev), ens.init_ensemble(c2, 1, gen, dev)
        vocab = min(c1.vocab_size, c2.vocab_size)
        toks = np.random.default_rng(seed).integers(0, vocab, (16, 24)).astype(np.int32)
        for temperature in (0.0, 0.8):
            server = CascadeServer([
                CascadeTier(c1, v1, TierSpec("s", "vote", 0.5, k=3), temperature=temperature, device=dev),
                CascadeTier(c2, v2, TierSpec("b", "confidence", -1.0), temperature=temperature, device=dev),
            ], device=dev)
            for mode, args in (("classify", ()), ("generate", (6, 3))):
                digests = {}
                for run in ("eager", "graphed_1", "graphed_2"):
                    before = trace_counts()
                    with recorded_generations(server) as gens:
                        res = getattr(server, mode)(toks, *args, eager=run == "eager")
                    digests[run] = outputs_digest(res.pred, res.tier_of, *gens)
                    if run == "graphed_2":
                        require(trace_counts() == before, f"{a1} {mode} T={temperature}: a repeat call captured again")
                require(len(set(digests.values())) == 1,
                        f"{a1} -> {a2} {mode} T={temperature}: eager and graphed runs differ: {digests}")
                out[f"{a1} -> {a2}/{mode}@T{temperature:g}"] = digests["eager"]
    return out


def check_engine_on_card(dev, seed):
    """The single-model ``ServingEngine`` at reduced width on the card:
    classify and generate (left-pad starts on the dense model), greedy and
    sampled at T = 0.8, graphed twice against an eager engine of the same
    seed (the generators advance alike): bitwise equal logits and tokens,
    launches per kernel equal, the second graphed call capturing nothing;
    and a sampled ``serve_continuous``, paged and dense, graphed twice ==
    eager twice, the second graphed run capturing nothing."""
    import copy

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve.graphs import trace_counts

    out = {}
    for arch in ("qwen2.5-3b", "zamba2-2.7b"):
        cfg = get_config(arch).reduced()
        params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
        starts = np.array([0, 3, 17, 39], np.int32) if cfg.family == "dense" else None
        for temperature in (0.0, 0.8):
            engs = {e: ServingEngine(cfg, params, temperature=temperature, seed=seed, device=dev) for e in (True, False)}
            digests = []
            for call in range(2):
                runs = {}
                for eager in (True, False):
                    before = trace_counts()
                    kernels.reset_launch_counts()
                    logits = engs[eager].classify(toks, starts, eager=eager)
                    gen = engs[eager].generate(toks, 6, starts=starts, eager=eager)
                    bits = np.ascontiguousarray(logits, np.float32).view(np.int32)
                    runs[eager] = (outputs_digest(bits, gen), kernels.launch_counts())
                    if call == 1 and not eager:
                        require(trace_counts() == before, f"engine {arch} T={temperature}: a repeat call captured again")
                require(runs[True] == runs[False], f"engine {arch} T={temperature} call {call}: graphed != eager "
                                                   f"(digest, launches): {runs}")
                digests.append(runs[True][0])
            out[f"engine {arch}@T{temperature:g}"] = digests
    cfg = get_config("qwen2.5-3b").reduced()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    reqs = serve_requests(np.random.default_rng(seed), 8, cfg.vocab_size, 4, 60, 6)
    for paged in (True, False):
        engs = {e: ServingEngine(cfg, params, temperature=0.8, seed=seed, device=dev) for e in (True, False)}
        digests = []
        for call in range(2):
            runs = {}
            for eager in (True, False):
                before = trace_counts()
                done = engs[eager].serve_continuous([copy.deepcopy(r) for r in reqs],
                                                    ServeConfig(n_slots=3, max_seq=96, page_size=16, paged=paged),
                                                    eager=eager)
                by = {r.rid: r.output for r in done}
                require(sorted(by) == sorted(r.rid for r in reqs), f"engine serve paged={paged}: requests lost")
                runs[eager] = outputs_digest(*(by[r.rid] for r in reqs))
                if call == 1 and not eager:
                    require(trace_counts() == before, f"engine serve paged={paged}: a repeat run captured again")
            require(runs[True] == runs[False], f"engine serve T=0.8 paged={paged} run {call}: graphed != eager")
            digests.append(runs[True])
        out[f"engine serve_continuous@T0.8 paged={paged}"] = digests
    return out


class recorded_generations:
    """Within the block, every tier's ``generate`` output of ``server`` is
    appended to the yielded list (an instance attribute over the method,
    deleted on exit, so no reference cycle outlives the block)."""

    def __init__(self, server):
        self.tiers = server.tiers
        self.gens = []

    def __enter__(self):
        for tier in self.tiers:
            def rec(*a, _gen=tier.generate, **kw):
                out = _gen(*a, **kw)
                self.gens.append(out)
                return out

            tier.generate = rec
        return self.gens

    def __exit__(self, *exc):
        for tier in self.tiers:
            del tier.generate
        return False


def check_serving_on_card(dev, seed):
    """Short ``serve_continuous`` runs on the card at reduced width, each
    with the eager oracle and with the graphed slot programs: the dense
    cascade with block-paged pools and with the dense slot cache, and the
    recurrent cascade (dense slot caches), greedy and sampled at T = 0.8
    (per-slot keys from ``ServeConfig.seed``).  Equal tokens, tiers and
    truncation flags for every request in every run of a temperature."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeServer, CascadeTier, ServeConfig

    out = {}
    for a1, a2, modes in (("qwen2.5-3b", "internlm2-1.8b", (True, False)), ("zamba2-2.7b", "rwkv6-7b", (None,))):
        c1, c2 = get_config(a1).reduced(), get_config(a2).reduced()
        gen = torch.Generator(device=dev).manual_seed(seed)
        v1, v2 = ens.init_ensemble(c1, 3, gen, dev), ens.init_ensemble(c2, 1, gen, dev)
        vocab = min(c1.vocab_size, c2.vocab_size)
        reqs = serve_requests(np.random.default_rng(seed), 12, vocab, 4, 60, 6, n_prefix=4, prefix_len=20)
        for temperature in (0.0, 0.8):
            server = CascadeServer([
                CascadeTier(c1, v1, TierSpec("s", "vote", 0.5, k=3), temperature=temperature, device=dev),
                CascadeTier(c2, v2, TierSpec("b", "confidence", -1.0), temperature=temperature, device=dev),
            ], device=dev)
            runs = {}
            for paged in modes:
                for eager in (True, False):
                    run = [copy.deepcopy(r) for r in reqs]
                    done = server.serve_continuous(
                        run, ServeConfig(n_slots=4, max_seq=128, page_size=16, paged=paged, seed=seed), eager=eager)
                    require(sorted(r.rid for r in done) == sorted(r.rid for r in reqs),
                            f"{a1}: paged={paged} eager={eager}: requests lost or doubled")
                    runs[paged, eager] = {r.rid: (r.tier, r.truncated, r.output.tolist()) for r in done}
            first = runs[modes[0], True]
            for key, got in runs.items():
                require(got == first, f"serve_continuous {a1} -> {a2} T={temperature}: (paged, eager) {key} emits "
                                      f"other tokens than {(modes[0], True)}")
            tiers = [t for t, _, _ in first.values()]
            out[f"{a1} x3 -> {a2} @T{temperature:g}"] = {
                "requests": len(reqs), "tier_counts": [tiers.count(0), tiers.count(1)],
                "runs_equal": [f"paged={p} eager={e}" for p, e in runs],
                "outputs_digest": outputs_digest(*(np.asarray(first[r.rid][2]) for r in reqs)),
            }
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at published widths
# ---------------------------------------------------------------------------

SERVE_CONFIG = dict(n_slots=8, max_seq=512, page_size=16, chunked_prefill=True, max_chunk=256)
# the two cascades of phase 4, and the kernels each mode must launch
CASCADES = {
    "qwen2.5-3b x3 -> internlm2-1.8b": dict(
        tier1="qwen2.5-3b", tier2="internlm2-1.8b",
        need=dict(
            classify=("agreement", "compaction", "flash_attention"),
            generate=("compaction", "flash_attention", "decode_attention"),
            # the row gather under paged_view, the paged decode
            serve_continuous=("compaction", "decode_attention_paged"),
        ),
    ),
    "zamba2-2.7b x3 -> rwkv6-7b": dict(
        tier1="zamba2-2.7b", tier2="rwkv6-7b",
        need=dict(
            classify=("agreement", "compaction", "flash_attention", "mamba2_ssd", "rwkv6_wkv"),
            generate=("compaction", "flash_attention", "decode_attention", "mamba2_ssd", "rwkv6_wkv"),
            # dense slot caches: chunked admission through the scans, hybrid
            # decode with per-slot positions
            serve_continuous=("decode_attention", "mamba2_ssd", "rwkv6_wkv"),
        ),
    ),
}


# the cascade whose serve_continuous also runs sampled (T = 0.8), graphed
SAMPLED_CASCADE = "qwen2.5-3b x3 -> internlm2-1.8b"


def main_path(dev, seed, name):
    """One cascade of ``CASCADES`` at published widths and full depth: the
    three modes, each run eager, then graphed twice, each run with the
    launch counters zeroed just before and read just after; one replay of
    each tier's graphed generate prefill and decode step, serve decode step
    and chunk call, profiled; for ``SAMPLED_CASCADE`` a sampled graphed
    serve_continuous.  Returns (results, launches per mode: the second
    graphed run's)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.kernels.agreement import ops as agree_ops
    from repro_torch.models import api
    from repro_torch.models.params import param_count
    from repro_torch.serve import CascadeServer, CascadeTier
    from repro_torch.serve.graphs import trace_counts

    spec = CASCADES[name]
    a1, a2 = spec["tier1"], spec["tier2"]
    c1, c2 = get_config(a1), get_config(a2)
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    v1 = ens.init_ensemble(c1, 3, g, dev)
    v2 = ens.init_ensemble(c2, 1, g, dev)
    torch.cuda.synchronize()
    log(f"[{name}] weights: tier1 {param_count(v1) / 1e9:.3f}B params, tier2 {param_count(v2) / 1e9:.3f}B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    vocab = min(c1.vocab_size, c2.vocab_size)

    with torch.no_grad():
        cal = rng.integers(0, vocab, (32, 256)).astype(np.int32)
        s = agree_ops.agreement(ens.ensemble_last_logits(v1, {"tokens": cal}, c1))["mean_score"]
        theta = float(s.median())
        log(f"[{name}] calibration: tier-1 mean_score median theta={theta:.6g} (min {s.min().item():.4g}, max {s.max().item():.4g})")
        tier2 = CascadeTier(c2, v2, TierSpec(a2, "confidence", -1.0, k=1, cost=1.0), device=dev)
        servers = {  # generate votes on answer digests: defer unless 2 of 3 members agree
            "classify": CascadeServer([
                CascadeTier(c1, v1, TierSpec(f"{a1}-x3", "score", theta, k=3, cost=3.0), device=dev), tier2,
            ], device=dev),
            "generate": CascadeServer([
                CascadeTier(c1, v1, TierSpec(f"{a1}-x3", "vote", 0.5, k=3, cost=3.0), device=dev), tier2,
            ], device=dev),
        }
        results, launches = {"tier1": a1, "tier2": a2, "theta": theta}, {}
        for mode, B, S, args in (("classify", 32, 256, ()), ("generate", 8, 128, (16,))):
            results[mode], launches[mode] = batch_path(servers[mode], mode, rng, vocab, B, S, args, name,
                                                       spec["need"][mode], max(c1.vocab_size, c2.vocab_size))
        counts = trace_counts()
        results["generate_steps"] = {tier.spec.name: generate_step_profile(tier, 8, 128, 16)
                                     for tier in servers["generate"].tiers}
        require(trace_counts() == counts, f"{name}: the profiled generate programs captured again")
        log(f"[{name}] one graphed generate prefill and decode step: {json.dumps(results['generate_steps'])}")
        results["serve_continuous"], launches["serve_continuous"] = serve_continuous_path(
            servers["generate"], rng, vocab, name, spec["need"]["serve_continuous"],
        )
        counts = trace_counts()
        results["decode_step"] = {tier.spec.name: decode_step_profile(tier) for tier in servers["generate"].tiers}
        require(trace_counts() == counts, f"{name}: the profiled decode steps captured again")
        log(f"[{name}] one graphed decode step: {json.dumps(results['decode_step'])}")
        results["chunk_call"] = {
            tier.spec.name: chunk_call_profile(tier, rng) for tier in servers["generate"].tiers
            if api.supports_paging(tier.cfg)
        }
        log(f"[{name}] one paged chunk call: {json.dumps(results['chunk_call'])}")
        if name == SAMPLED_CASCADE:
            results["serve_continuous_sampled"] = sampled_serve_run(servers["generate"], rng, vocab, name,
                                                                    spec["need"]["serve_continuous"], seed)
        results["generate_buckets"] = bucket_memory_check(servers["generate"].tiers[0], rng, vocab, name)
    return results, launches


def bucket_memory_check(tier, rng, vocab, name):
    """A tier's generate at published width over two more (S, max_new)
    shapes than it keeps batch buckets, all of (8, 144) cache rows, in two
    passes, so every call meets an evicted bucket and captures again: the
    tier never holds more than its ``graphs.max_buckets`` caches; once it holds
    that many, the device memory held after a call stays level, and each
    call of the second pass peaks no higher than the same shape's call in
    the first pass once the tier was full (16 MiB allowed for the
    allocator's rounding of the graphs' small outputs); the second pass
    emits the first pass's tokens."""
    from repro_torch.serve.graphs import trace_counts

    cap = tier.graphs.max_buckets
    shapes = [(120 - 8 * i, 24 + 8 * i) for i in range(cap + 2)]
    toks = rng.integers(0, vocab, (8, 144)).astype(np.int32)
    held, peaks, kept, out = [], [], [], []
    for S, max_new in shapes * 2:
        before = trace_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out.append(tier.generate(toks[:, :S], max_new, seed=0))
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated() / 2**30)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        kept.append(len(tier.batch_caches))
        require(kept[-1] <= cap, f"{name}: {kept[-1]} static caches kept, cap {cap}")
        require(trace_counts() != before, f"{name}: generate at an evicted bucket {(S, max_new)} captured nothing")
    require(cap in kept, f"{name}: the tier never filled its {cap} buckets: {kept}")
    full, n, slack = kept.index(cap), len(shapes), 16 / 1024  # full: the first call after which cap are held
    require(max(held[full:]) <= held[full] + slack, f"{name}: device memory held grows past the bucket cap: {held}")
    require(all(peaks[n + i] <= peaks[i] + slack for i in range(full, n)),
            f"{name}: peak device memory grows past the bucket cap: {peaks}")
    require(all(np.array_equal(out[n + i], out[i]) for i in range(n)),
            f"{name}: a recaptured evicted bucket emits other tokens")
    r = dict(cap=cap, shapes=shapes, caches_kept=kept, held_gib=held, peak_gib=peaks)
    log(f"[{name}] generate over {n} shapes twice, cap {cap}: {json.dumps(r)}")
    return r


def batch_path(server, mode, rng, vocab, B, S, args, name, need, n_classes):
    """``classify`` or ``generate`` at published widths on (B, S) prompts,
    after an eager warm-up at a small shape: once with the eager oracle,
    then twice graphed (the first captures each tier's programs at the
    call's buckets, the second must capture nothing).  The three runs must
    give the same pred, tier_of and member tokens, launch each kernel as
    often, and a graphed run's peak device memory stay within 2 GiB of the
    eager run's.  Returns (results, the second graphed run's launches)."""
    from repro_torch import kernels
    from repro_torch.core.cascade import host_fetch_stats, reset_host_fetch_stats
    from repro_torch.serve.graphs import capture_seconds, trace_counts

    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    getattr(server, mode)(toks[:8, :16], *args, eager=True)  # warm-up at a small shape
    runs = {}
    for run in ("eager", "graphed_1", "graphed_2"):
        cap0, counts0 = capture_seconds(), trace_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_host_fetch_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with recorded_generations(server) as gens:
            res = getattr(server, mode)(toks, *args, eager=run == "eager")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        for kname in need:
            require(counts[kname] > 0, f"{name} {mode} ({run}): kernel {kname} was not launched on the main path")
        require(res.tier_counts.sum() == B and res.pred.shape == (B,), f"{mode}: bad result shapes")
        require(np.isfinite(res.scores).all(), f"{mode}: non-finite scores")
        require(set(np.unique(res.tier_of)) <= {0, 1}, f"{mode}: bad tier_of")
        if mode == "classify":
            require(((res.pred >= 0) & (res.pred < n_classes)).all(), "classify: bad class ids")
        for g in gens:
            require(((g >= 0) & (g < n_classes)).all(), "generate: bad token ids")
        runs[run] = dict(
            batch=[B, S], wall_s=wall, tier_counts=res.tier_counts.tolist(), evaluated=res.evaluated.tolist(),
            outputs_digest=outputs_digest(res.pred, res.tier_of),
            tokens_digest=outputs_digest(*gens) if gens else None,
            cost=res.cost, host_fetch=host_fetch_stats(), launches=counts,
            captures={k: v - counts0.get(k, 0) for k, v in trace_counts().items() if v != counts0.get(k, 0)},
            capture_s=capture_seconds() - cap0,
            max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        log(f"[{name}] {mode} ({run}): {json.dumps(runs[run])}")
    eager = runs["eager"]
    for run in ("graphed_1", "graphed_2"):
        r = runs[run]
        require((r["outputs_digest"], r["tokens_digest"]) == (eager["outputs_digest"], eager["tokens_digest"]),
                f"{name}: {run} {mode} gives other pred, tier_of or tokens than the eager run")
        require(r["launches"] == eager["launches"], f"{name}: {run} {mode} launches {r['launches']} != eager "
                                                    f"{eager['launches']}")
        require(r["max_memory_allocated_gib"] <= eager["max_memory_allocated_gib"] + 2.0,
                f"{name}: {run} {mode} peak device memory {r['max_memory_allocated_gib']:.2f} GiB against eager "
                f"{eager['max_memory_allocated_gib']:.2f}")
    require(runs["graphed_1"]["captures"], f"{name}: the first graphed {mode} captured nothing")
    require(not runs["graphed_2"]["captures"], f"{name}: the second graphed {mode} captured "
                                               f"{runs['graphed_2']['captures']}")
    # the static caches generate keeps on each tier, one a (B, S, max_new)
    caches = {f"{t.spec.name} {key}": nbytes(*(x for v in c.values() for x in (v if isinstance(v, list) else [v])))
              / 2**30 for t in server.tiers for key, c in t.batch_caches.items()}
    log(f"[{name}] {mode} walls: eager {eager['wall_s']:.4f}s, graphed {runs['graphed_1']['wall_s']:.4f}s, "
        f"{runs['graphed_2']['wall_s']:.4f}s; static caches GiB {json.dumps(caches)}")
    return dict(runs, wall_speedup_graphed_2=eager["wall_s"] / runs["graphed_2"]["wall_s"],
                static_cache_gib=caches), runs["graphed_2"]["launches"]


def generate_step_profile(tier, B, S, max_new):
    """One replay of the prefill and of the decode step that a tier's
    ``generate`` captured at (B, S, max_new), each profiled
    (``profile_call``) over the tier's static cache."""
    from repro_torch.serve import sampling

    cache = tier.batch_caches[(B, S, max_new)]
    keys, bucket = sampling.batch_keys(0, B), (B, S, max_new)
    toks = np.zeros((B, S), np.int32)
    tok = np.zeros((tier.k, B, 1), np.int32)
    pos = np.full(B, S, np.int64)
    return dict(
        prefill=profile_call(lambda: tier.graphs.run(
            tier._prefill.key, functools.partial(tier._prefill_into, cache), toks, keys, bucket=bucket)),
        decode_step=profile_call(lambda: tier.graphs.run(
            tier._decode.key, functools.partial(tier._decode_in, cache), tok, pos, keys, bucket=bucket)),
    )


def sampled_serve_run(server, rng, vocab, name, need, seed):
    """One graphed ``serve_continuous`` at T = 0.8 over new tiers on the
    same weights (per-slot keys from ``seed``), with no eager oracle:
    phase 3 holds sampled graphed == eager and paged == dense at reduced
    width.  Checks the outputs and returns its numbers, with one profiled
    replay of each tier's sampled decode step (against the greedy one in
    ``decode_step``, the sampler's cost)."""
    from repro_torch.serve import CascadeServer, CascadeTier, ServeConfig
    from repro_torch.serve.graphs import trace_counts

    sampled = CascadeServer([CascadeTier(t.cfg, t.values, t.spec, temperature=0.8, device=t.device)
                             for t in server.tiers], device=server.device)
    cfg = ServeConfig(**SERVE_CONFIG, seed=seed)
    reqs = serve_requests(rng, 32, vocab, 16, 384, 16, n_prefix=8, prefix_len=128)
    result = serve_continuous_run(sampled, reqs, cfg, name, "sampled_graphed", need)
    counts = trace_counts()
    result["decode_step"] = {tier.spec.name: decode_step_profile(tier) for tier in sampled.tiers}
    require(trace_counts() == counts, f"{name}: the profiled sampled decode steps captured again")
    log(f"[{name}] one sampled graphed decode step: {json.dumps(result['decode_step'])}")
    return result


def profile_call(fn, reps=3, names=False):
    """One call of ``fn`` after a warm call: its wall (median of 5, host
    clock to a synchronize), then ``reps`` calls each under torch.profiler,
    of which the one with the median count of device kernels gives its
    host operators (top-level ``aten::`` calls, and all of them), device
    kernels, device busy time (the kernels' summed durations), six
    costliest kernels by name and the launch counters' delta.  ``names``
    adds that profile's kernel count by name (``kernel_names``).

    The profiler drops or adds a record at the edge of its window, the same
    way in every window of a process (one process missed the window's first
    kernel in every profile, another saw one from before it), so the
    kernels of a call, their count and their durations, are those of a
    window of two calls less those of a window of one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    def window(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = prof.events()
        dev_ev = [e for e in ev if e.device_type == DeviceType.CUDA
                  and not e.name.lower().startswith(("memcpy", "memset"))]
        n, ms = collections.Counter(), collections.Counter()
        for e in dev_ev:
            n[e.name] += 1
            ms[e.name] += e.time_range.elapsed_us() / 1e3
        return ev, n, ms

    runs = []
    for _ in range(reps):
        kernels.reset_launch_counts()
        ev, n_one, ms_one = window(1)
        counts = kernels.launch_counts()
        _, n_two, ms_two = window(2)
        per_call = {k: n_two[k] - n_one[k] for k in n_two | n_one if n_two[k] != n_one[k]}
        by_name = {k: ms_two[k] - ms_one[k] for k in ms_two | ms_one}
        aten = [e for e in ev if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
        runs.append(dict(
            aten_ops_top_level=sum(e.cpu_parent is None for e in aten), aten_ops_all=len(aten),
            device_kernels=sum(per_call.values()), wall_s=sorted(walls)[2], device_busy_ms=sum(by_name.values()),
            top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]),
            launches={k: v for k, v in counts.items() if v},
        ))
        if names:
            runs[-1]["kernel_names"] = collections.Counter(per_call)
    out = sorted(runs, key=lambda r: r["device_kernels"])[reps // 2]
    return dict(out, device_kernels_runs=[r["device_kernels"] for r in runs])


def chunk_call_profile(tier, rng):
    """One chunked-admission call of a paged tier at its published width
    (a 256-token chunk at position 0 into a slot that maps 24 shuffled
    pages of a 257-page pool, as ``SERVE_CONFIG`` sizes it), profiled
    (``profile_call``) with the one-launch K/V view, again with the two
    ``paged_pool_view`` calls through ``gather_rows`` that it replaced
    (patched in for that run), and as a replay of the call captured in a
    CUDA graph (the serving path's form: its device kernels must be the
    eager call's)."""
    from repro_torch.core import ensemble as ens
    from repro_torch.kernels.compaction import ops as cops
    from repro_torch.serve.graphs import GraphSet

    cfg, values, dev = tier.cfg, tier.values, tier.device
    ps = SERVE_CONFIG["page_size"]
    n_pg = SERVE_CONFIG["max_seq"] // ps
    P = SERVE_CONFIG["n_slots"] * n_pg + 1
    pools = ens.init_ensemble_paged_pool(values, cfg, P, ps)
    pages = np.full(n_pg, -1, np.int32)
    pages[:24] = rng.permutation(P - 1)[:24]
    pages_row = torch.as_tensor(pages, device=dev)
    tokens = rng.integers(0, cfg.vocab_size, SERVE_CONFIG["max_chunk"]).astype(np.int32)

    def call():
        ens.ensemble_prefill_into_slot_paged(values, tokens, pools, pages_row, 0, cfg)

    graphs = GraphSet(dev)

    def graphed_call():
        graphs.run(f"{cfg.name}/chunk_call_profile",
                   lambda t, p, s: ens.ensemble_prefill_into_slot_paged(values, t, pools, p, s, cfg),
                   tokens, pages, np.array([0]), bucket=len(tokens))

    def two_views(k_pool, v_pool, pages):
        return (cops.paged_pool_view(k_pool, pages, cops.gather_rows),
                cops.paged_pool_view(v_pool, pages, cops.gather_rows))

    out = {}
    one_view = cops.paged_kv_view
    try:
        for variant, view, fn in (("one_launch_view", one_view, call), ("two_paged_view_calls", two_views, call),
                                  ("graphed", one_view, graphed_call)):
            cops.paged_kv_view = view
            out[variant] = profile_call(fn, names=variant != "two_paged_view_calls")
    finally:
        cops.paged_kv_view = one_view
    for variant in ("one_launch_view", "graphed"):
        require(out[variant]["launches"].get("compaction") == cfg.n_layers,
                f"{cfg.name}: {out[variant]['launches']} launches in a {variant} chunk call")
    eager_names, graphed_names = out["one_launch_view"].pop("kernel_names"), out["graphed"].pop("kernel_names")
    if graphed_names != eager_names:
        log(f"{cfg.name}: device kernels of a graphed chunk call less the eager call's, by name: "
            f"{json.dumps({k: graphed_names[k] - eager_names[k] for k in graphed_names | eager_names if graphed_names[k] != eager_names[k]})}")
    require(out["graphed"]["device_kernels"] == out["one_launch_view"]["device_kernels"],
            f"{cfg.name}: a graphed chunk call runs {out['graphed']['device_kernels']} device kernels "
            f"({out['graphed']['device_kernels_runs']}), the eager call {out['one_launch_view']['device_kernels']} "
            f"({out['one_launch_view']['device_kernels_runs']})")
    return out


def decode_step_profile(tier):
    """One graphed decode step of a tier at the serving geometry
    (``SERVE_CONFIG``: 8 slots, every slot at position 300), replaying the
    graph its ``serve_continuous`` captured, profiled (``profile_call``)."""
    from repro_torch.serve import TierBackend

    cfg = SERVE_CONFIG
    backend = TierBackend(tier, n_slots=cfg["n_slots"], max_seq=cfg["max_seq"], page_size=cfg["page_size"])
    pos = np.full(cfg["n_slots"], 300, np.int32)
    if backend.paged:
        for s in range(cfg["n_slots"]):
            backend.pool.admit(s, np.arange(301, dtype=np.int32) % tier.cfg.vocab_size, share=False)
    tok = np.zeros((tier.k, cfg["n_slots"], 1), np.int32)
    return profile_call(lambda: backend.decode(tok, pos))


def serve_continuous_path(server, rng, vocab, name, need):
    """``serve_continuous`` at published widths: 32 requests of 16-384
    prompt tokens (8 sharing a 128-token prefix, 8 full pages where the
    tier pages), 16 new tokens each, after an eager warm-up at a small
    shape; run once with the eager oracle, then graphed twice (the first
    graphed run captures each tier's decode step and chunk buckets, the
    second must capture nothing).  The three runs must emit bitwise the same
    tokens, tiers and pool counters and launch each kernel as often, and a
    graphed run's peak device memory stay within 2 GiB of the eager run's.
    Returns (results, the second graphed run's launches)."""
    from repro_torch.serve import ServeConfig

    cfg = ServeConfig(**SERVE_CONFIG)
    server.serve_continuous(serve_requests(rng, 4, vocab, 8, 40, 2, n_prefix=2, prefix_len=16), cfg, eager=True)
    state = rng.bit_generator.state
    runs = {}
    for run in ("eager", "graphed_1", "graphed_2"):
        rng.bit_generator.state = state  # the same requests in every run
        reqs = serve_requests(rng, 32, vocab, 16, 384, 16, n_prefix=8, prefix_len=128)
        runs[run] = serve_continuous_run(server, reqs, cfg, name, run, need)
    eager, g1, g2 = runs["eager"], runs["graphed_1"], runs["graphed_2"]
    for run in ("graphed_1", "graphed_2"):
        r = runs[run]
        require(r["outputs_digest"] == eager["outputs_digest"] and r["pool_digest"] == eager["pool_digest"],
                f"{name}: {run} serve_continuous emits other tokens, tiers or pool counters than the eager run")
        require(r["launches"] == eager["launches"], f"{name}: {run} launches {r['launches']} != eager {eager['launches']}")
        require(r["max_memory_allocated_gib"] <= eager["max_memory_allocated_gib"] + 2.0,
                f"{name}: {run} peak device memory {r['max_memory_allocated_gib']:.2f} GiB against eager "
                f"{eager['max_memory_allocated_gib']:.2f}")
    require(g2["trace_counts"] == g1["trace_counts"], f"{name}: the second graphed serve_continuous captured again")
    require(g1["trace_counts"] != eager["trace_counts"], f"{name}: the first graphed serve_continuous captured nothing")
    captures = {k: v - eager["trace_counts"].get(k, 0) for k, v in g1["trace_counts"].items()
                if v != eager["trace_counts"].get(k, 0)}
    result = dict(runs, captures_graphed_1=captures,
                  wall_speedup_graphed_2=eager["wall_s"] / g2["wall_s"])
    log(f"[{name}] serve_continuous captures in the first graphed run: {json.dumps(captures)}; "
        f"walls eager {eager['wall_s']:.4f}s, graphed {g1['wall_s']:.4f}s, {g2['wall_s']:.4f}s")
    return result, g2["launches"]


def serve_continuous_run(server, reqs, cfg, name, run, need):
    """One timed ``serve_continuous`` (``run`` "eager" takes the oracle
    route) with the launch counters, host fetches and peak memory reset
    just before and read just after; checks its outputs and returns its
    numbers."""
    from repro_torch import kernels
    from repro_torch.core.cascade import host_fetch_stats, reset_host_fetch_stats
    from repro_torch.obs import Observability
    from repro_torch.serve.graphs import capture_seconds, trace_counts

    ob = Observability()
    cap0 = capture_seconds()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_host_fetch_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = server.serve_continuous(reqs, dataclasses.replace(cfg, obs=ob), eager=run == "eager")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for kname in need:
        require(counts[kname] > 0, f"{name} serve_continuous ({run}): kernel {kname} was not launched on the main path")
    require(sorted(r.rid for r in done) == sorted(r.rid for r in reqs), "serve_continuous: a request was lost or doubled")
    require(len({id(r) for r in done}) == len(reqs), "serve_continuous: a request completed twice")
    reg = ob.registry
    n_tiers = len(server.tiers)
    paged = [reg.get(f"paging.tier{i}.pool_occupancy") is not None for i in range(n_tiers)]
    for i in range(n_tiers):
        if paged[i]:
            require(reg.get(f"paging.tier{i}.pool_occupancy").value == 0, f"tier {i}: pool pages still in use")
    out_tokens = 0
    for r in done:
        require(r.tier in range(n_tiers) and r.output.ndim == 1, f"request {r.rid}: bad tier or output")
        require(len(r.output) == r.max_new_tokens or r.truncated, f"request {r.rid}: short output not flagged")
        v = server.tiers[r.tier].cfg.vocab_size
        require(((r.output >= 0) & (r.output < v)).all(), f"request {r.rid}: bad token ids")
        out_tokens += len(r.output)
    tiers = [r.tier for r in done]
    by_rid = {r.rid: r for r in done}
    st = server.last_stream_stats
    names = {t.cfg.name for t in server.tiers}
    tier_stats = [dict(
        decode_steps=reg.get(f"slot_stream.tier{i}.decode.dispatch_s").count,
        decode_tokens=st[i]["decode_tokens"], chunk_calls=st[i]["chunk_calls"],
        chunk_tokens=st[i]["chunk_tokens"], shared_tokens=st[i]["shared_tokens"],
        peak_pages=reg.get(f"paging.tier{i}.pool_occupancy").peak if paged[i] else None,
        shared_hits=reg.value(f"paging.tier{i}.shared_hits") if paged[i] else None,
        forced_completions=st[i]["forced_completions"],
    ) for i in range(n_tiers)]
    result = dict(
        run=run, config=SERVE_CONFIG, paged=paged,
        n_pages=SERVE_CONFIG["n_slots"] * SERVE_CONFIG["max_seq"] // SERVE_CONFIG["page_size"] + 1,
        requests=len(reqs), prompt_tokens=int(sum(len(r.tokens) for r in reqs)),
        # tier, truncation flag and tokens of every request, in submission order
        outputs_digest=outputs_digest(*(np.concatenate([[by_rid[q.rid].tier, by_rid[q.rid].truncated],
                                                        by_rid[q.rid].output]) for q in reqs)),
        # every tier's stream and pool counters
        pool_digest=outputs_digest(*([-1 if v is None else v for v in t.values()] for t in tier_stats)),
        wall_s=wall, output_tokens=out_tokens, output_tokens_per_s=out_tokens / wall,
        tier_counts=[tiers.count(i) for i in range(n_tiers)],
        truncated=sum(r.truncated for r in done),
        # host clock: admission (page claims + chunked-prefill launches or
        # replays) and decode (launches or a replay, and the one token fetch,
        # which waits for the device); with graphs both are dispatch
        tiers=[dict(t, admit_s=st[i]["admit_time"], decode_s=st[i]["decode_time"]) for i, t in enumerate(tier_stats)],
        host_fetch=host_fetch_stats(), launches=counts,
        trace_counts={k: v for k, v in trace_counts().items() if k.split("@")[0].split("/")[0] in names},
        capture_s=capture_seconds() - cap0,
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    log(f"[{name}] serve_continuous ({run}): {json.dumps(result)}")
    return result


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
    # the cases added with the compaction and agreement redesign draw from
    # their own stream, so every other check sees the inputs it always had
    gx = torch.Generator(device=dev).manual_seed(args.seed + 1)
    checks = []
    for fn in (functools.partial(check_agreement, gx=gx), functools.partial(check_compaction, gx=gx),
               check_flash, check_decode, check_decode_paged, check_ssd, check_wkv6):
        r = fn(dev, g)
        log(f"kernel {r['name']}: {json.dumps(r)}")
        checks.append(r)
    ref = check_reference(dev, args.seed)
    ref.update(check_reference_recurrent(dev, args.seed))
    log(f"reference (card vs cpu, normwise, tol {REF_TOL}): {json.dumps(ref)}")
    ref["serve_continuous_on_card"] = check_serving_on_card(dev, args.seed)
    log(f"serve_continuous on the card, paged == dense, graphed == eager: {json.dumps(ref['serve_continuous_on_card'])}")
    ref["batch_programs_on_card"] = check_batch_programs_on_card(dev, args.seed)
    log(f"batch programs on the card, vector == int position, draws == cpu, graphed == eager: "
        f"{json.dumps(ref['batch_programs_on_card'])}")
    ref["engine_on_card"] = check_engine_on_card(dev, args.seed)
    log(f"engine on the card, graphed == eager: {json.dumps(ref['engine_on_card'])}")
    results, launches = {}, {}
    # each cascade's weights and caches must be freed by reference counting
    # alone when it returns, before the next is built: the cyclic collector
    # is off meanwhile, so a reference cycle that holds device memory fails
    gc.collect()
    gc.disable()
    for name in CASCADES:
        before = torch.cuda.memory_allocated()
        results[name], per_mode = main_path(dev, args.seed, name)
        launches.update({f"{name}/{mode}": c for mode, c in per_mode.items()})
        left = (torch.cuda.memory_allocated() - before) / 2**30
        log(f"[{name}] device memory still allocated after the run: {left:.4f} GiB")
        require(left < 0.25, f"{name}: {left:.2f} GiB of device memory outlived the cascade")
        results[name]["memory_left_gib"] = left
        torch.cuda.empty_cache()
    gc.enable()

    sources = {
        "agreement": ("src/repro_torch/csrc/agreement.cu", "src/repro/kernels/agreement/kernel.py:67"),
        "compaction": ("src/repro_torch/csrc/compaction.cu", "src/repro/kernels/compaction/kernel.py:56"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:179"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu", "src/repro/kernels/decode_attention/kernel.py:226"),
        "decode_attention_paged": ("src/repro_torch/csrc/decode_attention.cu", "src/repro/kernels/decode_attention/kernel.py:110"),
        "mamba2_ssd": ("src/repro_torch/csrc/mamba2_ssd.cu", "src/repro/kernels/mamba2_ssd/kernel.py:88"),
        "rwkv6_wkv": ("src/repro_torch/csrc/rwkv6_wkv.cu", "src/repro/kernels/rwkv6_wkv/kernel.py:92"),
    }
    line = {"kernels": [
        {
            "name": c["name"], "route": "cuda", "source": sources[c["name"]][0],
            "replaces": sources[c["name"]][1],
            "launches": sum(launches[m][c["name"]] for m in launches),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "device_ms": c["device_ms"], "library_device_ms": c["library_device_ms"],
            "host_us": c["host_us"], "device_launches_per_call": c["device_launches_per_call"],
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

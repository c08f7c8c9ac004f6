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
   and paged decode bitwise the dense kernel at S 4096.  Then the head
   groups of the MoE, VLM and command-r families (``check_attention_groups``,
   its own generator): decode dense and paged and flash at G 5, 6 and 12
   (the published (H, KVH) of llama4, mixtral and command-r-plus at hd
   128, and hd 64), dense decode at every cluster size 1-8, paged bitwise
   the dense kernel, flash at mixtral's 4096-row window with S past it;
   each timed (a row under its kernel's ``groups``) with a bound and SDPA.
   Then the padded head sizes and the f32 route (``check_attention_widths``,
   its own generator): flash, dense and paged decode at hd 8, 16, 24, 32,
   40 and 56 (G 1, 2, 3, 7) in bf16, and at those and hd 64, 80, 128 in
   f32 (normwise 1e-5), every G from 1 to 16 at hd 40 in both, paged
   bitwise the dense kernel at each; timed at the examples' shapes (bf16)
   and the main path's (f32), each a row under its kernel's ``widths``.
   Then the routes past those (``check_wide_routes``, its own generator):
   flash, dense and paged decode at hd 256, 200, 100, 20, 3 and 300 and at
   G 32 and 71 in bf16, f16 and f32 (paged bitwise the dense kernel), the SSD
   on the dual form at N 128, P 128 and P 96 and on the run-time (P, N)
   scan in bf16 and f32, WKV6 on the run-time-D scan at D 128 and 48;
   timed: flash hd 256 (bf16) and f16 hd 128 against SDPA, decode at G 32
   and 64 against SDPA, the SSD at N 128 and WKV6 at D 128 against their
   bounds, each a row under its kernel's ``routes`` (and in the kernels
   line).
   Then training (``check_flash_training``, its own generator): flash's
   lse output against the plain version's (abs 1e-3) at B 4 x S 1024 with
   qwen2.5-3b's heads (16, 2) at hd 128, zamba2's hd 80 at G 1, and a window
   and softcap; dq, dk, dv through the training route (the kernel forward
   with lse, the plain backward) against autograd of the plain version
   (normwise 2e-2); the forward timed with and without lse, and the
   training route's forward and backward against SDPA's (events, device
   and host times, the backward's bound).
   ``check_ssd_grad`` / ``check_wkv6_grad`` hold the scans' input gradients
   under autograd (kernel forward, backward by recompute of the plain
   version) against autograd of the plain versions at reduced shapes (with
   the bound of a forward and backward), and
   ``check_inference_only`` that agreement, compaction (its three entries)
   and both decode kernels raise under grad.
3. reference — the port on the card (kernels) against the port on the CPU
   (plain versions) with the same bf16 weights at reduced width: prefill and
   decode, paged decode and paged chunked prefill for the dense tiers;
   prefill, decode and chunked prefill into a slot followed by a decode step
   for rwkv6-7b and zamba2-2.7b, and the same again in float32 (rwkv6-7b,
   zamba2-2.7b's Mamba2 backbone and zamba2-2.7b whole, and qwen2.5-3b,
   whose attention takes the kernels' f32 route) at a tight tolerance,
   where only summation order differs; then short ``serve_continuous`` runs on the
   card, each with the eager oracle and with the graphed slot programs:
   the dense cascade with block-paged pools and with the dense slot cache,
   the recurrent cascade with dense slot caches; all must emit equal
   tokens.  Then the batch programs (``check_batch_programs_on_card``),
   the single-model engine (``check_engine_on_card``: classify, generate
   and a sampled serve_continuous, graphed == eager), speculative deferral
   (``check_speculative_on_card``: qwen2.5-3b, tier 1 [m0, m0, m2], tier 2
   [m0], greedy and T = 0.8, paged and dense, eager and graphed twice
   bitwise, speculative == plain up to near ties, each request emitting
   its verify pass's choices, each pass of the second graphed run bitwise
   the eager route on a copy of its memory; over an rwkv6-7b tier 2
   no verify pass), open-loop serving (``check_open_loop_on_card``: the
   bench's bursty trace, static and with the greedy controller, each run
   twice with equal reports and no capture) and placement
   (``check_transport_on_card``, both cascade shapes: classify over
   ``edge_cloud(link="sim")`` bitwise the unplaced run, one count read a
   transition, each tier's answers the rule's over its own logits on the
   card, logits held to the CPU's, the CPU's answers but at rows the row's
   own difference can flip;
   ``serve_continuous`` greedy and T = 0.8 bitwise under no placement,
   ``single_host`` and the sim, serial and async links at 10 ms, equal
   hops, ``inflight_admitted`` the deferrals; speculative over the async
   link, the draft on the hop).  Then an f32 cascade, 3 x qwen2.5-3b ->
   internlm2-1.8b reduced (``check_f32_cascade_on_card``): classify over
   the sim link, each tier's greedy generate and the cascade's
   serve_continuous, card against CPU equal but at near ties.  Last the
   families of the MoE, VLM and
   encoder slice at reduced width (``check_families_on_card``): olmo-1b and
   command-r-plus-104b end to end (left-padded prefill, decode, paged chunk
   and decode) card vs CPU at REF_TOL; hubert-xlarge over frames,
   internvl2-26b with its vision prefix, mixtral-8x22b and
   llama4-maverick-400b-a17b layer by layer on the CPU's inputs at REF_TOL
   (end to end a bf16 difference upstream can move a near tie between
   experts, and the frontends' large projected inputs carry the rounding
   further), prefill == forward on the card, and the MoE configs' paged
   serve_continuous graphed twice == eager == dense.  Then three train
   steps of qwen2.5-3b, mixtral-8x22b, zamba2-2.7b, rwkv6-7b, internvl2-26b
   and hubert-xlarge at reduced width (``check_training_on_card``), card
   against CPU from the same bf16 weights: each loss within 1e-2, the
   parameters after the third step at REF_TOL, the first step's grad_norm
   within 0.25 and its gradient leaf by leaf and over the whole tree within
   three times the CPU's own bf16-vs-f32 distance (relative L2, at least
   0.1, below 0.9: a lost or negated gradient fails), three AdamW updates
   with one gradient equal on both devices up to rounding, the family's
   kernels launched on the card and none on the CPU, the MoE's aux term
   positive; and a checkpoint of the card's trained parameters restoring
   bitwise.
4. main path — three cascades at published widths, bf16
   weights drawn from ``--seed``, each built after the one before has its
   tensors freed by reference counting alone (the cyclic collector is
   off, and device memory that outlives a cascade fails the run).  First: tier 1 a k=3 ensemble of qwen2.5-3b, tier 2
   internlm2-1.8b.  Second: tier 1 a k=3 ensemble of zamba2-2.7b (Mamba2
   backbone, shared attention every 6th layer), tier 2 rwkv6-7b — the path
   that runs the SSD and WKV6 kernels.  Third: tier 1 a k=3 ensemble of
   olmo-1b (full depth), tier 2 mixtral-8x22b cut to 4 of its 56 layers
   (MoE at published width, G 6, window 4096), with the first two's three
   modes and none of the first cascade's extras.  The first two run at
   full depth.  Each: tier 1 uses the score rule
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
   call's).  Then tier 1's generate over more (S, max_new) shapes than
   the tier keeps batch buckets (``bucket_memory_check``): device memory
   level once the tier is full.  The first cascade then serves the bench's
   open-loop trace with the main path's prompts (``open_loop_path``), and
   last its tier-1 weights, member 0 copied into member 1, make the
   speculative cascade 3 x qwen2.5-3b [m0, m0, m2] -> qwen2.5-3b [m0]
   (``speculative_path``): plain and speculative graphed twice and at T =
   0.8, every request emitting its accepted draft prefix and its verify
   pass's choice, every pass of two runs bitwise the eager route on a
   copy of its pool (``verify_passes``), the verify chunk held to the
   decode steps layer by layer, one verify replay profiled.  Before the
   open loop, the first cascade's tiers run the edge-to-cloud path
   (``edge_cloud_path``): classify 32 x 256 over a simulated 100 ms link
   (the unplaced digest; bytes crossed against the batch's), and the main
   path's serve_continuous over a serial and an overlapped 100 ms link
   (``AsyncTransport``): the unplaced graphed run's tokens, equal hops,
   nothing captured, both walls and the overlap ratio.  After the
   cascades, the frontends at published width (``frontend_path``):
   hubert-xlarge x3 last logits over 8 x 512 frames and ``member_stats``;
   internvl2-26b with 4 of its 48 layers, a 256-patch + 128-token prefill
   and 16 decode steps, graphed == eager.  Then the serve CLI at published
   width (``serve_cli_path``: ``--tiers qwen2.5-3b:3 internlm2-1.8b:1``,
   classify and generate) and examples/edge_to_cloud.py at its widths, hd
   16 and 32 (``edge_to_cloud_example``: its 200 and 400 training steps,
   classify over the sim link card vs CPU, serve_continuous over the sim,
   serial and async links, equal generations and hops).  Last,
   training (``train_path``):
   the first-step grad_norm of qwen2.5-3b's 36 layers at d 512 on the card
   and the CPU, finite and within 3 decades (``deep_gradient_witness``);
   qwen2.5-3b at published width (36 layers, d 2048, vocab 151936, remat
   on), one warm-up step and 5 timed steps of 4 x 1024 tokens of
   ``sequence_task`` (step wall, tokens/s, peak memory, losses; finite
   losses and 72 flash launches a step: 36 forward, 36 from remat's
   recompute), then one more forward and backward outside the step (every
   leaf's gradient finite, the f64 sum of squares past f32's range where
   grad_norm read inf; device memory by stage); then examples/train_then_cascade.py on the card
   (``trained_cascade``) at its own widths, hd 24 and 40, calibrated and
   serving 1024 fresh requests through ``CascadeServer``.  Its launches join the kernels line
   under ``train/`` runs (``train_launches``).  Last, ``pod_classify``
   (``pod_classify_path``): the first cascade's classify on 32 x 256 at
   published width over ``pod_placement`` of a (2, 1, 1) mesh (tier i on
   rank i), a (4, 1, 1) one (each tier on two ranks, every chunk of tier
   2's rows landing half on each) and a (6, 1, 1) one (tier 1's three
   members one a rank, tier 2 replicated on three), the ranks spawned on this card under ``gloo``
   (NCCL takes one rank a card), computing on ``cuda:0`` and loading the
   kernels phase 1 built: eager, graphed twice and the replicated
   baseline, every rank's pred, tier_of and tier_counts bitwise this
   process's unplaced server's, the hop metered as the replicated link's,
   each rank holding only its slice's tier and fed its block of each of
   tier 2's chunks; rank 0's walls, each rank's
   peak memory, the hop's bytes, and each mesh's launches (summed over its
   ranks, the second graphed run) in the kernels line as
   ``pod_classify_2``, ``_4`` and ``_6``.  On the (2, 1, 1) and (6, 1, 1)
   meshes the same ranks then run the cascade's generate (8 x 128, 16
   new, digests voted, θ 0.5) and serve_continuous (8 requests of 16-128
   tokens, 16 new, 4 slots; greedy and T = 0.8) over the same placed
   weights, graphed (``pod_serve_runs``): every rank's pred, tier_of,
   tier_counts, tokens, tiers and completion order bitwise this process's
   unplaced server's, one metered hop a deferral, tier 1's member offsets
   [0] and [0, 1, 2] (the global index its draws key on).  Random members
   never agree, so at θ 0.5 every request defers; generate and serve at T
   = 0.8 and θ 0.25 (a 1-of-3 vote answers) make tier 1's sampled
   generations the outputs.  There a (2, 1, 1) rank holds all three
   members and must equal the unplaced server bitwise, every member's
   generation included; a (6, 1, 1) rank holds one, whose products run at
   another batch count than the stacked tier's (``chip_member_products.py``:
   other bits), so each member's generations must equal that member
   alone, unplaced and drawing as its global index (``pod_member_refs``),
   and every rank's answers the vote over them; members 1 or 2 must win
   some votes; rank 0's walls,
   peak memory and launches (``pod_generate_2`` / ``_6``,
   ``pod_serve_2`` / ``_6``) in the kernels line.  The ranks time-share
   one card, so the walls are no multi-GPU speed.

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

# the card's rates (``repro_torch.core.cost_model.H100_SXM``, read in main
# once the port is importable): bytes a second from HBM, operations a second
# on the bf16 and TF32 tensor cores and on the f32 CUDA cores
HBM_BYTES_PER_S = BF16_FLOPS = TF32_FLOPS = F32_FLOPS = None


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
    activity.  Both are a window of 2 x ``iters`` calls less a window of
    ``iters``: the profiler drops or adds a record at a window's edge, the
    same way in every window of a process (see ``profile_call``).  Now and
    then one window alone gains an edge record, and the launches a call
    read a fraction no call can launch: such a pair of windows is taken
    again (at most 3 pairs; the median pair if none reads whole)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window(calls):
        for _ in range(3):  # a trace now and then holds no device records: take another
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if dev:
                kernels = [e for e in dev if not e.name.lower().startswith(("memcpy", "memset"))]
                return sum(e.time_range.elapsed_us() for e in dev), len(kernels)
        return None

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(3):
        one, two = window(iters), window(2 * iters)
        if one is None or two is None:
            return None, None
        pairs.append(((two[0] - one[0]) / iters / 1e3, (two[1] - one[1]) / iters))
        if float(pairs[-1][1]).is_integer():
            return pairs[-1]
    return sorted(pairs, key=lambda p: p[1])[1]


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


def bound_of(cost):
    """``bound`` of a kernel call's ``cost(...)`` (``kernels/*/ops.py``: the
    one place a kernel's bytes and operations are counted)."""
    peak = {"bf16": BF16_FLOPS, "f16": BF16_FLOPS, "tf32": TF32_FLOPS, "f32": F32_FLOPS}[cost["unit"]]
    return bound(cost["bytes"], cost["flops"], peak)


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
    b_ms, b_by = bound_of(ops.cost(x))
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

    def library():
        idx = torch.nonzero(mask).flatten()
        return {k: v.index_select(0, idx) for k, v in tree.items()}

    def plain():
        im, _ = ops.compact_indices_plain(mask)
        return {k: ops.gather_rows_plain(v, im) for k, v in tree.items()}

    b_ms, b_by = bound_of(ops.compact_cost(tree, mask, n))
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
        b_ms, b_by = bound_of(ops.paged_kv_view_cost(kp, vp, pages, mapped))
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
        b_ms, b_by = bound_of(ops.cost(q, k, v, causal=True))  # q, k, v read; out written
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
        b_ms, b_by = bound_of(ops.cost(q, kc, vc, cur))
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


def shuffled_table(cur, n_pg, ps, P, holes=(), *, dev, g):
    """A shuffled, non-monotone (B, n_pg) page table of a pool of P pages:
    slot b maps ceil(cur[b] / ps) distinct random pages (from ``g``), -1
    past its length and at ``holes``."""
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


def check_decode_paged(dev, g):
    import torch.nn.functional as F

    from repro_torch.kernels.compaction.ops import gather_rows_plain, pool_row_index
    from repro_torch.kernels.decode_attention import ops

    mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)

    table = functools.partial(shuffled_table, dev=dev, g=g)

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
    b_ms, b_by = bound_of(ops.paged_cost(q, kp, vp, pages, cur_t))  # the K/V rows of E * sum(cur)
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


# The head-group sizes that join the decode kernel with the MoE, VLM and
# command-r families, with each config's published (H, KVH) at hd 128.
GROUP_SHAPES = {
    5: ("llama4-maverick-400b-a17b", 40, 8),
    6: ("mixtral-8x22b", 48, 8),
    12: ("command-r-plus-104b", 96, 8),
}
MIXTRAL_WINDOW = 4096


def check_attention_groups(dev, g):
    """The decode kernels (dense and paged) and flash at G 5, 6 and 12, hd
    128 at the published (H, KVH) and hd 64, against their plain versions:
    dense decode at every cluster size of the split plan (one (row, kv head)
    pair at S = 128 n, n = 1..8, so the merge chunks G * hd = 640, 768 and
    1536 outputs n ways), with window, softcap, starts and pure-pad rows;
    paged decode with a shuffled table and holes, bitwise the dense kernel
    on the gathered view; flash causal and not, and at mixtral's window with
    S past it.  Timed (as phase 2 times every kernel, with a bound and the
    SDPA call) at the third cascade's shapes: generate's decode (8 rows,
    cache 144), serve's paged decode (8 slots of 512 rows in 16-row pages)
    and tier 2's classify prefill (32 x 256).  Draws from its own generator,
    so the older checks keep their inputs.  Returns {kernel name: {"max_abs_err",
    "groups": {G: rows}}}."""
    import torch.nn.functional as F

    from repro_torch.kernels.compaction.ops import gather_rows_plain, pool_row_index
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl

    mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)  # noqa: E731
    T = lambda *xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731
    out = {n: {"max_abs_err": 0.0, "groups": {}} for n in ("decode_attention", "decode_attention_paged", "flash_attention")}

    def held(name, got, ref, what):
        err = (got.float() - ref.float()).abs().max().item()
        tol = FLASH_TOL if name == "flash_attention" else DECODE_TOL
        require(math.isfinite(err) and err <= tol, f"{name} {what}: err {err} > {tol}")
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        return err

    def decode(q, kc, vc, cur, what, **kw):
        got = dec.decode_attention_bksd(q, kc, vc, cur, **kw)
        err = held("decode_attention", got, dec.decode_attention_plain(q, kc, vc, cur, **kw), what)
        if kw.get("starts") is not None:
            pad = kw["starts"] >= torch.as_tensor(cur, device=dev).expand(q.shape[0])
            require(not got[pad].any(), f"decode {what}: pure-pad rows not zero")
        return err

    table = functools.partial(shuffled_table, dev=dev, g=g)

    def paged(E, B, H, KVH, hd, ps, n_pg, cur, what, holes=(), **kw):
        P = B * n_pg + 1
        q, kp, vp = mk(E * B, 1, H, hd), mk(E, P, KVH, ps, hd), mk(E, P, KVH, ps, hd)
        pages, cur_t = table(cur, n_pg, ps, P, holes), T(*cur)
        got = dec.decode_attention_paged(q, kp, vp, pages, cur_t, **kw)
        err = held("decode_attention_paged", got, dec.decode_attention_paged_plain(q, kp, vp, pages, cur_t, **kw),
                   what)
        kv, vv = (dec.paged_pool_view(t, pages, gather_rows_plain) for t in (kp, vp))
        require(torch.equal(got, dec.decode_attention_bksd(q, kv, vv, cur_t.repeat(E), **kw)),
                f"paged decode {what} is not bitwise the dense kernel on the gathered view")
        return q, kp, vp, pages, cur_t, err

    def flash(q, k, v, what, **kw):
        return held("flash_attention", fl.flash_attention(q, k, v, **kw), fl.flash_attention_plain(q, k, v, **kw), what)

    for G, (arch, H, KVH) in GROUP_SHAPES.items():
        for n in range(1, 9):  # one pair: n_split = n, up to the cluster's 8
            S = 128 * n
            q, kc, vc = mk(1, 1, G, 128), mk(1, 1, S, 128), mk(1, 1, S, 128)
            for cur in sorted({S, max(1, S - 77), 1}):
                decode(q, kc, vc, cur, f"G {G} S {S} cur {cur}")
        for hd, kvh in ((128, KVH), (64, 2)):
            S = 600
            q, kc, vc = mk(3, 1, G * kvh, hd), mk(3, kvh, S, hd), mk(3, kvh, S, hd)
            decode(q, kc, vc, T(1, 300, S), f"G {G} hd {hd}")
            decode(q, kc, vc, T(S, S - 1, 65), f"G {G} hd {hd} window", window=200)
            decode(q, kc, vc, T(S, 129, 1), f"G {G} hd {hd} starts", starts=T(S - 1, 128, 1))  # row 0: pure pad
            decode(q, kc, vc, T(513, S, 1), f"G {G} hd {hd} softcap", softcap=20.0, starts=T(0, 513, 0))
            paged(2, 3, G * kvh, kvh, hd, 16, 8, [100, 5, 128], f"G {G} hd {hd} holes", holes=[(0, 2), (2, 7)])
            paged(1, 4, G * kvh, kvh, hd, 16, 8, [120, 33, 128, 9], f"G {G} hd {hd} window", window=40, softcap=20.0)
            paged(1, 3, G * kvh, kvh, hd, 16, 256, [4096, 1000, 2049], f"G {G} hd {hd} S 4096")
            flash(*(mk(2, 200, G * kvh, hd), mk(2, 200, kvh, hd), mk(2, 200, kvh, hd)), f"G {G} hd {hd} causal",
                  causal=True, starts=T(0, 37))
            flash(*(mk(2, 77, G * kvh, hd), mk(2, 150, kvh, hd), mk(2, 150, kvh, hd)), f"G {G} hd {hd}", causal=False)
        rows = {"config": arch, "H": H, "KVH": KVH, "hd": 128}

        # generate's decode step of the third cascade's tier 2 (8 rows, cache 144)
        q, kc, vc = mk(8, 1, H, 128), mk(8, KVH, 144, 128), mk(8, KVH, 144, 128)
        cur = 143
        err = decode(q, kc, vc, cur, f"G {G} generate shape")
        qt, ks, vs = q.transpose(1, 2), kc[:, :, :cur], vc[:, :, :cur]
        b_ms, b_by = bound_of(dec.cost(q, kc, vc, cur))
        out["decode_attention"]["groups"][G] = dict(
            rows, shape={"q": list(q.shape), "cache": list(kc.shape), "cur_len": cur}, max_abs_err=err,
            **timings(lambda: dec.decode_attention_bksd(q, kc, vc, cur),
                      lambda: dec.decode_attention_plain(q, kc, vc, cur),
                      lambda: F.scaled_dot_product_attention(qt, ks, vs, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by,
        )

        # serve's paged decode: 8 slots of max_seq 512 in 16-row pages, E = 1
        B, ps, n_pg = 8, 16, 32
        cur_l = torch.randint(1, 513, (B,), generator=torch.Generator().manual_seed(G)).tolist()
        q, kp, vp, pages, cur_t, err = paged(1, B, H, KVH, 128, ps, n_pg, cur_l, f"G {G} serve shape")
        b_ms, b_by = bound_of(dec.paged_cost(q, kp, vp, pages, cur_t))
        idx = pool_row_index(pages, 1, kp.shape[1]).clamp(min=0).long()
        S = n_pg * ps
        valid = (torch.arange(S, device=dev)[None, :] < cur_t[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)

        def library(kp=kp, vp=vp, idx=idx, valid=valid, qt=qt):
            kv, vv = (t.reshape(-1, KVH, ps, 128).index_select(0, idx).reshape(B, n_pg, KVH, ps, 128)
                      .transpose(1, 2).reshape(B, KVH, S, 128) for t in (kp, vp))
            return F.scaled_dot_product_attention(qt, kv, vv, attn_mask=valid, enable_gqa=True)

        out["decode_attention_paged"]["groups"][G] = dict(
            rows, shape={"q": list(q.shape), "pool": list(kp.shape), "pages": list(pages.shape), "cur_len": cur_l},
            max_abs_err=err,
            **timings(lambda: dec.decode_attention_paged(q, kp, vp, pages, cur_t),
                      lambda: dec.decode_attention_paged_plain(q, kp, vp, pages, cur_t), library),
            bound_ms=b_ms, bound_by=b_by,
        )

        # tier 2's classify prefill (32 prompts of 256 tokens), causal
        q, k, v = mk(32, 256, H, 128), mk(32, 256, KVH, 128), mk(32, 256, KVH, 128)
        err = flash(q, k, v, f"G {G} classify shape", causal=True)
        b_ms, b_by = bound_of(fl.cost(q, k, v, causal=True))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = dict(
            rows, shape={"q": list(q.shape), "kv": list(k.shape)}, max_abs_err=err,
            **timings(lambda: fl.flash_attention(q, k, v, causal=True),
                      lambda: fl.flash_attention_plain(q, k, v, causal=True),
                      lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
                      plain_iters=5),
            bound_ms=b_ms, bound_by=b_by,
        )
        if G == 6:  # mixtral's sliding window, the prompt past it: keys before S - 4096 drop out
            S = MIXTRAL_WINDOW + 256
            q, k, v = mk(1, S, H, 128), mk(1, S, KVH, 128), mk(1, S, KVH, 128)
            err = flash(q, k, v, f"G {G} window {MIXTRAL_WINDOW} at S {S}", causal=True, window=MIXTRAL_WINDOW)
            b_ms, b_by = bound_of(fl.cost(q, k, v, causal=True, window=MIXTRAL_WINDOW))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            i = torch.arange(S, device=dev)
            win = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - MIXTRAL_WINDOW)
            row["window"] = dict(
                shape={"q": list(q.shape), "kv": list(k.shape)}, window=MIXTRAL_WINDOW, max_abs_err=err,
                **timings(lambda: fl.flash_attention(q, k, v, causal=True, window=MIXTRAL_WINDOW),
                          lambda: fl.flash_attention_plain(q, k, v, causal=True, window=MIXTRAL_WINDOW),
                          lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=win, enable_gqa=True),
                          plain_iters=2),
                bound_ms=b_ms, bound_by=b_by,
            )
        out["flash_attention"]["groups"][G] = row
    return out


# The head sizes the attention kernels run zero-padded to a built width (the
# examples' 16, 24, 32 and 40; 8 and 56 beside them), head groups no config
# has (3, 7), and the f32 route (plain FFMA on the SIMT cores), where card
# and plain version differ only in summation order: held normwise at
# F32_ATTN_TOL.  bf16 as above (FLASH_TOL, DECODE_TOL).
F32_ATTN_TOL = 1e-5
# (hd, H, KVH): every padded width with G 1, 2, 3 and 7; hd 64, 80 and 128
# join for f32 (their bf16 kernels are held above)
WIDTHS = ((8, 2, 2), (16, 6, 2), (24, 7, 1), (32, 8, 8), (40, 4, 4), (56, 3, 1))
F32_WIDTHS = WIDTHS + ((64, 8, 2), (80, 4, 4), (128, 16, 2))
# timed, bf16: the examples' own shapes (train_then_cascade's tiers at hd 24
# and 40 classifying 1024 prompts of 32 tokens, tier 1 three members;
# edge_to_cloud's at hd 16 and 32, its serve_continuous paged decode over 4
# slots of 32 rows); f32: the main path's shapes
EXAMPLE_FLASH = {"hd24": (3 * 1024, 32, 2, 2, 24), "hd40": (1024, 32, 4, 4, 40),
                 "hd16": (3 * 256, 32, 2, 2, 16), "hd32": (256, 32, 4, 4, 32)}
EXAMPLE_PAGED = {"hd16": (3, 4, 2, 2, 16), "hd32": (1, 4, 4, 4, 32)}  # E, slots, H, KVH, hd


def check_attention_widths(dev, g):
    """Flash, dense decode and paged decode at every padded head size and G
    (``WIDTHS``), and in f32 at those and the built widths
    (``F32_WIDTHS``), against their plain versions: flash causal with
    starts (pure-pad rows zero) and not causal with a window and a softcap;
    dense decode with per-row cur_len and starts, and with a window and
    softcap, at S 600 (several splits); paged decode with a shuffled table
    and holes, bitwise the dense kernel on the gathered view; then every G
    from 1 to 16 at hd 40 in both dtypes, dense and paged.  Timed as every
    kernel is, at the examples' shapes in bf16 (``EXAMPLE_FLASH``,
    ``EXAMPLE_PAGED``, and generate's dense decode at hd 32) and at the
    main path's shapes in f32.  Draws from its own generator.  Returns
    {kernel name: {"max_abs_err", "f32_normwise_err", "widths": {case:
    row}}}."""
    import torch.nn.functional as F

    from repro_torch.kernels.compaction.ops import gather_rows_plain, pool_row_index
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl

    names = ("flash_attention", "decode_attention", "decode_attention_paged")
    out = {n: {"max_abs_err": 0.0, "f32_normwise_err": 0.0, "widths": {}} for n in names}
    T = lambda *xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731

    def mk(*s, dtype=torch.bfloat16):
        return torch.randn(*s, device=dev, generator=g).to(dtype)

    def held(name, got, ref, what):
        require(got.dtype == ref.dtype, f"{name} {what}: dtype {got.dtype} != the plain version's {ref.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        if got.dtype == torch.float32:
            e32 = normwise_err(got, ref)
            require(math.isfinite(e32) and e32 <= F32_ATTN_TOL, f"{name} {what}: f32 normwise err {e32} > {F32_ATTN_TOL}")
            out[name]["f32_normwise_err"] = max(out[name]["f32_normwise_err"], e32)
        else:
            tol = FLASH_TOL if name == "flash_attention" else DECODE_TOL
            require(math.isfinite(err) and err <= tol, f"{name} {what}: err {err} > {tol}")
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        return err

    table = functools.partial(shuffled_table, dev=dev, g=g)

    def flash(q, k, v, what, **kw):
        got = fl.flash_attention(q, k, v, **kw)
        err = held("flash_attention", got, fl.flash_attention_plain(q, k, v, **kw), what)
        if kw.get("starts") is not None and kw.get("causal"):
            for b, s in enumerate(kw["starts"].tolist()):
                require(not got[b, :s].any(), f"flash {what}: pure-pad rows not zero")
        return err

    def decode(q, kc, vc, cur, what, **kw):
        got = dec.decode_attention_bksd(q, kc, vc, cur, **kw)
        err = held("decode_attention", got, dec.decode_attention_plain(q, kc, vc, cur, **kw), what)
        if kw.get("starts") is not None:
            require(not got[kw["starts"] >= torch.as_tensor(cur, device=dev).expand(q.shape[0])].any(),
                    f"decode {what}: pure-pad rows not zero")
        return err

    def paged(E, B, H, KVH, hd, ps, n_pg, cur, what, dtype, holes=(), **kw):
        P = B * n_pg + 1
        q, kp, vp = mk(E * B, 1, H, hd, dtype=dtype), mk(E, P, KVH, ps, hd, dtype=dtype), mk(E, P, KVH, ps, hd, dtype=dtype)
        pages, cur_t = table(cur, n_pg, ps, P, holes), T(*cur)
        got = dec.decode_attention_paged(q, kp, vp, pages, cur_t, **kw)
        err = held("decode_attention_paged", got, dec.decode_attention_paged_plain(q, kp, vp, pages, cur_t, **kw), what)
        kv, vv = (dec.paged_pool_view(t, pages, gather_rows_plain) for t in (kp, vp))
        require(torch.equal(got, dec.decode_attention_bksd(q, kv, vv, cur_t.repeat(E), **kw)),
                f"paged decode {what} is not bitwise the dense kernel on the gathered view")
        return q, kp, vp, pages, cur_t, err

    for dtype, widths in ((torch.bfloat16, WIDTHS), (torch.float32, F32_WIDTHS)):
        dn = str(dtype).split(".")[-1]
        for hd, H, KVH in widths:
            w = f"{dn} hd {hd} G {H // KVH}"
            flash(mk(2, 200, H, hd, dtype=dtype), mk(2, 200, KVH, hd, dtype=dtype), mk(2, 200, KVH, hd, dtype=dtype),
                  f"{w} causal", causal=True, starts=T(0, 37))
            flash(mk(2, 77, H, hd, dtype=dtype), mk(2, 150, KVH, hd, dtype=dtype), mk(2, 150, KVH, hd, dtype=dtype),
                  f"{w} window softcap", causal=False, window=40, softcap=20.0)
            S = 600
            q, kc, vc = mk(3, 1, H, hd, dtype=dtype), mk(3, KVH, S, hd, dtype=dtype), mk(3, KVH, S, hd, dtype=dtype)
            decode(q, kc, vc, T(1, 300, S), f"{w} cur_len")
            decode(q, kc, vc, T(S, 129, 1), f"{w} starts", starts=T(S - 1, 128, 1))  # row 0: pure pad
            decode(q, kc, vc, T(513, S, 65), f"{w} window softcap", window=200, softcap=20.0)
            paged(2, 3, H, KVH, hd, 16, 8, [100, 5, 128], f"{w} holes", dtype, holes=[(0, 2), (2, 7)])
            paged(1, 4, H, KVH, hd, 16, 8, [120, 33, 128, 9], f"{w} window", dtype, window=40, softcap=20.0)
        for G in range(1, 17):
            w = f"{dn} hd 40 G {G}"
            decode(mk(3, 1, 2 * G, 40, dtype=dtype), mk(3, 2, 700, 40, dtype=dtype), mk(3, 2, 700, 40, dtype=dtype),
                   T(700, 300, 1), w, starts=T(0, 300, 0))
            paged(2, 3, 2 * G, 2, 40, 16, 16, [256, 100, 1], w, dtype)

    def row(name, what, shape, err, timed, cost):
        b_ms, b_by = bound_of(cost)
        out[name]["widths"][what] = dict(shape=shape, max_abs_err=err, **timed, bound_ms=b_ms, bound_by=b_by)
        log(f"  [widths] {name} {what}: {json.dumps(out[name]['widths'][what])}")

    def flash_timed(what, B, S, H, KVH, hd, dtype):
        q, k, v = mk(B, S, H, hd, dtype=dtype), mk(B, S, KVH, hd, dtype=dtype), mk(B, S, KVH, hd, dtype=dtype)
        err = flash(q, k, v, f"{what} timed", causal=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        t = timings(lambda: fl.flash_attention(q, k, v, causal=True),
                    lambda: fl.flash_attention_plain(q, k, v, causal=True),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), plain_iters=5)
        row("flash_attention", what, {"q": list(q.shape), "kv": list(k.shape), "dtype": str(dtype)}, err, t,
            fl.cost(q, k, v, causal=True))

    def decode_timed(what, B, H, KVH, S, cur, hd, dtype):
        q, kc, vc = mk(B, 1, H, hd, dtype=dtype), mk(B, KVH, S, hd, dtype=dtype), mk(B, KVH, S, hd, dtype=dtype)
        err = decode(q, kc, vc, cur, f"{what} timed")
        qt, ks, vs = q.transpose(1, 2), kc[:, :, :cur], vc[:, :, :cur]
        t = timings(lambda: dec.decode_attention_bksd(q, kc, vc, cur), lambda: dec.decode_attention_plain(q, kc, vc, cur),
                    lambda: F.scaled_dot_product_attention(qt, ks, vs, enable_gqa=True))
        row("decode_attention", what, {"q": list(q.shape), "cache": list(kc.shape), "cur_len": cur, "dtype": str(dtype)},
            err, t, dec.cost(q, kc, vc, cur))

    def paged_timed(what, E, B, H, KVH, hd, ps, n_pg, seed, dtype):
        cur_l = torch.randint(1, n_pg * ps + 1, (B,), generator=torch.Generator().manual_seed(seed)).tolist()
        q, kp, vp, pages, cur_t, err = paged(E, B, H, KVH, hd, ps, n_pg, cur_l, f"{what} timed", dtype)
        visible = E * sum(cur_l)
        idx = pool_row_index(pages, E, kp.shape[1]).clamp(min=0).long()
        S = n_pg * ps
        valid = (torch.arange(S, device=dev)[None, :] < cur_t.repeat(E)[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)

        def library():
            kv, vv = (t.reshape(-1, KVH, ps, hd).index_select(0, idx).reshape(E * B, n_pg, KVH, ps, hd)
                      .transpose(1, 2).reshape(E * B, KVH, S, hd) for t in (kp, vp))
            return F.scaled_dot_product_attention(qt, kv, vv, attn_mask=valid, enable_gqa=True)

        t = timings(lambda: dec.decode_attention_paged(q, kp, vp, pages, cur_t),
                    lambda: dec.decode_attention_paged_plain(q, kp, vp, pages, cur_t), library)
        row("decode_attention_paged", what, {"q": list(q.shape), "pool": list(kp.shape), "pages": list(pages.shape),
                                             "cur_len": cur_l, "dtype": str(dtype)}, err, t,
            dec.paged_cost(q, kp, vp, pages, cur_t))

    for what, (B, S, H, KVH, hd) in EXAMPLE_FLASH.items():
        flash_timed(f"bf16 {what}", B, S, H, KVH, hd, torch.bfloat16)
    flash_timed("f32 hd128", 96, 256, 16, 2, 128, torch.float32)  # qwen2.5-3b tier 1 classify prefill
    decode_timed("bf16 hd32", 8, 4, 4, 40, 39, 32, torch.bfloat16)  # edge_to_cloud's cloud tier, a generate step
    decode_timed("f32 hd128", 24, 16, 2, 144, 143, 128, torch.float32)  # qwen2.5-3b tier 1 generate step
    for what, (E, B, H, KVH, hd) in EXAMPLE_PAGED.items():
        paged_timed(f"bf16 {what}", E, B, H, KVH, hd, 16, 2, hd, torch.bfloat16)
    paged_timed("f32 hd128", 3, 8, 16, 2, 128, 16, 32, 0, torch.float32)  # tier 1's serve decode
    return out


# The inputs the reference's kernels take past the port's earlier routes:
# hd 129-256 (the 256-wide bodies), hd off the multiples of 8 (zero-padded
# by the wrappers in 16 bits), hd past 256 (attend_any), G 32 and 71 (the
# heads in tiles of 16), in bf16, f16 and f32: (hd, H, KVH)
WIDE_ATTN = ((256, 8, 2), (200, 4, 2), (100, 6, 2), (20, 4, 1), (3, 2, 1), (300, 4, 2), (64, 32, 1), (64, 71, 1))
WIDE_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def check_wide_routes(dev, g):
    """The routes this slice added, against their plain versions: flash,
    dense and paged decode at every ``WIDE_ATTN`` shape in every
    ``WIDE_DTYPES`` type (the cases of ``check_attention_widths``), the SSD
    on the dual form at N 128 and P 128 and on the run-time (P, N) scan in
    both types, WKV6 on the run-time-D scan at D 128 and 48.  Timed: flash
    at hd 256 (Gemma 2 9B's 16 heads on 8) in bf16 and at hd 128 in f16
    (cell 1's classify prefill), against SDPA at the same shape and type;
    decode at G 32 and 64 against SDPA; the SSD at N 128 (mamba2-2.7b's 80
    heads of 64 at d_state 128 over 32 x 256 prompts) and WKV6 at D 128
    against their bounds.  Draws from its own generator.  Returns {kernel
    name: {"max_abs_err", "routes": {route: row}}}."""
    import torch.nn.functional as F

    from repro_torch.kernels.compaction.ops import gather_rows_plain
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.mamba2_ssd import ops as ssd
    from repro_torch.kernels.rwkv6_wkv import ops as wkv

    out = {n: {"max_abs_err": 0.0, "routes": {}} for n in
           ("flash_attention", "decode_attention", "decode_attention_paged", "mamba2_ssd", "rwkv6_wkv")}
    T = lambda *xs: torch.tensor(xs, dtype=torch.int32, device=dev)  # noqa: E731
    mk = lambda *s, dtype=torch.bfloat16: torch.randn(*s, device=dev, generator=g).to(dtype)  # noqa: E731

    def held(name, got, ref, what):
        require(got.dtype == ref.dtype and got.shape == ref.shape, f"{name} {what}: {got.dtype} {tuple(got.shape)} "
                f"against the plain version's {ref.dtype} {tuple(ref.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        if got.dtype == torch.float32:
            e32 = normwise_err(got, ref)
            require(math.isfinite(e32) and e32 <= F32_ATTN_TOL, f"{name} {what}: f32 normwise err {e32} > {F32_ATTN_TOL}")
        else:
            tol = FLASH_TOL if name == "flash_attention" else DECODE_TOL
            require(math.isfinite(err) and err <= tol, f"{name} {what}: err {err} > {tol}")
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        return err

    def flash(q, k, v, what, **kw):
        return held("flash_attention", fl.flash_attention(q, k, v, **kw), fl.flash_attention_plain(q, k, v, **kw), what)

    def decode(q, kc, vc, cur, what, **kw):
        return held("decode_attention", dec.decode_attention_bksd(q, kc, vc, cur, **kw),
                    dec.decode_attention_plain(q, kc, vc, cur, **kw), what)

    def paged(E, B, H, KVH, hd, ps, n_pg, cur, what, dtype, holes=(), **kw):
        P = B * n_pg + 1
        q, kp, vp = mk(E * B, 1, H, hd, dtype=dtype), mk(E, P, KVH, ps, hd, dtype=dtype), mk(E, P, KVH, ps, hd, dtype=dtype)
        pages, cur_t = shuffled_table(cur, n_pg, ps, P, holes, dev=dev, g=g), T(*cur)
        got = dec.decode_attention_paged(q, kp, vp, pages, cur_t, **kw)
        held("decode_attention_paged", got, dec.decode_attention_paged_plain(q, kp, vp, pages, cur_t, **kw), what)
        kv, vv = (dec.paged_pool_view(t, pages, gather_rows_plain) for t in (kp, vp))
        require(torch.equal(got, dec.decode_attention_bksd(q, kv, vv, cur_t.repeat(E), **kw)),
                f"paged decode {what} is not bitwise the dense kernel on the gathered view")

    for dtype in WIDE_DTYPES:
        dn = str(dtype).split(".")[-1]
        for hd, H, KVH in WIDE_ATTN:
            w = f"{dn} hd {hd} G {H // KVH}"
            flash(mk(2, 200, H, hd, dtype=dtype), mk(2, 200, KVH, hd, dtype=dtype), mk(2, 200, KVH, hd, dtype=dtype),
                  f"{w} causal", causal=True, starts=T(0, 37))
            flash(mk(2, 77, H, hd, dtype=dtype), mk(2, 150, KVH, hd, dtype=dtype), mk(2, 150, KVH, hd, dtype=dtype),
                  f"{w} window softcap", causal=False, window=40, softcap=20.0)
            S = 600
            q, kc, vc = mk(3, 1, H, hd, dtype=dtype), mk(3, KVH, S, hd, dtype=dtype), mk(3, KVH, S, hd, dtype=dtype)
            decode(q, kc, vc, T(1, 300, S), f"{w} cur_len")
            decode(q, kc, vc, T(S, 129, 1), f"{w} starts", starts=T(S - 1, 128, 1))
            decode(q, kc, vc, T(513, S, 65), f"{w} window softcap", window=200, softcap=20.0)
            paged(2, 3, H, KVH, hd, 16, 8, [100, 5, 128], f"{w} holes", dtype, holes=[(0, 2), (2, 7)])
            paged(1, 4, H, KVH, hd, 16, 8, [120, 33, 128, 9], f"{w} window", dtype, window=40, softcap=20.0)

    def row(name, what, shape, err, timed, cost):
        b_ms, b_by = bound_of(cost)
        out[name]["routes"][what] = dict(shape=shape, max_abs_err=err, **timed, bound_ms=b_ms, bound_by=b_by)
        log(f"  [wide] {name} {what}: {json.dumps(out[name]['routes'][what])}")

    def flash_timed(what, B, S, H, KVH, hd, dtype):
        q, k, v = mk(B, S, H, hd, dtype=dtype), mk(B, S, KVH, hd, dtype=dtype), mk(B, S, KVH, hd, dtype=dtype)
        err = flash(q, k, v, f"{what} timed", causal=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        t = timings(lambda: fl.flash_attention(q, k, v, causal=True),
                    lambda: fl.flash_attention_plain(q, k, v, causal=True),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), plain_iters=5)
        row("flash_attention", what, {"q": list(q.shape), "kv": list(k.shape), "dtype": str(dtype)}, err, t,
            fl.cost(q, k, v, causal=True))

    def decode_timed(what, B, H, KVH, S, cur, hd, dtype):
        q, kc, vc = mk(B, 1, H, hd, dtype=dtype), mk(B, KVH, S, hd, dtype=dtype), mk(B, KVH, S, hd, dtype=dtype)
        err = decode(q, kc, vc, cur, f"{what} timed")
        qt, ks, vs = q.transpose(1, 2), kc[:, :, :cur], vc[:, :, :cur]
        t = timings(lambda: dec.decode_attention_bksd(q, kc, vc, cur), lambda: dec.decode_attention_plain(q, kc, vc, cur),
                    lambda: F.scaled_dot_product_attention(qt, ks, vs, enable_gqa=True))
        row("decode_attention", what, {"q": list(q.shape), "cache": list(kc.shape), "cur_len": cur, "dtype": str(dtype)},
            err, t, dec.cost(q, kc, vc, cur))

    flash_timed("bf16 hd256", 4, 1024, 16, 8, 256, torch.bfloat16)
    flash_timed("f16 hd128", 96, 256, 16, 2, 128, torch.float16)
    decode_timed("bf16 G32", 8, 32, 1, 2048, 2047, 128, torch.bfloat16)
    decode_timed("bf16 G64", 8, 64, 1, 2048, 2047, 128, torch.bfloat16)

    def scan_inputs(shape, dtype, scan):
        if scan == "ssd":
            B, S, H, P, G, N = shape
            x = mk(B, S, H, P, dtype=dtype)
            Bm, Cm = (torch.randn(B, S, G, N, device=dev, generator=g).mul(0.5).to(dtype) for _ in range(2))
            dt = F.softplus(torch.randn(B, S, H, device=dev, generator=g) - 2.0)
            A = -torch.exp(torch.randn(H, device=dev, generator=g) * 0.3)
            s0 = torch.randn(B, H, N, P, device=dev, generator=g).mul(0.2)
            return (x, dt, A, Bm, Cm), s0, ssd
        B, S, H, D = shape
        r, k, v = (mk(B, S, H, D, dtype=dtype) for _ in range(3))
        logw = -torch.exp(torch.randn(B, S, H, D, device=dev, generator=g) * 0.5 - 2.0)
        u = torch.randn(H, D, device=dev, generator=g).mul(0.5)
        s0 = torch.randn(B, H, D, D, device=dev, generator=g).mul(0.1)
        return (r, k, v, logw, u), s0, wkv

    def scan(name, what, shape, dtype, timed=False):
        kind = "ssd" if name == "mamba2_ssd" else "wkv6"
        args, s0, mod = scan_inputs(shape, dtype, kind)
        fn = mod.ssd if kind == "ssd" else mod.wkv6
        plain = mod.ssd_plain if kind == "ssd" else mod.wkv6_plain
        got = fn(*args, initial_state=s0, return_final_state=True)
        ey, es, err = check_scan(f"{name} {what}", got, plain(*args, initial_state=s0))
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        if timed:
            t = timings(lambda: fn(*args, initial_state=s0, return_final_state=True),
                        lambda: plain(*args, initial_state=s0), None, plain_iters=3)
            row(name, what, {"x": list(args[0].shape), "dtype": str(dtype), "normwise_err": ey, "state_normwise_err": es},
                err, t, mod.cost(*args, initial_state=s0))

    # (B, S, H, P, G, N): the dual form at N 128 (P 64 and 128, in blocks of
    # 64 columns; P 96 in blocks of 32), the run-time scan in bf16 and f32
    scan("mamba2_ssd", "bf16 dual P64 N128", (2, 300, 4, 64, 1, 128), torch.bfloat16)
    scan("mamba2_ssd", "bf16 dual P128 N128", (2, 200, 4, 128, 2, 128), torch.bfloat16)
    scan("mamba2_ssd", "bf16 dual P96 N32", (2, 100, 4, 96, 2, 32), torch.bfloat16)
    scan("mamba2_ssd", "bf16 scan P48 N24", (2, 77, 4, 48, 2, 24), torch.bfloat16)
    scan("mamba2_ssd", "f32 scan P64 N128", (2, 100, 2, 64, 1, 128), torch.float32)
    scan("mamba2_ssd", "f32 scan P200 N16", (2, 50, 2, 200, 1, 16), torch.float32)
    scan("mamba2_ssd", "bf16 dual N128 classify", (32, 256, 80, 64, 1, 128), torch.bfloat16, timed=True)
    # (B, S, H, D): the run-time-D scan
    scan("rwkv6_wkv", "bf16 D48", (3, 77, 4, 48), torch.bfloat16)
    scan("rwkv6_wkv", "f32 D128", (2, 50, 2, 128), torch.float32)
    scan("rwkv6_wkv", "bf16 D128 decode", (8, 1, 32, 128), torch.bfloat16)
    scan("rwkv6_wkv", "bf16 D128 prefill", (8, 256, 32, 128), torch.bfloat16, timed=True)
    return out


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
        # bytes the kernel reads and writes: x, B, C in their own dtype, dt f32
        # (the prescale is fused); the dual form on TF32 tensor cores in
        # bf16, the per-step form on the f32 cores in f32
        b_ms, b_by = bound_of(ops.cost(*args, initial_state=s0))
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
        r = args[0]
        # the per-step form on the f32 cores: k v, S w + k v, r S (5 operations a state element a step)
        b_ms, b_by = bound_of(ops.cost(*args, initial_state=s0))
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
# (~1e-6 a layer).  It separates rounding from a fault.  zamba2 runs its
# Mamba2 backbone alone and whole (the shared attention through the f32
# route of flash and decode), and the dense qwen2.5-3b the same way, whose
# random dense blocks grow their input's difference about tenfold a layer
# (as the bf16 runs above show): held at F32_DENSE_TOL.
F32_TOL = 1e-4
F32_DENSE_TOL = 1e-3


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
    end to end in float32 at F32_TOL (and zamba2 whole, and qwen2.5-3b at
    F32_DENSE_TOL, whose attention takes the kernels' f32 route)."""
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
    for arch, k, family, tol in (("zamba2-2.7b", 3, "ssm_mamba2", F32_TOL), ("rwkv6-7b", 1, "ssm_rwkv6", F32_TOL),
                                 ("zamba2-2.7b", 3, "hybrid", F32_TOL), ("qwen2.5-3b", 3, "dense", F32_DENSE_TOL)):
        cfg = dataclasses.replace(get_config(arch).reduced(), family=family, dtype="float32")
        e2e = recurrent_end_to_end(cfg, k, dev, seed, tol)[2]
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
# the families that join with the MoE, VLM and encoder slice (phases 3 and 4)
# ---------------------------------------------------------------------------


def attention_layer_by_layer(cfg, vals, gvals, dev, x, cache=None, pos=None):
    """Walk an attention stack on the CPU from hidden x (E, B, S, D), a
    prefill, or with ``cache`` (CPU member cache, updated in place) one
    decode step at ``pos``; feed each layer's CPU input (and its cache) to
    the same layer on the card and hold its output and written K/V against
    the CPU's at REF_TOL.  On one input the f32 router sees the same bf16
    activations on both devices, so the MoE routes alike but at exact
    ties; end to end a bf16 difference upstream can move a near tie between
    two experts, and a token's whole output with it.  The VLM's projected
    patches are some 50 times its token embeddings, so the text positions
    carry the prefix's rounding (bf16 P in flash against the plain f32
    softmax) into every later layer: end to end its logits read 0.14 of
    their largest apart on an H100 80GB HBM3 at 700 W, where CPU bf16 against CPU f32
    already reads 0.24 on this random model.  Returns (worst normwise
    error, final CPU hidden)."""
    from repro_torch.models import api
    from repro_torch.models import blocks_dense as BD

    worst = 0.0
    for l in range(cfg.n_layers):
        lp, glp = api._layer(vals, l, cfg), api._layer(gvals, l, cfg)
        gx = x.to(dev)
        if cache is None:
            causal = not cfg.is_encoder
            y = BD.dense_layer_fwd(lp, x, cfg, causal=causal, sliding_window=cfg.sliding_window)[0]
            gy = BD.dense_layer_fwd(glp, gx, cfg, causal=causal, sliding_window=cfg.sliding_window)[0]
        else:
            kc, vc = cache["k"][l], cache["v"][l]
            gk, gv = kc.to(dev), vc.to(dev)
            y = BD.dense_layer_decode(lp, x, cfg, kc, vc, pos, sliding_window=cfg.sliding_window)
            gy = BD.dense_layer_decode(glp, gx, cfg, gk, gv, pos, sliding_window=cfg.sliding_window)
            worst = max(worst, normwise(kc, gk, f"{cfg.name} layer {l} k card vs cpu, same input"),
                        normwise(vc, gv, f"{cfg.name} layer {l} v card vs cpu, same input"))
        worst = max(worst, normwise(y, gy, f"{cfg.name} layer {l} card vs cpu, same input"))
        x = y
    return worst, x


def serve_graphed_on_card(cfg, vals, dev, seed, what):
    """A one-tier k-member cascade at reduced width: ``serve_continuous``
    eager, then graphed twice over block-paged pools (the second run must
    capture nothing), and graphed over the dense slot cache: every run the
    same tokens, tiers and truncation flags, the graphed runs the eager
    run's launches per kernel."""
    import copy

    from repro_torch import kernels
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeServer, CascadeTier, ServeConfig
    from repro_torch.serve.graphs import trace_counts

    k = ens.member_count(vals)
    server = CascadeServer([CascadeTier(cfg, vals, TierSpec("t", "vote", 0.5, k=k), device=dev)], device=dev)
    reqs = serve_requests(np.random.default_rng(seed), 10, cfg.vocab_size, 4, 60, 6, n_prefix=3, prefix_len=20)
    runs, launches = {}, {}
    modes = [(True, True), (True, False), (True, False), (False, False)]  # (paged, eager)
    for i, (paged, eager) in enumerate(modes):
        run = [copy.deepcopy(r) for r in reqs]
        counts = trace_counts()
        kernels.reset_launch_counts()
        done = server.serve_continuous(run, ServeConfig(n_slots=4, max_seq=128, page_size=16, paged=paged), eager=eager)
        launches[i] = kernels.launch_counts()
        require(sorted(r.rid for r in done) == sorted(r.rid for r in reqs), f"{what}: requests lost or doubled")
        runs[i] = {r.rid: (r.tier, r.truncated, r.output.tolist()) for r in done}
        if i == 2:
            require(trace_counts() == counts, f"{what}: the second graphed paged serve_continuous captured again")
    for i in runs:
        require(runs[i] == runs[0], f"{what}: serve_continuous (paged, eager) {modes[i]} emits other tokens than eager")
    require(launches[1] == launches[0] == launches[2], f"{what}: graphed launches {launches[1]} != eager {launches[0]}")
    require(launches[0]["decode_attention_paged"] > 0, f"{what}: the paged decode kernel was not launched")
    return {"requests": len(reqs), "runs_equal": [f"paged={p} eager={e}" for p, e in modes],
            "outputs_digest": outputs_digest(*(np.asarray(runs[0][r.rid][2]) for r in reqs)), "launches": launches[1]}


def check_families_on_card(dev, seed):
    """The six configurations of the MoE, VLM and encoder slice at reduced
    width, card against CPU on the same bf16 weights.  olmo-1b (k=3) and
    command-r-plus-104b (G 12 reduced to the group of 4 heads on 1 KV head
    the reduction gives) end to end at REF_TOL: a left-padded prefill and a
    decode step, then a paged chunk into one slot and a paged decode step.
    hubert-xlarge (k=3, non-causal over frames), internvl2-26b (k=1, with its
    vision prefix), mixtral-8x22b (k=2) and llama4-maverick-400b-a17b (k=1,
    its reduction: one dense and one MoE layer with the shared expert)
    layer by layer on the CPU's inputs at REF_TOL
    (``attention_layer_by_layer``: prefill, then a decode step but for the
    encoder), with prefill == forward on the card and end to end printed; then
    ``serve_graphed_on_card`` for the two MoE configs (paged graphed ==
    eager, paged == dense)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.models import api
    from repro_torch.models import layers as L
    from repro_torch.models.params import tree_map
    from repro_torch.serve.engine import grow_cache

    errs = {}
    rng = np.random.default_rng(seed + 3)

    def pair(arch, k):
        cfg = get_config(arch).reduced()
        vals = ens.init_ensemble(cfg, k, torch.Generator().manual_seed(seed), "cpu")
        return cfg, vals, tree_map(lambda t: t.to(dev), vals)

    for arch, k in (("olmo-1b", 3), ("command-r-plus-104b", 1)):
        cfg, vals, gvals = pair(arch, k)
        toks = rng.integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
        batch = {"tokens": toks, "starts": np.array([0, 3, 17, 39], np.int32)}
        outs = []
        for v in (vals, gvals):
            logits, cache = ens.ensemble_prefill(v, batch, cfg)
            tok = torch.as_tensor(np.full((k, 4, 1), 7, np.int32), device=logits.device)
            step, _ = api.decode_step_members(v, tok, grow_cache(cache, 2, cfg), 40, cfg, starts=batch["starts"])
            outs.append((logits, step))
        errs[f"{arch}/prefill"] = normwise(outs[0][0], outs[1][0], f"{arch} prefill card vs cpu")
        errs[f"{arch}/decode"] = normwise(outs[0][1], outs[1][1], f"{arch} decode card vs cpu")
        errs.update(check_reference_paged(arch, cfg, k, vals, gvals, seed))

    # the VLM with its prefix: layer by layer on the CPU's inputs (see
    # attention_layer_by_layer), the head over the text positions, then a
    # decode step over the prefix's and the text's cache rows; end to end
    # printed, and prefill == forward on the card
    cfg, vals, gvals = pair("internvl2-26b", 1)
    text = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    patches = torch.randn(2, cfg.n_vision_tokens, cfg.frontend_dim, generator=torch.Generator().manual_seed(seed))
    batch = {"tokens": text, "embeds": patches.to(torch.bfloat16)}
    gbatch = {"tokens": text, "embeds": patches.to(dev, torch.bfloat16)}
    head = lambda x: (L.project_logits(vals, x, cfg), L.project_logits(gvals, x.to(dev), cfg))  # noqa: E731
    worst, x = attention_layer_by_layer(cfg, vals, gvals, dev, api.embed_batch(vals, batch, cfg))
    worst = max(worst, normwise(*head(x[:, :, cfg.n_vision_tokens:]), "internvl2-26b text head card vs cpu"))
    _, cache = ens.ensemble_prefill(vals, batch, cfg)
    S = cache["k"].shape[4]
    require(S == cfg.n_vision_tokens + 24, f"internvl2: {S} cache rows for a {cfg.n_vision_tokens}-patch prefix")
    tok = api.embed_inputs(vals, torch.full((1, 2, 1), 5, dtype=torch.int64))
    w, x = attention_layer_by_layer(cfg, vals, gvals, dev, tok, grow_cache(cache, 1, cfg), pos=S)
    worst = max(worst, w, normwise(*head(x[:, :, 0]), "internvl2-26b decode head card vs cpu"))
    errs["internvl2-26b/layer_by_layer_worst"] = worst
    g_fwd = api.forward_logits_members(gvals, gbatch, cfg)
    require(g_fwd.shape[2] == 24, f"internvl2: logits {tuple(g_fwd.shape)} cover more than the text")
    g_pre = ens.ensemble_last_logits(gvals, gbatch, cfg)
    errs["internvl2-26b/prefill_vs_forward_on_card"] = normwise(g_fwd[:, :, -1], g_pre, "internvl2-26b prefill vs forward")
    c_fwd = api.forward_logits_members(vals, batch, cfg)
    errs["internvl2-26b/end_to_end_forward"] = ((c_fwd - g_fwd.cpu()).abs().max() / c_fwd.abs().max()).item()

    # the encoder over frames: layer by layer (its CPU bf16 run reads 0.05
    # from its f32 one; end to end an H100 80GB HBM3 at 700 W read 0.044), the
    # head at the last frame, end to end printed
    cfg, vals, gvals = pair("hubert-xlarge", 3)
    frames = torch.randn(3, 50, cfg.frontend_dim, generator=torch.Generator().manual_seed(seed + 1))
    batch = {"embeds": frames.to(torch.bfloat16)}
    head = lambda x: (L.project_logits(vals, x, cfg), L.project_logits(gvals, x.to(dev), cfg))  # noqa: E731
    worst, x = attention_layer_by_layer(cfg, vals, gvals, dev, api.embed_batch(vals, batch, cfg))
    errs["hubert-xlarge/layer_by_layer_worst"] = max(worst, normwise(*head(x[:, :, -1]), "hubert-xlarge head card vs cpu"))
    a = ens.ensemble_last_logits(vals, batch, cfg)
    b = ens.ensemble_last_logits(gvals, {"embeds": frames.to(dev, torch.bfloat16)}, cfg)
    errs["hubert-xlarge/end_to_end_last_logits"] = ((a - b.cpu()).abs().max() / a.abs().max()).item()

    for arch, k in (("mixtral-8x22b", 2), ("llama4-maverick-400b-a17b", 1)):
        cfg, vals, gvals = pair(arch, k)
        toks = rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
        embed = lambda t, v=vals: api.embed_inputs(v, torch.as_tensor(t).to(torch.int64))  # noqa: E731
        head = lambda x, v=vals, gv=gvals: (L.project_logits(v, x, cfg), L.project_logits(gv, x.to(dev), cfg))  # noqa: E731
        worst, x = attention_layer_by_layer(cfg, vals, gvals, dev, embed(toks))
        worst = max(worst, normwise(*head(x[:, :, -1]), f"{arch} prefill head card vs cpu"))
        _, cache = ens.ensemble_prefill(vals, {"tokens": toks}, cfg)
        tok = np.full((k, 3, 1), 9, np.int32)
        w, x = attention_layer_by_layer(cfg, vals, gvals, dev, embed(tok), grow_cache(cache, 1, cfg), pos=40)
        worst = max(worst, w, normwise(*head(x[:, :, 0]), f"{arch} decode head card vs cpu"))
        errs[f"{arch}/layer_by_layer_worst"] = worst
        # on the card: prefill's last logits == the forward's; end to end printed
        g_pre = ens.ensemble_last_logits(gvals, {"tokens": toks}, cfg)
        g_fwd = ens.ensemble_logits(gvals, {"tokens": toks}, cfg)[:, :, -1]
        errs[f"{arch}/prefill_vs_forward_on_card"] = normwise(g_pre, g_fwd, f"{arch} prefill vs forward on the card")
        c_pre = ens.ensemble_last_logits(vals, {"tokens": toks}, cfg)
        errs[f"{arch}/end_to_end_prefill"] = ((c_pre - g_pre.cpu()).abs().max() / c_pre.abs().max()).item()
        errs[f"{arch}/serve"] = serve_graphed_on_card(cfg, gvals, dev, seed, f"{arch} reduced")
    return errs


# ---------------------------------------------------------------------------
# speculative deferral and open-loop serving (phases 3 and 4)
# ---------------------------------------------------------------------------

# the verify chunk against the decode steps, normwise (max abs difference
# over max abs), layer by layer: each layer of tier 2 fed the decode route's
# own input and cache, once through decode steps and once through verify
# chunks (the same bf16 weights through the decode kernel and through the
# chunk attention, rounding at other places).  End to end the two routes
# are not held: a random-weight model amplifies a layer's rounding
# difference several times a layer, so at 36 layers the logits share
# little but their scale (``route_error_by_depth`` prints the growth)
SPEC_LAYER_TOL = REF_TOL
# the bench's open-loop trace (benchmarks/bench_serving.py): 80 arrivals,
# on/off at 300 and 2 q/s, dwell 0.5 s, SLO 0.3 s, 0.01 s of virtual time a
# sweep; phase 4 draws the main path's prompt lengths
OPEN_LOOP_TRACE = dict(rate_lo_qps=2.0, rate_hi_qps=300.0, n_requests=80, seed=7, mean_on_s=0.5,
                       mean_off_s=0.5, max_new_tokens=(2, 5))
OPEN_LOOP_RUN = dict(slo_s=0.3, step_time_s=0.01)
OPEN_LOOP_CONTROLLER_INTERVAL_S = 0.1


def drafting_server(dev, c1, v1, c2, v2, temperature=0.0):
    """The speculative fixture: tier 1 ``v1`` (members [m0, m0, m2]) under
    vote_preds 0.8, so the m0 pair's 2-of-3 vote defers with m0's
    generation as the draft, and tier 2 ``v2`` (one member) answering."""
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeServer, CascadeTier

    return CascadeServer([
        CascadeTier(c1, v1, TierSpec(f"{c1.name} [m0, m0, m2]", "vote_preds", 0.8, k=3, cost=3.0),
                    temperature=temperature, device=dev),
        CascadeTier(c2, v2, TierSpec(f"{c2.name} [m0]", "vote_preds", 0.0, k=1, cost=1.0),
                    temperature=temperature, device=dev),
    ], device=dev)


def tier2_keys(tracer, seed, reqs):
    """Submission index -> tier 2's slot key of each request in a run of
    ``reqs`` traced by ``tracer``: the key ``TierBackend.begin_slot`` set at
    the request's admission there, ``fold_in(base_key(seed + 1), admission
    sequence)``."""
    from repro_torch.serve import sampling

    order = [e["tid"] for e in tracer.events
             if e.get("ph") == "B" and e["name"] == "admit" and e["args"].get("stream") == "slot_stream.tier1"]
    base, index = sampling.base_key(seed + 1), {q.rid: i for i, q in enumerate(reqs)}
    return {index[rid]: sampling.fold_in(base, n + 1) for n, rid in enumerate(order)}


class verify_passes:
    """Inside it, every verify pass a run makes (``TierBackend.verify_draft``)
    is recorded: the request (tagged by the stream's accept hook, which
    runs right after the pass), the chunk fed, its start and the choices
    the program returned.  With ``hold`` each pass is also replayed eagerly
    through ``ensemble_prefill_into_slot[_paged]_logits`` and
    ``verify_choices`` on a copy of the slot memory, with the same table
    row (or slot), start and slot key, taken just before it: the choices
    (every layer, the final norm, the projection and the draw) and the
    whole pool or cache the pass wrote must equal the program's bitwise.
    The eager replay's kernel launches are taken back out of the
    counters."""

    def __init__(self, hold=False):
        self.hold, self.calls, self.held = hold, [], 0

    def __enter__(self):
        from repro_torch.models.params import tree_map
        from repro_torch.serve import TierBackend
        from repro_torch.serve.cascade_server import _CascadeRun

        self._verify, self._recorder, rec = TierBackend.verify_draft, _CascadeRun._accept_recorder, self

        def verify_draft(backend, tokens, slot, start, max_chunk):
            snap = None
            if rec.hold:
                row = backend.pool.table[slot] if backend.paged else np.array([slot], np.int64)
                snap = (tree_map(torch.clone, backend.mem.state), np.array(row), int(backend.slot_keys[slot]))
            choices = rec._verify(backend, tokens, slot, start, max_chunk)
            if snap is not None:
                rec._hold(backend, tokens, start, max_chunk, snap, choices)
            rec.calls.append(dict(tokens=np.array(tokens), start=int(start), choices=np.array(choices)))
            return choices

        def accept_recorder(h):
            hook = rec._recorder(h)

            def tagged(r, n_acc, n_draft):
                rec.calls[-1].update(rid=r.rid, n_acc=n_acc)
                hook(r, n_acc, n_draft)

            return tagged

        TierBackend.verify_draft, _CascadeRun._accept_recorder = verify_draft, staticmethod(accept_recorder)
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import TierBackend
        from repro_torch.serve.cascade_server import _CascadeRun

        TierBackend.verify_draft, _CascadeRun._accept_recorder = self._verify, staticmethod(self._recorder)

    def _hold(self, backend, tokens, start, max_chunk, snap, choices):
        from repro_torch import kernels
        from repro_torch.core import ensemble as ens
        from repro_torch.core.cascade import prompt_chunks
        from repro_torch.kernels import build
        from repro_torch.serve.speculative import verify_choices

        state, row, key = snap
        tier, dev = backend.tier, backend.tier.device
        fn = ens.ensemble_prefill_into_slot_paged_logits if backend.paged else ens.ensemble_prefill_into_slot_logits
        counts = kernels.launch_counts()
        staged = lambda a: torch.as_tensor(a).to(dev)  # as ``GraphSet.run`` stages an input
        outs, off = [], 0
        for c in prompt_chunks(len(tokens), max_chunk):
            at, k = staged(np.array([start + off], np.int64)), staged(np.array([key], np.int64))
            logits, state = fn(tier.values, staged(tokens[off: off + c]), state, staged(row), at, tier.cfg)
            outs.append(verify_choices(logits, k, at, float(tier.temperature)))
            off += c
        ref = torch.cat(outs, 1).cpu().numpy()
        same_memory = all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(backend.mem.state)))
        kernels.reset_launch_counts()
        for kname, n in counts.items():
            build.launch_counter(kname).add(n)
        require(np.array_equal(ref, choices), f"verify pass at {start}: the program's choices differ from the "
                                              f"eager route's on the same memory: {choices} vs {ref}")
        require(same_memory, f"verify pass at {start}: the program's pool or cache differs from the eager route's")
        self.held += 1


def leaves(tree):
    return [t for v in tree.values() for t in leaves(v)] if isinstance(tree, dict) else [tree]


def hold_spec_to_verify(reqs, spec, passes, what):
    """Every request the run verified emits its accepted draft prefix, then
    the verify pass's choice at the first rejected position, the chunk as
    the run fed it (``spec``: submission index -> (tier, truncated,
    output); ``passes``: a ``verify_passes``)."""
    from repro_torch.serve.speculative import accepted_prefix

    index, seen = {q.rid: i for i, q in enumerate(reqs)}, set()
    for c in passes.calls:
        i = index[c["rid"]]
        require(i not in seen, f"{what}: request {i} verified twice")
        seen.add(i)
        draft, ch, out = c["tokens"][1:], c["choices"], spec[i][2]
        require(ch.shape[0] == 1 and c["start"] == len(reqs[i].tokens) - 1, f"{what}: request {i}: pass {c}")
        n_acc = accepted_prefix(ch, draft)
        expect = [int(t) for t in draft[:n_acc]] + [int(ch[0, n_acc])]
        require(n_acc == c["n_acc"] and out[: n_acc + 1] == expect,
                f"{what}: request {i} emits {out[: n_acc + 1]}, its verify pass chose {expect}")
    return dict(verified=len(seen), held_bitwise=passes.held)


def teacher_forced_logits(tier, prompt, fed, max_chunk, max_seq):
    """A tier's member logits (E, len(fed), V), f32, for the tokens ``fed``
    at positions P-1.. after ``prompt[:-1]``, replayed eagerly into a
    one-slot dense cache of ``max_seq`` rows: through decode steps (the
    plain route) and through verify chunks in the ``prompt_chunks`` buckets
    (the speculative route).  Returns (decode, verify)."""
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import prompt_chunks
    from repro_torch.models import api

    cfg, vals, dev, E, P = tier.cfg, tier.values, tier.device, tier.k, len(prompt)
    routes = []
    for route in ("decode", "verify"):
        cache = api.init_cache_members(cfg, E, 1, max_seq, dev)
        off = 0
        for c in prompt_chunks(P - 1, max_chunk):
            ens.ensemble_prefill_into_slot(vals, prompt[off: off + c], cache, 0, off, cfg)
            off += c
        rows, off = [], 0
        if route == "decode":
            for i, t in enumerate(fed):
                tok = torch.full((E, 1, 1), int(t), dtype=torch.int32, device=dev)
                rows.append(ens.ensemble_decode_step(vals, tok, cache, torch.tensor([P - 1 + i], device=dev), cfg)[0])
        else:
            for c in prompt_chunks(len(fed), max_chunk):
                rows.append(ens.ensemble_prefill_into_slot_logits(vals, fed[off: off + c], cache, 0, P - 1 + off,
                                                                  cfg)[0])
                off += c
        routes.append(torch.cat(rows, 1).float())
    return routes


def route_errors_by_layer(tier, prompt, fed, max_chunk, max_seq):
    """Normwise error of each layer's output, verify route against decode
    route, every layer fed the decode route's output of the layer before
    and a copy of the cache the prompt's chunked prefill left (``fed`` at
    positions P-1..)."""
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import prompt_chunks
    from repro_torch.models import api
    from repro_torch.models import blocks_dense as BD
    from repro_torch.models.params import tree_map

    cfg, vals, dev, E, P = tier.cfg, tier.values, tier.device, tier.k, len(prompt)
    cache = api.init_cache_members(cfg, E, 1, max_seq, dev)
    off = 0
    for c in prompt_chunks(P - 1, max_chunk):
        ens.ensemble_prefill_into_slot(vals, prompt[off: off + c], cache, 0, off, cfg)
        off += c
    x = api.embed_inputs(vals, torch.as_tensor(fed, device=dev).to(torch.int64)[None])  # (E, 1, n, D)
    slot, errs = torch.zeros(1, dtype=torch.int64, device=dev), []
    for l in range(cfg.n_layers):
        lp = tree_map(lambda t: t[:, l], vals["layers"])
        kd, vd, kv, vv = (cache[n][l].clone() for n in ("k", "v", "k", "v"))
        dec = torch.cat([BD.dense_layer_decode(lp, x[:, :, i: i + 1], cfg, kd, vd,
                                               torch.tensor([P - 1 + i], device=dev),
                                               sliding_window=cfg.sliding_window)
                         for i in range(len(fed))], 2)
        outs, off = [], 0
        for c in prompt_chunks(len(fed), max_chunk):
            outs.append(BD.dense_layer_prefill_chunk(lp, x[:, :, off: off + c], cfg, kv, vv, slot,
                                                     torch.tensor([P - 1 + off], device=dev),
                                                     sliding_window=cfg.sliding_window))
            off += c
        errs.append(((dec - torch.cat(outs, 2)).abs().max() / dec.abs().max()).item())
        x = dec
    return errs


def route_error_by_depth(tier, prompt, fed, max_chunk, max_seq, depths=(1, 2, 4, 8)):
    """The two routes' end-to-end logits error (normwise) for the tier's
    first ``depth`` layers and for all of them: how a layer's rounding
    difference grows with depth in this model."""
    from types import SimpleNamespace

    from repro_torch.models.params import tree_map

    out = {}
    for d in [d for d in depths if d < tier.cfg.n_layers] + [tier.cfg.n_layers]:
        vals = dict(tier.values, layers=tree_map(lambda t: t[:, :d], tier.values["layers"]))
        sub = SimpleNamespace(cfg=dataclasses.replace(tier.cfg, n_layers=d), values=vals, device=tier.device,
                              k=tier.k)
        dec, ver = teacher_forced_logits(sub, prompt, fed, max_chunk, max_seq)
        out[d] = ((dec - ver).abs().max() / dec.abs().max()).item()
    return out


def near_tie(tier, prompt, plain, spec, temperature, key, config):
    """Where the speculative output ``spec`` first leaves the plain output
    ``plain``: tier 2 replayed teacher-forced on the prompt and ``plain``
    through both routes (``teacher_forced_logits``); the decode route's
    top-1 - top-2 gap there and the routes' largest difference, on the
    logits (greedy) or on logits / T + g, g recomputed from the slot key
    (sampled).  A near tie: the gap is at most the difference."""
    from repro_torch.serve import sampling

    n = min(len(plain), len(spec))
    j = next((i for i in range(n) if plain[i] != spec[i]), n)
    require(j < n, f"speculative output {spec} and plain {plain} differ in length only")
    fed = np.concatenate([prompt[-1:], plain[:j]]).astype(np.int32)
    dec, ver = (x[:, -1] for x in teacher_forced_logits(tier, prompt, fed, config.max_chunk, config.max_seq))
    if temperature > 0:
        at = torch.tensor([len(prompt) - 1 + j], device=dec.device)
        g = sampling.gumbel(sampling.draw_bits(torch.tensor([key], device=dec.device), at, tier.k, dec.shape[-1]))
        dec, ver = dec / temperature + g[:, 0], ver / temperature + g[:, 0]
    top = dec.topk(2, dim=-1).values
    gap, diff = (top[:, 0] - top[:, 1]).min().item(), (dec - ver).abs().max().item()
    return dict(position=j, plain_token=int(plain[j]), spec_token=int(spec[j]),
                decode_replay_token=int(dec[0].argmax()), verify_replay_token=int(ver[0].argmax()),
                gap=gap, route_diff=diff, near_tie=gap <= diff)


def hold_spec_to_plain(tier2, reqs, plain, spec, temperature, keys, config, what, *, gate=True, show=None):
    """Speculative == plain request by request (``plain``, ``spec``:
    submission index -> (tier, truncated, output); ``keys`` index -> tier
    2's slot key); every request that differs must be answered by tier 2 in
    both runs.  Where it first differs ``near_tie`` replays both routes
    (for the first ``show`` differing requests, all when None); with
    ``gate`` each difference must be a near tie.  Where the routes diverge
    over depth (published width, random weights) their difference spans
    the vocabulary and the rule cannot fail, so there it is printed only."""
    checks, differing = [], 0
    for i, r in enumerate(reqs):
        p, s = plain[i], spec[i]
        if p == s:
            continue
        require(p[0] == s[0] == 1, f"{what}: request {i} answered by tier {p[0]} plain, {s[0]} speculative")
        differing += 1
        if show is not None and len(checks) >= show:
            continue
        c = dict(request=i, **near_tie(tier2, r.tokens, p[2], s[2], temperature, keys.get(i), config))
        log(f"{what}: request {i} differs: {json.dumps(c)}")
        if gate:
            require(c["near_tie"], f"{what}: request {i} leaves the plain output at position {c['position']}, "
                                   f"where the decode route's gap {c['gap']} exceeds the routes' difference "
                                   f"{c['route_diff']}")
        checks.append(c)
    return dict(requests=len(reqs), differing=differing, differences=checks)


def spec_stats(stats):
    return {k: stats[k] for k in ("admitted", "decode_tokens", "spec_drafts", "spec_draft_tokens",
                                  "spec_accepted_tokens")}


def check_speculative_on_card(dev, seed):
    """Speculative deferral at reduced width on the card: qwen2.5-3b, tier 1
    [m0, m0, m2] under vote_preds 0.8, tier 2 [m0]; 12 requests of 4-60
    tokens (4 sharing a 20-token prefix), 6 new, 3 slots, max_seq 128;
    greedy and T = 0.8, paged and dense: the speculative run eager (the
    oracle) and graphed twice, and a plain graphed run.  Graphed == eager
    and paged == dense bitwise (tokens, tiers, flags, the spec counters),
    the second graphed run capturing nothing; speculative == plain, or each
    difference a near tie (``hold_spec_to_plain``); every run's output the
    accepted draft prefix and its verify pass's choice
    (``hold_spec_to_verify``), each pass of the second graphed run bitwise
    the eager route on a copy of its memory (``verify_passes``).  Then the
    same tier 1 over an rwkv6-7b tier 2: no verify pass, bitwise the plain
    run."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.models.params import tree_map
    from repro_torch.obs import Observability, Tracer
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.graphs import trace_counts

    cfg = get_config("qwen2.5-3b").reduced()
    vals = ens.init_ensemble(cfg, 3, torch.Generator(device=dev).manual_seed(seed), dev)
    v1 = tree_map(lambda t: torch.stack([t[0], t[0], t[2]]), vals)
    reqs = serve_requests(np.random.default_rng(seed), 12, cfg.vocab_size, 4, 60, 6, n_prefix=4, prefix_len=20)

    def serve(server, run, paged, speculative):
        tr = Tracer()
        config = ServeConfig(n_slots=3, max_seq=128, page_size=16, paged=paged, seed=seed, speculative=speculative,
                             obs=Observability(tracer=tr))
        before = trace_counts()
        with verify_passes(hold=run == "graphed_2") as passes:
            done = server.serve_continuous([copy.deepcopy(r) for r in reqs], config, eager=run == "eager")
        require(sorted(r.rid for r in done) == sorted(r.rid for r in reqs), f"speculative {run}: requests lost")
        if run == "graphed_2":
            require(trace_counts() == before, f"speculative paged={paged}: the second graphed run captured again")
        by = {r.rid: r for r in done}
        outputs = {i: (by[q.rid].tier, by[q.rid].truncated, by[q.rid].output.tolist()) for i, q in enumerate(reqs)}
        stats = spec_stats(server.last_stream_stats[1])
        verified = hold_spec_to_verify(reqs, outputs, passes, f"speculative {run} paged={paged}")
        require(verified["verified"] == stats["spec_drafts"], f"speculative {run}: {verified} against {stats}")
        return outputs, stats, tier2_keys(tr, seed, reqs), config, verified

    out = {}
    for temperature in (0.0, 0.8):
        server = drafting_server(dev, cfg, v1, cfg, tree_map(lambda t: t[0:1], vals), temperature)
        runs = {(paged, run): serve(server, run, paged, run != "plain")
                for paged in (True, False) for run in ("plain", "eager", "graphed_1", "graphed_2")}
        what = f"speculative reduced T={temperature}"
        ref = runs[True, "eager"]
        for key, got in runs.items():
            if key[1] != "plain":
                require(got[:2] == ref[:2], f"{what}: (paged, run) {key} differs from the paged eager run: "
                                            f"{got[1]} vs {ref[1]}")
        plain = runs[True, "plain"]
        require(runs[False, "plain"][0] == plain[0], f"{what}: the plain run differs paged and dense")
        require(plain[2] == ref[2], f"{what}: tier 2 admits in another order plain and speculative")
        require(ref[1]["spec_drafts"] > 0 and plain[1]["spec_drafts"] == 0, f"{what}: spec counters {ref[1]}")
        held = hold_spec_to_plain(server.tiers[1], reqs, plain[0], ref[0], temperature, plain[2], plain[3], what)
        out[f"T{temperature:g}"] = dict(spec=ref[1], plain=plain[1], **held,
                                        verify_held=[runs[p, "graphed_2"][4] for p in (True, False)],
                                        outputs_digest=outputs_digest(*(np.asarray(o[2]) for o in ref[0].values())))
    c2 = get_config("rwkv6-7b").reduced()
    v2 = ens.init_ensemble(c2, 1, torch.Generator(device=dev).manual_seed(seed + 2), dev)
    server = drafting_server(dev, cfg, v1, c2, v2)
    fallback = {s: serve(server, "graphed_1", None, s) for s in (False, True)}
    require(fallback[True][1]["spec_drafts"] == 0, f"rwkv6 tier 2 ran a verify pass: {fallback[True][1]}")
    require(fallback[True][0] == fallback[False][0], "rwkv6 tier 2: speculative differs from plain")
    out["rwkv6 tier 2 fallback"] = dict(spec=fallback[True][1], deferred=sum(
        t == 1 for t, _, _ in fallback[True][0].values()))
    return out


def open_loop_report(rep, wall_s):
    return dict(offered=rep.offered, completed=len(rep.completed), shed=len(rep.shed),
                completed_in_slo=rep.completed_in_slo, goodput=rep.goodput, p50_s=rep.p50_s, p99_s=rep.p99_s,
                makespan_s=rep.makespan_s, controller_actions=len(rep.controller_actions), wall_s=wall_s,
                tier_counts=[sum(r.tier == i for r in rep.completed) for i in range(2)],
                outputs_digest=outputs_digest(*(np.concatenate([[r.tier], r.output]) for r in rep.completed)))


def open_loop_runs(server, workload, config, what, need=()):
    """``serve_open_loop`` of ``workload`` after a closed-loop run of the same
    geometry: the static arm and the greedy controller's, each twice, the
    launch counters zeroed just before and read just after each run.
    Within an arm both runs give equal reports and capture nothing;
    offered == completed + shed in every run.  Returns (the reports, the
    last run's launches)."""
    from repro_torch import kernels
    from repro_torch.serve import ControllerConfig, GreedyController
    from repro_torch.serve.graphs import trace_counts

    server.serve_continuous([r for _, r in workload], config)
    before = trace_counts()
    out = {}
    for arm in ("static", "controller"):
        reps = []
        for _ in range(2):
            ctl = GreedyController(ControllerConfig(interval_s=OPEN_LOOP_CONTROLLER_INTERVAL_S)) \
                if arm == "controller" else None
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = server.serve_open_loop(workload, config, controller=ctl, **OPEN_LOOP_RUN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            for kname in need:
                require(launches[kname] > 0, f"{what} {arm}: kernel {kname} was not launched")
            require(rep.offered == len(rep.completed) + len(rep.shed) == len(workload),
                    f"{what} {arm}: offered {rep.offered} != {len(rep.completed)} completed + {len(rep.shed)} shed")
            require(all(r.shed and r.output is None for r in rep.shed), f"{what} {arm}: a shed request has output")
            reps.append((open_loop_report(rep, wall), rep.controller_actions))
        first, second = ({k: v for k, v in r[0].items() if k != "wall_s"} for r in reps)
        require(first == second and reps[0][1] == reps[1][1], f"{what} {arm}: two runs differ: {first} vs {second}")
        out[arm] = dict(reps[0][0], wall_s=[r[0]["wall_s"] for r in reps], launches=launches)
        log(f"{what} open loop, {arm}: {json.dumps(out[arm])}")
    require(trace_counts() == before, f"{what}: an open-loop run captured after the closed-loop run")
    return out, launches


def check_open_loop_on_card(dev, seed):
    """The bench's open-loop trace on the dense cascade of
    ``check_serving_on_card`` (qwen2.5-3b x3 at vote 0.5 -> internlm2-1.8b,
    reduced, 4 slots, max_seq 64, paged): ``open_loop_runs``."""
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeServer, CascadeTier, ServeConfig, bursty

    c1, c2 = get_config("qwen2.5-3b").reduced(), get_config("internlm2-1.8b").reduced()
    gen = torch.Generator(device=dev).manual_seed(seed)
    v1, v2 = ens.init_ensemble(c1, 3, gen, dev), ens.init_ensemble(c2, 1, gen, dev)
    server = CascadeServer([CascadeTier(c1, v1, TierSpec("s", "vote", 0.5, k=3), device=dev),
                            CascadeTier(c2, v2, TierSpec("b", "confidence", -1.0), device=dev)], device=dev)
    wl = bursty(**OPEN_LOOP_TRACE, prompt_len=(4, 12))
    return open_loop_runs(server, wl, ServeConfig(n_slots=4, max_seq=64, page_size=16), "reduced")[0]


# ---------------------------------------------------------------------------
# placement and transports: the edge-to-cloud path (phases 3 and 4)
# ---------------------------------------------------------------------------

# the placements every serving check runs over: None is the unplaced server
PLACEMENTS = (None, "single_host", "sim", "serial", "async")
LINKS = ("sim", "serial", "async")


def placement_of(kind, delay):
    """``kind`` of ``PLACEMENTS`` as a ``TierPlacement`` of two tiers (the
    server binds its link to tier 2's device)."""
    from repro_torch.serve import edge_cloud, single_host

    if kind is None:
        return None
    if kind == "single_host":
        return single_host(2)
    return edge_cloud(delay=delay, link=kind)


def hop_list(link):
    return [(h.src, h.dst, h.n_examples, h.payload_bytes, h.latency) for h in link.hops] if link is not None else []


def first_difference(reqs, got, ref):
    """The first request (by submission index) and output step where two
    runs' outputs differ, with both tokens there."""
    for i in range(len(reqs)):
        if got[i] != ref[i]:
            (t1, f1, o1), (t2, f2, o2) = got[i], ref[i]
            step = next((s for s in range(min(len(o1), len(o2))) if o1[s] != o2[s]), min(len(o1), len(o2)))
            return dict(request=i, step=step, tier=(t1, t2), truncated=(f1, f2),
                        token=(o1[step] if step < len(o1) else None, o2[step] if step < len(o2) else None))
    return None


def served_outputs(done, reqs):
    by = {r.rid: r for r in done}
    require(sorted(by) == sorted(r.rid for r in reqs), "serve_continuous: requests lost or doubled")
    return {i: (by[q.rid].tier, bool(by[q.rid].truncated), by[q.rid].output.tolist()) for i, q in enumerate(reqs)}


def largest_gap_theta(scores):
    """A threshold for the score rule in the widest gap between the middle
    half of the card's sorted tier-1 scores: no score lies near it, so the
    card and the CPU take the same defer decisions unless their scores
    differ by half that gap."""
    s = np.sort(scores)
    lo, hi = len(s) // 4, 3 * len(s) // 4
    j = lo + int(np.argmax(np.diff(s[lo:hi + 1])))
    return float((s[j] + s[j + 1]) / 2), float(s[j + 1] - s[j])


def unsettled(cpu, card):
    """Logits (..., V) on the CPU and on the card -> (...) True where the
    argmax could differ between the two: the CPU's top-1 minus top-2 gap
    is within twice that row's own largest card-vs-CPU difference."""
    cpu = cpu.float()
    top = cpu.topk(2, dim=-1).values
    return ((top[..., 0] - top[..., 1]) <= 2 * (card.float().cpu() - cpu).abs().amax(-1)).numpy()


def vote_unsettled(cpu, card, pred):
    """Member logits (E, B, V) on the CPU and the card and the CPU's
    plurality answer (B,) -> (B,) True where the score rule's prediction,
    the plurality of the members' argmaxes, could differ: an unsettled
    member (``unsettled``) may vote for anything, and the answer stands
    only if its settled votes outnumber any other answer's with every
    unsettled member added to that one."""
    free = unsettled(cpu, card)
    votes = cpu.float().argmax(-1).numpy()
    out = np.zeros(votes.shape[1], bool)
    for b in range(votes.shape[1]):
        n_free = int(free[:, b].sum())
        if n_free:
            fixed = collections.Counter(votes[~free[:, b], b].tolist())
            mine = fixed.pop(int(pred[b]), 0)
            out[b] = mine <= max(fixed.values(), default=0) + n_free
    return out


def classify_over_link(dev, c1, v1, c2, v2, rng, vocab, what):
    """Classify at reduced width over ``edge_cloud(link="sim")``: on the
    card, pred, tier_of and scores bitwise the unplaced server's (the same
    tiers, so the same programs), one count read per transition, and the
    hop the deferred rows, padded to the bucket cover, with their index
    map.  The card's answers are exactly the rules' over the card's own
    logits, each tier's program replayed on the rows classify fed it.
    Then the same placed classify on the CPU with the same bf16 weights:
    each tier's logits held normwise to the CPU's (REF_TOL dense, E2E_TOL
    recurrent), and every row where card and CPU answer differently must be
    one the row's own logits difference can flip under the rule that
    answered it: tier 1's score within that row's score difference of
    theta, tier 1's plurality not settled (``vote_unsettled``), or tier 2's
    argmax unsettled (``unsettled``).  With no tier-1 row unsettled the
    CPU's hop list must equal the card's."""
    from repro_torch.core import deferral
    from repro_torch.core.cascade import TierSpec, bucket_chunks, host_fetch_stats, reset_host_fetch_stats
    from repro_torch.kernels.agreement import ops as agree_ops
    from repro_torch.models.params import tree_map
    from repro_torch.serve import CascadeServer, CascadeTier, edge_cloud

    B, S = 16, 24
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    card1 = CascadeTier(c1, v1, TierSpec("edge", "score", 0.0, k=3), device=dev)
    logits1 = card1.last_logits(toks, eager=True)
    theta, gap = largest_gap_theta(agree_ops.agreement(logits1)["mean_score"].float().cpu().numpy())
    spec1, spec2 = TierSpec("edge", "score", theta, k=3), TierSpec("cloud", "confidence", -1.0)
    tiers = [CascadeTier(c1, v1, spec1, device=dev), CascadeTier(c2, v2, spec2, device=dev)]
    res = {}
    for kind in (None, "sim"):
        placement = placement_of(kind, "medium")
        server = CascadeServer(tiers, device=dev, placement=placement)
        reset_host_fetch_stats()
        res[kind] = (server.classify(toks), host_fetch_stats(), hop_list(placement.link(0) if placement else None))
    (unplaced, _, _), (placed, fetch, hops) = res[None], res["sim"]
    for name in ("pred", "tier_of", "scores"):
        require(np.array_equal(getattr(placed, name), getattr(unplaced, name)),
                f"{what}: classify over the link gives other {name} than unplaced on the card")
    n_def = int(placed.tier_counts[1])
    require(0 < n_def < B, f"{what}: {n_def} of {B} rows deferred")
    n_pad = min(sum(bucket_chunks(n_def, 8)), B)
    require(fetch == {"bytes": B * 12 + 2 * 4 + 4, "calls": 2}, f"{what}: classify over the link read {fetch}, not "
                                                                 "one count a transition and the results")
    require(hops == [("edge0", "cloud0", n_def, n_pad * (S * 4 + 4), 0.1)], f"{what}: hops {hops} for {n_def} "
                                                                             "deferred rows")
    # the card's answers are the rules' over its own logits: tier 1's
    # program on the batch, tier 2's on the deferred rows padded to the
    # bucket cover (rows are independent, so the padding's content is not)
    card_l1 = tiers[0].last_logits(toks).clone()
    rule1 = deferral.score_rule(card_l1, theta)
    defer1, pred1 = rule1.defer.cpu().numpy(), rule1.pred.cpu().numpy()
    rows = np.flatnonzero(placed.tier_of == 1)
    require(np.array_equal(rows, np.flatnonzero(defer1)) and np.array_equal(placed.pred[~defer1], pred1[~defer1]),
            f"{what}: tier 1's answers on the card are not the score rule's over its logits")
    fed = toks[np.resize(rows, n_pad)]
    card_l2 = tiers[1].last_logits(fed).clone()[:, :n_def]
    require(np.array_equal(placed.pred[rows], deferral.confidence_rule(card_l2, -1.0).pred.cpu().numpy()),
            f"{what}: tier 2's answers on the card are not the argmax of its logits")
    # the same placed classify on the CPU, on the same weights
    cpu_tiers = [CascadeTier(t.cfg, tree_map(lambda x: x.cpu(), t.values), t.spec, device="cpu") for t in tiers]
    cpu_pl = edge_cloud(delay="medium")
    cpu = CascadeServer(cpu_tiers, device="cpu", placement=cpu_pl).classify(toks)
    cpu_l1 = cpu_tiers[0].last_logits(toks, eager=True)
    cpu_l2 = cpu_tiers[1].last_logits(fed, eager=True)[:, :n_def]
    err = [normwise(card, ref, f"{what} tier {i + 1} classify logits card vs cpu",
                    REF_TOL if t.cfg.family == "dense" else E2E_TOL)
           for i, (card, ref, t) in enumerate(zip((card_l1, card_l2), (cpu_l1, cpu_l2), tiers))]
    cpu_stats = agree_ops.agreement(cpu_l1)
    cpu_score = cpu_stats["mean_score"].float().numpy()
    card_score = agree_ops.agreement(card_l1)["mean_score"].float().cpu().numpy()
    near_defer = np.abs(cpu_score - theta) <= np.abs(card_score - cpu_score)
    near_vote = vote_unsettled(cpu_l1, card_l1, cpu_stats["pred"].numpy())
    near_answer = np.zeros(B, bool)
    near_answer[rows] = unsettled(cpu_l2[0], card_l2[0])
    near = near_defer | near_vote | near_answer
    differ = (placed.pred != cpu.pred) | (placed.tier_of != cpu.tier_of)
    require(not (differ & ~near).any(), f"{what}: card and CPU classify differ at rows "
                                        f"{np.flatnonzero(differ & ~near).tolist()}, none a near tie")
    if not (near_defer | near_vote).any():
        require(hop_list(cpu_pl.link(0)) == hops, f"{what}: the CPU's hops {hop_list(cpu_pl.link(0))} != {hops}")
    return dict(batch=[B, S], theta=theta, theta_gap=gap, deferred=n_def, hops=hops, host_fetch=fetch,
                logits_normwise_err=err, near_ties=dict(defer=int(near_defer.sum()), vote=int(near_vote.sum()),
                                                       answer=int(near_answer.sum()), rows=int(near.sum())),
                differ=int(differ.sum()), cpu_hops_equal=hop_list(cpu_pl.link(0)) == hops)


def path_unsettled(cpu_tier, card_tier, prompts, seqs):
    """(E, B) True where member e's greedy path could differ between the
    CPU and the card: ``seqs`` (E, B, n) continuations of ``prompts`` (B,
    S); member e's logits on its own sequence, on both devices, at the n
    positions that chose its tokens, ``unsettled`` at any of them."""
    from repro_torch.core import ensemble as ens

    S, n = prompts.shape[1], seqs.shape[-1]
    out = np.zeros(seqs.shape[:2], bool)
    with torch.no_grad():
        for e in range(seqs.shape[0]):
            full = np.concatenate([prompts, seqs[e]], axis=1)[:, :-1].astype(np.int32)
            lc = ens.ensemble_logits(cpu_tier.values, {"tokens": full}, cpu_tier.cfg)[e, :, S - 1:S - 1 + n]
            lg = ens.ensemble_logits(card_tier.values, {"tokens": full}, card_tier.cfg)[e, :, S - 1:S - 1 + n]
            out[e] = unsettled(lc, lg).any(-1)
    return out


def check_f32_cascade_on_card(dev, seed):
    """An f32 cascade, 3 x qwen2.5-3b reduced -> internlm2-1.8b reduced, on
    the card (every attention through the kernels' f32 route) against the
    CPU from the same weights, where the two differ only in summation
    order: classify over a simulated link (``classify_over_link``: pred and
    tier_of equal but at rows a near tie can flip); each tier's greedy
    generate, member tokens equal but on a path through a near tie
    (``path_unsettled``); the cascade's greedy ``serve_continuous`` (paged,
    graphed on the card), every request's tier and tokens equal but where
    its CPU output passes a near tie of some member of either tier; the
    attention kernels launched on the card."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.models.params import tree_map
    from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig

    c1, c2 = (dataclasses.replace(get_config(a).reduced(), dtype="float32") for a in ("qwen2.5-3b", "internlm2-1.8b"))
    g = torch.Generator().manual_seed(seed + 9)
    v1, v2 = ens.init_ensemble(c1, 3, g, "cpu"), ens.init_ensemble(c2, 1, g, "cpu")
    g1, g2 = (tree_map(lambda t: t.to(dev), v) for v in (v1, v2))
    rng = np.random.default_rng(seed + 9)
    vocab = min(c1.vocab_size, c2.vocab_size)
    kernels.reset_launch_counts()
    out = {"classify": classify_over_link(dev, c1, g1, c2, g2, rng, vocab, "f32 cascade")}
    specs = (TierSpec("qwen-x3", "vote", 0.5, k=3), TierSpec("internlm", "confidence", -1.0))
    card = [CascadeTier(c, v, sp, device=dev) for c, v, sp in zip((c1, c2), (g1, g2), specs)]
    cpu = [CascadeTier(c, v, sp, device="cpu") for c, v, sp in zip((c1, c2), (v1, v2), specs)]

    toks = rng.integers(0, vocab, (8, 16)).astype(np.int32)
    gen = []
    with torch.no_grad():
        for ct, pt in zip(card, cpu):
            got, ref = ct.generate(toks, 8), pt.generate(toks, 8)
            near = path_unsettled(pt, ct, toks, ref)
            differ = (got != ref).any(-1)
            require(not (differ & ~near).any(), f"f32 cascade {ct.spec.name} generate: card and CPU tokens differ "
                                                f"at (member, row) {np.argwhere(differ & ~near).tolist()}, none a near tie")
            gen.append(dict(tier=ct.spec.name, members=int(got.shape[0]), differ=int(differ.sum()),
                            near_ties=int(near.sum())))
    out["generate"] = gen

    prompts = [rng.integers(0, vocab, int(rng.integers(4, 21))).astype(np.int32) for _ in range(12)]
    make = lambda: [Request(tokens=p, max_new_tokens=6, rid=i) for i, p in enumerate(prompts)]  # noqa: E731
    config = ServeConfig(n_slots=4, max_seq=64)
    with torch.no_grad():
        done = {where: {r.rid: r for r in CascadeServer(tiers, device=where).serve_continuous(make(), config)}
                for where, tiers in ((dev, card), ("cpu", cpu))}
        n_differ = n_near = 0
        for i, p in enumerate(prompts):
            a, b = done[dev][i], done["cpu"][i]
            if a.tier == b.tier and np.array_equal(a.output, b.output):
                continue
            n_differ += 1
            seq = np.asarray(b.output, np.int32)[None, None]
            near = any(path_unsettled(pt, ct, p[None], np.repeat(seq, ct.k, 0)).any() for ct, pt in zip(card, cpu))
            n_near += near
            require(near, f"f32 cascade serve_continuous: request {i} on the card (tier {a.tier}, {a.output.tolist()}) "
                          f"!= the CPU (tier {b.tier}, {b.output.tolist()}), no near tie on the CPU's path")
    out["serve_continuous"] = dict(requests=len(prompts), differ=n_differ, near_ties=n_near,
                                   tier_counts=np.bincount([r.tier for r in done[dev].values()], minlength=2).tolist())
    launched = kernels.launch_counts()
    for name in ("agreement", "compaction", "flash_attention", "decode_attention", "decode_attention_paged"):
        require(launched[name] > 0, f"f32 cascade: no {name} launch on the card")
    out["launches"] = launched
    return out


def check_transport_on_card(dev, seed):
    """Placement and transports at reduced width on the card, for both
    cascade shapes: qwen2.5-3b x3 -> internlm2-1.8b (paged) and zamba2-2.7b
    x3 -> rwkv6-7b (dense slot caches).  Classify over ``edge_cloud(link=
    "sim")`` (``classify_over_link``); then ``serve_continuous``, greedy
    and T = 0.8, 12 requests (4 sharing a 20-token prefix), 4 slots,
    graphed, under no placement, ``single_host`` and the ``sim``,
    ``serial`` and ``async`` links at the "small" delay (10 ms): tokens,
    tiers and flags bitwise equal across all five (a difference is reported
    by request and step and fails), the metered hops equal across the
    three links, and ``inflight_admitted`` on tier 2 equal to the
    deferrals.  On the first shape also speculative over the async link:
    the tokens are the unplaced speculative run's, each hop carries more
    bytes than the plain run's (the draft rides it)."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeServer, CascadeTier, ServeConfig
    from repro_torch.serve.graphs import trace_counts

    out = {}
    for a1, a2, paged in (("qwen2.5-3b", "internlm2-1.8b", True), ("zamba2-2.7b", "rwkv6-7b", None)):
        name = f"{a1} x3 -> {a2}"
        c1, c2 = get_config(a1).reduced(), get_config(a2).reduced()
        gen = torch.Generator(device=dev).manual_seed(seed)
        v1, v2 = ens.init_ensemble(c1, 3, gen, dev), ens.init_ensemble(c2, 1, gen, dev)
        vocab = min(c1.vocab_size, c2.vocab_size)
        rng = np.random.default_rng(seed)
        result = {"classify": classify_over_link(dev, c1, v1, c2, v2, rng, vocab, name)}
        reqs = serve_requests(rng, 12, vocab, 4, 60, 6, n_prefix=4, prefix_len=20)
        for temperature in (0.0, 0.8):
            tiers = [CascadeTier(c1, v1, TierSpec("edge", "vote", 0.5, k=3), temperature=temperature, device=dev),
                     CascadeTier(c2, v2, TierSpec("cloud", "confidence", -1.0), temperature=temperature, device=dev)]
            runs, hops, captured = {}, {}, {}
            for kind in PLACEMENTS:
                placement = placement_of(kind, "small")
                server = CascadeServer(tiers, device=dev, placement=placement)
                before = trace_counts()
                t0 = time.perf_counter()
                done = server.serve_continuous([copy.deepcopy(r) for r in reqs], ServeConfig(
                    n_slots=4, max_seq=128, page_size=16, paged=paged, seed=seed))
                wall = time.perf_counter() - t0
                runs[kind] = served_outputs(done, reqs)
                deferred = sum(t == 1 for t, _, _ in runs[kind].values())
                admitted = server.last_stream_stats[1]["inflight_admitted"]
                require(admitted == (deferred if kind is not None else 0),
                        f"{name} T={temperature} {kind}: inflight_admitted {admitted}, {deferred} deferrals")
                link = placement.link(0) if placement is not None else None
                hops[kind] = dict(hops=hop_list(link), wall_s=wall, wait_s=link.total_wait if link else 0.0)
                captured[str(kind)] = trace_counts() != before
                if kind is not None:
                    diff = first_difference(reqs, runs[kind], runs[None])
                    if diff is not None:
                        log(f"[{name}] T={temperature} {kind}: first difference from the unplaced run: {diff}")
                    require(diff is None, f"{name} T={temperature}: {kind} emits other tokens than the unplaced run")
            link_hops = [[h[:4] + (round(h[4], 9),) for h in hops[k]["hops"]] for k in LINKS]
            require(link_hops[0] == link_hops[1] == link_hops[2], f"{name} T={temperature}: the links meter other hops")
            deferred = sum(t == 1 for t, _, _ in runs[None].values())
            require(len(link_hops[0]) == deferred > 0, f"{name} T={temperature}: {len(link_hops[0])} hops, "
                                                        f"{deferred} deferrals")
            result[f"T{temperature:g}"] = dict(
                requests=len(reqs), deferred=deferred, hop_bytes=sum(h[3] for h in link_hops[0]),
                walls_s={str(k): hops[k]["wall_s"] for k in PLACEMENTS},
                async_wait_s=hops["async"]["wait_s"], captured=captured,
                outputs_digest=outputs_digest(*(np.asarray(runs[None][i][2]) for i in range(len(reqs)))))
            log(f"[{name}] T={temperature}: tokens equal under {PLACEMENTS}: {json.dumps(result[f'T{temperature:g}'])}")
        if a1 == "qwen2.5-3b":
            result["speculative"] = speculative_over_link(dev, tiers=[
                CascadeTier(c1, v1, TierSpec("edge", "vote", 0.5, k=3), device=dev),
                CascadeTier(c2, v2, TierSpec("cloud", "confidence", -1.0), device=dev)], reqs=reqs, seed=seed)
        out[name] = result
    return out


def speculative_over_link(dev, tiers, reqs, seed):
    """The first shape speculative, unplaced and over the async link (10
    ms), and plain over the simulated link: equal tokens speculative
    placed and unplaced, tier 2 ran verify passes, and each hop of the
    speculative run carries the plain hop's prompt and the draft."""
    import copy

    from repro_torch.serve import CascadeServer, ServeConfig

    runs, links = {}, {}
    for kind, speculative in ((None, True), ("async", True), ("sim", False)):
        placement = placement_of(kind, "small")
        server = CascadeServer(tiers, device=dev, placement=placement)
        done = server.serve_continuous([copy.deepcopy(r) for r in reqs], ServeConfig(
            n_slots=4, max_seq=128, page_size=16, seed=seed, speculative=speculative))
        runs[kind] = (served_outputs(done, reqs), dict(server.last_stream_stats[1]))
        links[kind] = placement.link(0) if placement is not None else None
    diff = first_difference(reqs, runs["async"][0], runs[None][0])
    require(diff is None, f"speculative over the async link emits other tokens than unplaced: {diff}")
    spec, plain = links["async"].hops, links["sim"].hops
    require(len(spec) == len(plain) > 0 and all(s.payload_bytes > p.payload_bytes for s, p in zip(spec, plain)),
            "speculative hops do not carry the draft beside the prompt")
    stats = runs["async"][1]
    require(stats["spec_drafts"] > 0 and stats["inflight_admitted"] == len(spec), f"speculative over the link: {stats}")
    return dict(hops=len(spec), spec_bytes=sum(h.payload_bytes for h in spec),
                plain_bytes=sum(h.payload_bytes for h in plain), spec_drafts=stats["spec_drafts"],
                spec_accepted_tokens=stats["spec_accepted_tokens"])


def edge_cloud_path(servers, toks, make_reqs, unplaced, name, need):
    """Phase 4's edge-to-cloud path, over the main path's tiers at published
    width: classify (32 x 256) over ``edge_cloud(link="sim", delay=
    "medium")`` against an unplaced classify of the same prompts (equal
    pred/tier_of digest; the bytes that crossed against the whole batch's),
    then the main path's greedy ``serve_continuous`` over the ``serial``
    and the ``async`` link at "medium" (100 ms): the tokens digest of each
    the unplaced graphed run's (``unplaced``), equal hops, nothing
    captured, and both walls, the link's summed latency and blocked wait,
    the overlap ratio (serial wall / async wall) and the hidden link
    seconds.  Returns (results, launches by mode)."""
    from repro_torch import kernels
    from repro_torch.core.cascade import host_fetch_stats, reset_host_fetch_stats
    from repro_torch.serve import CascadeServer, ServeConfig, edge_cloud
    from repro_torch.serve.graphs import trace_counts

    dev = servers["classify"].device
    results, launches = {}, {}
    counts = trace_counts()
    classify = {}
    for kind in (None, "sim"):
        placement = edge_cloud(delay="medium", link="sim") if kind else None
        server = CascadeServer(servers["classify"].tiers, device=dev, placement=placement)
        reset_host_fetch_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = server.classify(toks)
        torch.cuda.synchronize()
        classify[kind] = dict(wall_s=time.perf_counter() - t0, outputs_digest=outputs_digest(res.pred, res.tier_of),
                              tier_counts=res.tier_counts.tolist(), host_fetch=host_fetch_stats(),
                              launches=kernels.launch_counts())
        if kind:
            link = placement.link(0)
            launches["edge_cloud_classify"] = classify[kind]["launches"]
            for kname in need["classify"]:
                require(launches["edge_cloud_classify"][kname] > 0, f"{name} edge_cloud classify: {kname} not launched")
            B, S = toks.shape
            classify[kind].update(hops=hop_list(link), bytes_crossed=link.total_bytes, batch_bytes=B * S * 4,
                                  bytes_reduction=B * S * 4 / max(1, link.total_bytes))
            require(link.total_examples == res.tier_counts[1], f"{name} edge_cloud classify: hops {hop_list(link)}")
    require(classify["sim"]["outputs_digest"] == classify[None]["outputs_digest"],
            f"{name}: classify over the link gives other pred or tier_of than unplaced")
    require(classify["sim"]["host_fetch"]["calls"] == 2, f"{name}: classify over the link: {classify['sim']}")
    results["classify"] = classify
    log(f"[{name}] edge_cloud classify: {json.dumps(classify)}")
    serve = {}
    for link_kind in ("serial", "async"):
        placement = edge_cloud(delay="medium", link=link_kind)
        server = CascadeServer(servers["generate"].tiers, device=dev, placement=placement)
        run = serve_continuous_run(server, make_reqs(), ServeConfig(**SERVE_CONFIG), name,
                                   f"edge_cloud_{link_kind}", need["serve_continuous"])
        link = placement.link(0)
        run.update(hops=len(link.hops), bytes=link.total_bytes, examples=link.total_examples,
                   total_latency_s=link.total_latency, total_wait_s=link.total_wait,
                   hidden_s=max(0.0, link.total_latency - link.total_wait), hop_list=hop_list(link))
        require(run["outputs_digest"] == unplaced["outputs_digest"],
                f"{name}: serve_continuous over the {link_kind} link emits other tokens than unplaced")
        require(run["tiers"][1]["decode_tokens"] > 0 and link.total_examples == run["tier_counts"][1],
                f"{name}: {link_kind}: {link.total_examples} hops for {run['tier_counts'][1]} deferrals")
        launches[f"edge_cloud_serve_{link_kind}"] = run["launches"]
        serve[link_kind] = run
    require(serve["serial"]["hop_list"] == serve["async"]["hop_list"], f"{name}: serial and async meter other hops")
    require(trace_counts() == counts, f"{name}: the edge-to-cloud runs captured a program")
    results["serve"] = {k: {x: v for x, v in r.items() if x != "hop_list"} for k, r in serve.items()}
    results["overlap_ratio"] = serve["serial"]["wall_s"] / serve["async"]["wall_s"]
    log(f"[{name}] edge_cloud serve: serial wall {serve['serial']['wall_s']:.4f}s, async wall "
        f"{serve['async']['wall_s']:.4f}s, overlap ratio {results['overlap_ratio']:.4f}, link "
        f"{serve['async']['total_latency_s']:.4f}s, blocked {serve['async']['total_wait_s']:.4f}s, hidden "
        f"{serve['async']['hidden_s']:.4f}s (serial: blocked {serve['serial']['total_wait_s']:.4f}s, hidden "
        f"{serve['serial']['hidden_s']:.4f}s), unplaced graphed wall {unplaced['wall_s']:.4f}s")
    return results, launches


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
            # the paged verify chunk's K/V view, both tiers' paged decode
            serve_speculative=("compaction", "decode_attention_paged"),
            serve_open_loop=("compaction", "decode_attention_paged"),
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
    # MoE at published width: mixtral-8x22b cut to 4 of its 56 layers (8
    # experts of d_ff 16384 on d_model 6144, 10.4 B parameters, 48 heads on
    # 8 KV heads: G 6, window 4096), after olmo-1b x3 at full depth
    "olmo-1b x3 -> mixtral-8x22b": dict(
        tier1="olmo-1b", tier2="mixtral-8x22b", tier2_layers=4,
        need=dict(
            classify=("agreement", "compaction", "flash_attention"),
            generate=("compaction", "flash_attention", "decode_attention"),
            serve_continuous=("compaction", "decode_attention_paged"),
        ),
    ),
}


# the cascade whose serve_continuous also runs sampled (T = 0.8), graphed,
# and open loop, and whose tier 1 drafts for the speculative cascade
SAMPLED_CASCADE = "qwen2.5-3b x3 -> internlm2-1.8b"


def main_path(dev, seed, name):
    """One cascade of ``CASCADES`` at published widths and full depth: the
    three modes, each run eager, then graphed twice, each run with the
    launch counters zeroed just before and read just after; one replay of
    each tier's graphed generate prefill and decode step, serve decode step
    and chunk call, profiled; for ``SAMPLED_CASCADE`` a sampled graphed
    serve_continuous, the open loop (``open_loop_path``) and the
    speculative cascade (``speculative_path``).  Returns (results, launches
    per mode: the second graphed run's)."""
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
    if "tier2_layers" in spec:
        c2 = dataclasses.replace(c2, n_layers=spec["tier2_layers"])
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
        results["serve_continuous"], launches["serve_continuous"], make_reqs = serve_continuous_path(
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
            # prompts of their own stream: ``rng`` goes on as before
            toks = np.random.default_rng(seed + 2).integers(0, vocab, (32, 256)).astype(np.int32)
            results["edge_cloud"], edge_launches = edge_cloud_path(
                servers, toks, make_reqs, results["serve_continuous"]["graphed_2"], name, spec["need"])
            launches.update(edge_launches)
        if name == SAMPLED_CASCADE:
            results["serve_continuous_sampled"] = sampled_serve_run(servers["generate"], rng, vocab, name,
                                                                    spec["need"]["serve_continuous"], seed)
        results["generate_buckets"] = bucket_memory_check(servers["generate"].tiers[0], rng, vocab, name)
        if name == SAMPLED_CASCADE:
            results["serve_open_loop"], launches["serve_open_loop"] = open_loop_path(
                servers["generate"], c1, c2, name, spec["need"]["serve_open_loop"])
            # last: it overwrites tier 1's member 1 with member 0
            del servers, tier2
            results["serve_speculative"], launches["serve_speculative"] = speculative_path(
                dev, c1, v1, rng, c1.vocab_size, name, spec["need"]["serve_speculative"], seed)
    return results, launches


def frontend_path(dev, seed):
    """The two frontends at published width: hubert-xlarge x3
    ``ensemble_last_logits`` over 8 x 512 stubbed frames (48 non-causal
    layers: flash at hd 80, G 1; then ``member_stats`` through the agreement
    kernel), and internvl2-26b with 4 of its 48 layers, one member: a
    prefill of 256 stubbed patches and 128 text tokens into a static cache,
    then 16 greedy decode steps (G 6 decode), once eager and once with the
    prefill and the decode step captured as CUDA graphs (``GraphSet``) and
    replayed: bitwise the same tokens and last logits.  Each run with the
    launch counters zeroed just before and read just after.  Returns
    (results, launches per run)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.kernels.agreement import ops as agree_ops
    from repro_torch.models import api
    from repro_torch.models.params import param_count
    from repro_torch.serve.graphs import GraphSet

    results, launches = {}, {}
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = get_config("hubert-xlarge")
    vals = ens.init_ensemble(cfg, 3, g, dev)
    frames = torch.randn(8, 512, cfg.frontend_dim, device=dev, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        runs = []
        for _ in range(2):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = ens.ensemble_last_logits(vals, {"embeds": frames}, cfg)
            stats = agree_ops.agreement(logits)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, kernels.launch_counts(), logits, stats))
        (_, _, l0, s0), (wall, counts, l1, s1) = runs
        require(torch.isfinite(l1).all() and l1.shape == (3, 8, cfg.vocab_size), f"hubert: logits {tuple(l1.shape)}")
        require(torch.equal(l0, l1) and torch.equal(s0["pred"], s1["pred"]), "hubert: two runs differ")
        for kname in ("flash_attention", "agreement"):
            require(counts[kname] > 0, f"hubert-xlarge x3: kernel {kname} was not launched")
        launches["hubert-xlarge x3/last_logits"] = counts
        results["hubert-xlarge x3"] = dict(
            params=param_count(vals), frames=[8, 512], wall_s=wall, launches=counts,
            pred_digest=outputs_digest(s1["pred"].cpu().numpy()),
            max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
    log(f"[frontend] hubert-xlarge x3 last logits over frames: {json.dumps(results['hubert-xlarge x3'])}")
    del vals, frames, runs, l0, l1, logits

    cfg = dataclasses.replace(get_config("internvl2-26b"), n_layers=4)
    params = api.init_params(cfg, g, dev)
    B, St, n_new = 1, 128, 16
    S = cfg.n_vision_tokens + St
    rng = np.random.default_rng(seed)
    text = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, St)).astype(np.int32), device=dev)
    patches = torch.randn(B, cfg.n_vision_tokens, cfg.frontend_dim, device=dev, generator=g).to(torch.bfloat16)
    out = {}
    with torch.no_grad():
        for run in ("eager", "graphed_1", "graphed_2"):
            eager = run == "eager"
            gs = GraphSet(dev) if run != "graphed_2" else gs
            cache = api.init_cache(cfg, B, S + n_new, dev) if run != "graphed_2" else cache

            def prefill(tokens, embeds, cache=cache):
                return api.prefill(params, {"tokens": tokens, "embeds": embeds}, cfg, cache=cache)[0]

            def decode(tok, pos, cache=cache):
                return api.decode_step(params, tok, cache, pos, cfg)[0]

            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = gs.run("internvl2/prefill", prefill, text, patches, eager=eager)
            toks = [logits.argmax(-1)]
            for t in range(n_new):
                pos = torch.full((B,), S + t, dtype=torch.int64, device=dev)
                logits = gs.run("internvl2/decode", decode, toks[-1][:, None], pos, eager=eager)
                toks.append(logits.argmax(-1))
            last = logits.float().clone()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            out[run] = dict(wall_s=time.perf_counter() - t0, launches=counts, last=last,
                            tokens=torch.stack(toks, 1).cpu().numpy())
            require(torch.isfinite(last).all(), f"internvl2 {run}: non-finite logits")
            for kname in ("flash_attention", "decode_attention"):
                require(counts[kname] > 0, f"internvl2-26b: kernel {kname} was not launched ({run})")
            launches[f"internvl2-26b/{run}"] = counts
    for run in ("graphed_1", "graphed_2"):
        require(np.array_equal(out[run]["tokens"], out["eager"]["tokens"]) and torch.equal(out[run]["last"], out["eager"]["last"]),
                f"internvl2-26b: the {run} prefill + decode differs from the eager run")
        require(out[run]["launches"] == out["eager"]["launches"], f"internvl2-26b: {run} launches differ from eager")
    results["internvl2-26b (4 layers)"] = dict(
        params=param_count(params), prefix=cfg.n_vision_tokens, text=St, new_tokens=n_new,
        tokens_digest=outputs_digest(out["eager"]["tokens"]),
        **{f"{run}_wall_s": out[run]["wall_s"] for run in out}, launches=out["graphed_2"]["launches"],
    )
    log(f"[frontend] internvl2-26b prefix prefill + decode, graphed == eager: "
        f"{json.dumps(results['internvl2-26b (4 layers)'])}")
    return results, launches


def speculative_path(dev, c1, v1, rng, vocab, name, need, seed):
    """The speculative cascade at published width, from the first cascade's
    tier-1 weights with no second copy of a member: member 1 takes member
    0's values in place (tier 1 [m0, m0, m2], vote_preds 0.8) and tier 2 is
    a view of member 0.  The main path's 32 serve requests and
    ``SERVE_CONFIG``: plain graphed twice, speculative graphed twice (the
    second capturing nothing), then plain and speculative at T = 0.8,
    graphed, on tiers of their own.  Every speculative run emits, request
    by request, the accepted draft prefix and its verify pass's choice
    (``hold_spec_to_verify``); every pass of the first greedy and the
    sampled speculative run is held bitwise to the eager route on a copy of
    its pool, table row, start and key (``verify_passes``; their walls
    include it).  The requests that leave the plain output are counted,
    and the first 4 of each mode replayed teacher-forced at the position
    where they leave it (``hold_spec_to_plain``, printed: the two bf16
    routes diverge over 36 random layers, so no near-tie rule can tell a
    fault there).  For 4 requests the verify chunk is held to the
    teacher-forced decode steps at all 16 positions layer by layer
    (``SPEC_LAYER_TOL``), the logits' error end to end and by depth
    printed; one replay of tier 2's 16-token verify chunk profiled.
    Returns (results, the second speculative run's launches)."""
    from repro_torch.models.params import tree_map
    from repro_torch.obs import Tracer
    from repro_torch.serve import ServeConfig, TierBackend
    from repro_torch.serve.graphs import trace_counts

    tree_map(lambda t: t[1].copy_(t[0]), v1)
    v2 = tree_map(lambda t: t[0:1], v1)
    state = rng.bit_generator.state
    runs, outputs, keys, servers, verified = {}, {}, {}, {}, {}
    for temperature, kinds in ((0.0, ("plain_1", "plain_2", "spec_1", "spec_2")), (0.8, ("plain", "spec"))):
        servers[temperature] = server = drafting_server(dev, c1, v1, c1, v2, temperature)
        for kind in kinds:
            rng.bit_generator.state = state  # the same requests in every run
            reqs = serve_requests(rng, 32, vocab, 16, 384, 16, n_prefix=8, prefix_len=128)
            cfg = ServeConfig(**SERVE_CONFIG, seed=seed, speculative=kind.startswith("spec"))
            tag = f"{kind}@T{temperature:g}"
            outputs[tag], tr = {}, Tracer() if temperature > 0 else None
            with verify_passes(hold=kind in ("spec_1", "spec")) as passes:
                runs[tag] = serve_continuous_run(server, reqs, cfg, f"{name} speculative", tag, need,
                                                 outputs=outputs[tag], tracer=tr)
            keys[tag] = tier2_keys(tr, seed, reqs) if tr is not None else {}
            if cfg.speculative:
                verified[tag] = hold_spec_to_verify(reqs, outputs[tag], passes, f"{name} {tag}")
                require(verified[tag]["verified"] == runs[tag]["tiers"][1]["spec_drafts"] > 0,
                        f"{name} {tag}: {verified[tag]} against {runs[tag]['tiers'][1]}")
    for a, b in (("plain_1@T0", "plain_2@T0"), ("spec_1@T0", "spec_2@T0")):
        require(runs[a]["outputs_digest"] == runs[b]["outputs_digest"] and runs[a]["pool_digest"] == runs[b]["pool_digest"],
                f"{name}: two graphed runs {a}, {b} differ")
    require(runs["spec_2@T0"]["trace_counts"] == runs["spec_1@T0"]["trace_counts"],
            f"{name}: the second speculative run captured again")
    require(keys["plain@T0.8"] == keys["spec@T0.8"], f"{name}: tier 2 admits in another order at T = 0.8")
    tier2 = servers[0.0].tiers[1]
    config = ServeConfig(**SERVE_CONFIG)
    held = {}
    for t, p, s in ((0.0, "plain_2@T0", "spec_2@T0"), (0.8, "plain@T0.8", "spec@T0.8")):
        held[s] = hold_spec_to_plain(servers[t].tiers[1], reqs, outputs[p], outputs[s], t, keys[p], config,
                                     f"{name} {s}", gate=False, show=4)
    # the verify chunk against the decode steps at every position, 4
    # requests: layer by layer (held), end to end and by depth (printed)
    route = []
    for i in [i for i in range(len(reqs)) if outputs["plain_2@T0"][i][0] == 1][:4]:
        r, plain = reqs[i], np.asarray(outputs["plain_2@T0"][i][2])
        fed = np.concatenate([r.tokens[-1:], plain[:-1]]).astype(np.int32)
        layers = route_errors_by_layer(tier2, r.tokens, fed, config.max_chunk, config.max_seq)
        require(max(layers) <= SPEC_LAYER_TOL, f"{name}: request {i}: a layer's verify output is "
                                               f"{max(layers)} normwise off its decode output: {layers}")
        route.append(dict(request=i, positions=len(fed), layer_max=max(layers), layer_errs=layers,
                          logits_by_depth=route_error_by_depth(tier2, r.tokens, fed, config.max_chunk,
                                                               config.max_seq)))
    log(f"[{name}] verify chunk vs teacher-forced decode steps, normwise: {json.dumps(route)}")
    backend = TierBackend(tier2, n_slots=SERVE_CONFIG["n_slots"], max_seq=SERVE_CONFIG["max_seq"],
                          page_size=SERVE_CONFIG["page_size"])
    prompt = rng.integers(0, vocab, 300).astype(np.int32)
    backend.begin_slot(0, prompt, share=False)
    require(backend.extend_slot(0, 300 + 15), f"{name}: the pool refused a verify extension")
    tokens = np.concatenate([prompt[-1:], rng.integers(0, vocab, 15)]).astype(np.int32)
    counts = trace_counts()
    verify_profile = profile_call(lambda: backend.verify_draft(tokens, 0, 299, SERVE_CONFIG["max_chunk"]))
    require(trace_counts() == counts, f"{name}: the profiled verify chunk captured again")
    del backend
    plain, spec = runs["plain_2@T0"]["tiers"][1], runs["spec_2@T0"]["tiers"][1]
    summary = dict(
        walls_s={k: r["wall_s"] for k, r in runs.items()},
        tier2_decode_tokens=dict(plain=plain["decode_tokens"], speculative=spec["decode_tokens"]),
        drafts=spec["spec_drafts"], draft_tokens=spec["spec_draft_tokens"], accepted_tokens=spec["spec_accepted_tokens"],
        accepted_per_deferral=spec["spec_accepted_tokens"] / max(1, spec["spec_drafts"]),
        accept_rate=spec["spec_accepted_tokens"] / max(1, spec["spec_draft_tokens"]),
        sampled=dict(plain=runs["plain@T0.8"]["tiers"][1], speculative=runs["spec@T0.8"]["tiers"][1]),
        capture_s={k: r["capture_s"] for k, r in runs.items()},
        peak_gib={k: r["max_memory_allocated_gib"] for k, r in runs.items()},
        spec_vs_plain=held, spec_vs_verify=verified, verify_vs_decode=route, verify_chunk_replay=verify_profile,
    )
    log(f"[{name}] speculative: {json.dumps(summary)}")
    return dict(summary, runs=runs), runs["spec_2@T0"]["launches"]


def open_loop_path(server, c1, c2, name, need):
    """The first cascade under the bench's open-loop trace with the main
    path's prompts (16-384 tokens; vocabulary the smaller tier's),
    ``SERVE_CONFIG``: ``open_loop_runs``.  Random members disagree on every
    request, so the routing here says nothing about the controller: no
    goodput ordering is required."""
    from repro_torch.serve import ServeConfig, bursty

    wl = bursty(**OPEN_LOOP_TRACE, prompt_len=(16, 384), vocab=min(c1.vocab_size, c2.vocab_size))
    return open_loop_runs(server, wl, ServeConfig(**SERVE_CONFIG), f"[{name}]", need)



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
    eager call's; misread counts are profiled again, at most twice)."""
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
    # the profiler misreads a call's kernels now and then, eager or graphed,
    # in two of the three reps at once as often as in one (a mixtral chunk
    # replay once read [567, 567, 525] against the eager 546, a qwen eager
    # call [3746, 3741, 3718] against its replay's 3746): when the medians
    # differ both are profiled again, at most twice, every reading kept
    rereads = [(out["one_launch_view"]["device_kernels_runs"], out["graphed"]["device_kernels_runs"])]
    while out["graphed"]["device_kernels"] != out["one_launch_view"]["device_kernels"] and len(rereads) < 3:
        out["one_launch_view"] = profile_call(call, names=True)
        out["graphed"] = profile_call(graphed_call, names=True)
        rereads.append((out["one_launch_view"]["device_kernels_runs"], out["graphed"]["device_kernels_runs"]))
    out["graphed"]["device_kernels_reads"] = rereads
    for variant in ("one_launch_view", "graphed"):
        require(out[variant]["launches"].get("compaction") == cfg.n_layers,
                f"{cfg.name}: {out[variant]['launches']} launches in a {variant} chunk call")
    eager_names, graphed_names = out["one_launch_view"].pop("kernel_names"), out["graphed"].pop("kernel_names")
    if graphed_names != eager_names:
        log(f"{cfg.name}: device kernels of a graphed chunk call less the eager call's, by name: "
            f"{json.dumps({k: graphed_names[k] - eager_names[k] for k in graphed_names | eager_names if graphed_names[k] != eager_names[k]})}")
    require(out["graphed"]["device_kernels"] == out["one_launch_view"]["device_kernels"],
            f"{cfg.name}: a graphed chunk call runs {out['graphed']['device_kernels']} device kernels, the eager "
            f"call {out['one_launch_view']['device_kernels']} (eager and graphed reads: {rereads})")
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
    Returns (results, the second graphed run's launches, a function that
    makes the runs' requests anew)."""
    from repro_torch.serve import ServeConfig

    cfg = ServeConfig(**SERVE_CONFIG)
    server.serve_continuous(serve_requests(rng, 4, vocab, 8, 40, 2, n_prefix=2, prefix_len=16), cfg, eager=True)
    state = rng.bit_generator.state

    def make_reqs():
        """The same requests in every run, drawn from a copy of ``rng``."""
        stream = np.random.default_rng()
        stream.bit_generator.state = state
        return serve_requests(stream, 32, vocab, 16, 384, 16, n_prefix=8, prefix_len=128)

    runs = {}
    for run in ("eager", "graphed_1", "graphed_2"):
        runs[run] = serve_continuous_run(server, make_reqs(), cfg, name, run, need)
    # ``rng`` moves past the requests, so the later checks draw what they drew
    # when each run drew its requests from it
    serve_requests(rng, 32, vocab, 16, 384, 16, n_prefix=8, prefix_len=128)
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
    return result, g2["launches"], make_reqs


def serve_continuous_run(server, reqs, cfg, name, run, need, *, outputs=None, tracer=None):
    """One timed ``serve_continuous`` (``run`` "eager" takes the oracle
    route) with the launch counters, host fetches and peak memory reset
    just before and read just after; checks its outputs and returns its
    numbers.  ``outputs`` (a dict) receives (tier, truncated, output) of
    each request by submission index; ``tracer`` traces the run."""
    from repro_torch import kernels
    from repro_torch.core.cascade import host_fetch_stats, reset_host_fetch_stats
    from repro_torch.obs import Observability
    from repro_torch.serve.graphs import capture_seconds, trace_counts

    ob = Observability(tracer=tracer)
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
        forced_completions=st[i]["forced_completions"], spec_drafts=st[i]["spec_drafts"],
        spec_draft_tokens=st[i]["spec_draft_tokens"], spec_accepted_tokens=st[i]["spec_accepted_tokens"],
    ) for i in range(n_tiers)]
    if outputs is not None:
        outputs.update({i: (by_rid[q.rid].tier, by_rid[q.rid].truncated, by_rid[q.rid].output.tolist())
                        for i, q in enumerate(reqs)})
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


# ---------------------------------------------------------------------------
# training: phase 2 (flash lse and gradients, the scans under autograd, the
# inference-only kernels), phase 3 (train steps card vs CPU), phase 4 (full
# width steps and the trained cascade)
# ---------------------------------------------------------------------------

LSE_TOL = 1e-3  # abs, natural-log units: the kernel's ex2.approx sums against exp in f32
GRAD_TOL = 2e-2  # normwise, bf16 gradients (inputs and outputs rounded to bf16)
# the training shapes of flash: B 4 x S 1024 at qwen2.5-3b's (16, 2) heads of
# hd 128; zamba2-2.7b's shared attention (32 heads of hd 80, G 1); a window
# and a softcap at qwen's heads
FLASH_TRAIN_CASES = {
    "qwen2.5-3b": dict(shape=(4, 1024, 16, 2, 128), causal=True),
    "zamba2-2.7b": dict(shape=(4, 1024, 32, 32, 80), causal=True),
    "window_softcap": dict(shape=(4, 1024, 16, 2, 128), causal=True, window=256, softcap=30.0),
}


def grads_of(fn, inputs, weights):
    """Gradients of sum(output_i * weight_i) over fn's outputs with respect
    to ``inputs`` (fresh leaves, so each call starts from nothing)."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum(((o.float() * w).sum() for o, w in zip(outs, weights)), torch.zeros((), device=outs[0].device)).backward()
    return [None if t is None else t.grad for t in leaves]


def check_flash_training(dev, g):
    """The flash kernel's lse output against the plain version's at the
    training shapes (out abs FLASH_TOL, lse abs LSE_TOL), and dq, dk, dv
    through the training route (``FlashAttention``: the kernel forward with
    lse, the plain backward) against autograd of the plain version
    (normwise GRAD_TOL); the forward timed with and without lse, and the
    plain backward."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops

    mk = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
    out = {}
    for name, case in FLASH_TRAIN_CASES.items():
        B, S, H, KVH, hd = case["shape"]
        kw = dict(causal=case["causal"], window=case.get("window"), softcap=case.get("softcap"))
        q, k, v, do = mk(B, S, H, hd), mk(B, S, KVH, hd), mk(B, S, KVH, hd), mk(B, S, H, hd)
        o, lse = ops._flash_cuda(q, k, v, starts=None, return_lse=True, **kw)
        po, plse = ops.flash_attention_plain(q, k, v, return_lse=True, **kw)
        e_out, e_lse = (o.float() - po.float()).abs().max().item(), (lse - plse).abs().max().item()
        require(e_out <= FLASH_TOL, f"flash {name}: out err {e_out} > {FLASH_TOL} with lse")
        require(e_lse <= LSE_TOL, f"flash {name}: lse err {e_lse} > {LSE_TOL}")
        before = kernels.launch_counts()["flash_attention"]
        got = grads_of(lambda q, k, v: ops.flash_attention(q, k, v, **kw), (q, k, v), (do,))
        require(kernels.launch_counts()["flash_attention"] == before + 1, f"flash {name}: the training route "
                                                                          "did not launch the kernel once")
        ref = grads_of(lambda q, k, v: ops.flash_attention_plain(q, k, v, **kw), (q, k, v), (do,))
        errs = {n: normwise_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, ref)}
        for n, e in errs.items():
            require(math.isfinite(e) and e <= GRAD_TOL, f"flash {name}: {n} normwise err {e} > {GRAD_TOL}")
        out[name] = dict(shape=list(case["shape"]), window=kw["window"], softcap=kw["softcap"],
                         out_err=e_out, lse_err=e_lse, grad_normwise_err=errs)
        del q, k, v, do, o, lse, po, plse, got, ref
    B, S, H, KVH, hd = FLASH_TRAIN_CASES["qwen2.5-3b"]["shape"]
    q, k, v, do = mk(B, S, H, hd), mk(B, S, KVH, hd), mk(B, S, KVH, hd), mk(B, S, H, hd)
    fwd = lambda: ops._flash_cuda(q, k, v, causal=True, window=None, softcap=None, starts=None)
    fwd_lse = lambda: ops._flash_cuda(q, k, v, causal=True, window=None, softcap=None, starts=None, return_lse=True)
    o, lse = fwd_lse()
    out["times"] = dict(
        shape=[B, S, H, KVH, hd], fwd_ms=time_ms(fwd), fwd_lse_ms=time_ms(fwd_lse),
        fwd_device_ms=device_ms(fwd), fwd_lse_device_ms=device_ms(fwd_lse),
        bwd_plain_ms=time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True), iters=5),
    )
    out["fwd_bwd"] = flash_fwd_bwd_times(q, k, v, do)
    return out


def flash_fwd_bwd_times(q, k, v, do):
    """The training route's forward and backward (``flash_attention`` under
    grad: the kernel with lse, then the plain backward) against one call of
    the same function in PyTorch (SDPA's forward and its autograd
    backward), causal: event ms, device ms with a cold L2 (the profiler's
    kernel durations: autograd's backward is not captured in a graph here)
    and host µs a call; the bound of the backward's five products over the
    causal pairs (S = Q K^T and P recomputed, dV, dP, dQ, dK)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    B, S, H, hd = q.shape
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    t_leaves = [t.detach().transpose(1, 2).clone().requires_grad_(True) for t in (q, k, v)]
    do_t = do.transpose(1, 2)

    def route():
        with torch.enable_grad():
            return torch.autograd.grad(ops.flash_attention(*leaves, causal=True), leaves, do)

    def sdpa():
        with torch.enable_grad():
            o = F.scaled_dot_product_attention(*t_leaves, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(o, t_leaves, do_t)

    b_ms, b_by = bound(nbytes(q, k, v, q, do) + nbytes(q, k, v), 5 * 2 * hd * B * H * S * (S + 1) // 2, BF16_FLOPS)
    return dict(shape=[B, S, H, k.shape[2], hd], ms=time_ms(route, iters=5), device_ms=profiled_cold_ms(route),
                host_us=host_us(route, calls=5), library_ms=time_ms(sdpa, iters=5),
                library_device_ms=profiled_cold_ms(sdpa), library_host_us=host_us(sdpa, calls=5),
                bwd_bound_ms=b_ms, bwd_bound_by=b_by)


def scan_grad_bound(inputs, weights, step_flops, steps):
    """The bound of a scan's forward and backward: each input read once and
    its gradient written once, each output written once and its gradient
    read once (``weights`` are those gradients); 3x the forward's per-step
    operations (the forward, and the backward's two products a step: the
    state's gradient and the inputs'), on the SIMT f32 peak (the
    reference's gradient is f32)."""
    ins = [t for t in inputs if t is not None]
    return bound(2 * nbytes(*ins) + 2 * nbytes(*weights), 3 * step_flops * steps, F32_FLOPS)


def check_scan_grad(name, fn, plain, inputs, weights, launch_name):
    """Input gradients of the wrapped scan (kernel forward, backward by
    recompute of the plain version) against autograd of the plain version,
    normwise GRAD_TOL; the kernel launches once in the forward.  Also the
    times of the kernel forward, of the wrapped forward + backward and of
    the plain forward + backward."""
    from repro_torch import kernels

    before = kernels.launch_counts()[launch_name]
    got = grads_of(fn, inputs, weights)
    require(kernels.launch_counts()[launch_name] == before + 1, f"{name}: the training route did not launch "
                                                                "the kernel once")
    ref = grads_of(plain, inputs, weights)
    errs = {}
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            continue
        e = normwise_err(a, b)
        require(math.isfinite(e) and e <= GRAD_TOL, f"{name}: grad of input {i} normwise err {e} > {GRAD_TOL}")
        errs[i] = e
    with torch.no_grad():
        fwd_ms = time_ms(lambda: fn(*inputs))
    return dict(grad_normwise_err=errs, fwd_ms=fwd_ms,
                fwd_bwd_ms=time_ms(lambda: grads_of(fn, inputs, weights), iters=5),
                plain_fwd_bwd_ms=time_ms(lambda: grads_of(plain, inputs, weights), iters=5))


def check_ssd_grad(dev, g):
    """``ssd`` under autograd on the card at a reduced zamba2-like shape (8
    heads of P 64, N 64, G 1, ragged S 200, an initial state, per-member A):
    the output and the final state both feed the loss."""
    import torch.nn.functional as F

    from repro_torch.kernels.mamba2_ssd import ops

    B, S, H, P, G, N, E = 4, 200, 8, 64, 1, 64, 2
    rn = lambda *s: torch.randn(*s, device=dev, generator=g)
    x = rn(B, S, H, P).to(torch.bfloat16)
    Bm, Cm = rn(B, S, G, N).mul(0.5).to(torch.bfloat16), rn(B, S, G, N).mul(0.5).to(torch.bfloat16)
    dt, A = F.softplus(rn(B, S, H) - 2.0), -torch.exp(rn(E, H) * 0.3)
    s0 = rn(B, H, N, P).mul(0.2)
    wy, ws = rn(B, S, H, P), rn(B, H, N, P)
    fn = lambda x, dt, A, Bm, Cm, s0: ops.ssd(x, dt, A, Bm, Cm, initial_state=s0, return_final_state=True)
    plain = lambda x, dt, A, Bm, Cm, s0: ops.ssd_plain(x, dt, A, Bm, Cm, initial_state=s0)
    # a step of a (row, head): h = exp(dt A) h + (dt x) B^T and y = C h, two
    # and one multiply-adds an (N, P) element
    b_ms, b_by = scan_grad_bound((x, dt, A, Bm, Cm, s0), (wy, ws), 6 * N * P, B * S * H)
    return dict(name="mamba2_ssd", shape={"x": [B, S, H, P], "B": [B, S, G, N], "E": E},
                **check_scan_grad("ssd grad", fn, plain, (x, dt, A, Bm, Cm, s0), (wy, ws), "mamba2_ssd"),
                bound_ms=b_ms, bound_by=b_by)


def check_wkv6_grad(dev, g):
    """``wkv6`` under autograd on the card at a reduced rwkv6-like shape (8
    heads of D 64, ragged S 77, an initial state, per-member u)."""
    from repro_torch.kernels.rwkv6_wkv import ops

    B, S, H, D, E = 4, 77, 8, 64, 2
    rn = lambda *s: torch.randn(*s, device=dev, generator=g)
    r, k, v = (rn(B, S, H, D).to(torch.bfloat16) for _ in range(3))
    logw, u, s0 = -torch.exp(rn(B, S, H, D) * 0.5), rn(E, H, D).mul(0.5), rn(B, H, D, D).mul(0.1)
    wy, ws = rn(B, S, H, D), rn(B, H, D, D)
    fn = lambda r, k, v, logw, u, s0: ops.wkv6(r, k, v, logw, u, initial_state=s0, return_final_state=True)
    plain = lambda r, k, v, logw, u, s0: ops.wkv6_plain(r, k, v, logw, u, initial_state=s0)
    # a step of a (row, head): y = r (S + u k v^T) and S = w S + k v^T, three
    # multiply-adds a (D, D) element
    b_ms, b_by = scan_grad_bound((r, k, v, logw, u, s0), (wy, ws), 6 * D * D, B * S * H)
    return dict(name="rwkv6_wkv", shape={"r": [B, S, H, D], "E": E},
                **check_scan_grad("wkv6 grad", fn, plain, (r, k, v, logw, u, s0), (wy, ws), "rwkv6_wkv"),
                bound_ms=b_ms, bound_by=b_by)


def check_inference_only(dev):
    """Every kernel with no training route refuses a CUDA input that
    requires grad under grad mode, naming its op (and runs under no_grad)."""
    from repro_torch.kernels.agreement import ops as agree
    from repro_torch.kernels.compaction import ops as compaction
    from repro_torch.kernels.decode_attention import ops as dec

    bf = dict(device=dev, dtype=torch.bfloat16)
    logits = torch.randn(3, 4, 512, device=dev, requires_grad=True)
    rows = torch.randn(8, 16, device=dev, requires_grad=True)
    mask = torch.arange(8, device=dev) % 2 == 0
    imap = torch.arange(8, device=dev, dtype=torch.int32)
    q = torch.randn(4, 1, 8, 64, **bf).requires_grad_(True)
    kc, vc = torch.randn(4, 2, 32, 64, **bf), torch.randn(4, 2, 32, 64, **bf)
    kp, vp = torch.randn(1, 8, 2, 16, 64, **bf), torch.randn(1, 8, 2, 16, 64, **bf)
    pages = torch.arange(8, device=dev, dtype=torch.int32).reshape(4, 2)
    cur = torch.full((4,), 20, device=dev, dtype=torch.int32)
    calls = {
        "member_stats": lambda: agree.member_stats(logits),
        "compact": lambda: compaction.compact(rows, mask),
        "gather_rows": lambda: compaction.gather_rows(rows, imap),
        "paged_kv_view": lambda: compaction.paged_kv_view(kp.requires_grad_(True), vp, pages),
        "decode_attention": lambda: dec.decode_attention_bksd(q, kc, vc, cur_len=20),
        "decode_attention_paged": lambda: dec.decode_attention_paged(q, kp, vp, pages, cur),
    }
    for op, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            require(f"{op}:" in str(e), f"{op}: raised under grad without naming the op: {e}")
        else:
            raise AssertionError(f"{op}: an inference-only kernel ran under grad")
        with torch.no_grad():
            call()
    return sorted(calls)


def flat(tree):
    """Every leaf of a parameter tree as one f32 vector on the host."""
    from repro_torch.models.params import tree_leaves

    return torch.cat([t.detach().float().cpu().reshape(-1) for t in tree_leaves(tree)])


TRAIN_ARCHS = ("qwen2.5-3b", "mixtral-8x22b", "zamba2-2.7b", "rwkv6-7b", "internvl2-26b", "hubert-xlarge")
TRAIN_STEPS_REF = 3
TRAIN_LOSS_TOL = 1e-2  # relative, each step's loss card vs CPU (the forward in bf16)
GRAD_NORM_TOL = 0.25  # relative, the first step's grad_norm card vs CPU
# The first step's gradient, card vs CPU, leaf by leaf in relative L2
# (||g_card - g_cpu|| / ||g_cpu||): at most GRAD_FACTOR times that leaf's
# distance between the CPU's own bf16 and f32 gradients (how far rounding
# alone moves it), at least GRAD_FLOOR and never GRAD_CAP or more, so a
# leaf whose gradient is lost (1.0) or negated (2.0) always fails.  Two
# correct bf16 implementations read up to 1.9 times that distance apart:
# the JAX package's against the port's on the CPU, zamba2's Mamba leaves
# (tests/test_torch_train.py::test_bf16_gradients_within_rounding_of_jax,
# which holds them to the same rule).
GRAD_FACTOR, GRAD_FLOOR, GRAD_CAP = 3.0, 0.1, 0.9


def rel_l2(got, ref):
    """||got - ref|| / ||ref|| in f64 on the host (0 where both are 0)."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    den = ref.norm().item()
    return (got - ref).norm().item() / den if den else float((got != 0).any())


def grad_bound(d_rounding):
    return min(GRAD_CAP, max(GRAD_FLOOR, GRAD_FACTOR * d_rounding))


def first_step_grads(host, cfg, batch, where, f32=False):
    """Every leaf's gradient of ``loss_fn`` at the weights ``host``, on the
    device ``where`` (in f32 where asked), in tree order."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves, tree_map

    c = dataclasses.replace(cfg, dtype="float32") if f32 else cfg
    p = tree_map(lambda t: (t.float() if f32 else t).requires_grad_(True), params_from_numpy(host, c, device=where))
    loss, _ = api.loss_fn(p, batch, c)
    leaves = tree_leaves(p)
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if x is None else x.detach() for x, t in zip(g, leaves)], [x is None for x in g]


def check_adamw_on_card(host, cfg, grads, dev):
    """Three AdamW updates (the default config, clip on) from the same bf16
    weights with the same gradient, on the card and on the CPU: the f32
    moments within 1e-5 normwise of each other, the grad_norm metric within
    1e-5, and every bf16 weight within one unit in the last place (both
    round the same f32 value; a tie can round either way)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.optim import OptimConfig, adamw_init, adamw_update

    ocfg = OptimConfig(lr=3e-4)
    out = {}
    for where in ("cpu", dev):
        params = params_from_numpy(host, cfg, device=where)
        state = adamw_init(params, ocfg)
        g = tree_unflatten(params, [x.to(where) for x in grads])
        for _ in range(3):
            params, state, m = adamw_update(g, state, params, ocfg)
        out[str(where)] = ([tree_leaves(params), tree_leaves(state["m"]), tree_leaves(state["v"])], float(m["grad_norm"]))
    (cpu, gn_cpu), (card, gn_card) = out["cpu"], out[str(dev)]
    errs = {"grad_norm": abs(gn_card - gn_cpu) / gn_cpu}
    require(errs["grad_norm"] <= 1e-5, f"AdamW grad_norm card {gn_card} vs cpu {gn_cpu}")
    for name, a, b in (("m", card[1], cpu[1]), ("v", card[2], cpu[2])):
        errs[name] = max(normwise_err(x.cpu(), y) if y.abs().max() > 0 else float((x != 0).any()) for x, y in zip(a, b))
        require(errs[name] <= 1e-5, f"AdamW {name} card vs cpu normwise {errs[name]} > 1e-5")
    ulp = [((x.cpu().float() - y.float()).abs() > 2.0**-7 * torch.maximum(x.cpu().float().abs(), y.float().abs())).sum().item()
           for x, y in zip(card[0], cpu[0])]
    require(not any(ulp), f"AdamW: bf16 weights card vs cpu more than one ulp apart at {ulp} elements a leaf")
    errs["params_differing"] = sum(int((x.cpu() != y).sum()) for x, y in zip(card[0], cpu[0]))
    return errs


def train_batch(cfg, rng, B, S):
    """A numpy batch for ``loss_fn``: tokens and next-token targets (the
    encoder: frames in place of tokens; the VLM: its patches before them)."""
    if cfg.is_encoder:
        return {"embeds": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    rows = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:], "mask": np.ones((B, S), np.float32)}
    if cfg.n_vision_tokens:
        batch["embeds"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def check_training_on_card(dev, seed):
    """Three train steps of each of ``TRAIN_ARCHS`` at reduced width, card
    against CPU from the same bf16 weights (carried by ``bridge``) on the
    same batches: each step's loss at TRAIN_LOSS_TOL, the parameters after
    the last step normwise at REF_TOL; on the card the flash kernel (and the
    scans, for the state families) launched, on the CPU no kernel.  The
    gradient itself at the first weights: grad_norm at GRAD_NORM_TOL, every
    leaf and the whole tree within ``grad_bound`` of the CPU's (relative
    L2).  Three AdamW updates with one gradient, card against CPU
    (``check_adamw_on_card``).  Then a checkpoint of the card's trained
    parameters restores bitwise on the card.

    After the first step the two devices' weights part (AdamW's first
    updates are about lr * sign(g), and a random reduced model's gradient
    moves with rounding: bf16 against f32 on an H100 host's CPU 0.025 to
    1.92 in relative L2 over the tree), so later steps' gradients are read,
    not held."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.bridge import params_from_numpy, params_to_numpy
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_train_state, make_train_step

    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        host = params_to_numpy(api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu"))
        rng = np.random.default_rng(seed + 5)
        batches = [train_batch(cfg, rng, 2, 64) for _ in range(TRAIN_STEPS_REF)]
        ocfg = OptimConfig(lr=3e-4)
        runs = {}
        for where in ("cpu", dev):
            params = params_from_numpy(host, cfg, device=where)
            state = init_train_state(params, ocfg)
            step = make_train_step(cfg, ocfg, total_steps=10, warmup_steps=1)
            kernels.reset_launch_counts()
            hist = []
            for b in batches:
                state, m = step(state, b)
                hist.append({k: float(m[k]) for k in ("loss", "grad_norm", "aux")})
            runs[str(where)] = (state, hist, kernels.launch_counts())
        (cpu_state, cpu_hist, cpu_counts), (card_state, card_hist, card_counts) = runs["cpu"], runs[str(dev)]
        require(all(n == 0 for n in cpu_counts.values()), f"{arch}: the CPU train step launched {cpu_counts}")
        used = ["flash_attention"] if cfg.family not in ("ssm_rwkv6",) else []
        used += {"hybrid": ["mamba2_ssd"], "ssm_mamba2": ["mamba2_ssd"], "ssm_rwkv6": ["rwkv6_wkv"]}.get(cfg.family, [])
        for n in used:
            require(card_counts[n] > 0, f"{arch}: the card's train step never launched {n}")
        require(all(card_counts[n] == 0 for n in card_counts if n not in used),
                f"{arch}: the card's train step launched an inference kernel: {card_counts}")
        errs = {}
        errs["loss"] = [abs(c["loss"] - a["loss"]) / abs(a["loss"]) for c, a in zip(card_hist, cpu_hist)]
        require(max(errs["loss"]) <= TRAIN_LOSS_TOL, f"{arch}: train losses card vs cpu {errs['loss']} > {TRAIN_LOSS_TOL}")
        errs["grad_norm"] = [abs(c["grad_norm"] - a["grad_norm"]) / abs(a["grad_norm"]) for c, a in zip(card_hist, cpu_hist)]
        require(errs["grad_norm"][0] <= GRAD_NORM_TOL,
                f"{arch}: first step's grad_norm card vs cpu {errs['grad_norm'][0]} > {GRAD_NORM_TOL}")
        errs["params"] = normwise(flat(card_state.params), flat(cpu_state.params),
                                  f"{arch} params after {TRAIN_STEPS_REF} steps card vs cpu")
        # the first step's gradient leaf by leaf, against the CPU's bf16 and,
        # for the yardstick of rounding, the CPU's f32 of the same weights
        g_cpu, unused_cpu = first_step_grads(host, cfg, batches[0], "cpu")
        g_card, unused_card = first_step_grads(host, cfg, batches[0], dev)
        g_f32, _ = first_step_grads(host, cfg, batches[0], "cpu", f32=True)
        require(unused_card == unused_cpu, f"{arch}: leaves without a gradient card {unused_card} vs cpu {unused_cpu}")
        leaf, bound, rounding = [], [], []
        for c, a, f in zip(g_card, g_cpu, g_f32):
            leaf.append(rel_l2(c, a))
            rounding.append(rel_l2(a, f))
            bound.append(grad_bound(rounding[-1]))
        bad = [(i, round(e, 4), round(t, 4)) for i, (e, t) in enumerate(zip(leaf, bound)) if not e <= t]
        require(not bad, f"{arch}: first-step gradient card vs cpu (leaf, rel L2, bound) {bad}")
        cat = lambda gs: torch.cat([x.double().cpu().reshape(-1) for x in gs])
        tree, tree_rounding = rel_l2(cat(g_card), cat(g_cpu)), rel_l2(cat(g_cpu), cat(g_f32))
        require(tree <= grad_bound(tree_rounding), f"{arch}: first-step gradient card vs cpu, whole tree, rel L2 "
                                                   f"{tree} > {grad_bound(tree_rounding)}")
        errs.update(grad_leaf_rel_l2=leaf, grad_leaf_bound=bound, grad_leaf_rounding=rounding, grad_tree_rel_l2=tree,
                    grad_tree_bound=grad_bound(tree_rounding), grad_tree_rounding=tree_rounding)
        errs["adamw"] = check_adamw_on_card(host, cfg, g_card, dev)
        if cfg.family == "moe":
            require(all(h["aux"] > 0 for h in card_hist), f"{arch}: the MoE's aux term is {card_hist}")
        log(f"  [train {arch}] losses {max(errs['loss']):.2e}, grad_norm {errs['grad_norm'][0]:.3f} (bound "
            f"{GRAD_NORM_TOL}); gradient rel L2 tree {tree:.4f} (bound {grad_bound(tree_rounding):.3f}), worst leaf "
            f"{max(leaf):.4f}; AdamW m {errs['adamw']['m']:.1e} v {errs['adamw']['v']:.1e}")
        out[arch] = dict(normwise_err=errs, card=card_hist, cpu=cpu_hist,
                         card_launches={n: card_counts[n] for n in used})
    with tempfile.TemporaryDirectory(dir=str(Path(__file__).resolve().parent / "build")) as d:
        save_checkpoint(d, TRAIN_STEPS_REF, card_state.params)
        back = restore_checkpoint(d, card_state.params)
        same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                   for a, b in zip(tree_leaves(card_state.params), tree_leaves(back)))
    require(same, f"{arch}: a checkpoint of the card's parameters does not restore bitwise")
    out["checkpoint_roundtrip_bitwise"] = same
    return out


# phase 4 (a): qwen2.5-3b at published width, remat on
TRAIN_FULL = dict(arch="qwen2.5-3b", batch=4, seq=1024, warmup_steps=1, steps=5)


DEEP_WITNESS = dict(n_layers=36, d_model=512, d_ff=1024, n_heads=8)  # qwen2.5-3b's depth at a width both devices run
DEEP_DECADES = 3.0  # |log10(card / cpu)| of its grad_norm


def deep_gradient_witness(dev, seed):
    """The gradient's growth with depth under the reference's init, at
    qwen2.5-3b's 36 layers and d 512 (``DEEP_WITNESS``; reduced vocabulary):
    the first step's grad_norm on the card and on the CPU from the same bf16
    weights, each from the f64 sum of every leaf's squares.  Both must be
    finite and within DEEP_DECADES decades of each other: each layer
    amplifies rounding, so at this depth the two devices agree in size, not
    in value (an H100 and its host's CPU read 1.4 decades apart)."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), **DEEP_WITNESS)
    host = params_to_numpy(api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu"))
    batch = train_batch(cfg, np.random.default_rng(seed + 5), 2, 64)
    norms = {}
    for where in ("cpu", dev):
        g, _ = first_step_grads(host, cfg, batch, where)
        norms[str(where)] = math.sqrt(sum(x.double().square().sum().item() for x in g))
    card, cpu = norms[str(dev)], norms["cpu"]
    require(math.isfinite(card) and math.isfinite(cpu) and card > 0 and cpu > 0, f"deep witness grad_norm {norms}")
    decades = abs(math.log10(card / cpu))
    require(decades <= DEEP_DECADES, f"deep witness: grad_norm card {card:.4g} vs cpu {cpu:.4g}, {decades:.2f} decades")
    log(f"  [train deep witness] {cfg.n_layers} layers, d {cfg.d_model}: grad_norm card {card:.4g}, cpu {cpu:.4g}")
    return dict(config=DEEP_WITNESS, grad_norm_card=card, grad_norm_cpu=cpu, decades=decades)


def train_full_width(dev, seed):
    """``TRAIN_FULL``: one warm-up step, then timed steps of B x S tokens of
    ``sequence_task``; finite losses and 2 flash launches a layer a step (the
    forward and remat's recompute).  The init rule is the JAX package's
    (std 1/sqrt(fan_in), no scaling by depth), under which the gradient grows
    with depth: at 36 layers its global norm overflows f32, the clip's scale
    is 0 and a step applies weight decay alone, so the losses stay level.
    The step's work is the same.  After the timed steps one more forward
    and backward, outside the step, shows what overflows: every leaf's
    gradient finite, each leaf's sum of squares in f64, and the f64 total
    above f32's range wherever the step's grad_norm was inf.  It also
    splits the peak memory by stage: weights, moments, the forward's
    saved activations, the backward and the AdamW update."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, batches, sequence_task, to_device
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.optim import OptimConfig, adamw_update
    from repro_torch.train import init_train_state, make_train_step

    c = TRAIN_FULL
    cfg = get_config(c["arch"])
    require(cfg.remat, f"{cfg.name}: remat off")
    n_steps = c["warmup_steps"] + c["steps"]
    rows = sequence_task(c["batch"] * n_steps, c["seq"], vocab=min(cfg.vocab_size, 512), seed=seed)
    it = batches(TokenDataset(rows), c["batch"], seed=seed)
    gib = lambda: torch.cuda.memory_allocated() / 2**30
    mem = {}
    torch.cuda.reset_peak_memory_stats()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    mem["weights"] = gib()
    ocfg = OptimConfig(lr=3e-4)
    state = init_train_state(params, ocfg)
    del params
    mem["weights_and_moments"] = gib()
    step = make_train_step(cfg, ocfg, total_steps=n_steps, warmup_steps=1)
    walls, losses, grad_norms, per_step = [], [], [], []
    counts = collections.Counter()
    for i in range(n_steps):
        b = to_device(next(it), dev)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        n = kernels.launch_counts()
        per_step.append(n["flash_attention"])
        if i >= c["warmup_steps"]:
            counts.update(n)
        grad_norms.append(float(m["grad_norm"]))
        log(f"  [train {cfg.name}] step {i + 1}: loss {losses[-1]:.4f} grad_norm {grad_norms[-1]:.4g} "
            f"wall {walls[-1]:.3f}s flash launches {n['flash_attention']}")
    timed = walls[c["warmup_steps"]:]
    mem["step_peak"] = torch.cuda.max_memory_allocated() / 2**30
    require(all(math.isfinite(x) for x in losses), f"train {cfg.name}: losses {losses}")
    require(all(n == 2 * cfg.n_layers for n in per_step), f"train {cfg.name}: flash launches a step {per_step}, "
                                                          f"not {2 * cfg.n_layers}")

    # the step's stages again, outside the step, on the next batch (the second epoch's first)
    b = to_device(next(it), dev)
    del m
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(state.params)]
    with torch.enable_grad():
        loss, _ = api.loss_fn(tree_unflatten(state.params, leaves), b, cfg)
        mem["after_forward"], mem["forward_peak"] = gib(), torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    del loss, leaves
    mem["after_backward"], mem["backward_peak"] = gib(), torch.cuda.max_memory_allocated() / 2**30
    finite = [bool(torch.isfinite(g).all()) for g in grads]
    sq64 = [g.double().square().sum().item() for g in grads]
    sq32_inf = sum(not math.isfinite(g.float().square().sum().item()) for g in grads)
    total64 = sum(sq64)
    f32_max = float(torch.finfo(torch.float32).max)
    require(all(finite), f"train {cfg.name}: leaves {[i for i, f in enumerate(finite) if not f]} have a "
                         f"non-finite gradient")
    require(math.isfinite(total64), f"train {cfg.name}: f64 sum of squares {total64}")
    require(all(math.isfinite(x) for x in grad_norms) or total64 > f32_max,
            f"train {cfg.name}: grad_norm {grad_norms} inf while the f64 sum of squares {total64:.4g} fits f32")
    torch.cuda.reset_peak_memory_stats()
    adamw_update(tree_unflatten(state.params, grads), state.opt, state.params, ocfg)
    torch.cuda.synchronize()
    mem["optimizer_peak"] = torch.cuda.max_memory_allocated() / 2**30
    del grads
    big = max(range(len(sq64)), key=sq64.__getitem__)
    overflow = dict(all_leaves_finite=all(finite), f64_grad_norm=math.sqrt(total64),
                    f64_sum_of_squares=total64, f32_max=f32_max, leaves_f32_sum_of_squares_inf=sq32_inf,
                    largest_leaf=big, largest_leaf_f64_sum_of_squares=sq64[big])
    log(f"  [train {cfg.name}] gradient after the steps: every leaf finite, f64 norm {math.sqrt(total64):.4g} "
        f"(f32 sum of squares overflows past {f32_max:.4g}; {sq32_inf} of {len(sq64)} leaves overflow alone); "
        f"memory GiB {json.dumps({k: round(v, 2) for k, v in mem.items()})}")
    tokens = c["batch"] * c["seq"]
    res = dict(arch=cfg.name, layers=cfg.n_layers, batch=c["batch"], seq=c["seq"], remat=cfg.remat,
               params=sum(t.numel() for t in tree_leaves(state.params)), losses=losses, grad_norms=grad_norms,
               step_wall_s=walls,
               median_step_s=float(np.median(timed)), tokens_per_s=tokens / float(np.median(timed)),
               peak_memory_gib=mem["step_peak"], memory_gib=mem, flash_launches_per_step=per_step,
               gradient_overflow=overflow)
    del state, b
    return res, dict(counts)


def trained_cascade(dev):
    """examples/train_then_cascade.py on the card through its port
    (``repro_torch.examples.train_then_cascade``), at the example's own
    widths: three small members (d 48, 2 heads of hd 24; 300 steps each)
    and one big model (d 160, 4 heads of hd 40; 600 steps) trained on
    ``MixtureTask`` (flash's padded widths under the training route), theta
    calibrated on 100 held-out samples (vote rule, epsilon 0.05), then 1024
    fresh requests classified through ``CascadeServer``.  Each model's loss
    must fall (mean of the last 10 steps below the first 10's by 1.0); the
    card's pred and tier_of must equal the port's CPU classify on the same
    trained weights except at rows a near tie can flip (``unsettled``
    members or answers); the selection rate must lie strictly between 0
    and 1.  The example's seeds are its own (0-2 and 7), as in the
    reference."""
    from repro_torch import kernels
    from repro_torch.examples import train_then_cascade as ex
    from repro_torch.models.params import tree_map
    from repro_torch.serve import CascadeServer, CascadeTier

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stacked, big_vals, losses = ex.train_tiers(ex.parse_args([]), dev)  # the example's own steps
    for s_, l_ in losses.items():
        first, last = float(l_[:10].mean()), float(l_[-10:].mean())
        log(f"  [train_then_cascade seed {s_}] {len(l_)} steps: loss first 10 {first:.3f}, last 10 {last:.3f}")
        require(last < first - 1.0, f"train_then_cascade seed {s_}: loss {first:.3f} -> {last:.3f} did not fall by 1.0")
    train_s = time.perf_counter() - t0
    train_counts = kernels.launch_counts()
    theta, info = ex.calibrate(stacked, ex.SMALL, ex.TASK, seed=999)
    kernels.reset_launch_counts()
    rep = ex.serve(stacked, big_vals, theta, dev)
    classify_counts = kernels.launch_counts()
    for n in ("flash_attention", "agreement"):
        require(classify_counts[n] > 0, f"trained cascade: classify launched no {n} kernel")
    server, res, test_toks = rep["server"], rep["result"], rep["tokens"]
    sel = res.tier_of == 0
    require(0.0 < sel.mean() < 1.0, f"trained cascade: selection rate {sel.mean()}")

    # the port's CPU classify of the same trained weights
    cpu_tiers = [CascadeTier(t.cfg, tree_map(lambda x: x.cpu(), t.values), t.spec, device="cpu") for t in server.tiers]
    cpu = CascadeServer(cpu_tiers, device="cpu").classify(test_toks)
    with torch.no_grad():
        near = unsettled(cpu_tiers[0].last_logits(test_toks, eager=True),
                         server.tiers[0].last_logits(test_toks, eager=True)).any(0)
        near |= unsettled(cpu_tiers[1].last_logits(test_toks, eager=True)[0],
                          server.tiers[1].last_logits(test_toks, eager=True)[0])
    differ = (res.pred != cpu.pred) | (res.tier_of != cpu.tier_of)
    require(not (differ & ~near).any(), f"trained cascade: card and CPU classify differ at rows "
                                        f"{np.flatnonzero(differ & ~near).tolist()}, none a near tie")
    easy = rep["easy"]
    report = dict(
        widths={c.name: dict(d_model=c.d_model, n_heads=c.n_heads, head_dim=c.head_dim, d_ff=c.d_ff)
                for c in (ex.SMALL, ex.BIG)},
        train_s=train_s, losses={str(s_): [float(l_[:10].mean()), float(l_[-10:].mean())] for s_, l_ in losses.items()},
        theta=theta, calibration=info, accuracy_cascade=rep["accuracy_cascade"],
        accuracy_big_only=rep["accuracy_big_only"], tier_fractions=[float(f) for f in rep["tier_fractions"]],
        cost=float(res.cost), cost_always_large=25.0 * len(test_toks), cost_ratio=25.0 * len(test_toks) / float(res.cost),
        easy_share_exits=float(easy[sel].mean()), easy_share_deferred=float(easy[~sel].mean()),
        card_vs_cpu=dict(differ=int(differ.sum()), near_ties=int(near.sum())),
        launches={"train": dict(train_counts), "classify": dict(classify_counts)},
    )
    log(f"  [trained cascade] hd {ex.SMALL.head_dim} / {ex.BIG.head_dim}: accuracy cascade "
        f"{report['accuracy_cascade']:.3f} vs big-only {report['accuracy_big_only']:.3f}; {report['cost_ratio']:.2f}x "
        f"cheaper; card vs CPU {report['card_vs_cpu']}")
    return report, {"train": dict(train_counts), "classify": dict(classify_counts)}


def edge_to_cloud_example(dev):
    """examples/edge_to_cloud.py on the card through its port
    (``repro_torch.examples.edge_to_cloud``), at the example's widths (hd 16
    at the edge, 32 in the cloud) and training steps (200 and 400):
    classify 256 prompts over the ``sim`` link (the hop the deferred rows
    padded to the bucket, card against the CPU on the same weights equal
    but at near ties), then ``serve_continuous`` over the sim, serial and
    async 40 ms links: the same generations and hops under every link, the
    paged decode at the padded widths launched.  Returns (results, launches
    by run)."""
    from repro_torch import kernels
    from repro_torch.examples import edge_to_cloud as ex
    from repro_torch.models.params import tree_map

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    args = ex.parse_args([])
    edge, cloud = ex.train_tiers(args, dev)
    train_s = time.perf_counter() - t0
    launches = {"train": kernels.launch_counts()}
    theta, _ = ex.calibrate(edge, ex.EDGE, ex.TASK, seed=77)
    toks = ex.TASK.sample(256, seed=42)[0]
    kernels.reset_launch_counts()
    res, placement = ex.classify_over_link(edge, cloud, theta, toks, dev)
    launches["classify"] = kernels.launch_counts()
    link = placement.link(0)
    S = toks.shape[1]
    require(link.total_examples == int((res.tier_of == 1).sum()) and
            link.total_bytes == res.evaluated[1] * (S * 4 + 4), f"edge_to_cloud classify: hops {hop_list(link)}")
    cpu_res, _ = ex.classify_over_link(tree_map(lambda t: t.cpu(), edge), tree_map(lambda t: t.cpu(), cloud), theta,
                                       toks, torch.device("cpu"))
    cpu_tiers = ex.tiers(tree_map(lambda t: t.cpu(), edge), tree_map(lambda t: t.cpu(), cloud), theta, torch.device("cpu"))
    card_tiers = ex.tiers(edge, cloud, theta, dev)
    with torch.no_grad():
        near = vote_unsettled(cpu_tiers[0].last_logits(toks, eager=True), card_tiers[0].last_logits(toks, eager=True),
                              cpu_res.pred)
        near |= unsettled(cpu_tiers[1].last_logits(toks, eager=True)[0], card_tiers[1].last_logits(toks, eager=True)[0])
    differ = (res.pred != cpu_res.pred) | (res.tier_of != cpu_res.tier_of)
    require(not (differ & ~near).any(), f"edge_to_cloud classify: card and CPU differ at rows "
                                        f"{np.flatnonzero(differ & ~near).tolist()}, none a near tie")
    serve = {}
    for kind in ("sim", "serial", "async"):
        kernels.reset_launch_counts()
        done, wall, ln = ex.serve_over_link(card_tiers, kind, dev)
        launches[f"serve_{kind}"] = kernels.launch_counts()
        serve[kind] = dict(wall_s=wall, generations=ex.generations(done),
                           hops=[(h.n_examples, h.payload_bytes) for h in ln.hops], latency_s=ln.total_latency,
                           wait_s=ln.total_wait)
    require(serve["sim"]["generations"] == serve["serial"]["generations"] == serve["async"]["generations"],
            "edge_to_cloud serve: the links give other generations")
    require(serve["serial"]["hops"] == serve["async"]["hops"], "edge_to_cloud serve: serial and async meter other hops")
    for kname in ("decode_attention_paged", "compaction"):
        require(launches["serve_async"][kname] > 0, f"edge_to_cloud serve: {kname} not launched")
    require(launches["classify"]["agreement"] > 0 and launches["classify"]["flash_attention"] > 0,
            f"edge_to_cloud classify: launches {launches['classify']}")
    out = dict(widths={c.name: c.head_dim for c in (ex.EDGE, ex.CLOUD)},
               steps=dict(edge=args.edge_steps, cloud=args.cloud_steps), train_s=train_s,
               theta=theta, deferred=int(res.tier_counts[1]), bytes_crossed=link.total_bytes,
               batch_bytes=toks.size * 4, card_vs_cpu=dict(differ=int(differ.sum()), near_ties=int(near.sum())),
               serve={k: {x: v for x, v in r.items() if x != "generations"} for k, r in serve.items()},
               overlap_ratio=serve["serial"]["wall_s"] / serve["async"]["wall_s"], launches=launches)
    log(f"  [edge_to_cloud] {json.dumps(out)}")
    return out, launches


def serve_cli_path(dev, seed):
    """The serve CLI (``repro_torch.launch.serve``) at published width,
    ``--tiers qwen2.5-3b:3 internlm2-1.8b:1`` on the card: its tiers built
    once (weights from ``--seed``), then its classify and its generate (64
    prompts of 64 tokens each): every request answered, the mode's kernels
    launched.  Returns (results, launches by mode)."""
    from repro_torch import kernels
    from repro_torch.launch import serve as cli

    need = dict(classify=("agreement", "compaction", "flash_attention"),
                generate=("compaction", "flash_attention", "decode_attention"))
    results, launches = {}, {}
    argv = ["--tiers", "qwen2.5-3b:3", "internlm2-1.8b:1", "--seed", str(seed)]
    tiers = cli.build_tiers(cli.parse_args(argv))  # one set of weights for both modes
    for mode in ("classify", "generate"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = cli.serve(cli.parse_args(argv + ["--mode", mode]), tiers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = kernels.launch_counts()
        require(int(res.tier_counts.sum()) == 64, f"serve CLI {mode}: {res.tier_counts} answered of 64")
        for n in need[mode]:
            require(launches[mode][n] > 0, f"serve CLI {mode}: {n} not launched")
        results[mode] = dict(wall_s=wall, tier_counts=res.tier_counts.tolist(), evaluated=res.evaluated.tolist(),
                             cost=float(res.cost), outputs_digest=outputs_digest(res.pred, res.tier_of),
                             launches=launches[mode])
        del res
    del tiers
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve CLI] {json.dumps(results)}")
    return results, launches


def train_path(dev, seed):
    """Phase 4's training: ``deep_gradient_witness``, ``train_full_width``,
    then ``trained_cascade``.  Returns (report, launches by run)."""
    deep = deep_gradient_witness(dev, seed)
    full, full_counts = train_full_width(dev, seed)
    log(f"[train {full['arch']}] {full['batch']} x {full['seq']} tokens, {full['layers']} layers, remat: median "
        f"step {full['median_step_s']:.3f}s, {full['tokens_per_s']:.0f} tokens/s, peak "
        f"{full['peak_memory_gib']:.1f} GiB; losses {[round(x, 4) for x in full['losses']]}")
    gc.collect()
    torch.cuda.empty_cache()
    cascade, cascade_counts = trained_cascade(dev)
    return dict(deep_witness=deep, full_width=full, trained_cascade=cascade), {
        "full_width": full_counts, "cascade_train": cascade_counts["train"],
        "cascade_classify": cascade_counts["classify"],
    }


# ---------------------------------------------------------------------------
# pod_classify: the first cascade's classify over a mesh placement, its
# ranks time-sharing the one card
# ---------------------------------------------------------------------------

POD_TIERS = ("qwen2.5-3b", "internlm2-1.8b")
POD_MESHES = {"pod_classify_2": 2, "pod_classify_4": 4, "pod_classify_6": 6}
POD_NEED = ("agreement", "compaction", "flash_attention")
# generate and serve over the mesh: on (2, 1, 1) and on (6, 1, 1), where
# tier 1's three members lie one a rank and draw on their global index
POD_SERVE_WORLDS = (2, 6)
POD_SERVE_NEED = {"generate": ("compaction", "flash_attention", "decode_attention"),
                  "serve": ("compaction", "decode_attention_paged")}
POD_SERVE_CONFIG = dict(n_slots=4, max_seq=256, page_size=16)


POD_ANSWER_THETA = 0.25  # a vote share of 1/3 exceeds it: one member's vote answers


def pod_serve_specs(theta=0.5):
    """generate's and serve's specs: defer unless 2 of 3 members agree
    (θ 0.5), or never (``POD_ANSWER_THETA``)."""
    from repro_torch.core.cascade import TierSpec

    return (TierSpec(f"{POD_TIERS[0]}-x3", "vote", theta, k=3, cost=3.0),
            TierSpec(POD_TIERS[1], "confidence", -1.0, k=1, cost=1.0))


def pod_serve_inputs(seed):
    """generate's batch (8 x 128, the main path's) and serve's 8 requests of
    16-128 tokens and 16 new, below both tiers' vocabularies."""
    from repro_torch.configs import get_config

    vocab = min(get_config(a).vocab_size for a in POD_TIERS)
    rng = np.random.default_rng(seed + 13)
    toks = rng.integers(0, vocab, (8, 128)).astype(np.int32)
    prompts = [rng.integers(0, vocab, int(rng.integers(16, 129))).astype(np.int32) for _ in range(8)]
    return toks, prompts


def retiered(server, specs, temperature=0.0):
    """``server`` over the same (placed) weights with other tier specs and
    temperature: new tier objects (graphs of their own) on the same
    tensors, each keeping its member offset and 'pod' group."""
    import copy

    out = copy.copy(server)
    out.tiers = [dataclasses.replace(t, spec=sp, temperature=temperature) for t, sp in zip(server.tiers, specs)]
    return out


def pod_serve_runs(server, seed, link=None, *, timed=False):
    """generate (greedy, 16 new) and serve_continuous (greedy and T = 0.8)
    of ``server``'s tiers under the serving specs, then both at T = 0.8
    and ``POD_ANSWER_THETA``, where tier 1 answers with its sampled
    generations, each graphed once.  With ``timed`` every rank meets at a
    barrier before each call, and the launch counters are zeroed just
    before it and read just after.  The last run also keeps, on the rank
    that votes, every member's generation of each tier-1 vote, in the
    order the slots completed (``votes``)."""
    from repro_torch.kernels import build
    from repro_torch.serve import Request, ServeConfig

    toks, prompts = pod_serve_inputs(seed)
    res = {}

    def run(key, call):
        if timed:
            import torch.distributed as dist

            dist.barrier()
            build.reset_launch_counts()
        n0 = len(link.hops) if link is not None else 0
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        if timed:
            out["launches"] = build.launch_counts()
        if link is not None:
            out["hops"] = [[h.n_examples, h.payload_bytes] for h in link.hops[n0:]]
        res[key] = out

    def generate(T=0.0, theta=0.5):
        r = retiered(server, pod_serve_specs(theta), T).generate(toks, 16)
        return {"pred": r.pred.tolist(), "tier_of": r.tier_of.tolist(), "tier_counts": r.tier_counts.tolist()}

    def serve(T, theta=0.5):
        reqs = [Request(tokens=t, max_new_tokens=16) for t in prompts]
        done = retiered(server, pod_serve_specs(theta), T).serve_continuous(
            reqs, ServeConfig(**POD_SERVE_CONFIG, seed=seed))
        order = {id(r): i for i, r in enumerate(reqs)}
        return {"out": [[r.output.tolist(), r.tier, r.truncated] for r in reqs], "order": [order[id(r)] for r in done]}

    run("generate", generate)
    for T in (0.0, 0.8):
        run(f"serve@{T:g}", functools.partial(serve, T))
    run("generate@0.8/answer", functools.partial(generate, 0.8, POD_ANSWER_THETA))
    from repro_torch.serve import cascade_server

    votes, vote = [], cascade_server._CascadeRun._vote

    def spy(self, i, gen):
        if i == 0:
            votes.append(gen.tolist())
        return vote(self, i, gen)

    cascade_server._CascadeRun._vote = spy
    try:
        run("serve@0.8/answer", functools.partial(serve, 0.8, POD_ANSWER_THETA))
    finally:
        cascade_server._CascadeRun._vote = vote
    res["votes"] = votes
    return res


def vote_winner(gens):
    """(digest, generation) tier 1's vote picks among its members'
    generations (``vote_rule_from_preds`` on their digests: most votes,
    then the smallest digest)."""
    from repro_torch.serve.cascade_server import stable_digest

    d = np.asarray([stable_digest(np.asarray(g, np.int32)) for g in gens], np.int32)
    counts = np.asarray([(d == x).sum() for x in d])
    best = d[counts == counts.max()].min()
    return int(best), list(gens[int(np.argmax(d == best))])


def pod_member_refs(v1, seed, dev):
    """Each tier-1 member alone, unplaced: a one-member tier of member e's
    weights drawing as member e (``member_offset``), generate (8 x 128,
    16 new) and serve_continuous of the pod's requests at T = 0.8.  This
    is what a rank holding that member alone computes, at the same shapes;
    the stacked three-member tier runs its products at another batch count
    and need not give the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.core.cascade import TierSpec
    from repro_torch.models.params import tree_map
    from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig

    toks, prompts = pod_serve_inputs(seed)
    out = {"generate": [], "serve": []}
    for e in range(3):
        tier = CascadeTier(get_config(POD_TIERS[0]), tree_map(lambda t: t[e:e + 1].clone(), v1),
                           TierSpec(f"m{e}", "vote", POD_ANSWER_THETA, k=1), temperature=0.8, member_offset=e,
                           device=dev)
        out["generate"].append(tier.generate(toks, 16)[0].tolist())
        reqs = [Request(tokens=t, max_new_tokens=16) for t in prompts]
        CascadeServer([tier], device=dev).serve_continuous(reqs, ServeConfig(**POD_SERVE_CONFIG, seed=seed))
        out["serve"].append([r.output.tolist() for r in reqs])
        del tier
    return out


def pod_values(arch, k, seed, device):
    """Tier weights of the pod phase, each tier from a generator of its own
    (``seed`` + 10 for tier 1, + 11 for tier 2), so a rank draws one tier
    without the other; on ``"meta"`` nothing is drawn."""
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens

    gen = torch.Generator(device=device if device != "meta" else "cpu").manual_seed(seed)
    return ens.init_ensemble(get_config(arch), k, gen, device)


def pod_specs(theta):
    from repro_torch.core.cascade import TierSpec

    return (TierSpec(f"{POD_TIERS[0]}-x3", "score", theta, k=3, cost=3.0),
            TierSpec(POD_TIERS[1], "confidence", -1.0, k=1, cost=1.0))


def pod_inputs(seed):
    """The calibration batch and the classify batch, 32 x 256 each, below
    both tiers' vocabularies."""
    from repro_torch.configs import get_config

    vocab = min(get_config(a).vocab_size for a in POD_TIERS)
    rng = np.random.default_rng(seed + 12)
    return rng.integers(0, vocab, (32, 256)).astype(np.int32), rng.integers(0, vocab, (32, 256)).astype(np.int32)


def pod_server(dev, seed, theta, placement):
    """The cascade over ``placement`` on this rank: the tier of this rank's
    slice drawn whole, placed (a rank keeps its members), then dropped; the
    other tier meta.  The ranks of a slice draw one after another, so one
    whole tier 1 at a time lives on the card."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.serve import CascadeServer, CascadeTier

    from repro_torch.serve.placement import place_tier_values

    ks, seeds = (3, 1), (seed + 10, seed + 11)
    mine = [h.mesh.get_coordinate() is not None for h in placement.hosts]
    server, times = None, {}
    # the first DTensor a process makes costs seconds of one-time setup
    # (torch._dynamo's import; ~8 s on an H100 host, PERF.md §6): every
    # rank pays it at once here, not one after another in the turns below
    t0 = time.perf_counter()
    place_tier_values({"w": torch.zeros(3, 1, device=dev)}, placement.hosts[mine.index(True)])
    times["warm_s"] = time.perf_counter() - t0
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            t0 = time.perf_counter()
            values = [pod_values(a, k, sd, dev if here else "meta") for a, k, sd, here in zip(POD_TIERS, ks, seeds, mine)]
            torch.cuda.synchronize()
            times["draw_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tiers = [CascadeTier(get_config(a), v, spec, device=dev)
                     for a, v, spec in zip(POD_TIERS, values, pod_specs(theta))]
            del values
            server = CascadeServer(tiers, device=dev, placement=placement)
            del tiers
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # the whole tier goes back to the card for the next rank
            times["place_s"] = time.perf_counter() - t0
        dist.barrier()
    return server, times


def pod_rank(rank, world, root, seed, theta):
    """One rank of a pod world: a ``gloo`` group (NCCL takes one rank a
    card), compute on ``cuda:0``, kernels loaded as the parent built them.
    Runs the mesh placement's classify eager, graphed twice (the launch
    counters zeroed just before the second and read just after), then the
    replicated baseline's graphed classify, and writes its JSON."""
    import datetime

    import torch.distributed as dist

    from repro_torch.device import rank_device
    from repro_torch.kernels import build
    from repro_torch.serve.placement import pod_placement
    from repro_torch.sharding.mesh import device_mesh

    build.load_only()
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(root) / "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    dev = rank_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = device_mesh(dev, (world, 1, 1), ("pod", "data", "model"))
    _, toks = pod_inputs(seed)
    out = {"rank": rank, "device": str(dev)}
    with torch.no_grad():
        for shard_examples in (True, False):
            placement = pod_placement(mesh, 2, shard_examples=shard_examples)
            t0 = time.perf_counter()
            server, times = pod_server(dev, seed, theta, placement)
            build_s = time.perf_counter() - t0
            # the rows tier 2 is fed a call on this rank: its block of each
            # chunk of the cover
            fed, tier2 = [], server.tiers[1]
            if placement.hosts[1].mesh.get_coordinate() is not None:
                def spy(tokens, *, eager=False, inner=tier2.last_logits):
                    fed.append(int(tokens.shape[0]))
                    return inner(tokens, eager=eager)

                tier2.last_logits = spy
            torch.cuda.reset_peak_memory_stats()
            runs = ("eager", "graphed_1", "graphed_2") if shard_examples else ("graphed_1",)
            res = {}
            for run in runs:
                if run == "graphed_2":
                    build.reset_launch_counts()
                dist.barrier()
                t0 = time.perf_counter()
                r = server.classify(toks, eager=run == "eager")
                wall = time.perf_counter() - t0
                if run == "graphed_2":
                    res["launches"] = build.launch_counts()
                res[run] = {"wall_s": wall, "pred": r.pred.tolist(), "tier_of": r.tier_of.tolist(),
                            "tier_counts": r.tier_counts.tolist(), "link": placement.link(0).stats(),
                            "fed_rows": list(fed)}
                placement.link(0).hops.clear()
                fed.clear()
            res["build_s"], res["build_own_s"] = build_s, times
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            res["members"] = [int(t.k) for t in server.tiers]
            res["meta"] = [all(x.is_meta for x in leaves(t.values)) for t in server.tiers]
            out["sharded" if shard_examples else "replicated"] = res
            if shard_examples and world in POD_SERVE_WORLDS:
                # generate and serve_continuous over the same placed weights
                torch.cuda.reset_peak_memory_stats()
                out["serving"] = pod_serve_runs(server, seed, placement.link(0), timed=True)
                out["serving"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                out["serving"]["member_offsets"] = [int(t.member_offset) for t in server.tiers]
            del server
            torch.cuda.empty_cache()
    Path(root, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def check_pod_serving(ranks, ref, world, launches, members):
    """Every rank's generate and serve_continuous equal, bitwise, the
    unplaced server's (pred, tier_of, tier_counts; tokens, tiers,
    truncation and completion order), each deferral one metered hop; each
    mode launched the kernels of its path on the ranks (summed into
    ``launches`` as ``pod_generate_<world>`` / ``pod_serve_<world>``).
    Where tier 1 answers (``POD_ANSWER_THETA``) on the (6, 1, 1) mesh, a
    rank runs one member, so each member's generations must equal those of
    that member alone (``members``), the vote over them must be every
    rank's answer, and some answers must be members 1 and 2's."""
    split = world == 6
    want = {k: v for k, v in ref.items() if k != "votes"}
    if split:
        gen = [vote_winner([members["generate"][e][b] for e in range(3)])[0] for b in range(8)]
        want["generate@0.8/answer"] = dict(want["generate@0.8/answer"], pred=gen, tier_of=[0] * 8,
                                           tier_counts=[8, 0])
        out = [[vote_winner([members["serve"][e][q] for e in range(3)])[1], 0, False] for q in range(8)]
        want["serve@0.8/answer"] = dict(want["serve@0.8/answer"], out=out)
    for o in ranks:
        r, got = o["rank"], o["serving"]
        for key, w in want.items():
            same = {k: v for k, v in got[key].items() if k in w and k != "wall_s"}
            require(same == {k: v for k, v in w.items() if k != "wall_s"},
                    f"({world}, 1, 1) rank {r} {key}: differs from the "
                    + ("members' alone" if split and key.endswith("answer") else "unplaced server's"))
        for key in ("generate", "generate@0.8/answer"):
            n_def = sum(t != 0 for t in want[key]["tier_of"])
            require(len(got[key]["hops"]) == (1 if n_def else 0), f"rank {r} {key}: hops {got[key]['hops']}")
        for key in ("serve@0", "serve@0.8", "serve@0.8/answer"):
            deferred = sum(t == 1 for _, t, _ in want[key]["out"])
            require(len(got[key]["hops"]) == deferred, f"rank {r} {key}: {deferred} deferred, hops {got[key]['hops']}")
    votes = ranks[0]["serving"]["votes"]
    if split:  # every member's draws on its own rank, not only the winners
        for e in range(3):
            require(sorted(v[e] for v in votes) == sorted(members["serve"][e]),
                    f"(6, 1, 1): member {e}'s generations on its rank differ from the member's alone")
    else:
        require(votes == ref["votes"], f"({world}, 1, 1): tier 1's member generations differ from the unplaced's")
    winners = [next(e for e, g in enumerate(v) if g == vote_winner(v)[1]) for v in votes]
    require(len(winners) == 8 and any(w != 0 for w in winners),
            f"({world}, 1, 1): tier 1's winning members {winners}: no answer holds member 1's or 2's draws")
    off = [o["serving"]["member_offsets"][0] for o in ranks[:world // 2]]
    require(off == ([0, 1, 2] if split else [0]), f"tier 1's member offsets by rank {off}")
    summary = {"member_offsets": off, "answer_winners": winners}
    if split:
        # the stacked three-member tier against each member alone: the same
        # draws, products at another batch count
        stacked = [sorted(v[e] for v in ref["votes"]) for e in range(3)]
        summary["alone_equal_to_stacked"] = sum(
            a == b for e in range(3) for a, b in zip(stacked[e], sorted(members["serve"][e])))
    for mode, keys in (("generate", ("generate",)), ("serve", ("serve@0", "serve@0.8"))):
        sums = {k: sum(o["serving"][key]["launches"][k] for o in ranks for key in keys)
                for k in ranks[0]["serving"]["generate"]["launches"]}
        for k in POD_SERVE_NEED[mode]:
            require(sums[k] > 0, f"({world}, 1, 1) {mode}: {k} was not launched")
        launches[f"pod_{mode}_{world}"] = sums
        summary[mode] = {"launches": sums, "rank0_wall_s": {key: ranks[0]["serving"][key]["wall_s"] for key in keys}}
    summary["answer_wall_s"] = {key: ranks[0]["serving"][key]["wall_s"]
                                for key in ("generate@0.8/answer", "serve@0.8/answer")}
    summary["peak_gib"] = [o["serving"]["peak_gib"] for o in ranks]
    summary["tier_counts"] = ref["generate"]["tier_counts"]
    summary["serve_tiers"] = {T: [t for _, t, _ in want[f"serve@{T}"]["out"]] for T in ("0", "0.8", "0.8/answer")}
    log(f"[pod_serve] ({world}, 1, 1): generate and serve_continuous (greedy, T = 0.8) bitwise the unplaced "
        f"server's on every rank, and tier 1 answering at T = 0.8 bitwise "
        f"{'each member alone' if split else 'the unplaced server'}; {json.dumps(summary)}")
    return summary


def pod_classify_path(dev, seed):
    """The first cascade (3 x qwen2.5-3b -> internlm2-1.8b) at published
    width, classify on 32 x 256, over ``pod_placement`` of a (2, 1, 1)
    mesh (tier i on rank i), a (4, 1, 1) one (each tier replicated on its
    two ranks; the hop lands each chunk of tier 2's cover sharded over
    slice 1's 'pod' axis, half on each rank) and a (6, 1, 1) one (tier 1's
    three members one a rank of slice 0, tier 2 replicated on slice 1's
    three ranks, where a chunk of 8 or 16 rows does not split in three and
    lands whole), ranks spawned on the one card under ``gloo``.  Every
    rank's pred, tier_of and tier_counts must equal, bitwise, this
    process's unplaced server's on the same weights, with the replicated
    baseline's metered hop; each rank must hold only its slice's tier
    (slice 0's ranks of the (6, 1, 1) mesh one member each), and each rank
    of slice 1 be fed its block of every chunk, as the logical rules shard
    it.  Returns (results, launches a mesh, summed over its ranks, of the
    second graphed run)."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import bucket_chunks
    from repro_torch.kernels.agreement import ops as agree_ops
    from repro_torch.serve import CascadeServer, CascadeTier
    from repro_torch.sharding.logical import logical_to_pspec, make_rules

    t0 = time.perf_counter()
    cal, toks = pod_inputs(seed)
    with torch.no_grad():
        v1 = pod_values(POD_TIERS[0], 3, seed + 10, dev)
        theta = float(agree_ops.agreement(ens.ensemble_last_logits(v1, {"tokens": cal}, get_config(POD_TIERS[0])))
                      ["mean_score"].median())
        v2 = pod_values(POD_TIERS[1], 1, seed + 11, dev)
        server = CascadeServer([CascadeTier(get_config(a), v, spec, device=dev)
                                for a, v, spec in zip(POD_TIERS, (v1, v2), pod_specs(theta))], device=dev)
        server.classify(toks)
        ref = server.classify(toks)
        # generate and serve_continuous, unplaced: what the ranks must
        # equal; and each tier-1 member alone, what a rank holding it alone
        # must equal where tier 1 answers
        serve_ref = pod_serve_runs(server, seed)
        members = pod_member_refs(v1, seed, dev)
    answered = [t for _, t, _ in serve_ref["serve@0.8/answer"]["out"]]
    require(answered == [0] * 8 and serve_ref["generate@0.8/answer"]["tier_counts"] == [8, 0],
            f"at θ {POD_ANSWER_THETA} tier 1 did not answer every request: serve tiers {answered}, generate "
            f"{serve_ref['generate@0.8/answer']['tier_counts']}")
    del server, v1, v2
    torch.cuda.empty_cache()
    n_def = int(ref.tier_counts[1])
    hop_bytes = min(sum(bucket_chunks(n_def, 8)), 32) * (256 * 4 + 4) if n_def else 0
    results = {"theta": theta, "tier_counts": ref.tier_counts.tolist(), "hop_bytes": hop_bytes,
               "reference_s": time.perf_counter() - t0}
    log(f"[pod_classify] unplaced reference: tier_counts {ref.tier_counts.tolist()}, theta {theta:.6g}, "
        f"{results['reference_s']:.1f}s")
    launches = {}
    for name, world in POD_MESHES.items():
        with tempfile.TemporaryDirectory(prefix="pod_classify_") as root:
            t0 = time.perf_counter()
            mp.start_processes(pod_rank, args=(world, root, seed, theta), nprocs=world, join=True,
                               start_method="spawn")
            wall = time.perf_counter() - t0
            ranks = [json.loads(Path(root, f"rank{r}.json").read_text()) for r in range(world)]
        half = world // 2

        def block(c):
            """The rows of a chunk of ``c`` each rank of slice 1 holds."""
            spec = logical_to_pspec(("act_batch", None), make_rules("decode", pod=True), shape=(c, 256),
                                    mesh={"pod": half, "data": 1, "model": 1})
            return c // (half if spec[0] is not None and "pod" in spec[0] else 1)

        chunks = bucket_chunks(n_def, 8)
        for out in ranks:
            r = out["rank"]
            for mode in ("sharded", "replicated"):
                for run, got in out[mode].items():
                    if not isinstance(got, dict) or "pred" not in got:
                        continue
                    what = f"{name} rank {r} {mode} {run}"
                    require(got["pred"] == ref.pred.tolist(), f"{what}: pred differs from the unplaced server's")
                    require(got["tier_of"] == ref.tier_of.tolist(), f"{what}: tier_of differs")
                    require(got["tier_counts"] == ref.tier_counts.tolist(), f"{what}: tier_counts differ")
                    require(got["link"]["bytes"] == hop_bytes and got["link"]["examples"] == n_def,
                            f"{what}: metered {got['link']} != one copy of the payload, {hop_bytes} bytes")
                    want = ([] if r < half else [block(c) if mode == "sharded" else c for c in chunks])
                    require(got["fed_rows"] == want, f"{what}: tier 2 fed {got['fed_rows']} rows, not {want}")
            tier = 0 if r < half else 1
            res = out["sharded"]
            require(res["meta"] == [tier != 0, tier != 1], f"{name} rank {r} holds another slice's weights")
            k1 = 3 // half if 3 % half == 0 else 3  # 'pod' does not divide the members: replicated
            require(res["members"][tier] == (k1 if tier == 0 else 1), f"{name} rank {r}: members {res}")
        sums = {k: sum(out["sharded"]["launches"][k] for out in ranks) for k in ranks[0]["sharded"]["launches"]}
        for k in POD_NEED:
            require(sums[k] > 0, f"{name}: {k} was not launched")
        launches[name] = sums
        if world in POD_SERVE_WORLDS:
            results[f"pod_serve_{world}"] = check_pod_serving(ranks, serve_ref, world, launches, members)
        r0 = ranks[0]["sharded"]
        results[name] = {
            "world_s": wall,
            "rank0_walls_s": {run: r0[run]["wall_s"] for run in ("eager", "graphed_1", "graphed_2")},
            "peak_gib": [out["sharded"]["peak_gib"] for out in ranks],
            "replicated_peak_gib": [out["replicated"]["peak_gib"] for out in ranks],
            "build_s": [out["sharded"]["build_s"] for out in ranks],
            "build_own_s": [out["sharded"]["build_own_s"] for out in ranks],
            "hop": r0["graphed_2"]["link"], "members": [out["sharded"]["members"] for out in ranks],
            "tier2_fed_rows": [out["sharded"]["graphed_2"]["fed_rows"] for out in ranks],
            "launches": sums,
        }
        log(f"[pod_classify] {name}: {world} ranks on one card, {wall:.1f}s; rank 0 walls "
            f"{json.dumps(results[name]['rank0_walls_s'])}; peak GiB by rank {results[name]['peak_gib']}; "
            f"hop {json.dumps(results[name]['hop'])}; tier 2 fed rows by rank "
            f"{results[name]['tier2_fed_rows']}; launches {json.dumps(sums)}; pred, tier_of, tier_counts "
            f"bitwise the unplaced server's, bytes the replicated link's")
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
    from repro_torch.core.cost_model import H100_SXM
    from repro_torch.kernels import build

    global HBM_BYTES_PER_S, BF16_FLOPS, TF32_FLOPS, F32_FLOPS
    HBM_BYTES_PER_S, BF16_FLOPS = H100_SXM["hbm_bw"], H100_SXM["peak_flops_bf16"]
    TF32_FLOPS, F32_FLOPS = H100_SXM["peak_flops_tf32"], H100_SXM["peak_flops_f32"]

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
    # G 5, 6 and 12 (and flash at them) from a generator of their own; each
    # kernel's row takes their worst error and keeps them under "groups"
    groups = check_attention_groups(dev, torch.Generator(device=dev).manual_seed(args.seed + 2))
    for c in checks:
        if c["name"] in groups:
            c["max_abs_err"] = max(c["max_abs_err"], groups[c["name"]]["max_abs_err"])
            c["groups"] = groups[c["name"]]["groups"]
            log(f"kernel {c['name']} at G 5, 6, 12: {json.dumps(c['groups'])}")
    # the padded head sizes, every G to 16 and the f32 route (a generator of
    # their own); each row takes their worst error and keeps them under "widths"
    widths = check_attention_widths(dev, torch.Generator(device=dev).manual_seed(args.seed + 6))
    for c in checks:
        if c["name"] in widths:
            w = widths[c["name"]]
            c["max_abs_err"] = max(c["max_abs_err"], w["max_abs_err"])
            c["f32_normwise_err"], c["widths"] = w["f32_normwise_err"], w["widths"]
            log(f"kernel {c['name']} at the padded head sizes and in f32: f32 normwise err "
                f"{w['f32_normwise_err']:.3g}, bf16/f32 max abs err {w['max_abs_err']:.3g}")
    # the routes this slice added (hd to 256, any hd, any G, f16; every SSD
    # (P, N) and WKV6 D), from a generator of their own, under "routes"
    wide = check_wide_routes(dev, torch.Generator(device=dev).manual_seed(args.seed + 7))
    for c in checks:
        c["max_abs_err"] = max(c["max_abs_err"], wide.get(c["name"], {}).get("max_abs_err", 0.0))
        c["routes"] = wide.get(c["name"], {}).get("routes", {})
        log(f"kernel {c['name']} on this slice's routes: {json.dumps(c['routes'])}")
    # training: flash's lse forward and gradients, the scans under autograd
    # (generators of their own), and the kernels that refuse grad
    by_name = {c["name"]: c for c in checks}
    by_name["flash_attention"]["training"] = check_flash_training(dev, torch.Generator(device=dev).manual_seed(args.seed + 4))
    g_scan = torch.Generator(device=dev).manual_seed(args.seed + 5)
    for grad_check in (check_ssd_grad, check_wkv6_grad):
        r = grad_check(dev, g_scan)
        by_name[r.pop("name")]["training"] = r
    for n in ("flash_attention", "mamba2_ssd", "rwkv6_wkv"):
        log(f"kernel {n} training route: {json.dumps(by_name[n]['training'])}")
    inference_only = check_inference_only(dev)
    log(f"inference-only kernels raise under grad: {inference_only}")
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
    ref["speculative_on_card"] = check_speculative_on_card(dev, args.seed)
    log(f"speculative on the card, graphed == eager, paged == dense, == plain up to near ties: "
        f"{json.dumps(ref['speculative_on_card'])}")
    ref["open_loop_on_card"] = check_open_loop_on_card(dev, args.seed)
    log(f"open loop on the card, repeat runs equal: {json.dumps(ref['open_loop_on_card'])}")
    ref["transport_on_card"] = check_transport_on_card(dev, args.seed)
    log(f"placement and transports on the card, tokens equal under every link: {json.dumps(ref['transport_on_card'])}")
    ref["f32_cascade_on_card"] = check_f32_cascade_on_card(dev, args.seed)
    log(f"f32 cascade on the card vs cpu, equal but at near ties: {json.dumps(ref['f32_cascade_on_card'])}")
    ref["families_on_card"] = check_families_on_card(dev, args.seed)
    log(f"moe, vlm, encoder, olmo and command-r on the card vs cpu (tol {REF_TOL}), MoE serve graphed == eager, "
        f"paged == dense: {json.dumps(ref['families_on_card'])}")
    ref["training_on_card"] = check_training_on_card(dev, args.seed)
    log(f"train steps card vs cpu (losses, first-step gradient by leaf, AdamW), checkpoint round trip: "
        f"{json.dumps(ref['training_on_card'])}")
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
    before = torch.cuda.memory_allocated()
    results["frontends"], per_run = frontend_path(dev, args.seed)
    launches.update({f"frontends/{run}": c for run, c in per_run.items()})
    left = (torch.cuda.memory_allocated() - before) / 2**30
    require(left < 0.25, f"frontends: {left:.2f} GiB of device memory outlived the checks")
    torch.cuda.empty_cache()
    gc.enable()
    # the serve CLI at published width and examples/edge_to_cloud.py at its own widths
    results["serve_cli"], per_mode = serve_cli_path(dev, args.seed)
    launches.update({f"cli/{mode}": c for mode, c in per_mode.items()})
    results["edge_to_cloud_example"], per_run = edge_to_cloud_example(dev)
    launches.update({f"examples/edge_to_cloud/{run}": c for run, c in per_run.items()})
    # training last: autograd graphs and checkpointed layers are freed with
    # the cyclic collector on
    results["train"], per_run = train_path(dev, args.seed)
    launches.update({f"train/{run}": c for run, c in per_run.items()})
    gc.collect()
    torch.cuda.empty_cache()
    # last: the first cascade's classify over mesh placements, ranks spawned
    # on this card (they load the kernels phase 1 built)
    t0 = time.perf_counter()
    results["pod_classify"], per_mesh = pod_classify_path(dev, args.seed)
    launches.update(per_mesh)
    results["pod_classify"]["phase_s"] = time.perf_counter() - t0
    log(f"[pod_classify] phase {results['pod_classify']['phase_s']:.1f}s")

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
            "train_launches": sum(launches[m][c["name"]] for m in launches if m.startswith("train/")),
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "device_ms": c["device_ms"], "library_device_ms": c["library_device_ms"],
            "host_us": c["host_us"], "device_launches_per_call": c["device_launches_per_call"],
            # every timed route past the main path's (hd 256, f16, G 32 / 64, SSD N 128, WKV6 D 128)
            "routes": [{"route": what, **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                              "library_ms", "device_ms", "library_device_ms")}}
                       for what, r in c.get("routes", {}).items()],
        }
        for c in checks
    ]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, build_s=build_s, checks=checks, inference_only=inference_only, reference=ref,
            main_path=results, line=line,
        ), indent=1))
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

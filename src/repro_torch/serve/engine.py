"""Single-model serving engine (port of ``repro.serve.engine``).

Compile-once discipline: the JAX package jits every serving program once
per shape and counts its traces.  The port's counterpart is the CUDA graph
(``serve/graphs.py``): on the card every serving program of an engine is
captured the first time the engine runs it at a bucket and replayed on
every later call of that bucket:

* ``classify``: the last-token logits of a (B, S) prompt batch;
* ``generate``: the batch prefill, written into a static cache of
  (B, S + max_new) rows kept on the engine (``batch_caches``), and the
  decode step over that cache, with the position staged as a (B,) device
  tensor, replayed max_new - 1 times;
* ``serve_continuous``: the slot-stream decode step and each
  chunked-admission bucket (one per pow2 chunk length), over the pools or
  slot caches of a slot geometry.

The engine keeps the graphs and caches of at most ``BATCH_BUCKETS``
batch buckets (classify's (B, S), generate's (B, S, max_new)); a new
bucket evicts the least recently used one, which captures again if it
comes back.

``trace_count``/``trace_counts`` count those captures under the JAX
package's ``"<cfg.name>/<program>"`` keys; on the CPU, where nothing is
captured, they count each program's first call at a bucket on its owner,
so the same flat-after-warm-up checks hold there.  Two slot programs stay
eager and are counted at their first call: ``slot_reset`` (a strided fill
of a slot's state leaves at admission) and ``copy_page`` (a copy-on-write
page copy), each one launch a leaf.  ``eager=True`` runs every program
eagerly on the card (``generate`` then grows a fresh cache with
``grow_cache`` and decodes at a scalar position, the code the graphs
replaced): it exists only as the oracle the graphed path is held to.

Sampling: ``temperature > 0`` draws each token as the Gumbel-max of
``logits / T`` with noise from the engine's own ``torch.Generator``
(seeded by ``seed``), after the captured step, on the host side of the
program, as the JAX engine splits its rng outside its programs; greedy
decoding keeps the argmax inside the graph.

The function-level programs (``model_programs``, ``paged_model_programs``)
stay shared per config, as in the JAX package; the graphs and the device
memory they are captured over belong to the engine, and go with it.
Prompts in a batch are left-padded to a common length and the per-row
``starts`` carve the padding out of attention (RoPE relative to each row's
start), so padded generations match solo runs.

Continuous batching lives in ``serve/slot_stream.py``;
``ServingEngine.serve_continuous`` is its E=1 entry point, with chunked-prefill
admission and block-paged KV pools by default.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cascade import host_fetch
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.params import tree_map
from repro_torch.obs import Observability, StatsView
from repro_torch.serve.batching import Request, RequestQueue
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.graphs import (  # noqa: F401
    BATCH_BUCKETS, GraphPool, GraphSet, Program, trace_count, trace_counts,
)
from repro_torch.serve.sampling import gumbel


@functools.lru_cache(maxsize=None)
def model_programs(cfg: ModelConfig) -> SimpleNamespace:
    """The single-model programs for one config, each a ``Program`` keyed
    ``"<cfg.name>/<program>"``: ``prefill``/``decode`` (batch; ``decode``
    is also the slot-stream decode step over the dense slot cache),
    ``prefill_chunk`` (chunked prefill into a slot, one graph a pow2 chunk
    length) and ``reset_slot`` (zero a slot's recurrent state at admission;
    None for the dense family, which has none)."""
    return SimpleNamespace(
        prefill=Program(f"{cfg.name}/prefill", functools.partial(api.prefill, cfg=cfg)),
        decode=Program(f"{cfg.name}/decode", functools.partial(api.decode_step, cfg=cfg)),
        prefill_chunk=(
            Program(f"{cfg.name}/prefill_chunk", functools.partial(api.prefill_into_slot, cfg=cfg))
            if api.supports_chunked_prefill(cfg) else None
        ),
        reset_slot=(
            Program(f"{cfg.name}/slot_reset", functools.partial(api.reset_slot, cfg=cfg))
            if api.has_slot_state(cfg) else None
        ),
    )


@functools.lru_cache(maxsize=None)
def paged_model_programs(cfg: ModelConfig) -> SimpleNamespace:
    """The block-paged single-model programs: page-table decode, paged
    chunked prefill and the copy-on-write page copy (eager)."""
    assert api.supports_paging(cfg), cfg.family
    return SimpleNamespace(
        decode=Program(f"{cfg.name}/decode_paged", functools.partial(api.decode_step_paged, cfg=cfg)),
        prefill_chunk=Program(
            f"{cfg.name}/prefill_chunk_paged", functools.partial(api.prefill_into_slot_paged, cfg=cfg)
        ),
        copy_page=Program(f"{cfg.name}/copy_page", api.copy_pool_page),
    )


def grow_cache(cache, pad: int, cfg: ModelConfig):
    """Pad the sequence axis (second to last) of the attention KV leaves by
    ``pad`` zero rows — any leading axes (layers, members, batch) pass
    through, so single-model and member caches grow alike.  The hybrid's
    per-invocation ``attn_k``/``attn_v`` leaves grow one by one; recurrent
    state is constant-size, so ``ssm_mamba2``/``ssm_rwkv6`` caches come
    back as they are."""
    if pad <= 0:
        return cache
    grow = lambda t: F.pad(t, (0, 0, 0, pad))
    if cfg.family == "dense":
        return {k: grow(v) for k, v in cache.items()}
    if cfg.family == "hybrid":
        return {k: [grow(t) for t in v] if k in ("attn_k", "attn_v") else v for k, v in cache.items()}
    return cache


class ServingEngine:
    """Single-model serving front end: ``classify`` (last-token logits),
    ``generate`` (batch decode loop), ``serve_continuous`` (the E=1
    ``SlotStream`` loop), ``slot_stream`` and the queue-driven
    ``serve_pending``.  Holds the params, the sampling policy
    (``temperature`` and a generator seeded by ``seed``), its graphs and the
    device memory they run over.  ``device=None`` means the card."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_batch: int = 32,
        max_seq: int = 512,
        temperature: float = 0.0,
        seed: int = 0,
        obs: Optional[Observability] = None,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.temperature = float(temperature)
        self._rng = torch.Generator(device=self.device).manual_seed(int(seed))
        self.queue = RequestQueue(max_batch=max_batch)
        programs = model_programs(cfg)
        self._prefill = programs.prefill
        self._decode = programs.decode
        # every graph of the engine allocates from one pool; the batch
        # programs' graphs and the static caches of ``generate`` live in
        # ``graphs``, the slot programs' in ``slot_memory`` (slot geometry
        # -> SlotMemory: pools or slot caches and graphs)
        self._graph_pool = GraphPool()
        self.graphs = GraphSet(self.device, self._graph_pool, BATCH_BUCKETS)
        self.slot_memory: dict = {}
        self.obs = obs if obs is not None else Observability.private()
        sc = self.obs.scope("engine")
        self._c_prefill = sc.counter("prefill_tokens")
        self._c_decode = sc.counter("decode_tokens")
        self._c_batches = sc.counter("batches")
        self.stats = StatsView({
            "prefill_tokens": lambda m=self._c_prefill: m.value,
            "decode_tokens": lambda m=self._c_decode: m.value,
            "batches": lambda m=self._c_batches: m.value,
        })

    # -- low-level --------------------------------------------------------
    def _prefill_batch(self, tokens, starts):
        batch = {"tokens": torch.as_tensor(tokens, device=self.device)}
        if starts is not None:
            batch["starts"] = torch.as_tensor(starts, device=self.device).to(torch.int32)
        return batch

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Token ids from logits (..., V): the argmax, or at T > 0 the
        Gumbel-max of ``logits / T`` on noise from the engine's generator."""
        if self.greedy:
            return logits.argmax(-1).to(torch.int32)
        bits = torch.randint(0, 1 << 32, logits.shape, generator=self._rng, device=logits.device,
                             dtype=torch.int64)
        return (logits.float() / self.temperature + gumbel(bits)).argmax(-1).to(torch.int32)

    def _step_out(self, logits):
        """What a captured step returns: the greedy token (B, 1), or the
        logits for the sampler that runs after it."""
        return self._sample(logits)[:, None] if self.greedy else logits

    def _next_token(self, out):
        return out if self.greedy else self._sample(out)[:, None]

    def _classify_fn(self, tokens, starts=None):
        return api.last_logits(self.params, self._prefill_batch(tokens, starts), self.cfg)

    def _prefill_into(self, cache, tokens, starts=None):
        logits, _ = self._prefill(self.params, self._prefill_batch(tokens, starts), cache=cache)
        return self._step_out(logits)

    def _decode_in(self, cache, tok, pos, starts=None):
        logits, _ = self._decode(self.params, tok, cache, pos, starts=starts)
        return self._step_out(logits)

    @property
    def batch_caches(self) -> dict:
        """generate's static caches kept now, by (B, S, max_new, no starts)
        bucket."""
        return {b: m for b, m in self.graphs.buckets.items() if m is not None}

    def classify(self, tokens: np.ndarray, starts=None, *, eager: bool = False) -> np.ndarray:
        """Last-token logits as a classifier head: tokens (B, S) -> (B, V);
        ``starts`` (B,) the per-row prompt starts of a left-padded batch.
        One captured program a (B, S) (and starts or none); ``eager`` the
        oracle route."""
        self._c_prefill.add(tokens.size)
        if eager:
            logits = self._classify_fn(tokens, starts)
        else:
            extra = () if starts is None else (np.asarray(starts, np.int32),)
            logits = self.graphs.run(self._prefill.key, self._classify_fn, tokens, *extra,
                                     bucket=("classify", tokens.shape, starts is None))
        return host_fetch(logits)

    def generate(self, tokens: np.ndarray, max_new_tokens: int, starts=None, *, eager: bool = False) -> np.ndarray:
        """Generation, greedy or sampled: tokens (B, S) -> (B, max_new).
        With ``starts`` the left-pad carve-out rides every decode step too.
        The prefill and the decode step are captured once a (B, S,
        max_new) over the engine's static cache; ``eager`` runs the oracle
        (a fresh cache grown by ``grow_cache``, scalar positions)."""
        B, S = tokens.shape
        self._c_prefill.add(tokens.size)
        if eager:
            return self._generate_eager(tokens, max_new_tokens, starts)
        extra = () if starts is None else (np.asarray(starts, np.int32),)
        bucket = (B, S, max_new_tokens, starts is None)
        cache = self.graphs.bucket(bucket, lambda: api.init_cache(self.cfg, B, S + max_new_tokens, self.device))
        out = self.graphs.run(self._prefill.key, functools.partial(self._prefill_into, cache), tokens, *extra,
                              bucket=bucket)
        tok = self._next_token(out)
        pos = np.empty(B, np.int64)
        toks = []
        for t in range(max_new_tokens):
            toks.append(host_fetch(tok)[:, 0])
            if t == max_new_tokens - 1:
                break
            pos.fill(S + t)
            out = self.graphs.run(self._decode.key, functools.partial(self._decode_in, cache), tok, pos, *extra,
                                  bucket=bucket)
            self._c_decode.add(B)
            tok = self._next_token(out)
        return np.stack(toks, axis=1)

    def _generate_eager(self, tokens, max_new_tokens, starts):
        B, S = tokens.shape
        logits, cache = self._prefill(self.params, self._prefill_batch(tokens, starts))
        cache = grow_cache(cache, max_new_tokens, self.cfg)
        out = []
        tok = self._sample(logits)[:, None]
        dec_kw = {} if starts is None else {"starts": torch.as_tensor(starts, device=self.device).to(torch.int32)}
        for t in range(max_new_tokens):
            out.append(host_fetch(tok)[:, 0])
            if t == max_new_tokens - 1:
                break
            logits, cache = self._decode(self.params, tok, cache, S + t, **dec_kw)
            self._c_decode.add(B)
            tok = self._sample(logits)[:, None]
        return np.stack(out, axis=1)

    # -- continuous batching ----------------------------------------------
    def slot_stream(self, config: ServeConfig = ServeConfig(), *, eager: bool = False):
        """A fresh ``SlotStream`` over this engine's model — the E=1 case
        of the shared slot state machine.  ``paged`` selects block-paged KV
        pools (default: wherever the family supports them; ``paged=False``
        keeps the dense slot cache as the parity oracle); ``n_pages``
        bounds the pool (default: dense-equivalent capacity plus the
        overflow sink).  The stream runs over the engine's device memory
        and graphs for its geometry; ``eager`` runs its programs eagerly on
        the card (the oracle of the graphed path, nothing else)."""
        from repro_torch.serve.slot_stream import EngineBackend, SlotStream

        cfg = config.with_max_seq_default(self.max_seq)
        backend = EngineBackend(
            self.cfg, self.params, model_programs(self.cfg), self._sample,
            n_slots=cfg.n_slots, max_seq=cfg.max_seq, greedy=self.greedy,
            prefill_counter=self._c_prefill,
            paged=cfg.paged, page_size=cfg.page_size, n_pages=cfg.n_pages,
            obs=cfg.obs, memory=self.slot_memory, graph_pool=self._graph_pool, eager=eager,
        )
        return SlotStream(backend, cfg)

    def serve_continuous(self, requests: List[Request], config: ServeConfig = ServeConfig(), *,
                         eager: bool = False) -> List[Request]:
        """Slot-based continuous batching, a thin loop over
        ``SlotStream``: one decode step advances every active slot by one
        token at its own position; freed slots admit new requests
        mid-stream, consuming ``prompt[:-1]`` through bucketed chunked
        prefill (or token by token through decode with
        ``chunked_prefill=False``).  Requests cut short by the cache wall
        come back with ``truncated=True``.  The stream records into
        ``config.obs`` or, without one, the engine's own registry; the run's
        stream counters land in ``last_stream_stats``.  ``eager`` as in
        ``slot_stream``.  Returns the completed requests."""
        cfg = config.with_max_seq_default(self.max_seq)
        ob = cfg.obs if cfg.obs is not None else self.obs
        stream = self.slot_stream(dataclasses.replace(cfg, obs=ob), eager=eager)
        clk = ob.clock
        h_lat = ob.registry.histogram("serve.request_latency_s")
        # counters in a shared registry are cumulative across serves: the
        # engine's decode credit and ``last_stream_stats`` are this run's delta
        st0 = dict(stream.stats)
        t_submit = {r.rid: clk() for r in requests}
        stream.submit(requests)
        done: List[Request] = []
        for r, gen in stream.drain():
            r.output = gen[0].astype(np.int32)
            h_lat.record(clk() - t_submit[r.rid])
            if ob.tracer.enabled:
                ob.tracer.instant(r.rid, "complete", truncated=r.truncated)
            done.append(r)
        st1 = dict(stream.stats)
        self._c_decode.add(st1["decode_tokens"] - st0["decode_tokens"])
        self.last_stream_stats = {k: v - st0[k] for k, v in st1.items()}
        return done

    # -- queue-driven serving --------------------------------------------
    def serve_pending(self) -> List[Request]:
        """Drain ``self.queue`` batch by batch: each batch is padded to its
        power-of-two bucket (right-aligned prompts, per-row starts) and
        generated in one call.  Returns the completed requests."""
        done = []
        while True:
            batch = self.queue.next_batch()
            if batch is None:
                return done
            toks, starts, _ = self.queue.pad_batch_with_starts(batch)
            gen = self.generate(toks, max(r.max_new_tokens for r in batch), starts=starts)
            self._c_batches.add(1)
            for i, r in enumerate(batch):
                r.output = gen[i, : r.max_new_tokens]
                done.append(r)

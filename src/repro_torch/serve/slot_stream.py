"""SlotStream: the slot state machine behind all continuous batching (port
of ``repro.serve.slot_stream``, greedy).

One ``SlotStream`` owns the admit / refill / prompt-feed / force-complete
lifecycle of ``n_slots`` decode slots over member-stacked caches or pools;
the single-model engine is the E=1 case and a cascade tier the E=k case,
so ``ServingEngine.serve_continuous`` and ``CascadeServer.serve_continuous``
are both thin loops over this module.

Slot isolation: prompts are left-aligned at position 0 of their slot and
every slot advances at its own ``pos`` (the decode step takes a per-slot
(B,) position vector).  Attention reads cache rows ``< pos + 1`` only, so
rows written by a slot's previous occupant stay invisible.

Chunked-prefill admission: on admit, ``prompt[:-1]`` is consumed in exact
power-of-two chunks (``core.cascade.prompt_chunks``) written into the slot
at its offset — a 400-token prompt costs a handful of chunk calls instead
of ~400 decode steps.  The final prompt token always goes through the
shared decode step (its logits pick the first output token), which keeps
chunked and decode-only admission token for token identical.

Device work goes through a small backend protocol (duck-typed):

    E                        int, ensemble width
    supports_chunked_prefill bool
    decode(tok (E, n_slots, 1), pos (n_slots,)) -> next (E, n_slots)
    prefill_chunk(tokens (C,), slot, start)     -> None   (updates cache)
    reset_slot(slot)                            -> None   (zero state leaves)

plus three optional hooks for backends whose slot memory is allocated
rather than dedicated (the block-paged KV pools, ``serve/paging.py``):

    begin_slot(slot, tokens, share) -> Optional[int]
        claim slot memory before any prefill; returns the number of leading
        prompt tokens already covered by shared prefix pages (0 for dense),
        or None when the pool cannot admit — the request stays queued.
    release_slot(slot) -> None
        return the slot's memory (decref pages) on completion.
    prepare_step(pos, active) -> [slot, ...]
        map each active slot's next write position (grow by a page,
        copy-on-write); returns the slots the pool could NOT serve, which
        the stream force-completes with ``truncated=True``.

``EngineBackend`` (E=1) and ``TierBackend`` (a cascade tier's ensemble)
default to block-paged pools where ``api.supports_paging`` allows (the
dense family) and keep the dense slot cache behind ``paged=False`` as the
parity oracle.  The constant-state families (``ssm_mamba2``,
``ssm_rwkv6``, ``hybrid``) always run the dense slot cache: their
``begin_slot`` zeroes the admitted slot's recurrent state through the
backend's ``reset_slot``.  Every
decode step makes exactly one device-to-host read: the metered
``host_fetch`` of the next tokens.

Not ported yet (the JAX package has them): the speculative draft-verify
admission and in-flight (transport) admission.
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import host_fetch, prompt_chunks
from repro_torch.models import api
from repro_torch.obs import Observability, StatsView
from repro_torch.serve.batching import Request
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.paging import PagePool


class SlotStream:
    """Slot-based continuous batching over a device backend.

    Takes a ``ServeConfig``; the stream reads the scheduling fields
    (``n_slots``, ``max_seq``, ``chunked_prefill``, ``max_chunk``,
    ``obs``), the memory fields belong to the backend its caller built."""

    def __init__(self, backend, config: ServeConfig = ServeConfig(), *, name: str = "slot_stream"):
        cfg = config.with_max_seq_default(256)
        self.backend = backend
        self.n_slots = n_slots = cfg.n_slots
        self.max_seq = cfg.max_seq
        self.max_chunk = cfg.max_chunk
        self.chunked = bool(cfg.chunked_prefill) and backend.supports_chunked_prefill
        E = backend.E
        self.queue: deque = deque()
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_consumed = np.zeros(n_slots, np.int64)  # prompt tokens fed
        self.slot_emitted: List[List[np.ndarray]] = [[] for _ in range(n_slots)]
        self.pos = np.zeros(n_slots, np.int32)
        self.tok = np.zeros((E, n_slots, 1), np.int32)
        self.steps = 0
        # telemetry: counters and histograms on the stream's registry, named
        # under ``name`` (cascade tiers pass ``slot_stream.tier{i}``); times
        # come from the injectable ``obs.clock``
        self.obs = cfg.obs if cfg.obs is not None else Observability.private()
        self.name = name
        self._clock = self.obs.clock
        self._tr = self.obs.tracer
        sc = self.obs.scope(name)
        self._c_admitted = sc.counter("admitted")
        self._c_admit_failures = sc.counter("admit_failures")
        self._c_forced = sc.counter("forced_completions")
        self._c_chunk_calls = sc.counter("chunk_calls")
        self._c_chunk_tokens = sc.counter("chunk_tokens")
        self._c_shared_tokens = sc.counter("shared_tokens")
        self._c_decode_tokens = sc.counter("decode_tokens")
        self._g_queue = sc.gauge("queue_depth")
        # host wall time of the launches (PyTorch returns before the device
        # finishes: synchronise around refill()/step() for device latency)
        self._h_begin_slot = sc.histogram("admit.begin_slot_s")
        self._h_prefill_dispatch = sc.histogram("admit.prefill_dispatch_s")
        self._h_decode_dispatch = sc.histogram("decode.dispatch_s")
        self.stats = StatsView({
            "admitted": lambda m=self._c_admitted: m.value,
            "admit_failures": lambda m=self._c_admit_failures: m.value,
            "forced_completions": lambda m=self._c_forced: m.value,
            "chunk_calls": lambda m=self._c_chunk_calls: m.value,
            "chunk_tokens": lambda m=self._c_chunk_tokens: m.value,
            "shared_tokens": lambda m=self._c_shared_tokens: m.value,
            "decode_tokens": lambda m=self._c_decode_tokens: m.value,
            "admit_time": lambda b=self._h_begin_slot, p=self._h_prefill_dispatch: b.sum + p.sum,
            "decode_time": lambda m=self._h_decode_dispatch: m.sum,
        })

    # -- admission ---------------------------------------------------------
    def submit(self, requests: Sequence[Request]):
        """Enqueue requests.  Prompts must fit the slot:
        1 <= len(tokens) < max_seq."""
        for r in requests:
            assert len(r.tokens) >= 1, f"request {r.rid}: empty prompt"
            assert len(r.tokens) < self.max_seq, (
                f"request {r.rid}: prompt length {len(r.tokens)} does not fit "
                f"max_seq={self.max_seq}"
            )
            self.queue.append(r)
            if self._tr.enabled:
                self._tr.begin(r.rid, "queue_wait", stream=self.name)
        self._g_queue.set(len(self.queue))

    def _release(self, s: int):
        """Hand the slot's memory back to the backend (paged pools decref
        their pages; dense backends have nothing to return)."""
        release = getattr(self.backend, "release_slot", None)
        if release is not None:
            release(s)
        self.slot_req[s] = None
        self.slot_emitted[s] = []

    def _admit(self, s: int):
        if not self.queue:
            self.slot_req[s] = None
            return
        r = self.queue[0]  # peek: admission may be refused by the pool
        t0 = self._clock()
        begin = getattr(self.backend, "begin_slot", None)
        if begin is not None:
            # prefix pages are only shareable under chunked prefill (the
            # owner writes them in full before any sharer can be admitted)
            shared = begin(s, r.tokens, share=self.chunked)
            if shared is None:
                # pool exhausted: the request stays at the queue head and
                # the slot stays free; completions will release pages
                self._h_begin_slot.record(self._clock() - t0)
                self._c_admit_failures.add(1)
                self.slot_req[s] = None
                if not any(q is not None for q in self.slot_req):
                    raise RuntimeError(
                        f"request {r.rid}: prompt needs more pages than the "
                        "pool holds even with every slot free"
                    )
                return
        else:
            self.backend.reset_slot(s)
            shared = 0
        t1 = self._clock()
        self._h_begin_slot.record(t1 - t0)
        self.queue.popleft()
        self._g_queue.set(len(self.queue))
        tr = self._tr
        if tr.enabled:
            tr.end(r.rid, "queue_wait")
            tr.begin(
                r.rid, "admit", stream=self.name, slot=s,
                prompt_tokens=len(r.tokens), shared_tokens=shared,
            )
        consumed = 0
        if self.chunked and len(r.tokens) > 1:
            # consume prompt[:-1] in bucketed pow2 chunks; the last prompt
            # token rides the decode step.  A shared-prefix span is already
            # resident in the pool: chunks start at its end
            m = len(r.tokens) - 1
            chunks = prompt_chunks(m - shared, self.max_chunk)
            off = shared
            for c in chunks:
                if tr.enabled:
                    tr.begin(r.rid, "prefill_chunk", tokens=c, start=off)
                self.backend.prefill_chunk(r.tokens[off: off + c], s, off)
                if tr.enabled:
                    tr.end(r.rid, "prefill_chunk")
                off += c
            consumed = off
            self._c_chunk_calls.add(len(chunks))
            self._c_chunk_tokens.add(m - shared)
            self._c_shared_tokens.add(shared)
            self._h_prefill_dispatch.record(self._clock() - t1)
        self.slot_req[s] = r
        self.slot_consumed[s] = consumed + 1
        self.slot_emitted[s] = []
        self.pos[s] = consumed
        self.tok[:, s, 0] = r.tokens[consumed]
        self._c_admitted.add(1)
        if tr.enabled:
            tr.end(r.rid, "admit")
            tr.begin(r.rid, "decode", stream=self.name, slot=s)

    def refill(self):
        """Admit queued requests into every free slot."""
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                self._admit(s)

    @property
    def runnable(self) -> bool:
        """True when the stream can make progress: a slot is occupied or a
        request is queued."""
        return any(r is not None for r in self.slot_req) or bool(self.queue)

    @property
    def active(self) -> bool:
        """True while the stream still owes work (the port has no
        in-flight admission, so this is ``runnable``)."""
        return self.runnable

    # -- stepping ----------------------------------------------------------
    def _complete(self, s: int, completed: list, *, truncated: bool):
        r = self.slot_req[s]
        r.truncated = truncated
        gen = (
            np.stack(self.slot_emitted[s], axis=1)
            if self.slot_emitted[s]
            else np.zeros((self.backend.E, 0), np.int32)
        )
        completed.append((r, gen))
        return r, gen

    def step(self) -> List[Tuple[Request, np.ndarray]]:
        """Advance every active slot by one token; returns the list of
        (request, member generations (E, T)) that completed this step.
        Freed slots immediately admit from ``self.queue``."""
        self.refill()
        completed: List[Tuple[Request, np.ndarray]] = []
        n_active = sum(r is not None for r in self.slot_req)
        if n_active == 0:
            return completed
        prepare = getattr(self.backend, "prepare_step", None)
        if prepare is not None:
            # paged pools: map every active slot's next write position.
            # Slots the pool cannot serve force-complete with what they have
            active = [s for s, r in enumerate(self.slot_req) if r is not None]
            for s in prepare(self.pos, active):
                r, gen = self._complete(s, completed, truncated=True)
                self._c_forced.add(1)
                if self._tr.enabled:
                    self._tr.end(r.rid, "decode", new_tokens=gen.shape[1])
                    self._tr.instant(r.rid, "forced_complete", slot=s)
                self._release(s)
                self._admit(s)
            n_active = sum(r is not None for r in self.slot_req)
            if n_active == 0:
                return completed
        t0 = self._clock()
        nxt = self.backend.decode(self.tok, self.pos)  # (E, n_slots) host
        self._h_decode_dispatch.record(self._clock() - t0)
        self._c_decode_tokens.add(n_active)
        self.steps += 1
        for s, r in enumerate(self.slot_req):
            if r is None:
                continue
            self.pos[s] += 1
            if self.slot_consumed[s] < len(r.tokens):
                # prompt feed: still consuming the prompt through decode
                self.tok[:, s, 0] = r.tokens[self.slot_consumed[s]]
                self.slot_consumed[s] += 1
            else:
                self.slot_emitted[s].append(nxt[:, s].copy())
                self.tok[:, s, 0] = nxt[:, s]
                full = len(self.slot_emitted[s]) >= r.max_new_tokens
                wall = self.pos[s] >= self.max_seq - 1  # out of cache rows
                if full or wall:
                    _, gen = self._complete(s, completed, truncated=not full)
                    if self._tr.enabled:
                        self._tr.end(r.rid, "decode", new_tokens=gen.shape[1], truncated=r.truncated)
                    self._release(s)
                    self._admit(s)
        return completed

    def drain(self) -> List[Tuple[Request, np.ndarray]]:
        """Step until every queued request has completed."""
        done = []
        while self.active:
            done.extend(self.step())
        return done


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def _default_n_pages(n_slots: int, max_seq: int, page_size: int) -> int:
    """Dense-equivalent pool capacity plus the overflow sink: enough pages
    that no admission pattern the dense cache serves can ever fail."""
    return n_slots * (max_seq // page_size) + 1


class _PagedSlots:
    """The shared paged-backend half: host ``PagePool`` bookkeeping plus
    the begin/release/prepare hooks.  ``self.pool_dev`` is the device pool
    (engine pools (L, P, ...) and member-stacked tier pools (L, E, P, ...)
    take the same ``api.copy_pool_page``)."""

    def _init_pool(self, n_slots, max_seq, page_size, n_pages, obs=None, pool_name="paging"):
        if n_pages is None:
            n_pages = _default_n_pages(n_slots, max_seq, page_size)
        self.pool = PagePool(
            n_pages, page_size, n_slots=n_slots, max_seq=max_seq, obs=obs, name=pool_name,
        )

    def begin_slot(self, slot, tokens, *, share=True):
        """Claim pages for a new occupant (see ``PagePool.admit``); dense
        backends fall back to ``reset_slot`` + private rows."""
        if not self.paged:
            self.reset_slot(slot)
            return 0
        return self.pool.admit(slot, tokens, share=share)

    def release_slot(self, slot):
        if self.paged:
            self.pool.release(slot)

    def prepare_step(self, pos, active):
        """Map each active slot's next write position; copy-on-write splits
        copy the page on the device.  Returns slots the pool cannot serve."""
        if not self.paged:
            return []
        oom = []
        for s in active:
            ok, copies = self.pool.prepare(s, int(pos[s]))
            if not ok:
                oom.append(s)
                continue
            for src, dst in copies:
                api.copy_pool_page(self.pool_dev, src, dst)
        return oom


class EngineBackend(_PagedSlots):
    """E=1 backend over a single model's functions (``model_programs``);
    ``sample`` turns logits into token ids (greedy).  ``paged`` selects
    block-paged KV pools (default wherever the family supports them);
    ``paged=False`` keeps the dense slot cache as the parity oracle."""

    def __init__(self, cfg, params, programs, sample, *, n_slots, max_seq,
                 prefill_counter=None, paged=None, page_size: int = 16,
                 n_pages=None, obs=None, pool_name="paging"):
        assert not cfg.is_encoder
        self.cfg = cfg
        self.params = params
        self._decode = programs.decode
        self._chunk = programs.prefill_chunk
        self._reset = programs.reset_slot
        self._sample = sample
        # the owning engine's ``engine.prefill_tokens`` counter; None
        # outside an engine
        self._prefill_counter = prefill_counter
        self.E = 1
        self.paged = api.supports_paging(cfg) if paged is None else bool(paged)
        if self.paged:
            from repro_torch.serve.engine import paged_model_programs

            self._init_pool(n_slots, max_seq, page_size, n_pages, obs=obs, pool_name=pool_name)
            self.pool_dev = api.init_paged_pool(cfg, self.pool.n_pages, page_size, params["embed"].device)
            progs = paged_model_programs(cfg)
            self._decode_paged = progs.decode
            self._chunk_paged = progs.prefill_chunk
            self.cache = None
            self.supports_chunked_prefill = True
        else:
            self.cache = api.init_cache(cfg, n_slots, max_seq, params["embed"].device)
            self.supports_chunked_prefill = self._chunk is not None

    def decode(self, tok, pos):
        """One decode step for every slot at its own ``pos``; returns the
        next tokens (1, n_slots) on the host."""
        if self.paged:
            logits, self.pool_dev = self._decode_paged(self.params, tok[0], self.pool_dev, pos, self.pool.table)
        else:
            logits, self.cache = self._decode(self.params, tok[0], self.cache, pos)
        return host_fetch(self._sample(logits))[None]

    def prefill_chunk(self, tokens, slot, start):
        """Write one pow2 prompt chunk into ``slot`` at offset ``start``."""
        if self.paged:
            self.pool_dev = self._chunk_paged(self.params, tokens, self.pool_dev, self.pool.table[slot], start)
        else:
            self.cache = self._chunk(self.params, tokens, self.cache, slot, start)
        if self._prefill_counter is not None:
            self._prefill_counter.add(len(tokens))

    def reset_slot(self, slot):
        """Zero the slot's constant-state leaves (nothing for position-
        masked families)."""
        if self._reset is not None:
            self.cache = self._reset(self.cache, slot)


class TierBackend(_PagedSlots):
    """E=k backend over a cascade tier's stacked-ensemble functions (one
    batched program advances every member; greedy tokens come back in one
    fetch).  Paged tiers stack E pool planes under ONE page table: members
    score the same tokens at the same positions, so every shared prefix
    page is an E-fold memory saving."""

    def __init__(self, tier, *, n_slots, max_seq, paged=None, page_size: int = 16,
                 n_pages=None, obs=None, pool_name="paging"):
        assert not tier.cfg.is_encoder
        self.tier = tier
        self.E = tier.k
        self.paged = api.supports_paging(tier.cfg) if paged is None else bool(paged)
        if self.paged:
            from repro_torch.serve.cascade_server import tier_paged_programs

            self._init_pool(n_slots, max_seq, page_size, n_pages, obs=obs, pool_name=pool_name)
            self.pool_dev = ens.init_ensemble_paged_pool(tier.values, tier.cfg, self.pool.n_pages, page_size)
            progs = tier_paged_programs(tier.cfg, float(tier.temperature))
            self._decode_paged = progs.decode_slots
            self._chunk_paged = progs.prefill_chunk
            self.caches = None
            self.supports_chunked_prefill = True
        else:
            self.caches = api.init_cache_members(tier.cfg, self.E, n_slots, max_seq, tier.device)
            self.supports_chunked_prefill = tier._prefill_chunk is not None

    def decode(self, tok, pos):
        """One batched decode step for every member x slot; returns the
        next tokens (E, n_slots) on the host."""
        if self.paged:
            t, self.pool_dev = self._decode_paged(self.tier.values, tok, self.pool_dev, pos, self.pool.table)
        else:
            t, self.caches = self.tier._decode_slots(self.tier.values, tok, self.caches, pos)
        return host_fetch(t)[..., 0]

    def prefill_chunk(self, tokens, slot, start):
        """Write one pow2 prompt chunk into every member's ``slot``."""
        if self.paged:
            self.pool_dev = self._chunk_paged(self.tier.values, self.pool_dev, tokens, self.pool.table[slot], start)
        else:
            self.caches = self.tier._prefill_chunk(self.tier.values, self.caches, tokens, slot, start)

    def reset_slot(self, slot):
        """Zero the slot's constant-state leaves across all members."""
        if self.tier._reset_slot is not None:
            self.caches = self.tier._reset_slot(self.caches, slot)

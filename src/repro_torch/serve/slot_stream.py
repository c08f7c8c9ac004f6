"""SlotStream: the slot state machine behind all continuous batching (port
of ``repro.serve.slot_stream``).

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

In-flight admission: work whose payload is still crossing a ``Transport``
link (``serve/transport.py``) enters through ``submit_inflight`` as a
(``SendHandle``, finalize) pair instead of a ready ``Request``.  The
stream drains it only at its admission points: the top of ``refill()``
polls and never blocks (decode runs on while hops are in flight), and
``drain()`` or the serving loop's all-idle fallback blocks on the oldest handle
only when no stream has runnable work.  Handles land strictly in
submission order, so the admission order, and with it every slot's
sampling key, is what a blocking transport would give.  The poll runs
before the step's replay, never inside a graph capture.

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

and, for speculative deferral (``serve/speculative.py``), backends with
``supports_draft_verify`` take

    verify_draft(tokens (T+1,), slot, start, max_chunk) -> choices (E, T+1)
    accepted_prefix(choices, draft) -> n_acc  (over every member of the tier)
    extend_slot(slot, n_rows) -> bool   (map private rows before the pass)
    rollback_slot(slot, keep_rows)      (unmap what the pass left past them)

A request that arrives with a draft is admitted through the verify pass in
place of the last prompt token's decode feed: the pass emits the accepted
prefix and each member's own token after it, and decode resumes at
``pos = P + n_acc``.  A request the pass completes (budget or wall) never
decodes; ``step`` hands it back first.

``EngineBackend`` (E=1) and ``TierBackend`` (a cascade tier's ensemble)
default to block-paged pools where ``api.supports_paging`` allows (the
dense family) and keep the dense slot cache behind ``paged=False`` as the
parity oracle.  The constant-state families (``ssm_mamba2``,
``ssm_rwkv6``, ``hybrid``) always run the dense slot cache: their
``begin_slot`` zeroes the admitted slot's recurrent state through the
backend's ``reset_slot``.  Every
decode step makes exactly one device-to-host read: the metered
``host_fetch`` of the next tokens.

Compile-once: both backends run the decode step and each chunk bucket
through their owner's ``GraphSet`` (``serve/graphs.py``): on the card each
is captured as a CUDA graph at its first call and replayed after, with the
step's tokens, positions and page table (or the chunk's tokens, slot,
offset and table row) copied into the graph's static device buffers first.
The pools or slot caches live on the owning engine or tier
(``SlotMemory``, keyed by slot geometry), so a later run replays the graphs
an earlier one captured.

Sampling (temperature > 0): a tier samples inside its captured decode step
from per-slot keys (``serve/sampling.py``), staged as an (n_slots,) input
like the positions: ``TierBackend.begin_slot`` sets a slot's key from the
admission sequence number once the pool admits it, so a slot's tokens do
not depend on which slot it landed in or what shares its steps.  The
engine samples after the captured step from its own generator.

Admission cap: ``set_slot_limit`` (the open-loop controller's actuation)
stops slots at index >= ``slot_limit`` from admitting; their occupants
drain.  It changes no shape, so no program is captured again.
"""
from __future__ import annotations

import weakref
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import host_fetch, prompt_chunks
from repro_torch.models import api
from repro_torch.obs import Observability, StatsView
from repro_torch.serve.batching import Request
from repro_torch.serve.config import ServeConfig
from repro_torch.serve import sampling
from repro_torch.serve.graphs import GraphSet
from repro_torch.serve.paging import PagePool
from repro_torch.serve.speculative import accepted_prefix, plan_draft
from repro_torch.sharding import collectives


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
        # admission-side slot cap (<= n_slots): slots at index >= slot_limit
        # stop admitting; occupants above a lowered limit drain
        self.slot_limit = n_slots
        E = backend.E
        self.queue: deque = deque()
        # (SendHandle, finalize) pairs whose payload is still on a transport
        # link; drained in order at the admission points
        self.inflight: deque = deque()
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_consumed = np.zeros(n_slots, np.int64)  # prompt tokens fed
        self.slot_emitted: List[List[np.ndarray]] = [[] for _ in range(n_slots)]
        self.pos = np.zeros(n_slots, np.int32)
        self.tok = np.zeros((E, n_slots, 1), np.int32)
        self.steps = 0
        # requests the verify pass completed at admission (full acceptance
        # used the budget or hit the wall): ``step`` hands them back first
        self._admit_done: List[Tuple[Request, np.ndarray]] = []
        # cascade hook: called as (request, n_accepted, n_draft) after every
        # verify pass
        self.on_draft_verified = None
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
        self._c_inflight_admitted = sc.counter("inflight_admitted")
        # speculative verify: passes run, draft tokens offered, accepted
        self._c_spec_drafts = sc.counter("spec.drafts")
        self._c_spec_draft_tokens = sc.counter("spec.draft_tokens")
        self._c_spec_accepted = sc.counter("spec.accepted_tokens")
        # ready-queue depth after every enqueue and admission: the backlog
        # signal the open-loop controller reads
        self._g_queue = sc.gauge("queue_depth")
        # host wall time of the launches (PyTorch returns before the device
        # finishes: synchronise around refill()/step() for device latency)
        self._h_begin_slot = sc.histogram("admit.begin_slot_s")
        self._h_prefill_dispatch = sc.histogram("admit.prefill_dispatch_s")
        self._h_decode_dispatch = sc.histogram("decode.dispatch_s")
        # time blocked on unresolved transport handles (0 when hops hid)
        self._h_inflight_wait = sc.histogram("admit.inflight_wait_s")
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
            "inflight_admitted": lambda m=self._c_inflight_admitted: m.value,
            "inflight_wait": lambda m=self._h_inflight_wait: m.sum,
            "spec_drafts": lambda m=self._c_spec_drafts: m.value,
            "spec_draft_tokens": lambda m=self._c_spec_draft_tokens: m.value,
            "spec_accepted_tokens": lambda m=self._c_spec_accepted: m.value,
        })

    # -- admission ---------------------------------------------------------
    def _check_request(self, r: Request) -> Request:
        """The admission invariant of both entry paths: 1 <= len(tokens) <
        max_seq."""
        assert len(r.tokens) >= 1, f"request {r.rid}: empty prompt"
        assert len(r.tokens) < self.max_seq, (
            f"request {r.rid}: prompt length {len(r.tokens)} does not fit "
            f"max_seq={self.max_seq}"
        )
        return r

    def submit(self, requests: Sequence[Request]):
        """Enqueue ready requests (work still on a transport link enters
        through ``submit_inflight``).  Prompts must fit the slot:
        1 <= len(tokens) < max_seq."""
        for r in requests:
            self.queue.append(self._check_request(r))
            if self._tr.enabled:
                self._tr.begin(r.rid, "queue_wait", stream=self.name)
        self._g_queue.set(len(self.queue))

    def submit_inflight(self, handle, finalize):
        """Enqueue work whose payload is still crossing a transport link:
        ``handle`` a ``serve.transport.SendHandle``, ``finalize`` maps the
        delivered payload to the ``Request`` to admit.  The stream stays
        ``active`` (not ``runnable``) while anything is in flight."""
        self.inflight.append((handle, finalize))

    def poll_inflight(self, *, block: bool = False) -> int:
        """Move resolved in-flight sends into the queue, in submission order,
        stopping at the first unresolved handle.  With ``block`` and nothing
        resolved, waits on the oldest handle (serving loops do so only when no
        stream has runnable work).  Returns the number that landed."""
        landed = 0
        while self.inflight and (self.inflight[0][0].done() or (block and landed == 0)):
            handle, finalize = self.inflight.popleft()
            r = self._check_request(finalize(handle.result()))
            self.queue.append(r)
            self._h_inflight_wait.record(handle.wait_time)
            self._c_inflight_admitted.add(1)
            if self._tr.enabled:
                self._tr.begin(r.rid, "queue_wait", stream=self.name)
            landed += 1
        if landed:
            self._g_queue.set(len(self.queue))
        return landed

    def set_slot_limit(self, k: int) -> None:
        """Cap how many slots may hold occupants (clamped to ``[1,
        n_slots]``): a lowered limit takes effect as occupied slots free
        up; a raised one reopens admission at the next ``refill``."""
        self.slot_limit = max(1, min(int(k), self.n_slots))

    def _release(self, s: int):
        """Hand the slot's memory back to the backend (paged pools decref
        their pages; dense backends have nothing to return)."""
        release = getattr(self.backend, "release_slot", None)
        if release is not None:
            release(s)
        self.slot_req[s] = None
        self.slot_emitted[s] = []

    def _admit(self, s: int):
        if not self.queue or s >= self.slot_limit:
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
        # a deferral carrying the previous tier's agreeing generation scores
        # every draft position in one pass INSTEAD of the last prompt
        # token's decode feed, where the chunk loop left off (consumed ==
        # P-1), on backends whose cache can roll rejected rows back
        plan = None
        if r.draft is not None:
            draft, r.draft = r.draft, None  # consumed at this admission
            if self.chunked and getattr(self.backend, "supports_draft_verify", False):
                plan = plan_draft(r.tokens, draft, r.max_new_tokens, self.max_seq)
        verified = None
        if plan is not None:
            P, T_use = len(r.tokens), len(plan.draft)
            # paged: map private pages for the draft rows first; a refusal
            # (pool pressure) falls back to plain admission
            if self.backend.extend_slot(s, P + T_use):
                if tr.enabled:
                    tr.begin(r.rid, "verify_draft", draft_tokens=T_use)
                choices = self.backend.verify_draft(plan.tokens, s, plan.start, self.max_chunk)
                n_acc = self.backend.accepted_prefix(choices, plan.draft)
                # unmap pages wholly past the accepted span (dense: the
                # position mask already hides the rejected rows)
                self.backend.rollback_slot(s, P + n_acc)
                if tr.enabled:
                    tr.end(r.rid, "verify_draft", accepted=n_acc)
                self._c_spec_drafts.add(1)
                self._c_spec_draft_tokens.add(T_use)
                self._c_spec_accepted.add(n_acc)
                if self.on_draft_verified is not None:
                    self.on_draft_verified(r, n_acc, T_use)
                verified = (plan, choices, n_acc)
        self.slot_req[s] = r
        if verified is not None:
            plan, choices, n_acc = verified
            # accepted draft tokens are every member's own emission; position
            # n_acc emits each member's own choice: n_acc + 1 decode steps'
            # worth of output from one pass
            emitted = [np.full((self.backend.E,), d, np.int32) for d in plan.draft[:n_acc]]
            emitted.append(choices[:, n_acc].astype(np.int32).copy())
            self.slot_consumed[s] = len(r.tokens)
            self.slot_emitted[s] = emitted
            self.pos[s] = len(r.tokens) + n_acc
            self.tok[:, s, 0] = choices[:, n_acc]
        else:
            self.slot_consumed[s] = consumed + 1
            self.slot_emitted[s] = []
            self.pos[s] = consumed
            self.tok[:, s, 0] = r.tokens[consumed]
        self._c_admitted.add(1)
        if tr.enabled:
            tr.end(r.rid, "admit")
            tr.begin(r.rid, "decode", stream=self.name, slot=s)
        if verified is not None:
            # the pass may already satisfy the budget or hit the wall:
            # complete now (the slot never decodes), hand the result back
            # through step()'s _admit_done drain, and admit the next request
            full = len(self.slot_emitted[s]) >= r.max_new_tokens
            wall = self.pos[s] >= self.max_seq - 1
            if full or wall:
                _, gen = self._complete(s, self._admit_done, truncated=not full)
                if tr.enabled:
                    tr.end(r.rid, "decode", new_tokens=gen.shape[1], truncated=r.truncated)
                self._release(s)
                self._admit(s)

    def refill(self):
        """Admit queued requests into every free slot, after landing the
        in-flight sends that have resolved (a poll: decode never waits on
        the link here)."""
        if self.inflight:
            self.poll_inflight(block=False)
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                self._admit(s)

    @property
    def runnable(self) -> bool:
        """True when the stream can make progress now: a slot is occupied, a
        request is queued, or an admission-time completion waits to be
        handed back.  In-flight sends do not count (see ``active``)."""
        return any(r is not None for r in self.slot_req) or bool(self.queue) or bool(self._admit_done)

    @property
    def active(self) -> bool:
        """True while the stream still owes work: runnable, or a payload is
        in flight on a transport link."""
        return self.runnable or bool(self.inflight)

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
        # admission-time completions (fully accepted drafts) exit first:
        # the verify pass finished them and they own no slot
        completed, self._admit_done = self._admit_done, []
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
        """Step until every queued and in-flight request has completed; with
        only in-flight work left, block on the oldest handle."""
        done = []
        while self.active:
            if not self.runnable:
                self.poll_inflight(block=True)
            done.extend(self.step())
        return done


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


def _default_n_pages(n_slots: int, max_seq: int, page_size: int) -> int:
    """Dense-equivalent pool capacity plus the overflow sink: enough pages
    that no admission pattern the dense cache serves can ever fail."""
    return n_slots * (max_seq // page_size) + 1


def _no_user():
    return None


class SlotMemory:
    """One slot geometry's device memory of an engine or a cascade tier:
    its pools or slot caches (``state``) and the graphs captured over them
    (``graphs``).  A graph bakes in the addresses of what it reads and
    writes, so both live on their owner (a dict keyed by geometry) and every
    later run of that geometry reuses them; each run builds a fresh host
    ``PagePool`` over the same device pages.  Stale contents stay invisible
    by the stream's own contract: the per-slot position mask, unmapped
    pages read as zero rows, and recurrent state zeroed at admission.
    ``user`` (a weak reference) is the backend using it: a second live
    backend of the same owner and geometry gets memory of its own."""

    __slots__ = ("state", "graphs", "user")

    def __init__(self, state, device, pool=None):
        self.state = state
        self.graphs = GraphSet(device, pool)
        self.user = _no_user


class _SlotBackend:
    """The half both backends share: the owner's device memory for this
    geometry, the host ``PagePool`` bookkeeping with the begin / release /
    prepare hooks, and the graphed programs.  Decode and each chunk bucket
    run through ``self.mem.graphs`` (captured on the card, replayed after);
    ``reset_slot`` and ``copy_page`` stay eager: each is one strided copy or
    fill a leaf, nothing for a graph to save, and they are counted as eager
    programs.  ``eager=True`` runs everything eagerly: the oracle that the
    graphed path is held to, and nothing else."""

    def _init_slots(self, owner, device, cfg, *, n_slots, max_seq, paged, page_size, n_pages,
                    obs, pool_name, eager, graph_pool=None):
        """Host pool and device memory for this geometry: the owner's
        (``owner`` its geometry -> ``SlotMemory`` dict, None for memory of
        this backend's own), or new memory from ``_new_pool``/``_new_cache``,
        its graphs allocating from the owner's ``graph_pool``."""
        self.paged = api.supports_paging(cfg) if paged is None else bool(paged)
        self.eager = bool(eager)
        if self.paged:
            if n_pages is None:
                n_pages = _default_n_pages(n_slots, max_seq, page_size)
            self.pool = PagePool(n_pages, page_size, n_slots=n_slots, max_seq=max_seq, obs=obs, name=pool_name)
            geometry = (n_slots, max_seq, True, page_size, n_pages)
        else:
            geometry = (n_slots, max_seq, False, None, None)
        mem = None if owner is None else owner.get(geometry)
        if mem is None or mem.user() is not None:
            state = self._new_pool(n_pages, page_size) if self.paged else self._new_cache(n_slots, max_seq)
            mem = SlotMemory(state, device, graph_pool)
            if owner is not None:
                owner.setdefault(geometry, mem)
        mem.user = weakref.ref(self)
        self.mem = mem

    def _run(self, program, fn, *inputs, bucket=None):
        return self.mem.graphs.run(program.key, fn, *inputs, bucket=bucket, eager=self.eager)

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

    def extend_slot(self, slot, n_rows):
        """Cover rows ``[0, n_rows)`` with private pages before a verify
        pass writes draft rows past the admission span
        (``PagePool.extend``); dense slot rows are dedicated.  False when
        the pool cannot cover the span (the caller admits plainly)."""
        return self.pool.extend(slot, n_rows) if self.paged else True

    def rollback_slot(self, slot, keep_rows):
        """Unmap the pages wholly past rows ``[0, keep_rows)`` after a
        verify pass (``PagePool.truncate``).  Dense slots rely on the
        position mask: rejected rows are invisible, and the next decode
        writes its row before attending to it."""
        if self.paged:
            self.pool.truncate(slot, keep_rows)

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
                self.mem.graphs.eager(self._copy_page.key, self._copy_page, self.mem.state, src, dst)
        return oom

    def decode(self, tok, pos):
        """One decode step for every member x slot at its own ``pos``;
        returns the next tokens (E, n_slots) on the host, in the step's one
        device-to-host read."""
        keys = self._step_keys()
        if self.paged:
            out = self._run(self._decode_paged, self._decode_paged_fn, tok, pos, self.pool.table, *keys)
        else:
            out = self._run(self._decode, self._decode_fn, tok, pos, *keys)
        return host_fetch(self._after_step(out))

    def prefill_chunk(self, tokens, slot, start):
        """Write one pow2 prompt chunk into ``slot`` (every member's) at
        offset ``start``; one program a chunk length."""
        at = np.array([start], np.int64)
        if self.paged:
            self._run(self._chunk_paged, self._chunk_paged_fn, tokens, self.pool.table[slot], at,
                      bucket=len(tokens))
        else:
            self._run(self._chunk, self._chunk_fn, tokens, np.array([slot], np.int64), at, bucket=len(tokens))

    def reset_slot(self, slot):
        """Zero the slot's constant-state leaves across all members
        (nothing for position-masked families)."""
        if self._reset is not None:
            self.mem.graphs.eager(self._reset.key, self._reset, self.mem.state, slot)


class EngineBackend(_SlotBackend):
    """E=1 backend over a single model's programs (``model_programs``);
    ``sample`` turns logits (..., V) into token ids: with ``greedy`` (the
    argmax) it runs inside the captured decode step, otherwise after it, on
    the host side of the program (the engine's generator draws there).
    ``paged`` selects block-paged KV pools (default wherever the family
    supports them); ``paged=False`` keeps the dense slot cache as the
    parity oracle.  ``memory`` is the owning engine's geometry ->
    ``SlotMemory`` dict (None: memory of this backend's own) and
    ``graph_pool`` its graphs' pool; ``eager`` the oracle route."""

    def __init__(self, cfg, params, programs, sample, *, n_slots, max_seq, greedy=True,
                 prefill_counter=None, paged=None, page_size: int = 16,
                 n_pages=None, obs=None, pool_name="paging", memory=None, graph_pool=None, eager=False):
        assert not cfg.is_encoder
        self.cfg = cfg
        self.params = params
        self.E = 1
        self._decode = programs.decode
        self._chunk = programs.prefill_chunk
        self._reset = programs.reset_slot
        self._sample = sample
        self._greedy = bool(greedy)
        # the owning engine's ``engine.prefill_tokens`` counter; None
        # outside an engine
        self._prefill_counter = prefill_counter
        self._init_slots(
            memory, params["embed"].device, cfg, n_slots=n_slots, max_seq=max_seq, paged=paged,
            page_size=page_size, n_pages=n_pages, obs=obs, pool_name=pool_name, eager=eager,
            graph_pool=graph_pool,
        )
        if self.paged:
            from repro_torch.serve.engine import paged_model_programs

            progs = paged_model_programs(cfg)
            self._decode_paged = progs.decode
            self._chunk_paged = progs.prefill_chunk
            self._copy_page = progs.copy_page
            self.supports_chunked_prefill = True
        else:
            self.supports_chunked_prefill = self._chunk is not None

    def _new_pool(self, n_pages, page_size):
        return api.init_paged_pool(self.cfg, n_pages, page_size, self.params["embed"].device)

    def _new_cache(self, n_slots, max_seq):
        return api.init_cache(self.cfg, n_slots, max_seq, self.params["embed"].device)

    def _step_keys(self):
        return ()

    def _step_out(self, logits):
        return self._sample(logits)[None] if self._greedy else logits[None]

    def _after_step(self, out):
        return out if self._greedy else self._sample(out)

    def _decode_fn(self, tok, pos):
        logits, _ = self._decode(self.params, tok[0], self.mem.state, pos)
        return self._step_out(logits)

    def _decode_paged_fn(self, tok, pos, pages):
        logits, _ = self._decode_paged(self.params, tok[0], self.mem.state, pos, pages)
        return self._step_out(logits)

    def _chunk_fn(self, tokens, slot, start):
        self._chunk(self.params, tokens, self.mem.state, slot, start)

    def _chunk_paged_fn(self, tokens, pages_row, start):
        self._chunk_paged(self.params, tokens, self.mem.state, pages_row, start)

    def prefill_chunk(self, tokens, slot, start):
        super().prefill_chunk(tokens, slot, start)
        if self._prefill_counter is not None:
            self._prefill_counter.add(len(tokens))


class TierBackend(_SlotBackend):
    """E=k backend over a cascade tier's stacked-ensemble programs (one
    batched program advances every member and samples its tokens, which
    come back in one fetch).  Paged tiers stack E pool planes under ONE
    page table: members score the same tokens at the same positions, so
    every shared prefix page is an E-fold memory saving.  Device memory and
    graphs live on the tier (``CascadeTier.slot_memory``); ``eager`` is the
    oracle route.

    Sampling determinism: every slot owns a key ``fold_in(base_key(seed),
    admit_seq)`` assigned at admission (admission order is FIFO), and each
    sampled token draws on (slot key, position, member): a slot's sampled
    trajectory depends only on its own occupant and history, never on its
    slot index, ``n_slots`` or which other slots share its decode steps."""

    def __init__(self, tier, *, n_slots, max_seq, seed: int = 0, paged=None, page_size: int = 16,
                 n_pages=None, obs=None, pool_name="paging", eager=False):
        assert not tier.cfg.is_encoder
        self.tier = tier
        self.E = tier.k
        self._base_key = sampling.base_key(seed)
        self._admit_seq = 0
        self.slot_keys = np.full(n_slots, self._base_key, np.int64)
        self._decode = tier._decode_slots
        self._chunk = tier._prefill_chunk
        self._reset = tier._reset_slot
        self._init_slots(
            tier.slot_memory, tier.device, tier.cfg, n_slots=n_slots, max_seq=max_seq, paged=paged,
            page_size=page_size, n_pages=n_pages, obs=obs, pool_name=pool_name, eager=eager,
            graph_pool=tier.graph_pool,
        )
        self._verify = tier._verify_chunk
        if self.paged:
            from repro_torch.serve.cascade_server import tier_paged_programs

            progs = tier_paged_programs(tier.cfg, float(tier.temperature), tier.member_offset)
            self._decode_paged = progs.decode_slots
            self._chunk_paged = progs.prefill_chunk
            self._verify_paged = progs.verify_chunk
            self._copy_page = progs.copy_page
            self.supports_chunked_prefill = True
            # paged families are attention families: always verifiable
            self.supports_draft_verify = True
        else:
            self.supports_chunked_prefill = self._chunk is not None
            self.supports_draft_verify = self._verify is not None

    def _new_pool(self, n_pages, page_size):
        return ens.init_ensemble_paged_pool(self.tier.values, self.tier.cfg, n_pages, page_size)

    def _new_cache(self, n_slots, max_seq):
        return api.init_cache_members(self.tier.cfg, self.E, n_slots, max_seq, self.tier.device)

    def begin_slot(self, slot, tokens, *, share=True):
        """Claim the slot's memory, then assign its admission key."""
        shared = super().begin_slot(slot, tokens, share=share)
        if shared is None:
            return None  # pool refusal: the occupant (and its key) stays out
        self._admit_seq += 1
        self.slot_keys[slot] = sampling.fold_in(self._base_key, self._admit_seq)
        return shared

    def _step_keys(self):
        return (self.slot_keys,)

    def _after_step(self, out):
        return out

    def _decode_fn(self, tok, pos, keys):
        return self._decode(self.tier.values, tok, self.mem.state, pos, keys)[0][..., 0]

    def _decode_paged_fn(self, tok, pos, pages, keys):
        return self._decode_paged(self.tier.values, tok, self.mem.state, pos, pages, keys)[0][..., 0]

    def _chunk_fn(self, tokens, slot, start):
        self._chunk(self.tier.values, self.mem.state, tokens, slot, start)

    def _chunk_paged_fn(self, tokens, pages_row, start):
        self._chunk_paged(self.tier.values, self.mem.state, tokens, pages_row, start)

    def verify_draft(self, tokens, slot, start, max_chunk):
        """Score the verify chunk ``[prompt[-1], d_0..d_{T-1}]`` at positions
        ``[start, start + len(tokens))`` and return every member's
        decode-equivalent choices, (E, len(tokens)) host int32.  Runs in the
        ``prompt_chunks`` buckets of chunked admission, each one program
        (captured at its first call), with the slot's key, set by
        ``begin_slot``, a staged input; a bucket's choices are copied out
        before the next replay, since two chunks of one size can follow each
        other, and come back in one metered fetch."""
        key = np.array([self.slot_keys[slot]], np.int64)
        outs, off = [], 0
        for c in prompt_chunks(len(tokens), max_chunk):
            at = np.array([start + off], np.int64)
            if self.paged:
                t = self._run(self._verify_paged, self._verify_paged_fn, tokens[off: off + c],
                              self.pool.table[slot], at, key, bucket=c)
            else:
                t = self._run(self._verify, self._verify_fn, tokens[off: off + c], np.array([slot], np.int64),
                              at, key, bucket=c)
            outs.append(t.clone())
            off += c
        return host_fetch(torch.cat(outs, dim=1))

    def accepted_prefix(self, choices, draft) -> int:
        """``speculative.accepted_prefix`` over every member of the tier: a
        rank that holds some of the members of a tier split over a mesh's
        'pod' axis (``tier.member_group``) takes the least of its 'pod'
        group's prefixes, so every rank emits the same span."""
        n = accepted_prefix(choices, draft)
        group = self.tier.member_group
        if group is not None:
            t = torch.tensor([n], dtype=torch.int64, device=collectives.wire_device(self.tier.device))
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
            n = int(t.item())
        return n

    def _verify_fn(self, tokens, slot, start, key):
        return self._verify(self.tier.values, self.mem.state, tokens, slot, start, key)[0]

    def _verify_paged_fn(self, tokens, pages_row, start, key):
        return self._verify_paged(self.tier.values, self.mem.state, tokens, pages_row, start, key)[0]

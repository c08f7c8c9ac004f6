"""CascadeServer: ABC as a serving runtime (port of
``repro.serve.cascade_server``).

* ``classify`` — each tier's ensemble produces last-token logits (one
  captured program a tier and pow2 (B, S) bucket); the agreement rule
  (Eq. 3/4) selects or defers; deferred rows are compacted on the device
  and re-batched for the next tier.  Routing, agreement and compaction run
  eagerly between the tiers' graphs, as they run between the JAX
  package's jitted tier programs.
* ``generate`` — black-box flavour: every member of a tier generates,
  greedily or sampled, all members in one batched program per decode step
  (the prefill and the decode step captured once a (B, S, max_new) over the
  tier's static cache); answers become stable crc32 digests and are
  compared by vote (``vote_rule_from_preds``).
* ``serve_continuous`` — cascade-aware continuous batching: each tier runs
  a ``SlotStream`` (the same slot state machine the single-model engine
  drives at E=1, here at E=k) over block-paged KV pools (dense slot caches
  for the constant-state families, whose slots are zeroed at admission)
  with chunked prefill admission; a slot that finishes votes on its member generations,
  and a disagreement re-queues the request on the next tier.  Tier streams
  are stepped round-robin, so tier i+1 starts while tier i still decodes.
  With ``ServeConfig(speculative=True)`` a deferral carries the tier's
  plurality generation as a draft, which the next tier verifies in one
  chunked pass (``serve/speculative.py``).
* ``serve_open_loop`` — the same run machinery driven by a workload's
  arrival times in virtual time (``serve/workload.py``), optionally under
  the greedy admission controller (``serve/controller.py``), scored by
  SLO goodput.

Sampling at ``temperature > 0`` is the counter-based Gumbel-max draw of
``serve/sampling.py``, inside the captured programs: batch generation keys
row b on ``(seed, b)`` and the fed token's position, continuous batching
keys each slot on ``(ServeConfig.seed + tier index, admission sequence)``.
JAX's PRNG cannot be reproduced, so sampled tokens are held to the port's
own invariants (paged == dense, graphed == eager, slot reuse, n_slots),
and greedy ones to the JAX package's tokens.

Over a mesh placement (``pod_placement``) every rank of the world runs
the server (SPMD): tier i computes on the ranks of pod slice i, each on the
members it holds (sampling each as its index in the whole ensemble), and
the answers and verdicts come together on the slice's first rank; see
``CascadeServer.__init__`` and ``_MeshRun``.

Placement (``serve/placement.py``): ``CascadeServer(placement=...)`` pins
each tier to a host and makes every cross-host deferral an explicit metered
``Transport`` hop (``serve/transport.py``).  In the batch modes only the
compacted deferral payload (the deferred rows and their int32 index map,
padded to the bucket cover) crosses; in continuous mode the deferred
request's prompt does (and under ``speculative`` the draft with it), sent
with ``send_async`` and admitted on the next tier when the handle resolves,
so with an ``AsyncTransport`` the edge tier decodes on while payloads are
on the wire.  Tokens do not depend on the link: tier i+1 admits deferrals
in submission order whatever the link's timing, and a slot's sampling key
comes from its admission sequence.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from collections import deque
from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import deferral
from repro_torch.core import ensemble as ens
from repro_torch.core.cascade import CascadeResult, TierSpec, cascade_apply_routed, host_fetch
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.params import tree_map
from repro_torch.obs import UNIT_BUCKETS, Observability
from repro_torch.serve.batching import Request
from repro_torch.serve.config import ServeConfig
from repro_torch.serve import sampling
from repro_torch.serve.engine import grow_cache
from repro_torch.serve.graphs import BATCH_BUCKETS, GraphPool, GraphSet, Program
from repro_torch.serve.placement import place_tier_values
from repro_torch.serve.slot_stream import SlotStream, TierBackend
from repro_torch.serve.speculative import verify_choices
from repro_torch.serve.workload import VirtualClock, Workload
from repro_torch.sharding import collectives
from repro_torch.sharding.mesh import first_rank


def stable_digest(tokens) -> int:
    """Process-independent canonical id for a token sequence: crc32 of the
    little-endian int32 encoding, masked to 30 bits so every digest stays
    below ``vote_rule_from_preds``'s 2**30 sentinel."""
    row = np.ascontiguousarray(np.asarray(host_fetch(tokens), np.int32)).astype("<i4")
    return zlib.crc32(row.tobytes()) & 0x3FFFFFFF


def digest_generations(out: np.ndarray) -> np.ndarray:
    """(E, B, T) member generations -> (E, B) int32 canonical answer ids."""
    E, B = out.shape[:2]
    return np.asarray([[stable_digest(out[e, b]) for b in range(B)] for e in range(E)], np.int32)


def _program_key(cfg: ModelConfig, temperature: float, member_offset: int) -> str:
    """``"<cfg.name>@T<temperature>"``, the JAX package's key; a tier whose
    first member is not member 0 (a rank's members of a tier split over a
    mesh's 'pod' axis) draws on other member indices: ``+m<offset>``."""
    key = f"{cfg.name}@T{temperature:g}"
    return key if member_offset == 0 else f"{key}+m{member_offset}"


@functools.lru_cache(maxsize=None)
def tier_programs(cfg: ModelConfig, temperature: float, member_offset: int = 0) -> SimpleNamespace:
    """The programs of one tier, with the JAX package's key inputs:

    ``last_logits(values, batch) -> (E, B, V)``
    ``prefill(values, batch, rng, *, cache=None) -> (tok (E, B, 1), caches)``
    ``decode(values, tok, caches, pos, rng) -> (tok, caches)``
    ``decode_slots(values, tok, caches, pos, slot_keys) -> (tok, caches)``
        (per-slot (B,) ``pos``, continuous batching over the dense slot
        cache)
    ``prefill_chunk(values, caches, tokens, slot, start) -> caches``
    ``verify_chunk(values, caches, tokens, slot, start, slot_key) ->
        (choices (E, C), caches)`` (the speculative verify pass: a chunk
        that also scores every position, its tokens drawn as the decode
        step draws them; None where ``api.supports_draft_verify`` is false)
    ``reset_slot(caches, slot) -> caches`` (zero every member's recurrent
        state in the slot; None for the dense family, which has none).

    ``rng`` and ``slot_keys`` are (B,) int64 keys (``serve/sampling.py``):
    a token is sampled from (key, position of the token whose logits pick
    it, member ``member_offset + e``), the argmax at ``temperature`` 0.  ``pos`` is an int or a
    (B,) device tensor (a captured step's); ``prefill`` draws at S - 1 and
    writes into ``cache`` when one is given (``api.prefill_members``).

    Each is a ``Program`` keyed ``"<cfg.name>@T<temperature>/ens_<name>"``,
    the JAX package's keys; a tier captures ``last_logits``, ``prefill``
    and ``decode`` per batch bucket and ``decode_slots``, ``prefill_chunk``
    and ``verify_chunk`` per slot geometry (``serve/graphs.py``)."""
    key = _program_key(cfg, temperature, member_offset)

    def _tokens(logits, keys, pos):
        return sampling.sample(logits, keys, pos, temperature, member_offset)[..., None]

    def last_logits(values, batch):
        return ens.ensemble_last_logits(values, batch, cfg)

    def prefill(values, batch, rng, *, cache=None):
        logits, caches = ens.ensemble_prefill(values, batch, cfg, cache=cache)
        return _tokens(logits, rng, batch["tokens"].shape[1] - 1), caches

    def decode(values, tok, caches, pos, rng):
        logits, caches = ens.ensemble_decode_step(values, tok, caches, pos, cfg)
        return _tokens(logits, rng, pos), caches

    def prefill_chunk(values, caches, tokens, slot, start):
        return ens.ensemble_prefill_into_slot(values, tokens, caches, slot, start, cfg)

    def verify_chunk(values, caches, tokens, slot, start, slot_key):
        logits, caches = ens.ensemble_prefill_into_slot_logits(values, tokens, caches, slot, start, cfg)
        return verify_choices(logits, slot_key, start, temperature, member_offset), caches

    return SimpleNamespace(
        last_logits=Program(f"{key}/ens_last_logits", last_logits),
        prefill=Program(f"{key}/ens_prefill", prefill),
        decode=Program(f"{key}/ens_decode", decode),
        decode_slots=Program(f"{key}/ens_decode_slots", decode),
        prefill_chunk=(
            Program(f"{key}/ens_prefill_chunk", prefill_chunk) if api.supports_chunked_prefill(cfg) else None
        ),
        verify_chunk=(
            Program(f"{key}/ens_verify_chunk", verify_chunk) if api.supports_draft_verify(cfg) else None
        ),
        reset_slot=(
            Program(f"{key}/ens_slot_reset", functools.partial(api.reset_slot_members, cfg=cfg))
            if api.has_slot_state(cfg) else None
        ),
    )


@functools.lru_cache(maxsize=None)
def tier_paged_programs(cfg: ModelConfig, temperature: float, member_offset: int = 0) -> SimpleNamespace:
    """Block-paged counterparts of the continuous-mode programs: E pool
    planes advance under ONE shared (n_slots, n_pg) page table, with the
    per-slot admission keys for sampling:
    ``decode_slots(values, tok, pools, pos, pages, slot_keys)``,
    ``prefill_chunk(values, pools, tokens, pages_row, start)`` and
    ``verify_chunk(values, pools, tokens, pages_row, start, slot_key)``."""
    assert api.supports_paging(cfg), cfg.family
    key = _program_key(cfg, temperature, member_offset)

    def decode_slots(values, tok, pools, pos, pages, slot_keys):
        logits, pools = ens.ensemble_decode_step_paged(values, tok, pools, pos, pages, cfg)
        return sampling.sample(logits, slot_keys, pos, temperature, member_offset)[..., None], pools

    def prefill_chunk(values, pools, tokens, pages_row, start):
        return ens.ensemble_prefill_into_slot_paged(values, tokens, pools, pages_row, start, cfg)

    def verify_chunk(values, pools, tokens, pages_row, start, slot_key):
        logits, pools = ens.ensemble_prefill_into_slot_paged_logits(values, tokens, pools, pages_row, start, cfg)
        return verify_choices(logits, slot_key, start, temperature, member_offset), pools

    return SimpleNamespace(
        decode_slots=Program(f"{key}/ens_decode_paged", decode_slots),
        prefill_chunk=Program(f"{key}/ens_prefill_chunk_paged", prefill_chunk),
        verify_chunk=Program(f"{key}/ens_verify_chunk_paged", verify_chunk),
        copy_page=Program(f"{key}/ens_copy_pool_page", api.copy_pool_page),
    )


@dataclasses.dataclass
class CascadeTier:
    """One cascade level: a stacked k-member ensemble (``values`` with a
    leading member axis) plus its ``TierSpec`` deferral rule.  ``device``
    None means the card.  The tier owns its graphs and the device memory
    they are captured over, so later calls replay what earlier ones
    captured, and all go with the tier: ``graphs`` (classify's last-token
    logits a (B, S), generate's prefill and decode step and its static
    cache of (B, S + max_new) rows a (B, S, max_new); at most
    ``BATCH_BUCKETS`` buckets, the least recently used evicted) and
    ``slot_memory`` (slot geometry -> ``SlotMemory``: the pools or slot
    caches of the tier's slot streams and their graphs), all allocating
    from ``graph_pool``.

    ``k`` counts the members in ``values``.  Under a mesh placement whose
    slice splits the members over 'pod' that is a rank's share of
    ``spec.k``: ``member_offset`` is the stacked index of its first member
    (what it samples as, ``serve/sampling.py``) and ``member_group`` the
    'pod' group of the ranks that hold the others (None: the tier holds
    every member)."""

    cfg: ModelConfig
    values: dict
    spec: TierSpec
    temperature: float = 0.0
    device: object = None
    member_offset: int = 0
    member_group: object = dataclasses.field(default=None, repr=False, compare=False)
    graph_pool: GraphPool = dataclasses.field(default_factory=GraphPool, init=False, repr=False, compare=False)
    slot_memory: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # meta values: a tier this rank does not serve (a mesh placement's
        # other slices), never computed here
        self.values = tree_map(lambda t: t if t.is_meta else t.to(self.device), self.values)
        self.graphs = GraphSet(self.device, self.graph_pool, BATCH_BUCKETS)
        self.k = ens.member_count(self.values)
        programs = tier_programs(self.cfg, float(self.temperature), self.member_offset)
        self._last_logits = programs.last_logits
        self._prefill = programs.prefill
        self._decode = programs.decode
        self._decode_slots = programs.decode_slots
        self._prefill_chunk = programs.prefill_chunk
        self._verify_chunk = programs.verify_chunk
        self._reset_slot = programs.reset_slot

    def last_logits(self, tokens, *, eager: bool = False) -> torch.Tensor:
        """Member last-token logits (E, B, V) of tokens (B, S), host or
        device: one captured program a (B, S).  The result of a replay is
        the graph's output buffer: read it before the tier's next call."""
        if eager:
            return self._last_logits_fn(torch.as_tensor(tokens, device=self.device))
        return self.graphs.run(self._last_logits.key, self._last_logits_fn, tokens,
                               bucket=("classify", tuple(tokens.shape)))

    def generate(self, tokens: np.ndarray, max_new_tokens: int, seed: int = 0, *,
                 eager: bool = False, rows=None) -> np.ndarray:
        """Ensemble generation, greedy or sampled (``temperature``) under
        ``seed``: tokens (B, S) -> (E, B, max_new).  The prefill writes into
        the tier's static cache of (B, S + max_new) rows and the decode step
        runs over it at a (B,) device position, each captured once a (B, S,
        max_new) and replayed after; ``eager`` runs the oracle (a fresh
        cache grown by ``grow_cache``, scalar positions).  ``rows`` (B,)
        are the rows' indices in the whole batch (default 0..B-1), which
        key their draws: a rank that holds a block of the batch samples
        what the whole batch's generation samples for it."""
        assert max_new_tokens >= 1, max_new_tokens
        B, S = tokens.shape
        keys = sampling.batch_keys(seed, B, rows)
        if eager:
            return self._generate_eager(tokens, max_new_tokens, torch.as_tensor(keys, device=self.device))
        bucket = (B, S, max_new_tokens)
        cache = self.graphs.bucket(bucket, lambda: api.init_cache_members(
            self.cfg, self.k, B, S + max_new_tokens, self.device))
        tok = self.graphs.run(self._prefill.key, functools.partial(self._prefill_into, cache), tokens, keys,
                              bucket=bucket)
        out = [host_fetch(tok)[..., 0]]
        pos = np.empty(B, np.int64)
        for t in range(max_new_tokens - 1):
            pos.fill(S + t)
            tok = self.graphs.run(self._decode.key, functools.partial(self._decode_in, cache), tok, pos, keys,
                                  bucket=bucket)
            out.append(host_fetch(tok)[..., 0])
        return np.stack(out, axis=2)  # (E, B, T)

    def _generate_eager(self, tokens, max_new_tokens, keys):
        S = tokens.shape[1]
        tok, caches = self._prefill(self.values, {"tokens": torch.as_tensor(tokens, device=self.device)}, keys)
        caches = grow_cache(caches, max_new_tokens, self.cfg)
        out = [host_fetch(tok)[..., 0]]
        for t in range(max_new_tokens - 1):
            tok, caches = self._decode(self.values, tok, caches, S + t, keys)
            out.append(host_fetch(tok)[..., 0])
        return np.stack(out, axis=2)

    @property
    def batch_caches(self) -> dict:
        """generate's static caches kept now, by (B, S, max_new) bucket."""
        return {b: m for b, m in self.graphs.buckets.items() if m is not None}

    def _last_logits_fn(self, tokens):
        return self._last_logits(self.values, {"tokens": tokens})

    def _prefill_into(self, cache, tokens, keys):
        return self._prefill(self.values, {"tokens": tokens}, keys, cache=cache)[0]

    def _decode_in(self, cache, tok, pos, keys):
        return self._decode(self.values, tok, cache, pos, keys)[0]


@dataclasses.dataclass
class OpenLoopReport:
    """What one ``CascadeServer.serve_open_loop`` run measured.

    ``goodput`` is SLO attainment: the fraction of offered requests that
    completed within ``slo_s`` of their arrival; shed requests and SLO
    misses both count against it.  ``completed + shed`` partitions the
    offered trace (asserted by ``serve_open_loop``); the latency percentiles come
    from the run's ``serve.request_latency_s`` histogram."""

    offered: int
    completed: List[Request]
    shed: List[Request]
    completed_in_slo: int
    goodput: float
    p50_s: float
    p99_s: float
    makespan_s: float
    controller_actions: List[dict] = dataclasses.field(default_factory=list)

    def __repr__(self):
        return (
            f"OpenLoopReport(offered={self.offered}, done={len(self.completed)}, shed={len(self.shed)}, "
            f"goodput={self.goodput:.3f}, p50={self.p50_s:.4g}s, p99={self.p99_s:.4g}s, "
            f"makespan={self.makespan_s:.4g}s)"
        )


class _CascadeRun:
    """One serve run's machinery, shared by the closed-loop
    (``serve_continuous``) and open-loop (``serve_open_loop``) entry points:
    per-tier ``SlotStream``s over ``TierBackend``s, the vote / defer /
    complete routing and the telemetry scopes.  The two differ only in
    when requests enter and how time advances.

    ``theta_offset`` is the open-loop controller's deferral actuation: tier
    i defers on ``vote_frac <= clamp(spec.theta + theta_offset[i], 0,
    1)``.  At offset 0 the vote reads ``spec.theta`` unmodified, so a run
    without a controller is bitwise the plain ``serve_continuous``."""

    def __init__(self, server: "CascadeServer", cfg: ServeConfig, ob: Observability, eager: bool):
        self.tiers = server.tiers
        self.device = server.device
        self.placement = server.placement
        self.hosts = server._host_names()
        self.ob = ob
        self.tr = ob.tracer
        self.clk = ob.clock
        self.h_lat = ob.registry.histogram("serve.request_latency_s")
        if self.placement is not None:
            for i, link in enumerate(self.placement.links):
                if link is not None:
                    link.attach_obs(ob, f"{self.hosts[i]}_{self.hosts[i + 1]}")
        tier_sc = [ob.scope(f"cascade.tier{i}") for i in range(len(self.tiers))]
        self.c_answered = [sc.counter("answered") for sc in tier_sc]
        self.c_deferred = [sc.counter("deferred") for sc in tier_sc]
        self.c_tokens = [sc.counter("output_tokens") for sc in tier_sc]
        self.h_margin = [sc.histogram("agreement_margin", buckets=UNIT_BUCKETS) for sc in tier_sc]
        self.h_accept = [sc.histogram("draft_accept_rate", buckets=UNIT_BUCKETS) for sc in tier_sc]
        self.speculative = bool(cfg.speculative)
        self.theta_offset: List[float] = [0.0] * len(self.tiers)
        self.streams = [self._stream(i, t, cfg, ob, eager) for i, t in enumerate(self.tiers)]
        for h, st in zip(self.h_accept[1:], self.streams[1:]):
            st.on_draft_verified = self._accept_recorder(h)
        self.t_start: dict = {}
        self.done: List[Request] = []

    def _stream(self, i: int, tier: CascadeTier, cfg: ServeConfig, ob: Observability, eager: bool):
        return SlotStream(
            TierBackend(
                tier, n_slots=cfg.n_slots, max_seq=cfg.max_seq, seed=cfg.seed + i, paged=cfg.paged,
                page_size=cfg.page_size, n_pages=cfg.n_pages,
                obs=ob, pool_name=f"paging.tier{i}", eager=eager,
            ),
            dataclasses.replace(cfg, obs=ob),
            name=f"slot_stream.tier{i}",
        )

    @staticmethod
    def _accept_recorder(h):
        """The hook a stream calls after each verify pass.  It holds the
        histogram, not the run: a run -> stream -> hook -> run cycle would
        keep the backends alive past the run, and with them their claim on
        the tier's slot memory."""
        def record(r, n_acc, n_draft):
            h.record(n_acc / max(1, n_draft))

        return record

    def submit(self, requests: Sequence[Request], *, t0=None) -> None:
        """Enqueue onto tier 0.  ``t0`` overrides the latency clock's origin
        (open loop passes the arrival time, so queue wait before admission
        counts against the SLO)."""
        for r in requests:
            self.t_start[r.rid] = self.clk() if t0 is None else t0
        self.streams[0].submit(requests)

    @property
    def runnable(self) -> bool:
        return any(st.runnable for st in self.streams)

    @property
    def active(self) -> bool:
        return any(st.active for st in self.streams)

    def block_on_inflight(self) -> None:
        """Every stream idle but payloads still on the wire: block on the
        oldest in-flight hop (there is no compute left to hide it behind)."""
        next(st for st in self.streams if st.inflight).poll_inflight(block=True)

    def effective_theta(self, i: int) -> float:
        off = self.theta_offset[i]
        th = self.tiers[i].spec.theta
        return th if off == 0.0 else min(1.0, max(0.0, th + off))

    def sweep(self) -> None:
        """One round-robin pass: step every stream once, routing each
        completed slot through its tier's vote.  Deferred re-queues land on
        tier i+1 before its step in the same sweep."""
        for i, st in enumerate(self.streams):
            for r, gen in st.step():
                self._finish_slot(i, r, gen)

    def _finish_slot(self, i: int, r: Request, gen: np.ndarray) -> None:
        defer_h, votes, winner = self._vote(i, gen)
        self._route(i, r, defer_h, votes / gen.shape[0], winner)

    def _vote(self, i: int, gen: np.ndarray):
        """Tier i's vote over a completed slot's member generations (E, T):
        -> (defer, the winning digest's vote count, the winning generation)."""
        digests = np.asarray([stable_digest(gen[e]) for e in range(gen.shape[0])], np.int32)
        out = deferral.vote_rule_from_preds(
            torch.as_tensor(digests[:, None], device=self.device), self.effective_theta(i)
        )
        # one metered fetch per completed slot: the vote verdict and the
        # winning digest
        defer_h, pred_h = host_fetch((out.defer[0], out.pred[0]))
        votes = int(np.unique(digests, return_counts=True)[1].max())
        return bool(defer_h), votes, gen[int(np.argmax(digests == pred_h))]

    def _route(self, i: int, r: Request, defer_h: bool, margin: float, winner: np.ndarray) -> None:
        """A verdict's consequences: the request exits with ``winner`` (T,)
        as its output, or is re-queued on tier i + 1.  ``margin`` is the
        winning digest's vote share (1.0 = unanimous)."""
        tr = self.tr
        defer = defer_h and i < len(self.streams) - 1
        self.h_margin[i].record(margin)
        if tr.enabled:
            tr.instant(r.rid, "defer_vote", tier=i, margin=margin, defer=defer_h)
        if defer:
            self.c_deferred[i].add(1)
            # cascade-as-drafter: the plurality generation this tier voted
            # on becomes the next tier's draft
            draft = winner.astype(np.int32) if self.speculative and winner.shape[0] else None
            link = self.placement.link(i) if self.placement is not None else None
            if link is None:
                r.draft = draft
                self.streams[i + 1].submit([r])
            else:
                self._send_deferral(i, link, r, draft)
            return
        self.c_answered[i].add(1)
        self.c_tokens[i].add(int(winner.shape[0]))
        r.output = winner.astype(np.int32)
        r.tier = i
        self.h_lat.record(self.clk() - self.t_start[r.rid])
        if tr.enabled:
            tr.instant(r.rid, "complete", tier=i)
        self.done.append(r)

    def _send_deferral(self, i: int, link, r: Request, draft: Optional[np.ndarray]) -> None:
        """Cross-host re-queue: the prompt (and the draft) is the payload.
        ``send_async`` meters the hop now; the handle joins tier i+1's
        in-flight queue and lands at one of its admission points, so this
        tier's other slots decode on over the hop."""
        tr = self.tr
        hosts = self.hosts
        payload = {"tokens": np.asarray(r.tokens, np.int32)}
        if draft is not None:
            payload["draft"] = draft  # rides the same metered hop
        if tr.enabled:
            tr.begin(r.rid, "hop", src=hosts[i], dst=hosts[i + 1],
                     n_bytes=int(sum(v.nbytes for v in payload.values())))
        handle = link.send_async(hosts[i], hosts[i + 1], payload, n_examples=1)
        hop = link.hops[-1]  # metered at send time

        def land(delivered, r=r, handle=handle, hop=hop):
            # the delivered payload is back on the host as the request's
            # prompt (not a metered fetch: the JAX package's count)
            r.tokens = _host_int32(delivered["tokens"])
            r.draft = _host_int32(delivered["draft"]) if "draft" in delivered else None
            if tr.enabled:
                # the span closes at delivery; blocked is what result()
                # charged the caller, hidden the link time decode covered
                blocked = float(handle.wait_time)
                tr.end(r.rid, "hop", link_s=float(hop.latency), blocked_s=blocked,
                       hidden_s=max(0.0, float(hop.latency) - blocked))
            return r

        self.streams[i + 1].submit_inflight(handle, land)


class _RemoteStream:
    """A tier's stream as a rank outside the tier's slice sees it under a
    mesh placement: no slots and no computation.  Its queue depth (the
    gauge the open-loop controller reads) is what the slice's first rank
    broadcast after the tier's last step plus what was submitted since, so
    it equals the stream's own on the slice; its slot cap follows the
    controller as the stream's does."""

    def __init__(self, n_slots: int, ob: Observability, name: str):
        self.n_slots = self.slot_limit = n_slots
        self.inflight: deque = deque()  # a mesh hop lands where it is sent
        self.stats: dict = {}
        self._g_queue = ob.scope(name).gauge("queue_depth")

    def submit(self, requests: Sequence[Request]) -> None:
        self._g_queue.set(self._g_queue.value + len(requests))

    def sync_queue(self, depth: int) -> None:
        self._g_queue.set(depth)

    def set_slot_limit(self, k: int) -> None:
        self.slot_limit = max(1, min(int(k), self.n_slots))


class _MeshRun(_CascadeRun):
    """``_CascadeRun`` over a mesh placement: every rank of the world runs
    the same control loop, and a rank steps tier i's ``SlotStream`` only
    where it belongs to slice i, decoding its own members.  Generation has
    no EOS, so every slot runs to its budget and the ranks of a slice
    admit, step and complete the same slots without hearing from each
    other (a speculative verify pass agrees its accepted prefix over 'pod',
    ``TierBackend.accepted_prefix``); only the vote needs every member.

    After each step of tier i its completed slots' generations are
    gathered over 'pod' in one gather onto the slice's first rank, which
    votes and broadcasts the verdicts to the world: a header (completions,
    body length, the stream's queue depth) and one packed int32 body
    (request, defer, votes, truncated, length and the winning generation a
    completion).  Every rank applies them in the same order, so requests,
    counters, histograms and the controller's inputs are the same on every
    rank.  A deferral is a hop of the prompt (and under ``speculative`` the
    draft) from that rank over the boundary's mesh transport, which every
    rank meters; its delivery moves the rows point to point inside
    ``send_async``, at the same place in every rank's loop and in the same
    order, on the caller's thread (never a worker's, which could deadlock
    the group).  A request's progress is counted on every rank
    (``pending``), so the loop's runnable and active tests agree too."""

    def __init__(self, server: "CascadeServer", cfg: ServeConfig, ob: Observability, eager: bool):
        self.meshes = [h.mesh for h in server.placement.hosts]
        self.here = [collectives.in_mesh(m) for m in self.meshes]
        self.members = [api._anchor(v).shape[0] for v in server.placed_values]
        self.pods = [_pod_split(v, m) for v, m in zip(server.placed_values, self.meshes)]
        super().__init__(server, cfg, ob, eager)
        self.pending = [0] * len(self.tiers)
        self.reqs: List[Request] = []
        self.seq: dict = {}

    def _stream(self, i, tier, cfg, ob, eager):
        if self.here[i]:
            return super()._stream(i, tier, cfg, ob, eager)
        return _RemoteStream(cfg.n_slots, ob, f"slot_stream.tier{i}")

    def submit(self, requests: Sequence[Request], *, t0=None) -> None:
        for r in requests:
            self.seq[id(r)] = len(self.reqs)
            self.reqs.append(r)
        self.pending[0] += len(requests)
        super().submit(requests, t0=t0)

    @property
    def runnable(self) -> bool:
        return any(self.pending)

    @property
    def active(self) -> bool:
        return any(self.pending)

    def sweep(self) -> None:
        for i, st in enumerate(self.streams):
            if self.pending[i]:
                for q, defer_h, votes, truncated, winner in self._verdicts(i, st.step() if self.here[i] else []):
                    r = self.reqs[q]
                    r.truncated = truncated
                    self.pending[i] -= 1
                    if defer_h and i < len(self.streams) - 1:
                        self.pending[i + 1] += 1
                    self._route(i, r, defer_h, votes / self.members[i], winner)

    def _gathered(self, i: int, done) -> list:
        """Every member's generations of tier i's completed slots, on the
        ranks of the slice's first rank's 'pod' line (one gather over 'pod'
        for the whole step); the rank's own members' elsewhere."""
        gens = [gen for _, gen in done]
        pod, split = self.pods[i]
        coord = self.meshes[i].get_coordinate()
        if not (split and done and all(c == 0 for j, c in enumerate(coord) if j != pod)):
            return gens
        widths = np.cumsum([g.shape[1] for g in gens])
        flat = np.concatenate(gens + [np.zeros((gens[0].shape[0], 1), np.int32)], 1)  # never empty
        full = collectives.all_gather_rows(torch.from_numpy(np.ascontiguousarray(flat, np.int32)),
                                           self.tiers[i].member_group).numpy()
        return np.split(full[:, :-1], widths[:-1], axis=1)

    def _verdicts(self, i: int, done) -> list:
        """Tier i's step's verdicts on every rank of the world, in the
        order its slots completed: (request index, defer, votes, truncated,
        winning generation) a completion."""
        src = first_rank(self.meshes[i])
        header = body = None
        if self.here[i]:
            gens = self._gathered(i, done)
            if dist.get_rank() == src:
                rows = []
                for (r, _), gen in zip(done, gens):
                    defer_h, votes, winner = self._vote(i, gen)
                    rows += [self.seq[id(r)], int(defer_h), votes, int(r.truncated), len(winner), *winner.tolist()]
                body = torch.tensor(rows, dtype=torch.int32)
                header = torch.tensor([len(done), len(rows), len(self.streams[i].queue)], dtype=torch.int32)
        n, size, depth = (int(x) for x in collectives.broadcast(header, src, (3,), torch.int32, self.device))
        if not self.here[i]:
            self.streams[i].sync_queue(depth)
        if n == 0:
            return []
        flat = collectives.broadcast(body, src, (size,), torch.int32, self.device).numpy()
        out, at = [], 0
        for _ in range(n):
            q, defer_h, votes, truncated, T = (int(x) for x in flat[at:at + 5])
            out.append((q, bool(defer_h), votes, bool(truncated), flat[at + 5:at + 5 + T].copy()))
            at += 5 + T
        return out

    def _send_deferral(self, i: int, link, r: Request, draft: Optional[np.ndarray]) -> None:
        """The re-queue over a mesh boundary: the prompt (and the draft), a
        leading axis of one example, sent from slice i's first rank, every
        other rank passing meta tensors of its shapes; the ranks of slice
        i + 1 take it whole and submit the request, the others count it."""
        tr = self.tr
        hosts = self.hosts
        leaves = {"tokens": np.asarray(r.tokens, np.int32)}
        if draft is not None:
            leaves["draft"] = draft  # rides the same metered hop
        src = dist.get_rank() == link.src_rank
        payload = {k: torch.from_numpy(v)[None] if src else torch.empty((1, v.size), dtype=torch.int32, device="meta")
                   for k, v in leaves.items()}
        if tr.enabled:
            tr.begin(r.rid, "hop", src=hosts[i], dst=hosts[i + 1],
                     n_bytes=int(sum(v.nbytes for v in leaves.values())))
        delivered = link.send_async(hosts[i], hosts[i + 1], payload, n_examples=1).result()
        if self.here[i + 1]:
            r.tokens = _host_int32(collectives.materialize(delivered["tokens"]))[0]
            r.draft = _host_int32(collectives.materialize(delivered["draft"]))[0] if "draft" in delivered else None
        if tr.enabled:
            hop = link.hops[-1]
            tr.end(r.rid, "hop", link_s=float(hop.latency), blocked_s=0.0, hidden_s=float(hop.latency))
        self.streams[i + 1].submit([r])


def _pod_split(placed, mesh):
    """(index of 'pod' among ``mesh``'s dims or None, True when a tier's
    placed values split its members over 'pod')."""
    from torch.distributed.tensor import Shard

    names = list(mesh.mesh_dim_names)
    pod = names.index("pod") if "pod" in names else None
    split = pod is not None and mesh.mesh.shape[pod] > 1 and isinstance(
        api._anchor(placed).placements[pod], Shard)
    return pod, split


def _placed_tier(tier: CascadeTier, placed, host) -> CascadeTier:
    """The tier a rank serves under a mesh placement: its own members
    (``placed``' local blocks) on a rank of ``host``'s slice, meta tensors
    of their shapes elsewhere.  Where the slice splits the members over
    'pod', the rank's tier has ``k`` = its share of ``spec.k``, the stacked
    index of its first member as ``member_offset`` and its 'pod' group as
    ``member_group``."""
    mesh = host.mesh
    if mesh.get_coordinate() is None:
        local = tree_map(lambda t: t.to_local().new_empty(t.shape, device="meta"), placed)
        return dataclasses.replace(tier, values=local)
    local = tree_map(lambda t: t.to_local(), placed)
    _, split = _pod_split(placed, mesh)
    if not split:
        return dataclasses.replace(tier, values=local)
    anchor = api._anchor(placed)
    block = collectives.block_of(mesh, anchor.placements, mesh.get_coordinate())
    return dataclasses.replace(tier, values=local, member_offset=block * anchor.to_local().shape[0],
                               member_group=mesh.get_group("pod"))


def _row_ids(toks, mesh, pod) -> np.ndarray:
    """The indices, in the fed chunk, of the rows a rank of ``mesh``
    computes on: its block of ``toks`` (a plain tensor: every row), or with
    ``pod`` (the rows gathered over 'pod') the blocks of its 'pod' peers in
    the group's order.  They key the rows' sampling draws."""
    from torch.distributed.tensor import DTensor

    if not isinstance(toks, DTensor):
        return np.arange(toks.shape[0], dtype=np.int64)
    b = toks.to_local().shape[0]
    coord = list(mesh.get_coordinate())
    coords = [coord] if pod is None else [coord[:pod] + [p] + coord[pod + 1:] for p in range(mesh.mesh.shape[pod])]
    blocks = [collectives.block_of(mesh, toks.placements, c) for c in coords]
    return np.concatenate([np.arange(k * b, (k + 1) * b, dtype=np.int64) for k in blocks])


def _host_int32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.int32)


class CascadeServer:
    """The ABC serving runtime: a tier list and an optional
    ``TierPlacement``."""

    def __init__(self, tiers: Sequence[CascadeTier], *, pad_to: int = 8, device=None, placement=None):
        """``placement`` (``serve/placement.py``) pins each tier to a host
        and makes every cross-host deferral a metered ``Transport`` hop.
        Each tier must live on the server's device, where every host
        computes (a simulated host, and a mesh host's rank): the tiers are
        used as they are, so a
        placed server replays the graphs an unplaced one over the same tiers
        captured.  Each link is bound to land its payloads on the device of
        the tier it feeds.

        A mesh placement (``pod_placement``) runs the server on every rank
        of the world, ``device`` the rank's (``device.rank_device``), with
        the same tiers on every rank: a tier's values whole on the ranks of
        its slice, meta tensors (or whole) elsewhere.  Each tier's values
        are put on its slice (``place_tier_values``, kept in
        ``placed_values``); on a rank of slice i, tier i becomes a copy of
        the given tier over this rank's members, and on any other rank a
        copy over meta tensors, never computed.  All four modes run over
        it, every rank calling them with the same inputs: ``classify`` and
        ``generate`` run tier i's programs, eager or graphed, on slice i's
        ranks and route through ``cascade_apply_routed(meshes=)``;
        ``serve_continuous`` and ``serve_open_loop`` step tier i's slot
        stream on slice i's ranks (``_MeshRun``).  Where slice i splits
        its members over 'pod', a rank's tier i holds ``k`` members, its
        share of ``spec.k``; the vote gathers every member's answers over
        'pod' first, and ``spec.k`` stays the whole ensemble's count."""
        self.device = resolve_device(device)
        self.tiers = list(tiers)
        self.placement = placement
        self.placed_values = None
        hosts = [None] * len(self.tiers)
        if placement is not None:
            assert placement.n_tiers == len(self.tiers), (placement.n_tiers, len(self.tiers))
            hosts = placement.hosts
        meshes = [h is not None and h.mesh is not None for h in hosts]
        if any(meshes) and not all(meshes):
            raise ValueError("a mesh placement puts every tier on a mesh")
        if all(meshes) and hosts:
            self.placed_values = [place_tier_values(t.values, h) for t, h in zip(self.tiers, hosts)]
            self.tiers = [_placed_tier(t, v, h) for t, v, h in zip(self.tiers, self.placed_values, hosts)]
        for t in self.tiers:
            if t.device != self.device:
                raise ValueError(f"tier {t.spec.name} lives on {t.device}, the server on {self.device}")
        if placement is not None:
            for link, dst in zip(placement.links, self.tiers[1:]):
                if link is not None:
                    link.bind(dst.device)
        self.pad_to = pad_to

    def _placed_fn(self, i: int, per_rows):
        """Tier i's answers on a rank of its slice, for every member, on the
        rows the rank was fed.  ``per_rows(tier, local, rows)`` computes this
        rank's members' answers (E_local, b, ...) on ``local``, the rows at
        ``rows`` of the fed chunk.  Where the members are split over 'pod'
        the rank first gathers its 'pod' peers' rows (when the rows are
        split over 'pod' too), then gathers every member's answers over
        'pod' and keeps its own block of rows."""
        from torch.distributed.tensor import DTensor, Shard

        tier, mesh = self.tiers[i], self.placement.hosts[i].mesh
        pod, split = _pod_split(self.placed_values[i], mesh)

        def fn(batch):
            group = mesh.get_group("pod") if split else None
            toks = batch["tokens"]
            rows = isinstance(toks, DTensor) and split and isinstance(toks.placements[pod], Shard)
            local = toks.to_local() if isinstance(toks, DTensor) else toks
            ids = _row_ids(toks, mesh, pod if rows else None)
            if rows:
                # the members split over 'pod' need the rows of every
                # 'pod' peer: gather them, keep this rank's block after
                local = collectives.all_gather_rows(local, group)
            out = per_rows(tier, local.to(tier.device), ids)
            if split:
                out = collectives.all_gather_rows(out, group)
            if rows:
                b = out.shape[1] // mesh.mesh.shape[pod]
                c = mesh.get_coordinate()[pod]
                out = out[:, c * b:(c + 1) * b]
            return out

        return fn

    def _run(self, cfg: ServeConfig, ob: Observability, eager: bool) -> _CascadeRun:
        return (_CascadeRun if self.placed_values is None else _MeshRun)(self, cfg, ob, eager)

    def _hop_transports(self):
        """Per-boundary transports from the placement (None: no metering)."""
        return None if self.placement is None else list(self.placement.links)

    def _host_names(self):
        """Per-tier host names for the hop metering (None: unplaced)."""
        return None if self.placement is None else [h.name for h in self.placement.hosts]

    def classify(self, tokens: np.ndarray, *, eager: bool = False) -> CascadeResult:
        """tokens (B, S) -> CascadeResult with per-tier routing stats.  Each
        tier's logits are one captured program a bucket (``eager``: the
        oracle route)."""

        def tier_fn(tier: CascadeTier):
            def fn(batch):
                return tier.last_logits(batch["tokens"], eager=eager)

            return fn

        meshes = None
        fns = [tier_fn(t) for t in self.tiers]
        if self.placed_values is not None:
            meshes = [h.mesh for h in self.placement.hosts]
            fns = [self._placed_fn(i, lambda tier, local, rows: tier.last_logits(local, eager=eager))
                   for i in range(len(self.tiers))]
        return cascade_apply_routed(
            fns, [t.spec for t in self.tiers],
            {"tokens": tokens}, pad_to=self.pad_to, device=self.device,
            transport=self._hop_transports(), hosts=self._host_names(), meshes=meshes,
        )

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 8, seed: int = 0, *,
                 eager: bool = False) -> CascadeResult:
        """Each tier's members generate (``CascadeTier.generate``: greedy or
        sampled under ``seed``, graphed unless ``eager``); answers are
        digested to stable ids and vote-compared.

        Over a mesh placement a rank of slice i generates its members on
        the rows it holds (its 'pod' peers' rows too where members and rows
        are both split over 'pod'), each row keyed by its index in the fed
        chunk and each member by its stacked index, so the draws are the
        unplaced server's; the (E_local, b) digests are gathered over 'pod'
        into every member's, and ``cascade_apply_routed(meshes=)`` routes
        them as it routes classify's logits."""

        def digests(tier, toks, rows=None):
            out = tier.generate(host_fetch(toks), max_new_tokens, seed=seed, eager=eager, rows=rows)
            return torch.as_tensor(digest_generations(out), device=tier.device)

        meshes = None
        fns = [lambda batch, tier=t: digests(tier, batch["tokens"]) for t in self.tiers]
        if self.placed_values is not None:
            meshes = [h.mesh for h in self.placement.hosts]
            fns = [self._placed_fn(i, digests) for i in range(len(self.tiers))]
        specs = [dataclasses.replace(t.spec, rule="vote_preds") for t in self.tiers]
        return cascade_apply_routed(
            fns, specs, {"tokens": tokens}, pad_to=self.pad_to, device=self.device,
            transport=self._hop_transports(), hosts=self._host_names(), meshes=meshes,
        )

    def serve_continuous(self, requests: Sequence[Request], config: ServeConfig = ServeConfig(), *,
                         eager: bool = False) -> List[Request]:
        """Continuous-batching generate mode: every tier runs a
        ``SlotStream`` over its stacked-ensemble programs (block-paged
        pools and chunked-prefill admission by default); streams are
        stepped round-robin, so a request deferred by tier i is admitted
        into a freed tier-(i+1) slot while tier i still decodes.  A
        completed slot votes over its member generations (Eq. 3 on stable
        digests): agreement -> the request exits with the majority answer
        and ``r.tier`` set; disagreement -> it is re-queued, prompt intact,
        on the next tier.  Per-tier stream counters land in
        ``last_stream_stats``.  With ``config.speculative`` a deferral
        carries the tier's plurality generation as the next tier's draft
        (``serve/speculative.py``): the tokens are the plain run's, in fewer
        decode steps.  Each tier's decode step, chunk buckets and verify
        buckets are captured once per slot geometry and replayed after;
        ``eager=True`` runs them eagerly, the oracle of the graphed path and
        nothing else.

        With a placement, a cross-host re-queue is a ``send_async`` on the
        boundary's link: the hop joins tier i+1's in-flight queue and the
        loop steps every runnable stream meanwhile, blocking on the oldest
        hop only when no stream has runnable work.  Returns completed
        requests."""
        cfg = config.with_max_seq_default(256)
        for r in requests:
            assert len(r.tokens) + r.max_new_tokens <= cfg.max_seq, (
                f"request {r.rid}: prompt+budget {len(r.tokens)}+{r.max_new_tokens} "
                f"exceeds max_seq={cfg.max_seq}"
            )
        run = self._run(cfg, cfg.resolved_obs(), eager)
        run.submit(requests)
        while run.active:
            if not run.runnable:
                run.block_on_inflight()
                continue
            run.sweep()
        self.last_stream_stats = [dict(st.stats) for st in run.streams]
        return run.done

    def serve_open_loop(self, workload: Workload, config: ServeConfig = ServeConfig(), *, slo_s: float = 1.0,
                        controller=None, step_time_s: float = 0.01) -> OpenLoopReport:
        """Open-loop serving: requests enter at the workload's arrival
        times, not as an up-front list, so queues build under bursts, and
        the report scores SLO attainment (``goodput``).

        The run is in virtual time: ``config.obs.clock`` must be advanceable
        (``serve.workload.VirtualClock``; one is made when ``config.obs`` is
        None), and the loop advances it by ``step_time_s`` a round-robin
        sweep (the modelled service time of one decode step across the
        tiers) and across idle gaps to the next arrival, so identical
        (workload, config, controller) inputs replay bit for bit.

        ``controller`` (``serve.controller.GreedyController``, optional) is
        bound to the run and ticked on its own interval; it may lower
        per-tier deferral thresholds, cap per-tier slot admission and shed
        arrivals under overload.  Shed requests come back in
        ``report.shed`` with ``r.shed=True``: ``offered == len(completed) +
        len(shed)`` is asserted.  The slot programs are
        ``serve_continuous``'s (``set_slot_limit`` changes no shape), so an
        open-loop run after a closed-loop run of the same geometry captures
        nothing."""
        cfg = config.with_max_seq_default(256)
        assert slo_s > 0 and step_time_s > 0, (slo_s, step_time_s)
        ob = cfg.obs if cfg.obs is not None else Observability(clock=VirtualClock())
        assert hasattr(ob.clock, "advance"), (
            "serve_open_loop runs in virtual time: obs.clock must be advanceable "
            f"(serve.workload.VirtualClock), got {type(ob.clock).__name__}"
        )
        vt = ob.clock
        arrivals = list(workload)  # fresh Request objects, arrival order
        for _, r in arrivals:
            assert len(r.tokens) + r.max_new_tokens <= cfg.max_seq, (
                f"request {r.rid}: prompt+budget {len(r.tokens)}+{r.max_new_tokens} "
                f"exceeds max_seq={cfg.max_seq}"
            )
        run = self._run(cfg, ob, eager=False)
        sc = ob.scope("serve.open_loop")
        c_offered, c_shed = sc.counter("offered"), sc.counter("shed")
        c_completed, c_in_slo = sc.counter("completed"), sc.counter("completed_in_slo")
        if controller is not None:
            controller.bind(run, slo_s=slo_s)
        shed: List[Request] = []
        n_in_slo = 0
        n_seen = 0  # run.done prefix already scored against the SLO
        idx = 0
        next_tick = controller.config.interval_s if controller is not None else float("inf")
        while idx < len(arrivals) or run.active:
            # admit everything that has arrived by virtual now; shedding
            # happens here, before the request touches a stream
            while idx < len(arrivals) and arrivals[idx][0] <= vt.now_s + 1e-12:
                t_arrive, r = arrivals[idx]
                idx += 1
                c_offered.add(1)
                if controller is not None and controller.should_shed():
                    r.shed = True
                    shed.append(r)
                    c_shed.add(1)
                    if run.tr.enabled:
                        run.tr.instant(r.rid, "complete", shed=True)
                    continue
                run.submit([r], t0=t_arrive)
            if run.runnable:
                run.sweep()
                # score completions at their completion time, before this
                # sweep's time charge moves the clock
                for r in run.done[n_seen:]:
                    c_completed.add(1)
                    if vt.now_s - run.t_start[r.rid] <= slo_s:
                        c_in_slo.add(1)
                        n_in_slo += 1
                n_seen = len(run.done)
                vt.advance(step_time_s)
            elif any(st.inflight for st in run.streams):
                run.block_on_inflight()
            elif idx < len(arrivals):
                # nothing runnable, nothing in flight: jump to the next arrival
                vt.advance(arrivals[idx][0] - vt.now_s)
            else:
                break
            if controller is not None and vt.now_s + 1e-12 >= next_tick:
                controller.tick(vt.now_s)
                next_tick = vt.now_s + controller.config.interval_s
        self.last_stream_stats = [dict(st.stats) for st in run.streams]
        assert len(run.done) + len(shed) == len(arrivals), (
            f"open-loop invariant violated: {len(arrivals)} offered != {len(run.done)} completed "
            f"+ {len(shed)} shed"
        )
        return OpenLoopReport(
            offered=len(arrivals), completed=run.done, shed=shed, completed_in_slo=n_in_slo,
            goodput=n_in_slo / max(1, len(arrivals)),
            p50_s=run.h_lat.percentile(0.50), p99_s=run.h_lat.percentile(0.99), makespan_s=vt.now_s,
            controller_actions=list(controller.actions) if controller is not None else [],
        )

    def tier_fractions(self, result: CascadeResult) -> np.ndarray:
        """(n_tiers,) fraction of examples answered by each tier."""
        return result.tier_counts / max(1, result.tier_counts.sum())

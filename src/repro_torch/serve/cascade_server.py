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

Sampling at ``temperature > 0`` is the counter-based Gumbel-max draw of
``serve/sampling.py``, inside the captured programs: batch generation keys
row b on ``(seed, b)`` and the fed token's position, continuous batching
keys each slot on ``(ServeConfig.seed + tier index, admission sequence)``.
JAX's PRNG cannot be reproduced, so sampled tokens are held to the port's
own invariants (paged == dense, graphed == eager, slot reuse, n_slots),
and greedy ones to the JAX package's tokens.

Not ported yet: placement and transports, the speculative
(cascade-as-drafter) path and ``serve_open_loop``.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from types import SimpleNamespace
from typing import List, Sequence

import numpy as np
import torch

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
from repro_torch.serve.slot_stream import SlotStream, TierBackend


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


@functools.lru_cache(maxsize=None)
def tier_programs(cfg: ModelConfig, temperature: float) -> SimpleNamespace:
    """The programs of one tier, with the JAX package's key inputs:

    ``last_logits(values, batch) -> (E, B, V)``
    ``prefill(values, batch, rng, *, cache=None) -> (tok (E, B, 1), caches)``
    ``decode(values, tok, caches, pos, rng) -> (tok, caches)``
    ``decode_slots(values, tok, caches, pos, slot_keys) -> (tok, caches)``
        (per-slot (B,) ``pos``, continuous batching over the dense slot
        cache)
    ``prefill_chunk(values, caches, tokens, slot, start) -> caches``
    ``reset_slot(caches, slot) -> caches`` (zero every member's recurrent
        state in the slot; None for the dense family, which has none).

    ``rng`` and ``slot_keys`` are (B,) int64 keys (``serve/sampling.py``):
    a token is sampled from (key, position of the token whose logits pick
    it, member), the argmax at ``temperature`` 0.  ``pos`` is an int or a
    (B,) device tensor (a captured step's); ``prefill`` draws at S - 1 and
    writes into ``cache`` when one is given (``api.prefill_members``).

    Each is a ``Program`` keyed ``"<cfg.name>@T<temperature>/ens_<name>"``,
    the JAX package's keys; a tier captures ``last_logits``, ``prefill``
    and ``decode`` per batch bucket and ``decode_slots`` and
    ``prefill_chunk`` per slot geometry (``serve/graphs.py``)."""
    key = f"{cfg.name}@T{temperature:g}"

    def _tokens(logits, keys, pos):
        return sampling.sample(logits, keys, pos, temperature)[..., None]

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

    return SimpleNamespace(
        last_logits=Program(f"{key}/ens_last_logits", last_logits),
        prefill=Program(f"{key}/ens_prefill", prefill),
        decode=Program(f"{key}/ens_decode", decode),
        decode_slots=Program(f"{key}/ens_decode_slots", decode),
        prefill_chunk=(
            Program(f"{key}/ens_prefill_chunk", prefill_chunk) if api.supports_chunked_prefill(cfg) else None
        ),
        reset_slot=(
            Program(f"{key}/ens_slot_reset", functools.partial(api.reset_slot_members, cfg=cfg))
            if api.has_slot_state(cfg) else None
        ),
    )


@functools.lru_cache(maxsize=None)
def tier_paged_programs(cfg: ModelConfig, temperature: float) -> SimpleNamespace:
    """Block-paged counterparts of the continuous-mode programs: E pool
    planes advance under ONE shared (n_slots, n_pg) page table, with the
    per-slot admission keys for sampling:
    ``decode_slots(values, tok, pools, pos, pages, slot_keys)``."""
    assert api.supports_paging(cfg), cfg.family
    key = f"{cfg.name}@T{temperature:g}"

    def decode_slots(values, tok, pools, pos, pages, slot_keys):
        logits, pools = ens.ensemble_decode_step_paged(values, tok, pools, pos, pages, cfg)
        return sampling.sample(logits, slot_keys, pos, temperature)[..., None], pools

    def prefill_chunk(values, pools, tokens, pages_row, start):
        return ens.ensemble_prefill_into_slot_paged(values, tokens, pools, pages_row, start, cfg)

    return SimpleNamespace(
        decode_slots=Program(f"{key}/ens_decode_paged", decode_slots),
        prefill_chunk=Program(f"{key}/ens_prefill_chunk_paged", prefill_chunk),
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
    from ``graph_pool``."""

    cfg: ModelConfig
    values: dict
    spec: TierSpec
    temperature: float = 0.0
    device: object = None
    graph_pool: GraphPool = dataclasses.field(default_factory=GraphPool, init=False, repr=False, compare=False)
    slot_memory: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.values = tree_map(lambda t: t.to(self.device), self.values)
        self.graphs = GraphSet(self.device, self.graph_pool, BATCH_BUCKETS)
        self.k = ens.member_count(self.values)
        programs = tier_programs(self.cfg, float(self.temperature))
        self._last_logits = programs.last_logits
        self._prefill = programs.prefill
        self._decode = programs.decode
        self._decode_slots = programs.decode_slots
        self._prefill_chunk = programs.prefill_chunk
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
                 eager: bool = False) -> np.ndarray:
        """Ensemble generation, greedy or sampled (``temperature``) under
        ``seed``: tokens (B, S) -> (E, B, max_new).  The prefill writes into
        the tier's static cache of (B, S + max_new) rows and the decode step
        runs over it at a (B,) device position, each captured once a (B, S,
        max_new) and replayed after; ``eager`` runs the oracle (a fresh
        cache grown by ``grow_cache``, scalar positions)."""
        assert max_new_tokens >= 1, max_new_tokens
        B, S = tokens.shape
        keys = sampling.batch_keys(seed, B)
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


class _CascadeRun:
    """One ``serve_continuous`` run's machinery: per-tier ``SlotStream``s
    over ``TierBackend``s, the vote / defer / complete routing and the
    telemetry scopes."""

    def __init__(self, server: "CascadeServer", cfg: ServeConfig, ob: Observability, eager: bool):
        self.tiers = server.tiers
        self.device = server.device
        self.ob = ob
        self.tr = ob.tracer
        self.clk = ob.clock
        self.h_lat = ob.registry.histogram("serve.request_latency_s")
        tier_sc = [ob.scope(f"cascade.tier{i}") for i in range(len(self.tiers))]
        self.c_answered = [sc.counter("answered") for sc in tier_sc]
        self.c_deferred = [sc.counter("deferred") for sc in tier_sc]
        self.c_tokens = [sc.counter("output_tokens") for sc in tier_sc]
        self.h_margin = [sc.histogram("agreement_margin", buckets=UNIT_BUCKETS) for sc in tier_sc]
        self.streams = [
            SlotStream(
                TierBackend(
                    t, n_slots=cfg.n_slots, max_seq=cfg.max_seq, seed=cfg.seed + i, paged=cfg.paged,
                    page_size=cfg.page_size, n_pages=cfg.n_pages,
                    obs=ob, pool_name=f"paging.tier{i}", eager=eager,
                ),
                dataclasses.replace(cfg, obs=ob),
                name=f"slot_stream.tier{i}",
            )
            for i, t in enumerate(self.tiers)
        ]
        self.t_start: dict = {}
        self.done: List[Request] = []

    def submit(self, requests: Sequence[Request]) -> None:
        """Enqueue onto tier 0."""
        for r in requests:
            self.t_start[r.rid] = self.clk()
        self.streams[0].submit(requests)

    @property
    def active(self) -> bool:
        return any(st.active for st in self.streams)

    def sweep(self) -> None:
        """One round-robin pass: step every stream once, routing each
        completed slot through its tier's vote.  Deferred re-queues land on
        tier i+1 before its step in the same sweep."""
        for i, st in enumerate(self.streams):
            for r, gen in st.step():
                self._finish_slot(i, r, gen)

    def _finish_slot(self, i: int, r: Request, gen: np.ndarray) -> None:
        tier = self.tiers[i]
        tr = self.tr
        digests = np.asarray([stable_digest(gen[e]) for e in range(tier.k)], np.int32)
        out = deferral.vote_rule_from_preds(
            torch.as_tensor(digests[:, None], device=self.device), tier.spec.theta
        )
        # one metered fetch per completed slot: the vote verdict and the
        # winning digest
        defer_h, pred_h = host_fetch((out.defer[0], out.pred[0]))
        defer = bool(defer_h) and i < len(self.streams) - 1
        # agreement margin: the winning digest's vote share (1.0 = unanimous)
        margin = float(np.unique(digests, return_counts=True)[1].max()) / tier.k
        self.h_margin[i].record(margin)
        if tr.enabled:
            tr.instant(r.rid, "defer_vote", tier=i, margin=margin, defer=bool(defer_h))
        if defer:
            self.c_deferred[i].add(1)
            self.streams[i + 1].submit([r])
            return
        self.c_answered[i].add(1)
        self.c_tokens[i].add(int(gen.shape[1]))
        winner = int(np.argmax(digests == pred_h))
        r.output = gen[winner].astype(np.int32)
        r.tier = i
        self.h_lat.record(self.clk() - self.t_start[r.rid])
        if tr.enabled:
            tr.instant(r.rid, "complete", tier=i)
        self.done.append(r)


class CascadeServer:
    """The ABC serving runtime over a tier list on one device."""

    def __init__(self, tiers: Sequence[CascadeTier], *, pad_to: int = 8, device=None):
        self.device = resolve_device(device)
        self.tiers = list(tiers)
        for t in self.tiers:
            if t.device != self.device:
                raise ValueError(f"tier {t.spec.name} lives on {t.device}, server on {self.device}")
        self.pad_to = pad_to

    def classify(self, tokens: np.ndarray, *, eager: bool = False) -> CascadeResult:
        """tokens (B, S) -> CascadeResult with per-tier routing stats.  Each
        tier's logits are one captured program a bucket (``eager``: the
        oracle route)."""

        def tier_fn(tier: CascadeTier):
            def fn(batch):
                return tier.last_logits(batch["tokens"], eager=eager)

            return fn

        return cascade_apply_routed(
            [tier_fn(t) for t in self.tiers], [t.spec for t in self.tiers],
            {"tokens": tokens}, pad_to=self.pad_to, device=self.device,
        )

    def generate(self, tokens: np.ndarray, max_new_tokens: int = 8, seed: int = 0, *,
                 eager: bool = False) -> CascadeResult:
        """Each tier's members generate (``CascadeTier.generate``: greedy or
        sampled under ``seed``, graphed unless ``eager``); answers are
        digested to stable ids and vote-compared."""

        def tier_fn(tier: CascadeTier):
            def fn(batch):
                toks = host_fetch(batch["tokens"])
                out = tier.generate(toks, max_new_tokens, seed=seed, eager=eager)
                return torch.as_tensor(digest_generations(out), device=self.device)

            return fn

        specs = [dataclasses.replace(t.spec, rule="vote_preds") for t in self.tiers]
        return cascade_apply_routed(
            [tier_fn(t) for t in self.tiers], specs, {"tokens": tokens},
            pad_to=self.pad_to, device=self.device,
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
        ``last_stream_stats``.  Each tier's decode step and chunk buckets
        are captured once per slot geometry and replayed after;
        ``eager=True`` runs them eagerly, the oracle of the graphed path and
        nothing else.  Returns completed requests."""
        cfg = config.with_max_seq_default(256)
        for r in requests:
            assert len(r.tokens) + r.max_new_tokens <= cfg.max_seq, (
                f"request {r.rid}: prompt+budget {len(r.tokens)}+{r.max_new_tokens} "
                f"exceeds max_seq={cfg.max_seq}"
            )
        run = _CascadeRun(self, cfg, cfg.resolved_obs(), eager)
        run.submit(requests)
        while run.active:
            run.sweep()
        self.last_stream_stats = [dict(st.stats) for st in run.streams]
        return run.done

    def tier_fractions(self, result: CascadeResult) -> np.ndarray:
        """(n_tiers,) fraction of examples answered by each tier."""
        return result.tier_counts / max(1, result.tier_counts.sum())

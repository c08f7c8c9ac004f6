"""Continuous batching in the port against the JAX package, on the same
bridged float32 weights and the same numpy prompts: ``SlotStream`` over
block-paged pools and over the dense slot cache (E = 1 through
``ServingEngine.slot_stream``, E = 3 through ``TierBackend``), the pool
wall, ``ServingEngine.serve_continuous`` and
``CascadeServer.serve_continuous``.  Requests are matched by submission
order (the two packages number them apart).

Discrete outputs must be equal: greedy tokens, answering tier,
``truncated`` flags, stream and pool counters, metered host fetches.
Inside the port, paged and dense serving, and chunked and decode-only
admission, emit bitwise the same tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cascade as j_cascade
from repro.core.cascade import TierSpec as JTierSpec
from repro.obs import Histogram as JHistogram
from repro.serve import CascadeTier as JTier
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.serve import SlotStream as JSlotStream
from repro.serve import TierBackend as JTierBackend
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import cascade as t_cascade
from repro_torch.core.cascade import TierSpec
from repro_torch.obs import Histogram, Observability, Tracer, validate_trace
from repro_torch.serve import (
    CascadeTier,
    Request,
    ServeConfig,
    ServingEngine,
    SlotStream,
    TierBackend,
)
from test_torch_cascade import BIG, SMALL, build, numpy_values

CFG = dataclasses.replace(SMALL, dtype="float32")
TCFG = ModelConfig(**dataclasses.asdict(CFG))
# counters a run must reproduce exactly (the stats' *_time keys are host
# wall clock)
STREAM_KEYS = ("admitted", "admit_failures", "forced_completions", "chunk_calls",
               "chunk_tokens", "shared_tokens", "decode_tokens")


@pytest.fixture(scope="module")
def stack():
    return numpy_values(CFG, 40, k=3)


def _prompts(seed, n, *, lo=4, hi=20, max_new=(2, 5)):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, 64, int(rng.integers(lo, hi))).astype(np.int32), int(rng.integers(*max_new)))
        for _ in range(n)
    ]


def _prefix_prompts(seed, n, prefix_len, *, tail_hi=12, max_new=(2, 5)):
    """Ragged prompts all sharing one ``prefix_len``-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 64, prefix_len).astype(np.int32)
    out = []
    for _ in range(n):
        tail = rng.integers(0, 64, int(rng.integers(1, tail_hi))).astype(np.int32)
        out.append((np.concatenate([prefix, tail]), int(rng.integers(*max_new))))
    return out


def _member(stack, i=0):
    return {k: _member(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def _jax_stream(stack, E, config):
    if E == 1:
        return JEngine(CFG, jax.tree.map(jnp.asarray, _member(stack)), max_seq=64).slot_stream(config)
    tier = JTier(CFG, jax.tree.map(jnp.asarray, stack), JTierSpec("t", "vote", 0.67, k=3))
    backend = JTierBackend(tier, n_slots=config.n_slots, max_seq=64, paged=config.paged,
                           page_size=config.page_size, n_pages=config.n_pages)
    return JSlotStream(backend, config)


def _port_stream(stack, E, config):
    if E == 1:
        vals = params_from_numpy(_member(stack), TCFG, device="cpu")
        return ServingEngine(TCFG, vals, max_seq=64, device="cpu").slot_stream(config)
    tier = CascadeTier(TCFG, params_from_numpy(stack, TCFG, device="cpu"), TierSpec("t", "vote", 0.67, k=3),
                       device="cpu")
    backend = TierBackend(tier, n_slots=config.n_slots, max_seq=64, paged=config.paged,
                          page_size=config.page_size, n_pages=config.n_pages)
    return SlotStream(backend, config)


def _drain_both(stack, E, prompts, j_config, t_config):
    """Drain the same prompts through a JAX stream and a port stream;
    returns (jax stream, port stream, [(jax gen, port gen, jax req, port
    req)] in submission order)."""
    js, ts = _jax_stream(stack, E, j_config), _port_stream(stack, E, t_config)
    jr = [JRequest(tokens=t.copy(), max_new_tokens=m) for t, m in prompts]
    tr = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in prompts]
    js.submit(jr)
    ts.submit(tr)
    jd = {r.rid: g for r, g in js.drain()}
    td = {r.rid: g for r, g in ts.drain()}
    assert sorted(td) == sorted(r.rid for r in tr), "every request completes exactly once"
    return js, ts, [(jd[a.rid], td[b.rid], a, b) for a, b in zip(jr, tr)]


# ---------------------------------------------------------------------------
# paged serving == the dense oracle == the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E", [1, 3])
def test_paged_matches_dense_oracle(stack, E):
    """page_size 8, three ragged prompts plus four sharing a 17-token
    prefix (two full pages), 2 slots: tokens equal to the JAX package's in
    both memory modes, paged == dense bitwise in the port, equal sharing
    and peak pages, and every page back on the free list."""
    prompts = _prompts(50 + E, 3) + _prefix_prompts(60 + E, 4, 17)
    gens = {}
    for paged in (True, False):
        kw = dict(n_slots=2, max_seq=64, paged=paged, page_size=8)
        js, ts, pairs = _drain_both(stack, E, prompts, JServeConfig(**kw), ServeConfig(**kw))
        assert ts.backend.paged is paged
        for jg, tg, _, _ in pairs:
            np.testing.assert_array_equal(tg, jg)
        assert {k: ts.stats[k] for k in STREAM_KEYS} == {k: js.stats[k] for k in STREAM_KEYS}
        if paged:
            pool, jpool = ts.backend.pool, js.backend.pool
            assert dict(pool.stats) == dict(jpool.stats)
            assert pool.stats["shared_hits"] >= 2 and ts.stats["shared_tokens"] >= 16
            assert pool.pages_in_use == 0
            pool.assert_conserved()
        gens[paged] = [tg for _, tg, _, _ in pairs]
    for a, b in zip(gens[True], gens[False]):
        np.testing.assert_array_equal(a, b)


def test_paged_pool_wall_forces_completion(stack):
    """3 allocatable pages + the sink, two 9-token prompts of 40 new tokens:
    admission fails while a slot is free, growth fails mid-decode and both
    requests force-complete truncated — the same set, outputs and counters
    as the JAX package."""
    rng = np.random.default_rng(71)
    prompts = [(rng.integers(0, 64, 9).astype(np.int32), 40) for _ in range(2)]
    kw = dict(n_slots=2, max_seq=64, paged=True, page_size=8, n_pages=4)
    js, ts, pairs = _drain_both(stack, 1, prompts, JServeConfig(**kw), ServeConfig(**kw))
    for jg, tg, jr, tr in pairs:
        np.testing.assert_array_equal(tg, jg)
        assert tr.truncated and jr.truncated
    assert ts.stats["forced_completions"] == 2 and ts.stats["admit_failures"] >= 1
    assert {k: ts.stats[k] for k in STREAM_KEYS} == {k: js.stats[k] for k in STREAM_KEYS}
    assert ts.backend.pool.pages_in_use == 0
    ts.backend.pool.assert_conserved()


def test_pool_too_small_for_prompt_raises(stack):
    stream = _port_stream(stack, 1, ServeConfig(n_slots=1, max_seq=64, paged=True, page_size=8, n_pages=3))
    stream.submit([Request(tokens=np.arange(17, dtype=np.int32) % 64, max_new_tokens=2)])
    with pytest.raises(RuntimeError, match="pool"):
        stream.drain()


@pytest.mark.parametrize("paged", [True, False])
def test_chunked_matches_decode_only_admission(stack, paged):
    """Inside the port: bucketed chunked prefill (a 33-token prompt needs
    several pow2 buckets) emits the tokens token-by-token admission does."""
    vals = params_from_numpy(_member(stack), TCFG, device="cpu")
    eng = ServingEngine(TCFG, vals, max_seq=64, device="cpu")
    prompts = _prompts(7, 4, hi=16) + [(np.random.default_rng(8).integers(0, 64, 33).astype(np.int32), 4)]
    outs = {}
    for chunked in (True, False):
        reqs = [Request(tokens=t, max_new_tokens=m) for t, m in prompts]
        done = eng.serve_continuous(reqs, ServeConfig(n_slots=2, chunked_prefill=chunked, paged=paged, page_size=8))
        assert (eng.last_stream_stats["chunk_tokens"] >= 32) if chunked else eng.last_stream_stats["chunk_calls"] == 0
        assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
        outs[chunked] = [r.output for r in reqs]
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


def test_engine_serve_continuous_matches_jax_and_solo(stack):
    """The E=1 entry point: outputs, truncation and run deltas equal to the JAX
    engine's, and each output equal to that request's solo ``generate``;
    a 16-row cache wall truncates the long request in both."""
    member = _member(stack)
    jeng = JEngine(CFG, jax.tree.map(jnp.asarray, member), max_seq=16)
    teng = ServingEngine(TCFG, params_from_numpy(member, TCFG, device="cpu"), max_seq=16, device="cpu")
    prompts = _prompts(31, 4, lo=3, hi=8, max_new=(2, 4)) + [(np.arange(8, dtype=np.int32), 32)]
    jr = [JRequest(tokens=t, max_new_tokens=m) for t, m in prompts]
    tr = [Request(tokens=t, max_new_tokens=m) for t, m in prompts]
    jeng.serve_continuous(jr, JServeConfig(n_slots=2))
    teng.serve_continuous(tr, ServeConfig(n_slots=2))
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.output, a.output)
        assert a.truncated == b.truncated
    assert tr[-1].truncated and len(tr[-1].output) < 32
    assert {k: teng.last_stream_stats[k] for k in STREAM_KEYS} == {k: jeng.last_stream_stats[k] for k in STREAM_KEYS}
    assert teng.stats["decode_tokens"] == jeng.stats["decode_tokens"]
    for r in tr[:-1]:
        np.testing.assert_array_equal(teng.generate(r.tokens[None], r.max_new_tokens)[0], r.output)


def test_serve_pending_matches_jax(stack):
    """Queue-driven serving: left-padded pow2 batches with per-row starts."""
    member = _member(stack)
    jeng = JEngine(CFG, jax.tree.map(jnp.asarray, member))
    teng = ServingEngine(TCFG, params_from_numpy(member, TCFG, device="cpu"), device="cpu")
    prompts = _prompts(12, 5)
    for t, m in prompts:
        jeng.queue.submit(JRequest(tokens=t, max_new_tokens=m))
        teng.queue.submit(Request(tokens=t, max_new_tokens=m))
    for a, b in zip(jeng.serve_pending(), teng.serve_pending()):
        np.testing.assert_array_equal(b.output, a.output)


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta", [0.5, 0.0])
def test_cascade_serve_continuous_matches_jax(theta):
    """SMALL x 3 (digest vote) -> BIG x 1: the same answering tier, output
    and ``truncated`` per request, completion order, per-tier stream
    counters and metered host fetches as the JAX package."""
    j_server, t_server = build([(SMALL, 3, 6, "vote", theta, 1.0), (BIG, 1, 7, "confidence", -1.0, 25.0)])
    rng = np.random.default_rng(3)
    prompts = [(rng.integers(0, 64, int(rng.integers(3, 30))).astype(np.int32), int(rng.integers(1, 4)))
               for _ in range(10)]
    jr = [JRequest(tokens=t, max_new_tokens=m) for t, m in prompts]
    tr = [Request(tokens=t, max_new_tokens=m) for t, m in prompts]
    kw = dict(n_slots=3, max_seq=64, page_size=8)
    j_cascade.reset_host_fetch_stats()
    t_cascade.reset_host_fetch_stats()
    jd = j_server.serve_continuous(jr, JServeConfig(**kw))
    td = t_server.serve_continuous(tr, ServeConfig(**kw))
    assert t_cascade.host_fetch_stats() == j_cascade.host_fetch_stats()
    for a, b in zip(jr, tr):
        assert (b.tier, b.truncated) == (a.tier, a.truncated)
        np.testing.assert_array_equal(b.output, a.output)
    order = {id(r): i for i, r in enumerate(jr)}, {id(r): i for i, r in enumerate(tr)}
    assert [order[1][id(r)] for r in td] == [order[0][id(r)] for r in jd]
    for js, ts in zip(j_server.last_stream_stats, t_server.last_stream_stats):
        assert {k: ts[k] for k in STREAM_KEYS} == {k: js[k] for k in STREAM_KEYS}
    # theta 0: a 3-member vote never falls to 0, so tier 0 answers all;
    # theta 0.5: members that all disagree defer to tier 1
    tiers = {r.tier for r in tr}
    assert tiers == {0} if theta == 0.0 else 1 in tiers


def test_cascade_paged_matches_dense_and_traces():
    """Inside the port: the cascade's paged and dense runs emit the same
    tiers and tokens; a recording tracer's lifecycle validates, every
    request reaches ``complete``, and the pools end empty."""
    _, t_server = build([(SMALL, 3, 8, "vote", 0.0, 1.0), (BIG, 1, 9, "confidence", -1.0, 25.0)])
    prompts = _prompts(9, 6) + _prefix_prompts(10, 3, 17)
    outs = {}
    for paged in (True, False):
        ob = Observability(tracer=Tracer())
        reqs = [Request(tokens=t, max_new_tokens=m) for t, m in prompts]
        t_server.serve_continuous(reqs, ServeConfig(n_slots=2, max_seq=64, page_size=8, paged=paged, obs=ob))
        summary = validate_trace(ob.tracer.export())
        assert summary["tracks"] == len(reqs)
        outs[paged] = [(r.tier, r.output.tolist()) for r in reqs]
        if paged:
            for i in range(2):
                assert ob.registry.get(f"paging.tier{i}.pool_occupancy").value == 0
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# configuration surface and telemetry
# ---------------------------------------------------------------------------


def test_serve_config_resolution(stack):
    vals = params_from_numpy(_member(stack), TCFG, device="cpu")
    eng = ServingEngine(TCFG, vals, max_seq=64, device="cpu")
    stream = eng.slot_stream(ServeConfig(n_slots=3, page_size=8))
    assert stream.n_slots == 3 and stream.max_seq == 64
    assert stream.backend.pool.page_size == 8 and stream.backend.paged
    # speculative deferral is ported (tests/test_torch_speculative.py)
    assert ServeConfig(speculative=True).speculative and not ServeConfig().speculative
    # sampling is ported: the engine takes a temperature and the seed of its
    # generator, and ServeConfig carries the tiers' sampling seed again
    sampled = ServingEngine(TCFG, vals, temperature=0.7, seed=3, device="cpu")
    assert sampled.temperature == 0.7 and not sampled.greedy
    assert ServeConfig().seed == 0 and ServeConfig(seed=5).seed == 5


def test_no_gpu_engine_raises(stack, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(TCFG, params_from_numpy(_member(stack), TCFG, device="cpu"))


def test_histogram_matches_jax():
    rng = np.random.default_rng(13)
    xs = np.exp(rng.standard_normal(200) * 3 - 6)
    h, jh = Histogram("x"), JHistogram("x")
    for x in xs:
        h.record(float(x))
        jh.record(float(x))
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.percentile(q) == jh.percentile(q)
    assert (h.sum, h.count, h.counts) == (jh.sum, jh.count, jh.counts)

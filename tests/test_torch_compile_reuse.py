"""Compile-once serving in the port (``serve/graphs.py``), on the CPU path:
the serving scenarios of ``tests/test_compile_reuse.py`` with the port's
``trace_count`` (on the CPU a program of an engine or tier counts at its
first call, as a capture does on the card), runs over an owner's reused
pools and slot caches against runs on fresh ones, the tensor-addressed
chunk programs against the int-addressed code they replaced, and the
JAX package's tokens on the same weights.

Discrete outputs (tokens, tiers, ``truncated`` flags) and cache contents
must be bitwise equal."""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.cascade import TierSpec as JTierSpec
from repro.serve import CascadeServer as JServer
from repro.serve import CascadeTier as JTier
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import ensemble as t_ens
from repro_torch.core.cascade import TierSpec, prompt_chunks
from repro_torch.models import api as t_api
from repro_torch.models import blocks_dense as BD
from repro_torch.models import layers as L
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig, ServingEngine, TierBackend
from repro_torch.serve.cascade_server import tier_paged_programs
from repro_torch.serve.engine import model_programs, trace_count, trace_counts
from repro_torch.serve.graphs import GraphSet
from test_torch_recurrent_serving import CONFIGS as RECURRENT
from test_torch_recurrent_serving import _stack

_DENSE = dict(family="dense", n_layers=2, d_model=64, d_ff=128, vocab_size=64, n_heads=4, n_kv_heads=2,
              remat=False, dtype="float32")
FAMILIES = ["dense", "ssm_mamba2", "ssm_rwkv6", "hybrid"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny models: the suite runs several
    workers on the CPU at once, and idle threads of each spin against the
    others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(family, name):
    if family == "dense":
        return JModelConfig(name=name, **_DENSE)
    return dataclasses.replace(RECURRENT[family], name=name, dtype="float32")


def _tcfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def _engine(jcfg, seed, max_seq=64):
    """A port engine on the port's own seeded weights (the tests that
    compare with the JAX package use ``_jax_engine``)."""
    tcfg = _tcfg(jcfg)
    return ServingEngine(tcfg, t_api.init_params(tcfg, torch.Generator().manual_seed(seed), "cpu"),
                         max_seq=max_seq, device="cpu")


def _jax_engine(jcfg, seed, max_seq=64):
    """(port engine, JAX engine) on the same f32 weights."""
    member = jax.tree.map(lambda a: a[0], _stack(jcfg, seed, k=1))
    tcfg = _tcfg(jcfg)
    return (ServingEngine(tcfg, params_from_numpy(member, tcfg, device="cpu"), max_seq=max_seq, device="cpu"),
            JEngine(jcfg, jax.tree.map(jnp.asarray, member), max_seq=max_seq))


def _server(pairs):
    """pairs: [(jax cfg, k, seed, rule, theta)] -> a port server on the
    port's own seeded weights."""
    g = torch.Generator()
    return CascadeServer([
        CascadeTier(_tcfg(jcfg), t_ens.init_ensemble(_tcfg(jcfg), k, g.manual_seed(seed), "cpu"),
                    TierSpec(f"t{i}", rule, theta, k=k), device="cpu")
        for i, (jcfg, k, seed, rule, theta) in enumerate(pairs)
    ], device="cpu")


def _jax_server(pairs):
    """(JAX server, port server) on the same f32 weights."""
    j_tiers, t_tiers = [], []
    for i, (jcfg, k, seed, rule, theta) in enumerate(pairs):
        vals = _stack(jcfg, seed, k)
        j_tiers.append(JTier(jcfg, jax.tree.map(jnp.asarray, vals), JTierSpec(f"t{i}", rule, theta, k=k)))
        tcfg = _tcfg(jcfg)
        t_tiers.append(CascadeTier(tcfg, params_from_numpy(vals, tcfg, device="cpu"),
                                   TierSpec(f"t{i}", rule, theta, k=k), device="cpu"))
    return JServer(j_tiers), CascadeServer(t_tiers, device="cpu")


def _reqs(seed, n, *, lo=3, hi=24, max_new=(2, 5), cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(tokens=rng.integers(0, 64, int(rng.integers(lo, hi))).astype(np.int32),
                max_new_tokens=int(rng.integers(*max_new))) for _ in range(n)]


def _outputs(done, reqs):
    by = {r.rid: r for r in done}
    assert sorted(by) == sorted(r.rid for r in reqs), "every request completes exactly once"
    return [(by[r.rid].tier, by[r.rid].truncated, by[r.rid].output.tolist()) for r in reqs]


# ---------------------------------------------------------------------------
# tests/test_compile_reuse.py's serving scenarios
# ---------------------------------------------------------------------------


def test_engine_programs_shared_across_instances():
    """Two engines for one config share the function-level programs (the
    graphs and the device memory they run over are each engine's own)."""
    e1 = _engine(_jcfg("dense", "reuse-shared"), 2)
    e2 = _engine(_jcfg("dense", "reuse-shared"), 2)
    assert e1._prefill is e2._prefill and e1._decode is e2._decode
    assert e1._prefill is model_programs(e1.cfg).prefill
    assert e1._decode.key == "reuse-shared/decode"
    assert e1.slot_memory is not e2.slot_memory


@pytest.mark.parametrize("paged", [True, False])
def test_serve_continuous_no_rejit(paged):
    eng = _engine(_jcfg("dense", f"reuse-nr-{paged}"), 3)
    config = ServeConfig(n_slots=4, paged=paged, page_size=8)
    rng = np.random.default_rng(4)

    def reqs():
        return [Request(tokens=rng.integers(0, 64, 6).astype(np.int32), max_new_tokens=3) for _ in range(5)]

    before = trace_count()
    eng.serve_continuous(reqs(), config)  # warm-up
    assert trace_count() > before
    before = trace_counts()
    done = eng.serve_continuous(reqs(), config)
    assert len(done) == 5
    assert trace_counts() == before, "serve_continuous must reuse its decode program"


@pytest.mark.parametrize("paged", [True, False])
def test_serve_continuous_chunked_prefill_no_rejit(paged):
    """One new count per DISTINCT pow2 chunk length at the first run (a
    21-token prompt: chunks 16 and 4), no more than 5 for the config, and
    none at a second run with the same prompt lengths."""
    jcfg = _jcfg("dense", f"reuse-chunk-{paged}")
    eng = _engine(jcfg, 5)
    chunk_key = f"{jcfg.name}/prefill_chunk_paged" if paged else f"{jcfg.name}/prefill_chunk"

    def reqs():
        rr = np.random.default_rng(10)
        return [Request(tokens=rr.integers(0, 64, 21).astype(np.int32), max_new_tokens=3) for _ in range(5)]

    config = ServeConfig(n_slots=4, paged=paged, page_size=8)
    eng.serve_continuous(reqs(), config)  # warm-up: the bucket programs count
    stats = eng.last_stream_stats
    assert stats["chunk_calls"] > 0 and stats["chunk_tokens"] == 5 * 20
    assert trace_count(chunk_key) == len(set(prompt_chunks(20))) == 2
    assert trace_count(chunk_key) <= 5  # a subset of {1, 2, 4, 8, 16}
    before = trace_counts()
    assert len(eng.serve_continuous(reqs(), config)) == 5
    assert trace_counts() == before, "second chunked serve_continuous must not count anything"


@pytest.mark.parametrize("paged", [True, False])
def test_cascade_serve_continuous_no_rejit(paged):
    """A repeat cascade serve_continuous (a slot stream a tier, chunked
    admission, live deferral) counts nothing new."""
    server = _server([(_jcfg("dense", f"reuse-c1-{paged}"), 3, 6, "vote", 0.67),
                         (_jcfg("dense", f"reuse-c2-{paged}"), 1, 7, "confidence", -1.0)])
    config = ServeConfig(n_slots=3, max_seq=32, paged=paged, page_size=8)

    def reqs():
        prompts = np.random.default_rng(12).integers(0, 64, (6, 8)).astype(np.int32)
        return [Request(tokens=p.copy(), max_new_tokens=4) for p in prompts]

    first = _outputs(server.serve_continuous(r1 := reqs(), config), r1)
    assert all(st["admitted"] > 0 for st in server.last_stream_stats), "both tiers' streams must run"
    before = trace_counts()
    assert _outputs(server.serve_continuous(r2 := reqs(), config), r2) == first
    assert trace_counts() == before, "repeat cascade serve_continuous must not count anything"


# ---------------------------------------------------------------------------
# reused pools and slot caches == fresh ones
# ---------------------------------------------------------------------------

_MODES = [("dense", True), ("dense", False)] + [(f, False) for f in FAMILIES[1:]]


@pytest.mark.parametrize("family,paged", _MODES)
def test_reused_memory_matches_fresh_engine(family, paged):
    """An engine that served other requests first (its pools or slot caches
    hold their stale rows and state) emits, twice, bitwise the tokens a
    fresh engine does on the same requests, and counts nothing new."""
    jcfg = _jcfg(family, f"reuse-e-{family}")
    config = ServeConfig(n_slots=2, paged=paged, page_size=8)
    used = _engine(jcfg, 20)
    used.serve_continuous(_reqs(1, 6, hi=40), config)
    fresh = _engine(jcfg, 20)
    ref = _outputs(fresh.serve_continuous(r := _reqs(2, 5), config), r)
    before = trace_counts()
    for _ in range(2):
        assert _outputs(used.serve_continuous(r := _reqs(2, 5), config), r) == ref
    assert trace_counts() == before
    assert len(used.slot_memory) == 1


@pytest.mark.parametrize("family,paged", _MODES)
def test_reused_memory_matches_fresh_cascade(family, paged):
    """The same at E = 3: a 3-member tier of ``family`` in front of a dense
    tier, on reused tier memory against a fresh server."""
    pairs = [(_jcfg(family, f"reuse-t-{family}"), 3, 21, "vote", 0.67),
             (_jcfg("dense", f"reuse-t2-{family}"), 1, 22, "confidence", -1.0)]
    config = ServeConfig(n_slots=2, max_seq=48, paged=paged, page_size=8)
    used = _server(pairs)
    used.serve_continuous(_reqs(3, 3, hi=40, max_new=(2, 3)), config)
    fresh = _server(pairs)
    ref = _outputs(fresh.serve_continuous(r := _reqs(4, 3), config), r)
    memory = [(t.slot_memory.copy(), [m.graphs for m in t.slot_memory.values()]) for t in used.tiers]
    for _ in range(2):
        assert _outputs(used.serve_continuous(r := _reqs(4, 3), config), r) == ref
    assert [(t.slot_memory, [m.graphs for m in t.slot_memory.values()]) for t in used.tiers] == memory
    assert all(len(t.slot_memory) == 1 for t in used.tiers)


def test_live_stream_gets_its_own_memory():
    """A second slot stream opened while the first is alive runs on memory
    of its own (a shared pool would mix their slots); once the first is
    gone, the engine's memory is reused."""
    eng = _engine(_jcfg("dense", "reuse-live"), 8)
    s1 = eng.slot_stream(ServeConfig(n_slots=2))
    s2 = eng.slot_stream(ServeConfig(n_slots=2))
    assert s1.backend.mem is not s2.backend.mem
    assert eng.slot_memory[next(iter(eng.slot_memory))] is s1.backend.mem
    mem = s1.backend.mem
    del s1
    assert eng.slot_stream(ServeConfig(n_slots=2)).backend.mem is mem


def test_slot_memory_freed_with_its_owner():
    """With the cyclic collector off, a dropped server frees its tiers'
    pools, slot caches and graph sets: nothing of them sits in a cycle."""
    gc.collect()
    gc.disable()
    try:
        server = _server([(_jcfg("hybrid", "reuse-free"), 3, 30, "vote", 0.67),
                             (_jcfg("dense", "reuse-free2"), 1, 31, "confidence", -1.0)])
        server.serve_continuous(_reqs(5, 4), ServeConfig(n_slots=2, max_seq=32, page_size=8))
        mems = [m for t in server.tiers for m in t.slot_memory.values()]
        assert len(mems) == 2
        leaves = [weakref.ref(next(iter(m.state.values()))) for m in mems]
        sets = [weakref.ref(m.graphs) for m in mems]
        del server, mems
        assert [w() for w in leaves + sets] == [None] * 4
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the graph set on the CPU
# ---------------------------------------------------------------------------


def test_graph_set_frees_an_evicted_bucket_before_making_the_next():
    """An evicted bucket's memory and entries are gone before the new
    bucket's memory is made, so peak memory holds at most the cap of
    buckets; a kept bucket is moved to the end, not evicted."""
    gs = GraphSet("cpu", max_buckets=2)
    for b in ("a", "b"):
        gs.run(f"gs-evict/{b}", lambda x: x + 1, np.zeros(3, np.float32), bucket=b)
    mem = gs.bucket("a", lambda: torch.zeros(4))
    ref = weakref.ref(mem)
    del mem
    seen = []
    gs.bucket("c", lambda: seen.append(ref() is None) or torch.ones(4))
    assert list(gs.buckets) == ["a", "c"]
    gs.bucket("d", lambda: seen.append(ref() is None) or torch.ones(4))
    assert seen == [False, True]
    assert list(gs.buckets) == ["c", "d"] and ("gs-evict/a", "a", False) not in gs._entries


def test_graph_set_counts_first_calls_and_stages_inputs():
    gs = GraphSet("cpu")
    key, eager_key = "graph-set-test/prog", "graph-set-test/eager"
    seen = []

    def fn(a, b):
        seen.append((a.clone(), b.clone()))
        return a + b

    before = trace_counts()
    out = gs.run(key, fn, np.arange(3, dtype=np.int32), np.array([5], np.int64), bucket=3)
    assert out.tolist() == [5, 6, 7] and trace_count(key) == before.get(key, 0) + 1
    out = gs.run(key, fn, np.array([1, 1, 1], np.int32), np.array([2], np.int64), bucket=3)
    assert out.tolist() == [3, 3, 3] and trace_count(key) == before.get(key, 0) + 1
    gs.run(key, fn, np.arange(4, dtype=np.int32), np.array([0], np.int64), bucket=4)
    assert trace_count(key) == before.get(key, 0) + 2
    # the static buffers take the call's values, never a stale one
    assert seen[1][0].tolist() == [1, 1, 1] and seen[1][0].dtype == torch.int32
    with pytest.raises(ValueError, match="static"):
        gs.run(key, fn, np.arange(5, dtype=np.int32), np.array([0], np.int64), bucket=3)
    for _ in range(3):
        assert gs.eager(eager_key, lambda x: x * 2, 4) == 8
    assert trace_count(eager_key) == before.get(eager_key, 0) + 1


# ---------------------------------------------------------------------------
# tensor-addressed programs == the int-addressed code they replaced
# ---------------------------------------------------------------------------


def _int_chunk_attention(p, x, cfg, k_cache, v_cache, slot: int, start: int, *, sliding_window=None):
    """``layers.attention_prefill_chunk`` as it was: Python-int slices."""
    E, _, C, _ = x.shape
    positions = start + torch.arange(C)[None, :]
    q, k, v = L.qkv_project(p, x, cfg, positions)
    k_cache[:, slot, :, start:start + C] = k[:, 0].transpose(1, 2).to(k_cache.dtype)
    v_cache[:, slot, :, start:start + C] = v[:, 0].transpose(1, 2).to(v_cache.dtype)
    ctx = L._chunk_attend(L._fold(q), k_cache[:, slot].contiguous(), v_cache[:, slot].contiguous(),
                          positions, cfg, sliding_window)
    return L.attn_output(p, ctx.reshape(q.shape), cfg)


def _int_chunk_layer(p, x, cfg, k_cache, v_cache, slot, start, *, sliding_window=None):
    x = x + _int_chunk_attention(p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, k_cache, v_cache, slot, start,
                                 sliding_window=sliding_window)
    return BD._mlp_residual(p, x, cfg)


def _int_prefill_into_slot_members(params, tokens, cache, slot: int, start: int, cfg):
    """``api.prefill_into_slot_members`` as it was: int slot, slices."""
    x = t_api.embed_inputs(params, torch.as_tensor(tokens).to(torch.int64)[None])
    if cfg.family == "dense":
        for l in range(cfg.n_layers):
            x = _int_chunk_layer(t_api._layer(params, l), x, cfg, cache["k"][l], cache["v"][l], slot, start)
        return cache
    row = slice(slot, slot + 1)
    for l in range(cfg.n_layers):
        x, st = t_api._recurrent_layer(params, l, x, cfg, {n: cache[n][l][:, row] for n in t_api._state_keys(cfg)})
        for name, t in st.items():
            cache[name][l][:, row] = t
        if t_api._attn_after(cfg, l):
            inv = l // cfg.attn_every
            x = _int_chunk_layer(params["shared_attn"], x, cfg, cache["attn_k"][inv], cache["attn_v"][inv], slot, start)
    return cache


def _leaves(cache):
    return [t for v in cache.values() for t in (v if isinstance(v, list) else [v])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_addressed_chunk_matches_int_addressed(family, dtype):
    """Two chunks (9 tokens at 0, then 4 at 9) into slot 1 of 3 slots of a
    3-member cache holding random stale rows and state: every cache leaf
    bitwise what the int-addressed code wrote, with slot and start as
    (1,) tensors."""
    cfg = dataclasses.replace(_tcfg(_jcfg(family, f"reuse-int-{family}")), dtype=dtype)
    vals = t_ens.init_ensemble(cfg, 3, torch.Generator().manual_seed(0), "cpu")
    cache = t_api.init_cache_members(cfg, 3, 3, 32, "cpu")
    g = torch.Generator().manual_seed(1)
    for t in _leaves(cache):
        t.copy_(torch.randn(t.shape, generator=g).to(t.dtype))
    ref = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in cache.items()}
    toks = np.random.default_rng(2).integers(0, 64, 13).astype(np.int32)
    for lo, hi in ((0, 9), (9, 13)):
        _int_prefill_into_slot_members(vals, toks[lo:hi], ref, 1, lo, cfg)
        t_ens.ensemble_prefill_into_slot(vals, torch.as_tensor(toks[lo:hi]), cache, torch.tensor([1]),
                                         torch.tensor([lo]), cfg)
    for a, b in zip(_leaves(cache), _leaves(ref)):
        assert torch.equal(a, b)


def test_tensor_addressed_paged_chunk_matches_int_start():
    """Paged chunked prefill with ``start`` a (1,) tensor writes bitwise the
    pool it writes with an int start (the int path now goes through the
    same code), and both equal the dense slot cache's rows."""
    cfg = _tcfg(_jcfg("dense", "reuse-paged-int"))
    vals = t_ens.init_ensemble(cfg, 3, torch.Generator().manual_seed(0), "cpu")
    pages = np.array([3, 0, 5, -1], np.int32)
    toks = np.random.default_rng(3).integers(0, 64, 20).astype(np.int32)
    pools = [t_ens.init_ensemble_paged_pool(vals, cfg, 7, 8) for _ in range(2)]
    dense = t_api.init_cache_members(cfg, 3, 2, 32, "cpu")
    for lo, hi in ((0, 16), (16, 20)):
        t_ens.ensemble_prefill_into_slot_paged(vals, toks[lo:hi], pools[0], pages, lo, cfg)
        t_ens.ensemble_prefill_into_slot_paged(vals, torch.as_tensor(toks[lo:hi]), pools[1], torch.as_tensor(pages),
                                               torch.tensor([lo]), cfg)
        _int_prefill_into_slot_members(vals, toks[lo:hi], dense, 1, lo, cfg)
    for name in ("k", "v"):
        assert torch.equal(pools[0][name], pools[1][name])
        view = pools[1][name][:, :, pages[:3]].permute(0, 1, 3, 2, 4, 5).reshape(dense[name][:, :, 1, :, :24].shape)
        assert torch.equal(view[..., :20, :], dense[name][:, :, 1, :, :20])


@pytest.mark.parametrize("paged", [True, False])
def test_graph_set_decode_matches_direct_call(paged):
    """A tier backend's decode step through its graph set (inputs staged
    into static buffers) gives bitwise the tokens and cache rows of the
    program called directly on a copy of the same memory."""
    server = _server([(_jcfg("dense", f"reuse-dec-{paged}"), 3, 40, "vote", 0.67)])
    tier = server.tiers[0]
    be = TierBackend(tier, n_slots=3, max_seq=32, paged=paged, page_size=8)
    g = torch.Generator().manual_seed(5)
    for t in _leaves(be.mem.state):
        t.copy_(torch.randn(t.shape, generator=g))
    if paged:
        for s in range(3):
            be.pool.admit(s, np.arange(9 + s, dtype=np.int32), share=False)
    copy = {k: v.clone() for k, v in be.mem.state.items()}
    tok = np.random.default_rng(6).integers(0, 64, (3, 3, 1)).astype(np.int32)
    pos = np.array([9, 10, 11], np.int32)
    got = be.decode(tok, pos)
    if paged:
        t, _ = tier_paged_programs(tier.cfg, 0.0).decode_slots(tier.values, tok, copy, pos, be.pool.table,
                                                                be.slot_keys)
    else:
        t, _ = tier._decode_slots(tier.values, tok, copy, pos, be.slot_keys)
    np.testing.assert_array_equal(got, t[..., 0].numpy())
    for name in copy:
        assert torch.equal(copy[name], be.mem.state[name])


# ---------------------------------------------------------------------------
# the JAX package's tokens, on reused memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_reused_engine_matches_jax(family):
    """Two serve_continuous runs of one engine (the second on its reused
    memory) emit the JAX engine's tokens on the same weights."""
    eng, jeng = _jax_engine(_jcfg(family, f"reuse-jax-{family}"), 50)
    jr = _reqs(51, 5, cls=JRequest)
    jeng.serve_continuous(jr, JServeConfig(n_slots=2, page_size=8))
    for _ in range(2):
        tr = _reqs(51, 5)
        eng.serve_continuous(tr, ServeConfig(n_slots=2, page_size=8))
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(b.output, a.output)
            assert a.truncated == b.truncated


def test_reused_cascade_matches_jax():
    """The same for a cascade: a 3-member vote tier over a dense tier."""
    j_server, t_server = _jax_server([(_jcfg("dense", "reuse-jc1"), 3, 60, "vote", 0.67),
                                      (_jcfg("dense", "reuse-jc2"), 1, 61, "confidence", -1.0)])
    kw = dict(n_slots=2, max_seq=48, page_size=8)
    jr = _reqs(62, 4, cls=JRequest)
    j_server.serve_continuous(jr, JServeConfig(**kw))
    for _ in range(2):
        tr = _reqs(62, 4)
        t_server.serve_continuous(tr, ServeConfig(**kw))
        for a, b in zip(jr, tr):
            assert (b.tier, b.truncated) == (a.tier, a.truncated)
            np.testing.assert_array_equal(b.output, a.output)


# ---------------------------------------------------------------------------
# the batch programs: classify, the batch prefill and generate's decode
# ---------------------------------------------------------------------------


def _reuse_pairs(family, tag):
    """tests/test_compile_reuse.py's server: a 3-member vote tier of
    ``family`` in front of a one-member confidence tier."""
    return [(_jcfg(family, f"reuse-{tag}1-{family}"), 3, 70, "vote", 0.67),
            (_jcfg("dense", f"reuse-{tag}2-{family}"), 1, 71, "confidence", -1.0)]


@pytest.mark.parametrize("family", FAMILIES)
def test_classify_zero_retrace_after_warmup(family):
    """Same-shape classify counts nothing new after a warm-up (tier
    transitions included), and answers alike every time."""
    server = _server(_reuse_pairs(family, "cls"))
    toks = np.random.default_rng(0).integers(0, 64, (16, 12)).astype(np.int32)
    server.classify(toks)  # warm-up: counts (tier transitions included)
    before = trace_counts()
    r1 = server.classify(toks)
    r2 = server.classify(toks)
    assert trace_counts() == before, "same-shape classify must not count again"
    assert any(k.endswith("/ens_last_logits") and k.startswith(f"reuse-cls1-{family}@") for k in before)
    np.testing.assert_array_equal(r1.pred, r2.pred)
    np.testing.assert_array_equal(r1.tier_of, r2.tier_of)


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_zero_retrace_after_warmup(family):
    server = _server(_reuse_pairs(family, "gen"))
    toks = np.random.default_rng(1).integers(0, 64, (8, 10)).astype(np.int32)
    server.generate(toks, max_new_tokens=3)  # warm-up
    before = trace_counts()
    r1 = server.generate(toks, max_new_tokens=3)
    r2 = server.generate(toks, max_new_tokens=3)
    assert trace_counts() == before, "same-shape generate must not count again"
    for prog in ("ens_prefill", "ens_decode"):
        assert before[f"reuse-gen1-{family}@T0/{prog}"] == 1
    np.testing.assert_array_equal(r1.pred, r2.pred)
    np.testing.assert_array_equal(r1.tier_of, r2.tier_of)
    tier = server.tiers[0]
    assert list(tier.batch_caches) == [(8, 10, 3)]


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_batch_programs_zero_retrace(family):
    """The engine's classify and generate, with left-pad starts where the
    family takes them: flat counts after a warm-up, one static cache a
    (B, S, max_new) bucket, equal answers."""
    eng = _engine(_jcfg(family, f"reuse-eb-{family}"), 9)
    toks = np.random.default_rng(2).integers(0, 64, (4, 8)).astype(np.int32)
    starts = np.array([0, 3, 5, 1], np.int32) if family == "dense" else None
    eng.classify(toks, starts)
    eng.generate(toks, 4, starts=starts)
    before = trace_counts()
    outs = [(eng.classify(toks, starts), eng.generate(toks, 4, starts=starts)) for _ in range(2)]
    assert trace_counts() == before
    assert before[f"reuse-eb-{family}/prefill"] == 2 and before[f"reuse-eb-{family}/decode"] == 1
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert list(eng.batch_caches) == [(4, 8, 4, starts is None)]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_static_cache_generate_matches_grow_cache(family, temperature):
    """Generate over the tier's static cache at (B,) positions (the graphed
    route) emits bitwise the tokens of the grow_cache route at scalar
    positions (``eager=True``), on a first call, on a reused cache holding
    another batch's rows, and at another max_new on its own cache."""
    jcfg = _jcfg(family, f"reuse-sc-{family}")
    tier = CascadeTier(_tcfg(jcfg), t_ens.init_ensemble(_tcfg(jcfg), 3, torch.Generator().manual_seed(3), "cpu"),
                       TierSpec("t", "vote", 0.5, k=3), temperature=temperature, device="cpu")
    rng = np.random.default_rng(4)
    for toks, max_new in ((rng.integers(0, 64, (4, 9)), 5), (rng.integers(0, 64, (4, 9)), 5),
                          (rng.integers(0, 64, (4, 9)), 2)):
        toks = toks.astype(np.int32)
        got = tier.generate(toks, max_new, seed=11)
        ref = tier.generate(toks, max_new, seed=11, eager=True)
        assert got.shape == (3, 4, max_new)
        np.testing.assert_array_equal(got, ref)
    assert sorted(tier.batch_caches) == [(4, 9, 2), (4, 9, 5)]


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_static_cache_generate_matches_grow_cache(family):
    """The engine's static-cache generate (with starts on the dense family)
    equals its grow_cache oracle bitwise."""
    eng = _engine(_jcfg(family, f"reuse-esc-{family}"), 12)
    rng = np.random.default_rng(5)
    starts = np.array([2, 0, 6], np.int32) if family == "dense" else None
    for _ in range(2):
        toks = rng.integers(0, 64, (3, 8)).astype(np.int32)
        np.testing.assert_array_equal(eng.generate(toks, 5, starts=starts),
                                      eng.generate(toks, 5, starts=starts, eager=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_vector_position_decode_matches_scalar(family, dtype):
    """A decode step at a (B,) position vector (a captured step's route, and
    a 0-d tensor, which broadcasts to it) writes bitwise the cache and emits
    bitwise the logits of the step at the scalar int position, with left-pad
    starts on the dense family."""
    cfg = dataclasses.replace(_tcfg(_jcfg(family, f"reuse-vec-{family}")), dtype=dtype)
    vals = t_ens.init_ensemble(cfg, 3, torch.Generator().manual_seed(6), "cpu")
    toks = np.random.default_rng(7).integers(0, 64, (4, 10)).astype(np.int32)
    batch = {"tokens": toks}
    kw = {}
    if family == "dense":
        batch["starts"] = np.array([0, 4, 9, 2], np.int32)
        kw["starts"] = torch.as_tensor(batch["starts"])
    cache = t_api.init_cache_members(cfg, 3, 4, 14, "cpu")
    t_ens.ensemble_prefill(vals, batch, cfg, cache=cache)
    tok = torch.as_tensor(np.random.default_rng(8).integers(0, 64, (3, 4, 1)).astype(np.int32))
    results = []
    for pos in (10, torch.full((4,), 10, dtype=torch.int64), torch.tensor(10), np.full(4, 10, np.int32)):
        c = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone() for k, v in cache.items()}
        logits, _ = t_api.decode_step_members(vals, tok, c, pos, cfg, **kw)
        results.append((logits, c))
    for logits, c in results[1:]:
        assert torch.equal(logits, results[0][0])
        for a, b in zip(_leaves(c), _leaves(results[0][1])):
            assert torch.equal(a, b)


def test_static_cache_prefill_matches_fresh_cache():
    """Prefill into a larger static cache holding stale rows writes rows
    [0, S) bitwise what a fresh prefill cache holds, and the logits."""
    cfg = _tcfg(_jcfg("hybrid", "reuse-pre"))
    vals = t_ens.init_ensemble(cfg, 3, torch.Generator().manual_seed(9), "cpu")
    toks = np.random.default_rng(10).integers(0, 64, (2, 7)).astype(np.int32)
    ref_logits, ref = t_ens.ensemble_prefill(vals, {"tokens": toks}, cfg)
    cache = t_api.init_cache_members(cfg, 3, 2, 12, "cpu")
    for t in _leaves(cache):
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(11)))
    logits, got = t_ens.ensemble_prefill(vals, {"tokens": toks}, cfg, cache=cache)
    assert got is cache and torch.equal(logits, ref_logits)
    for name, v in ref.items():
        for a, b in zip(v if isinstance(v, list) else [v], got[name] if isinstance(v, list) else [got[name]]):
            if name in ("attn_k", "attn_v"):
                b = b[..., :7, :]
            assert torch.equal(a, b), name


@pytest.mark.parametrize("family", FAMILIES)
def test_batch_programs_match_jax(family):
    """pred, tier_of and the greedy tokens of the graphed-route classify and
    generate equal the JAX package's on the same weights, at a first call
    and on the reused programs and static caches."""
    j_server, t_server = _jax_server(_reuse_pairs(family, "jx"))
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 64, (16, 12)).astype(np.int32)
    gtoks = rng.integers(0, 64, (8, 10)).astype(np.int32)
    jc, jg = j_server.classify(toks), j_server.generate(gtoks, max_new_tokens=4)
    jt = np.asarray(j_server.tiers[0].generate(gtoks, 4))
    for _ in range(2):
        tc, tg = t_server.classify(toks), t_server.generate(gtoks, max_new_tokens=4)
        for j, t in ((jc, tc), (jg, tg)):
            np.testing.assert_array_equal(t.pred, j.pred)
            np.testing.assert_array_equal(t.tier_of, j.tier_of)
        np.testing.assert_array_equal(t_server.tiers[0].generate(gtoks, 4), jt)


def test_engine_batch_programs_match_jax():
    """The engine's graphed-route classify (argmax) and generate, with
    left-pad starts, equal the JAX engine's."""
    eng, jeng = _jax_engine(_jcfg("dense", "reuse-ejx"), 14)
    toks = np.random.default_rng(15).integers(0, 64, (4, 9)).astype(np.int32)
    starts = np.array([0, 2, 8, 5], np.int32)
    jl, jt = jeng.classify(toks, starts), jeng.generate(toks, 5, starts=starts)
    for _ in range(2):
        np.testing.assert_array_equal(eng.classify(toks, starts).argmax(-1), np.asarray(jl).argmax(-1))
        np.testing.assert_array_equal(eng.generate(toks, 5, starts=starts), np.asarray(jt))


@pytest.mark.parametrize("family", FAMILIES)
def test_batch_buckets_bounded(family):
    """Generate at five (S, max_new) shapes on a tier that keeps two
    buckets: never more than two static caches, each call bitwise the
    grow_cache oracle, and an evicted shape that comes back captures again
    over new memory and answers as before."""
    jcfg = _jcfg(family, f"reuse-lru-{family}")
    tier = CascadeTier(_tcfg(jcfg), t_ens.init_ensemble(_tcfg(jcfg), 2, torch.Generator().manual_seed(17), "cpu"),
                       TierSpec("t", "vote", 0.5, k=2), temperature=0.8, device="cpu")
    tier.graphs.max_buckets = 2
    rng = np.random.default_rng(18)
    toks = rng.integers(0, 64, (4, 12)).astype(np.int32)
    shapes = [(6, 4), (8, 2), (7, 5), (9, 3), (6, 4)]
    key = f"reuse-lru-{family}@T0.8/ens_prefill"
    first, outs = trace_count(key), []
    for S, max_new in shapes:
        outs.append(tier.generate(toks[:, :S], max_new, seed=5))
        np.testing.assert_array_equal(outs[-1], tier.generate(toks[:, :S], max_new, seed=5, eager=True))
        assert len(tier.batch_caches) <= 2 and len(tier.graphs.buckets) <= 2
    assert list(tier.batch_caches) == [(4, 9, 3), (4, 6, 4)]
    assert trace_count(key) == first + 5, "the evicted (6, 4) bucket captures again"
    np.testing.assert_array_equal(outs[-1], outs[0])
    before = trace_counts()
    tier.generate(toks[:, :9], 3, seed=5)
    assert trace_counts() == before, "a kept bucket replays"


def test_engine_batch_buckets_bounded():
    """The engine's classify and generate buckets share one bound: a
    serve_pending-like run of varied budgets keeps at most the cap, and
    answers bitwise as the eager oracle."""
    tcfg = _tcfg(_jcfg("dense", "reuse-elru"))
    eng = ServingEngine(tcfg, t_api.init_params(tcfg, torch.Generator().manual_seed(19), "cpu"),
                        max_seq=64, device="cpu")
    eng.graphs.max_buckets = 3
    toks = np.random.default_rng(20).integers(0, 64, (4, 8)).astype(np.int32)
    starts = np.array([0, 3, 5, 1], np.int32)
    for max_new in (2, 3, 4, 5, 2):
        np.testing.assert_array_equal(eng.classify(toks, starts), eng.classify(toks, starts, eager=True))
        np.testing.assert_array_equal(eng.generate(toks, max_new, starts=starts),
                                      eng.generate(toks, max_new, starts=starts, eager=True))
        assert len(eng.graphs.buckets) <= 3
    assert list(eng.graphs.buckets) == [(4, 8, 5, False), ("classify", (4, 8), False), (4, 8, 2, False)]
    assert list(eng.batch_caches) == [(4, 8, 5, False), (4, 8, 2, False)]


def test_batch_memory_freed_with_its_owner():
    """With the cyclic collector off, a dropped tier frees its static batch
    caches and its batch graph set."""
    gc.collect()
    gc.disable()
    try:
        server = _server(_reuse_pairs("hybrid", "free"))
        toks = np.random.default_rng(16).integers(0, 64, (8, 6)).astype(np.int32)
        server.classify(toks)
        server.generate(toks, 3)
        caches = [weakref.ref(next(iter(t.batch_caches.values()))["attn_k"][0]) for t in server.tiers[:1]]
        sets = [weakref.ref(t.graphs) for t in server.tiers]
        del server
        assert [w() for w in caches + sets] == [None] * 3
    finally:
        gc.enable()

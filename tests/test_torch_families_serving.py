"""The MoE and VLM families through the port's serving layer —
``ServingEngine`` slot streams and ``CascadeServer`` (classify, generate,
serve_continuous over paged pools and dense slot caches) — on the configs
of ``tests/test_slot_stream.py`` / ``tests/test_differential_prefill.py``
(``moe``, ``moe_interleaved``) and a VLM of the same size, with bridged
float32 weights and numpy prompts.

Discrete outputs are held exactly: greedy tokens, answering tiers,
``truncated`` flags and stream counters equal to the JAX package's; inside
the port paged == dense serving bitwise, and chunked == decode-only
admission under ``capacity_factor >= n_experts`` (no choice can drop, the
JAX package's stated contract for MoE admission); at the default 1.25 a
chunk drops choices, and the tokens are still the JAX package's.  A
repeat run counts no new program (``trace_counts()`` flat).  The server
takes tokens only, as the JAX one does: a VLM tier serves its text."""
import dataclasses

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
from repro_torch.core.cascade import TierSpec
from repro_torch.models import api as t_api
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig, ServingEngine
from repro_torch.serve.graphs import trace_counts
from test_torch_cascade import numpy_values

_BASE = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=64, remat=False, dtype="float32")
# capacity_factor >= n_experts: no token ever drops, so every admission
# path routes alike (tests/test_slot_stream.py's configs)
CONFIGS = {
    "moe": JModelConfig(name="fs-moe", family="moe", n_heads=4, n_kv_heads=2, n_experts=4, top_k=2,
                        capacity_factor=4.0, **_BASE),
    "moe_interleaved": JModelConfig(name="fs-moe-il", family="moe", n_heads=4, n_kv_heads=2, n_experts=4,
                                    top_k=2, moe_every=2, capacity_factor=4.0, **_BASE),
    "vlm": JModelConfig(name="fs-vlm", family="vlm", n_heads=4, n_kv_heads=2, n_vision_tokens=4,
                        frontend_dim=32, **_BASE),
}
FAMILIES = list(CONFIGS)
STREAM_KEYS = ("admitted", "admit_failures", "forced_completions", "chunk_calls",
               "chunk_tokens", "shared_tokens", "decode_tokens")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the module runs (restored after): these
    small models gain nothing from more, and under xdist the workers'
    thread pools otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family, name_suffix="", **changes):
    cfg = dataclasses.replace(CONFIGS[family], **changes)
    cfg = dataclasses.replace(cfg, name=cfg.name + name_suffix)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _prompts(seed, n, lo=4, hi=24, max_new=(2, 5)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, int(rng.integers(lo, hi))).astype(np.int32), int(rng.integers(*max_new)))
            for _ in range(n)]


def _engines(cfg, tcfg, seed, max_seq=64):
    vals = numpy_values(cfg, seed)
    return (JEngine(cfg, jax.tree.map(jnp.asarray, vals), max_seq=max_seq),
            ServingEngine(tcfg, params_from_numpy(vals, tcfg, device="cpu"), max_seq=max_seq, device="cpu"))


def _servers(tiers):
    """tiers: [(jax cfg, port cfg, k, seed, rule, theta)] -> (jax server, port server)."""
    jt, tt = [], []
    for i, (cfg, tcfg, k, seed, rule, theta) in enumerate(tiers):
        vals = numpy_values(cfg, seed, k=k)
        jt.append(JTier(cfg, jax.tree.map(jnp.asarray, vals), JTierSpec(f"t{i}", rule, theta, k=k)))
        tt.append(CascadeTier(tcfg, params_from_numpy(vals, tcfg, device="cpu"), TierSpec(f"t{i}", rule, theta, k=k),
                              device="cpu"))
    return JServer(jt), CascadeServer(tt, device="cpu")


def _serve(server, prompts, config, cls):
    reqs = [cls(tokens=t.copy(), max_new_tokens=m) for t, m in prompts]
    server.serve_continuous(reqs, config)
    return [(r.tier, r.truncated, np.asarray(r.output).tolist()) for r in reqs]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("paged", [True, False])
def test_chunked_matches_decode_only_admission(family, paged):
    """capacity_factor 4 = n_experts: bucketed chunked prefill (a 33-token
    prompt takes several pow2 buckets) emits the tokens one-token
    admission does; over paged pools both equal the JAX engine's (the
    dense slot cache is held to them here and below)."""
    cfg, tcfg = _cfg(family, f"-cd-{paged}")
    assert t_api.supports_paging(tcfg) and t_api.supports_chunked_prefill(tcfg)
    jeng, teng = _engines(cfg, tcfg, 21)
    prompts = _prompts(7, 4, hi=16) + [(np.random.default_rng(8).integers(0, 64, 33).astype(np.int32), 4)]
    outs = {}
    for chunked in (True, False):
        kw = dict(n_slots=2, chunked_prefill=chunked, paged=paged, page_size=8)
        outs[chunked] = _serve(teng, prompts, ServeConfig(**kw), Request)
        stats = teng.last_stream_stats
        assert stats["chunk_tokens"] >= 32 if chunked else stats["chunk_calls"] == 0
        if paged:
            assert _serve(jeng, prompts, JServeConfig(**kw), JRequest) == outs[chunked]
            assert {k: stats[k] for k in STREAM_KEYS} == {k: jeng.last_stream_stats[k] for k in STREAM_KEYS}
    assert outs[True] == outs[False]


def test_cascade_with_capacity_drops_matches_jax():
    """The default capacity factor 1.25: a chunk of T tokens drops the
    choices past ceil(T * K / E * 1.25) rows of an expert.  A 3-member MoE
    tier under the digest vote defers to a 1-member interleaved-MoE tier
    (the shape of the olmo-1b x3 -> mixtral-8x22b cascade, MoE in both
    places): a paged serve_continuous with chunked admission gives the JAX
    package's tiers, tokens, flags and stream counters, with drops in tier
    1's chunks."""
    from repro_torch.models import layers as t_layers

    cfg1, t1 = _cfg("moe", "-drops", capacity_factor=1.25)
    cfg2, t2 = _cfg("moe_interleaved", "-drops", capacity_factor=1.25)
    assert t_layers.moe_capacity(16, 16, t1) < 16  # a 16-token chunk keeps 10 rows of an expert
    j_server, t_server = _servers([(cfg1, t1, 3, 31, "vote", 0.67), (cfg2, t2, 1, 32, "confidence", -1.0)])
    prompts = _prompts(9, 8, lo=10, hi=40)
    kw = dict(n_slots=3, max_seq=64, page_size=8)
    got = _serve(t_server, prompts, ServeConfig(**kw), Request)
    assert got == _serve(j_server, prompts, JServeConfig(**kw), JRequest)
    for js, ts in zip(j_server.last_stream_stats, t_server.last_stream_stats):
        assert {k: ts[k] for k in STREAM_KEYS} == {k: js[k] for k in STREAM_KEYS}
    assert t_server.last_stream_stats[0]["chunk_tokens"] > 0 and 1 in {t for t, _, _ in got}


@pytest.mark.parametrize("family", FAMILIES)
def test_cascade_paged_equals_dense_and_no_recount(family):
    """The family as both tiers of a cascade: paged and dense serving emit
    the same tiers and tokens, and a repeat run counts no new program."""
    cfg, tcfg = _cfg(family, "-pd")
    _, t_server = _servers([(cfg, tcfg, 3, 41, "vote", 0.67), (cfg, tcfg, 1, 42, "confidence", -1.0)])
    prompts = _prompts(11, 6, hi=30)
    outs = {}
    for paged in (True, False):
        config = ServeConfig(n_slots=3, max_seq=64, page_size=8, paged=paged)
        outs[paged] = _serve(t_server, prompts, config, Request)
        before = trace_counts()
        assert _serve(t_server, prompts, config, Request) == outs[paged]
        assert trace_counts() == before, "a repeat serve_continuous must not count a program"
    assert outs[True] == outs[False]
    assert {t for t, _, _ in outs[True]} <= {0, 1}

"""Cascades with constant-state tiers in the port against the JAX
package: ``CascadeServer.classify``, ``.generate`` and
``.serve_continuous`` with RWKV6 and hybrid tiers, on the same weights
(made by the JAX package from a seed, carried through numpy) and the same
numpy prompts.  ``pred``, ``tier_of``, tier counts, evaluated rows, cost,
answering tiers, tokens, stream counters and metered host fetches are
equal to the reference's; scores agree to rtol 1e-4 / atol 1e-6 (f32
configs)."""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.core import cascade as j_cascade
from repro.core.cascade import TierSpec as JTierSpec
from repro.serve import CascadeServer as JServer
from repro.serve import CascadeTier as JTier
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core import cascade as t_cascade
from repro_torch.core import ensemble as t_ens
from repro_torch.core.cascade import TierSpec
from repro_torch.kernels.agreement import ops as agree
from repro_torch.models import api as t_api
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig, ServingEngine, SlotStream, TierBackend
from repro_torch.serve.paging import PagePool
from test_torch_recurrent_serving import CONFIGS, STREAM_KEYS, _member, _prompts, _stack, port_cfg


# ---------------------------------------------------------------------------
# cascades with recurrent tiers
# ---------------------------------------------------------------------------


def _build(pairs):
    """pairs: [(jax cfg, k, seed, rule, theta, cost)] -> (jax server, port
    server) on the same f32 weights."""
    j_tiers, t_tiers = [], []
    for i, (cfg, k, seed, rule, theta, cost) in enumerate(pairs):
        cfg = dataclasses.replace(cfg, dtype="float32")
        vals = _stack(cfg, seed, k)
        j_tiers.append(JTier(cfg, jax.tree.map(jnp.asarray, vals), JTierSpec(f"t{i}", rule, theta, k=k, cost=cost)))
        tcfg = port_cfg(cfg)
        t_tiers.append(CascadeTier(tcfg, params_from_numpy(vals, tcfg, device="cpu"),
                                   TierSpec(f"t{i}", rule, theta, k=k, cost=cost), device="cpu"))
    return JServer(j_tiers), CascadeServer(t_tiers, device="cpu")


def _run_both(j_server, t_server, mode, *args):
    j_cascade.reset_host_fetch_stats()
    t_cascade.reset_host_fetch_stats()
    ref = getattr(j_server, mode)(*args)
    got = getattr(t_server, mode)(*args)
    for f in ("pred", "tier_of", "tier_counts", "evaluated"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)), err_msg=f)
    assert got.cost == ref.cost
    np.testing.assert_allclose(got.scores, np.asarray(ref.scores), rtol=1e-4, atol=1e-6)
    assert t_cascade.host_fetch_stats() == j_cascade.host_fetch_stats()
    return got


def _serve_both(j_server, t_server, prompts, **kw):
    jr = [JRequest(tokens=t, max_new_tokens=m) for t, m in prompts]
    tr = [Request(tokens=t, max_new_tokens=m) for t, m in prompts]
    j_cascade.reset_host_fetch_stats()
    t_cascade.reset_host_fetch_stats()
    j_server.serve_continuous(jr, JServeConfig(**kw))
    done = t_server.serve_continuous(tr, ServeConfig(**kw))
    assert sorted(r.rid for r in done) == sorted(r.rid for r in tr), "every request completes exactly once"
    assert t_cascade.host_fetch_stats() == j_cascade.host_fetch_stats()
    for a, b in zip(jr, tr):
        assert (b.tier, b.truncated) == (a.tier, a.truncated)
        np.testing.assert_array_equal(b.output, a.output)
    for js, ts in zip(j_server.last_stream_stats, t_server.last_stream_stats):
        assert {k: ts[k] for k in STREAM_KEYS} == {k: js[k] for k in STREAM_KEYS}
    return tr


def test_mixed_family_cascade():
    """tests/test_serving.py's RWKV6 tier (k=2, vote) -> dense tier
    (olmo-1b reduced): classify gives the JAX package's ``pred``,
    ``tier_of``, counts and host fetches, and the RWKV engine generates
    the JAX engine's tokens."""
    rw_cfg = j_get_config("rwkv6-7b").reduced()
    d_cfg = j_get_config("olmo-1b").reduced()
    j_server, t_server = _build([(rw_cfg, 2, 5, "vote", 0.6, 1.0), (d_cfg, 1, 6, "confidence", -1.0, 10.0)])
    vocab = min(rw_cfg.vocab_size, d_cfg.vocab_size)
    toks = np.random.default_rng(7).integers(0, vocab, (8, 16)).astype(np.int32)
    got = _run_both(j_server, t_server, "classify", toks)
    assert got.tier_counts.sum() == 8
    rw32 = dataclasses.replace(rw_cfg, dtype="float32")
    member = _member(_stack(rw32, 5, 2))
    ref = JEngine(rw32, jax.tree.map(jnp.asarray, member)).generate(toks[:2], max_new_tokens=3)
    gen = ServingEngine(port_cfg(rw32), params_from_numpy(member, port_cfg(rw32), device="cpu"),
                        device="cpu").generate(toks[:2], max_new_tokens=3)
    assert gen.shape == (2, 3)
    np.testing.assert_array_equal(gen, ref)


def test_cascade_defer_completes_exactly_once():
    """tests/test_slot_stream.py's scenario: an RWKV tier 0 (k=3, digest
    vote 0.67) whose independent members never agree, so every request is
    deferred and re-admitted mid-stream into tier-1 (dense, k=1) slots;
    each completes exactly once with tier 1's answer, as in the JAX
    package (tiers, tokens, stream counters, host fetches)."""
    rw, dense = CONFIGS["ssm_rwkv6"], dataclasses.replace(CONFIGS["hybrid"], family="dense", name="ss-dense")
    j_server, t_server = _build([(rw, 3, 1, "vote", 0.67, 1.0), (dense, 1, 0, "confidence", -1.0, 10.0)])
    prompts = _prompts(41, 5, lo=4, hi=10, max_new=(4, 5))
    tr = _serve_both(j_server, t_server, prompts, n_slots=2, max_seq=32)
    assert all(r.tier == 1 for r in tr), "untrained members never agree"
    tier1 = t_server.tiers[1]
    for r in tr:
        np.testing.assert_array_equal(tier1.generate(r.tokens[None], r.max_new_tokens)[0, 0], r.output)


def test_hybrid_to_rwkv_cascade():
    """The slice's cascade at reduced width: zamba2-2.7b x 3 -> rwkv6-7b x 1
    in ``classify`` (score rule, theta between the middle scores so rows
    defer), ``generate`` (digest vote 0.5) and ``serve_continuous``; every
    discrete output and host fetch equal to the JAX package's."""
    zc, rc = j_get_config("zamba2-2.7b").reduced(), j_get_config("rwkv6-7b").reduced()
    j_server, t_server = _build([(zc, 3, 11, "score", 0.0, 3.0), (rc, 1, 12, "confidence", -1.0, 10.0)])
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 512, (12, 16)).astype(np.int32)
    tier = t_server.tiers[0]
    s = np.sort(agree.agreement(tier._last_logits(tier.values, {"tokens": toks}))["mean_score"].numpy())
    theta = float((s[5] + s[6]) / 2)
    for server in (j_server, t_server):
        server.tiers[0].spec = dataclasses.replace(server.tiers[0].spec, theta=theta)
    got = _run_both(j_server, t_server, "classify", toks)
    assert got.tier_counts.tolist() == [6, 6]
    for server in (j_server, t_server):
        server.tiers[0].spec = dataclasses.replace(server.tiers[0].spec, rule="vote", theta=0.5)
    _run_both(j_server, t_server, "generate", toks[:6, :10], 3)
    prompts = _prompts(14, 5, lo=3, hi=10, max_new=(2, 4), vocab=512)
    _serve_both(j_server, t_server, prompts, n_slots=2, max_seq=32)


def test_serve_continuous_frees_without_the_collector():
    """With the cyclic collector off, a finished ``serve_continuous`` leaves
    no slot stream, tier backend or page pool alive, and a dropped server
    or engine frees its weights: the stats views hold the metrics, not
    their owners, so nothing of a run sits in a reference cycle."""
    hy = port_cfg(dataclasses.replace(CONFIGS["hybrid"], dtype="float32"))
    dense = port_cfg(dataclasses.replace(CONFIGS["hybrid"], family="dense", name="ss-dense", dtype="float32"))
    rw = port_cfg(dataclasses.replace(CONFIGS["ssm_rwkv6"], dtype="float32"))
    g = torch.Generator().manual_seed(0)
    prompts = _prompts(3, 4, lo=3, hi=12, max_new=(2, 4))
    alive = lambda *types: sum(type(o) in types for o in gc.get_objects())
    gc.collect()
    gc.disable()
    try:
        server = CascadeServer([
            CascadeTier(hy, t_ens.init_ensemble(hy, 3, g, "cpu"), TierSpec("t0", "vote", 0.67, k=3, cost=1.0), device="cpu"),
            CascadeTier(dense, t_ens.init_ensemble(dense, 1, g, "cpu"), TierSpec("t1", "confidence", -1.0, k=1, cost=4.0),
                        device="cpu"),
        ], device="cpu")
        engine = ServingEngine(rw, t_api.init_params(rw, g, "cpu"), max_seq=32, device="cpu")
        done = server.serve_continuous([Request(tokens=t, max_new_tokens=m) for t, m in prompts],
                                       ServeConfig(n_slots=2, max_seq=32, page_size=8))
        assert len(done) == len(prompts)
        engine.serve_continuous([Request(tokens=t, max_new_tokens=m) for t, m in prompts],
                                ServeConfig(n_slots=2, max_seq=32))
        assert alive(SlotStream, TierBackend, PagePool) == 0
        weights = [weakref.ref(server.tiers[0].values["embed"]), weakref.ref(server.tiers[1].values["embed"]),
                   weakref.ref(engine.params["embed"])]
        del server, engine
        assert [w() for w in weights] == [None] * 3
    finally:
        gc.enable()

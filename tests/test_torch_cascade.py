"""End-to-end parity of the ported cascade with the JAX package:
``CascadeServer.classify`` and greedy ``.generate`` give exactly the
reference's ``pred``, ``tier_of``, ``tier_counts``, ``evaluated``, ``cost``
and metered host fetches (calls and bytes), on the same bridged float32
weights and numpy prompts.  Scores agree to rtol 1e-4 / atol 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import cascade as j_cascade
from repro.core import ensemble as j_ens
from repro.core.cascade import TierSpec as JTierSpec
from repro.models import api as j_api
from repro.models.params import unbox
from repro.serve import CascadeServer as JServer
from repro.serve import CascadeTier as JTier
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import cascade as t_cascade
from repro_torch.core.cascade import TierSpec
from repro_torch.kernels.agreement import ops as t_agree
from repro_torch.serve import CascadeServer, CascadeTier

SMALL = JModelConfig(
    name="tiny-s", family="dense", n_layers=2, d_model=64, d_ff=128,
    vocab_size=64, n_heads=4, n_kv_heads=2, remat=False,
)
BIG = JModelConfig(
    name="tiny-b", family="dense", n_layers=3, d_model=96, d_ff=192,
    vocab_size=64, n_heads=4, n_kv_heads=4, remat=False,
)


def numpy_values(cfg, seed, k=None):
    """A values tree with the JAX package's structure, shapes and dtypes
    (from ``jax.eval_shape`` of its init), filled from a numpy seed."""
    def init(key):
        boxed = j_api.init_params(cfg, key) if k is None else j_ens.init_ensemble(cfg, k, key)
        return unbox(boxed)[0]

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape)
        if name == "scale":
            x = 1.0 + 0.1 * x
        elif name in ("embed", "lm_head"):
            x = 0.02 * x
        elif name.startswith("b"):
            x = 0.1 * x
        else:
            x = x / np.sqrt(s.shape[-2])
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def build(pairs):
    """pairs: [(jax cfg, k, seed, rule, theta, cost)] -> (jax server, port server)."""
    j_tiers, t_tiers = [], []
    for i, (cfg, k, seed, rule, theta, cost) in enumerate(pairs):
        cfg = dataclasses.replace(cfg, dtype="float32")
        vals = numpy_values(cfg, seed, k=k)
        j_tiers.append(JTier(cfg, jax.tree.map(jnp.asarray, vals), JTierSpec(f"t{i}", rule, theta, k=k, cost=cost)))
        tcfg = ModelConfig(**dataclasses.asdict(cfg))
        t_tiers.append(CascadeTier(tcfg, params_from_numpy(vals, tcfg, device="cpu"),
                                   TierSpec(f"t{i}", rule, theta, k=k, cost=cost), device="cpu"))
    return JServer(j_tiers), CascadeServer(t_tiers, device="cpu")


def run_both(j_server, t_server, mode, *args):
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


def test_classify_vote_confidence():
    j_server, t_server = build([(SMALL, 3, 0, "vote", 0.5, 1.0), (BIG, 1, 1, "confidence", -1.0, 25.0)])
    toks = np.random.default_rng(0).integers(0, 64, (20, 16)).astype(np.int32)
    got = run_both(j_server, t_server, "classify", toks)
    assert got.tier_counts.sum() == 20 and got.tier_counts[1] > 0
    np.testing.assert_allclose(t_server.tier_fractions(got), np.asarray(j_server.tier_fractions(got)))


def test_classify_score_rule_half_defers():
    """Tier-1 score rule with theta between the two middle mean scores, so
    about half the rows defer and the compaction chunking splits."""
    toks = np.random.default_rng(1).integers(0, 64, (20, 16)).astype(np.int32)
    j_server, t_server = build([(SMALL, 3, 2, "score", 0.0, 1.0), (BIG, 1, 3, "confidence", -1.0, 25.0)])
    tier = t_server.tiers[0]
    s = np.sort(t_agree.agreement(tier._last_logits(tier.values, {"tokens": toks}))["mean_score"].numpy())
    theta = float((s[9] + s[10]) / 2)
    for server in (j_server, t_server):
        server.tiers[0].spec = dataclasses.replace(server.tiers[0].spec, theta=theta)
    got = run_both(j_server, t_server, "classify", toks)
    assert got.tier_counts.tolist() == [10, 10]


def test_classify_quickstart_configs():
    """The quickstart's tiers: qwen2.5-3b reduced (k=3) then internlm2-1.8b
    reduced (k=1)."""
    qwen, intern = j_get_config("qwen2.5-3b").reduced(), j_get_config("internlm2-1.8b").reduced()
    j_server, t_server = build([(qwen, 3, 4, "vote", 0.5, 1.0), (intern, 1, 5, "confidence", -1.0, 25.0)])
    toks = np.random.default_rng(2).integers(0, 512, (8, 16)).astype(np.int32)
    run_both(j_server, t_server, "classify", toks)


@pytest.mark.parametrize("theta", [0.5, 0.0])
def test_generate_greedy(theta):
    j_server, t_server = build([(SMALL, 3, 6, "vote", theta, 1.0), (BIG, 1, 7, "confidence", -1.0, 25.0)])
    toks = np.random.default_rng(3).integers(0, 64, (6, 8)).astype(np.int32)
    run_both(j_server, t_server, "generate", toks, 4)


# ---------------------------------------------------------------------------
# deferral rules and cascade helpers, against the JAX package
# ---------------------------------------------------------------------------

from repro.core import deferral as j_deferral  # noqa: E402
from repro_torch.core import deferral as t_deferral  # noqa: E402


@pytest.mark.parametrize("rule", sorted(t_deferral.RULES))
def test_rules_match_jax(rule):
    rng = np.random.default_rng(11)
    if rule == "vote_preds":
        x = rng.integers(0, 4, (5, 40)).astype(np.int32)  # many vote ties
        theta = 0.5
    else:
        x = (rng.standard_normal((3, 40, 97)) * 3).astype(np.float32)
        x[:, :5, 50] = x[:, :5, 3] = 30.0  # argmax ties
        theta = 0.5
    got = t_deferral.apply_rule(rule, torch.from_numpy(x), theta)
    ref = j_deferral.apply_rule(rule, jnp.asarray(x), theta)
    np.testing.assert_array_equal(got.pred.numpy(), np.asarray(ref.pred))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), rtol=1e-5, atol=1e-6)
    s = np.asarray(ref.score)
    clear = np.abs(s - theta) > 1e-5  # defer decisions away from the threshold
    np.testing.assert_array_equal(got.defer.numpy()[clear], np.asarray(ref.defer)[clear])


@pytest.mark.parametrize("n", [0, 1, 7, 8, 13, 64, 100, 257, 1000])
def test_bucket_helpers_match_jax(n):
    for floor in (1, 8):
        assert t_cascade.bucket_size(n, floor) == j_cascade.bucket_size(n, floor)
        assert t_cascade.bucket_chunks(n, floor) == j_cascade.bucket_chunks(n, floor)
    assert t_cascade.prompt_chunks(n) == j_cascade.prompt_chunks(n)


def test_cascade_apply_dense_matches_jax():
    rng = np.random.default_rng(12)
    tiers = [(rng.standard_normal((3, 30, 20)) * 2).astype(np.float32), (rng.standard_normal((1, 30, 20)) * 2).astype(np.float32)]
    specs = [JTierSpec("a", "vote", 0.5, k=3), JTierSpec("b", "confidence", -1.0)]
    t_specs = [TierSpec("a", "vote", 0.5, k=3), TierSpec("b", "confidence", -1.0)]
    ref = j_cascade.cascade_apply_dense([lambda b, l=l: jnp.asarray(l) for l in tiers], specs, None)
    got = t_cascade.cascade_apply_dense([lambda b, l=l: torch.from_numpy(l) for l in tiers], t_specs, None)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)

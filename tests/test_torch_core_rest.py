"""The rest of ``core/`` and ``models/counting`` in the port against the JAX
package: ``calibration``, ``theory`` and ``cost_model`` (numpy copies)
give exactly the reference's values on seeded inputs; ``count_params``,
``active_param_count``, ``embedding_params`` and ``model_flops_per_token``
are exactly the reference's for the four ported configs at published
widths (the port reads its shapes from ``init_params`` on the ``meta``
device); ``train_router`` (gradient descent through ``torch.autograd``,
from its own generator's initial weights) scores within 1e-2 of the
reference's router on the same features — the loss is convex and both
start within 0.01 of zero, so the two runs of 300 steps end close but not
equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import get_config as j_get_config
from repro.core import calibration as j_calibration
from repro.core import cost_model as j_cost
from repro.core import router_baselines as j_router
from repro.core import theory as j_theory
from repro.models import counting as j_counting
from repro_torch.configs import get_config
from repro_torch.core import calibration, cost_model, router_baselines, theory
from repro_torch.models import counting

ARCHS = ("qwen2.5-3b", "internlm2-1.8b", "zamba2-2.7b", "rwkv6-7b")
ROUTER_TOL = 1e-2


def _labelled(seed, n=500):
    """Scores in [0, 1] that are informative about correctness."""
    rng = np.random.default_rng(seed)
    scores = rng.beta(2, 2, n)
    correct = rng.random(n) < 0.3 + 0.6 * scores
    return scores, correct


@pytest.mark.parametrize("seed", range(3))
def test_calibration_equals_jax(seed):
    scores, correct = _labelled(seed)
    for eps in (0.0, 0.02, 0.1):
        for theta in (-np.inf, 0.3, 0.5, 1.0):
            assert calibration.failure_rate(scores, correct, theta) == j_calibration.failure_rate(scores, correct, theta)
            assert calibration.selection_rate(scores, theta) == j_calibration.selection_rate(scores, theta)
        for n in (None, 100):
            assert calibration.estimate_threshold(scores, correct, eps, n_samples=n, seed=seed) == \
                j_calibration.estimate_threshold(scores, correct, eps, n_samples=n, seed=seed)
    assert calibration.threshold_stability_curve(scores, correct, 0.05, sample_sizes=(50, 100, 400, 800)) == \
        j_calibration.threshold_stability_curve(scores, correct, 0.05, sample_sizes=(50, 100, 400, 800))


@pytest.mark.parametrize("seed", range(3))
def test_theory_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 400
    y = rng.integers(0, 5, n)
    small = np.where(rng.random(n) < 0.7, y, rng.integers(0, 5, n))
    large = np.where(rng.random(n) < 0.9, y, rng.integers(0, 5, n))
    defer = rng.random(n) < 0.4
    assert theory.risk(small, y) == j_theory.risk(small, y)
    assert theory.cascade_risk_decomposition(small, large, defer, y) == \
        j_theory.cascade_risk_decomposition(small, large, defer, y)
    for fn in ("safe_rule_epsilon",):
        assert getattr(theory, fn)(small, defer, y) == getattr(j_theory, fn)(small, defer, y)
    for fn in ("excess_risk", "excess_risk_identity", "admissible"):
        assert getattr(theory, fn)(small, large, defer, y) == getattr(j_theory, fn)(small, large, defer, y)
    assert theory.excess_risk_identity(small, large, np.ones(n, bool), y) == 0.0


def test_cost_model_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        c0, gamma, rho, rate = rng.uniform(0.01, 2), rng.uniform(0.01, 0.5), rng.uniform(0, 1), rng.uniform(0, 1)
        k = int(rng.integers(1, 9))
        assert cost_model.ensemble_cost(c0, k, rho) == j_cost.ensemble_cost(c0, k, rho)
        assert cost_model.two_level_expected_cost(gamma, k, rho, rate, c0) == \
            j_cost.two_level_expected_cost(gamma, k, rho, rate, c0)
        assert cost_model.fraction_cost_saved(gamma, k, rho, rate) == j_cost.fraction_cost_saved(gamma, k, rho, rate)
        costs, ks, reach = rng.uniform(0, 5, 3).tolist(), rng.integers(1, 5, 3).tolist(), rng.uniform(0, 1, 3).tolist()
        assert cost_model.multi_tier_expected_cost(costs, ks, rho, reach) == \
            j_cost.multi_tier_expected_cost(costs, ks, rho, reach)
        fracs = rng.dirichlet(np.ones(2)).tolist()
        assert cost_model.gpu_rental_cost(["A6000", "H100"], fracs) == j_cost.gpu_rental_cost(["A6000", "H100"], fracs)
        prices = [j_cost.TOGETHER_PRICES[m] for m in j_cost.API_TIERS[1][:2]]
        assert cost_model.api_cost_per_query(prices, reach[:2], 700.0) == j_cost.api_cost_per_query(prices, reach[:2], 700.0)
        edge = cost_model.EdgeCloudCost(delay=float(rng.uniform(0, 1)))
        assert edge.mean_latency(rate, 0.01) == j_cost.EdgeCloudCost(delay=edge.delay).mean_latency(rate, 0.01)
    for name in ("LAMBDA_GPU_PRICES", "EDGE_DELAYS", "TOGETHER_PRICES", "API_TIERS"):
        assert getattr(cost_model, name) == getattr(j_cost, name), name
    assert not hasattr(cost_model, "TPU_V5E")  # no TPU figure enters the port


@pytest.mark.parametrize("arch", ARCHS)
def test_counting_equals_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert counting.count_params(cfg) == j_counting.count_params(jcfg) == cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert counting.embedding_params(cfg) == j_counting.embedding_params(jcfg)
    assert counting.model_flops_per_token(cfg) == j_counting.model_flops_per_token(jcfg) > 0
    red = cfg.reduced()
    assert counting.count_params(red) == j_counting.count_params(jcfg.reduced())


@pytest.mark.parametrize("seed", range(2))
def test_router_within_tolerance_of_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(400, 32)) * rng.uniform(0.5, 3, (400, 1))).astype(np.float32)
    y = rng.integers(0, 32, 400)
    feats = router_baselines.logits_features(torch.as_tensor(logits)).numpy()
    j_feats = np.asarray(j_router.logits_features(jnp.asarray(logits)))
    np.testing.assert_allclose(feats, j_feats, rtol=1e-5, atol=1e-5)
    correct = (logits.argmax(-1) == y) | (rng.random(400) < 2 * j_feats[:, 0])
    router = router_baselines.train_router(j_feats, correct, seed=seed, device="cpu")
    ref = j_router.train_router(j_feats, correct, seed=seed)
    assert float(router.w.abs().max()) > 0.1  # it trained
    s = router.score(torch.as_tensor(np.array(j_feats))).numpy()
    s_ref = np.asarray(ref.score(jnp.asarray(j_feats)))
    assert np.abs(s - s_ref).max() <= ROUTER_TOL
    out = router_baselines.router_rule(router, torch.as_tensor(logits)[None], 0.5)
    j_out = j_router.router_rule(ref, jnp.asarray(logits)[None], 0.5)
    np.testing.assert_array_equal(out.pred.numpy(), np.asarray(j_out.pred))
    clear = np.abs(s_ref - 0.5) > ROUTER_TOL  # away from the threshold the rules agree
    np.testing.assert_array_equal(out.defer.numpy()[clear], np.asarray(j_out.defer)[clear])

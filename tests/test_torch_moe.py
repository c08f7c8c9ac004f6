"""The MoE block of the port (``repro_torch.models.layers.apply_moe``)
against the JAX package's ``repro.models.layers.apply_moe`` on the same
numpy weights and inputs, float32.  Outputs agree normwise: max |port -
jax| <= 1e-5 * max |jax| (f32 products summed in different orders).  The
discrete routing agrees exactly: each token's experts in ``lax.top_k``'s
order, each choice's position in its expert's buffer and which choices
are dropped.  Member-stacked inputs (E, B, S, D) route each member's
tokens on their own, as the JAX package's ``vmap`` over members does."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import layers as j_layers
from repro_torch.configs import ModelConfig
from repro_torch.models import layers as t_layers

NORM_TOL = 1e-5

TOP2 = JModelConfig(
    name="moe-top2", family="moe", n_layers=1, d_model=32, d_ff=48, vocab_size=64,
    n_heads=4, n_kv_heads=2, n_experts=4, top_k=2, dtype="float32", remat=False,
)
TOP1_SHARED = dataclasses.replace(TOP2, name="moe-top1-shared", top_k=1, n_shared_experts=1)
CONFIGS = {"top2": TOP2, "top1_shared": TOP1_SHARED}

j_apply_moe = jax.jit(j_layers.apply_moe, static_argnames=("cfg",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the module runs (restored after): these
    small models gain nothing from more, and under xdist the workers'
    thread pools otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def moe_weights(cfg, seed, E=None, *, favour=None, tie=False):
    """MoE parameters as numpy f32, with a leading member axis when ``E``.
    ``favour`` adds a bias towards one expert (with positive inputs every
    token picks it first: capacity drops; small enough that the other
    probabilities stay far from f32's subnormals, where XLA flushes to
    zero and would make ties the port does not see); ``tie`` makes router columns 1 and 3 copies of
    0 and 2, so pairs of experts have exactly equal probabilities."""
    rng = np.random.default_rng(seed)
    d, f, n = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = () if E is None else (E,)
    w = lambda *s: (rng.standard_normal(lead + s) / np.sqrt(s[-2])).astype(np.float32)
    p = {"router": w(d, n), "w_gate": w(n, d, f), "w_up": w(n, d, f), "w_down": w(n, f, d)}
    if favour is not None:
        p["router"][..., favour] += 0.3
    if tie:
        p["router"][..., 1] = p["router"][..., 0]
        p["router"][..., 3] = p["router"][..., 2]
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": w(d, fs), "w_up": w(d, fs), "w_down": w(fs, d)}
    return p


def _inputs(cfg, shape, seed, *, favour_rows=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if favour_rows:  # positive mean along d: a router bias column then wins
        x = np.abs(x)
    return x


def _torch(tree, one=True):
    """numpy leaves -> tensors; ``one``: a single model's, given the member
    axis of one (the port's functions take (E, ...) parameters)."""
    return {k: _torch(v, one) if isinstance(v, dict) else torch.from_numpy(v)[None] if one else torch.from_numpy(v)
            for k, v in tree.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= NORM_TOL * scale, (err, scale)


def _jax_route(p, x, cfg):
    """The routing lines of the JAX package's ``apply_moe``, on one
    member's (B, S, D): (experts (T, K), positions (T, K), capacity)."""
    B, S, D = x.shape
    T, n, K = B * S, cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(jnp.asarray(x).reshape(T, D) @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    oh = jax.nn.one_hot(idx, n, dtype=jnp.int32).reshape(T * K, n)
    pos = ((jnp.cumsum(oh, axis=0) - oh) * oh).sum(-1).reshape(T, K)
    if S == 1:
        cap = min(T, max(8, int(math.ceil(T * K / n * 2.0))))
    else:
        cap = max(1, int(math.ceil(T * K / n * cfg.capacity_factor)))
    return np.asarray(idx), np.asarray(pos), cap


def _port_route(p, x, cfg):
    B, S, D = x.shape
    _, expert, pos, cap = t_layers.moe_route(_torch(p), torch.from_numpy(x).reshape(1, B * S, D), S, _tcfg(cfg))
    return expert[0].numpy(), pos[0].reshape(B * S, cfg.top_k).numpy(), cap


# (B, S, favour): a prefill with the default capacity factor 1.25, one
# where every token prefers expert 0 (drops), and decode steps (S == 1,
# the 2x-slack capacity) with and without drops
CASES = {
    "prefill": (2, 16, None),
    "prefill_drops": (2, 16, 0),
    "decode": (24, 1, None),
    "decode_drops": (16, 1, 0),
}


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(cfg_name, case):
    cfg = CONFIGS[cfg_name]
    B, S, favour = CASES[case]
    p = moe_weights(cfg, seed=1, favour=favour)
    x = _inputs(cfg, (B, S, cfg.d_model), seed=2, favour_rows=favour is not None)
    j_idx, j_pos, j_cap = _jax_route(p, x, cfg)
    t_idx, t_pos, t_cap = _port_route(p, x, cfg)
    assert t_cap == j_cap
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_pos, j_pos)
    dropped = int((j_pos >= j_cap).sum())
    # a decode step's capacity is T for top-2 of 4 experts: nothing can drop
    can_drop = j_cap < B * S
    if favour is not None and can_drop:
        assert dropped > 0, "the case should drop choices"
    elif case.startswith("decode"):
        assert dropped == 0 or can_drop
    ref, _ = j_apply_moe(_jax(p), jnp.asarray(x), cfg=cfg)
    got = t_layers.apply_moe(_torch(p), torch.from_numpy(x)[None], _tcfg(cfg))[0]
    _close(got.numpy(), ref)


@pytest.mark.parametrize("cfg_name,S", [("top2", 16), ("top1_shared", 1)])
def test_member_stacked_routes_each_member_alone(cfg_name, S):
    """(E, B, S, D) against a loop of single-member JAX calls: capacity and
    the running counts are per member (T = B * S of one member), so the
    drops are each member's own."""
    cfg, E = CONFIGS[cfg_name], 3
    B = 2 if S > 1 else 16
    p = moe_weights(cfg, seed=3, E=E, favour=0)
    x = _inputs(cfg, (E, B, S, cfg.d_model), seed=4, favour_rows=True)
    got = t_layers.apply_moe(_torch(p, one=False), torch.from_numpy(x), _tcfg(cfg))
    for e in range(E):
        pe = jax.tree.map(lambda t: t[e], p)
        ref, _ = j_apply_moe(_jax(pe), jnp.asarray(x[e]), cfg=cfg)
        _close(got[e].numpy(), ref)
        _, j_pos, j_cap = _jax_route(pe, x[e], cfg)
        assert (j_pos >= j_cap).any(), "each member should drop on its own"


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_tied_router_probabilities(cfg_name):
    """Experts 0 and 1 (and 2 and 3) have bitwise equal probabilities: the
    lower index comes first, as ``lax.top_k`` orders ties."""
    cfg = CONFIGS[cfg_name]
    p = moe_weights(cfg, seed=5, tie=True)
    x = _inputs(cfg, (2, 8, cfg.d_model), seed=6)
    j_idx, j_pos, _ = _jax_route(p, x, cfg)
    t_idx, t_pos, _ = _port_route(p, x, cfg)
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_pos, j_pos)
    assert set(np.unique(j_idx[:, 0])) <= {0, 2}  # of a tied pair, the lower index first
    if cfg.top_k == 2:
        np.testing.assert_array_equal(j_idx[:, 1], j_idx[:, 0] + 1)
    ref, _ = j_apply_moe(_jax(p), jnp.asarray(x), cfg=cfg)
    _close(t_layers.apply_moe(_torch(p), torch.from_numpy(x)[None], _tcfg(cfg))[0].numpy(), ref)


def test_top_k_first_order():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25], [0.1, 0.0, 0.6, 0.3]])
    vals, idx = t_layers.top_k_first(probs, 3)
    j_vals, j_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))


def test_moe_capacity_rule():
    cfg = _tcfg(TOP2)
    for T, S in ((32, 16), (7, 7), (1, 1), (8, 1), (100, 1), (3000, 1), (5, 5)):
        n, K = cfg.n_experts, cfg.top_k
        want = (min(T, max(8, math.ceil(T * K / n * 2.0))) if S == 1
                else max(1, math.ceil(T * K / n * cfg.capacity_factor)))
        assert t_layers.moe_capacity(T, S, cfg) == want

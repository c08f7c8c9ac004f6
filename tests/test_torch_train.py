"""The port's training path against the JAX package's on the CPU, on the
same weights (numpy-seeded, carried by ``bridge``) and the same numpy
batches: ``_chunked_ce`` and ``loss_fn`` in float32 within 1e-5 relative
(TINY, mixtral-8x22b reduced with its load-balancing term, internvl2-26b
reduced with its vision prefix); the flash gradient (the port's
``FlashAttention`` against the JAX package's ``_flash_diff`` custom VJP)
within 1e-5 of the largest gradient; one f32 train step's gradients within
1e-4 normwise and the parameters after 3 steps within 1e-4; the loss of
all ten reduced configs in bf16 within 2e-2 of the JAX ``loss_fn``; the
bf16 gradients of six reduced configs within rounding of the JAX
package's, and the gradient's growth with depth (qwen2.5-3b's 36 layers at
d 512) in both.  Each JAX reference is computed once per module.  Also the port's own training:
TINY learns a bigram task in 60 steps, remat and the MoE router's gradient,
``input_specs``/``make_inputs`` and the train CLI on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels.flash_attention import ops as j_flash
from repro.models import api as j_api
from repro.optim.adamw import OptimConfig as JOptimConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import kernels
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, ModelConfig, ShapeConfig, get_config
from repro_torch.data import TokenDataset, batches
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.models import api as t_api
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import OptimConfig
from repro_torch.train import init_train_state, make_train_step, train_loop
from test_torch_models import numpy_values

LOSS_TOL = 1e-5  # relative, float32
FLASH_GRAD_TOL = 1e-5  # of the largest gradient, float32
STEP_TOL = 1e-4  # normwise, float32
BF16_LOSS_TOL = 2e-2  # relative, bf16 loss
# the 3-step comparison's AdamW epsilon: with the default 1e-8 the first
# updates are about lr * sign(g), so an element whose gradient is near zero
# steps either way on a 1e-5 difference between the packages; at 1e-2 the
# update is continuous in g (the arithmetic is the same code path)
ADAM_EPS = 1e-2

TINY = JModelConfig(name="tiny", family="dense", n_layers=2, d_model=64, d_ff=128, vocab_size=128, n_heads=4,
                    n_kv_heads=2, remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _batch(cfg, B=2, S=16, seed=0):
    """numpy batch: tokens (or the encoder's frames), targets, a mask with
    a few zeros, the VLM's patches."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder:
        batch = {"embeds": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
        if cfg.n_vision_tokens:
            batch["embeds"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.frontend_dim)).astype(np.float32)
    batch["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, :3] = 0.0
    batch["mask"] = mask
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def _normwise(got, ref):
    """max |got - ref| / max |ref| over every leaf of two trees, by path."""
    g, r = _flat(got), _flat(ref)
    assert g.keys() == r.keys()
    num = max(float(np.abs(np.asarray(g[k], np.float32) - np.asarray(r[k], np.float32)).max()) for k in g)
    return num / max(float(np.abs(np.asarray(r[k], np.float32)).max()) for k in r)


F32_CFGS = {
    "tiny": dataclasses.replace(TINY, dtype="float32"),
    "mixtral-8x22b": dataclasses.replace(j_get_config("mixtral-8x22b").reduced(), dtype="float32"),
    "internvl2-26b": dataclasses.replace(j_get_config("internvl2-26b").reduced(), dtype="float32"),
}


@pytest.fixture(scope="module", params=list(F32_CFGS))
def f32_model(request):
    """(cfg, numpy weights, batch, the JAX loss and metrics, the JAX
    chunked CE on the final hidden): the references, once."""
    cfg = F32_CFGS[request.param]
    host = numpy_values(cfg, seed=3)
    batch = _batch(cfg, seed=1)
    values = jax.tree.map(jnp.asarray, host)
    loss, metrics = j_api.loss_fn(values, _j(batch), cfg)
    hidden = np.random.default_rng(2).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    ce = j_api._chunked_ce(values, jnp.asarray(hidden), jnp.asarray(np.resize(batch["targets"], (2, 40))),
                           jnp.asarray(np.resize(batch["mask"], (2, 40))), cfg, chunk=16)
    return cfg, host, batch, (float(loss), {k: float(v) for k, v in metrics.items()}), hidden, [float(x) for x in ce]


def test_loss_fn_matches_jax_f32(f32_model):
    cfg, host, batch, (ref_loss, ref_m), _, _ = f32_model
    loss, m = t_api.loss_fn(params_from_numpy(host, _tcfg(cfg), device="cpu"), batch, _tcfg(cfg))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=LOSS_TOL)
    for k in ("ce", "z_loss", "acc", "aux"):
        np.testing.assert_allclose(float(m[k]), ref_m[k], rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    if cfg.family == "moe":
        assert ref_m["aux"] > 0


def test_chunked_ce_matches_jax_f32(f32_model):
    """Chunks of 16 over S 40 halve to 8 (the VLM's text-length rule)."""
    cfg, host, batch, _, hidden, ref = f32_model
    params = params_from_numpy(host, _tcfg(cfg), device="cpu")
    got = t_api._chunked_ce(params, torch.from_numpy(hidden), torch.from_numpy(np.resize(batch["targets"], (2, 40))).long(),
                            torch.from_numpy(np.resize(batch["mask"], (2, 40))), _tcfg(cfg), chunk=16)
    np.testing.assert_allclose([float(x) for x in got], ref, rtol=LOSS_TOL, atol=1e-7)


FLASH_CASES = {
    "causal": dict(causal=True, window=None, softcap=None),
    "window": dict(causal=True, window=24, softcap=None),
    "softcap": dict(causal=True, window=None, softcap=5.0),
    "noncausal_window_softcap": dict(causal=False, window=16, softcap=3.0),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_gradient_matches_custom_vjp(case):
    """G 2 (4 heads on 2 KV heads), S 64 in one query block, f32."""
    kw = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    B, S, H, KVH, hd = 2, 64, 4, 2, 16
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd), (B, S, H, hd)))
    ref = jax.grad(lambda q, k, v: jnp.sum(j_flash._flash_diff(q, k, v, kw["causal"], kw["window"], kw["softcap"]) * do),
                   argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = t_flash.flash_attention(*leaves, **kw)
    out.backward(torch.from_numpy(do))
    for t, r in zip(leaves, ref):
        r = np.asarray(r)
        assert np.abs(t.grad.numpy() - r).max() <= FLASH_GRAD_TOL * np.abs(r).max()


def test_flash_backward_blocks_and_lse():
    """The backward's query blocks (S 600: one block of 512, then a ragged
    one of 88) give autograd's gradients through the plain version's whole
    (Sq, Sk) softmax, and the plain lse is the row's logsumexp of its
    masked, scaled scores."""
    S = 600
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((1, S, 4, 16), (1, S, 2, 16), (1, S, 2, 16), (1, S, 4, 16)))
    out, lse = t_flash.flash_attention_plain(q, k, v, causal=True, window=20, return_lse=True)
    assert S > t_flash.BWD_BLOCK_Q and S % t_flash.BWD_BLOCK_Q
    blocks = t_flash.flash_attention_bwd(q, k, v, out, lse, do, causal=True, window=20)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    whole = torch.autograd.grad(t_flash.flash_attention_plain(*leaves, causal=True, window=20), leaves, do)
    for a, b in zip(blocks, whole):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / 4.0
    rows, cols = torch.arange(S)[:, None], torch.arange(S)[None, :]
    s = s.masked_fill(~((cols <= rows) & (rows - cols < 20)), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).permute(0, 2, 1), rtol=1e-5, atol=1e-5)


def test_flash_starts_under_grad_raises():
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="starts"):
        t_flash.flash_attention(q, q.detach(), q.detach(), starts=torch.zeros(1, dtype=torch.int32))


def _tiny_case():
    cfg = dataclasses.replace(TINY, dtype="float32")
    return cfg, numpy_values(cfg, seed=5), [_batch(cfg, B=4, S=16, seed=10 + i) for i in range(3)]


@pytest.fixture(scope="module")
def tiny_grads():
    """The JAX package's f32 gradients of TINY's loss on the first batch."""
    cfg, host, bs = _tiny_case()
    return cfg, host, bs, jax.grad(lambda p: j_api.loss_fn(p, _j(bs[0]), cfg)[0])(jax.tree.map(jnp.asarray, host))


@pytest.fixture(scope="module")
def tiny_steps():
    """Three f32 train steps of TINY in the JAX package: the parameters
    after the third and every step's metrics."""
    cfg, host, bs = _tiny_case()
    ocfg = JOptimConfig(lr=1e-2, eps=ADAM_EPS)
    state = j_init_train_state(jax.tree.map(jnp.asarray, host), ocfg)
    step = jax.jit(j_make_train_step(cfg, ocfg, total_steps=10, warmup_steps=2))
    metrics = []
    for b in bs:
        state, m = step(state, _j(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return cfg, host, bs, state.params, metrics


def test_train_step_gradients_match_jax_f32(tiny_grads):
    cfg, host, bs, ref_grads = tiny_grads
    params = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(host, _tcfg(cfg), device="cpu"))
    t_api.loss_fn(params, bs[0], _tcfg(cfg))[0].backward()
    assert _normwise(tree_map(lambda t: t.grad.numpy(), params), ref_grads) <= STEP_TOL


def test_three_train_steps_match_jax_f32(tiny_steps):
    cfg, host, bs, ref_params, ref_metrics = tiny_steps
    ocfg = OptimConfig(lr=1e-2, eps=ADAM_EPS)
    state = init_train_state(params_from_numpy(host, _tcfg(cfg), device="cpu"), ocfg)
    step = make_train_step(_tcfg(cfg), ocfg, total_steps=10, warmup_steps=2)
    for b, ref in zip(bs, ref_metrics):
        state, m = step(state, b)
        assert m.keys() == ref.keys()
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), ref[k], rtol=STEP_TOL, err_msg=k)
        assert int(m["step"]) == int(ref["step"])
    assert int(state.step) == 3
    assert _normwise(tree_map(lambda t: t.numpy(), state.params), ref_params) <= STEP_TOL


def test_loss_decreases():
    """Next = prev + 1 (mod V): bigram structure a 2-layer model must learn
    within 60 steps (the JAX package's ``test_loss_decreases`` on the port,
    from the port's own seeded weights)."""
    cfg = _tcfg(TINY)
    ocfg = OptimConfig(lr=3e-3)
    state = init_train_state(t_api.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), ocfg)
    step = make_train_step(cfg, ocfg, total_steps=60, warmup_steps=5)
    rng = np.random.default_rng(0)
    rows = ((rng.integers(0, 128, (512, 1)) + np.arange(33)) % 128).astype(np.int32)
    kernels.reset_launch_counts()
    state, hist = train_loop(step, state, batches(TokenDataset(rows), 16), steps=60, log_every=1,
                             log_fn=lambda *_: None)
    losses = [h["loss"] for h in hist]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 1.0, losses[::10]
    assert kernels.launch_counts() == {n: 0 for n in kernels.launch_counts()}  # the CPU step launches no kernel


@pytest.fixture(scope="module", params=ARCH_IDS)
def bf16_case(request):
    """The JAX ``loss_fn`` of one reduced config in bf16 (its own compile),
    on numpy weights and one numpy batch."""
    cfg = j_get_config(request.param).reduced()
    host = numpy_values(cfg, seed=7)
    batch = _batch(cfg, B=2, S=16, seed=3)
    loss = jax.jit(j_api.loss_fn, static_argnames="cfg")(jax.tree.map(jnp.asarray, host), _j(batch), cfg=cfg)[0]
    return request.param, cfg, host, batch, float(loss)


def test_every_reduced_config_takes_a_train_step(bf16_case):
    arch, jcfg, host, batch, ref = bf16_case
    cfg = get_config(arch).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ocfg = OptimConfig()
    state = init_train_state(params_from_numpy(host, cfg, device="cpu"), ocfg)
    before = [t.clone() for t in tree_leaves(state.params)]
    state, m = make_train_step(cfg, ocfg, total_steps=10, warmup_steps=1)(state, batch)
    assert np.isfinite(float(m["loss"])) and 0.0 <= float(m["acc"]) <= 1.0
    assert abs(float(m["loss"]) - ref) <= BF16_LOSS_TOL * abs(ref)
    assert (float(m["aux"]) > 0) == (cfg.family == "moe")
    moved = [not torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params))]
    assert all(moved), "every leaf moves (weight decay reaches norms too)"


# the rule chip_smoke.py holds the card's first-step gradient to against
# the CPU's (relative L2 per leaf): at most GRAD_FACTOR times the leaf's own
# bf16-vs-f32 distance, in [GRAD_FLOOR, GRAD_CAP)
GRAD_FACTOR, GRAD_FLOOR, GRAD_CAP = 3.0, 0.1, 0.9
GRAD_NORM_TOL = 0.25  # relative, bf16 grad_norm
F32_GRAD_TOL = 5e-3  # relative L2 per leaf, f32 (reduced configs, B 2 x S 64)
TRAIN_ARCHS = ("qwen2.5-3b", "mixtral-8x22b", "zamba2-2.7b", "rwkv6-7b", "internvl2-26b", "hubert-xlarge")


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _lm_batch(cfg, B, S, seed):
    """chip_smoke.py's ``train_batch``: next-token targets, no mask (the
    encoder's frames in place of tokens; the VLM's patches before them)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder:
        return {"embeds": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    rows = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:], "mask": np.ones((B, S), np.float32)}
    if cfg.n_vision_tokens:
        batch["embeds"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _grads_both(arch, host, batch, dtype, **over):
    """{path: gradient} of the port's and the JAX package's loss on the same
    weights ``host`` (the port's tree as numpy), in ``dtype``."""
    from repro_torch.bridge import params_to_numpy

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **over)
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype, **over)
    cast = (lambda a: np.asarray(a, np.float32)) if dtype == "float32" else (lambda a: a)
    params = tree_map(lambda t: (t.float() if dtype == "float32" else t).requires_grad_(True),
                      params_from_numpy(jax.tree.map(cast, host), cfg, device="cpu"))
    t_api.loss_fn(params, batch, cfg)[0].backward()
    got = _flat(params_to_numpy(tree_map(lambda t: t.grad, params)))
    ref = jax.jit(jax.grad(lambda p: j_api.loss_fn(p, _j(batch), jcfg)[0]))(jax.tree.map(lambda a: jnp.asarray(cast(a)), host))
    return got, {k: np.asarray(v, np.float32) for k, v in _flat(ref).items()}


def _port_weights(arch, seed=0, **over):
    from repro_torch.bridge import params_to_numpy

    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return cfg, params_to_numpy(t_api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu"))


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_gradients_within_rounding_of_jax(arch):
    """chip_smoke.py phase 3's weights and batch (the port's init, seed 0;
    B 2 x S 64): in f32 the port's gradient is the JAX package's; in bf16
    the two sit apart by rounding alone, within the rule the card is held
    to, and each package's bf16 gradient is as far from its own f32 one as
    the other's (the spread belongs to the model, not to the port)."""
    cfg, host = _port_weights(arch)
    batch = _lm_batch(cfg, 2, 64, seed=5)
    t32, j32 = _grads_both(arch, host, batch, "float32")
    t16, j16 = _grads_both(arch, host, batch, "bfloat16")
    assert t32.keys() == j32.keys() == t16.keys() == j16.keys()
    for k in t32:
        assert _rel_l2(t32[k], j32[k]) <= F32_GRAD_TOL, k
        rounding = _rel_l2(t16[k], t32[k])
        assert _rel_l2(t16[k], j16[k]) <= min(GRAD_CAP, max(GRAD_FLOOR, GRAD_FACTOR * rounding)), k
    cat = lambda d: np.concatenate([np.ravel(d[k]) for k in sorted(d)])
    spread_t, spread_j = _rel_l2(cat(t16), cat(t32)), _rel_l2(cat(j16), cat(j32))
    assert 0.5 <= spread_j / spread_t <= 2.0, (spread_t, spread_j)
    assert _rel_l2(cat(t16), cat(j16)) <= min(GRAD_CAP, max(GRAD_FLOOR, GRAD_FACTOR * spread_t))
    gn_t, gn_j = np.linalg.norm(cat(t16)), np.linalg.norm(cat(j16))
    assert abs(gn_t - gn_j) <= GRAD_NORM_TOL * gn_j


def test_deep_gradient_explodes_in_both_packages():
    """qwen2.5-3b's 36 layers at d 512 (chip_smoke.py's deep witness): under
    the reference's init the gradient's norm grows by orders of magnitude
    with depth in the JAX package as in the port (the first-step grad_norm
    is below 1e3 at 1 layer in f32 and at least 1e9 at 36 in bf16).  Each layer
    amplifies the rounding too, so at this depth the packages agree in size
    (within 3 decades, as the card is held to the CPU), not in value; at 1
    layer they agree within 1e-3 in f32."""
    deep = dict(d_model=512, d_ff=1024, n_heads=8)
    for layers, dtype in ((1, "float32"), (36, "bfloat16")):
        cfg, host = _port_weights("qwen2.5-3b", n_layers=layers, **deep)
        batch = _lm_batch(cfg, 2, 64, seed=5)
        t, j = _grads_both("qwen2.5-3b", host, batch, dtype, n_layers=layers, **deep)
        gn_t = float(np.sqrt(sum(np.square(v, dtype=np.float64).sum() for v in t.values())))
        gn_j = float(np.sqrt(sum(np.square(v, dtype=np.float64).sum() for v in j.values())))
        assert np.isfinite(gn_t) and np.isfinite(gn_j)
        if layers == 1:
            assert max(_rel_l2(t[k], j[k]) for k in t) <= 1e-3
            assert gn_t < 1e3 and gn_j < 1e3, (gn_t, gn_j)
        else:
            assert gn_t >= 1e9 and gn_j >= 1e9, (gn_t, gn_j)
            assert abs(np.log10(gn_t / gn_j)) <= 3.0, (gn_t, gn_j)


def test_remat_changes_nothing_computed():
    """``cfg.remat`` recomputes each layer in the backward: the same loss
    and gradients as without, through the hybrid's shared block too."""
    base = get_config("zamba2-2.7b").reduced()
    batch = _batch(base, S=12, seed=4)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, dtype="float32")
        params = tree_map(lambda t: t.float().requires_grad_(True),
                          t_api.init_params(cfg, torch.Generator().manual_seed(1), "cpu"))
        loss, _ = t_api.loss_fn(params, batch, cfg)
        loss.backward()
        out.append((loss.item(), [t.grad for t in tree_leaves(params)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_moe_router_gradient_flows_through_gates_and_aux():
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(), dtype="float32")
    params = tree_map(lambda t: t.float().requires_grad_(True),
                      t_api.init_params(cfg, torch.Generator().manual_seed(2), "cpu"))
    loss, m = t_api.loss_fn(params, _batch(cfg, seed=5), cfg)
    g_ce = torch.autograd.grad(m["ce"], params["layers"]["moe"]["router"], retain_graph=True)[0]
    g_aux = torch.autograd.grad(m["aux"], params["layers"]["moe"]["router"])[0]
    assert g_ce.abs().max() > 0 and g_aux.abs().max() > 0
    # serving never computes the term: apply_moe returns the output alone
    from repro_torch.models import layers as L
    x = torch.randn(1, 2, 5, cfg.d_model)
    lp = tree_map(lambda t: t[:, 0].detach(), t_api._members(params)["layers"])
    assert isinstance(L.apply_moe(lp["moe"], x, cfg), torch.Tensor)


def test_window_override_matches_jax():
    cfg = dataclasses.replace(TINY, dtype="float32")
    host = numpy_values(cfg, seed=6)
    batch = _batch(cfg, seed=6)
    ref = float(j_api.loss_fn(jax.tree.map(jnp.asarray, host), _j(batch), cfg, window_override=4)[0])
    got, _ = t_api.loss_fn(params_from_numpy(host, _tcfg(cfg), device="cpu"), batch, _tcfg(cfg), window_override=4)
    np.testing.assert_allclose(float(got), ref, rtol=LOSS_TOL)
    full, _ = t_api.loss_fn(params_from_numpy(host, _tcfg(cfg), device="cpu"), batch, _tcfg(cfg))
    assert float(full) != float(got)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_jax(kind):
    shape = ShapeConfig(kind, 32, 2, kind)
    for arch in ARCH_IDS:
        jcfg = j_get_config(arch).reduced()
        if kind == "decode" and jcfg.is_encoder:
            continue
        cfg = get_config(arch).reduced()
        ref = j_api.input_specs(jcfg, JShapeConfig(kind, 32, 2, kind))
        got = t_api.input_specs(cfg, shape)
        assert got.keys() == ref.keys()
        inputs = t_api.make_inputs(cfg, shape, torch.Generator().manual_seed(0), "cpu")
        for name, s in ref.items():
            assert got[name].shape == tuple(s.shape)
            assert str(got[name].dtype).split(".")[-1] == jnp.dtype(s.dtype).name
            assert inputs[name].shape == tuple(s.shape) and inputs[name].dtype == got[name].dtype
        if "tokens" in inputs:
            assert int(inputs["tokens"].max()) < cfg.vocab_size


def test_train_cli_on_cpu(tmp_path, capsys):
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train

    hist = train.main(["--arch", "hubert-xlarge", "--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
                       "--n-examples", "8", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert np.isfinite(hist[-1]["loss"]) and latest_step(str(tmp_path)) == 2
    assert "final loss" in capsys.readouterr().out


def test_train_cli_needs_a_gpu_or_cpu_flag(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen2.5-3b", "--reduced", "--steps", "1"])

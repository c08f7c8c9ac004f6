"""Dense-model parity: ``prefill``, ``decode_step`` and ``forward_logits``
of the port against the JAX package (``impl='xla'``) on the same bridged
float32 weights and the same numpy token ids.  Float outputs agree
normwise: max |port - jax| <= 1e-4 * max |jax| (f32 sums taken in
different orders through many layers of random weights); greedy ids are
equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import ensemble as j_ens
from repro.models import api as j_api
from repro.models.params import unbox
from repro.serve.engine import grow_cache as j_grow_cache
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import ensemble as t_ens
from repro_torch.models import api as t_api
from repro_torch.serve.engine import grow_cache as t_grow_cache

NORM_TOL = 1e-4

# the JAX side runs jitted: op-by-op dispatch of the layer scans is slow
j_prefill = jax.jit(j_api.prefill, static_argnames=("cfg",))
j_decode_step = jax.jit(j_api.decode_step, static_argnames=("cfg",))
j_forward_logits = jax.jit(j_api.forward_logits, static_argnames=("cfg",))

SMALL = JModelConfig(
    name="tiny-s", family="dense", n_layers=2, d_model=64, d_ff=128,
    vocab_size=64, n_heads=4, n_kv_heads=2, remat=False,
)
BIG = JModelConfig(
    name="tiny-b", family="dense", n_layers=3, d_model=96, d_ff=192,
    vocab_size=64, n_heads=4, n_kv_heads=4, remat=False,
)
CONFIGS = {
    "small": SMALL,
    "big": BIG,
    "qwen2.5-3b-reduced": j_get_config("qwen2.5-3b").reduced(),
    "internlm2-1.8b-reduced": j_get_config("internlm2-1.8b").reduced(),
}


def numpy_values(cfg, seed, k=None):
    """A values tree with the JAX package's structure, shapes and dtypes
    (from ``jax.eval_shape`` of its init), filled from a numpy seed: weights
    N(0, 1/sqrt(fan_in)), embed/head N(0, 0.02), norm scales near one and
    biases non-zero so the bias paths are exercised."""
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


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    cfg = dataclasses.replace(CONFIGS[request.param], dtype="float32")
    np_values = numpy_values(cfg, seed=3)
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tparams = params_from_numpy(np_values, tcfg, device="cpu")
    return cfg, jax.tree.map(jnp.asarray, np_values), tcfg, tparams


def _batch(cfg, B=3, S=12, padded=False, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if padded:
        batch["starts"] = np.array([0, 5, 9][:B], np.int32)
    return batch


def _close(got, ref):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= NORM_TOL * scale, (err, scale)


@pytest.mark.parametrize("padded", [False, True])
def test_forward_logits(model, padded):
    cfg, values, tcfg, tparams = model
    batch = _batch(cfg, padded=padded)
    _close(t_api.forward_logits(tparams, batch, tcfg), j_forward_logits(values, {k: jnp.asarray(v) for k, v in batch.items()}, cfg=cfg))


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_then_decode(model, padded):
    cfg, values, tcfg, tparams = model
    batch = _batch(cfg, padded=padded, seed=1)
    S, n_new = batch["tokens"].shape[1], 3
    j_logits, j_cache = j_prefill(values, {k: jnp.asarray(v) for k, v in batch.items()}, cfg=cfg)
    t_logits, t_cache = t_api.prefill(tparams, batch, tcfg)
    _close(t_logits, j_logits)
    for name in ("k", "v"):  # same (L, B, KVH, S, hd) layout
        _close(t_cache[name], j_cache[name])
    j_cache = j_grow_cache(j_cache, n_new, cfg)
    t_cache = t_grow_cache(t_cache, n_new, tcfg)
    starts = batch.get("starts")
    for t in range(n_new):
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(t_logits.argmax(-1).numpy(), tok[:, 0])
        j_logits, j_cache = j_decode_step(
            values, jnp.asarray(tok), j_cache, jnp.int32(S + t), cfg=cfg,
            starts=None if starts is None else jnp.asarray(starts),
        )
        t_logits, t_cache = t_api.decode_step(
            tparams, torch.from_numpy(tok), t_cache, S + t, tcfg,
            starts=None if starts is None else torch.from_numpy(starts),
        )
        _close(t_logits, j_logits)


def test_ensemble_prefill_and_decode_members():
    """E explicit: the stacked 3-member prefill/decode equals the JAX vmapped
    ensemble (member caches are layer-major in the port)."""
    cfg = dataclasses.replace(j_get_config("qwen2.5-3b").reduced(), dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    np_values = numpy_values(cfg, seed=4, k=3)
    values = jax.tree.map(jnp.asarray, np_values)
    tvals = params_from_numpy(np_values, tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    j_logits, j_caches = jax.jit(j_ens.ensemble_prefill, static_argnames=("cfg",))(
        values, {"tokens": jnp.asarray(toks)}, cfg=cfg)
    t_logits, t_caches = t_ens.ensemble_prefill(tvals, {"tokens": toks}, tcfg)
    _close(t_logits, j_logits)
    _close(t_caches["k"].transpose(0, 1), j_caches["k"])
    _close(t_ens.ensemble_last_logits(tvals, {"tokens": toks}, tcfg), j_logits)
    j_caches = j_grow_cache(j_caches, 1, cfg, lead=1)
    t_caches = t_grow_cache(t_caches, 1, tcfg)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[..., None]
    j_out, _ = jax.jit(j_ens.ensemble_decode_step, static_argnames=("cfg",))(
        values, jnp.asarray(tok), j_caches, jnp.int32(10), cfg=cfg)
    t_out, _ = t_ens.ensemble_decode_step(tvals, torch.from_numpy(tok), t_caches, 10, tcfg)
    _close(t_out, j_out)


def test_init_cache_matches_jax_layout(model):
    cfg, _, tcfg, _ = model
    ref = j_api.init_cache(cfg, 3, 20)
    got = t_api.init_cache(tcfg, 3, 20, "cpu")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == ref[name].value.shape and not got[name].any()

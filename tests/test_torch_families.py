"""The six configurations that join the port with the MoE, VLM and encoder
families — olmo-1b, command-r-plus-104b, mixtral-8x22b,
llama4-maverick-400b-a17b, internvl2-26b and hubert-xlarge — at reduced
width, against the JAX package on the same bridged float32 weights: the
scenarios of ``tests/test_smoke_archs.py`` (forward finite, decode step,
prefill == forward) with the JAX outputs as the reference.  Float outputs
agree normwise: max |port - jax| <= 1e-4 * max |jax| (f32 sums in
different orders through random layers), 3e-4 where a frontend feeds
the model (the encoder, the VLM with its prefix): the projected frames and
patches are about 50 times the token embeddings, and the encoder's ungated
GELU layers carry hidden values near 100 by the second layer (there both
packages' f32 logits lie 0.5e-4 to 1.5e-4 of the largest from a float64
run of the port); greedy ids are equal.  Also the
VLM's vision prefix and its refusal of ``starts``, the encoder's missing
cache and decode, llama4's interleave, the stacked member forms
(``ensemble_logits`` / ``ensemble_last_logits`` with ``embeds``), the
bridge's interleaved and frontend trees and ``param_count`` of all ten
configs (on the ``meta`` device: no weights are made)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_configs as j_list_configs
from repro.core import ensemble as j_ens
from repro.models import api as j_api
from repro.serve.engine import grow_cache as j_grow_cache
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config
from repro_torch.core import ensemble as t_ens
from repro_torch.models import api as t_api
from repro_torch.serve.engine import grow_cache as t_grow_cache
from test_torch_models import numpy_values

NORM_TOL = 1e-4
FRONTEND_TOL = 3e-4

j_prefill = jax.jit(j_api.prefill, static_argnames=("cfg",))
j_decode_step = jax.jit(j_api.decode_step, static_argnames=("cfg",))
j_forward_logits = jax.jit(j_api.forward_logits, static_argnames=("cfg",))

NEW_ARCHS = ("olmo-1b", "command-r-plus-104b", "mixtral-8x22b", "llama4-maverick-400b-a17b",
             "internvl2-26b", "hubert-xlarge")
DECODERS = tuple(a for a in NEW_ARCHS if a != "hubert-xlarge")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while the module runs (restored after): these
    small models gain nothing from more, and under xdist the workers'
    thread pools otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **changes):
    cfg = dataclasses.replace(j_get_config(arch).reduced(), dtype="float32", **changes)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=NEW_ARCHS)
def model(request):
    cfg, tcfg = _cfgs(request.param)
    np_values = numpy_values(cfg, seed=11)
    return cfg, jax.tree.map(jnp.asarray, np_values), tcfg, params_from_numpy(np_values, tcfg, device="cpu")


def _batch(cfg, B=2, S=10, seed=0, prefix=True):
    """numpy inputs: tokens, and ``embeds`` (frames for the encoder, the
    vision prefix for the VLM when ``prefix``)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder:
        return {"embeds": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.n_vision_tokens and prefix:
        batch["embeds"] = rng.standard_normal((B, cfg.n_vision_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, ref, tol=NORM_TOL):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (err, scale)


def _tol(cfg):
    return FRONTEND_TOL if cfg.frontend_dim else NORM_TOL


def test_all_ten_configs_registered():
    assert ARCH_IDS == tuple(j_list_configs())
    for a in ARCH_IDS:
        assert dataclasses.asdict(get_config(a)) == dataclasses.asdict(j_get_config(a))


def test_forward_matches_jax(model):
    cfg, values, tcfg, tparams = model
    batch = _batch(cfg)
    got = t_api.forward_logits(tparams, batch, tcfg)
    assert got.shape == (2, 10, cfg.vocab_size)  # the text positions only, for the VLM
    _close(got, j_forward_logits(values, _j(batch), cfg=cfg), _tol(cfg))


def test_prefill_equals_forward_and_jax(model):
    cfg, values, tcfg, tparams = model
    batch = _batch(cfg, seed=1)
    logits, cache = t_api.prefill(tparams, batch, tcfg)
    _close(logits, t_api.forward_logits(tparams, batch, tcfg)[:, -1].numpy())
    j_logits, j_cache = j_prefill(values, _j(batch), cfg=cfg)
    _close(logits, j_logits, _tol(cfg))
    if cfg.is_encoder:
        assert cache is None and j_cache is None
        return
    for name in ("k", "v"):  # (L, B, KVH, S, hd), the vision prefix's rows included
        _close(cache[name], j_cache[name], _tol(cfg))


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_steps_match_jax(arch):
    cfg, tcfg = _cfgs(arch)
    np_values = numpy_values(cfg, seed=12)
    values, tparams = jax.tree.map(jnp.asarray, np_values), params_from_numpy(np_values, tcfg, device="cpu")
    batch = _batch(cfg, B=3, S=9, seed=2)
    n_new = 3
    j_logits, j_cache = j_prefill(values, _j(batch), cfg=cfg)
    t_logits, t_cache = t_api.prefill(tparams, batch, tcfg)
    S = t_cache["k"].shape[3]  # prompt rows, with the prefix
    j_cache, t_cache = j_grow_cache(j_cache, n_new, cfg), t_grow_cache(t_cache, n_new, tcfg)
    for t in range(n_new):
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(t_logits.argmax(-1).numpy(), tok[:, 0])
        j_logits, j_cache = j_decode_step(values, jnp.asarray(tok), j_cache, jnp.int32(S + t), cfg=cfg)
        t_logits, t_cache = t_api.decode_step(tparams, torch.from_numpy(tok), t_cache, S + t, tcfg)
        _close(t_logits, j_logits, _tol(cfg))
    _close(t_cache["k"], j_cache["k"], _tol(cfg))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-maverick-400b-a17b", "olmo-1b"])
def test_left_pad_carveout_matches_jax(arch):
    """``starts`` through forward and decode, as the dense family takes it."""
    cfg, tcfg = _cfgs(arch)
    np_values = numpy_values(cfg, seed=13)
    values, tparams = jax.tree.map(jnp.asarray, np_values), params_from_numpy(np_values, tcfg, device="cpu")
    batch = dict(_batch(cfg, B=3, S=10, seed=3), starts=np.array([0, 4, 8], np.int32))
    _close(t_api.forward_logits(tparams, batch, tcfg), j_forward_logits(values, _j(batch), cfg=cfg))
    j_logits, j_cache = j_prefill(values, _j(batch), cfg=cfg)
    t_logits, t_cache = t_api.prefill(tparams, batch, tcfg)
    j_cache, t_cache = j_grow_cache(j_cache, 1, cfg), t_grow_cache(t_cache, 1, tcfg)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    j_out, _ = j_decode_step(values, jnp.asarray(tok), j_cache, jnp.int32(10), cfg=cfg,
                             starts=jnp.asarray(batch["starts"]))
    t_out, _ = t_api.decode_step(tparams, torch.from_numpy(tok), t_cache, 10, tcfg,
                                 starts=torch.from_numpy(batch["starts"]))
    _close(t_out, j_out)


def test_vlm_prefix_and_its_starts_refusal():
    cfg, tcfg = _cfgs("internvl2-26b")
    np_values = numpy_values(cfg, seed=14)
    values, tparams = jax.tree.map(jnp.asarray, np_values), params_from_numpy(np_values, tcfg, device="cpu")
    with_prefix, text = _batch(cfg, seed=4), _batch(cfg, seed=4, prefix=False)
    # the prefix changes the text's logits, and its rows enter the cache
    a = t_api.forward_logits(tparams, with_prefix, tcfg)
    b = t_api.forward_logits(tparams, text, tcfg)
    assert a.shape == b.shape and not torch.allclose(a, b)
    _close(b, j_forward_logits(values, _j(text), cfg=cfg))
    _, cache = t_api.prefill(tparams, with_prefix, tcfg)
    assert cache["k"].shape[3] == cfg.n_vision_tokens + 10
    # starts index token columns: refused with a prefix, served without one
    starts = np.array([0, 3], np.int32)
    with pytest.raises(ValueError, match="vision prefix"):
        t_api.forward_logits(tparams, dict(with_prefix, starts=starts), tcfg)
    with pytest.raises(ValueError, match="vision prefix"):
        t_api.prefill(tparams, dict(with_prefix, starts=starts), tcfg)
    with pytest.raises(AssertionError):  # the JAX package refuses it too
        j_api.forward_logits(values, _j(dict(with_prefix, starts=starts)), cfg)
    padded = dict(text, starts=starts)
    _close(t_api.forward_logits(tparams, padded, tcfg), j_forward_logits(values, _j(padded), cfg=cfg))


def test_encoder_has_no_cache_and_no_decode():
    cfg, tcfg = _cfgs("hubert-xlarge")
    tparams = params_from_numpy(numpy_values(cfg, seed=15), tcfg, device="cpu")
    assert "embed" not in tparams and tparams["frontend"]["proj"].shape == (cfg.frontend_dim, cfg.d_model)
    batch = _batch(cfg)
    _, cache = t_api.prefill(tparams, batch, tcfg)
    assert cache is None
    assert not t_api.supports_chunked_prefill(tcfg) and not t_api.supports_paging(tcfg)
    with pytest.raises(ValueError, match="encoder"):
        t_api.init_cache(tcfg, 2, 16, "cpu")
    with pytest.raises(ValueError, match="encoder"):
        t_api.decode_step(tparams, np.zeros((2, 1), np.int32), {}, 3, tcfg)
    with pytest.raises(ValueError, match="carve-out"):
        t_api.forward_logits(tparams, dict(batch, starts=np.zeros(2, np.int32)), tcfg)
    # non-causal: the first position sees the last frame
    e2 = {"embeds": batch["embeds"].copy()}
    e2["embeds"][:, -1] += 1.0
    assert not torch.allclose(t_api.forward_logits(tparams, e2, tcfg)[:, 0],
                              t_api.forward_logits(tparams, batch, tcfg)[:, 0])


@pytest.mark.parametrize("arch,E", [("hubert-xlarge", 3), ("internvl2-26b", 2)])
def test_ensemble_logits_with_embeds(arch, E):
    """The stacked member forms take ``embeds`` as the JAX ensemble does."""
    cfg, tcfg = _cfgs(arch)
    np_values = numpy_values(cfg, seed=16, k=E)
    values, tvals = jax.tree.map(jnp.asarray, np_values), params_from_numpy(np_values, tcfg, device="cpu")
    batch = _batch(cfg, seed=5)
    _close(t_ens.ensemble_logits(tvals, batch, tcfg),
           jax.jit(j_ens.ensemble_logits, static_argnames=("cfg",))(values, _j(batch), cfg=cfg), _tol(cfg))
    _close(t_ens.ensemble_last_logits(tvals, batch, tcfg),
           jax.jit(j_ens.ensemble_last_logits, static_argnames=("cfg",))(values, _j(batch), cfg=cfg), _tol(cfg))
    assert t_ens.member_count(tvals) == E


def test_llama4_interleave():
    """Two groups of (dense, MoE): the tree keeps the JAX package's stacks,
    layer l is MoE exactly when (l + 1) % moe_every == 0, and forward,
    prefill and decode agree with the JAX package's grouped scans."""
    cfg, tcfg = _cfgs("llama4-maverick-400b-a17b", n_layers=4)
    np_values = numpy_values(cfg, seed=17)
    values, tparams = jax.tree.map(jnp.asarray, np_values), params_from_numpy(np_values, tcfg, device="cpu")
    assert set(tparams["layers"]) == {"dense", "moe"}
    assert tparams["layers"]["dense"]["mlp"]["w_gate"].shape[0] == 2
    assert tparams["layers"]["moe"]["moe"]["router"].shape[0] == 2
    members = t_api._members(tparams)
    for l in range(cfg.n_layers):
        assert ("moe" in t_api._layer(members, l, tcfg)) == ((l + 1) % cfg.moe_every == 0)
    batch = _batch(cfg, B=2, S=8, seed=6)
    _close(t_api.forward_logits(tparams, batch, tcfg), j_forward_logits(values, _j(batch), cfg=cfg))
    j_logits, j_cache = j_prefill(values, _j(batch), cfg=cfg)
    t_logits, t_cache = t_api.prefill(tparams, batch, tcfg)
    _close(t_cache["v"], j_cache["v"])  # the cache's layer order is the model's: [d, m, d, m]
    j_cache, t_cache = j_grow_cache(j_cache, 1, cfg), t_grow_cache(t_cache, 1, tcfg)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    j_out, _ = j_decode_step(values, jnp.asarray(tok), j_cache, jnp.int32(8), cfg=cfg)
    t_out, _ = t_api.decode_step(tparams, torch.from_numpy(tok), t_cache, 8, tcfg)
    _close(t_out, j_out)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "internvl2-26b", "hubert-xlarge"])
@pytest.mark.parametrize("k", [None, 3])
def test_bridge_round_trips_interleaved_and_frontend_trees(arch, k):
    cfg, tcfg = _cfgs(arch)
    np_values = numpy_values(cfg, seed=18, k=k)
    t = params_from_numpy(np_values, tcfg, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(np_values)[0]
    for path, leaf in flat_j:
        node = t
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    assert sum(1 for _ in flat_j) == len(jax.tree_util.tree_leaves(jax.tree.map(np.asarray, {k_: v for k_, v in t.items()})))


def test_bridge_refuses_a_wrong_layer_axis():
    cfg, tcfg = _cfgs("llama4-maverick-400b-a17b", n_layers=4)
    np_values = numpy_values(cfg, seed=19)
    bad = dict(np_values, layers=dict(np_values["layers"], moe=jax.tree.map(lambda a: a[:1], np_values["layers"]["moe"])))
    with pytest.raises(ValueError, match="layer axis"):
        params_from_numpy(bad, tcfg, device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_jax(arch):
    t, j = get_config(arch), j_get_config(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    from repro.models import counting as j_counting
    from repro_torch.models import counting as t_counting

    assert t_counting.model_flops_per_token(t) == j_counting.model_flops_per_token(j)

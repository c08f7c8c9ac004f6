"""The constant-state families in the port against the JAX package:
the SSD and WKV6 plain versions, the step functions, and ``prefill``,
``decode_step``, ``forward_logits`` and ``prefill_into_slot`` of
``rwkv6-7b``, ``zamba2-2.7b`` and a small ``ssm_mamba2`` config (reduced),
on the same weights (made by the JAX package from a seed, carried through
numpy) and the same numpy inputs.

Tolerances: the plain scans against JAX's ``_xla_ssd``/``_xla_wkv6``
normwise rtol 1e-5 — max |port - jax| <= 1e-5 * max |jax| (the same
chunked arithmetic in f32, summed in other orders: outputs reach |y| ~ 50,
where one f32 ulp is 4e-6, so an elementwise 1e-5 cannot hold; JAX's own
XLA route is as far from its per-step ref); against the JAX per-step refs
the JAX tests' own 5e-4 (SSD) and 2e-3 (WKV6); the
step functions against the full scan 1e-4; model logits and every state
leaf normwise 1e-4, as ``tests/test_torch_models.py`` holds the dense
family (f32 configs; products summed in other orders through the layers
leave ~3e-5 absolute on elements near zero, where an elementwise atol of
1e-5 cannot hold).  Greedy ids are equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import ensemble as j_ens
from repro.kernels.mamba2_ssd import ops as j_ssd_ops
from repro.kernels.mamba2_ssd import ref as j_ssd_ref
from repro.kernels.rwkv6_wkv import ops as j_wkv_ops
from repro.kernels.rwkv6_wkv import ref as j_wkv_ref
from repro.models import api as j_api
from repro.models.params import unbox
from repro.serve.engine import grow_cache as j_grow_cache
from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import ensemble as t_ens
from repro_torch.kernels.mamba2_ssd import ops as t_ssd_ops
from repro_torch.kernels.mamba2_ssd import ref as t_ssd_ref
from repro_torch.kernels.rwkv6_wkv import ops as t_wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as t_wkv_ref
from repro_torch.models import api as t_api
from repro_torch.serve.engine import grow_cache as t_grow_cache

NORM_TOL = 1e-4

MAMBA = JModelConfig(
    name="tiny-mamba", family="ssm_mamba2", n_layers=2, d_model=64, d_ff=128,
    vocab_size=64, ssm_state=16, ssm_head_dim=32, remat=False,
)
CONFIGS = {
    "rwkv6-7b-reduced": j_get_config("rwkv6-7b").reduced(),
    "zamba2-2.7b-reduced": j_get_config("zamba2-2.7b").reduced(),
    "tiny-mamba": MAMBA,
}

j_prefill = jax.jit(j_api.prefill, static_argnames=("cfg",))
j_decode_step = jax.jit(j_api.decode_step, static_argnames=("cfg",))
j_forward_logits = jax.jit(j_api.forward_logits, static_argnames=("cfg",))
j_prefill_into_slot = jax.jit(j_api.prefill_into_slot, static_argnames=("cfg",))


def jax_values(cfg, seed, k=None):
    """Weights from the JAX package's own init, as numpy leaves."""
    key = jax.random.PRNGKey(seed)
    boxed = j_api.init_params(cfg, key) if k is None else j_ens.init_ensemble(cfg, k, key)
    return jax.tree.map(np.asarray, unbox(boxed)[0])


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _normwise(got, ref, tol=1e-5, what=""):
    """max |got - ref| <= tol * max |ref|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (what, err, scale)


def _close(got, ref, what=""):
    _normwise(got, ref, NORM_TOL, what)


def _close_tree(got, ref):
    assert sorted(got) == sorted(ref)
    for name in ref:
        if isinstance(ref[name], list):
            assert len(got[name]) == len(ref[name])
            for i, (g, r) in enumerate(zip(got[name], ref[name])):
                _close(g, r, f"{name}[{i}]")
        else:
            _close(got[name], ref[name], name)


# ---------------------------------------------------------------------------
# the plain scans against the JAX package's XLA route and refs
# ---------------------------------------------------------------------------


def _ssd_inputs(B, S, H, P, G, N, seed, h0=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.5).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, N, P)) * 0.2).astype(np.float32) if h0 else None
    return x, dt, A, Bm, Cm, s0


SSD_SHAPES = [  # tests/test_kernels.py's, plus a ragged S and zamba2 widths
    (2, 128, 4, 32, 2, 16, 32, False),
    (1, 256, 2, 64, 1, 64, 64, True),
    (2, 96, 4, 32, 4, 16, 64, True),  # ragged: 96 % 64
    (2, 64, 2, 16, 1, 8, 32, True),
    (2, 200, 3, 16, 3, 8, 128, True),  # ragged at the port's default chunk
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk,h0", SSD_SHAPES)
def test_ssd_plain_matches_jax(B, S, H, P, G, N, chunk, h0):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(B, S, H, P, G, N, seed=S + N, h0=h0)
    j_in = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    t_in = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    js0 = None if s0 is None else jnp.asarray(s0)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    jy, jh = j_ssd_ops._xla_ssd(*j_in, chunk=chunk, initial_state=js0, return_final_state=True)
    ty, th = t_ssd_ops.ssd_plain(*t_in, chunk=chunk, initial_state=ts0)
    _normwise(ty.numpy(), jy)
    _normwise(th.numpy(), jh)
    ry, rh = j_ssd_ref.ssd_ref(*j_in, initial_state=js0, return_final_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh), rtol=5e-4, atol=5e-4)
    py, ph = t_ssd_ref.ssd_ref(*t_in, initial_state=ts0, return_final_state=True)
    _normwise(py.numpy(), ry)
    _normwise(ph.numpy(), rh)


def _wkv_inputs(B, S, H, D, seed, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    scale = 2.0 if strong else 0.5  # strong: exp(logw) down to ~1e-300 (decays to 0 in f32)
    logw = (-np.exp(rng.standard_normal((B, S, H, D)) * scale)).astype(np.float32)
    u = (rng.standard_normal((H, D)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


WKV_SHAPES = [  # tests/test_kernels.py's, plus S = 1 and strong decay
    (2, 128, 3, 32, 32, False),
    (1, 64, 2, 64, 32, False),
    (2, 80, 2, 32, 32, False),  # ragged
    (3, 1, 2, 32, 32, False),  # a decode step
    (2, 45, 2, 16, 32, True),
]


@pytest.mark.parametrize("B,S,H,D,chunk,strong", WKV_SHAPES)
def test_wkv6_plain_matches_jax(B, S, H, D, chunk, strong):
    r, k, v, logw, u, s0 = _wkv_inputs(B, S, H, D, seed=S + D, strong=strong)
    j_in = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    t_in = [torch.from_numpy(a) for a in (r, k, v, logw, u)]
    jy, js = j_wkv_ops._xla_wkv6(*j_in, chunk=chunk, initial_state=jnp.asarray(s0), return_final_state=True)
    ty, ts = t_wkv_ops.wkv6_plain(*t_in, chunk=chunk, initial_state=torch.from_numpy(s0))
    assert np.isfinite(ty.numpy()).all() and np.isfinite(ts.numpy()).all()
    _normwise(ty.numpy(), jy)
    _normwise(ts.numpy(), js)
    ry, rs = j_wkv_ref.wkv6_ref(*j_in, initial_state=jnp.asarray(s0), return_final_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=2e-3, atol=2e-3)
    py, ps = t_wkv_ref.wkv6_ref(*t_in, initial_state=torch.from_numpy(s0), return_final_state=True)
    _normwise(py.numpy(), ry)
    _normwise(ps.numpy(), rs)


def test_per_member_parameters():
    """u (E, H, D) and A (E, H): row b reads member b // (B / E), the same
    as running each member's rows alone."""
    E, B = 3, 2
    r, k, v, logw, _, s0 = (torch.from_numpy(a) for a in _wkv_inputs(E * B, 20, 2, 16, seed=1))
    u = torch.from_numpy(np.random.default_rng(2).standard_normal((E, 2, 16)).astype(np.float32))
    y, s = t_wkv_ops.wkv6(r, k, v, logw, u, initial_state=s0, return_final_state=True)
    x, dt, _, Bm, Cm, h0 = (torch.from_numpy(a) for a in _ssd_inputs(E * B, 20, 4, 8, 2, 8, seed=3, h0=True))
    A = -torch.rand(E, 4, generator=torch.Generator().manual_seed(4)) - 0.1
    yy, hh = t_ssd_ops.ssd_plain(x, dt, A, Bm, Cm, initial_state=h0, chunk=8)
    for e in range(E):
        rows = slice(e * B, (e + 1) * B)
        ye, se = t_wkv_ops.wkv6(r[rows], k[rows], v[rows], logw[rows], u[e], initial_state=s0[rows],
                                return_final_state=True)
        torch.testing.assert_close(y[rows], ye, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(s[rows], se, rtol=1e-6, atol=1e-6)
        ye, he = t_ssd_ops.ssd_plain(x[rows], dt[rows], A[e], Bm[rows], Cm[rows], initial_state=h0[rows], chunk=8)
        torch.testing.assert_close(yy[rows], ye, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(hh[rows], he, rtol=1e-6, atol=1e-6)


def test_ssd_step_matches_scan():
    x, dt, A, Bm, Cm, _ = (None if a is None else torch.from_numpy(a) for a in _ssd_inputs(2, 16, 2, 16, 1, 8, seed=5))
    full = t_ssd_ops.ssd(x, dt, A, Bm, Cm)
    st = torch.zeros((2, 2, 8, 16))
    for t in range(16):
        step_in = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        jy, jst = j_ssd_ops.ssd_step(*(jnp.asarray(a.numpy()) for a in step_in), jnp.asarray(st.numpy()))
        y, st = t_ssd_ops.ssd_step(*step_in, st)
        torch.testing.assert_close(y, full[:, t], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5, atol=1e-6)


def test_wkv6_step_matches_scan():
    r, k, v, logw, u, _ = (torch.from_numpy(a) for a in _wkv_inputs(2, 12, 2, 16, seed=7))
    full = t_wkv_ops.wkv6(r, k, v, logw, u)
    st = torch.zeros((2, 2, 16, 16))
    for t in range(12):
        jy, _ = j_wkv_ops.wkv6_step(*(jnp.asarray(a.numpy()) for a in (r[:, t], k[:, t], v[:, t], logw[:, t], u)),
                                    jnp.asarray(st.numpy()))
        y, st = t_wkv_ops.wkv6_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, st)
        torch.testing.assert_close(y, full[:, t], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# models: prefill, decode, forward_logits, chunked prefill into a slot
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    cfg = dataclasses.replace(CONFIGS[request.param], dtype="float32")
    vals = jax_values(cfg, seed=3)
    tcfg = port_cfg(cfg)
    return cfg, jax.tree.map(jnp.asarray, vals), tcfg, params_from_numpy(vals, tcfg, device="cpu")


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_forward_logits(model):
    cfg, values, tcfg, tparams = model
    toks = _tokens(cfg, 3, 12, 0)
    _close(t_api.forward_logits(tparams, {"tokens": toks}, tcfg),
           j_forward_logits(values, {"tokens": jnp.asarray(toks)}, cfg=cfg))


def test_prefill_then_decode(model):
    """Logits and every state leaf after the prefill and after each of three
    decode steps (the hybrid's attention leaves grown by ``grow_cache``)."""
    cfg, values, tcfg, tparams = model
    toks = _tokens(cfg, 3, 11, 1)
    j_logits, j_cache = j_prefill(values, {"tokens": jnp.asarray(toks)}, cfg=cfg)
    t_logits, t_cache = t_api.prefill(tparams, {"tokens": toks}, tcfg)
    _close(t_logits, j_logits)
    _close_tree(t_cache, j_cache)
    j_cache, t_cache = j_grow_cache(j_cache, 3, cfg), t_grow_cache(t_cache, 3, tcfg)
    for t in range(3):
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(t_logits.argmax(-1).numpy(), tok[:, 0])
        j_logits, j_cache = j_decode_step(values, jnp.asarray(tok), j_cache, jnp.int32(11 + t), cfg=cfg)
        t_logits, t_cache = t_api.decode_step(tparams, torch.from_numpy(tok), t_cache, 11 + t, tcfg)
        _close(t_logits, j_logits)
        _close_tree(t_cache, j_cache)


def test_prefill_into_slot_then_decode(model):
    """Two chunks (8 then 3 tokens, the second continuing the slot's state)
    into slot 1 of a 3-slot cache, then one decode step over every slot at
    per-slot positions; the other slots' state stays as it was."""
    cfg, values, tcfg, tparams = model
    n_slots, max_seq = 3, 32
    j_cache = unbox(j_api.init_cache(cfg, n_slots, max_seq))[0]
    rng = np.random.default_rng(4)
    j_cache = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.1), j_cache)
    t_cache = cache_from_numpy(jax.tree.map(np.asarray, j_cache), "cpu", members=False)
    toks = _tokens(cfg, 1, 11, 5)[0]
    for lo, hi in ((0, 8), (8, 11)):
        j_cache = j_prefill_into_slot(values, jnp.asarray(toks[lo:hi]), j_cache, 1, lo, cfg=cfg)
        t_cache = t_api.prefill_into_slot(tparams, toks[lo:hi], t_cache, 1, lo, tcfg)
        _close_tree(t_cache, j_cache)
    tok = rng.integers(0, cfg.vocab_size, (n_slots, 1)).astype(np.int32)
    pos = np.array([4, 11, 20], np.int32)
    j_logits, j_cache = j_decode_step(values, jnp.asarray(tok), j_cache, jnp.asarray(pos), cfg=cfg)
    t_logits, t_cache = t_api.decode_step(tparams, torch.from_numpy(tok), t_cache, pos, tcfg)
    _close(t_logits, j_logits)
    _close_tree(t_cache, j_cache)


def test_reset_slot_zeroes_state_only(model):
    cfg, _, tcfg, _ = model
    t_cache = t_api.init_cache(tcfg, 3, 16, "cpu")
    for v in t_cache.values():
        for t in (v if isinstance(v, list) else [v]):
            t.fill_(1.0)
    ref = j_api.reset_slot(jax.tree.map(lambda t: jnp.asarray(t.numpy()) if isinstance(t, torch.Tensor) else t,
                                        t_cache), 1, cfg)
    got = t_api.reset_slot(t_cache, 1, tcfg)
    _close_tree(got, ref)
    members = t_api.init_cache_members(tcfg, 2, 3, 16, "cpu")
    for name in ("conv", "ssm", "wkv", "tm_x"):
        if name in members:
            members[name].fill_(1.0)
            t_api.reset_slot_members(members, 2, tcfg)
            assert not members[name][:, :, 2].any() and members[name][:, :, :2].eq(1.0).all()


def test_init_cache_matches_jax_layout(model):
    cfg, _, tcfg, _ = model
    ref = unbox(j_api.init_cache(cfg, 3, 20))[0]
    got = t_api.init_cache(tcfg, 3, 20, "cpu")
    assert sorted(got) == sorted(ref)
    for name in ref:
        pairs = zip(got[name], ref[name]) if isinstance(ref[name], list) else [(got[name], ref[name])]
        for g, r in pairs:
            assert tuple(g.shape) == r.shape and not g.any()
            assert g.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(r.dtype)]
    assert t_api.has_slot_state(tcfg) and t_api.supports_chunked_prefill(tcfg) and not t_api.supports_paging(tcfg)


def test_carveout_is_refused(model):
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="carve-out"):
        t_api.prefill(tparams, {"tokens": np.zeros((2, 4), np.int32), "starts": np.array([0, 1], np.int32)}, tcfg)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_ensemble_members_match_jax(arch):
    """E = 3 explicit: the member prefill, its layer-major caches (through
    ``cache_from_numpy``) and a decode step equal the JAX vmapped
    ensemble's."""
    cfg = dataclasses.replace(j_get_config(arch).reduced(), dtype="float32")
    tcfg = port_cfg(cfg)
    vals = jax_values(cfg, seed=6, k=3)
    values = jax.tree.map(jnp.asarray, vals)
    tvals = params_from_numpy(vals, tcfg, device="cpu")
    toks = _tokens(cfg, 2, 9, 7)
    j_logits, j_caches = jax.jit(j_ens.ensemble_prefill, static_argnames=("cfg",))(
        values, {"tokens": jnp.asarray(toks)}, cfg=cfg)
    t_logits, t_caches = t_ens.ensemble_prefill(tvals, {"tokens": toks}, tcfg)
    _close(t_logits, j_logits)
    _close_tree(t_caches, cache_from_numpy(jax.tree.map(np.asarray, j_caches), "cpu"))
    _close(t_ens.ensemble_last_logits(tvals, {"tokens": toks}, tcfg), j_logits)
    j_caches = j_grow_cache(j_caches, 1, cfg, lead=1)
    t_caches = t_grow_cache(t_caches, 1, tcfg)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[..., None]
    j_out, j_caches = jax.jit(j_ens.ensemble_decode_step, static_argnames=("cfg",))(
        values, jnp.asarray(tok), j_caches, jnp.int32(9), cfg=cfg)
    t_out, t_caches = t_ens.ensemble_decode_step(tvals, torch.from_numpy(tok), t_caches, 9, tcfg)
    _close(t_out, j_out)
    _close_tree(t_caches, cache_from_numpy(jax.tree.map(np.asarray, j_caches), "cpu"))


# ---------------------------------------------------------------------------
# the bridge and the port's own init
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
@pytest.mark.parametrize("k", [None, 3])
def test_bridge_round_trip(arch, k):
    """Every parameter leaf (the hybrid's un-stacked ``shared_attn``
    included, bf16 as the config has it) and every state leaf arrives with
    its shape, dtype and value; the port's own init draws the same tree."""
    cfg = j_get_config(arch).reduced()
    tcfg = port_cfg(cfg)
    vals = jax_values(cfg, seed=8, k=k)
    got = _flat(params_from_numpy(vals, tcfg, device="cpu"))
    ref = _flat(vals)
    assert sorted(got) == sorted(ref)
    for name, a in ref.items():
        assert tuple(got[name].shape) == a.shape, name
        np.testing.assert_array_equal(got[name].float().numpy(), a.astype(np.float32), err_msg=name)
    g = torch.Generator().manual_seed(0)
    own = _flat(t_api.init_params(tcfg, g, "cpu") if k is None else t_ens.init_ensemble(tcfg, k, g, "cpu"))
    assert {n: (tuple(t.shape), t.dtype) for n, t in own.items()} == {
        n: (tuple(t.shape), t.dtype) for n, t in got.items()}
    own_consts = {n: t for n, t in own.items() if n.rsplit("/", 1)[-1] in ("A_log", "dt_bias", "decay_base")}
    for name, t in own_consts.items():
        np.testing.assert_allclose(t.numpy(), ref[name], rtol=1e-6, err_msg=name)
    # state trees: member-stacked (E, L, ...) -> layer-major, lists as they are
    E = 2
    state = unbox(j_api.init_cache(cfg, 3, 8))[0]
    state = jax.tree.map(lambda a: np.stack([np.full(a.shape, e + 1, np.float32).astype(a.dtype) for e in range(E)]), state)
    tstate = cache_from_numpy(state, "cpu")
    shapes = t_api.init_cache_members(tcfg, E, 3, 8, "cpu")
    for name, leaf in tstate.items():
        for t, s in (zip(leaf, shapes[name]) if isinstance(leaf, list) else [(leaf, shapes[name])]):
            assert t.shape == s.shape and t.dtype == s.dtype, name
            member_axis = 0 if isinstance(leaf, list) else 1
            for e in range(E):
                assert t.select(member_axis, e).float().eq(e + 1).all(), name


def test_port_configs_match_jax():
    for arch in ("rwkv6-7b", "zamba2-2.7b"):
        ref = j_get_config(arch)
        got = get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        for prop in ("attention_free", "d_inner", "ssm_nheads"):
            assert getattr(got, prop) == getattr(ref, prop)
        assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(ref.reduced())


def test_no_fallback_off_the_cpu(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: a meta
    tensor (the dry run) gets its outputs' shapes and computes nothing; the
    kernel wrappers refuse anything but a CUDA tensor; and without a card an
    entry point raises instead of running on the CPU."""
    meta = lambda *s: torch.empty(*s, device="meta")

    def plain(*a, **k):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(t_wkv_ops, "wkv6_plain", plain)
    monkeypatch.setattr(t_ssd_ops, "ssd_plain", plain)
    wkv_args = (meta(1, 4, 2, 16), meta(1, 4, 2, 16), meta(1, 4, 2, 16), meta(1, 4, 2, 16), meta(2, 16))
    ssd_args = (meta(1, 4, 2, 16), meta(1, 4, 2), meta(2), meta(1, 4, 1, 8), meta(1, 4, 1, 8))
    y = t_wkv_ops.wkv6(*wkv_args)
    assert y.is_meta and y.shape == (1, 4, 2, 16)
    y = t_ssd_ops.ssd(*ssd_args)
    assert y.is_meta and y.shape == (1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_wkv_ops._wkv6_cuda(*wkv_args, initial_state=None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ssd_ops._ssd_cuda(*ssd_args, initial_state=None)
    from repro_torch.serve import ServingEngine

    cfg = get_config("rwkv6-7b").reduced()
    params = t_api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)

"""Parity of the port's block-paged KV path with the JAX package on the
same numpy inputs: the paged decode kernel's plain version, the host
``PagePool`` allocator, and the model API's slot surface
(``decode_step_paged``, ``prefill_into_slot_paged``, ``prefill_into_slot``,
vector-position ``decode_step``, ``copy_pool_page``) for one model and for
a member-stacked ensemble.

Tolerances: attention outputs f32 rtol 1e-5 / atol 1e-5 (two frameworks
sum in different orders); model logits and pools normwise,
max |port - jax| <= 1e-4 * max |jax| + 1e-5, as ``test_torch_models.py``
holds the model (float32 weights through several layers; K/V entries span
two orders of magnitude, so an elementwise rtol would be set by the
smallest); greedy ids, page tables, refcounts and allocator stats exactly
equal; paged against dense inside the port bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.decode_attention import ops as j_decode
from repro.kernels.decode_attention import ref as j_decode_ref
from repro.models import api as j_api
from repro.models.params import unbox
from repro.serve.paging import PagePool as JPagePool
from repro.serve.paging import prefix_page_keys as j_prefix_page_keys
from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import ensemble as t_ens
from repro_torch.kernels.compaction.ops import gather_rows_plain
from repro_torch.kernels.decode_attention import ops as t_decode
from repro_torch.kernels.decode_attention import ref as t_decode_ref
from repro_torch.models import api as t_api
from repro_torch.serve.paging import PagePool, prefix_page_keys
from test_torch_cascade import BIG, SMALL, numpy_values

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
NORM_RTOL, NORM_ATOL = 1e-4, 1e-5


# ---------------------------------------------------------------------------
# paged decode attention: plain version against the JAX XLA route and refs
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # shuffled non-monotone table, -1 past cur_len, ragged cur_len
    dict(pages=[[5, 0, -1, -1], [2, 7, 1, 8], [3, -1, -1, -1]], cur=[7, 16, 1], window=None, softcap=None),
    # an unmapped page inside a slot's length reads as zero rows
    dict(pages=[[5, -1, 6, -1], [2, 7, 1, 8], [-1, 3, -1, -1]], cur=[11, 13, 6], window=None, softcap=None),
    dict(pages=[[5, 0, 4, -1], [2, 7, 1, 8], [3, 6, -1, -1]], cur=[12, 16, 8], window=5, softcap=None),
    dict(pages=[[8, 0, 4, 3], [2, 7, 1, 5], [6, -1, -1, -1]], cur=[14, 9, 2], window=None, softcap=2.5),
]


def _paged_inputs(case, seed, E=None):
    rng = np.random.default_rng(seed)
    B, KVH, G, hd, P, ps = 3, 2, 4, 8, 10, 4
    lead = () if E is None else (E,)
    q = rng.standard_normal(((E or 1) * B, 1, KVH * G, hd)).astype(np.float32)
    kp = rng.standard_normal(lead + (P, KVH, ps, hd)).astype(np.float32)
    vp = rng.standard_normal(lead + (P, KVH, ps, hd)).astype(np.float32)
    return q, kp, vp, np.asarray(case["pages"], np.int32), np.asarray(case["cur"], np.int32)


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: f"cur={c['cur']}-w={c['window']}-cap={c['softcap']}")
def test_decode_attention_paged_matches_jax(case):
    q, kp, vp, pages, cur = _paged_inputs(case, seed=1)
    kw = dict(window=case["window"], softcap=case["softcap"])
    got = t_decode.decode_attention_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pages), torch.from_numpy(cur), **kw,
    ).numpy()
    ref = j_decode._xla_decode_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages), jnp.asarray(cur), **kw,
    )
    np.testing.assert_allclose(got, np.asarray(ref), **KERNEL_TOL)
    oracle = j_decode_ref.decode_attention_paged_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pages), jnp.asarray(cur), **kw,
    )
    np.testing.assert_allclose(got, np.asarray(oracle), **KERNEL_TOL)
    t_oracle = t_decode_ref.decode_attention_paged_ref(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pages), torch.from_numpy(cur), **kw,
    ).numpy()
    np.testing.assert_allclose(got, t_oracle, **KERNEL_TOL)


@pytest.mark.parametrize("case", PAGED_CASES[:2] + PAGED_CASES[3:], ids=lambda c: f"cur={c['cur']}")
def test_decode_attention_paged_member_planes(case):
    """E member planes under ONE table: row r of q reads plane r // B,
    exactly what the JAX package computes per member (its vmap)."""
    E = 3
    q, kp, vp, pages, cur = _paged_inputs(case, seed=2, E=E)
    kw = dict(window=case["window"], softcap=case["softcap"])
    got = t_decode.decode_attention_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pages), torch.from_numpy(cur), **kw,
    ).numpy()
    B = pages.shape[0]
    for e in range(E):
        ref = j_decode._xla_decode_paged(
            jnp.asarray(q[e * B:(e + 1) * B]), jnp.asarray(kp[e]), jnp.asarray(vp[e]),
            jnp.asarray(pages), jnp.asarray(cur), **kw,
        )
        np.testing.assert_allclose(got[e * B:(e + 1) * B], np.asarray(ref), **KERNEL_TOL)


def test_decode_attention_paged_is_dense_on_gathered_view():
    """Inside the port, paged decode is bitwise the dense decode over the
    gathered view (the serving path's paged == dense contract)."""
    q, kp, vp, pages, cur = (torch.from_numpy(a) for a in _paged_inputs(PAGED_CASES[1], seed=3, E=2))
    got = t_decode.decode_attention_paged(q, kp, vp, pages, cur)
    view_k, view_v = (t_decode.paged_pool_view(t, pages, gather_rows_plain) for t in (kp, vp))
    dense = t_decode.decode_attention_bksd(q, view_k, view_v, cur.repeat(2))
    assert torch.equal(got, dense)


def test_decode_attention_paged_rejects_mismatched_table():
    q, kp, vp, pages, cur = (torch.from_numpy(a) for a in _paged_inputs(PAGED_CASES[0], seed=4))
    with pytest.raises(ValueError, match="do not agree"):
        t_decode.decode_attention_paged(q, kp, vp, pages[:2], cur)


# ---------------------------------------------------------------------------
# PagePool: the same seeded operation sequence on both allocators
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return pool.table.copy(), pool.refcount.copy(), dict(pool.stats), pool.pages_in_use


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_slots, ps, max_seq, n_pages = 4, 4, 32, 20
    pools = [JPagePool(n_pages, ps, n_slots=n_slots, max_seq=max_seq),
             PagePool(n_pages, ps, n_slots=n_slots, max_seq=max_seq)]
    prefix = rng.integers(0, 50, 9).astype(np.int32)
    for _ in range(120):
        slot = int(rng.integers(n_slots))
        op = rng.choice(["admit", "prepare", "extend", "truncate", "release"])
        mapped = bool((pools[0].table[slot] >= 0).any())
        if op == "admit" and not mapped:
            n = int(rng.integers(2, 20))
            toks = rng.integers(0, 50, n).astype(np.int32)
            if rng.random() < 0.5:
                toks = np.concatenate([prefix, toks])[: max_seq - 1]
            share = bool(rng.random() < 0.7)
            outs = [p.admit(slot, toks, share=share) for p in pools]
        elif op == "prepare" and mapped:
            pos = int(rng.integers(0, max_seq))
            outs = [p.prepare(slot, pos) for p in pools]
        elif op == "extend" and mapped:
            rows = int(rng.integers(1, max_seq + 1))
            outs = [p.extend(slot, rows) for p in pools]
        elif op == "truncate":
            keep = int(rng.integers(0, max_seq))
            outs = [p.truncate(slot, keep) for p in pools]
        else:
            outs = [p.release(slot) for p in pools]
        assert outs[0] == outs[1], (op, outs)
        ref, got = _pool_state(pools[0]), _pool_state(pools[1])
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[2:] == ref[2:]
        pools[1].assert_conserved()


def test_prefix_page_keys_match_jax():
    toks = np.random.default_rng(5).integers(0, 1000, 70).astype(np.int32)
    assert prefix_page_keys(toks, 16, 4) == j_prefix_page_keys(toks, 16, 4)


# ---------------------------------------------------------------------------
# the model API's slot surface, one model and a member-stacked ensemble
# ---------------------------------------------------------------------------

CONFIGS = {
    "small": SMALL,
    "big": BIG,
    "qwen2.5-3b-reduced": j_get_config("qwen2.5-3b").reduced(),
    "internlm2-1.8b-reduced": j_get_config("internlm2-1.8b").reduced(),
}
N_SLOTS, PS, MAX_SEQ = 3, 8, 32
N_PAGES = N_SLOTS * MAX_SEQ // PS + 1
TABLE = np.array([[3, 1, 10, -1], [0, 5, 2, 7], [6, -1, -1, -1]], np.int32)
POS = np.array([20, 30, 4], np.int32)  # slot 2's next write lands on its one mapped page


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    cfg = dataclasses.replace(CONFIGS[request.param], dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    vals = numpy_values(cfg, 20)
    return cfg, tcfg, jax.tree.map(jnp.asarray, vals), params_from_numpy(vals, tcfg, device="cpu")


def _rand_tree(template, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda t: rng.standard_normal(t.shape).astype(np.float32), template)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= NORM_RTOL * scale + NORM_ATOL, f"normwise err {err} vs max {scale}"


def _close_tree(got, ref):
    for k in ref:
        _close(got[k], ref[k])


def test_decode_step_paged(model):
    cfg, tcfg, jp, tp = model
    pool = _rand_tree(unbox(j_api.init_paged_pool(cfg, N_PAGES, PS))[0], 21)
    tok = np.random.default_rng(22).integers(0, cfg.vocab_size, (N_SLOTS, 1)).astype(np.int32)
    ref_logits, ref_pool = jax.jit(j_api.decode_step_paged, static_argnames="cfg")(
        jp, jnp.asarray(tok), jax.tree.map(jnp.asarray, pool), jnp.asarray(POS), jnp.asarray(TABLE), cfg=cfg,
    )
    logits, tpool = t_api.decode_step_paged(tp, tok, cache_from_numpy(pool, "cpu", members=False), POS, TABLE, tcfg)
    _close(logits, ref_logits)
    _close_tree(tpool, ref_pool)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), np.asarray(ref_logits).argmax(-1))


def test_prefill_into_slot_paged(model):
    cfg, tcfg, jp, tp = model
    pool = _rand_tree(unbox(j_api.init_paged_pool(cfg, N_PAGES, PS))[0], 23)
    toks = np.random.default_rng(24).integers(0, cfg.vocab_size, 16).astype(np.int32)
    ref = jax.jit(j_api.prefill_into_slot_paged, static_argnames="cfg")(
        jp, jnp.asarray(toks), jax.tree.map(jnp.asarray, pool), jnp.asarray(TABLE[1]), jnp.int32(5), cfg=cfg,
    )
    got = t_api.prefill_into_slot_paged(tp, toks, cache_from_numpy(pool, "cpu", members=False), TABLE[1], 5, tcfg)
    _close_tree(got, ref)


def test_prefill_into_slot_and_vector_decode(model):
    """The dense slot cache: chunked prefill into slot 1, then one decode
    step with per-slot (B,) positions."""
    cfg, tcfg, jp, tp = model
    cache = _rand_tree(unbox(j_api.init_cache(cfg, N_SLOTS, MAX_SEQ))[0], 25)
    rng = np.random.default_rng(26)
    toks = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    tok = rng.integers(0, cfg.vocab_size, (N_SLOTS, 1)).astype(np.int32)
    ref = jax.jit(j_api.prefill_into_slot, static_argnames="cfg")(
        jp, jnp.asarray(toks), jax.tree.map(jnp.asarray, cache), jnp.int32(1), jnp.int32(12), cfg=cfg,
    )
    got = t_api.prefill_into_slot(tp, toks, cache_from_numpy(cache, "cpu", members=False), 1, 12, tcfg)
    _close_tree(got, ref)
    ref_logits, ref = jax.jit(j_api.decode_step, static_argnames="cfg")(
        jp, jnp.asarray(tok), ref, jnp.asarray(POS), cfg=cfg,
    )
    logits, got = t_api.decode_step(tp, tok, got, POS, tcfg)
    _close(logits, ref_logits)
    _close_tree(got, ref)


def test_member_stacked_paged_step():
    """A k=3 tier: one decode step and one chunk against E member planes
    under one table, against the JAX package's per-member vmap over the
    E-stacked pool as its TierBackend holds it (bridged layer-major)."""
    cfg = dataclasses.replace(SMALL, dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    vals = numpy_values(cfg, 27, k=3)
    jv, tv = jax.tree.map(jnp.asarray, vals), params_from_numpy(vals, tcfg, device="cpu")
    pool0 = unbox(j_api.init_paged_pool(cfg, N_PAGES, PS))[0]
    pool = _rand_tree(jax.tree.map(lambda t: jnp.zeros((3,) + t.shape), pool0), 28)  # (E, L, P, ...)
    rng = np.random.default_rng(29)
    tok = rng.integers(0, 64, (3, N_SLOTS, 1)).astype(np.int32)
    toks = rng.integers(0, 64, 4).astype(np.int32)

    @jax.jit
    def ref_step(v, t, pl):
        return jax.vmap(lambda v, t, pl: j_api.decode_step_paged(v, t, pl, jnp.asarray(POS), jnp.asarray(TABLE), cfg))(v, t, pl)

    @jax.jit
    def ref_chunk(v, pl):
        return jax.vmap(lambda v, pl: j_api.prefill_into_slot_paged(v, jnp.asarray(toks), pl, jnp.asarray(TABLE[0]), 16, cfg))(v, pl)

    ref_logits, ref_pool = ref_step(jv, jnp.asarray(tok), jax.tree.map(jnp.asarray, pool))
    ref_pool = ref_chunk(jv, ref_pool)
    tpool = cache_from_numpy(pool, "cpu")
    logits, tpool = t_ens.ensemble_decode_step_paged(tv, tok, tpool, POS, TABLE, tcfg)
    tpool = t_ens.ensemble_prefill_into_slot_paged(tv, toks, tpool, TABLE[0], 16, tcfg)
    _close(logits, ref_logits)
    for k in ref_pool:
        _close(tpool[k].transpose(0, 1), ref_pool[k])


def test_copy_pool_page_matches_jax():
    cfg = dataclasses.replace(SMALL, dtype="float32")
    pool = _rand_tree(unbox(j_api.init_paged_pool(cfg, N_PAGES, PS))[0], 30)
    ref = j_api.copy_pool_page(jax.tree.map(jnp.asarray, pool), jnp.int32(3), jnp.int32(7))
    got = t_api.copy_pool_page(cache_from_numpy(pool, "cpu", members=False), 3, 7)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    stacked = cache_from_numpy(jax.tree.map(lambda t: np.stack([t, 2 * t]), pool), "cpu")  # (L, E, P, ...)
    t_api.copy_pool_page(stacked, 1, 4)
    assert torch.equal(stacked["k"][:, :, 4], stacked["k"][:, :, 1])


def test_paged_step_addresses_once():
    """The per-step addressing: one page lookup per slot, unmapped rows to
    the overflow sink."""
    from repro_torch.models.layers import paged_step

    step = paged_step(np.array([3, 9, 17]), TABLE, E=2, n_pages=N_PAGES, page_size=PS, device="cpu")
    assert step.write_page.tolist() == [[3, 5, N_PAGES - 1]]  # slot 2, page 2 unmapped -> sink
    assert step.write_off.tolist() == [[3, 1, 1]]
    assert step.cur_len.dtype == torch.int32 and step.cur_len.tolist() == [4, 10, 18]
    assert step.members.tolist() == [[0], [1]]

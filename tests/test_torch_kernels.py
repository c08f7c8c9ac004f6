"""Parity of the port's kernel modules (their plain PyTorch versions on the
CPU) with the JAX package's ``impl='xla'`` paths, on the same numpy
inputs.  Float outputs: rtol 1e-5 / atol 1e-6 for f32 (two frameworks sum
in different orders); bf16 attention outputs one bf16 step (rtol 2**-7,
atol 2**-8: both compute in f32 and round once); discrete outputs (argmax,
votes, index maps, counts, compacted payloads, paged K/V views) must be
equal.  ``test_torch_cuda.py``
holds the CUDA kernels against these plain versions on the card."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.agreement import ops as j_agree
from repro.kernels.compaction import ops as j_compact
from repro.kernels.decode_attention import ops as j_decode
from repro.kernels.flash_attention import ops as j_flash
from repro.models import layers as j_layers
from repro_torch.kernels.agreement import ops as t_agree
from repro_torch.kernels.agreement import ref as t_agree_ref
from repro_torch.kernels.compaction import ops as t_compact
from repro_torch.kernels.compaction import ref as t_compact_ref
from repro_torch.kernels.decode_attention import ops as t_decode
from repro_torch.kernels.decode_attention import ref as t_decode_ref
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention import ref as t_flash_ref

RTOL, ATOL = 1e-5, 1e-6


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16 else x)


# ---------------------------------------------------------------------------
# agreement
# ---------------------------------------------------------------------------


def _logits(E, B, V, seed, ties=False):
    x = np.random.default_rng(seed).standard_normal((E, B, V)).astype(np.float32)
    if ties:
        # every member's max is hit twice: argmax must keep the first index;
        # members 0/1 and 2/3 split 2-2 on some rows: smallest id must win
        x[:, :, 7] = x[:, :, 300 % V] = 10.0
        x[0, :3, 11] = x[1, :3, 11] = 20.0
        x[2, :3, 5] = x[3 % E, :3, 5] = 20.0
    return x


@pytest.mark.parametrize("E,B,V,ties", [(3, 8, 64, False), (4, 16, 500, True), (1, 4, 500, False), (3, 5, 2048 + 384, True)])
def test_agreement_matches_jax(E, B, V, ties):
    x = _logits(E, B, V, seed=V + B, ties=ties)
    got = t_agree.agreement(torch.from_numpy(x))
    ref = j_agree.agreement(jnp.asarray(x))
    for k in ("pred",):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for k in ("vote_frac", "mean_score"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL)
    oracle = t_agree_ref.agreement_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(got["pred"].numpy(), oracle["pred"].numpy())
    np.testing.assert_allclose(got["mean_score"].numpy(), oracle["mean_score"].numpy(), rtol=RTOL, atol=ATOL)


def _slice_edges(V, clusters=(2, 4, 8)):
    """Element indices where the card kernel's V slices meet (a row split
    over a cluster of C blocks, ceil(V / 4 / C) float4s a block)."""
    n4 = V // 4
    return sorted({4 * -(-n4 // C) * r for C in clusters for r in range(1, C)})


@pytest.mark.parametrize("V", [92544, 151936, 151937])
def test_agreement_ties_across_slice_edges_match_jax(V):
    """The max hit on both sides of every slice edge (and at the ragged
    tail): the first index wins, in the port and in the JAX package."""
    E, B = 3, 4
    x = _logits(E, B, V, seed=V)
    for r, edge in enumerate(_slice_edges(V)):
        b = r % B
        x[:, b, edge - 1] = x[:, b, edge] = 30.0 + r  # first index: edge - 1
    x[1, 0, V - 1] = x[1, 0, V - 2] = 90.0  # a tie at the tail: V - 2 wins
    x[2, 3, 0] = x[2, 3, V - 1] = 95.0  # head against tail: 0 wins
    m, idx, l = t_agree.member_stats(torch.from_numpy(x))
    j_m, j_idx, j_l = (np.asarray(a) for a in j_agree._xla_member_stats(jnp.asarray(x)))
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_array_equal(m.numpy(), j_m)
    np.testing.assert_allclose(l.numpy(), j_l, rtol=1e-5)
    assert idx[1, 0] == V - 2 and idx[2, 3] == 0
    got, ref = t_agree.agreement(torch.from_numpy(x)), j_agree.agreement(jnp.asarray(x))
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(ref["pred"]))
    np.testing.assert_allclose(got["mean_score"].numpy(), np.asarray(ref["mean_score"]), rtol=RTOL, atol=ATOL)


def test_member_stats_first_index_ties():
    x = np.zeros((2, 3, 500), np.float32)
    x[:, :, 123] = x[:, :, 456] = 1.0
    m, idx, l = t_agree.member_stats(torch.from_numpy(x))
    assert (idx == 123).all()
    np.testing.assert_allclose(l.numpy(), 498 * np.exp(-1.0) + 2, rtol=RTOL)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def _mask(kind, B, seed):
    if kind == "all":
        return np.ones(B, bool)
    if kind == "none":
        return np.zeros(B, bool)
    return np.random.default_rng(seed).random(B) < 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("kind", ["all", "none", "random"])
def test_compact_matches_jax(dtype, kind):
    rng = np.random.default_rng(3)
    B = 13
    x = rng.standard_normal((B, 5, 3)) * 1e3
    x = x.astype(np.int32) + 2**30 if dtype == "int32" else x.astype(getattr(ml_dtypes, dtype, np.float32))
    mask = _mask(kind, B, seed=4)
    tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(x)
    out, im, cnt = t_compact.compact(tx, torch.from_numpy(mask))
    j_out, j_im, j_cnt = j_compact.compact(jnp.asarray(x), jnp.asarray(mask))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    np.testing.assert_array_equal(_np(out), np.asarray(j_out).astype(_np(out).dtype))
    np.testing.assert_array_equal(im.numpy(), np.asarray(j_im))
    assert int(cnt) == int(j_cnt) == mask.sum()
    r_out, r_im, r_cnt = t_compact_ref.compact_ref(tx, torch.from_numpy(mask))
    assert torch.equal(out, r_out) and torch.equal(im, r_im) and int(r_cnt) == int(cnt)


@pytest.mark.parametrize("kind", ["all", "none", "random"])
def test_compact_tree_and_scatter_back(kind):
    rng = np.random.default_rng(5)
    B = 11
    tree = {
        "tokens": rng.integers(0, 2**31 - 1, (B, 7)).astype(np.int32),
        "feat": rng.standard_normal((B, 4)).astype(np.float32),
        "__idx": np.arange(B, dtype=np.int32),
    }
    mask = _mask(kind, B, seed=6)
    out, im, cnt = t_compact.compact_tree({k: torch.from_numpy(v) for k, v in tree.items()}, torch.from_numpy(mask))
    j_out, j_im, j_cnt = j_compact.compact_tree({k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(mask))
    for k in tree:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(j_out[k]))
    np.testing.assert_array_equal(im.numpy(), np.asarray(j_im))
    assert int(cnt) == int(j_cnt)
    vals = torch.arange(B, dtype=torch.float32) + 1
    back = t_compact.scatter_back(vals, im, B)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j_compact.scatter_back(jnp.asarray(vals.numpy()), jnp.asarray(im.numpy()), B)))
    np.testing.assert_array_equal(back.numpy(), t_compact_ref.scatter_back_ref(vals, im, B).numpy())


def test_gather_rows_more_rows_than_source():
    x = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    im = torch.tensor([3, -1, 0, 3, 1, -1], dtype=torch.int32)
    out = t_compact.gather_rows(x, im)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_compact.gather_rows(jnp.asarray(x.numpy()), jnp.asarray(im.numpy()))))


def _mixed_tree(B, n_leaves, seed):
    """Leaves of mixed dtypes whose rows are mostly not a multiple of 16
    bytes (f32 x 5 = 20 B, bf16 x 7 = 14 B, i32 x 3 = 12 B, uint8 x 5),
    plus a (B,) row index; more than 8 leaves spill into a second launch on
    the card.  Returns (numpy tree for JAX, torch tree)."""
    rng = np.random.default_rng(seed)
    makers = [
        lambda: rng.standard_normal((B, 5)).astype(np.float32),
        lambda: rng.standard_normal((B, 7)).astype(np.float32).astype(ml_dtypes.bfloat16),
        lambda: rng.integers(-2**31, 2**31 - 1, (B, 3)).astype(np.int32),
        lambda: rng.integers(0, 256, (B, 5)).astype(np.uint8),
        lambda: (rng.standard_normal((B, 2, 4)) * 1e4).astype(np.float32),
    ]
    j_tree = {f"leaf{i}": makers[i % len(makers)]() for i in range(n_leaves - 1)}
    j_tree["__idx"] = np.arange(B, dtype=np.int32)
    return j_tree, {k: _torch_of(v) for k, v in j_tree.items()}


def _torch_of(a):
    """A numpy array as a torch tensor; bf16 through f32, which is exact."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("n_leaves", [3, 5, 11])
@pytest.mark.parametrize("B", [1, 13, 40])
@pytest.mark.parametrize("kind", ["all", "none", "random"])
def test_compact_tree_mixed_dtypes_matches_jax_and_ref(kind, B, n_leaves):
    j_tree, tree = _mixed_tree(B, n_leaves, seed=B + n_leaves)
    mask = _mask(kind, B, seed=B)
    out, im, cnt = t_compact.compact_tree(tree, torch.from_numpy(mask))
    j_out, j_im, j_cnt = j_compact.compact_tree({k: jnp.asarray(v) for k, v in j_tree.items()}, jnp.asarray(mask))
    np.testing.assert_array_equal(im.numpy(), np.asarray(j_im))
    assert int(cnt) == int(j_cnt) == mask.sum()
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape
        np.testing.assert_array_equal(_np(out[k]), np.asarray(j_out[k]).astype(_np(out[k]).dtype))
        r_out, r_im, r_cnt = t_compact_ref.compact_ref(v, torch.from_numpy(mask))
        assert torch.equal(out[k], r_out) and torch.equal(im, r_im) and int(r_cnt) == int(cnt)


def _view_inputs(E, ps, dtype, seed, P=21, KVH=2, hd=8, B=3, n_pg=6):
    """Pools (E, P, KVH, ps, hd) and a shuffled (B, n_pg) table: slot b maps
    a prefix of distinct random pages, -1 past its length and at holes
    inside it."""
    rng = np.random.default_rng(seed)
    pools = [rng.standard_normal((E, P, KVH, ps, hd)).astype(np.float32) for _ in range(2)]
    if dtype == "bfloat16":
        pools = [p.astype(ml_dtypes.bfloat16) for p in pools]
    perm = rng.permutation(P - 1).astype(np.int32)
    pages = np.full((B, n_pg), -1, np.int32)
    used = 0
    for b, n in enumerate((n_pg, 4, 1)[:B]):
        pages[b, :n] = perm[used:used + n]
        used += n
    pages[0, 2] = pages[1, 1] = -1  # holes inside the used length
    return pools, pages


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("E", [1, 3])
def test_paged_kv_view_matches_jax_paged_view(E, ps, dtype):
    """The K/V view chunked prefill reads (one launch on the card) is, plane
    by plane, bitwise the JAX package's ``layers.paged_view``."""
    (kp, vp), pages = _view_inputs(E, ps, dtype, seed=E * ps)
    k_view, v_view = t_compact.paged_kv_view(_torch_of(kp), _torch_of(vp), torch.from_numpy(pages))
    B, n_pg = pages.shape
    assert k_view.shape == v_view.shape == (E * B, kp.shape[2], n_pg * ps, kp.shape[4])
    for got, pool in ((k_view, kp), (v_view, vp)):
        for e in range(E):
            ref = np.asarray(j_layers.paged_view(jnp.asarray(pool[e]), jnp.asarray(pages)))
            np.testing.assert_array_equal(_np(got[e * B:(e + 1) * B]), ref.astype(np.float32))
    # unmapped entries are zero rows; a 4-D pool is one member plane
    assert not k_view[:B].reshape(B, -1, n_pg, ps, kp.shape[4])[1, :, 1].any()
    if E == 1:
        k4, v4 = t_compact.paged_kv_view(_torch_of(kp[0]), _torch_of(vp[0]), torch.from_numpy(pages))
        assert torch.equal(k4, k_view) and torch.equal(v4, v_view)


@pytest.mark.parametrize("E", [1, 3])
def test_paged_kv_view_is_the_decode_paths_view(E):
    """Both views are bitwise ``paged_pool_view`` through the plain row
    gather — the view the paged decode's plain version attends over."""
    (kp, vp), pages = _view_inputs(E, 16, "bfloat16", seed=7)
    kt, vt, pt = _torch_of(kp), _torch_of(vp), torch.from_numpy(pages)
    k_view, v_view = t_compact.paged_kv_view(kt, vt, pt)
    assert torch.equal(k_view, t_decode.paged_pool_view(kt, pt, t_compact.gather_rows_plain))
    assert torch.equal(v_view, t_decode.paged_pool_view(vt, pt, t_compact.gather_rows_plain))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    dict(causal=True, window=None, softcap=None, starts=None),
    dict(causal=True, window=5, softcap=None, starts=None),
    dict(causal=True, window=None, softcap=3.0, starts=None),
    dict(causal=True, window=None, softcap=None, starts=[0, 5, 16]),
    dict(causal=True, window=6, softcap=2.0, starts=[3, 0, 9]),
    dict(causal=False, window=None, softcap=None, starts=None),
    # the head sizes the card's kernels run padded (16, 24, 32, 40), G 3 and
    # 7, and bf16 inputs (the JAX kernel upcasts any dtype to f32 inside)
    dict(causal=True, window=None, softcap=None, starts=None, hd=16, H=6, KVH=2),
    dict(causal=True, window=5, softcap=None, starts=[0, 5, 16], hd=24, H=7, KVH=1),
    dict(causal=True, window=None, softcap=3.0, starts=None, hd=32, H=4, KVH=4),
    dict(causal=False, window=None, softcap=None, starts=None, hd=40, H=6, KVH=2),
    dict(causal=True, window=None, softcap=None, starts=None, hd=24, H=6, KVH=2, dtype="bfloat16"),
    dict(causal=True, window=6, softcap=2.0, starts=[3, 0, 9], hd=40, H=7, KVH=1, dtype="bfloat16"),
]
BF16_TOL = dict(rtol=2.0**-7, atol=2.0**-8)


def _as(x, dtype):
    """numpy f32 -> the case's dtype (ml_dtypes bfloat16 for the JAX side)."""
    return x if dtype == "float32" else x.astype(ml_dtypes.bfloat16)


def _torch_in(x):
    return torch.from_numpy(x) if x.dtype == np.float32 else torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _qkv(B, Sq, Sk, H, KVH, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KVH, hd)).astype(np.float32))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_flash_attention_matches_jax(case):
    dtype = case.get("dtype", "float32")
    q, k, v = (_as(x, dtype) for x in _qkv(3, 16, 16, case.get("H", 4), case.get("KVH", 2), case.get("hd", 8), seed=7))
    starts = case["starts"]
    kw = dict(causal=case["causal"], window=case["window"], softcap=case["softcap"])
    got = t_flash.flash_attention(
        _torch_in(q), _torch_in(k), _torch_in(v), **kw,
        starts=None if starts is None else torch.tensor(starts, dtype=torch.int32),
    )
    ref = j_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw,
        starts=None if starts is None else jnp.asarray(starts, jnp.int32),
    )
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_TOL
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(np.asarray(ref).astype(np.float32)), **tol)
    oracle = t_flash_ref.attention_ref(
        _torch_in(q), _torch_in(k), _torch_in(v), **kw,
        starts=None if starts is None else torch.tensor(starts),
    )
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    if starts is not None:  # pure-padding rows emit zeros
        for b, s in enumerate(starts):
            assert not got[b, :s].any()


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [
    dict(cur_len=9, window=None, softcap=None, starts=None),
    dict(cur_len=[3, 16, 9], window=None, softcap=None, starts=None),
    dict(cur_len=12, window=4, softcap=None, starts=None),
    dict(cur_len=[5, 12, 16], window=None, softcap=2.5, starts=[0, 4, 10]),
    dict(cur_len=12, window=None, softcap=None, starts=[0, 12, 3]),
    # padded head sizes, G 3 and 7, bf16 inputs
    dict(cur_len=[3, 16, 9], window=None, softcap=None, starts=None, hd=16, G=3),
    dict(cur_len=12, window=4, softcap=None, starts=None, hd=24, G=7),
    dict(cur_len=[5, 12, 16], window=None, softcap=2.5, starts=[0, 4, 10], hd=32, G=1),
    dict(cur_len=9, window=None, softcap=None, starts=None, hd=40, G=3, dtype="bfloat16"),
    dict(cur_len=12, window=None, softcap=None, starts=[0, 12, 3], hd=24, G=7, dtype="bfloat16"),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_decode_attention_matches_jax(case):
    rng = np.random.default_rng(8)
    B, KVH, S = 3, 2, 16
    G, hd, dtype = case.get("G", 4), case.get("hd", 8), case.get("dtype", "float32")
    q = _as(rng.standard_normal((B, 1, KVH * G, hd)).astype(np.float32), dtype)
    kc = _as(rng.standard_normal((B, KVH, S, hd)).astype(np.float32), dtype)
    vc = _as(rng.standard_normal((B, KVH, S, hd)).astype(np.float32), dtype)
    cur, starts = case["cur_len"], case["starts"]
    kw = dict(window=case["window"], softcap=case["softcap"])
    got = t_decode.decode_attention_bksd(
        _torch_in(q), _torch_in(kc), _torch_in(vc),
        cur if np.isscalar(cur) else torch.tensor(cur, dtype=torch.int32), **kw,
        starts=None if starts is None else torch.tensor(starts, dtype=torch.int32),
    )
    ref = j_decode.decode_attention_bksd(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cur, jnp.int32), **kw,
        starts=None if starts is None else jnp.asarray(starts, jnp.int32),
    )
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else BF16_TOL
    assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(np.asarray(ref).astype(np.float32)), **tol)
    oracle = t_decode_ref.decode_attention_ref(
        _torch_in(q), _torch_in(kc), _torch_in(vc),
        torch.as_tensor(cur), **kw, starts=None if starts is None else torch.tensor(starts),
    )
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)

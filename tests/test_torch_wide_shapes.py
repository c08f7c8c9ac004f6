"""The plain versions at the shapes and types the card's kernels took on
last: attention at hd 256, 100, 300 and 320 and at G 32 and 71
(multi-query), in f16 too; the SSD at (P 64, N 128), (P 128, N 128) and (P 48, N 24); WKV6
at D 128 and 48 — each held against the JAX package's XLA route on the
same numpy inputs.  The card tests (``tests/test_torch_cuda.py``, ``-k
"wide or f16"`` and the new SSD / WKV6 cases) hold the kernels to these
plain versions.

Each JAX reference is computed once, in a module fixture.  Tolerances:
f32 attention outputs rtol 1e-5 / atol 1e-5 (two frameworks sum in other
orders); f16 attention outputs atol 4e-3 (both round the f32 result to
f16, ~2**-10 relative, and may sum the f32 softmax in other orders before
that); the scans' outputs and states normwise 1e-5 of the largest
element (``test_torch_recurrent.py``'s ``_normwise``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as j_decode
from repro.kernels.flash_attention import ops as j_flash
from repro.kernels.mamba2_ssd import ops as j_ssd
from repro.kernels.rwkv6_wkv import ops as j_wkv
from repro_torch.kernels.decode_attention import ops as t_decode
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.mamba2_ssd import ops as t_ssd
from repro_torch.kernels.rwkv6_wkv import ops as t_wkv

F32_TOL = dict(rtol=1e-5, atol=1e-5)
F16_ATOL = 4e-3

FLASH = {  # name: (B, S, H, KVH, hd, dtype, window, softcap)
    "hd256": (2, 48, 8, 2, 256, np.float32, None, None),
    "hd100-window-cap": (2, 48, 6, 2, 100, np.float32, 17, 5.0),
    "g32-f16": (2, 40, 32, 1, 64, np.float16, None, None),
    "hd256-f16": (1, 32, 4, 2, 256, np.float16, 11, None),
    "hd300": (1, 24, 4, 2, 300, np.float32, None, 3.0),
}
DECODE = {  # name: (B, H, KVH, S, hd, window, with starts)
    "hd256": (3, 8, 2, 40, 256, None, True),
    "g32": (3, 32, 1, 40, 64, 9, False),
    "g71": (2, 71, 1, 33, 64, None, True),
    "hd320": (2, 4, 2, 30, 320, 12, False),
}
PAGED = {  # name: (E, B, H, KVH, hd, P, ps, n_pg)
    "hd256": (2, 3, 4, 2, 256, 9, 4, 3),
    "g32": (1, 3, 32, 1, 64, 9, 4, 3),
    "g71": (2, 2, 71, 1, 48, 7, 4, 3),
}
SSD = {  # name: (B, S, H, P, G, N, chunk)
    "p64-n128": (2, 96, 2, 64, 1, 128, 32),
    "p128-n128": (1, 64, 2, 128, 1, 128, 32),
    "p48-n24": (2, 80, 4, 48, 2, 24, 32),
}
WKV = {"d128": (2, 40, 2, 128), "d48": (2, 45, 3, 48)}  # name: (B, S, H, D)


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _flash_inputs(name):
    B, S, H, KVH, hd, dt, window, cap = FLASH[name]
    rng = _rng(name)
    q = rng.standard_normal((B, S, H, hd)).astype(dt)
    k, v = (rng.standard_normal((B, S, KVH, hd)).astype(dt) for _ in range(2))
    return q, k, v, dict(causal=True, window=window, softcap=cap)


def _decode_inputs(name):
    B, H, KVH, S, hd, window, with_starts = DECODE[name]
    rng = _rng(name)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, KVH, S, hd)).astype(np.float32) for _ in range(2))
    cur = np.asarray([S, S // 2 + 1, 3][:B], np.int32)
    starts = np.asarray([0, 4, 1][:B], np.int32) if with_starts else None
    return q, k, v, cur, starts, window


def _paged_inputs(name):
    E, B, H, KVH, hd, P, ps, n_pg = PAGED[name]
    rng = _rng(name)
    q = rng.standard_normal((E * B, 1, H, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((E, P, KVH, ps, hd)).astype(np.float32) for _ in range(2))
    pages = np.stack([rng.permutation(P)[:n_pg] for _ in range(B)]).astype(np.int32)
    pages[0, -1] = -1  # an unmapped page past the first slot's length
    cur = np.asarray([n_pg * ps - ps, n_pg * ps, 5][:B], np.int32)
    return q, kp, vp, pages, cur


def _ssd_inputs(name):
    B, S, H, P, G, N, _ = SSD[name]
    rng = _rng(name)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.5).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32) for _ in range(2))
    s0 = (rng.standard_normal((B, H, N, P)) * 0.2).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _wkv_inputs(name):
    B, S, H, D = WKV[name]
    rng = _rng(name)
    r, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    logw = (-np.exp(rng.standard_normal((B, S, H, D)) * 0.5)).astype(np.float32)
    u = (rng.standard_normal((H, D)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, D, D)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.fixture(scope="module")
def jax_refs():
    """Every JAX reference of this module, computed once."""
    out = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for name in FLASH:
            q, k, v, kw = _flash_inputs(name)
            out["flash", name] = np.asarray(j_flash._xla_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
        for name in DECODE:
            q, k, v, cur, starts, window = _decode_inputs(name)
            out["decode", name] = np.asarray(j_decode._xla_decode_bksd(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cur), window=window, softcap=None,
                starts=None if starts is None else jnp.asarray(starts)))
        for name in PAGED:
            q, kp, vp, pages, cur = _paged_inputs(name)
            B = pages.shape[0]
            out["paged", name] = np.concatenate([np.asarray(j_decode._xla_decode_paged(
                jnp.asarray(q[e * B:(e + 1) * B]), jnp.asarray(kp[e]), jnp.asarray(vp[e]), jnp.asarray(pages),
                jnp.asarray(cur), window=None, softcap=None)) for e in range(kp.shape[0])])
        for name in SSD:
            x, dt, A, Bm, Cm, s0 = _ssd_inputs(name)
            out["ssd", name] = tuple(np.asarray(a) for a in j_ssd._xla_ssd(
                *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=SSD[name][-1], initial_state=jnp.asarray(s0),
                return_final_state=True))
        for name in WKV:
            r, k, v, logw, u, s0 = _wkv_inputs(name)
            out["wkv", name] = tuple(np.asarray(a) for a in j_wkv._xla_wkv6(
                *(jnp.asarray(a) for a in (r, k, v, logw, u)), chunk=32, initial_state=jnp.asarray(s0),
                return_final_state=True))
    return out


def _normwise(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    assert np.abs(np.asarray(got, np.float32) - ref).max() <= tol * np.abs(ref).max() + 1e-6


@pytest.mark.parametrize("name", list(FLASH))
def test_flash_plain_matches_jax_wide(jax_refs, name):
    q, k, v, kw = _flash_inputs(name)
    got = t_flash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert got.dtype == torch.from_numpy(q).dtype
    ref = jax_refs["flash", name]
    if q.dtype == np.float16:
        np.testing.assert_allclose(got.float().numpy(), ref.astype(np.float32), rtol=0, atol=F16_ATOL)
    else:
        np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_plain_matches_jax_wide(jax_refs, name):
    q, k, v, cur, starts, window = _decode_inputs(name)
    got = t_decode.decode_attention_bksd(*(torch.from_numpy(a) for a in (q, k, v, cur)), window=window,
                                         starts=None if starts is None else torch.from_numpy(starts))
    np.testing.assert_allclose(got.numpy(), jax_refs["decode", name], **F32_TOL)


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_plain_matches_jax_wide(jax_refs, name):
    q, kp, vp, pages, cur = _paged_inputs(name)
    got = t_decode.decode_attention_paged(*(torch.from_numpy(a) for a in (q, kp, vp, pages, cur)))
    np.testing.assert_allclose(got.numpy(), jax_refs["paged", name], **F32_TOL)


@pytest.mark.parametrize("name", list(SSD))
def test_ssd_plain_matches_jax_wide(jax_refs, name):
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(name)
    y, h = t_ssd.ssd_plain(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk=SSD[name][-1],
                           initial_state=torch.from_numpy(s0))
    jy, jh = jax_refs["ssd", name]
    _normwise(y.numpy(), jy)
    _normwise(h.numpy(), jh)


@pytest.mark.parametrize("name", list(WKV))
def test_wkv6_plain_matches_jax_wide(jax_refs, name):
    r, k, v, logw, u, s0 = _wkv_inputs(name)
    y, s = t_wkv.wkv6_plain(*(torch.from_numpy(a) for a in (r, k, v, logw, u)), initial_state=torch.from_numpy(s0))
    jy, js = jax_refs["wkv", name]
    _normwise(y.numpy(), jy)
    _normwise(s.numpy(), js)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [3, 100, 256, 300])
def test_wrappers_route_every_head_size_and_dtype(dtype, hd):
    """What the card's wrappers hand the kernels, checked on the CPU: the
    16-bit routes pad hd to a multiple of 8 (zero columns, which leave a
    dot product exact), the f32 route takes hd as it is; the padded call
    equals the unpadded one, and the scale stays that of the real hd."""
    hp = t_flash.padded_head(hd, dtype)
    assert hp == (hd if dtype == torch.float32 or hd > t_flash.BUILT_HEAD else -(-hd // 8) * 8)
    assert t_flash.head_size_ok(hd)
    g = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn(2, 9, 4, hd, generator=g) for _ in range(3))
    want = t_flash.flash_attention_plain(q, k, v)
    pq, pk, pv = (t_flash.pad_head(t, hp) for t in (q, k, v))
    assert pq.shape[-1] == hp and pq.is_contiguous()
    # the padded inputs at the real hd's scale: the plain version's scale is
    # 1/sqrt of the width it is given, so undo it on q
    got = t_flash.flash_attention_plain(pq * (hp / hd) ** 0.5, pk, pv)[..., :hd]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert t_flash.unit_of(dtype) == {torch.float16: "f16", torch.bfloat16: "bf16"}.get(dtype, "f32")
    assert not t_flash.head_size_ok(t_flash.MAX_HEAD + 1)


@pytest.mark.parametrize("P,N,dtype,route", [
    (64, 64, torch.bfloat16, "dual"), (64, 128, torch.bfloat16, "dual"), (128, 128, torch.bfloat16, "dual"),
    (96, 32, torch.bfloat16, "dual"), (48, 24, torch.bfloat16, "scan"), (64, 8, torch.bfloat16, "scan"),
    (64, 64, torch.float32, "step"), (128, 8, torch.float32, "step"), (64, 128, torch.float32, "scan"),
    (200, 16, torch.float32, "scan"),
])
def test_ssd_route_and_cost(P, N, dtype, route):
    """Which SSD kernel a call runs, and the unit its cost is charged on."""
    assert t_ssd.route(dtype, P, N) == route
    x = torch.empty(1, 70, 2, P, dtype=dtype, device="meta")
    bc = torch.empty(1, 70, 1, N, dtype=dtype, device="meta")
    c = t_ssd.cost(x, torch.empty(1, 70, 2, device="meta"), torch.empty(2, device="meta"), bc, bc)
    assert c["unit"] == ("tf32" if route == "dual" else "f32")


@pytest.mark.parametrize("eq,xs,ws", [
    ("ebsd,edf->ebsf", (3, 2, 5, 16), (3, 16, 24)),
    ("ebsf,efd->ebsd", (3, 2, 5, 24), (3, 24, 16)),
    ("ebsd,edhk->ebshk", (3, 2, 5, 16), (3, 16, 4, 8)),
    ("ebshk,ehkd->ebsd", (3, 2, 5, 4, 8), (3, 4, 8, 16)),
    ("ebd,edv->ebv", (1, 7, 16), (1, 16, 40)),
])
def test_member_by_member_products_equal_the_batched_one(eq, xs, ws):
    """``chip_member_products.py``'s member route of a weight product (E
    2-D products on contiguous slices) computes the batched einsum's values
    (f32, rtol 1e-6 / atol 1e-6: other summation orders) and output shape,
    and member e's output depends on member e's slices alone, so what the
    probe compares on the card is the layers' product."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_member_products.py"
    spec = importlib.util.spec_from_file_location("chip_member_products", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    g = torch.Generator().manual_seed(len(eq))
    x, w = torch.randn(*xs, generator=g), torch.randn(*ws, generator=g)
    got, want = probe.member_by_member(eq, x, w), torch.einsum(eq, x, w)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(probe.member_by_member(eq, x[:1], w[:1])[0], got[0], rtol=0, atol=0)


def test_mixed_dtypes_are_routed_to_f32():
    """Inputs of two of the kernels' types are mixed (the card runs them in
    f32); one type, or an integer among them, is not."""
    t = lambda dt: torch.zeros(1, dtype=dt)  # noqa: E731
    assert t_flash.mixed(t(torch.float32), t(torch.bfloat16), t(torch.bfloat16))
    assert t_flash.mixed(t(torch.float16), t(torch.bfloat16))
    assert not t_flash.mixed(t(torch.bfloat16), t(torch.bfloat16))
    assert not t_flash.mixed(t(torch.bfloat16), t(torch.int32))

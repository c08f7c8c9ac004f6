"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (the kernels have no CPU or
interpret mode) and skips without one; the file imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: argmax, max, index maps, compacted payloads and paged K/V
views exact; sumexp rel 1e-5; bf16 and f16 attention outputs abs 2e-2
(inputs ~N(0, 1); the flash kernel rounds P to 16 bits before the PV
product), f32
attention outputs (the SIMT route) normwise 1e-5; the paged decode kernel
bitwise equal to the dense one on the gathered view, in both dtypes and at
every head size.  The SSD and WKV6
scans (the WKV6 kernel and the SSD's f32 route run the per-step
recurrence, the SSD's bf16 route the chunked dual form on TF32 tensor
cores, the plain versions the chunked form in f32): outputs
normwise 1e-5 in f32 and 2**-7 in bf16 (two f32 results each rounded to
bf16 may land one bf16 step apart: at most 2**-7 of the element),
final states normwise 1e-3; against the per-step ref, which shares the
kernels' arithmetic, the same output bounds and states normwise 1e-5.
Under strong decay (log-decay down to -exp(6) and beyond) the chunked
form's exponents ecum_t - cum_s are differences of two large sums that
lose up to ~|cum| * 6e-8: there the WKV6 kernel is held to the plain
version at normwise 2e-2 and to the per-step ref as above."""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.agreement import ops as agree
from repro_torch.kernels.compaction import ops as compact
from repro_torch.kernels.decode_attention import ops as decode
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.mamba2_ssd import ops as ssd
from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _randn(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("V", [500, 92544, 151936])
def test_agreement_ragged_vocab_and_ties(cuda, V):
    x = _randn(3, 8, V, seed=V)
    x[:, :4, V // 3] = x[:, :4, V - 1] = 40.0
    x = x.to(cuda)
    before = kernels.launch_counts()["agreement"]
    m, idx, l = agree.member_stats(x)
    pm, pidx, pl = agree.member_stats_plain(x)
    assert torch.equal(idx, pidx) and torch.equal(m, pm)
    torch.testing.assert_close(l, pl, rtol=1e-5, atol=0)
    assert (idx[:, :4] == V // 3).all()
    assert kernels.launch_counts()["agreement"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("kind", ["all", "none", "random"])
def test_compact_exact(cuda, dtype, kind):
    B = 1500  # more than one scan chunk
    x = (_randn(B, 33) * 1e4).to(dtype).to(cuda)
    mask = {"all": torch.ones(B, dtype=torch.bool), "none": torch.zeros(B, dtype=torch.bool),
            "random": _randn(B, seed=1) > 0}[kind].to(cuda)
    out, im, cnt = compact.compact(x, mask)
    p_im, p_cnt = compact.compact_indices_plain(mask)
    assert torch.equal(im, p_im) and int(cnt) == int(p_cnt)
    assert torch.equal(out, compact.gather_rows_plain(x, p_im))


def _device_kernels(fn):
    """Device kernels one call of ``fn`` launches, from torch.profiler (a
    trace now and then holds no device records: take another)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return len([e for e in dev if not e.name.lower().startswith(("memcpy", "memset"))])
    pytest.fail("torch.profiler recorded no device activity")


# CUgraphNodeType (the CUDA driver API's cuda.h)
_GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}


def _graph_nodes(fn):
    """The device work one call of ``fn`` issues: ``fn`` captured as a CUDA
    graph (on a side stream, ``keep_graph`` so the graph outlives its
    instantiation; nothing runs) and its nodes' types read through the
    driver API, by type name ('kernel', 'memcpy', ...).  Unlike a profiler
    trace, a captured graph always holds every launch."""
    import ctypes

    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        fn()
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        t = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        kinds.append(_GRAPH_NODE_TYPES.get(t.value, t.value))
    graph.reset()
    return kinds


def _mixed_leaves(B, n, cuda):
    """``n`` leaves of mixed dtypes and row widths (20, 14, 12, 5, 32, 1024
    bytes, and the (B,) row index), as the tier transition hands them over."""
    g = torch.Generator().manual_seed(B + n)
    makers = [
        lambda: torch.randn(B, 5, generator=g),
        lambda: torch.randn(B, 7, generator=g).to(torch.bfloat16),
        lambda: torch.randint(-2**31, 2**31 - 1, (B, 3), generator=g, dtype=torch.int32),
        lambda: torch.randint(0, 256, (B, 5), generator=g, dtype=torch.uint8),
        lambda: torch.randn(B, 2, 4, generator=g),
        lambda: torch.randint(0, 151936, (B, 256), generator=g, dtype=torch.int32),
    ]
    tree = {f"leaf{i}": makers[i % len(makers)]().to(cuda) for i in range(n - 1)}
    tree["__idx"] = torch.arange(B, dtype=torch.int32, device=cuda)
    return tree


@pytest.mark.parametrize("n_leaves", [1, 3, 8, 11])
@pytest.mark.parametrize("B", [1, 32, 1500, 5000])
@pytest.mark.parametrize("kind", ["all", "none", "random"])
def test_compact_tree_one_launch(cuda, kind, B, n_leaves):
    """The scan and up to 8 leaves in one launch (a further one for leaves
    9-11), every leaf exact; B 5000 spans many scan steps and blocks."""
    tree = _mixed_leaves(B, n_leaves, cuda)
    mask = {"all": torch.ones(B, dtype=torch.bool), "none": torch.zeros(B, dtype=torch.bool),
            "random": _randn(B, seed=B) > 0}[kind].to(cuda)
    before = kernels.launch_counts()["compaction"]
    out, im, cnt = compact.compact_tree(tree, mask)
    launches = 1 if n_leaves <= compact.MAX_LEAVES else 2
    assert kernels.launch_counts()["compaction"] == before + launches
    p_im, p_cnt = compact.compact_indices_plain(mask)
    assert torch.equal(im, p_im) and int(cnt) == int(p_cnt) == int(mask.sum())
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], compact.gather_rows_plain(v, p_im)), k
    if B == 1500 and kind == "random":
        assert _device_kernels(lambda: compact.compact_tree(tree, mask)) == launches


def test_compact_indices_and_gather_rows_one_launch_each(cuda):
    mask = (_randn(777, seed=3) > 0.3).to(cuda)
    before = kernels.launch_counts()["compaction"]
    im, cnt = compact.compact_indices(mask)
    p_im, p_cnt = compact.compact_indices_plain(mask)
    assert torch.equal(im, p_im) and int(cnt) == int(p_cnt)
    x = _randn(500, 9, seed=4).to(cuda, torch.bfloat16)
    idx = torch.tensor([499, -1, 0, 7, 7, -1, 3], dtype=torch.int32, device=cuda)  # fewer rows than x, repeats
    assert torch.equal(compact.gather_rows(x, idx), compact.gather_rows_plain(x, idx))
    assert kernels.launch_counts()["compaction"] == before + 2
    assert _device_kernels(lambda: compact.compact_indices(mask)) == 1


def _pools_and_table(E, P, KVH, ps, hd, B, n_pg, dtype, cuda, seed):
    """Two pools and a shuffled (B, n_pg) table: slot b maps a random number
    of distinct pages, -1 past it and at a hole inside it."""
    g = torch.Generator().manual_seed(seed)
    kp, vp = (torch.randn(E, P, KVH, ps, hd, generator=g).to(dtype) for _ in range(2))
    perm = torch.randperm(P - 1, generator=g).to(torch.int32)
    pages = torch.full((B, n_pg), -1, dtype=torch.int32)
    used = 0
    for b in range(B):
        n = int(torch.randint(1, n_pg + 1, (1,), generator=g))
        pages[b, :n] = perm[used:used + n]
        used += n
        if n > 2:
            pages[b, n // 2] = -1
    return kp.to(cuda), vp.to(cuda), pages.to(cuda)


# chunked admission's shapes: qwen2.5-3b (E 3, KVH 2) and internlm2-1.8b
# (E 1, KVH 8), hd 128, 16-row pages, n_pg 32; then page size 64, several
# slots, hd 80 and a tile that is not a multiple of 16 bytes (f32, hd 3)
VIEW_CASES = [
    dict(E=3, KVH=2, ps=16, hd=128, B=1, n_pg=32, dtype=torch.bfloat16),
    dict(E=1, KVH=8, ps=16, hd=128, B=1, n_pg=32, dtype=torch.bfloat16),
    dict(E=3, KVH=2, ps=64, hd=128, B=4, n_pg=8, dtype=torch.bfloat16),
    dict(E=2, KVH=4, ps=16, hd=80, B=3, n_pg=5, dtype=torch.bfloat16),
    dict(E=1, KVH=2, ps=16, hd=3, B=2, n_pg=6, dtype=torch.float32),
]


@pytest.mark.parametrize("case", VIEW_CASES, ids=lambda c: f"E{c['E']}-KVH{c['KVH']}-ps{c['ps']}-hd{c['hd']}-B{c['B']}")
def test_paged_kv_view_bitwise_one_launch(cuda, case):
    c = dict(case)
    B, n_pg = c.pop("B"), c.pop("n_pg")
    kp, vp, pages = _pools_and_table(c["E"], B * n_pg + 1, c["KVH"], c["ps"], c["hd"], B, n_pg,
                                     c["dtype"], cuda, seed=B * n_pg)
    before = kernels.launch_counts()["compaction"]
    k_view, v_view = compact.paged_kv_view(kp, vp, pages)
    assert kernels.launch_counts()["compaction"] == before + 1
    p_k, p_v = compact.paged_kv_view_plain(kp, vp, pages)
    assert torch.equal(k_view, p_k) and torch.equal(v_view, p_v)
    assert k_view.is_contiguous() and v_view.is_contiguous()
    if c["E"] == 1:  # a 4-D pool is one member plane
        k4, v4 = compact.paged_kv_view(kp[0], vp[0], pages)
        assert torch.equal(k4, k_view) and torch.equal(v4, v_view)
    assert _device_kernels(lambda: compact.paged_kv_view(kp, vp, pages)) == 1


def _slice_edges(V, clusters=(2, 4, 8)):
    """Element indices where the kernel's V slices meet (a row over a
    cluster of C blocks, ceil(V / 4 / C) float4s a block)."""
    n4 = V // 4
    return sorted({4 * -(-n4 // C) * r for C in clusters for r in range(1, C)})


@pytest.mark.parametrize("V", [500, 92544, 151936, 151937])
@pytest.mark.parametrize("EB", [(3, 8), (3, 32)])
def test_agreement_clusters_ties_across_slices(cuda, EB, V):
    """E*B 24 and 96 rows (clusters of 8 and 4 blocks at the long
    vocabularies), the max tied across every candidate slice edge, at the
    ragged tail and between head and tail; V 151937 starts most rows off a
    16-byte boundary.  Argmax and max exact, sumexp rel 1e-5, one launch."""
    E, B = EB
    x = _randn(E, B, V, seed=V + B)
    for r, edge in enumerate(e for e in _slice_edges(V) if e < V):
        x[:, r % B, edge - 1] = x[:, r % B, edge] = 30.0 + r
    x[1, 0, V - 1] = x[1, 0, V - 2] = 90.0
    x[2, B - 1, 0] = x[2, B - 1, V - 1] = 95.0
    x = x.to(cuda)
    before = kernels.launch_counts()["agreement"]
    m, idx, l = agree.member_stats(x)
    assert kernels.launch_counts()["agreement"] == before + 1
    pm, pidx, pl = agree.member_stats_plain(x)
    assert torch.equal(idx, pidx) and torch.equal(m, pm)
    torch.testing.assert_close(l, pl, rtol=1e-5, atol=0)
    assert idx[1, 0] == V - 2 and idx[2, B - 1] == 0


FLASH_CASES = [
    dict(causal=True, window=None, softcap=None, starts=None),
    dict(causal=True, window=25, softcap=None, starts=None),
    dict(causal=True, window=None, softcap=3.0, starts=None),
    dict(causal=True, window=None, softcap=None, starts=[0, 25, 80]),
    dict(causal=True, window=30, softcap=2.0, starts=[15, 0, 100]),
    dict(causal=False, window=None, softcap=None, starts=None),
]


def _held(got, ref, dtype):
    """bf16 and f16 outputs abs 2e-2; f32 outputs (the SIMT route) normwise 1e-5."""
    if dtype == torch.float32:
        assert got.dtype == torch.float32
        _normwise(got, ref, 1e-5)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=2e-2)


# head sizes: the built widths (64, 80, 128) and the padded ones of the
# examples (16, 24, 32, 40) and beyond (8, 56, 96); G 3 and 7 among the groups
ATTN_DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("hd,heads", [(64, (8, 2)), (128, (8, 2)), (80, (4, 4)), (16, (4, 2)), (24, (6, 2)),
                                      (32, (8, 8)), (40, (7, 1)), (8, (2, 2)), (56, (3, 1)), (96, (4, 2))])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_flash_attention(cuda, case, hd, heads, dtype):
    q, k, v = (_randn(3, 100, h, hd, seed=i).to(cuda, dtype) for i, h in enumerate(heads + heads[1:]))
    starts = None if case["starts"] is None else torch.tensor(case["starts"], dtype=torch.int32, device=cuda)
    kw = dict(causal=case["causal"], window=case["window"], softcap=case["softcap"], starts=starts)
    before = kernels.launch_counts()["flash_attention"]
    got = flash.flash_attention(q, k, v, **kw)
    assert kernels.launch_counts()["flash_attention"] == before + 1
    _held(got, flash.flash_attention_plain(q, k, v, **kw), dtype)
    if starts is not None:
        for b, s in enumerate(case["starts"]):
            assert not got[b, :s].any()


# the widths and types past the examples': hd 256 (Gemma 2 and 3), 200 (the
# 256 body, padded), 100 and 20 and 3 (off the multiples of 8: zero-padded
# by the wrapper, the scale of the real hd), 300 and 520 (attend_any), G 32
# (multi-query), in bf16, f16 and f32
WIDE_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("hd,heads", [(256, (8, 2)), (256, (4, 4)), (200, (4, 2)), (100, (6, 2)), (20, (4, 2)),
                                      (3, (2, 1)), (128, (32, 1)), (64, (8, 2)), (80, (4, 4)), (128, (8, 2)),
                                      (300, (4, 2)), (520, (2, 1))])
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[4], FLASH_CASES[5]],
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_flash_attention_wide_heads_and_f16(cuda, case, hd, heads, dtype):
    test_flash_attention(cuda, case, hd, heads, dtype)


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("hd", [256, 100])
def test_flash_attention_wide_heads_long(cuda, hd, dtype):
    """hd 256 and 100 over 1100 keys: the ring wraps many times."""
    q = _randn(2, 1100, 8, hd, seed=0).to(cuda, dtype)
    k, v = (_randn(2, 1100, 2, hd, seed=i).to(cuda, dtype) for i in (1, 2))
    starts = torch.tensor([500, 3], dtype=torch.int32, device=cuda)
    for kw in (dict(causal=True), dict(causal=True, window=300, starts=starts)):
        _held(flash.flash_attention(q, k, v, **kw), flash.flash_attention_plain(q, k, v, **kw), dtype)


# long and ragged: Sq, Sk of 1000 and more (not multiples of the tiles, so the
# two-stage ring wraps many times), starts mid-ring, a single K tile, hd 80 and 64
FLASH_LONG_CASES = [
    dict(B=2, Sq=1100, Sk=1100, H=8, KVH=2, hd=128, causal=True, window=None, starts=None),
    dict(B=2, Sq=1037, Sk=1100, H=8, KVH=2, hd=128, causal=False, window=None, starts=[500, 3]),
    dict(B=2, Sq=1100, Sk=1100, H=8, KVH=2, hd=64, causal=True, window=300, starts=[500, 3]),
    dict(B=2, Sq=1000, Sk=1000, H=4, KVH=4, hd=80, causal=True, window=None, starts=[500, 3]),
    dict(B=2, Sq=1000, Sk=1037, H=4, KVH=4, hd=80, causal=False, window=77, starts=None),
    dict(B=3, Sq=50, Sk=20, H=8, KVH=2, hd=128, causal=False, window=None, starts=None),
    dict(B=3, Sq=20, Sk=20, H=4, KVH=4, hd=64, causal=True, window=None, starts=[0, 5, 20]),
]


@pytest.mark.parametrize("case", FLASH_LONG_CASES, ids=lambda c: f"Sq{c['Sq']}-Sk{c['Sk']}-hd{c['hd']}")
def test_flash_attention_long_and_ragged(cuda, case):
    c = case
    q = _randn(c["B"], c["Sq"], c["H"], c["hd"], seed=0).to(cuda, torch.bfloat16)
    k, v = (_randn(c["B"], c["Sk"], c["KVH"], c["hd"], seed=i).to(cuda, torch.bfloat16) for i in (1, 2))
    starts = None if c["starts"] is None else torch.tensor(c["starts"], dtype=torch.int32, device=cuda)
    kw = dict(causal=c["causal"], window=c["window"], starts=starts)
    before = kernels.launch_counts()["flash_attention"]
    got = flash.flash_attention(q, k, v, **kw).float()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    torch.testing.assert_close(got, flash.flash_attention_plain(q, k, v, **kw).float(), rtol=0, atol=2e-2)
    if starts is not None and c["causal"]:
        for b, s in enumerate(c["starts"]):
            assert not got[b, :s].any()


DECODE_CASES = [
    dict(cur_len=90, window=None, softcap=None, starts=None),
    dict(cur_len=[3, 130, 77], window=None, softcap=None, starts=None),
    dict(cur_len=120, window=40, softcap=None, starts=None),
    dict(cur_len=[5, 120, 130], window=None, softcap=2.5, starts=[0, 40, 100]),
    dict(cur_len=100, window=None, softcap=None, starts=[0, 100, 3]),
]


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("G,hd", [(8, 128), (2, 64), (1, 128), (1, 80), (3, 16), (7, 24), (1, 32), (16, 40),
                                  (4, 80), (11, 56)])
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_decode_attention(cuda, case, G, hd, dtype):
    B, KVH, S = 3, 2, 130
    q = _randn(B, 1, KVH * G, hd, seed=0).to(cuda, dtype)
    kc = _randn(B, KVH, S, hd, seed=1).to(cuda, dtype)
    vc = _randn(B, KVH, S, hd, seed=2).to(cuda, dtype)
    cur = case["cur_len"] if np.isscalar(case["cur_len"]) else torch.tensor(case["cur_len"], dtype=torch.int32, device=cuda)
    starts = None if case["starts"] is None else torch.tensor(case["starts"], dtype=torch.int32, device=cuda)
    kw = dict(window=case["window"], softcap=case["softcap"], starts=starts)
    before = kernels.launch_counts()["decode_attention"]
    got = decode.decode_attention_bksd(q, kc, vc, cur, **kw)
    assert kernels.launch_counts()["decode_attention"] == before + 1
    _held(got, decode.decode_attention_plain(q, kc, vc, cur, **kw), dtype)
    if starts is not None:  # rows with nothing visible are exact zeros
        assert not got[starts >= torch.as_tensor(cur, device=cuda).expand(B)].any()


# past the examples' widths and groups: hd 256, 100, 20 and 3, G 32, 64 and
# 71 (Falcon-7B's multi-query: the heads in tiles of 16, the last one short),
# in bf16, f16 and f32
@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("G,hd", [(2, 256), (8, 256), (32, 128), (64, 128), (71, 64), (17, 20), (3, 100), (1, 3),
                                  (2, 300), (1, 520)])
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_decode_attention_wide_groups_and_f16(cuda, case, G, hd, dtype):
    test_decode_attention(cuda, case, G, hd, dtype)


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("G,hd", [(4, 256), (32, 128), (71, 64)])
@pytest.mark.parametrize("S", [512, 4096])
def test_decode_attention_wide_long(cuda, S, G, hd, dtype):
    """Long caches at the new widths and groups: every split count, hd
    256's one-stage loop over many tiles, window and starts edges."""
    case = DECODE_LONG_CASES[0] if S == 512 else DECODE_LONG_CASES[1]
    B, KVH = 3, 1
    q = _randn(B, 1, KVH * G, hd, seed=0).to(cuda, dtype)
    kc, vc = (_randn(B, KVH, S, hd, seed=i).to(cuda, dtype) for i in (1, 2))
    cur = torch.tensor(_long_cur(case["cur"], S), dtype=torch.int32, device=cuda)
    starts = None
    if case["starts"] is not None:
        starts = torch.tensor([x if x >= 0 else S + x for x in case["starts"]], dtype=torch.int32, device=cuda)
    kw = dict(window=S // 3 if case["window"] else None, softcap=case["softcap"], starts=starts)
    _held(decode.decode_attention_bksd(q, kc, vc, cur, **kw), decode.decode_attention_plain(q, kc, vc, cur, **kw), dtype)


@pytest.mark.parametrize("qt,kt", [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float16),
                                   (torch.float16, torch.float32)])
def test_attention_mixed_dtypes(cuda, qt, kt):
    """q in one type and K, V in another: the kernels run all three in f32
    (one launch of the f32 route) and return q's type, as the plain
    versions compute; held to the plain versions at the tolerance of q's
    type."""
    q = _randn(2, 50, 8, 64, seed=1).to(cuda, qt)
    k, v = (_randn(2, 50, 2, 64, seed=i).to(cuda, kt) for i in (2, 3))
    before = kernels.launch_counts()["flash_attention"]
    got = flash.flash_attention(q, k, v, causal=True)
    assert kernels.launch_counts()["flash_attention"] == before + 1 and got.dtype == qt
    _held(got, flash.flash_attention_plain(q, k, v, causal=True), qt)
    qd = _randn(3, 1, 8, 64, seed=4).to(cuda, qt)
    kc, vc = (_randn(3, 2, 130, 64, seed=i).to(cuda, kt) for i in (5, 6))
    cur = torch.tensor([130, 7, 64], dtype=torch.int32, device=cuda)
    _held(decode.decode_attention_bksd(qd, kc, vc, cur), decode.decode_attention_plain(qd, kc, vc, cur), qt)
    qp, kp, vp, pages, cur = (t.to(cuda) for t in _paged_case(2, 3, 2, 4, 64, 256, 16, kt, seed=7))
    qp = qp.to(qt)
    _held(decode.decode_attention_paged(qp, kp, vp, pages, cur), decode.decode_attention_paged_plain(qp, kp, vp, pages, cur), qt)


# long caches split across a thread-block cluster (128-row tiles, up to 8
# splits): window and starts edges inside and across split boundaries, splits
# with nothing visible, cur_len 1, pure-pad rows (exact zeros)
DECODE_LONG_CASES = [
    dict(cur="half", window=None, softcap=None, starts=[0, 100, -3]),
    dict(cur="tail", window="third", softcap=None, starts=None),
    dict(cur="pad", window=None, softcap=None, starts=[-1, 128, 1]),
    dict(cur="half", window=None, softcap=20.0, starts=[0, 129, 0]),
]


def _long_cur(kind, S):
    return {"half": [1, S // 2 + 7, S], "tail": [S, S - 1, 65], "pad": [S, 129, 1]}[kind]


@pytest.mark.parametrize("S", [512, 2048, 4096])
@pytest.mark.parametrize("G,hd", [(8, 128), (2, 64), (1, 80)])
@pytest.mark.parametrize("case", DECODE_LONG_CASES, ids=lambda c: f"{c['cur']}-w={c['window']}-cap={c['softcap']}")
def test_decode_attention_long(cuda, case, G, hd, S):
    B, KVH = 3, 2
    q = _randn(B, 1, KVH * G, hd, seed=0).to(cuda, torch.bfloat16)
    kc = _randn(B, KVH, S, hd, seed=1).to(cuda, torch.bfloat16)
    vc = _randn(B, KVH, S, hd, seed=2).to(cuda, torch.bfloat16)
    cur_l = _long_cur(case["cur"], S)
    cur = torch.tensor(cur_l, dtype=torch.int32, device=cuda)
    starts = None
    if case["starts"] is not None:
        starts = torch.tensor([x if x >= 0 else S + x for x in case["starts"]], dtype=torch.int32, device=cuda)
    kw = dict(window=S // 3 if case["window"] else None, softcap=case["softcap"], starts=starts)
    got = decode.decode_attention_bksd(q, kc, vc, cur, **kw).float()
    torch.testing.assert_close(got, decode.decode_attention_plain(q, kc, vc, cur, **kw).float(), rtol=0, atol=2e-2)
    if starts is not None:
        pad = starts >= cur
        assert not got[pad].any()


# the head-group sizes of llama4 (5), mixtral and internvl2 (6) and
# command-r-plus (12): the cases above at both head sizes, and one (row, kv
# head) pair at S = 128 n for n = 1..8, so the split plan takes every
# cluster size and the merge chunks G * hd = 640, 768, 1536 outputs n ways
@pytest.mark.parametrize("G", [5, 6, 12])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_decode_attention_odd_groups(cuda, case, G, hd):
    test_decode_attention(cuda, case, G, hd, torch.bfloat16)


@pytest.mark.parametrize("G", [5, 6, 12])
@pytest.mark.parametrize("n_split", list(range(1, 9)))
def test_decode_attention_odd_groups_every_split(cuda, G, n_split):
    S, hd = 128 * n_split, 128
    q = _randn(1, 1, G, hd, seed=0).to(cuda, torch.bfloat16)
    kc = _randn(1, 1, S, hd, seed=1).to(cuda, torch.bfloat16)
    vc = _randn(1, 1, S, hd, seed=2).to(cuda, torch.bfloat16)
    for cur in (S, S - 77, 1):
        got = decode.decode_attention_bksd(q, kc, vc, cur).float()
        torch.testing.assert_close(got, decode.decode_attention_plain(q, kc, vc, cur).float(), rtol=0, atol=2e-2)


def _paged_case(E, B, KVH, G, hd, S, ps, dtype, seed):
    """(q, k pool, v pool, shuffled table, cur_len) on the host: B slots of
    random lengths up to S in ps-row pages, E member planes."""
    n_pg = S // ps
    gen = torch.Generator().manual_seed(seed)
    cur_l = torch.randint(1, S + 1, (B,), generator=gen).tolist()
    P = sum(-(-c // ps) for c in cur_l) + 1
    pages = torch.full((B, n_pg), -1, dtype=torch.int32)
    perm, used = torch.randperm(P - 1, generator=gen), 0
    for b, c in enumerate(cur_l):
        n = -(-c // ps)
        pages[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    q = _randn(E * B, 1, KVH * G, hd, seed=3).to(dtype)
    kp, vp = (_randn(E, P, KVH, ps, hd, seed=i).to(dtype) for i in (4, 5))
    return q, kp, vp, pages, torch.tensor(cur_l, dtype=torch.int32)


def _paged_held(got, q, kp, vp, pages, cur, dtype, **kw):
    """Within tolerance of the plain version and bitwise the dense kernel
    on the gathered view."""
    E = kp.shape[0] if kp.dim() == 5 else 1
    view_k, view_v = (decode.paged_pool_view(t, pages, compact.gather_rows_plain) for t in (kp, vp))
    assert torch.equal(got, decode.decode_attention_bksd(q, view_k, view_v, cur.repeat(E), **kw))
    _held(got, decode.decode_attention_paged_plain(q, kp, vp, pages, cur, **kw), dtype)


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [128, 16, 24, 32, 40, 80])
@pytest.mark.parametrize("G,KVH", [(8, 2), (2, 8), (3, 2), (7, 1), (16, 1)])
def test_decode_attention_paged_bitwise_dense_head_sizes(cuda, G, KVH, hd, dtype):
    """The paged kernel bitwise the dense kernel on the gathered view at
    every head size and in f32 (3 members x 8 slots of 512 rows, 16-row
    pages)."""
    q, kp, vp, pages, cur = (t.to(cuda) for t in _paged_case(3, 8, KVH, G, hd, 512, 16, dtype, seed=hd + G))
    before = kernels.launch_counts()["decode_attention_paged"]
    got = decode.decode_attention_paged(q, kp, vp, pages, cur)
    assert kernels.launch_counts()["decode_attention_paged"] == before + 1
    _paged_held(got, q, kp, vp, pages, cur, dtype)


@pytest.mark.parametrize("dtype", WIDE_DTYPES, ids=["bf16", "f16", "f32"])
@pytest.mark.parametrize("G,KVH,hd", [(32, 1, 128), (71, 1, 64), (4, 2, 256), (2, 2, 100), (20, 1, 3), (2, 2, 300)])
def test_decode_attention_paged_bitwise_dense_wide(cuda, G, KVH, hd, dtype):
    """The paged kernel at the new widths, groups and f16: within tolerance
    of the plain version and bitwise the dense kernel on the gathered view."""
    q, kp, vp, pages, cur = (t.to(cuda) for t in _paged_case(3, 4, KVH, G, hd, 512, 16, dtype, seed=hd + G))
    before = kernels.launch_counts()["decode_attention_paged"]
    got = decode.decode_attention_paged(q, kp, vp, pages, cur)
    assert kernels.launch_counts()["decode_attention_paged"] == before + 1
    _paged_held(got, q, kp, vp, pages, cur, dtype)


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", [40, 128])
@pytest.mark.parametrize("G", list(range(1, 17)))
def test_decode_attention_every_group(cuda, G, hd, dtype):
    """Every G from 1 to 16, dense (with starts, a pure-pad row and a
    window) and paged (bitwise the dense kernel), against the plain
    versions; S 700 spans several splits of the bf16 plan."""
    B, KVH, S = 3, 2, 700
    q = _randn(B, 1, KVH * G, hd, seed=G).to(cuda, dtype)
    kc, vc = (_randn(B, KVH, S, hd, seed=G + i).to(cuda, dtype) for i in (1, 2))
    cur = torch.tensor([S, 300, 1], dtype=torch.int32, device=cuda)
    for kw in (dict(), dict(starts=torch.tensor([0, 300, 0], dtype=torch.int32, device=cuda)), dict(window=129)):
        got = decode.decode_attention_bksd(q, kc, vc, cur, **kw)
        _held(got, decode.decode_attention_plain(q, kc, vc, cur, **kw), dtype)
    q, kp, vp, pages, cur = (t.to(cuda) for t in _paged_case(2, 3, KVH, G, hd, 256, 16, dtype, seed=G))
    _paged_held(decode.decode_attention_paged(q, kp, vp, pages, cur), q, kp, vp, pages, cur, dtype)


def test_attention_kernels_refuse_what_they_do_not_take(cuda):
    """No fallback: hd past ``MAX_HEAD``, heads that do not split into the KV heads,
    and integer inputs raise, with their reason, and launch nothing."""
    bf = torch.bfloat16
    mk = lambda *s, dtype=bf: _randn(*s).to(cuda, dtype)  # noqa: E731
    before = kernels.launch_counts()
    big = flash.MAX_HEAD + 8  # past what attend_any keeps in shared memory
    with pytest.raises(ValueError, match=f"hd from 1 to {flash.MAX_HEAD}"):
        flash.flash_attention(mk(1, 4, 2, big), mk(1, 4, 2, big), mk(1, 4, 2, big))
    with pytest.raises(ValueError, match=f"hd from 1 to {flash.MAX_HEAD}"):
        decode.decode_attention_bksd(mk(1, 1, 2, big), mk(1, 2, 8, big), mk(1, 2, 8, big), 8)
    with pytest.raises(ValueError, match="H a multiple of KVH"):
        decode.decode_attention_bksd(mk(1, 1, 5, 64), mk(1, 2, 8, 64), mk(1, 2, 8, 64), 8)
    with pytest.raises(TypeError, match="dtype"):  # an integer among the inputs
        flash.flash_attention(mk(1, 4, 2, 64), mk(1, 4, 2, 64), torch.zeros(1, 4, 2, 64, device=cuda, dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        decode.decode_attention_bksd(*(torch.zeros(1, 1, 2, 64, device=cuda, dtype=torch.int32) for _ in range(3)), 1)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("G,KVH", [(8, 2), (2, 8), (5, 8), (6, 8), (12, 8)])
@pytest.mark.parametrize("S", [512, 4096])
def test_decode_attention_paged_bitwise_dense(cuda, G, KVH, S):
    """The serving shapes (3 members x 8 slots, G 8 and G 2, 16-row pages)
    and S 4096: the paged kernel is bitwise the dense kernel on the gathered
    view, with the same split plan."""
    E, B, ps, hd = 3, 8, 16, 128
    n_pg = S // ps
    gen = torch.Generator().manual_seed(S + G)
    cur_l = torch.randint(1, S + 1, (B,), generator=gen).tolist()
    P = sum(-(-c // ps) for c in cur_l) + 1
    pages = torch.full((B, n_pg), -1, dtype=torch.int32)
    perm, used = torch.randperm(P - 1, generator=gen), 0
    for b, c in enumerate(cur_l):
        n = -(-c // ps)
        pages[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    q = _randn(E * B, 1, KVH * G, hd, seed=3).to(cuda, torch.bfloat16)
    kp = _randn(E, P, KVH, ps, hd, seed=4).to(cuda, torch.bfloat16)
    vp = _randn(E, P, KVH, ps, hd, seed=5).to(cuda, torch.bfloat16)
    pages, cur = pages.to(cuda), torch.tensor(cur_l, dtype=torch.int32, device=cuda)
    got = decode.decode_attention_paged(q, kp, vp, pages, cur)
    view_k, view_v = (decode.paged_pool_view(t, pages, compact.gather_rows_plain) for t in (kp, vp))
    assert torch.equal(got, decode.decode_attention_bksd(q, view_k, view_v, cur.repeat(E)))
    ref = decode.decode_attention_paged_plain(q, kp, vp, pages, cur)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=2e-2)


PAGED_CASES = [
    dict(ps=16, cur=[1, 37, 128, 70], holes=[], window=None, softcap=None),  # cur_len off the page grid
    dict(ps=16, cur=[100, 5, 128, 64], holes=[(0, 2), (3, 1)], window=None, softcap=None),  # -1 inside cur_len
    dict(ps=64, cur=[200, 64, 1, 129], holes=[], window=None, softcap=None),
    dict(ps=16, cur=[120, 33, 128, 9], holes=[], window=40, softcap=20.0),
]


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("G,hd", [(8, 128), (2, 128), (1, 64), (5, 128), (6, 64), (12, 128), (3, 16), (7, 40),
                                  (1, 80), (4, 32), (16, 24)])
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: f"ps={c['ps']}-cur={c['cur']}-w={c['window']}")
def test_decode_attention_paged(cuda, case, G, hd, E, dtype):
    """Shuffled tables, -1 entries past and inside cur_len, member planes
    under one table: within 2e-2 of the plain version and bitwise the dense
    kernel on the gathered view."""
    B, KVH, ps = 4, 2, case["ps"]
    n_pg = -(-max(case["cur"]) // ps) + 1
    P = B * n_pg + 1
    gen = torch.Generator().manual_seed(ps + G)
    pages = torch.full((B, n_pg), -1, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=gen)
    used = 0
    for b, c in enumerate(case["cur"]):
        n = -(-c // ps)
        pages[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    for b, i in case["holes"]:
        pages[b, i] = -1
    q = _randn(E * B, 1, KVH * G, hd, seed=0).to(cuda, dtype)
    kp = _randn(E, P, KVH, ps, hd, seed=1).to(cuda, dtype)
    vp = _randn(E, P, KVH, ps, hd, seed=2).to(cuda, dtype)
    pages, cur = pages.to(cuda), torch.tensor(case["cur"], dtype=torch.int32, device=cuda)
    kw = dict(window=case["window"], softcap=case["softcap"])
    before = kernels.launch_counts()["decode_attention_paged"]
    got = decode.decode_attention_paged(q, kp, vp, pages, cur, **kw)
    assert kernels.launch_counts()["decode_attention_paged"] == before + 1
    _paged_held(got, q, kp, vp, pages, cur, dtype, **kw)


def test_decode_attention_paged_wants_device_table(cuda):
    q = _randn(2, 1, 8, 64).to(cuda, torch.bfloat16)
    kp = _randn(4, 2, 16, 64).to(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode.decode_attention_paged(q, kp, kp, torch.zeros((2, 1), dtype=torch.int32),
                                      torch.ones(2, dtype=torch.int32, device=cuda))


def _normwise(got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), (err, tol)


SSD_CASES = [  # (B, S, H, P, G, N, E, h0, dtype of x, B, C and y)
    (2, 128, 4, 32, 2, 16, 1, False, torch.float32),
    (1, 256, 2, 64, 1, 64, 1, True, torch.float32),
    (2, 96, 4, 32, 4, 16, 2, True, torch.bfloat16),  # ragged vs the plain chunk, per-member A
    (3, 200, 3, 16, 3, 8, 3, True, torch.float32),
    (6, 1, 4, 64, 1, 64, 3, True, torch.bfloat16),  # one step
    (4, 300, 8, 64, 1, 64, 2, False, torch.bfloat16),  # zamba2 widths, ragged
    # the dual form's chunks of 64 at zamba2's P/N: within one chunk, on a
    # boundary and past it, ragged
    *((2, S, 8, 64, 1, 64, 2, True, torch.bfloat16) for S in (1, 16, 63, 64, 65, 256, 300)),
    (2, 130, 8, 32, 2, 32, 2, True, torch.bfloat16),  # G 2: four heads a group
    (3, 77, 8, 64, 4, 16, 3, False, torch.bfloat16),
    (2, 100, 4, 32, 1, 64, 1, True, torch.bfloat16),
    *((2, S, 8, 64, 2, 64, 2, True, torch.float32) for S in (65, 300)),  # the f32 route
    # the published Mamba2 shapes (d_state 128, headdim 64) and P 128 on the
    # dual form (P in blocks of 64 or 32 columns: 128, 96)
    (2, 300, 4, 64, 1, 128, 2, True, torch.bfloat16),
    (2, 65, 4, 64, 2, 128, 1, False, torch.bfloat16),
    (2, 200, 2, 128, 1, 128, 1, True, torch.bfloat16),
    (2, 130, 4, 128, 2, 64, 2, True, torch.bfloat16),
    (2, 100, 4, 96, 2, 32, 1, True, torch.bfloat16),
    # every other shape: the run-time (P, N) scan, bf16 and f32, state in
    # shared memory or (N 700 at 64 columns) in the output
    (2, 77, 4, 48, 2, 24, 2, True, torch.bfloat16),
    (2, 40, 2, 64, 1, 8, 1, True, torch.bfloat16),
    (3, 1, 4, 48, 2, 24, 3, True, torch.bfloat16),
    (2, 100, 2, 64, 1, 128, 1, True, torch.float32),
    (2, 50, 2, 200, 1, 16, 1, True, torch.float32),
    (2, 77, 4, 48, 2, 24, 2, False, torch.float32),
    (1, 10, 2, 64, 1, 700, 1, True, torch.float32),
]


@pytest.mark.parametrize("B,S,H,P,G,N,E,h0,dtype", SSD_CASES)
def test_mamba2_ssd(cuda, B, S, H, P, G, N, E, h0, dtype):
    gen = torch.Generator().manual_seed(S + N)
    x = torch.randn(B, S, H, P, generator=gen).to(cuda, dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen)).mul(0.5).to(cuda)
    A = (-torch.exp(torch.randn(E, H, generator=gen) * 0.3)).to(cuda)
    Bm, Cm = (torch.randn(B, S, G, N, generator=gen).mul(0.5).to(cuda, dtype) for _ in range(2))
    s0 = torch.randn(B, H, N, P, generator=gen).mul(0.2).to(cuda) if h0 else None
    before = kernels.launch_counts()["mamba2_ssd"]
    y, hT = ssd.ssd(x, dt, A, Bm, Cm, initial_state=s0, return_final_state=True)
    assert kernels.launch_counts()["mamba2_ssd"] == before + 1
    py, ph = ssd.ssd_plain(x, dt, A, Bm, Cm, initial_state=s0)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    _normwise(y, py, 1e-5 if dtype == torch.float32 else 2**-7)
    _normwise(hT, ph, 1e-3)
    if dtype == torch.float32:
        ry, rh = ssd_ref.ssd_ref(x, dt, A, Bm, Cm, initial_state=s0, return_final_state=True)
        _normwise(y, ry, 1e-5)
        _normwise(hT, rh, 1e-5)


@pytest.mark.parametrize("pad", [0, 1])
def test_mamba2_ssd_reads_xbc_views_in_one_launch(cuda, pad):
    """x, B and C as the Mamba2 block hands them over: strided views of one
    xBC tensor, read in place — one wrapper call, one device kernel.  With
    a padding column the rows leave 16-byte boundaries and the wrapper
    copies the views first (same result).  The device work is counted as
    the nodes of the call captured in a CUDA graph (``_graph_nodes``), which
    does not depend on a profiler delivering its records."""
    B, S, H, P, G, N, E = 3, 200, 16, 64, 1, 64, 3
    gen = torch.Generator().manual_seed(7)
    xBC = torch.randn(B, S, H * P + 2 * G * N + pad, generator=gen).to(cuda, torch.bfloat16)
    x = xBC[..., :H * P].reshape(B, S, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xBC[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen) - 2.0).to(cuda)
    A = (-torch.exp(torch.randn(E, H, generator=gen) * 0.3)).to(cuda)
    s0 = torch.randn(B, H, N, P, generator=gen).mul(0.2).to(cuda)
    ssd.ssd(x, dt, A, Bm, Cm, initial_state=s0)  # build and load outside the capture
    torch.cuda.synchronize()
    before = kernels.launch_counts()["mamba2_ssd"]
    nodes = _graph_nodes(lambda: ssd.ssd(x, dt, A, Bm, Cm, initial_state=s0, return_final_state=True))
    assert kernels.launch_counts()["mamba2_ssd"] == before + 1
    if not pad:  # the call is one kernel, no copies
        assert nodes == ["kernel"], nodes
    else:  # the copies of the views, then the one scan kernel
        assert nodes.count("kernel") >= 2 and set(nodes) <= {"kernel", "memcpy"}, nodes
    y, hT = ssd.ssd(x, dt, A, Bm, Cm, initial_state=s0, return_final_state=True)
    py, ph = ssd.ssd_plain(x, dt, A, Bm, Cm, initial_state=s0)
    _normwise(y, py, 2**-7)
    _normwise(hT, ph, 1e-3)


WKV_CASES = [  # (B, S, H, D, E, logw scale, dtype)
    (2, 128, 3, 32, 1, 0.5, torch.float32),
    (1, 64, 2, 64, 1, 0.5, torch.float32),
    (2, 80, 2, 32, 2, 0.5, torch.bfloat16),  # ragged, per-member u
    (8, 1, 4, 64, 1, 0.5, torch.bfloat16),  # a decode step with a state
    (3, 45, 2, 16, 3, 2.0, torch.float32),  # strong decay: exp(logw) underflows
    (4, 70, 4, 64, 2, 3.0, torch.bfloat16),
    # the register-tiled kernel: a decode step, a short admission chunk, a
    # ragged pass, a full prefill; per-member u
    *((3, S, 4, D, 3, 0.5, torch.bfloat16) for S in (1, 16, 77, 256) for D in (32, 64)),
    (2, 77, 4, 64, 2, 3.0, torch.float32),  # strong decay in f32
    # 320 (row, head) pairs: the kernel's larger tile (fewer pairs take the smaller one)
    (5, 1, 64, 64, 5, 0.5, torch.bfloat16),
    (5, 77, 64, 64, 1, 0.5, torch.bfloat16),
    (5, 16, 64, 32, 5, 0.5, torch.float32),
    (5, 70, 64, 64, 1, 3.0, torch.bfloat16),
    (5, 45, 64, 16, 1, 2.0, torch.float32),
    # every other D: the run-time-D kernel (D 128 and 48, a decode step, a
    # small D, D 400 with the state in the output)
    (2, 50, 2, 128, 1, 0.5, torch.float32),
    (3, 33, 3, 48, 3, 0.5, torch.bfloat16),
    (2, 1, 2, 128, 2, 0.5, torch.bfloat16),
    (2, 70, 4, 128, 1, 3.0, torch.bfloat16),
    (1, 20, 1, 8, 1, 2.0, torch.float32),
    (1, 9, 1, 400, 1, 0.5, torch.float32),
]


@pytest.mark.parametrize("B,S,H,D,E,scale,dtype", WKV_CASES)
def test_rwkv6_wkv(cuda, B, S, H, D, E, scale, dtype):
    gen = torch.Generator().manual_seed(S + D)
    r, k, v = (torch.randn(B, S, H, D, generator=gen).to(cuda, dtype) for _ in range(3))
    logw = (-torch.exp(torch.randn(B, S, H, D, generator=gen) * scale)).to(cuda)
    u = torch.randn(E, H, D, generator=gen).mul(0.5).to(cuda)
    s0 = torch.randn(B, H, D, D, generator=gen).mul(0.1).to(cuda)
    before = kernels.launch_counts()["rwkv6_wkv"]
    y, sT = wkv.wkv6(r, k, v, logw, u, initial_state=s0, return_final_state=True)
    assert kernels.launch_counts()["rwkv6_wkv"] == before + 1
    py, ps = wkv.wkv6_plain(r, k, v, logw, u, initial_state=s0)
    assert y.dtype == dtype and torch.isfinite(y.float()).all() and torch.isfinite(sT).all()
    out_tol = 1e-5 if dtype == torch.float32 else 2**-7
    strong = scale >= 2.0  # the chunked plain version's exponents lose digits
    _normwise(y, py, 2e-2 if strong else out_tol)
    _normwise(sT, ps, 2e-2 if strong else 1e-3)
    ry, rs = wkv_ref.wkv6_ref(r, k, v, logw, u, initial_state=s0, return_final_state=True)
    _normwise(y, ry, out_tol)
    _normwise(sT, rs, 1e-5)


def test_rwkv6_wkv_copies_views_off_16_byte_boundaries(cuda):
    """Views at an odd storage offset (r, k, v, logw, u and the state each
    one element into a larger buffer) give what aligned copies give: the
    kernel's 16-byte loads read a copy, in one launch."""
    B, S, H, D, E = 3, 20, 4, 64, 3
    gen = torch.Generator().manual_seed(11)
    r, k, v = (torch.randn(B, S, H, D, generator=gen).to(cuda, torch.bfloat16) for _ in range(3))
    logw = (-torch.exp(torch.randn(B, S, H, D, generator=gen) * 0.5)).to(cuda)
    u = torch.randn(E, H, D, generator=gen).mul(0.5).to(cuda)
    s0 = torch.randn(B, H, D, D, generator=gen).mul(0.1).to(cuda)

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    views = [offset(t) for t in (r, k, v, logw, u, s0)]
    assert all(t.data_ptr() % 16 for t in views)
    before = kernels.launch_counts()["rwkv6_wkv"]
    y, sT = wkv.wkv6(*views[:5], initial_state=views[5], return_final_state=True)
    assert kernels.launch_counts()["rwkv6_wkv"] == before + 1
    ry, rs = wkv.wkv6(r, k, v, logw, u, initial_state=s0, return_final_state=True)
    assert torch.equal(y, ry) and torch.equal(sT, rs)


def test_recurrent_kernels_refuse_what_they_do_not_take(cuda):
    """Every (P, N) and every D runs (the run-time kernels); inputs that do
    not fit each other raise, with the kernel's name, and launch nothing."""
    before = kernels.launch_counts()["mamba2_ssd"], kernels.launch_counts()["rwkv6_wkv"]
    x = torch.zeros(1, 4, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="ssd"):  # B and C of different shapes
        ssd.ssd(x, torch.ones(1, 4, 2, device=cuda), -torch.ones(2, device=cuda),
                torch.zeros(1, 4, 1, 12, device=cuda), torch.zeros(1, 4, 1, 16, device=cuda))
    xb = torch.zeros(1, 4, 2, 48, device=cuda, dtype=torch.bfloat16)
    bb = torch.zeros(1, 4, 1, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ssd"):  # dt of the wrong length
        ssd.ssd(xb, torch.ones(1, 3, 2, device=cuda), -torch.ones(2, device=cuda), bb, bb)
    with pytest.raises(TypeError, match="ssd"):  # B and C in x's dtype, as the block hands them over
        ssd.ssd(xb[..., :32], torch.ones(1, 4, 2, device=cuda), -torch.ones(2, device=cuda),
                torch.zeros(1, 4, 1, 16, device=cuda), torch.zeros(1, 4, 1, 16, device=cuda))
    x3 = torch.zeros(1, 4, 3, 32, device=cuda)  # 3 heads do not split into 2 groups
    with pytest.raises(ValueError, match="ssd"):
        ssd.ssd(x3, torch.ones(1, 4, 3, device=cuda), -torch.ones(3, device=cuda),
                torch.zeros(1, 4, 2, 16, device=cuda), torch.zeros(1, 4, 2, 16, device=cuda))
    r = torch.zeros(1, 4, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="wkv6"):  # u of another width
        wkv.wkv6(r, r, r, r, torch.zeros(2, 40, device=cuda))
    assert (kernels.launch_counts()["mamba2_ssd"], kernels.launch_counts()["rwkv6_wkv"]) == before


# ---------------------------------------------------------------------------
# compile-once serving: captured decode steps and chunk buckets
# ---------------------------------------------------------------------------


def test_graph_set_replays_read_new_inputs_and_count_launches(cuda):
    """A captured paged decode replays on freshly staged inputs (each call
    bitwise the kernel called directly), counts once as a capture, and adds
    the capture's launches at every replay: 4 calls, 4 launches."""
    from repro_torch.serve.graphs import GraphSet, trace_count

    gen = torch.Generator().manual_seed(7)
    E, B, P, KVH, ps, hd, n_pg, G = 2, 3, 13, 2, 16, 64, 4, 4
    k_pool = torch.randn(E, P, KVH, ps, hd, generator=gen).to(cuda, torch.bfloat16)
    v_pool = torch.randn(E, P, KVH, ps, hd, generator=gen).to(cuda, torch.bfloat16)
    gs = GraphSet(cuda)
    key = "cuda-test/decode_paged"

    def fn(q, pages, cur):
        return decode.decode_attention_paged(q, k_pool, v_pool, pages, cur)

    before, count = kernels.launch_counts()["decode_attention_paged"], trace_count(key)
    rng = np.random.default_rng(0)
    for _ in range(4):
        q = torch.randn(E * B, 1, KVH * G, hd, generator=gen).to(torch.bfloat16)
        pages = np.stack([rng.permutation(P - 1)[:n_pg] for _ in range(B)]).astype(np.int32)
        cur = rng.integers(1, n_pg * ps + 1, B).astype(np.int32)
        out = gs.run(key, fn, q, pages, cur)
        ref = decode.decode_attention_paged(q.to(cuda), k_pool, v_pool, torch.as_tensor(pages, device=cuda),
                                            torch.as_tensor(cur, device=cuda))
        assert torch.equal(out, ref)
    assert trace_count(key) == count + 1
    assert kernels.launch_counts()["decode_attention_paged"] == before + 4 + 4


@pytest.mark.parametrize("arch,paged", [("qwen2.5-3b", True), ("qwen2.5-3b", False),
                                        ("zamba2-2.7b", False), ("rwkv6-7b", False),
                                        ("mixtral-8x22b", True), ("llama4-maverick-400b-a17b", True),
                                        ("mixtral-8x22b", False)])
def test_graphed_serve_continuous_matches_eager(cuda, arch, paged):
    """A one-tier k=3 cascade at reduced width: the graphed
    ``serve_continuous`` (twice) emits bitwise the eager oracle's tokens
    with the same launches per kernel, and the second graphed run captures
    nothing."""
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig
    from repro_torch.serve.graphs import trace_counts

    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    server = CascadeServer([CascadeTier(cfg, ens.init_ensemble(cfg, 3, gen, cuda), TierSpec("t", "vote", 0.5, k=3),
                                        device=cuda)], device=cuda)
    config = ServeConfig(n_slots=3, max_seq=96, page_size=16, paged=paged)

    def run(eager):
        rng = np.random.default_rng(1)
        reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32), max_new_tokens=5)
                for n in rng.integers(2, 60, 7)]
        kernels.reset_launch_counts()
        done = {r.rid: r for r in server.serve_continuous(reqs, config, eager=eager)}
        return [done[r.rid].output.tolist() for r in reqs], kernels.launch_counts()

    eager, l_eager = run(True)
    graphed, l_graphed = run(False)
    counts = trace_counts()
    again, l_again = run(False)
    assert trace_counts() == counts
    assert eager == graphed == again
    assert l_eager == l_graphed == l_again
    assert sum(l_eager.values()) > 0


# ---------------------------------------------------------------------------
# compile-once batch programs and sampling
# ---------------------------------------------------------------------------


def _reduced_tier(arch, cuda, temperature=0.0, k=3, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.core import ensemble as ens
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import CascadeTier

    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return CascadeTier(cfg, ens.init_ensemble(cfg, k, gen, cuda), TierSpec("t", "vote", 0.5, k=k),
                       temperature=temperature, device=cuda)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b", "rwkv6-7b"])
def test_graphed_generate_matches_eager(cuda, arch, temperature):
    """A k=3 tier's graphed generate (prefill into the static cache, decode
    at a (B,) device position) emits bitwise the eager grow_cache oracle's
    tokens with the same launches per kernel, twice, and the second call
    captures nothing; the classify logits of a replay equal the eager ones."""
    from repro_torch.serve.graphs import trace_counts

    tier = _reduced_tier(arch, cuda, temperature)
    toks = np.random.default_rng(2).integers(0, tier.cfg.vocab_size, (8, 24)).astype(np.int32)

    def run(eager):
        kernels.reset_launch_counts()
        out = tier.generate(toks, 6, seed=4, eager=eager)
        return out, kernels.launch_counts()

    eager, l_eager = run(True)
    graphed, l_graphed = run(False)
    counts = trace_counts()
    again, l_again = run(False)
    assert trace_counts() == counts
    np.testing.assert_array_equal(graphed, eager)
    np.testing.assert_array_equal(again, eager)
    assert l_eager == l_graphed == l_again and sum(l_eager.values()) > 0
    for _ in range(2):
        assert torch.equal(tier.last_logits(toks), tier.last_logits(toks, eager=True))
    assert trace_counts() != counts


@pytest.mark.parametrize("arch,paged", [("qwen2.5-3b", True), ("qwen2.5-3b", False), ("zamba2-2.7b", False)])
def test_sampled_serve_continuous_graphed_matches_eager(cuda, arch, paged):
    """serve_continuous at T = 0.8 on the card: graphed == eager, and
    n_slots 3 == n_slots 2 (the per-slot keys follow admission)."""
    from repro_torch.serve import CascadeServer, Request, ServeConfig

    tier = _reduced_tier(arch, cuda, 0.8)
    server = CascadeServer([tier], device=cuda)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, tier.cfg.vocab_size, int(n)).astype(np.int32), 5) for n in rng.integers(2, 50, 6)]

    def run(eager, n_slots):
        rs = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in reqs]
        done = {r.rid: r for r in server.serve_continuous(
            rs, ServeConfig(n_slots=n_slots, max_seq=96, page_size=16, paged=paged, seed=9), eager=eager)}
        return [done[r.rid].output.tolist() for r in rs]

    ref = run(True, 3)
    assert run(False, 3) == ref
    assert run(False, 2) == ref


def _reduced_engines(arch, cuda, temperature):
    """Two reduced-width engines on the same weights and seed, one for the
    eager oracle and one for the graphed route: their generators advance
    alike, so call i of one is held to call i of the other."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import ServingEngine

    cfg = get_config(arch).reduced()
    params = api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    return cfg, {eager: ServingEngine(cfg, params, temperature=temperature, seed=5, device=cuda)
                 for eager in (True, False)}


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b"])
def test_graphed_engine_batch_matches_eager(cuda, arch, temperature):
    """The engine's graphed classify and generate (left-pad starts on the
    dense model; at T = 0.8 the logits leave the graph for the engine's
    generator) equal the eager oracle's bitwise, logits and tokens, with
    the same launches per kernel, on two calls; the second captures
    nothing."""
    from repro_torch.serve.graphs import trace_counts

    cfg, engs = _reduced_engines(arch, cuda, temperature)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 40)).astype(np.int32)
    starts = np.array([0, 3, 17, 39], np.int32) if cfg.family == "dense" else None
    for call in range(2):
        runs = {}
        for eager in (True, False):
            before = trace_counts()
            kernels.reset_launch_counts()
            logits = engs[eager].classify(toks, starts, eager=eager)
            out = engs[eager].generate(toks, 6, starts=starts, eager=eager)
            runs[eager] = (logits, out, kernels.launch_counts())
            if call == 1 and not eager:
                assert trace_counts() == before
        np.testing.assert_array_equal(runs[False][0], runs[True][0])
        np.testing.assert_array_equal(runs[False][1], runs[True][1])
        assert runs[False][2] == runs[True][2] and sum(runs[True][2].values()) > 0


@pytest.mark.parametrize("paged", [True, False])
def test_sampled_engine_serve_continuous_graphed_matches_eager(cuda, paged):
    """The engine's serve_continuous at T = 0.8 (the generator samples
    after each captured step): graphed == eager on two runs, the second
    graphed run capturing nothing."""
    from repro_torch.serve import Request, ServeConfig
    from repro_torch.serve.graphs import trace_counts

    cfg, engs = _reduced_engines("qwen2.5-3b", cuda, 0.8)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32), 5) for n in rng.integers(2, 50, 6)]
    for call in range(2):
        runs = {}
        for eager in (True, False):
            before = trace_counts()
            rs = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in reqs]
            done = {r.rid: r for r in engs[eager].serve_continuous(
                rs, ServeConfig(n_slots=3, max_seq=96, page_size=16, paged=paged), eager=eager)}
            runs[eager] = [done[r.rid].output.tolist() for r in rs]
            if call == 1 and not eager:
                assert trace_counts() == before
        assert runs[False] == runs[True]


def test_generate_buckets_bounded_memory(cuda):
    """A tier keeping two batch buckets, at three (S, max_new) shapes of one
    cache size, twice over (every call meets an evicted bucket): at most
    two caches; once two are held, the device memory held after a call
    stays level and each second-pass call peaks no higher than its shape's
    first-pass call (1 MiB allowed: the staged prompt buffers differ by a
    few hundred bytes between shapes); the second pass emits the first
    pass's tokens, which equal the eager oracle's."""
    from repro_torch.serve.graphs import trace_counts

    tier = _reduced_tier("zamba2-2.7b", cuda, 0.8)
    tier.graphs.max_buckets = 2
    toks = np.random.default_rng(7).integers(0, tier.cfg.vocab_size, (8, 40)).astype(np.int32)
    shapes = [(36, 12), (32, 16), (28, 20)]
    held, peaks, outs = [], [], []
    for S, max_new in shapes * 2:
        before = trace_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs.append(tier.generate(toks[:, :S], max_new, seed=1))
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated())
        peaks.append(torch.cuda.max_memory_allocated())
        assert len(tier.batch_caches) <= 2 and trace_counts() != before
    assert max(held[1:]) <= held[1] + 2**20, held
    assert all(peaks[3 + i] <= peaks[i] + 2**20 for i in (1, 2)), peaks
    for i, (S, max_new) in enumerate(shapes):
        np.testing.assert_array_equal(outs[3 + i], outs[i])
        np.testing.assert_array_equal(outs[i], tier.generate(toks[:, :S], max_new, seed=1, eager=True))


def test_sampler_draws_match_cpu(cuda):
    from repro_torch.serve import sampling

    keys, pos = sampling.batch_keys(5, 6), np.array([0, 1, 2**20, 77, 300, 2**31])
    card = sampling.draw_bits(torch.as_tensor(keys, device=cuda), torch.as_tensor(pos, device=cuda), 3, 1000)
    assert torch.equal(card.cpu(), sampling.draw_bits(torch.as_tensor(keys), torch.as_tensor(pos), 3, 1000))


# ---------------------------------------------------------------------------
# speculative deferral and open-loop serving
# ---------------------------------------------------------------------------


def _drafting_server(cuda, temperature=0.0, tier2="qwen2.5-3b"):
    """Reduced qwen2.5-3b: tier 1 [m0, m0, m2] under vote_preds 0.8 (the m0
    pair agrees, so deferrals carry m0's generation as the draft), tier 2
    [m0] (``tier2`` another architecture: its own seeded member)."""
    from repro_torch.core.cascade import TierSpec
    from repro_torch.models.params import tree_map
    from repro_torch.serve import CascadeServer, CascadeTier

    t = _reduced_tier("qwen2.5-3b", cuda, temperature)
    t1 = CascadeTier(t.cfg, tree_map(lambda v: torch.stack([v[0], v[0], v[2]]), t.values),
                     TierSpec("t0", "vote_preds", 0.8, k=3), temperature=temperature, device=cuda)
    if tier2 == "qwen2.5-3b":
        t2 = CascadeTier(t.cfg, tree_map(lambda v: v[0:1], t.values), TierSpec("t1", "vote_preds", 0.0, k=1),
                         temperature=temperature, device=cuda)
    else:
        t2 = _reduced_tier(tier2, cuda, temperature, k=1)
    return CascadeServer([t1, t2], device=cuda)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("paged", [True, False])
def test_speculative_serve_graphed_matches_eager(cuda, paged, temperature):
    """Speculative serve_continuous on the card: the graphed verify chunks
    (twice) emit bitwise the eager oracle's tokens and spec counters with
    the same launches per kernel, the second graphed run captures nothing,
    and a verify pass ran."""
    from repro_torch.serve import Request, ServeConfig
    from repro_torch.serve.graphs import trace_counts

    server = _drafting_server(cuda, temperature)
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, server.tiers[0].cfg.vocab_size, int(n)).astype(np.int32), 6)
            for n in rng.integers(2, 60, 8)]

    def run(eager):
        rs = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in reqs]
        kernels.reset_launch_counts()
        done = {r.rid: r for r in server.serve_continuous(
            rs, ServeConfig(n_slots=3, max_seq=96, page_size=16, paged=paged, seed=2, speculative=True),
            eager=eager)}
        spec = {k: v for k, v in server.last_stream_stats[1].items() if k.startswith("spec") or k == "decode_tokens"}
        return [(done[r.rid].tier, done[r.rid].output.tolist()) for r in rs], spec, kernels.launch_counts()

    eager = run(True)
    graphed = run(False)
    counts = trace_counts()
    again = run(False)
    assert trace_counts() == counts
    assert eager == graphed == again
    assert eager[1]["spec_drafts"] > 0


def test_speculative_falls_back_on_a_recurrent_tier(cuda):
    """A recurrent tier 2 drops the draft: no verify pass, the plain run's
    tokens, bitwise."""
    from repro_torch.serve import Request, ServeConfig

    server = _drafting_server(cuda, tier2="rwkv6-7b")
    rng = np.random.default_rng(9)
    vocab = min(t.cfg.vocab_size for t in server.tiers)
    reqs = [(rng.integers(0, vocab, int(n)).astype(np.int32), 5) for n in rng.integers(2, 40, 6)]
    outs = {}
    for spec in (False, True):
        rs = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in reqs]
        done = {r.rid: r for r in server.serve_continuous(rs, ServeConfig(n_slots=3, max_seq=64, speculative=spec))}
        outs[spec] = [(done[r.rid].tier, done[r.rid].output.tolist()) for r in rs]
        assert server.last_stream_stats[1]["spec_drafts"] == 0
    assert outs[True] == outs[False] and any(t == 1 for t, _ in outs[True])


@pytest.mark.parametrize("paged", [True, False])
def test_captured_verify_bucket_draws_anew_with_a_new_key(cuda, paged):
    """A verify chunk at T = 0.8 captured at its first call and replayed with
    another slot key: each call's choices are bitwise the eager route's at
    the same key, the two keys' choices differ, and the replay captures
    nothing."""
    from repro_torch.core.cascade import prompt_chunks
    from repro_torch.serve import TierBackend
    from repro_torch.serve.graphs import trace_counts

    tier = _reduced_tier("qwen2.5-3b", cuda, 0.8, k=1)
    rng = np.random.default_rng(10)
    prompt, draft = (rng.integers(0, tier.cfg.vocab_size, n).astype(np.int32) for n in (37, 7))
    tokens = np.concatenate([prompt[-1:], draft])

    def choices(eager):
        backend = TierBackend(tier, n_slots=2, max_seq=96, page_size=16, paged=paged, eager=eager)
        backend.begin_slot(1, prompt, share=False)
        off = 0
        for c in prompt_chunks(len(prompt) - 1, 256):
            backend.prefill_chunk(prompt[off: off + c], 1, off)
            off += c
        assert backend.extend_slot(1, len(prompt) + len(draft))
        out = []
        for i, key in enumerate((int(backend.slot_keys[1]), (int(backend.slot_keys[1]) + 12345) % 2**32)):
            backend.slot_keys[1] = key
            before = trace_counts()
            out.append(backend.verify_draft(tokens, 1, len(prompt) - 1, 256))
            # counted (captured, on the graphed route) at the first call only
            assert (trace_counts() == before) == (i == 1)
        return out

    eager, graphed = choices(True), choices(False)
    for e, g in zip(eager, graphed):
        np.testing.assert_array_equal(g, e)
    assert not np.array_equal(graphed[0], graphed[1])


def test_open_loop_replays_the_closed_loop_graphs(cuda):
    """An open-loop run (the controller moving slot limits and offsets)
    after a closed-loop run of the same geometry captures nothing; run
    twice, it gives equal reports, with offered == completed + shed."""
    from repro_torch.core.cascade import TierSpec
    from repro_torch.serve import (CascadeServer, CascadeTier, ControllerConfig, GreedyController, ServeConfig,
                                   bursty)
    from repro_torch.serve.graphs import trace_counts

    t1 = _reduced_tier("qwen2.5-3b", cuda)
    t2 = _reduced_tier("internlm2-1.8b", cuda, k=1)
    t2.spec = TierSpec("t2", "confidence", -1.0)
    server = CascadeServer([t1, t2], device=cuda)
    vocab = min(t1.cfg.vocab_size, t2.cfg.vocab_size)
    wl = bursty(2.0, 300.0, 40, seed=7, mean_on_s=0.5, mean_off_s=0.5, prompt_len=(4, 40), max_new_tokens=(2, 5),
                vocab=vocab)
    cfg = ServeConfig(n_slots=4, max_seq=64, page_size=16)
    server.serve_continuous([r for _, r in wl], cfg)
    before = trace_counts()
    reports = []
    for _ in range(2):
        ctl = GreedyController(ControllerConfig(interval_s=0.1))
        rep = server.serve_open_loop(wl, cfg, slo_s=0.3, step_time_s=0.01, controller=ctl)
        assert rep.offered == len(rep.completed) + len(rep.shed) == 40
        reports.append((rep.goodput, rep.p50_s, rep.p99_s, rep.makespan_s, rep.controller_actions,
                        [(r.tier, r.output.tolist()) for r in rep.completed]))
    assert trace_counts() == before
    assert reports[0] == reports[1]


# ---------------------------------------------------------------------------
# training: flash's lse forward and its gradient route, the scans under
# autograd, the inference-only kernels, a train step
# ---------------------------------------------------------------------------


def _grads(fn, inputs, weights):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o.float() * w).sum() for o, w in zip(outs, weights)).backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("hd,H,KVH,window,softcap,dtype", [
    (128, 16, 2, None, None, torch.bfloat16), (80, 8, 8, None, None, torch.bfloat16),
    (64, 8, 2, 48, 30.0, torch.bfloat16), (24, 6, 2, None, None, torch.bfloat16),
    (40, 4, 4, 64, 5.0, torch.bfloat16), (16, 2, 2, None, None, torch.float32),
    (40, 8, 2, 48, 30.0, torch.float32), (128, 16, 2, None, None, torch.float32)])
def test_flash_lse_and_training_gradients(cuda, hd, H, KVH, window, softcap, dtype):
    """The kernel's lse and out against the plain version's (bf16: abs 1e-3
    and 2e-2; f32: abs 1e-5 and normwise 1e-5); dq, dk, dv through the
    training route (kernel forward, one launch) against autograd of the
    plain version, normwise 2e-2 (bf16) and 1e-4 (f32)."""
    g = torch.Generator().manual_seed(hd)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype).to(cuda)
    B, S = 2, 300
    q, k, v, do = mk(B, S, H, hd), mk(B, S, KVH, hd), mk(B, S, KVH, hd), mk(B, S, H, hd)
    kw = dict(causal=True, window=window, softcap=softcap)
    o, lse = flash._flash_cuda(q, k, v, starts=None, return_lse=True, **kw)
    po, plse = flash.flash_attention_plain(q, k, v, return_lse=True, **kw)
    f32 = dtype == torch.float32
    assert (lse - plse).abs().max().item() <= (1e-5 if f32 else 1e-3)
    _held(o, po, dtype)
    before = kernels.launch_counts()["flash_attention"]
    got = _grads(lambda q, k, v: flash.flash_attention(q, k, v, **kw), (q, k, v), (do,))
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = _grads(lambda q, k, v: flash.flash_attention_plain(q, k, v, **kw), (q, k, v), (do,))
    for a, b in zip(got, ref):
        _normwise(a, b, 1e-4 if f32 else 2e-2)


def test_scans_under_autograd_launch_and_match_plain(cuda):
    """ssd and wkv6 under grad: one kernel launch each in the forward; the
    input gradients (backward by recompute of the plain version) equal
    autograd of the plain version, normwise 2e-2."""
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g).to(cuda)
    x, Bm, Cm = rn(2, 70, 4, 64).bfloat16(), rn(2, 70, 1, 64).mul(0.5).bfloat16(), rn(2, 70, 1, 64).mul(0.5).bfloat16()
    dt, A, s0 = torch.nn.functional.softplus(rn(2, 70, 4) - 2), -torch.exp(rn(4) * 0.3), rn(2, 4, 64, 64).mul(0.2)
    w = (rn(2, 70, 4, 64), rn(2, 4, 64, 64))
    before = kernels.launch_counts()["mamba2_ssd"]
    got = _grads(lambda *a: ssd.ssd(*a[:5], initial_state=a[5], return_final_state=True), (x, dt, A, Bm, Cm, s0), w)
    assert kernels.launch_counts()["mamba2_ssd"] == before + 1
    ref = _grads(lambda *a: ssd.ssd_plain(*a[:5], initial_state=a[5]), (x, dt, A, Bm, Cm, s0), w)
    for a, b in zip(got, ref):
        _normwise(a, b, 2e-2)
    r, k, v = (rn(2, 33, 4, 32).bfloat16() for _ in range(3))
    logw, u, s1 = -torch.exp(rn(2, 33, 4, 32) * 0.5), rn(4, 32).mul(0.5), rn(2, 4, 32, 32).mul(0.1)
    w = (rn(2, 33, 4, 32), rn(2, 4, 32, 32))
    before = kernels.launch_counts()["rwkv6_wkv"]
    got = _grads(lambda *a: wkv.wkv6(*a[:5], initial_state=a[5], return_final_state=True), (r, k, v, logw, u, s1), w)
    assert kernels.launch_counts()["rwkv6_wkv"] == before + 1
    ref = _grads(lambda *a: wkv.wkv6_plain(*a[:5], initial_state=a[5]), (r, k, v, logw, u, s1), w)
    for a, b in zip(got, ref):
        _normwise(a, b, 2e-2)


def test_inference_only_kernels_raise_under_grad(cuda):
    logits = torch.randn(2, 3, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="member_stats"):
        agree.member_stats(logits)
    rows = torch.randn(4, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="compact"):
        compact.compact(rows, torch.ones(4, dtype=torch.bool, device=cuda))
    q = torch.randn(2, 1, 4, 64, device=cuda).bfloat16().requires_grad_(True)
    kc = torch.randn(2, 2, 16, 64, device=cuda).bfloat16()
    with pytest.raises(RuntimeError, match="decode_attention"):
        decode.decode_attention_bksd(q, kc, kc, cur_len=8)
    with torch.no_grad():
        agree.member_stats(logits)
        decode.decode_attention_bksd(q, kc, kc, cur_len=8)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b", "rwkv6-7b", "mixtral-8x22b"])
def test_train_step_on_card_launches_kernels(cuda, arch):
    """A reduced train step on the card: finite loss, every parameter
    moves, the family's kernels launched (flash twice a layer with remat)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = {"tokens": rows[:, :-1], "targets": rows[:, 1:]}
    state = init_train_state(api.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda), OptimConfig())
    before = [t.clone() for t in tree_leaves(state.params)]
    kernels.reset_launch_counts()
    state, m = make_train_step(cfg, OptimConfig(), total_steps=4, warmup_steps=1)(state, batch)
    counts = kernels.launch_counts()
    assert np.isfinite(float(m["loss"]))
    assert all(not torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)))
    n_attn = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1), "ssm_rwkv6": 0}.get(cfg.family, cfg.n_layers)
    assert counts["flash_attention"] == 2 * n_attn
    scan = {"hybrid": "mamba2_ssd", "ssm_rwkv6": "rwkv6_wkv"}.get(cfg.family)
    if scan:
        assert counts[scan] == 2 * cfg.n_layers  # the forward and remat's recompute

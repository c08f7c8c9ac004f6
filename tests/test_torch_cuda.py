"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device (the kernels have no CPU or
interpret mode) and skips without one; the file imports no JAX, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: argmax, max, index maps and compacted payloads exact; sumexp
rel 1e-5; bf16 attention outputs abs 2e-2 (inputs ~N(0, 1); the flash
kernel rounds P to bf16 before the PV product)."""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.agreement import ops as agree
from repro_torch.kernels.compaction import ops as compact
from repro_torch.kernels.decode_attention import ops as decode
from repro_torch.kernels.flash_attention import ops as flash

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


FLASH_CASES = [
    dict(causal=True, window=None, softcap=None, starts=None),
    dict(causal=True, window=25, softcap=None, starts=None),
    dict(causal=True, window=None, softcap=3.0, starts=None),
    dict(causal=True, window=None, softcap=None, starts=[0, 25, 80]),
    dict(causal=True, window=30, softcap=2.0, starts=[15, 0, 100]),
    dict(causal=False, window=None, softcap=None, starts=None),
]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_flash_attention(cuda, case, hd):
    q, k, v = (_randn(3, 100, h, hd, seed=i).to(cuda, torch.bfloat16) for i, h in enumerate((8, 2, 2)))
    starts = None if case["starts"] is None else torch.tensor(case["starts"], dtype=torch.int32, device=cuda)
    kw = dict(causal=case["causal"], window=case["window"], softcap=case["softcap"], starts=starts)
    got = flash.flash_attention(q, k, v, **kw).float()
    torch.testing.assert_close(got, flash.flash_attention_plain(q, k, v, **kw).float(), rtol=0, atol=2e-2)
    if starts is not None:
        for b, s in enumerate(case["starts"]):
            assert not got[b, :s].any()


DECODE_CASES = [
    dict(cur_len=90, window=None, softcap=None, starts=None),
    dict(cur_len=[3, 130, 77], window=None, softcap=None, starts=None),
    dict(cur_len=120, window=40, softcap=None, starts=None),
    dict(cur_len=[5, 120, 130], window=None, softcap=2.5, starts=[0, 40, 100]),
    dict(cur_len=100, window=None, softcap=None, starts=[0, 100, 3]),
]


@pytest.mark.parametrize("G,hd", [(8, 128), (2, 64), (1, 128)])
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items() if v))
def test_decode_attention(cuda, case, G, hd):
    B, KVH, S = 3, 2, 130
    q = _randn(B, 1, KVH * G, hd, seed=0).to(cuda, torch.bfloat16)
    kc = _randn(B, KVH, S, hd, seed=1).to(cuda, torch.bfloat16)
    vc = _randn(B, KVH, S, hd, seed=2).to(cuda, torch.bfloat16)
    cur = case["cur_len"] if np.isscalar(case["cur_len"]) else torch.tensor(case["cur_len"], dtype=torch.int32, device=cuda)
    starts = None if case["starts"] is None else torch.tensor(case["starts"], dtype=torch.int32, device=cuda)
    kw = dict(window=case["window"], softcap=case["softcap"], starts=starts)
    got = decode.decode_attention_bksd(q, kc, vc, cur, **kw).float()
    torch.testing.assert_close(got, decode.decode_attention_plain(q, kc, vc, cur, **kw).float(), rtol=0, atol=2e-2)

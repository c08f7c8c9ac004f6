"""Sampling at T > 0 in the port (``serve/sampling.py``), on the CPU path.

JAX's PRNG cannot be reproduced in PyTorch, so sampled tokens are held to
the port's own invariants, bitwise: paged == dense, slot reuse, n_slots 2
and 4 with the same admission order, the graphed route == the eager
oracle, and repeated calls with one seed.  The sampler's token frequencies
are held to ``softmax(logits / T)`` by a chi-squared test at p = 1e-3, and
its integer draws to a plain-Python evaluation of the same hash."""
import copy
import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.configs import ModelConfig
from repro_torch.core import ensemble as t_ens
from repro_torch.core.cascade import TierSpec
from repro_torch.models import api as t_api
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig, ServingEngine, TierBackend
from repro_torch.serve import sampling
from test_torch_recurrent_serving import CONFIGS as RECURRENT

T = 0.8
P_MIN = 1e-3  # the chi-squared tests fail below this p-value
_DENSE = dict(family="dense", n_layers=2, d_model=64, d_ff=128, vocab_size=64, n_heads=4, n_kv_heads=2,
              remat=False, dtype="float32")
FAMILIES = ["dense", "ssm_mamba2", "ssm_rwkv6", "hybrid"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family, name):
    if family == "dense":
        return ModelConfig(name=name, **_DENSE)
    return ModelConfig(**dict(dataclasses.asdict(RECURRENT[family]), name=name, dtype="float32"))


def _tier(family, name, seed, k=3, temperature=T):
    cfg = _cfg(family, name)
    return CascadeTier(cfg, t_ens.init_ensemble(cfg, k, torch.Generator().manual_seed(seed), "cpu"),
                       TierSpec(name, "vote", 0.67, k=k), temperature=temperature, device="cpu")


def _reqs(seed, n, *, lo=3, hi=24, max_new=(3, 7)):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, 64, int(rng.integers(lo, hi))).astype(np.int32),
                    max_new_tokens=int(rng.integers(*max_new))) for _ in range(n)]


def _serve(server, reqs, **kw):
    run = copy.deepcopy(reqs)
    done = server.serve_continuous(run, ServeConfig(max_seq=48, page_size=8, **kw))
    by = {r.rid: r for r in done}
    assert sorted(by) == sorted(r.rid for r in reqs)
    return [(by[r.rid].tier, by[r.rid].truncated, by[r.rid].output.tolist()) for r in reqs]


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def _py_mix32(x):
    x ^= x >> 16
    x = (x * 0x21F0AAAD) % 2**32
    x ^= x >> 15
    x = (x * 0x735A2D97) % 2**32
    return x ^ (x >> 15)


def _py_fold_in(key, data):
    return _py_mix32(key ^ _py_mix32((data + 0x9E3779B9) % 2**32))


def test_draw_bits_match_plain_python():
    """The int64 tensor hash equals the same hash in Python's unbounded
    integers (so no product wrapped) for keys and positions up to 2**32."""
    keys = np.array([0, 1, 2**32 - 1, sampling.base_key(7), 123456789], np.int64)
    pos = np.array([0, 5, 2**31, 300, 2**32 - 2], np.int64)
    E, V = 3, 11
    bits = sampling.draw_bits(torch.as_tensor(keys), torch.as_tensor(pos), E, V)
    assert bits.dtype == torch.int64 and bits.shape == (E, len(keys), V)
    for b, (k, p) in enumerate(zip(keys.tolist(), pos.tolist())):
        kp = _py_fold_in(k, p)
        for e in range(E):
            ke = _py_fold_in(kp, e)
            want = [_py_mix32(ke ^ _py_mix32((v + 0x9E3779B9) % 2**32)) for v in range(V)]
            assert bits[e, b].tolist() == want
    assert sampling.base_key(7) == _py_fold_in(0x5EED, 7)
    np.testing.assert_array_equal(sampling.batch_keys(7, 4), [_py_fold_in(sampling.base_key(7), b) for b in range(4)])


def test_gumbel_stays_finite():
    bits = torch.tensor([0, 1, 255, 256, 2**32 - 1, 2**31], dtype=torch.int64)
    g = sampling.gumbel(bits)
    assert torch.isfinite(g).all() and g.dtype == torch.float32
    assert (g[:-1].diff() >= 0).all() and g[0] < g[-1] < g[-2]  # monotone in the draw


def _chi2_p(counts, probs):
    probs = probs / probs.sum()
    return stats.chisquare(counts, probs * counts.sum()).pvalue


LOGITS = torch.tensor([1.0, 0.5, 0.0, -0.5, 2.0, -1.0, 0.25, 1.5])


@pytest.mark.parametrize("vary", ["keys", "positions", "members"])
def test_frequencies_match_softmax(vary):
    """Token frequencies of 24000 draws against softmax(logits / T), the
    draws varying over row keys, positions or members."""
    N, V = 24000, LOGITS.numel()
    if vary == "keys":
        keys, pos, E = torch.as_tensor(sampling.batch_keys(3, N)), torch.full((N,), 17), 1
    elif vary == "positions":
        keys, pos, E = torch.full((N,), sampling.base_key(5)), torch.arange(N), 1
    else:
        keys, pos, E = torch.as_tensor(sampling.batch_keys(9, 8)), torch.full((8,), 3), N // 8
    B = keys.numel()
    logits = LOGITS.expand(E, B, V)
    tok = sampling.sample(logits, keys, pos, T)
    assert tok.shape == (E, B) and tok.dtype == torch.int32
    counts = np.bincount(tok.reshape(-1).numpy(), minlength=V)
    probs = torch.softmax(LOGITS.double() / T, -1).numpy()
    assert _chi2_p(counts, probs) > P_MIN, (counts, probs * counts.sum())


def test_engine_sampler_frequencies_match_softmax():
    """The engine's generator-driven Gumbel-max draw, the same test."""
    eng = ServingEngine(_cfg("dense", "samp-eng-freq"),
                        t_api.init_params(_cfg("dense", "samp-eng-freq"), torch.Generator().manual_seed(0), "cpu"),
                        temperature=T, seed=4, device="cpu")
    tok = torch.cat([eng._sample(LOGITS.expand(3000, -1)) for _ in range(8)])
    counts = np.bincount(tok.numpy(), minlength=LOGITS.numel())
    assert _chi2_p(counts, torch.softmax(LOGITS.double() / T, -1).numpy()) > P_MIN


def test_greedy_is_first_argmax():
    logits = torch.tensor([[[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 0.0, 0.0]]])
    assert sampling.sample(logits, torch.tensor([1, 2]), 4, 0.0).tolist() == [[1, 0]]


def test_sampler_pos_int_equals_vector():
    logits = torch.randn(2, 5, 40, generator=torch.Generator().manual_seed(1))
    keys = torch.as_tensor(sampling.batch_keys(2, 5))
    a = sampling.sample(logits, keys, 33, T)
    assert torch.equal(a, sampling.sample(logits, keys, torch.full((5,), 33), T))
    assert torch.equal(a, sampling.sample(logits, keys, torch.tensor(33), T))
    assert not torch.equal(a, sampling.sample(logits, keys, 34, T))


# ---------------------------------------------------------------------------
# batch generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_tier_generate_sampled_repeatable(family):
    """CascadeTier.generate at T = 0.8: one seed gives bitwise the same
    tokens on every call and on the eager oracle; another seed others; the
    members disagree (the draw is per member)."""
    tier = _tier(family, f"samp-gen-{family}", 1)
    toks = np.random.default_rng(2).integers(0, 64, (4, 9)).astype(np.int32)
    a = tier.generate(toks, 6, seed=5)
    np.testing.assert_array_equal(tier.generate(toks, 6, seed=5), a)
    np.testing.assert_array_equal(tier.generate(toks, 6, seed=5, eager=True), a)
    assert (tier.generate(toks, 6, seed=6) != a).any()
    assert (a[0] != a[1]).any()
    greedy = _tier(family, f"samp-gen-{family}", 1, temperature=0.0).generate(toks, 6)
    assert (greedy != a).any()


def test_cascade_generate_sampled_graphed_equals_eager():
    server = CascadeServer([_tier("dense", "samp-cg1", 3), _tier("hybrid", "samp-cg2", 4, k=1)], device="cpu")
    server.tiers[1].spec = TierSpec("b", "confidence", -1.0)
    toks = np.random.default_rng(3).integers(0, 64, (16, 7)).astype(np.int32)
    for seed in (0, 1):
        a = server.generate(toks, 4, seed=seed)
        b = server.generate(toks, 4, seed=seed, eager=True)
        np.testing.assert_array_equal(a.pred, b.pred)
        np.testing.assert_array_equal(a.tier_of, b.tier_of)


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_generate_sampled(family):
    """The engine at T = 0.8: two engines of one seed emit the same tokens,
    graphed route against eager oracle; a third seed differs."""
    cfg = _cfg(family, f"samp-eg-{family}")
    params = t_api.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    engs = [ServingEngine(cfg, params, temperature=T, seed=s, device="cpu", max_seq=64) for s in (8, 8, 9)]
    toks = np.random.default_rng(7).integers(0, 64, (3, 8)).astype(np.int32)
    starts = np.array([0, 4, 2], np.int32) if family == "dense" else None
    a = engs[0].generate(toks, 6, starts=starts)
    np.testing.assert_array_equal(engs[1].generate(toks, 6, starts=starts, eager=True), a)
    assert (engs[2].generate(toks, 6, starts=starts) != a).any()
    # the generator advances: a second call draws anew
    assert (engs[0].generate(toks, 6, starts=starts) != a).any()


@pytest.mark.parametrize("paged", [True, False])
def test_engine_serve_continuous_sampled(paged):
    """The engine's slot stream at T = 0.8 (sampled after the step): two
    engines of one seed agree; the eager oracle agrees."""
    cfg = _cfg("dense", f"samp-es-{paged}")
    params = t_api.init_params(cfg, torch.Generator().manual_seed(10), "cpu")
    reqs = _reqs(11, 5)
    outs = []
    for eager in (False, True):
        eng = ServingEngine(cfg, params, temperature=T, seed=3, device="cpu", max_seq=48)
        run = copy.deepcopy(reqs)
        done = eng.serve_continuous(run, ServeConfig(n_slots=2, paged=paged, page_size=8), eager=eager)
        outs.append(sorted((r.rid, r.output.tolist()) for r in done))
    assert outs[0] == outs[1]
    greedy = ServingEngine(cfg, params, device="cpu", max_seq=48)
    done = greedy.serve_continuous(copy.deepcopy(reqs), ServeConfig(n_slots=2, paged=paged, page_size=8))
    assert sorted((r.rid, r.output.tolist()) for r in done) != outs[0]


# ---------------------------------------------------------------------------
# continuous batching: the per-slot key streams
# ---------------------------------------------------------------------------


def test_dense_tier_sampled_invariants():
    """One 3-member tier at T = 0.8 (admission order = submission order):
    paged == dense, n_slots 2 (slots reused) == n_slots 4, the eager oracle
    == the graphed route, a repeat run == the first, all bitwise."""
    server = CascadeServer([_tier("dense", "samp-inv", 12)], device="cpu")
    reqs = _reqs(13, 7)
    ref = _serve(server, reqs, n_slots=2, seed=4)
    for kw in (dict(n_slots=4), dict(n_slots=2, paged=False), dict(n_slots=4, paged=False), dict(n_slots=2)):
        assert _serve(server, reqs, seed=4, **kw) == ref, kw
    run = copy.deepcopy(reqs)
    done = server.serve_continuous(run, ServeConfig(n_slots=3, max_seq=48, page_size=8, seed=4), eager=True)
    assert sorted((r.rid, r.output.tolist()) for r in done) == sorted((r.rid, o) for r, (_, _, o) in zip(reqs, ref))
    assert _serve(server, reqs, n_slots=2, seed=5) != ref


@pytest.mark.parametrize("family", FAMILIES[1:])
def test_recurrent_tier_sampled_invariants(family):
    """The same for the constant-state families (dense slot caches, state
    zeroed at admission)."""
    server = CascadeServer([_tier(family, f"samp-rinv-{family}", 14)], device="cpu")
    reqs = _reqs(15, 6)
    ref = _serve(server, reqs, n_slots=2, seed=1)
    assert _serve(server, reqs, n_slots=4, seed=1) == ref
    assert _serve(server, reqs, n_slots=2, seed=1) == ref


def test_slot_tokens_follow_admission_not_slot():
    """A request's sampled tokens are those of its own generation, whatever
    slot it lands in: the slot stream's tokens equal a batch-of-one stream
    per request keyed on the same admission sequence number."""
    tier = _tier("dense", "samp-solo", 16)
    reqs = _reqs(17, 4, hi=12)
    be = TierBackend(tier, n_slots=3, max_seq=48, seed=2, page_size=8)
    from repro_torch.serve import SlotStream

    stream = SlotStream(be, ServeConfig(n_slots=3, max_seq=48, page_size=8))
    stream.submit(copy.deepcopy(reqs))
    together = {r.rid: g.tolist() for r, g in stream.drain()}
    for i, r in enumerate(reqs):
        solo = TierBackend(tier, n_slots=1, max_seq=48, seed=2, page_size=8)
        solo._admit_seq = i  # the request's admission sequence number in the shared run, less one
        st = SlotStream(solo, ServeConfig(n_slots=1, max_seq=48, page_size=8))
        st.submit([copy.deepcopy(r)])
        (_, gen), = st.drain()
        assert gen.tolist() == together[r.rid]


def test_refused_admission_takes_no_key():
    """Under a pool too small for every slot, refused admissions wait at the
    head of the queue without consuming a sequence number: the tokens equal
    those of an unconstrained pool."""
    server = CascadeServer([_tier("dense", "samp-tight", 18)], device="cpu")
    reqs = _reqs(19, 6, lo=10, hi=20, max_new=(3, 5))
    ref = _serve(server, reqs, n_slots=3, seed=7)
    tight = copy.deepcopy(reqs)
    done = server.serve_continuous(tight, ServeConfig(n_slots=3, max_seq=48, page_size=8, n_pages=7, seed=7))
    st = server.last_stream_stats[0]
    assert st["admit_failures"] > 0 and st["forced_completions"] == 0
    by = {r.rid: r for r in done}
    assert [(by[r.rid].tier, by[r.rid].truncated, by[r.rid].output.tolist()) for r in reqs] == ref


def test_cascade_tiers_key_on_seed_plus_index():
    """Tier i's slots key on ServeConfig.seed + i: a two-tier cascade with
    seed s emits, on requests its first tier defers, tier 2's tokens of a
    one-tier server of tier 2 with seed s + 1 fed the same requests in the
    same order (equal prompt lengths and budgets, so tier 1 completes them
    in one step, in slot order)."""
    t1 = _tier("dense", "samp-k1", 20)
    t1.spec = TierSpec("a", "vote", 1.1, k=3)  # defers everything
    t2 = _tier("dense", "samp-k2", 21, k=1)
    t2.spec = TierSpec("b", "confidence", -1.0)
    reqs = _reqs(22, 4, lo=8, hi=9, max_new=(4, 5))
    both = _serve(CascadeServer([t1, t2], device="cpu"), reqs, n_slots=4, seed=3)
    assert all(t == 1 for t, _, _ in both)
    alone = _serve(CascadeServer([t2], device="cpu"), reqs, n_slots=4, seed=4)
    assert [o for _, _, o in both] == [o for _, _, o in alone]

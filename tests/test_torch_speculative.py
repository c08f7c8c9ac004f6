"""Speculative deferral (cascade-as-drafter) in the port against the JAX
package, on the CPU: ``serve/speculative.py`` (``plan_draft``,
``accepted_prefix``, ``verify_choices``), the verify pass
``prefill_into_slot_logits{,_paged}``, and ``CascadeServer.
serve_continuous(..., ServeConfig(speculative=True))``.

Weights are the JAX package's own init in float32, carried through numpy.
Tolerances: verify logits rtol 1e-5 / atol 1e-5 against the JAX package
(two f32 frameworks summing in their own order), with equal argmax; the
K/V rows the pass writes (values up to ~10) rtol 1e-4 / atol 1e-4.
Discrete outputs are exact: draft plans, accepted prefixes, tokens,
answering tiers, ``truncated`` flags, stream counters (``admitted``,
``decode_tokens``, ``spec_*``) and metered host fetches equal the JAX
package's.  Inside the port, speculative serving emits bitwise what plain
serving emits, greedy and sampled (T = 0.7, the port's own draws: JAX's
PRNG cannot be reproduced), paged and dense, with fewer tier-2 decodes.

In f32 the bench's speculative A/B (``benchmarks/bench_serving.py``: tier 1
[m0, m0, m2] of ``bench-s``, tier 2 [m0]) accepts every draft token in
both packages (40 of 40 for 8 requests, 80 of 80 for 16; tier-2 decodes
48 -> 0 and 96 -> 0).  The bench itself runs bf16, where the JAX package
rejects a few drafts at near-ties between its E = 3 decode and its E = 1
verify chunk; bf16 is not bitwise across the two frameworks, so the
parity here is held in f32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import cascade as j_cascade
from repro.core import ensemble as j_ens
from repro.core.cascade import TierSpec as JTierSpec
from repro.models import api as j_api
from repro.models.params import unbox
from repro.serve import CascadeServer as JServer
from repro.serve import CascadeTier as JTier
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve.speculative import accepted_prefix as j_accepted_prefix
from repro.serve.speculative import plan_draft as j_plan_draft
from repro_torch.bridge import cache_from_numpy, params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import cascade as t_cascade
from repro_torch.core.cascade import TierSpec
from repro_torch.models import api as t_api
from repro_torch.obs import Observability, Tracer, validate_trace
from repro_torch.serve import CascadeServer, CascadeTier, Request, ServeConfig, SlotStream, sampling
from repro_torch.serve.engine import trace_count
from repro_torch.serve.speculative import accepted_prefix, plan_draft, verify_choices
from test_torch_recurrent_serving import CONFIGS as RECURRENT

_BASE = dict(n_layers=2, d_model=64, d_ff=128, remat=False, dtype="float32")
# tests/test_speculative.py's dense config, and the bench's tier-1 model
DENSE = JModelConfig(name="spec-dense", family="dense", n_heads=4, n_kv_heads=2, vocab_size=64, **_BASE)
BENCH_S = JModelConfig(name="bench-s", family="dense", n_heads=4, n_kv_heads=2, vocab_size=256, **_BASE)
SPEC_KEYS = ("admitted", "decode_tokens", "spec_drafts", "spec_draft_tokens", "spec_accepted_tokens")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny models (the suite runs several
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(cfg, seed, k=3):
    """k members' weights from the JAX package's init, as numpy leaves."""
    return jax.tree.map(np.asarray, unbox(j_ens.init_ensemble(cfg, k, jax.random.PRNGKey(seed)))[0])


def _pick(stack, members):
    return jax.tree.map(lambda a: np.stack([a[i] for i in members]), stack)


def _servers(cfg, stack, tier1=(0,), temperature=0.0):
    """(JAX server, port server) over tier 1 [m0, m0, m2] under vote_preds
    0.8 (the m0 pair agrees, so a 2/3 vote defers with m0's generation as
    the plurality draft) and tier 2 = the members ``tier1`` (by default
    [m0]: at T = 0 the draft is what tier 2 decodes)."""
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    tiers = [(_pick(stack, (0, 0, 2)), JTierSpec("t0", "vote_preds", 0.8, k=3), TierSpec("t0", "vote_preds", 0.8, k=3)),
             (_pick(stack, tier1), JTierSpec("t1", "vote_preds", 0.0, k=len(tier1)),
              TierSpec("t1", "vote_preds", 0.0, k=len(tier1)))]
    j = JServer([JTier(cfg, jax.tree.map(jnp.asarray, v), js, temperature=temperature) for v, js, _ in tiers])
    t = CascadeServer([CascadeTier(tcfg, params_from_numpy(v, tcfg, device="cpu"), ts, temperature=temperature,
                                   device="cpu") for v, _, ts in tiers], device="cpu")
    return j, t


@pytest.fixture(scope="module")
def dense_stack():
    return _stack(DENSE, 0)


@pytest.fixture(scope="module")
def bench_stack():
    return _stack(BENCH_S, 0)


def _prompts(seed, n, *, lo=4, hi=14, max_new=(2, 6), vocab=64):
    """tests/test_speculative.py's ``_requests``, as (tokens, budget)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(lo, hi))).astype(np.int32), int(rng.integers(*max_new)))
            for _ in range(n)]


def _bench_prompts(n):
    """The bench's speculative requests: 8-24 tokens, 6 new."""
    r = np.random.default_rng(11)
    return [(r.integers(1, 256, int(L)).astype(np.int32), 6) for L in r.integers(8, 25, n)]


def _outputs(done, reqs):
    """(tier, truncated, output) per request, in submission order."""
    by = {r.rid: r for r in done}
    assert sorted(by) == sorted(r.rid for r in reqs), "every request completes exactly once"
    return [(by[q.rid].tier, by[q.rid].truncated, by[q.rid].output.tolist()) for q in reqs]


def _serve(server, prompts, *, speculative, paged=None, n_slots=2, max_seq=64, page_size=16, seed=0, eager=False):
    """One port run: (outputs, per-tier stats)."""
    reqs = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in prompts]
    cfg = ServeConfig(n_slots=n_slots, max_seq=max_seq, paged=paged, page_size=page_size, seed=seed,
                      speculative=speculative)
    done = server.serve_continuous(reqs, cfg, eager=eager)
    return _outputs(done, reqs), [dict(s) for s in server.last_stream_stats]


# ---------------------------------------------------------------------------
# the plan, the acceptance rule, the verify pass and its sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_plan_and_accepted_prefix_match_jax(seed):
    """Random prompts, drafts, budgets and walls (both clamps and the
    nothing-to-verify case among them), and choices that diverge from the
    draft at random places in random members."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        prompt = rng.integers(0, 64, int(rng.integers(1, 40))).astype(np.int32)
        draft = rng.integers(0, 64, int(rng.integers(0, 12))).astype(np.int32)
        max_new, max_seq = int(rng.integers(1, 10)), int(rng.integers(len(prompt) + 1, 64))
        got, ref = plan_draft(prompt, draft, max_new, max_seq), j_plan_draft(prompt, draft, max_new, max_seq)
        assert (got is None) == (ref is None)
        if got is not None:
            assert got.start == ref.start
            np.testing.assert_array_equal(got.tokens, ref.tokens)
            np.testing.assert_array_equal(got.draft, ref.draft)
        T, E = len(draft), int(rng.integers(1, 4))
        choices = np.tile(np.concatenate([draft, [int(rng.integers(0, 64))]]), (E, 1)).astype(np.int32)
        for _ in range(int(rng.integers(0, 3))):
            choices[rng.integers(0, E), rng.integers(0, T + 1)] = rng.integers(0, 64)
        assert accepted_prefix(choices, draft) == j_accepted_prefix(choices, draft)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_into_slot_logits_match_jax(dense_stack, paged):
    """The single-model verify pass, dense slot cache and paged pool, after
    a chunk of prompt: the (C, V) logits of every position equal the JAX
    package's within rtol/atol 1e-5 with equal argmax, and the K/V the pass
    writes the JAX package's within 1e-4."""
    cfg, tcfg = DENSE, ModelConfig(**dataclasses.asdict(DENSE))
    member = jax.tree.map(lambda a: a[0], dense_stack)
    jp, tp = jax.tree.map(jnp.asarray, member), params_from_numpy(member, tcfg, device="cpu")
    rng = np.random.default_rng(3)
    prompt, chunk = rng.integers(0, 64, 9).astype(np.int32), rng.integers(0, 64, 7).astype(np.int32)
    if paged:
        pages = np.array([5, 2, 7, 1], np.int32)  # 4 pages of 8 rows: positions 0..31
        jpool = unbox(j_api.init_paged_pool(cfg, 9, 8))[0]
        tpool = t_api.init_paged_pool(tcfg, 9, 8, "cpu", dtype=torch.float32)
        jpool = j_api.prefill_into_slot_paged(jp, jnp.asarray(prompt), jpool, jnp.asarray(pages), 0, cfg)
        t_api.prefill_into_slot_paged(tp, prompt, tpool, pages, 0, tcfg)
        ref, jpool = j_api.prefill_into_slot_paged_logits(jp, jnp.asarray(chunk), jpool, jnp.asarray(pages), 9, cfg)
        got, tpool = t_api.prefill_into_slot_paged_logits(tp, chunk, tpool, pages, 9, tcfg)
        jcache, tcache = jpool, tpool
    else:
        jcache = unbox(j_api.init_cache(cfg, 3, 32))[0]
        tcache = t_api.init_cache(tcfg, 3, 32, "cpu", dtype=torch.float32)
        jcache = j_api.prefill_into_slot(jp, jnp.asarray(prompt), jcache, 1, 0, cfg)
        t_api.prefill_into_slot(tp, prompt, tcache, 1, 0, tcfg)
        ref, jcache = j_api.prefill_into_slot_logits(jp, jnp.asarray(chunk), jcache, 1, 9, cfg)
        got, tcache = t_api.prefill_into_slot_logits(tp, chunk, tcache, 1, 9, tcfg)
    assert got.shape == (7, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(ref).argmax(-1))
    want = cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu", members=False)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4)


def test_constant_state_families_refuse_the_verify_pass():
    for family in ("ssm_mamba2", "ssm_rwkv6", "hybrid"):
        cfg = ModelConfig(**dataclasses.asdict(RECURRENT[family]))
        assert not t_api.supports_draft_verify(cfg) and not j_api.supports_draft_verify(RECURRENT[family])
    assert t_api.supports_draft_verify(ModelConfig(**dataclasses.asdict(DENSE)))


def test_verify_sampler_draws_the_decode_steps_tokens():
    """At T = 0.7 the verify chunk's token (e, j) is bitwise the decode
    step's draw for that slot key at position start + j, member e; keys and
    start as ints or as (1,) tensors (a captured chunk's staged inputs) give
    the same tokens; at T = 0 it is the argmax."""
    g = torch.Generator().manual_seed(5)
    E, C, V, start, key = 3, 9, 64, 17, sampling.fold_in(sampling.base_key(4), 3)
    logits = torch.randn(E, C, V, generator=g) * 3
    got = verify_choices(logits, key, start, 0.7)
    staged = verify_choices(logits, torch.tensor([key]), torch.tensor([start]), 0.7)
    assert torch.equal(got, staged)
    for j in range(C):
        step = sampling.sample(logits[:, j:j + 1], np.array([key], np.int64), np.array([start + j]), 0.7)
        assert torch.equal(got[:, j], step[:, 0])
    assert torch.equal(verify_choices(logits, key, start, 0.0), logits.argmax(-1).to(torch.int32))
    assert not torch.equal(got, verify_choices(logits, key + 1, start, 0.7))


# ---------------------------------------------------------------------------
# the serving contract in the port: speculative == plain, fewer decodes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_bitwise_and_fewer_decodes(dense_stack, paged):
    _, server = _servers(DENSE, dense_stack)
    prompts = _prompts(31, 8)
    base, bs = _serve(server, prompts, speculative=False, paged=paged)
    spec, ss = _serve(server, prompts, speculative=True, paged=paged)
    assert spec == base
    assert bs[1]["spec_drafts"] == 0
    assert sum(t == 1 for t, _, _ in base) >= 2, "the fixture must defer for the test to mean anything"
    # identical weights and greedy: every draft token accepted
    assert ss[1]["spec_accepted_tokens"] == ss[1]["spec_draft_tokens"] > 0
    assert ss[1]["decode_tokens"] < bs[1]["decode_tokens"]


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_bitwise_at_sampled_temperature(dense_stack, paged):
    """T = 0.7: the verify pass draws on the decode step's (key, position,
    member), so speculative serving emits the plain run's tokens even where
    tier 2's draws leave the draft (partial acceptance)."""
    _, server = _servers(DENSE, dense_stack, temperature=0.7)
    prompts = _prompts(33, 8)
    base, _ = _serve(server, prompts, speculative=False, paged=paged, seed=3)
    spec, ss = _serve(server, prompts, speculative=True, paged=paged, seed=3)
    assert spec == base
    assert ss[1]["spec_drafts"] > 0
    assert ss[1]["spec_accepted_tokens"] < ss[1]["spec_draft_tokens"]


def test_partial_acceptance_still_bitwise(dense_stack):
    """Tier 2 = a different member than the draft's author: acceptance is
    whatever prefix happens to match, and decode resumes after it without
    shifting a token, in pages of 4 rows so extension and rollback cross
    page boundaries."""
    _, server = _servers(DENSE, dense_stack, tier1=(1,))
    prompts = _prompts(35, 8)
    base, _ = _serve(server, prompts, speculative=False, paged=True, page_size=4)
    spec, ss = _serve(server, prompts, speculative=True, paged=True, page_size=4)
    assert spec == base
    assert ss[1]["spec_drafts"] > 0
    assert ss[1]["spec_accepted_tokens"] < ss[1]["spec_draft_tokens"]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_paged_equals_dense_speculative(dense_stack, temperature):
    _, server = _servers(DENSE, dense_stack, temperature=temperature)
    prompts = _prompts(37, 8)
    dense, _ = _serve(server, prompts, speculative=True, paged=False, seed=2)
    paged, ss = _serve(server, prompts, speculative=True, paged=True, seed=2)
    assert dense == paged and ss[1]["spec_drafts"] > 0


def test_pool_conserved_with_shared_prefixes_and_admission_completions(dense_stack, monkeypatch):
    """Eight requests sharing a 20-token prefix, pages of 4 rows, 2 slots:
    ``PagePool.assert_conserved`` holds after every step of both tiers,
    drafts that a full acceptance completes at admission hand their slot
    and pages to the next request, and the tokens are the plain run's."""
    _, server = _servers(DENSE, dense_stack)
    rng = np.random.default_rng(39)
    prefix = rng.integers(1, 64, 20).astype(np.int32)
    prompts = [(np.concatenate([prefix, rng.integers(1, 64, int(rng.integers(1, 6))).astype(np.int32)]), 4)
               for _ in range(8)]
    step, seen = SlotStream.step, []

    def checked(self):
        out = step(self)
        self.backend.pool.assert_conserved()
        seen.append(self.name)
        return out

    monkeypatch.setattr(SlotStream, "step", checked)
    base, _ = _serve(server, prompts, speculative=False, paged=True, page_size=4)
    spec, ss = _serve(server, prompts, speculative=True, paged=True, page_size=4)
    assert spec == base and "slot_stream.tier1" in seen
    # budget 4: each verify pass emits 4 tokens and completes its request
    assert ss[1]["spec_drafts"] == ss[1]["admitted"] > 2 and ss[1]["decode_tokens"] == 0
    assert ss[1]["spec_accepted_tokens"] == ss[1]["spec_draft_tokens"]


@pytest.mark.parametrize("family", ["ssm_mamba2", "ssm_rwkv6"])
def test_constant_state_tier_drops_the_draft(family, dense_stack):
    """A constant-state tier 2 cannot roll rejected tokens out of its
    recurrent state: the draft is dropped at admission, no verify pass runs
    and the outputs are the plain run's."""
    cfg = dataclasses.replace(RECURRENT[family], dtype="float32")
    _, server = _servers(cfg, _stack(cfg, 9))
    prompts = _prompts(39, 6)
    base, _ = _serve(server, prompts, speculative=False)
    spec, ss = _serve(server, prompts, speculative=True)
    assert spec == base
    assert sum(t == 1 for t, _, _ in base) >= 1
    assert ss[1]["spec_drafts"] == 0


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_trace_counts_flat_after_warmup(dense_stack, paged):
    """Compile-once: a second speculative run of the same geometry adds
    nothing to ``trace_counts()``; the first counts one verify program a
    chunk bucket."""
    _, server = _servers(DENSE, dense_stack)
    prompts = _prompts(41, 8)
    n0 = trace_count()
    _serve(server, prompts, speculative=True, paged=paged)
    key = "spec-dense@T0/ens_verify_chunk" + ("_paged" if paged else "")
    assert trace_count(key) >= 1 and trace_count() > n0
    n1 = trace_count()
    _serve(server, prompts, speculative=True, paged=paged)
    assert trace_count() == n1


def test_verify_span_nests_in_admit(dense_stack):
    """The ``verify_draft`` span lies inside ``admit`` with its draft and
    accepted counts, and the trace validates."""
    _, server = _servers(DENSE, dense_stack)
    tr = Tracer()
    reqs = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in _prompts(43, 6)]
    server.serve_continuous(reqs, ServeConfig(n_slots=2, max_seq=64, speculative=True, obs=Observability(tracer=tr)))
    validate_trace(tr.export())
    ev = [e for e in tr.events if e.get("name") == "verify_draft"]
    assert ev and all(e["args"]["accepted"] <= e_b["args"]["draft_tokens"]
                      for e_b, e in zip(ev[0::2], ev[1::2]))


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _both(j_server, t_server, prompts, config):
    """The same prompts through both servers: (JAX outputs, port outputs,
    JAX stats, port stats, JAX host fetches, port host fetches)."""
    jr = [JRequest(tokens=t.copy(), max_new_tokens=m) for t, m in prompts]
    tr = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in prompts]
    j_cascade.reset_host_fetch_stats()
    jo = _outputs(j_server.serve_continuous(jr, JServeConfig(**config)), jr)
    jf = j_cascade.host_fetch_stats()
    t_cascade.reset_host_fetch_stats()
    to = _outputs(t_server.serve_continuous(tr, ServeConfig(**config)), tr)
    tf = t_cascade.host_fetch_stats()
    keys = lambda st: [{k: s[k] for k in SPEC_KEYS} for s in st]
    return jo, to, keys(j_server.last_stream_stats), keys(t_server.last_stream_stats), jf, tf


@pytest.mark.parametrize("n", [8, 16])
def test_bench_ab_matches_jax(bench_stack, n):
    """``bench_serving``'s speculative A/B (4 slots, max_seq 64), plain and
    speculative: tiers, outputs, truncation flags, stream counters and host
    fetches equal the JAX package's, and speculative == plain."""
    j_server, t_server = _servers(BENCH_S, bench_stack)
    prompts = _bench_prompts(n)
    runs = {}
    for spec in (False, True):
        jo, to, js, ts, jf, tf = _both(j_server, t_server, prompts, dict(n_slots=4, max_seq=64, speculative=spec))
        assert to == jo and ts == js and tf == jf
        runs[spec] = (to, ts)
    assert runs[True][0] == runs[False][0]
    plain, spec = runs[False][1][1], runs[True][1][1]
    assert spec["spec_drafts"] == n and spec["spec_draft_tokens"] == 5 * n
    assert spec["decode_tokens"] < plain["decode_tokens"] == 6 * n


@pytest.mark.parametrize("paged", [None, False])
def test_agreeing_server_matches_jax(dense_stack, paged):
    """tests/test_speculative.py's ``_agreeing_server`` fixture and requests
    (2 slots, max_seq 64), speculative, paged and dense: equal to the JAX
    package in everything discrete."""
    j_server, t_server = _servers(DENSE, dense_stack)
    jo, to, js, ts, jf, tf = _both(j_server, t_server, _prompts(31, 8),
                                   dict(n_slots=2, max_seq=64, paged=paged, speculative=True))
    assert to == jo and ts == js and tf == jf
    assert ts[1]["spec_drafts"] > 0

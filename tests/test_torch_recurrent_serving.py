"""Serving the constant-state families in the port against the JAX
package: ``SlotStream`` over dense slot caches (E = 1 through
``ServingEngine``, E = 3 through ``TierBackend``) and
``ServingEngine.serve_continuous``, on the same weights (made by the JAX
package from a seed, carried through numpy) and the same numpy prompts.
Requests are matched by submission order (the two packages number them
apart); the cascades are in ``test_torch_recurrent_cascade.py``.

Discrete outputs must be equal: greedy tokens and stream counters (f32
configs).
Inside the port, chunked and decode-only admission emit the same tokens
and a reused slot (its recurrent state zeroed at admission) emits what a
fresh engine does, on the f32 configs and on the JAX tests' own bf16
ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import ensemble as j_ens
from repro.core.cascade import TierSpec as JTierSpec
from repro.models.params import unbox
from repro.serve import CascadeTier as JTier
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JEngine
from repro.serve import SlotStream as JSlotStream
from repro.serve import TierBackend as JTierBackend
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core.cascade import TierSpec
from repro_torch.serve import (
    CascadeTier,
    Request,
    ServeConfig,
    ServingEngine,
    SlotStream,
    TierBackend,
)

_BASE = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=64, remat=False)
# tests/test_slot_stream.py's constant-state configs (bf16 there)
CONFIGS = {
    "ssm_mamba2": JModelConfig(name="ss-mamba", family="ssm_mamba2", ssm_state=16, ssm_head_dim=32, **_BASE),
    "ssm_rwkv6": JModelConfig(name="ss-rwkv", family="ssm_rwkv6", ssm_head_dim=32, rwkv_lora_rank=8, **_BASE),
    "hybrid": JModelConfig(
        name="ss-hybrid", family="hybrid", n_heads=4, n_kv_heads=2, ssm_state=16, ssm_head_dim=32,
        attn_every=2, **_BASE,
    ),
}
FAMILIES = list(CONFIGS)
STREAM_KEYS = ("admitted", "admit_failures", "forced_completions", "chunk_calls",
               "chunk_tokens", "shared_tokens", "decode_tokens")


def _cfg(family, dtype):
    return dataclasses.replace(CONFIGS[family], dtype=dtype)


def port_cfg(cfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(cfg))


def _stack(cfg, seed, k=3):
    """k members' weights from the JAX package's init, as numpy leaves."""
    return jax.tree.map(np.asarray, unbox(j_ens.init_ensemble(cfg, k, jax.random.PRNGKey(seed)))[0])


def _member(stack, i=0):
    return jax.tree.map(lambda a: a[i], stack)


def _prompts(seed, n, *, lo=4, hi=20, max_new=(2, 5), vocab=64):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32), int(rng.integers(*max_new)))
        for _ in range(n)
    ]


def _port_engine(cfg, stack, max_seq=64):
    tcfg = port_cfg(cfg)
    return ServingEngine(tcfg, params_from_numpy(_member(stack), tcfg, device="cpu"), max_seq=max_seq, device="cpu")


# ---------------------------------------------------------------------------
# stream == the JAX package's stream == solo generate, per family x E
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_stream_matches_jax_and_solo_generate(family, E):
    """Four ragged prompts through 2 slots with chunked admission: every
    member's tokens equal the JAX package's, the stream counters too, and
    each request's tokens equal its solo ``generate`` in the port."""
    cfg = _cfg(family, "float32")
    tcfg = port_cfg(cfg)
    stack = _stack(cfg, seed=10 + FAMILIES.index(family))
    prompts = _prompts(100 + E, 4, hi=14)
    config = dict(n_slots=2, max_seq=64)
    if E == 1:
        jstream = JEngine(cfg, jax.tree.map(jnp.asarray, _member(stack)), max_seq=64).slot_stream(JServeConfig(**config))
        teng = _port_engine(cfg, stack)
        tstream = teng.slot_stream(ServeConfig(**config))
    else:
        jtier = JTier(cfg, jax.tree.map(jnp.asarray, stack), JTierSpec("t", "vote", 0.67, k=3))
        jstream = JSlotStream(JTierBackend(jtier, n_slots=2, max_seq=64), JServeConfig(**config))
        ttier = CascadeTier(tcfg, params_from_numpy(stack, tcfg, device="cpu"), TierSpec("t", "vote", 0.67, k=3),
                            device="cpu")
        tstream = SlotStream(TierBackend(ttier, n_slots=2, max_seq=64), ServeConfig(**config))
    assert not tstream.backend.paged
    jr = [JRequest(tokens=t.copy(), max_new_tokens=m) for t, m in prompts]
    tr = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in prompts]
    jstream.submit(jr)
    tstream.submit(tr)
    jd = {r.rid: g for r, g in jstream.drain()}
    td = {r.rid: g for r, g in tstream.drain()}
    assert sorted(td) == sorted(r.rid for r in tr), "every request completes exactly once"
    assert tstream.stats["chunk_calls"] > 0
    assert {k: tstream.stats[k] for k in STREAM_KEYS} == {k: jstream.stats[k] for k in STREAM_KEYS}
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(td[b.rid], jd[a.rid])
        solo = teng.generate(b.tokens[None], b.max_new_tokens) if E == 1 else ttier.generate(b.tokens[None], b.max_new_tokens)[:, 0]
        np.testing.assert_array_equal(solo.reshape(td[b.rid].shape), td[b.rid])


# ---------------------------------------------------------------------------
# port-internal invariants, also on the JAX tests' own bf16 configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_matches_decode_only_admission(family, dtype):
    """Bucketed chunked prefill (a 33-token prompt needs several pow2
    buckets) emits the tokens token-by-token admission does."""
    cfg = _cfg(family, dtype)
    eng = _port_engine(cfg, _stack(cfg, seed=20))
    prompts = _prompts(7, 4, hi=16) + [(np.random.default_rng(8).integers(0, 64, 33).astype(np.int32), 4)]
    outs = {}
    for chunked in (True, False):
        reqs = [Request(tokens=t, max_new_tokens=m) for t, m in prompts]
        done = eng.serve_continuous(reqs, ServeConfig(n_slots=2, chunked_prefill=chunked))
        stats = eng.last_stream_stats
        assert stats["chunk_tokens"] >= 32 if chunked else stats["chunk_calls"] == 0
        assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
        outs[chunked] = [r.output for r in reqs]
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("family", FAMILIES)
def test_slot_reuse_matches_fresh_engine(family, chunked, dtype):
    """n_slots=1 forces every request back-to-back through the same slot:
    outputs equal fresh-engine runs, so the admitted slot's state leaves
    are zeroed (recurrent state is not position-masked)."""
    cfg = _cfg(family, dtype)
    stack = _stack(cfg, seed=30)
    eng = _port_engine(cfg, stack)
    prompts = _prompts(21, 3, max_new=(3, 5))
    reqs = [Request(tokens=t, max_new_tokens=m) for t, m in prompts]
    eng.serve_continuous(reqs, ServeConfig(n_slots=1, chunked_prefill=chunked))
    assert eng.last_stream_stats["admitted"] == 3
    for r in reqs:
        np.testing.assert_array_equal(_port_engine(cfg, stack).generate(r.tokens[None], r.max_new_tokens)[0], r.output)

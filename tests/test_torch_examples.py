"""The port's serve CLI (``repro_torch.launch.serve``) and its five examples
(``repro_torch.examples``) on the CPU.

The CLI against the JAX package's own: the reference CLI builds its tiers
from ``ens.init_ensemble`` (recorded here as it runs), those weights go
through ``bridge.params_from_numpy`` into the port's CLI, and both print
the same lines and give exactly the same tier fractions, ``evaluated`` and
cost, for the vote and score rules, classify and generate, at
``--reduced``.  The examples run through ``main([..., "--device",
"cpu"])`` at a few training steps and are held to their own invariants
(routing by the rule over the tier's own logits, cost = evaluated x tier
costs, continuous batching == one request at a time, the same generations
and hops under every link); the trained cascades' classify is also held
to the JAX package's routing on the example's trained weights, carried
across in float32 (bf16 rounds at other places in the two frameworks,
which can move a near tie between classes): pred and tier_of exact, the
hop's bytes those of the deferred rows' payload.
Every entry point raises without a card unless given ``--device``."""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as j_serve
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import deferral as j_deferral
from repro.core import ensemble as j_ens
from repro.serve import CascadeServer as JServer
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.core import deferral
from repro_torch.core.cascade import TierSpec
from repro_torch.examples import (
    continuous_batching,
    edge_to_cloud,
    quickstart,
    serve_cascade,
    train_then_cascade,
)
from repro_torch.launch import serve as t_serve
from repro_torch.models.params import tree_map
from repro_torch.serve import CascadeServer, CascadeTier, edge_cloud



@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """Each test on one intra-op thread: the examples run many small
    operations, and with the suite's parallel workers sharing the host's
    cores, threads of every worker contend on each of them (a test reads
    3-35x its own time).  Restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLI = ["--tiers", "qwen2.5-3b:3", "internlm2-1.8b:1", "--reduced", "--requests", "16", "--seq", "16"]
CLI_RUNS = [
    ["--rule", "vote", "--mode", "classify"],
    ["--rule", "vote", "--mode", "generate"],
    ["--rule", "score", "--mode", "classify"],
    ["--rule", "score", "--mode", "generate"],
    ["--rule", "score", "--mode", "classify", "--theta", "0.0"],  # every request answered at tier 0
]


def _jax_cli(argv):
    """Run the reference CLI; returns (stdout, its tiers, its result)."""
    seen = {}

    class Recording(JServer):
        def __init__(self, tiers, **kw):
            super().__init__(tiers, **kw)
            seen["tiers"] = tiers

        def classify(self, *a, **kw):
            seen["res"] = super().classify(*a, **kw)
            return seen["res"]

        def generate(self, *a, **kw):
            seen["res"] = super().generate(*a, **kw)
            return seen["res"]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(j_serve, "CascadeServer", Recording)
        mp.setattr(sys, "argv", ["serve"] + argv)
        j_serve.main()
    return out.getvalue(), seen["tiers"], seen["res"]


def test_serve_cli_matches_jax(capsys):
    for run in CLI_RUNS:
        j_out, j_tiers, j_res = _jax_cli(CLI + run)
        cfgs = [cfg for _, _, cfg in t_serve.tier_configs(t_serve.parse_args(CLI + run))]
        values = [params_from_numpy(jax.tree.map(np.asarray, t.values), cfg, device="cpu")
                  for t, cfg in zip(j_tiers, cfgs)]
        capsys.readouterr()
        res = t_serve.main(CLI + run + ["--device", "cpu"], values=values)
        assert capsys.readouterr().out == j_out, run
        np.testing.assert_array_equal(res.tier_counts, j_res.tier_counts)
        np.testing.assert_array_equal(res.evaluated, np.asarray(j_res.evaluated))
        assert res.cost == j_res.cost, (run, res.cost, j_res.cost)
        np.testing.assert_array_equal(res.tier_of, np.asarray(j_res.tier_of))
    assert "tier fractions: [1.0, 0.0]" in j_out  # the theta 0.0 run answers at tier 0


def test_serve_cli_draws_weights_from_seed():
    """Without ``values`` the CLI draws its own weights from ``--seed``:
    two runs with one seed route alike."""
    argv = CLI + ["--requests", "8", "--seq", "8", "--rule", "score", "--theta", "0.0", "--device", "cpu"]
    a, b = t_serve.main(argv), t_serve.main(argv)
    np.testing.assert_array_equal(a.pred, b.pred)
    np.testing.assert_array_equal(a.tier_counts, [8, 0])


ENTRY_POINTS = {
    "serve": (t_serve, CLI),
    "quickstart": (quickstart, []),
    "serve_cascade": (serve_cascade, []),
    "continuous_batching": (continuous_batching, []),
    "edge_to_cloud": (edge_to_cloud, ["--edge-steps", "1", "--cloud-steps", "1"]),
    "train_then_cascade": (train_then_cascade, ["--steps", "1", "--big-steps", "1"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_needs_a_card_unless_told(name, monkeypatch):
    module, argv = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(argv)


def _routing_held(server, toks, res, costs):
    """Each row answered where the rule stops it: tier 0's rows are those
    its rule keeps, with its answer over its own logits; the rest are tier
    1's argmax; cost = evaluated x tier costs, tier 1 evaluating the
    deferred rows padded to their bucket."""
    with torch.no_grad():
        lo0 = server.tiers[0].last_logits(toks, eager=True)
        lo1 = server.tiers[1].last_logits(toks, eager=True)
    spec = server.tiers[0].spec
    out = deferral.apply_rule(spec.rule, lo0, spec.theta)
    keep = ~out.defer.numpy()
    np.testing.assert_array_equal(res.tier_of, np.where(keep, 0, 1))
    np.testing.assert_array_equal(res.pred, np.where(keep, out.pred.numpy(), lo1[0].argmax(-1).numpy()))
    assert res.evaluated[0] == len(toks) and res.evaluated[1] >= int((~keep).sum())
    assert res.cost == pytest.approx(float(np.dot(res.evaluated, costs)), rel=1e-12)
    np.testing.assert_allclose(server.tier_fractions(res).sum(), 1.0)


def test_quickstart_example():
    out = quickstart.main(["--device", "cpu"])
    _routing_held(out["server"], out["tokens"], out["result"], [1.0, 25.0])
    assert 0.0 <= out["theta"] <= 1.0


def test_serve_cascade_example():
    out = serve_cascade.main(["--device", "cpu"])
    assert len(out["done"]) == 12 and out["engine"].stats["batches"] == 2
    assert all(len(r.output) == r.max_new_tokens for r in out["done"])
    assert out["new_traces"] == 0
    res, again = out["result"], out["again"]
    assert res.tier_counts.sum() == 16 and res.tier_counts.tolist() == again.tier_counts.tolist()
    np.testing.assert_array_equal(res.tier_of, again.tier_of)  # same prompts and seed: same routing


def test_continuous_batching_example():
    """Continuous batching emits each request's own greedy tokens, as one
    request at a time does; the cascade answers every request."""
    out = continuous_batching.main(["--device", "cpu"])
    assert len(out["done"]) == 25
    for r in out["done"]:
        assert not r.truncated and len(r.output) == r.max_new_tokens
        np.testing.assert_array_equal(r.output, out["sequential"][r.rid])
    assert out["stream_stats"]["chunk_calls"] > 0
    assert len(out["cascade"]) == 12 and sum(out["tier_counts"]) == 12
    assert all(r.tier in (0, 1) and len(r.output) == r.max_new_tokens for r in out["cascade"])


def _f32(cfg, values):
    """A config and its values in float32 (bf16 values are exact in f32)."""
    return dataclasses.replace(cfg, dtype="float32"), tree_map(lambda t: t.float(), values)


def _f32_server(pairs, placement=None):
    """pairs: [(cfg, values, TierSpec)] -> the port's server over them in f32."""
    return CascadeServer([CascadeTier(*_f32(cfg, vals), spec, device="cpu") for cfg, vals, spec in pairs],
                         device="cpu", placement=placement)


def _jax_routing(pairs, theta, toks):
    """The reference scripts' own routing of ``toks`` through the JAX
    package on the same weights in f32: the vote over tier 0's member
    logits at ``theta``, deferred rows answered by tier 1's argmax.
    Returns (tier_of, pred)."""
    logits = []
    for cfg, vals, _ in pairs:
        cfg, vals = _f32(cfg, vals)
        jvals = jax.tree.map(jnp.asarray, params_to_numpy(vals))
        logits.append(j_ens.ensemble_last_logits(jvals, {"tokens": jnp.asarray(toks)}, JModelConfig(**dataclasses.asdict(cfg))))
    out = j_deferral.vote_rule(logits[0], theta)
    defer = np.asarray(out.defer)
    return defer.astype(np.int32), np.where(defer, np.asarray(logits[1][0].argmax(-1)), np.asarray(out.pred))


def _held_to_jax(pairs, theta, toks, placement=None):
    """The port's cascade classify of ``toks`` in f32 equals the JAX
    package's routing (pred and tier_of exact).  Returns the result."""
    got = _f32_server(pairs, placement).classify(toks)
    tier_of, pred = _jax_routing(pairs, theta, toks)
    np.testing.assert_array_equal(got.tier_of, tier_of)
    np.testing.assert_array_equal(got.pred, pred)
    return got


def test_train_then_cascade_example():
    out = train_then_cascade.main(["--steps", "2", "--big-steps", "2", "--device", "cpu"])
    _routing_held(out["server"], out["tokens"], out["result"], [1.0, 25.0])
    assert set(out["losses"]) == {0, 1, 2, 7} and all(len(v) == 2 for v in out["losses"].values())
    ex, specs = train_then_cascade, [t.spec for t in out["server"].tiers]
    _held_to_jax([(ex.SMALL, out["small"], specs[0]), (ex.BIG, out["big"], specs[1])], out["theta"],
                 out["tokens"][:256])


def test_edge_to_cloud_example():
    out = edge_to_cloud.main(["--edge-steps", "2", "--cloud-steps", "2", "--device", "cpu"])
    res, link = out["link_result"], out["link"]
    S = out["tokens"].shape[1]

    def hops_held(res, link):
        """One hop of the deferred rows; its payload the tokens and the
        int32 index map of the rows padded to their bucket."""
        assert [h.n_examples for h in link.hops] == [int((res.tier_of == 1).sum())]
        assert link.total_bytes == res.evaluated[1] * (S * 4 + 4)

    hops_held(res, link)
    served = out["served"]
    assert out["generations_identical"]
    assert edge_to_cloud.generations(served["sim"]) == edge_to_cloud.generations(served["serial"])
    hops = {k: [(h.n_examples, h.payload_bytes) for h in ln.hops] for k, ln in out["links"].items()}
    assert hops["serial"] == hops["async"] and hops["async"]
    # classify over the simulated link in f32: the JAX package's routing on
    # the example's trained weights, and the same hop
    specs = [TierSpec("edge", "vote", out["theta"], k=3, cost=1.0), TierSpec("cloud", "confidence", -1.0, k=1, cost=50.0)]
    placement = edge_cloud(delay="medium")
    got = _held_to_jax([(edge_to_cloud.EDGE, out["edge"], specs[0]), (edge_to_cloud.CLOUD, out["cloud"], specs[1])],
                       out["theta"], out["tokens"][:256], placement)
    hops_held(got, placement.link(0))

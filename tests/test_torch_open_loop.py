"""Open-loop serving in the port against the JAX package, on the CPU:
``serve/workload.py`` (the seeded traces and ``VirtualClock``),
``serve/controller.py`` (``GreedyController``), ``SlotStream.
set_slot_limit`` and ``CascadeServer.serve_open_loop``.

Weights are the JAX package's own init in float32, carried through numpy.
Everything compared is exact: trace times, prompts and budgets; and the
whole ``OpenLoopReport`` of the bench's open-loop A/B (offered, completed
requests with their tiers and outputs, shed requests, completions within
the SLO, goodput, p50, p99, makespan, controller actions).  The run is in
virtual time, so both packages make the same decisions at the same
virtual instants.

The scenarios of ``tests/test_open_loop.py`` run here in the port, but for
its transfer-guard test: ``jax.transfer_guard_device_to_host`` has no
PyTorch counterpart (the port meters every read it makes through
``host_fetch``, as ``tests/test_torch_serving.py`` holds)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import ensemble as j_ens
from repro.core.cascade import TierSpec as JTierSpec
from repro.models.params import unbox
from repro.serve import CascadeServer as JServer
from repro.serve import CascadeTier as JTier
from repro.serve import ControllerConfig as JControllerConfig
from repro.serve import GreedyController as JGreedyController
from repro.serve import ServeConfig as JServeConfig
from repro.serve import bursty as j_bursty
from repro.serve import diurnal as j_diurnal
from repro.serve import poisson as j_poisson
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core.cascade import TierSpec
from repro_torch.obs import Observability, Tracer, validate_trace
from repro_torch.serve import (
    ArrivalSpec,
    CascadeServer,
    CascadeTier,
    ControllerConfig,
    GreedyController,
    Request,
    ServeConfig,
    ServingEngine,
    VirtualClock,
    Workload,
    bursty,
    diurnal,
    poisson,
)
from repro_torch.serve.engine import trace_counts

_BASE = dict(family="dense", n_layers=2, d_model=64, d_ff=128, remat=False, dtype="float32")
# tests/test_open_loop.py's tiers (vocabulary 64), and the bench's (256)
SMALL = JModelConfig(name="tiny-s", n_heads=4, n_kv_heads=2, vocab_size=64, **_BASE)
BIG = JModelConfig(name="tiny-b", **dict(_BASE, n_layers=3, d_model=96, d_ff=192), n_heads=4, n_kv_heads=4,
                   vocab_size=64)
BENCH_S = JModelConfig(name="bench-s", n_heads=4, n_kv_heads=2, vocab_size=256, **_BASE)
BENCH_B = JModelConfig(name="bench-b", **dict(_BASE, n_layers=4, d_model=128, d_ff=256), n_heads=8,
                       n_kv_heads=4, vocab_size=256)
CFG = ServeConfig(n_slots=4, max_seq=64)
# the bench's open-loop trace (benchmarks/bench_serving.py), and with the
# prompts drawn below the small tiers' vocabulary of 64 (the JAX tests
# draw them below 256 and rely on JAX clamping an out-of-range gather;
# the port raises)
BENCH_TRACE = dict(seed=7, mean_on_s=0.5, mean_off_s=0.5, prompt_len=(4, 12), max_new_tokens=(2, 5))
SMALL_TRACE = dict(BENCH_TRACE, vocab=64)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(cfg, seed, k):
    return jax.tree.map(np.asarray, unbox(j_ens.init_ensemble(cfg, k, jax.random.PRNGKey(seed)))[0])


def _tcfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def stacks():
    return _stack(SMALL, 0, 3), _stack(BIG, 1, 1)


def _server(stacks, small=SMALL, big=BIG, cost=50.0):
    """tests/test_open_loop.py's cascade in the port: tier 1 a k=3 vote
    ensemble at theta 0.67, tier 2 answers."""
    v1, v2 = stacks
    return CascadeServer([
        CascadeTier(_tcfg(small), params_from_numpy(v1, _tcfg(small), device="cpu"),
                    TierSpec("t1", "vote", 0.67, k=3, cost=1.0), device="cpu"),
        CascadeTier(_tcfg(big), params_from_numpy(v2, _tcfg(big), device="cpu"),
                    TierSpec("t2", "confidence", -1.0, k=1, cost=cost), device="cpu"),
    ], device="cpu")


def _key(report):
    """Everything a report says, requests by (tier, output, shed)."""
    return (
        report.offered, report.completed_in_slo, report.goodput, report.p50_s, report.p99_s, report.makespan_s,
        [(r.tier, r.output.tolist(), r.shed) for r in report.completed],
        [(r.tokens.tolist(), r.shed, r.output) for r in report.shed],
        report.controller_actions,
    )


# ---------------------------------------------------------------------------
# workloads and the virtual clock
# ---------------------------------------------------------------------------

TRACES = {
    "poisson": (lambda g, seed: g(50.0, 60, seed=seed), poisson, j_poisson),
    "bursty": (lambda g, seed: g(5.0, 200.0, 60, seed=seed), bursty, j_bursty),
    "bursty_bench": (lambda g, seed: g(2.0, 300.0, 80, **dict(BENCH_TRACE, seed=seed)), bursty, j_bursty),
    "diurnal": (lambda g, seed: g(10.0, 100.0, 2.0, 60, seed=seed), diurnal, j_diurnal),
}


@pytest.mark.parametrize("name", sorted(TRACES))
@pytest.mark.parametrize("seed", [0, 7])
def test_traces_bitwise_the_jax_packages(name, seed):
    make, gen, j_gen = TRACES[name]
    got, ref = make(gen, seed), make(j_gen, seed)
    assert len(got) == len(ref) and got.name == ref.name
    np.testing.assert_array_equal(got.arrival_times, ref.arrival_times)
    for (tg, rg), (tr, rr) in zip(got, ref):
        assert tg == tr and rg.max_new_tokens == rr.max_new_tokens
        np.testing.assert_array_equal(rg.tokens, rr.tokens)
        assert rg.tokens.dtype == np.int32 and isinstance(rg, Request)
    # each pass materializes fresh requests: serving mutates them
    first, second = [r for _, r in got], [r for _, r in got]
    assert all(a is not b and a.rid != b.rid for a, b in zip(first, second))


def test_virtual_clock_and_workload_span():
    clk = VirtualClock()
    assert clk() == 0.0
    clk.advance(0.5)
    clk.advance(0.0)
    assert clk() == clk.now_s == 0.5
    with pytest.raises(AssertionError):
        clk.advance(-0.1)
    wl = Workload([ArrivalSpec(2.0, np.ones(3, np.int32), 2), ArrivalSpec(0.5, np.ones(2, np.int32), 1)])
    assert wl.arrival_times.tolist() == [0.5, 2.0] and wl.duration_s == 2.0 and wl.offered_qps == 1.0


# ---------------------------------------------------------------------------
# tests/test_open_loop.py's scenarios, in the port
# ---------------------------------------------------------------------------


def test_open_loop_replay_is_deterministic(stacks):
    wl = bursty(2.0, 150.0, 30, seed=5, prompt_len=(4, 12), max_new_tokens=(2, 5), vocab=64)
    a = _server(stacks).serve_open_loop(wl, CFG, slo_s=0.5, step_time_s=0.01)
    b = _server(stacks).serve_open_loop(wl, CFG, slo_s=0.5, step_time_s=0.01)
    assert _key(a) == _key(b)
    assert a.offered == 30 and not a.shed


def test_open_loop_at_t0_matches_closed_loop(stacks):
    """Arrivals all at t = 0 and no controller: the open loop admits the
    same list in the same order, with every theta offset 0, so tokens,
    tiers and completion order are the closed loop's, bitwise."""
    rng = np.random.default_rng(9)
    specs = [ArrivalSpec(t_s=0.0, tokens=rng.integers(0, 64, int(rng.integers(4, 12))).astype(np.int32),
                         max_new_tokens=int(rng.integers(2, 5))) for _ in range(8)]
    closed = _server(stacks).serve_continuous([s.materialize() for s in specs], CFG)
    report = _server(stacks).serve_open_loop(Workload(specs), CFG, slo_s=10.0, step_time_s=0.01)
    assert report.goodput == 1.0 and len(report.completed) == 8
    assert [(r.tier, r.output.tolist()) for r in closed] == [(r.tier, r.output.tolist()) for r in report.completed]


def test_controller_beats_static_on_bursty_trace(stacks):
    wl = bursty(2.0, 300.0, 80, **SMALL_TRACE)
    static = _server(stacks).serve_open_loop(wl, CFG, slo_s=0.3, step_time_s=0.01)
    ctl = GreedyController(ControllerConfig(interval_s=0.1))
    adaptive = _server(stacks).serve_open_loop(wl, CFG, slo_s=0.3, step_time_s=0.01, controller=ctl)
    assert static.offered == adaptive.offered == 80
    assert len(static.completed) + len(static.shed) == 80
    assert len(adaptive.completed) + len(adaptive.shed) == 80
    assert adaptive.goodput > static.goodput, (adaptive, static)
    assert ctl.actions and any(a["action"] == "theta_offset" for a in ctl.actions)
    assert adaptive.controller_actions == ctl.actions


def test_shed_requests_come_back_marked(stacks):
    """Shed requests return with ``shed=True`` and no output, completed
    ones unmarked; the registry agrees with the report, and the trace (shed
    requests end in a ``complete`` instant) validates."""
    wl = bursty(2.0, 400.0, 60, seed=3, mean_on_s=0.8, mean_off_s=0.3, prompt_len=(4, 12), max_new_tokens=(2, 5),
                vocab=64)
    ctl = GreedyController(ControllerConfig(interval_s=0.05, shed_margin=1.0))
    tr = Tracer()
    cfg = dataclasses.replace(CFG, obs=Observability(tracer=tr, clock=VirtualClock()))
    report = _server(stacks).serve_open_loop(wl, cfg, slo_s=0.2, step_time_s=0.01, controller=ctl)
    assert report.shed, "trace tuned to force shedding"
    assert all(r.shed and r.output is None for r in report.shed)
    assert all(not r.shed and r.output is not None for r in report.completed)
    assert report.offered == len(report.completed) + len(report.shed)
    reg = ctl.run.ob.registry
    assert reg.value("serve.open_loop.shed") == len(report.shed)
    assert reg.value("serve.open_loop.offered") == report.offered
    validate_trace(tr.export())


def test_open_loop_latency_counts_queue_wait(stacks):
    specs = [ArrivalSpec(t_s=0.0, tokens=np.arange(4, dtype=np.int32) + 1, max_new_tokens=4),
             ArrivalSpec(t_s=0.0, tokens=np.arange(4, dtype=np.int32) + 7, max_new_tokens=4)]
    ob = Observability(clock=VirtualClock())
    _server(stacks).serve_open_loop(Workload(specs), ServeConfig(n_slots=1, max_seq=64, obs=ob), slo_s=10.0,
                                    step_time_s=0.01)
    h = ob.registry.get("serve.request_latency_s")
    assert h.count == 2
    assert h._max > h._min > 0


def test_open_loop_requires_advanceable_clock(stacks):
    cfg = ServeConfig(n_slots=2, max_seq=64, obs=Observability())
    with pytest.raises(AssertionError, match="advanceable"):
        _server(stacks).serve_open_loop(poisson(10.0, 2, seed=0, vocab=64), cfg, slo_s=1.0)


def test_slot_limit_caps_admission(stacks):
    """Admission-side only: at limit 1 a stream of 4 slots never holds more
    than one occupant, raising the limit reopens the idle slots, and limits
    clamp into [1, n_slots]."""
    v1, _ = stacks
    tcfg = _tcfg(SMALL)
    member = jax.tree.map(lambda a: a[0], v1)
    eng = ServingEngine(tcfg, params_from_numpy(member, tcfg, device="cpu"), max_seq=64, device="cpu")
    st = eng.slot_stream(ServeConfig(n_slots=4, max_seq=64))
    st.set_slot_limit(1)
    rng = np.random.default_rng(2)
    st.submit([Request(tokens=rng.integers(0, 64, 6).astype(np.int32), max_new_tokens=3) for _ in range(5)])
    done = []
    while st.runnable and len(done) < 3:
        done.extend(st.step())
        assert sum(r is not None for r in st.slot_req) <= 1
    st.set_slot_limit(4)
    done.extend(st.drain())
    assert len(done) == 5
    st.set_slot_limit(0)
    assert st.slot_limit == 1
    st.set_slot_limit(99)
    assert st.slot_limit == 4


# ---------------------------------------------------------------------------
# theta offsets, compile-once, and parity with the JAX package
# ---------------------------------------------------------------------------


def test_zero_offset_is_the_plain_theta(stacks):
    """``effective_theta`` reads ``spec.theta`` itself at offset 0 and
    clamps into [0, 1] otherwise; a controller whose watermarks are never
    reached leaves every offset at 0 and gives the static run's report."""
    server = _server(stacks)
    wl = bursty(2.0, 300.0, 80, **SMALL_TRACE)
    # watermarks out of reach (an SLO no latency busts, no backlog deep
    # enough): the controller ticks and reads but never actuates
    ctl = GreedyController(ControllerConfig(interval_s=0.1, backlog_slots=1e9, shift_hysteresis=10**9,
                                            shed_margin=1e9))
    idle = server.serve_open_loop(wl, CFG, slo_s=100.0, step_time_s=0.01, controller=ctl)
    static = server.serve_open_loop(wl, CFG, slo_s=100.0, step_time_s=0.01)
    assert ctl.run.theta_offset == [0.0, 0.0] and not idle.controller_actions
    assert _key(idle) == _key(static)
    run = ctl.run
    assert run.effective_theta(0) is server.tiers[0].spec.theta
    run.theta_offset[0] = -1.0
    assert run.effective_theta(0) == 0.0
    run.theta_offset[0] = 0.5
    assert run.effective_theta(0) == 1.0


def test_open_loop_after_closed_loop_captures_nothing(stacks):
    """``set_slot_limit`` changes no shape: an open-loop run (with the
    controller moving slot limits) after a closed-loop run of the same
    geometry adds nothing to ``trace_counts()``, paged and dense."""
    wl = bursty(2.0, 300.0, 80, **SMALL_TRACE)
    for paged in (True, False):
        server = _server(stacks)
        cfg = dataclasses.replace(CFG, paged=paged)
        server.serve_continuous([r for _, r in wl], cfg)
        before = trace_counts()
        ctl = GreedyController(ControllerConfig(interval_s=0.1))
        report = server.serve_open_loop(wl, cfg, slo_s=0.3, step_time_s=0.01, controller=ctl)
        assert trace_counts() == before
        assert any(a["action"] == "slot_limit" for a in report.controller_actions)


@pytest.mark.parametrize("controller", [False, True])
def test_bench_ab_matches_jax(controller):
    """``bench_serving``'s open-loop A/B (bench-s x3 at vote 0.67 ->
    bench-b, 4 slots, max_seq 64, SLO 0.3 s, 0.01 s a sweep; the
    controller at a 0.1 s interval): the port's report equals the JAX
    package's in everything, controller actions included."""
    v1, v2 = _stack(BENCH_S, 0, 3), _stack(BENCH_B, 1, 1)
    j_server = JServer([JTier(BENCH_S, jax.tree.map(jax.numpy.asarray, v1), JTierSpec("t1", "vote", 0.67, k=3, cost=1.0)),
                        JTier(BENCH_B, jax.tree.map(jax.numpy.asarray, v2),
                              JTierSpec("t2", "confidence", -1.0, k=1, cost=30.0))])
    t_server = _server((v1, v2), BENCH_S, BENCH_B, cost=30.0)
    kw = dict(slo_s=0.3, step_time_s=0.01)
    ref = j_server.serve_open_loop(j_bursty(2.0, 300.0, 80, **BENCH_TRACE), JServeConfig(n_slots=4, max_seq=64),
                                   controller=JGreedyController(JControllerConfig(interval_s=0.1)) if controller
                                   else None, **kw)
    got = t_server.serve_open_loop(bursty(2.0, 300.0, 80, **BENCH_TRACE), CFG,
                                   controller=GreedyController(ControllerConfig(interval_s=0.1)) if controller
                                   else None, **kw)
    assert _key(got) == _key(ref)
    assert got.offered == len(got.completed) + len(got.shed) == 80
    assert [s[k] for s in t_server.last_stream_stats for k in ("admitted", "decode_tokens")] == \
        [s[k] for s in j_server.last_stream_stats for k in ("admitted", "decode_tokens")]

"""Tier placement in the port (``serve/placement.py``, the routed cascade's
``transport=``/``hosts=`` and the placed ``CascadeServer``) against the
JAX package on the CPU: the scenarios of ``tests/test_placement_transport.
py``, the speculative draft on the hop (``tests/test_speculative.py``), the
open loop's in-flight branch and the edge-to-cloud bench's check
(``benchmarks/bench_edge_cloud.py``).

Equal to the JAX package: classify's pred, tier_of and hop list over
``edge_cloud`` (only the deferred rows cross, ``n_pad * (S*4 + 4)``
bytes); no deferrals, no traffic; the simulated link's latency and
bandwidth; ``serve_continuous``'s re-queue over the link, tokens and hops;
the speculative draft riding the hop; the open-loop report over a ``sim``
link.  The bench's check is a test: the metered latency per request within
2 % of ``EdgeCloudCost.mean_latency(defer_rate)`` at every delay of the
grid, on the bench's synthetic pool logits.

A pod placement puts tiers on slices of a ``torch.distributed`` mesh, so it
runs in a world of ranks, which no pytest worker starts: here both tiers
sit on the one rank's (1, 1, 1) mesh of a one-rank ``gloo`` world in a
subprocess (``tests/torch_mesh_world.py``, run once a session by
``test_torch_sharding.py``'s ``mesh_worlds`` fixture), a degenerate placement (the
hosts are not disjoint) that runs the mesh path's routing and metering,
but not two ranks.  The JAX test that forces 8 host devices
(``test_pod_placement_disjoint_hosts_subprocess``) has its counterpart in
``tests/test_torch_sharding.py``, on 8 spawned ranks."""
import jax
import numpy as np
import pytest
import torch

from benchmarks.common import PoolModel, sample_pool_logits, skill_for_accuracy
from repro.core.cost_model import EDGE_DELAYS as J_EDGE_DELAYS
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import bursty as j_bursty
from repro.serve import edge_cloud as j_edge_cloud
from repro.serve import CascadeServer as JServer
from repro_torch.core import calibration, deferral
from repro_torch.core import cascade as t_cascade
from repro_torch.core.cascade import TierSpec, bucket_chunks, cascade_apply_routed
from repro_torch.core.cost_model import EDGE_DELAYS, EdgeCloudCost
from repro_torch.obs import Observability, Tracer
from repro_torch.serve import (
    CascadeServer,
    Host,
    Request,
    ServeConfig,
    SimulatedLinkTransport,
    TierPlacement,
    bursty,
    edge_cloud,
    hosts_disjoint,
    single_host,
)
from test_torch_open_loop import SMALL_TRACE, _key
from test_torch_cascade import numpy_values
from test_torch_sharding import _unplaced, mesh_worlds  # noqa: F401 (a fixture)
from test_torch_speculative import DENSE, _prompts, _servers
from test_torch_transport import hop_list, jax_server, jax_stacks, outputs, port_server, prompts, serve_port


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stacks():
    return jax_stacks()


# ---------------------------------------------------------------------------
# batch mode: only the deferred rows cross
# ---------------------------------------------------------------------------


def test_edge_cloud_transport_meters_only_deferrals(stacks):
    """Tier 1 under the confidence rule at its median score: about half the
    batch defers, and only that slice (rows + int32 index map, padded to
    the bucket cover) crosses, as in the JAX package."""
    B, S = 16, 12
    toks = np.random.default_rng(4).integers(0, 64, (B, S)).astype(np.int32)
    probe = port_server(stacks).tiers[0].last_logits(toks)
    theta = float(np.median(deferral.confidence_rule(probe, 0.0).score.numpy()))
    placement = edge_cloud(delay="medium")
    res = port_server(stacks, placement, rule="confidence", theta=theta).classify(toks)
    j_pl = j_edge_cloud(delay="medium")
    ref = jax_server(stacks, j_pl, rule="confidence", theta=theta).classify(toks)
    np.testing.assert_array_equal(res.pred, ref.pred)
    np.testing.assert_array_equal(res.tier_of, ref.tier_of)
    link = placement.link(0)
    assert hop_list(link) == pytest.approx(hop_list(j_pl.link(0)))
    n_def = int(res.tier_counts[1])
    assert 0 < n_def < B and link.total_examples == n_def
    n_pad = min(sum(bucket_chunks(n_def, 8)), B)
    assert link.total_bytes == n_pad * (S * 4 + 4) < B * S * 4
    assert link.total_latency == pytest.approx(0.1)  # one metered hop
    # the placement moves no answer: the unplaced routed cascade's result
    ref_unplaced = port_server(stacks, rule="confidence", theta=theta).classify(toks)
    np.testing.assert_array_equal(res.pred, ref_unplaced.pred)
    np.testing.assert_array_equal(res.tier_of, ref_unplaced.tier_of)
    np.testing.assert_array_equal(res.scores, ref_unplaced.scores)


def test_routed_defer_path_fetches_only_scalars(stacks):
    """On a single host (loopback metered), the host reads one count scalar
    a transition plus the final results: the payload stays put."""
    placement = single_host(2)
    B, S = 16, 12
    toks = np.random.default_rng(2).integers(0, 64, (B, S)).astype(np.int32)
    t_cascade.reset_host_fetch_stats()
    res = port_server(stacks, placement).classify(toks)
    assert res.tier_counts.sum() == B
    assert t_cascade.host_fetch_stats() == {"bytes": B * 4 * 3 + 2 * 4 + 4, "calls": 2}
    assert placement.link(0).total_examples == int(res.tier_counts[1])


def test_no_deferrals_no_traffic(stacks):
    """Three copies of one member always agree: the link carries nothing."""
    v1, v2 = stacks
    same = jax.tree.map(lambda x: np.stack([x[0]] * 3), v1)
    placement = edge_cloud(delay="large")
    res = port_server((same, v2), placement, theta=0.99).classify(
        np.random.default_rng(5).integers(0, 64, (16, 12)).astype(np.int32))
    assert res.tier_counts[0] == 16
    assert placement.link(0).total_bytes == 0 and placement.link(0).total_latency == 0.0


def test_simulated_link_latency_and_bandwidth():
    tr = SimulatedLinkTransport(delay=0.01, bandwidth=1e6).bind("cpu")
    payload = {"x": torch.ones(4, 250)}  # 4000 B
    out = tr.send("edge0", "cloud0", payload, n_examples=4)
    assert torch.equal(out["x"], payload["x"]) and out["x"] is not payload["x"]
    assert tr.total_bytes == 4000
    assert tr.total_latency == pytest.approx(0.01 + 4000 / 1e6)
    assert tr.hops[0].src == "edge0" and tr.hops[0].dst == "cloud0"
    assert EDGE_DELAYS == J_EDGE_DELAYS
    assert SimulatedLinkTransport(delay="small").bind("cpu").delay == 0.01


# ---------------------------------------------------------------------------
# continuous mode: the re-queue crosses the link
# ---------------------------------------------------------------------------


def test_serve_continuous_requeue_crosses_link(stacks):
    """Exactly the deferred requests' prompts cross edge -> cloud, each
    once; tokens, tiers and hops equal the JAX package's."""
    ps = prompts(n=5, max_new=3)
    placement = edge_cloud(delay="small")
    got = serve_port(port_server(stacks, placement), ps, ServeConfig(n_slots=2, max_seq=32))
    j_pl = j_edge_cloud(delay="small")
    jreqs = [JRequest(tokens=t.copy(), max_new_tokens=m) for t, m in ps]
    assert got == outputs(jax_server(stacks, j_pl).serve_continuous(jreqs, JServeConfig(n_slots=2, max_seq=32)), jreqs)
    n_def = sum(t == 1 for t, _, _ in got)
    link = placement.link(0)
    assert link.total_examples == n_def > 0
    assert link.total_bytes == n_def * 8 * 4
    assert hop_list(link) == pytest.approx(hop_list(j_pl.link(0)))


@pytest.mark.parametrize("link", ["sim", "serial", "async"])
def test_draft_rides_metered_hop_and_order_is_irrelevant(link):
    """Speculative over a link: the draft's bytes are on the hop, the tokens
    are the plain run's, and (over the simulated link) the JAX package's
    tokens and hops."""
    j_plain, t_plain = _servers(DENSE, numpy_values(DENSE, 0, k=3))
    ps = _prompts(43, 6)

    def run(speculative):
        placement = edge_cloud(delay=0.01, link=link)
        server = CascadeServer(t_plain.tiers, device="cpu", placement=placement)
        got = serve_port(server, ps, ServeConfig(n_slots=2, max_seq=64, speculative=speculative))
        return got, placement.link(0), server

    base, link_plain, _ = run(False)
    spec, link_spec, server = run(True)
    assert base == spec
    assert len(link_spec.hops) == len(link_plain.hops) > 0
    for hp, hs in zip(link_plain.hops, link_spec.hops):
        assert hs.payload_bytes > hp.payload_bytes  # the same prompt, and the draft
    st = server.last_stream_stats[1]
    assert st["spec_accepted_tokens"] == st["spec_draft_tokens"] > 0
    assert st["inflight_admitted"] == len(link_spec.hops)
    if link == "sim":
        j_pl = j_edge_cloud(delay=0.01, link="sim")
        jreqs = [JRequest(tokens=t.copy(), max_new_tokens=m) for t, m in ps]
        jdone = JServer(j_plain.tiers, placement=j_pl).serve_continuous(
            jreqs, JServeConfig(n_slots=2, max_seq=64, speculative=True))
        assert spec == outputs(jdone, jreqs)
        assert hop_list(link_spec) == pytest.approx(hop_list(j_pl.link(0)))


def test_open_loop_inflight_branch(stacks):
    """Open loop over a link: over the simulated link the whole report is
    the JAX package's and the unplaced run's; over the async link (hops
    landing in wall time while virtual time runs) every request completes
    with the unplaced run's tokens."""
    wl = lambda g: g(2.0, 300.0, 24, **SMALL_TRACE)
    cfg = ServeConfig(n_slots=4, max_seq=64)
    plain = port_server(stacks).serve_open_loop(wl(bursty), cfg, slo_s=0.3, step_time_s=0.01)
    sim = port_server(stacks, edge_cloud(delay=0.01)).serve_open_loop(
        wl(bursty), cfg, slo_s=0.3, step_time_s=0.01)
    assert _key(sim) == _key(plain)
    ref = jax_server(stacks, j_edge_cloud(delay=0.01)).serve_open_loop(
        wl(j_bursty), JServeConfig(n_slots=4, max_seq=64), slo_s=0.3, step_time_s=0.01)
    assert _key(sim) == _key(ref)
    placement = edge_cloud(delay=0.01, link="async")
    rep = port_server(stacks, placement).serve_open_loop(wl(bursty), cfg, slo_s=0.3, step_time_s=0.01)
    assert rep.offered == len(rep.completed) == 24 and not rep.shed
    by_prompt = lambda r: {tuple(q.tokens.tolist()): (q.tier, q.output.tolist()) for q in r.completed}
    assert by_prompt(rep) == by_prompt(plain)
    assert placement.link(0).total_examples == sum(q.tier == 1 for q in rep.completed) > 0


# ---------------------------------------------------------------------------
# pod placement (degenerate: every host on the CPU) and the device checks
# ---------------------------------------------------------------------------


def test_pod_placement_on_one_device_is_degenerate(mesh_worlds):
    """Two 'pods' on one rank's mesh: not disjoint hosts, so this holds the
    routing and metering of a pod placement (values as DTensors on the
    slice, the hop from the slice's first rank, here its own destination,
    the answers broadcast), not two ranks; ``pod_placement`` itself needs a
    pod a tier.  Equal to the unplaced server.  Simulated hosts own no
    ranks, so they are disjoint."""
    setup = mesh_worlds.setup
    ref = _unplaced(setup, ("small", "big"), setup["theta"])
    (world,) = mesh_worlds.worlds["one_rank"]
    out = world["degenerate"]
    assert out["describe"] == "pod0(pod) -> pod1(pod)" and out["devices"] == [[0], [0]]
    assert not out["disjoint"] and "do not split into 2 slices" in out["split"]
    assert out["placed"] == ["DTensor", "DTensor"]
    np.testing.assert_array_equal(out["result"]["pred"], ref.pred)
    np.testing.assert_array_equal(out["result"]["tier_of"], ref.tier_of)
    n_def = int(ref.tier_counts[1])
    assert out["result"]["tier_counts"] == ref.tier_counts.tolist()
    assert out["link"]["examples"] == n_def > 0
    B, S = setup["tokens"].shape
    assert out["link"]["bytes"] == min(sum(bucket_chunks(n_def, 8)), B) * (S * 4 + 4)
    assert hosts_disjoint(edge_cloud()) and hosts_disjoint(single_host(2))


def test_server_binds_each_link_to_the_tier_it_feeds(stacks):
    """A placement names no landing device: the server binds each link to
    the device of the tier it feeds.  A link left unbound refuses to send;
    a link lands on one device, so binding it to another raises."""
    placement = edge_cloud(delay=0.01, link="serial")
    link = placement.link(0)
    with pytest.raises(RuntimeError, match="bound to no device"):
        link.send_async("edge0", "cloud0", {"x": np.zeros(2, np.int32)}, n_examples=1)
    assert not link.hops
    server = port_server(stacks, placement)
    assert link.device == server.tiers[1].device == torch.device("cpu")
    with pytest.raises(ValueError, match="lands payloads on cpu"):
        link.bind("meta")
    # the serial link hides nothing: every hop span's hidden time is 0
    ob = Observability(tracer=Tracer())
    reqs = [Request(tokens=t, max_new_tokens=m) for t, m in prompts(n=4, max_new=3)]
    server.serve_continuous(reqs, ServeConfig(n_slots=2, max_seq=32, obs=ob))
    spans = [e for e in ob.tracer.events if e.get("name") == "hop" and e.get("ph") == "E"]
    assert len(spans) == len(link.hops) > 0
    assert all(e["args"]["hidden_s"] == 0.0 and e["args"]["blocked_s"] >= 0.01 for e in spans)
    assert link.total_wait >= link.total_latency


def test_tier_off_its_hosts_device_is_refused(stacks):
    """Every host computes on the server's device (a simulated host, and a
    mesh host's rank): a tier elsewhere is refused, placed or not."""
    tiers = port_server(stacks).tiers
    pl = TierPlacement((Host("a", "edge"), Host("b", "cloud")), (None,))
    with pytest.raises(ValueError, match="lives on cpu, the server on meta"):
        CascadeServer(tiers, device="meta", placement=pl)
    with pytest.raises(ValueError, match="server"):
        CascadeServer(tiers, device="meta")


# ---------------------------------------------------------------------------
# benchmarks/bench_edge_cloud.py's check
# ---------------------------------------------------------------------------


def test_bench_edge_cloud_metered_latency_matches_analytic():
    """The bench's routed run at a unit-delay link, then the delay grid over
    the metered hops: the measured mean latency per request is within 2 %
    of ``EdgeCloudCost.mean_latency(defer_rate)`` at every delay.  (The
    routing and the calibration are held to the JAX package's in
    ``test_torch_cascade.py`` and ``test_torch_core_rest.py``.)"""
    edge = [PoolModel(f"edge{j}", skill_for_accuracy(0.72), 1.0, seed=j) for j in range(3)]
    cloud = [PoolModel("cloud", skill_for_accuracy(0.90), 100.0, seed=9)]
    n = 2000
    y, _, logits = sample_pool_logits(edge + cloud, n, seed=5, difficulty_beta=(1, 3))
    yc, _, logits_c = sample_pool_logits(edge + cloud, 400, seed=55, difficulty_beta=(1, 3))
    L = np.stack([logits[m.name] for m in edge]).astype(np.float32)
    Lc = np.stack([logits_c[m.name] for m in edge]).astype(np.float32)
    out_c = deferral.vote_rule(torch.as_tensor(Lc), 0.0)
    theta, _ = calibration.estimate_threshold(out_c.score.numpy(), out_c.pred.numpy() == yc, epsilon=0.03,
                                              n_samples=100)
    feat_dim = 64
    feats = np.random.default_rng(6).normal(size=(n, feat_dim)).astype(np.float32)
    batch = {"idx": np.arange(n, dtype=np.int32), "payload": feats}
    L_cloud = logits["cloud"][None].astype(np.float32)
    specs = [TierSpec("edge", "vote", theta, k=3, cost=1.0), TierSpec("cloud", "confidence", -1.0, k=1, cost=100.0)]
    fns = [lambda b, T=torch.as_tensor(L): T[:, b["idx"].long()],
           lambda b, T=torch.as_tensor(L_cloud): T[:, b["idx"].long()]]
    link = SimulatedLinkTransport(delay=1.0).bind("cpu")
    res = cascade_apply_routed(fns, specs, batch, pad_to=8, transport=link, hosts=["edge0", "cloud0"], device="cpu")
    n_def = int(res.tier_counts[1])
    defer_rate = n_def / n
    assert link.total_examples == n_def > 0
    assert link.total_bytes < n * (feat_dim * 4 + 4 + 4)
    unit_lat_sum = sum(h.n_examples * h.latency for h in link.hops)
    for name, delay in EDGE_DELAYS.items():
        cm = EdgeCloudCost(delay=delay)
        abc_lat = cm.mean_latency(defer_rate)
        meas_lat = cm.local + unit_lat_sum * delay / n
        assert abs(meas_lat - abc_lat) <= 0.02 * abc_lat + 1e-9, f"{name}: measured {meas_lat} vs analytic {abc_lat}"

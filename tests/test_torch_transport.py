"""Transport and in-flight admission in the port (``serve/transport.py``,
``SlotStream.submit_inflight``), against the JAX package on the CPU: the
scenarios of ``tests/test_async_transport.py``.

The hop/handle contract, serial metering identical to overlapped, the
token bucket serialising concurrent sends, FIFO in-flight order, one-slot
tiers completing, the routed classify over an async link reading one
count scalar a transition, and greedy tokens and metered hops equal to the
JAX package's over every link kind.  Sampled tokens (T = 0.8) are held
port-internally: bitwise equal with no placement, ``single_host``, and the
``sim``, ``serial`` and ``async`` links (JAX's PRNG is not reproduced).

Weights have the JAX package's structure, shapes and dtypes (float32),
filled from a numpy seed (``test_torch_cascade.numpy_values``) and carried
into the port through ``repro_torch.bridge``.  Real sleeps are 20 ms or less.  Left out: the
sharded hand-off (``ShardedDevicePutTransport`` needs the port's
``sharding/``, not ported) and the transfer guard (no PyTorch
counterpart; the port meters every read through ``host_fetch``)."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core.cascade import TierSpec as JTierSpec
from repro.serve import CascadeServer as JServer
from repro.serve import CascadeTier as JTier
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import edge_cloud as j_edge_cloud
from repro.serve import single_host as j_single_host
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ModelConfig
from repro_torch.core import cascade as t_cascade
from repro_torch.core.cascade import TierSpec
from repro_torch.serve import (
    AsyncTransport,
    CascadeServer,
    CascadeTier,
    LoopbackTransport,
    Request,
    SendHandle,
    ServeConfig,
    ServingEngine,
    SimulatedLinkTransport,
    SlotStream,
    edge_cloud,
    single_host,
    tree_bytes,
)
from test_torch_cascade import numpy_values

_BASE = dict(family="dense", remat=False, dtype="float32", vocab_size=64)
# tests/test_async_transport.py's tiers, in float32
SMALL = JModelConfig(name="tiny-s", n_layers=2, d_model=64, d_ff=128, n_heads=4, n_kv_heads=2, **_BASE)
BIG = JModelConfig(name="tiny-b", n_layers=3, d_model=96, d_ff=192, n_heads=4, n_kv_heads=4, **_BASE)
# the placements every serving parity runs over: None is the unplaced server
PLACEMENTS = (None, "single_host", "sim", "serial", "async")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_stacks():
    """Tier 1's three members and tier 2's one, as numpy trees."""
    return numpy_values(SMALL, 40, k=3), numpy_values(BIG, 41, k=1)


@pytest.fixture(scope="module")
def stacks():
    return jax_stacks()


def tcfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def port_placement(kind, delay=0.01):
    if kind is None:
        return None
    if kind == "single_host":
        return single_host(2)
    return edge_cloud(delay=delay, link=kind)


def jax_placement(kind, delay=0.01):
    if kind is None:
        return None
    if kind == "single_host":
        return j_single_host(2)
    return j_edge_cloud(delay=delay, link=kind)


def port_server(stacks, placement=None, *, temperature=0.0, theta=0.67, rule="vote"):
    """The JAX tests' cascade in the port: tier 1 a k=3 ensemble, tier 2
    answers (confidence -1)."""
    v1, v2 = stacks
    return CascadeServer([
        CascadeTier(tcfg(SMALL), params_from_numpy(v1, tcfg(SMALL), device="cpu"),
                    TierSpec("t1", rule, theta, k=3, cost=1.0), temperature=temperature, device="cpu"),
        CascadeTier(tcfg(BIG), params_from_numpy(v2, tcfg(BIG), device="cpu"),
                    TierSpec("t2", "confidence", -1.0, k=1, cost=50.0), temperature=temperature, device="cpu"),
    ], device="cpu", placement=placement)


def jax_server(stacks, placement=None, *, theta=0.67, rule="vote"):
    v1, v2 = stacks
    return JServer([
        JTier(SMALL, jax.tree.map(jax.numpy.asarray, v1), JTierSpec("t1", rule, theta, k=3, cost=1.0)),
        JTier(BIG, jax.tree.map(jax.numpy.asarray, v2), JTierSpec("t2", "confidence", -1.0, k=1, cost=50.0)),
    ], placement=placement)


def prompts(n=8, max_new=5, length=8, seed=6):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, length).astype(np.int32), max_new) for _ in range(n)]


def outputs(done, reqs):
    """(tier, truncated, output) per request, in submission order."""
    by = {r.rid: r for r in done}
    assert sorted(by) == sorted(r.rid for r in reqs), "every request completes exactly once"
    return [(by[q.rid].tier, bool(by[q.rid].truncated), np.asarray(by[q.rid].output).tolist()) for q in reqs]


def hop_list(link, latency=True):
    return [(h.src, h.dst, h.n_examples, h.payload_bytes) + ((h.latency,) if latency else ()) for h in link.hops]


def serve_port(server, ps, config):
    reqs = [Request(tokens=t.copy(), max_new_tokens=m) for t, m in ps]
    return outputs(server.serve_continuous(reqs, config), reqs)


# ---------------------------------------------------------------------------
# the hop/handle contract
# ---------------------------------------------------------------------------


def test_send_async_returns_live_handle_and_meters_at_send_time():
    tr = AsyncTransport(delay=0.02).bind("cpu")
    payload = {"x": np.arange(12, dtype=np.int32), "y": torch.ones(3, 2, dtype=torch.bfloat16)}
    t0 = time.perf_counter()
    h = tr.send_async("edge0", "cloud0", payload, n_examples=3)
    assert time.perf_counter() - t0 < 0.015, "send_async must not block"
    # metered at send time, before the payload lands: 48 + 12 bytes
    assert tr.total_bytes == tree_bytes(payload) == 60 and tr.total_examples == 3
    assert tr.hops[0].latency == pytest.approx(0.02)
    payload["x"][:] = -1  # the bytes left at send time
    out = h.result()
    assert h.done() and h.result() is out  # memoised
    np.testing.assert_array_equal(out["x"].numpy(), np.arange(12))
    assert out["y"].dtype == torch.bfloat16 and out["y"].device.type == "cpu"


def test_serial_mode_blocks_but_meters_identically():
    """The JAX package's serial case.  One deviation: the port charges the
    inline sleep to the handle's ``wait_time`` and to ``total_wait`` (the
    JAX package reports 0), so latency - wait, the hidden link time, reads
    0 on the serial link, which hides nothing."""
    tr = AsyncTransport(delay=0.02, overlap=False).bind("cpu")
    t0 = time.perf_counter()
    h = tr.send_async("edge0", "cloud0", {"x": np.zeros(4, np.float32)}, n_examples=4)
    assert time.perf_counter() - t0 >= 0.02, "a serial send sleeps inline"
    assert h.done() and tr.hops[0].latency == pytest.approx(0.02)
    assert tr.total_wait == h.wait_time >= 0.02
    assert tr.total_latency - tr.total_wait <= 0.0


def test_sync_backends_return_resolved_handles():
    for tr in (LoopbackTransport(), SimulatedLinkTransport(delay=0.01).bind("cpu")):
        x = torch.ones(2)
        h = tr.send_async("a", "b", {"x": x}, n_examples=2)
        assert isinstance(h, SendHandle) and h.done() and tr.total_examples == 2
        # the loopback hands the tree over as it is; the link moves the bytes
        assert (h.result()["x"] is x) == isinstance(tr, LoopbackTransport)


def test_handle_wait_time_is_the_unhidden_link_time():
    tr = AsyncTransport(delay=0.02).bind("cpu")
    h = tr.send_async("e", "c", {"x": np.zeros(2, np.int32)}, n_examples=1)
    h.result()  # nothing overlapped: the latency shows up as wait
    assert tr.total_wait == pytest.approx(0.02, abs=0.015)
    h2 = tr.send_async("e", "c", {"x": np.zeros(2, np.int32)}, n_examples=1)
    time.sleep(0.03)  # "compute" hides the whole hop
    h2.result()
    assert h2.wait_time < 0.01


def test_bandwidth_token_bucket_serializes_concurrent_sends():
    """Two concurrent sends of tx = 20 ms each: the second queues behind the
    first transmission; pure-delay hops stay concurrent."""
    payload = {"x": np.zeros(1000, np.float32)}  # 4000 bytes
    tr = AsyncTransport(delay=0.0, bandwidth=200_000.0).bind("cpu")  # tx = 0.02 s
    t0 = time.perf_counter()
    h1 = tr.send_async("e", "c", payload, n_examples=1)
    h2 = tr.send_async("e", "c", payload, n_examples=1)
    h1.result()
    t1 = time.perf_counter() - t0
    h2.result()
    t2 = time.perf_counter() - t0
    assert t1 >= 0.02, f"the first send pays its own tx: {t1:.3f}s"
    assert t2 >= 0.039, f"the second send queues behind the first: {t2:.3f}s"
    # metering stays uncontended: delay + bytes / bandwidth each
    assert [h.latency for h in tr.hops] == [pytest.approx(0.02)] * 2
    assert tr.total_wait > 0.0
    tr2 = AsyncTransport(delay=0.02).bind("cpu")
    t0 = time.perf_counter()
    for h in [tr2.send_async("e", "c", payload, n_examples=1) for _ in range(4)]:
        h.result()
    assert time.perf_counter() - t0 < 0.06, "pure-delay hops overlap"


def test_bandwidth_metering_identical_serial_vs_overlapped():
    payload = {"x": np.arange(256, dtype=np.float32)}
    lists = []
    for overlap in (False, True):
        tr = AsyncTransport(delay=0.002, bandwidth=1e6, overlap=overlap).bind("cpu")
        for h in [tr.send_async("e", "c", payload, n_examples=2) for _ in range(3)]:
            h.result()
        assert tr.total_bytes == 3 * 256 * 4
        lists.append(hop_list(tr))
    assert lists[0] == lists[1]


# ---------------------------------------------------------------------------
# SlotStream in-flight admission
# ---------------------------------------------------------------------------


def test_slot_stream_inflight_admission(stacks):
    v1, _ = stacks
    one = params_from_numpy(jax.tree.map(lambda a: a[0], v1), tcfg(SMALL), device="cpu")
    stream = ServingEngine(tcfg(SMALL), one, max_seq=64, device="cpu").slot_stream(ServeConfig(n_slots=2))
    tr = AsyncTransport(delay=0.01).bind("cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(tokens=rng.integers(0, 64, 6).astype(np.int32), max_new_tokens=3) for _ in range(3)]
    for r in reqs:
        h = tr.send_async("edge0", "cloud0", {"tokens": r.tokens}, n_examples=1)
        stream.submit_inflight(h, lambda delivered, r=r: r)
    assert stream.active and not stream.runnable
    done = stream.drain()
    assert len(done) == 3 and stream.stats["inflight_admitted"] == 3
    assert stream.stats["inflight_wait"] >= 0.0
    assert not stream.inflight and not stream.active


def test_slot_stream_inflight_preserves_fifo_order():
    """Handles land in submission order even when a later one is done
    first."""

    class _Stub:
        total_wait = 0.0

        def _waited(self, s):
            pass

    class _Handle(SendHandle):
        def __init__(self, ready):
            super().__init__(_Stub(), value=None)
            self._ready = ready

        def done(self):
            return self._ready()

    class _NullBackend:
        E = 1
        supports_chunked_prefill = False

        def decode(self, tok, pos):
            return np.zeros((1, tok.shape[1]), np.int32)

        def reset_slot(self, s):
            pass

    stream = SlotStream(_NullBackend(), ServeConfig(n_slots=1, max_seq=8))
    first = {"ready": False}
    r1 = Request(tokens=np.array([1], np.int32), max_new_tokens=1)
    r2 = Request(tokens=np.array([2], np.int32), max_new_tokens=1)
    stream.submit_inflight(_Handle(lambda: first["ready"]), lambda _: r1)
    stream.submit_inflight(_Handle(lambda: True), lambda _: r2)
    stream.poll_inflight(block=False)
    assert not stream.queue and len(stream.inflight) == 2
    first["ready"] = True
    stream.poll_inflight(block=False)
    assert [r.rid for r in stream.queue] == [r1.rid, r2.rid]


# ---------------------------------------------------------------------------
# serving over a link: the JAX package's tokens and hops, at every link kind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("link", ["sim", "serial", "async"])
def test_async_equals_sync_generations_and_metered_hops(stacks, link):
    """Tokens, answering tiers and the metered hop list equal the JAX
    package's over the same link kind and to the unplaced port run; an
    overlapped link hides some of its latency."""
    ps = prompts()
    cfg = ServeConfig(n_slots=2, max_seq=32)
    placement = port_placement(link)
    got = serve_port(port_server(stacks, placement), ps, cfg)
    assert got == serve_port(port_server(stacks), ps, cfg)
    j_pl = jax_placement(link)
    jreqs = [JRequest(tokens=t.copy(), max_new_tokens=m) for t, m in ps]
    jdone = jax_server(stacks, j_pl).serve_continuous(jreqs, JServeConfig(n_slots=2, max_seq=32))
    assert got == outputs(jdone, jreqs)
    assert hop_list(placement.link(0), latency=False) == hop_list(j_pl.link(0), latency=False)
    assert [h.latency for h in placement.link(0).hops] == pytest.approx([h.latency for h in j_pl.link(0).hops])
    link_t = placement.link(0)
    assert link_t.total_examples == sum(t == 1 for t, _, _ in got) > 0, "the test needs real deferrals"
    if link == "async":
        assert link_t.total_wait < link_t.total_latency


def test_async_serving_completes_all_requests_with_one_slot_tiers(stacks):
    """n_slots=1: the all-idle fallback blocks on in-flight hops instead of
    dropping them or spinning."""
    done = port_server(stacks, edge_cloud(delay=0.01, link="async")).serve_continuous(
        [Request(tokens=t, max_new_tokens=m) for t, m in prompts(n=4, max_new=3)], ServeConfig(n_slots=1, max_seq=32))
    assert len(done) == 4 and all(r.output is not None for r in done)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_tokens_bitwise_across_placements(stacks, temperature):
    """Greedy and sampled tokens are bitwise the same with no placement,
    ``single_host`` and the three links: tier 2 admits deferrals in
    submission order whatever the link's timing, and a slot's key comes
    from its admission sequence."""
    ps = prompts()
    cfg = ServeConfig(n_slots=2, max_seq=32, seed=7)
    runs = {kind: serve_port(port_server(stacks, port_placement(kind), temperature=temperature, theta=0.9), ps, cfg)
            for kind in PLACEMENTS}
    assert sum(t == 1 for t, _, _ in runs[None]) > 0, "the test needs real deferrals"
    for kind in PLACEMENTS[1:]:
        assert runs[kind] == runs[None], kind


# ---------------------------------------------------------------------------
# the routed classify over an async link: one count read a transition
# ---------------------------------------------------------------------------


def test_async_classify_fetches_one_count_scalar_per_transition(stacks):
    placement = edge_cloud(delay=0.005, link="async")
    server = port_server(stacks, placement)
    B, S = 16, 12
    toks = np.random.default_rng(2).integers(0, 64, (B, S)).astype(np.int32)
    t_cascade.reset_host_fetch_stats()
    res = server.classify(toks)
    assert res.tier_counts.sum() == B
    stats = t_cascade.host_fetch_stats()
    # pred, tier_of, scores and the tier counts, plus one count scalar
    assert stats == {"bytes": B * 4 * 3 + 2 * 4 + 4, "calls": 2}, stats
    assert placement.link(0).total_examples == int(res.tier_counts[1]) > 0
    ref = port_server(stacks).classify(toks)
    np.testing.assert_array_equal(res.pred, ref.pred)
    np.testing.assert_array_equal(res.tier_of, ref.tier_of)


def test_attach_obs_mirrors_the_link(stacks):
    """A placed run mirrors each link's metering into the run's registry
    as ``transport.{src}_{dst}.*`` (tests/test_obs_registry.py's names)."""
    from repro_torch.obs import Observability

    placement = edge_cloud(delay=0.01, link="sim")
    ob = Observability()
    reqs = [Request(tokens=t, max_new_tokens=m) for t, m in prompts(n=4, max_new=3)]
    port_server(stacks, placement).serve_continuous(reqs, ServeConfig(n_slots=2, max_seq=32, obs=ob))
    link = placement.link(0)
    reg = ob.registry
    assert reg.value("transport.edge0_cloud0.hops") == len(link.hops) > 0
    assert reg.value("transport.edge0_cloud0.bytes") == link.total_bytes
    assert reg.value("transport.edge0_cloud0.examples") == link.total_examples
    assert reg.value("transport.edge0_cloud0.latency_s") == pytest.approx(link.total_latency)
    assert reg.value("slot_stream.tier1.inflight_admitted") == len(link.hops)

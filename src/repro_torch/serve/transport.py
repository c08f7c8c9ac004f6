"""Inter-tier transport (port of ``repro.serve.transport``): the runtime
object behind §5.2's cost boundaries.

A cascade's deferrals cross a placement boundary (edge -> cloud, device ->
device, host -> API); the paper's headline numbers come from only the
disagreements paying that boundary's cost.  Every deferral hop goes through
a ``Transport`` that meters the payload bytes and accounts the hop's
latency, so a run reports measured traffic beside the analytic
``core.cost_model.EdgeCloudCost``.

Payload and bytes contract (every backend): callers send only what crosses
the boundary — the compacted deferral payload plus its int32 routing index
map, never the full batch — and every hop records ``Hop(src, dst,
n_examples, payload_bytes, latency)`` at send time, so the metered hop list
is the same whether a hop is drained at once or later.  Continuous-mode
payloads are ``{"tokens": (S,) int32 prompt}`` plus, under
``ServeConfig.speculative``, ``"draft": (T,) int32``, the sending tier's
agreeing generation; its bytes are metered like any other leaf.  Payload
leaves are torch tensors or numpy arrays; a delivered payload's leaves are
tensors on the link's destination device, except over the loopback, which
hands the tree over as it is.  The destination is the device of the tier
the link feeds: ``CascadeServer`` binds each link of its placement to it
when it is built (``Transport.bind``); a link used on its own is bound by
its caller.

Backends:

``LoopbackTransport``       in-process hand-off (same host).  No latency,
                            but it meters bytes, so tests can hold that only
                            the compacted deferral payload crosses.
``DevicePutTransport``      device -> device inside one process: the payload
                            is moved with ``.to`` the destination device.
``SimulatedLinkTransport``  the §5.2.1 delay grid plus a bandwidth term
                            (seconds = delay + bytes / bandwidth).  The bytes
                            really move (a snapshot to the host, then
                            ``.to`` the destination); the latency accumulates on
                            a simulated clock instead of being slept.
``AsyncTransport``          the same physics with real wall-clock latency,
                            slept by a worker thread: ``send_async`` returns
                            a ``SendHandle`` at once and the handle resolves
                            ``latency`` seconds later, so a serving loop
                            keeps decoding while the hop is in flight.

Every backend offers ``send_async``; the synchronous ones return a handle
that is already resolved, so one call site serves all.  Only the caller's
thread touches a device: the snapshot runs in ``send_async``, the re-feed
to the destination in the handle's finalize on the draining thread, and
the workers only sleep.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.cost_model import EDGE_DELAYS
from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.obs import perf_clock


def tree_bytes(tree) -> int:
    """Total payload bytes of a nested dict of tensors and numpy arrays:
    numel x element size, summed."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)


def _snapshot(tree):
    """A host copy of every leaf (CPU tensors): the bytes leave the source
    now, so the sender may go on mutating its buffers."""
    def snap(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.detach().to("cpu", copy=True)
        return torch.from_numpy(np.array(leaf, copy=True))

    return tree_map(snap, tree)


def _to_device(tree, device: torch.device):
    return tree_map(lambda leaf: torch.as_tensor(leaf).to(device), tree)


@dataclasses.dataclass
class Hop:
    """One metered boundary crossing: ``n_examples`` real (unpadded)
    deferred examples, ``payload_bytes`` as sent (bucket padding included:
    that is what crosses the wire), ``latency`` in the backend's seconds
    (simulated or wall clock)."""

    src: str
    dst: str
    n_examples: int
    payload_bytes: int
    latency: float


class SendHandle:
    """The future side of a hop: ``result()`` blocks until the payload has
    crossed and returns the delivered tree (memoised); ``done()`` never
    blocks, so admission points can poll.

    ``wait_time`` is how long the caller blocked on this hop: in
    ``result()``, or inline in a serial ``AsyncTransport`` send.  It is the
    part of the hop's latency the caller did not hide behind other work;
    the transport sums it in ``total_wait``."""

    def __init__(self, transport: "Transport", future: Optional[Future] = None, value=None, finalize=None):
        self._transport = transport
        self._future = future
        self._value = value
        self._finalize = finalize  # runs on the draining thread, once
        self._resolved = future is None
        self.wait_time = 0.0

    @classmethod
    def resolved(cls, transport: "Transport", value) -> "SendHandle":
        """A handle whose hop already completed (synchronous backends)."""
        return cls(transport, value=value)

    def done(self) -> bool:
        """True once the payload has crossed the link (never blocks)."""
        return self._resolved or self._future.done()

    def result(self):
        """The delivered payload; blocks until the hop completes and charges
        the blocked time to ``wait_time`` and ``Transport.total_wait``."""
        if not self._resolved:
            clock = self._transport._clock
            t0 = clock()
            self._value = self._future.result()
            self.wait_time = clock() - t0
            self._transport._waited(self.wait_time)
            self._resolved = True
            self._future = None
            if self._finalize is not None:
                # the arrival side (the re-feed to the destination device)
                # runs on the draining thread: workers only sleep the link
                self._value = self._finalize(self._value)
                self._finalize = None
        return self._value


class Transport:
    """Base transport: metering and stats; subclasses set the link physics
    through ``_latency(payload_bytes)`` (the seconds a hop accounts) and
    ``_deliver(tree)`` (what crossing does to the payload).  The base
    ``send_async`` delivers synchronously."""

    def __init__(self):
        self.hops: List[Hop] = []
        self.total_wait = 0.0  # seconds callers blocked in SendHandle.result
        self._wait_lock = threading.Lock()
        # injectable wait clock; the token bucket's time.monotonic stays wall clock
        self._clock = perf_clock
        self._obs_c = None  # optional mirrored registry counters
        self.device: Optional[torch.device] = None  # where payloads land: bind()

    def bind(self, device) -> "Transport":
        """Land delivered payloads on ``device`` (``resolve_device``: None
        means the card), the device of the tier this link feeds.  A link
        lands on one device: binding it to another raises."""
        dev = resolve_device(device)
        if self.device is not None and self.device != dev:
            raise ValueError(f"this link lands payloads on {self.device}, not {dev}")
        self.device = dev
        return self

    def _landing(self) -> torch.device:
        if self.device is None:
            raise RuntimeError("the link is bound to no device: place it in a CascadeServer or call bind(device)")
        return self.device

    def attach_obs(self, obs, name: str):
        """Mirror this link's metering into ``obs``'s registry as
        ``transport.{name}.*`` (hops, bytes, examples, latency_s, wait_s)."""
        sc = obs.scope(f"transport.{name}")
        self._clock = obs.clock
        self._obs_c = tuple(sc.counter(k) for k in ("hops", "bytes", "examples", "latency_s", "wait_s"))
        return self

    # -- link physics (overridden) ----------------------------------------
    def _latency(self, payload_bytes: int) -> float:
        return 0.0

    def _deliver(self, tree):
        return tree

    def _waited(self, seconds: float):
        with self._wait_lock:
            self.total_wait += seconds
        if self._obs_c is not None:
            self._obs_c[4].add(seconds)

    # -- public API ---------------------------------------------------------
    def send(self, src: str, dst: str, tree, *, n_examples: Optional[int] = None):
        """Move a payload across the link; returns the delivered tree."""
        return self.send_async(src, dst, tree, n_examples=n_examples).result()

    def send_async(self, src: str, dst: str, tree, *, n_examples: Optional[int] = None) -> SendHandle:
        """Start a hop and return its ``SendHandle``.  The hop is metered
        here, at send time, so the hop list (order, bytes, examples,
        latency) does not depend on when the handle is drained."""
        delivered = self._deliver(tree)
        self._meter(src, dst, tree, n_examples)
        return SendHandle.resolved(self, delivered)

    def _meter(self, src, dst, tree, n_examples) -> Hop:
        b = tree_bytes(tree)
        n = int(n_examples) if n_examples is not None else 0
        hop = Hop(src, dst, n, b, self._latency(b))
        self.hops.append(hop)
        if self._obs_c is not None:
            c_hops, c_bytes, c_examples, c_latency, _ = self._obs_c
            c_hops.add(1)
            c_bytes.add(b)
            c_examples.add(n)
            c_latency.add(hop.latency)
        return hop

    # -- stats ---------------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        return sum(h.payload_bytes for h in self.hops)

    @property
    def total_latency(self) -> float:
        """Sum of per-hop link seconds: what the hops cost a loop that
        blocks on every send.  An overlapped loop pays ``total_wait`` of it."""
        return sum(h.latency for h in self.hops)

    @property
    def total_examples(self) -> int:
        return sum(h.n_examples for h in self.hops)

    def stats(self) -> dict:
        return {
            "hops": len(self.hops),
            "bytes": self.total_bytes,
            "examples": self.total_examples,
            "latency": self.total_latency,
            "wait": self.total_wait,
        }


class LoopbackTransport(Transport):
    """Same-host hand-off: no delay, the payload stays where it is.  Single
    host placements still meter what would cross a real boundary."""


class DevicePutTransport(Transport):
    """Device -> device hand-off inside one process: every leaf is moved
    with ``.to`` the bound device.  Bytes are metered like any hop; latency
    stays zero."""

    def _deliver(self, tree):
        return _to_device(tree, self._landing())


class SimulatedLinkTransport(Transport):
    """A constrained link (edge -> cloud): per-hop latency = delay +
    bytes / bandwidth.  ``delay`` is seconds or a key of ``EDGE_DELAYS``;
    ``bandwidth`` bytes/s (None: delay only, the §5.2.1 model).  The
    latency is a simulated clock: ``send`` returns at once."""

    def __init__(self, delay="medium", bandwidth: Optional[float] = None):
        super().__init__()
        self.delay = EDGE_DELAYS[delay] if isinstance(delay, str) else float(delay)
        self.bandwidth = bandwidth

    def _latency(self, payload_bytes: int) -> float:
        lat = self.delay
        if self.bandwidth:
            lat += payload_bytes / self.bandwidth
        return lat

    def _deliver(self, tree):
        # the boundary is real: the bytes leave the source for the host and
        # are fed to the destination device
        return _to_device(_snapshot(tree), self._landing())


class AsyncTransport(SimulatedLinkTransport):
    """The simulated link's physics with real latency: ``send_async`` meters
    the hop, snapshots the payload to the host on the caller's thread, and
    returns a ``SendHandle`` that resolves once a worker thread has slept
    the hop's wall time; the handle's finalize feeds the payload to the
    bound device on the draining thread.

    ``overlap=False`` sleeps inline and returns a resolved handle: the
    stop-the-world serial baseline.  Both modes meter identical hops and
    deliver identical payloads.  The inline sleep is charged to the
    handle's ``wait_time`` and to ``total_wait``, so a serial link hides
    nothing (the JAX package's serial handle reports no wait).

    Link capacity is a token bucket: a hop's transmission time (bytes /
    bandwidth) reserves the wire, so concurrent sends serialise on it while
    the propagation delay overlaps.  Metering stays the uncontended delay +
    bytes / bandwidth; contention shows only in the wall clock and in
    ``total_wait``.  Delivery timing moves only when a deferred request is
    admitted, never its tokens.

    Workers come from one lazily created module-level pool of at most
    ``_MAX_WORKERS`` threads shared by every AsyncTransport;
    ``shutdown_async_workers()`` tears it down."""

    _MAX_WORKERS = 8  # in-flight hops beyond this queue behind the pool

    def __init__(self, delay="medium", bandwidth: Optional[float] = None, *, overlap: bool = True):
        super().__init__(delay=delay, bandwidth=bandwidth)
        self.overlap = overlap
        # token bucket: _busy_until is the monotonic time the wire finishes
        # its last reserved transmission
        self._bucket_lock = threading.Lock()
        self._busy_until = 0.0

    def _reserve_tx(self, payload_bytes: int) -> float:
        """Reserve this hop's transmission on the wire; returns its seconds
        end to end from now (queueing + bytes / bandwidth + delay).  A
        serial sender never queues: that is ``_latency(payload_bytes)``."""
        tx = payload_bytes / self.bandwidth if self.bandwidth else 0.0
        with self._bucket_lock:
            now = time.monotonic()
            start = max(now, self._busy_until)
            self._busy_until = start + tx
        return (start - now) + tx + self.delay

    def _executor(self) -> ThreadPoolExecutor:
        global _WORKER_POOL
        with _POOL_LOCK:
            if _WORKER_POOL is None:
                _WORKER_POOL = ThreadPoolExecutor(max_workers=self._MAX_WORKERS, thread_name_prefix="async-transport")
            return _WORKER_POOL

    def _refeed(self, host_tree):
        return _to_device(host_tree, self._landing())

    @staticmethod
    def _sleep_link(host_tree, latency: float):
        time.sleep(latency)
        return host_tree

    def send_async(self, src: str, dst: str, tree, *, n_examples: Optional[int] = None) -> SendHandle:
        """Start a wall-clock hop; the handle resolves once the link's
        latency (and any queueing on the wire) has elapsed."""
        self._landing()
        hop = self._meter(src, dst, tree, n_examples)
        wall = self._reserve_tx(hop.payload_bytes)
        host = _snapshot(tree)
        if not self.overlap:
            t0 = self._clock()
            time.sleep(wall)
            handle = SendHandle.resolved(self, self._refeed(host))
            handle.wait_time = self._clock() - t0
            self._waited(handle.wait_time)
            return handle
        fut = self._executor().submit(self._sleep_link, host, wall)
        return SendHandle(self, future=fut, finalize=self._refeed)


# the shared AsyncTransport worker pool
_WORKER_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def shutdown_async_workers():
    """Tear down the shared worker pool (idempotent): waits for the hops in
    flight; resolved handles stay resolvable; the next ``send_async`` makes
    a new pool."""
    global _WORKER_POOL
    with _POOL_LOCK:
        pool, _WORKER_POOL = _WORKER_POOL, None
    if pool is not None:
        pool.shutdown(wait=True)

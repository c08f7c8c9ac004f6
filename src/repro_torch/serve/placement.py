"""Tier placement (port of ``repro.serve.placement``): which host serves
each cascade tier.

The paper's deployment scenarios are placement statements: tier 1 on the
edge device and tier 2 in the cloud (§5.2.1), tiers on different GPUs
(§5.2.2), tiers behind different API endpoints (§5.2.3).  A
``TierPlacement`` gives each tier a ``Host`` (a name, a kind and a torch
device, or ``device=None`` for a simulated host, which serves on the
server's device) and each tier boundary the ``Transport`` its deferrals
cross — ``None`` when both tiers share a host.  A link lands payloads on
the device of the tier it feeds; ``CascadeServer`` binds it there
(``Transport.bind``), so a placement names no device of its own except a
pod's.

``pod_placement`` puts tier i on ``devices[i]`` with a ``DevicePutTransport``
at each boundary.  On one device (one card, or the CPU) the hosts coincide:
the routing and the metering run as they would across devices, but a
placement over disjoint devices is only exercised on a machine with more
than one.  ``edge_cloud`` picks the edge -> cloud link's physics: the
simulated-clock link, or the real-sleep ``AsyncTransport`` overlapped or
serial.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map
from repro_torch.serve.transport import (
    AsyncTransport,
    DevicePutTransport,
    LoopbackTransport,
    SimulatedLinkTransport,
    Transport,
)


@dataclasses.dataclass(frozen=True)
class Host:
    """One placement target: a named device (``None`` for a simulated host,
    which serves on the server's device — routing and metering behave the
    same)."""

    name: str
    kind: str = "local"  # 'local' | 'edge' | 'cloud' | 'pod'
    device: Optional[torch.device] = None

    def devices(self) -> set:
        """This host's device set (empty for a simulated host)."""
        return {self.device} if self.device is not None else set()


@dataclasses.dataclass(frozen=True)
class TierPlacement:
    """hosts[i] serves tier i; links[i] is the transport tier i's deferrals
    take to tier i+1 (None: same host, in process)."""

    hosts: Tuple[Host, ...]
    links: Tuple[Optional[Transport], ...]

    def __post_init__(self):
        assert len(self.links) == max(0, len(self.hosts) - 1), (
            f"{len(self.hosts)} hosts need {len(self.hosts) - 1} links, got {len(self.links)}"
        )

    @property
    def n_tiers(self) -> int:
        return len(self.hosts)

    def link(self, i: int) -> Optional[Transport]:
        """The transport tier i's deferrals cross to reach tier i+1."""
        return self.links[i]

    def describe(self) -> str:
        """The tier chain, e.g. ``edge0(edge) -> cloud0(cloud)``."""
        return " -> ".join(f"{h.name}({h.kind})" for h in self.hosts)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def single_host(n_tiers: int) -> TierPlacement:
    """Every tier on one simulated host.  The hops still go through a
    shared ``LoopbackTransport``, so what would cross a real boundary is
    metered without paying for it."""
    host = Host("local0", "local")
    link = LoopbackTransport()
    return TierPlacement(hosts=(host,) * n_tiers, links=(link,) * max(0, n_tiers - 1))


def edge_cloud(*, delay="medium", link: str = "sim") -> TierPlacement:
    """§5.2.1: tier 1 on the edge, tier 2 in the cloud (both simulated
    hosts).  ``delay`` is seconds or a key of ``EDGE_DELAYS``; ``link``
    picks the edge -> cloud physics (all three meter identical hops):

    ``'sim'``     ``SimulatedLinkTransport``: latency on a simulated clock;
    ``'async'``   ``AsyncTransport``: latency slept by a worker thread, and
                  ``serve_continuous`` decodes on while a hop is in flight;
    ``'serial'``  ``AsyncTransport(overlap=False)``: the same sleeps, each
                  blocking the sender: the baseline of the overlap ratio."""
    if link == "sim":
        uplink = SimulatedLinkTransport(delay=delay)
    elif link in ("async", "serial"):
        uplink = AsyncTransport(delay=delay, overlap=(link == "async"))
    else:
        raise ValueError(f"unknown link kind: {link!r}")
    return TierPlacement(hosts=(Host("edge0", "edge"), Host("cloud0", "cloud")), links=(uplink,))


def pod_placement(devices: Sequence) -> TierPlacement:
    """Tier i on ``devices[i]`` (one device a tier, resolved by
    ``resolve_device``); every boundary is a metered ``DevicePutTransport``
    hop bound to the next tier's device."""
    devs = [resolve_device(d) for d in devices]
    hosts = tuple(Host(f"pod{i}", "pod", device=d) for i, d in enumerate(devs))
    links = tuple(DevicePutTransport().bind(devs[i + 1]) for i in range(len(devs) - 1))
    return TierPlacement(hosts=hosts, links=links)


# ---------------------------------------------------------------------------
# weight placement
# ---------------------------------------------------------------------------


def place_tier_values(values, host: Host):
    """A tier's stacked ensemble values on its host's device (``.to``; the
    same tensors when they are there already).  No-op for a simulated host."""
    if host.device is None:
        return values
    return tree_map(lambda t: t.to(host.device), values)


def hosts_disjoint(placement: TierPlacement) -> bool:
    """True when every pair of distinct hosts owns disjoint device sets."""
    seen = []
    for h in placement.hosts:
        devs = h.devices()
        if not devs:
            continue
        for prev_name, prev in seen:
            if prev_name != h.name and prev & devs:
                return False
        seen.append((h.name, devs))
    return True

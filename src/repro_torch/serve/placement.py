"""Tier placement (port of ``repro.serve.placement``): which host serves
each cascade tier.

The paper's deployment scenarios are placement statements: tier 1 on the
edge device and tier 2 in the cloud (§5.2.1), tiers on different GPUs
(§5.2.2), tiers behind different API endpoints (§5.2.3).  A
``TierPlacement`` gives each tier a ``Host`` and each tier boundary the
``Transport`` its deferrals cross — ``None`` when both tiers share a host.

A host is simulated (it serves on the server's device) or a pod slice: a
``DeviceMesh`` of ranks carved from the 'pod' axis of a ('pod', 'data',
'model') mesh (DESIGN.md §3).  ``pod_placement`` puts tier
i on slice i: the server runs on every rank of the world (SPMD), tier i's
stacked ensemble values live on slice i as ``DTensor``s ('ensemble' on the
slice's 'pod' axis through the logical rule table, ``place_tier_values``),
and each boundary is a hop from slice i's first rank onto slice i+1 — by
default a ``ShardedDevicePutTransport``, which lands the payload's example
axis sharded over the next slice's ('pod', 'data') axes (DESIGN.md §8).
A link lands payloads on the device of the tier it feeds; ``CascadeServer``
binds it there (``Transport.bind``).  ``edge_cloud`` picks the edge ->
cloud link's physics: the simulated-clock link, or the real-sleep
``AsyncTransport`` overlapped or serial.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist

from repro_torch.device import rank_device
from repro_torch.launch.mesh import pod_submeshes
from repro_torch.models.params import tree_map
from repro_torch.serve.transport import (
    AsyncTransport,
    DevicePutTransport,
    LoopbackTransport,
    ShardedDevicePutTransport,
    SimulatedLinkTransport,
    Transport,
)
from repro_torch.sharding import collectives
from repro_torch.sharding.logical import logical_sharding, make_rules
from repro_torch.sharding.mesh import mesh_ranks


@dataclasses.dataclass(frozen=True)
class Host:
    """One placement target: a ``mesh`` of ranks (a pod slice), or None for
    a simulated host, which serves on the server's device — routing and
    metering behave the same."""

    name: str
    kind: str = "local"  # 'local' | 'edge' | 'cloud' | 'pod'
    mesh: object = None  # a torch.distributed DeviceMesh

    def devices(self) -> set:
        """This host's device set: the global ranks of its mesh (empty for a
        simulated host)."""
        return set(mesh_ranks(self.mesh)) if self.mesh is not None else set()


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


def pod_placement(mesh, n_tiers: int, *, shard_examples: bool = True) -> TierPlacement:
    """Carve the 'pod' axis of a ('pod', 'data', 'model') ``DeviceMesh`` into
    one slice a tier (``launch.mesh.pod_submeshes``; every rank calls it):
    tier i's ensemble lives on slice i (disjoint rank sets), and every
    boundary is a metered hop from slice i's first rank onto slice i+1.

    With ``shard_examples=True`` (the default, DESIGN.md §8) each hop is a
    ``ShardedDevicePutTransport``: the payload's example axis lands sharded
    over the next slice's ('pod', 'data') axes, so each rank holds
    ``1/shard_count`` of it.  ``shard_examples=False`` replicates the
    payload on every rank of the slice (``DevicePutTransport``): the parity
    baseline, with the same results and the same metered bytes."""
    subs = pod_submeshes(mesh, n_tiers)
    hosts = tuple(Host(f"pod{i}", "pod", mesh=sub) for i, sub in enumerate(subs))
    link = ShardedDevicePutTransport if shard_examples else DevicePutTransport
    links = tuple(link(subs[i + 1], src_mesh=subs[i]) for i in range(n_tiers - 1))
    return TierPlacement(hosts=hosts, links=links)


# ---------------------------------------------------------------------------
# weight placement
# ---------------------------------------------------------------------------


def place_tier_values(values, host: Host, *, kind: str = "decode"):
    """A tier's stacked ensemble values on its host's slice: each leaf a
    ``DTensor`` on the slice, the leading
    'ensemble' axis on the slice's 'pod' axis through the logical rule
    table (pod=True; a member count 'pod' does not divide is replicated),
    every other axis replicated.  A rank of the slice keeps its members
    (a copy, so the whole tree can be freed); a rank outside it holds no
    weight of the tier, and may pass meta tensors.  No communication: each
    rank of the slice passes the same values.  No-op for a simulated host."""
    if host.mesh is None:
        return values
    mesh, rules = host.mesh, make_rules(kind, pod=True)
    here = mesh.get_coordinate() is not None

    def put(leaf):
        axes = ("ensemble",) + (None,) * (leaf.ndim - 1)
        placements = logical_sharding(mesh, tuple(leaf.shape), axes, rules).placements(leaf.ndim)
        local = None
        if here:
            if leaf.is_meta:
                raise ValueError(f"rank {dist.get_rank()} serves {host.name}: it needs the tier's values, not meta")
            if leaf.device.type != mesh.device_type:
                leaf = leaf.to(rank_device(mesh.device_type))
            local = collectives.local_block(leaf, mesh, placements)
            if local.shape[0] != leaf.shape[0]:
                local = local.clone()
        return collectives.as_dtensor(local, mesh, placements, tuple(leaf.shape), leaf.dtype)

    return tree_map(put, values)


def hosts_disjoint(placement: TierPlacement) -> bool:
    """True when every pair of distinct hosts owns disjoint rank sets."""
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

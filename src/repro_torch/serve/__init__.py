from repro_torch.serve.batching import Request, RequestQueue
from repro_torch.serve.cascade_server import CascadeServer, CascadeTier, OpenLoopReport
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.controller import ControllerConfig, GreedyController
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.paging import PagePool
from repro_torch.serve.placement import (
    Host,
    TierPlacement,
    edge_cloud,
    hosts_disjoint,
    place_tier_values,
    pod_placement,
    single_host,
)
from repro_torch.serve.slot_stream import EngineBackend, SlotStream, TierBackend
from repro_torch.serve.transport import (
    AsyncTransport,
    DevicePutTransport,
    Hop,
    LoopbackTransport,
    SendHandle,
    SimulatedLinkTransport,
    Transport,
    shutdown_async_workers,
    tree_bytes,
)
from repro_torch.serve.workload import ArrivalSpec, VirtualClock, Workload, bursty, diurnal, poisson

__all__ = [
    "ArrivalSpec",
    "AsyncTransport",
    "CascadeServer",
    "CascadeTier",
    "ControllerConfig",
    "DevicePutTransport",
    "EngineBackend",
    "GreedyController",
    "Hop",
    "Host",
    "LoopbackTransport",
    "OpenLoopReport",
    "PagePool",
    "Request",
    "RequestQueue",
    "SendHandle",
    "ServeConfig",
    "ServingEngine",
    "SimulatedLinkTransport",
    "SlotStream",
    "TierBackend",
    "TierPlacement",
    "Transport",
    "VirtualClock",
    "Workload",
    "bursty",
    "diurnal",
    "edge_cloud",
    "hosts_disjoint",
    "place_tier_values",
    "pod_placement",
    "poisson",
    "shutdown_async_workers",
    "single_host",
    "tree_bytes",
]

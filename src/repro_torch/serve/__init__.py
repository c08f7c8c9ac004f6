from repro_torch.serve.batching import Request, RequestQueue
from repro_torch.serve.cascade_server import CascadeServer, CascadeTier, OpenLoopReport
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.controller import ControllerConfig, GreedyController
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.paging import PagePool
from repro_torch.serve.slot_stream import EngineBackend, SlotStream, TierBackend
from repro_torch.serve.workload import ArrivalSpec, VirtualClock, Workload, bursty, diurnal, poisson

__all__ = [
    "ArrivalSpec",
    "CascadeServer",
    "CascadeTier",
    "ControllerConfig",
    "EngineBackend",
    "GreedyController",
    "OpenLoopReport",
    "PagePool",
    "Request",
    "RequestQueue",
    "ServeConfig",
    "ServingEngine",
    "SlotStream",
    "TierBackend",
    "VirtualClock",
    "Workload",
    "bursty",
    "diurnal",
    "poisson",
]

from repro_torch.serve.batching import Request, RequestQueue
from repro_torch.serve.cascade_server import CascadeServer, CascadeTier
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.paging import PagePool
from repro_torch.serve.slot_stream import EngineBackend, SlotStream, TierBackend

__all__ = [
    "CascadeServer",
    "CascadeTier",
    "EngineBackend",
    "PagePool",
    "Request",
    "RequestQueue",
    "ServeConfig",
    "ServingEngine",
    "SlotStream",
    "TierBackend",
]

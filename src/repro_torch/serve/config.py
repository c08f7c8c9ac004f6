"""ServeConfig: the serving knobs every continuous-batching entry point
takes (port of ``repro.serve.config``).

``ServingEngine.serve_continuous``, ``ServingEngine.slot_stream``,
``SlotStream`` and ``CascadeServer.serve_continuous`` each take one
``ServeConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs import Observability


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Tuning knobs shared by every serving entry point.

    ``max_seq=None`` keeps each entry point's default (the engine's own
    ``max_seq``; 256 for the cascade).  ``paged=None`` selects block-paged
    KV pools wherever the family supports them (``paged=False`` keeps the
    dense slot cache as the parity oracle); ``n_pages=None`` sizes pools at
    dense-equivalent capacity plus the overflow sink.  ``seed`` feeds the
    per-tier sampling keys (tier i's slot keys derive from ``seed + i``;
    the single engine holds its own generator).  ``obs=None`` gives each
    component a private telemetry bundle.  ``speculative``
    (cascade-as-drafter) is not ported yet and raises."""

    n_slots: int = 8
    max_seq: Optional[int] = None
    seed: int = 0
    chunked_prefill: bool = True
    max_chunk: int = 256
    paged: Optional[bool] = None
    page_size: int = 16
    n_pages: Optional[int] = None
    obs: Optional[Observability] = None
    speculative: bool = False

    def __post_init__(self):
        if self.speculative:
            raise NotImplementedError("speculative decoding (speculative=True) is not ported yet")

    def with_max_seq_default(self, default: int) -> "ServeConfig":
        """This config with ``max_seq=None`` resolved to the caller's
        default."""
        if self.max_seq is not None:
            return self
        return dataclasses.replace(self, max_seq=int(default))

    def resolved_obs(self) -> Observability:
        """The configured telemetry bundle, or a fresh private one."""
        return self.obs if self.obs is not None else Observability.private()

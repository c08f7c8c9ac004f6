"""Serving telemetry (a copy of ``repro.obs``): metrics registry, tracing
and the ``Observability`` bundle the serving layer passes around.

Recording takes only host-resident scalars (device values cross through
the metered ``core.cascade.host_fetch`` first), timestamps come from the
bundle's injectable clock, and a disabled tracer costs one ``enabled``
check per site.  The package imports only the standard library.
"""
from __future__ import annotations

from repro_torch.obs.registry import (
    TIME_BUCKETS_S,
    UNIT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Scope,
    StatsView,
    global_registry,
)
from repro_torch.obs.trace import REQUEST_PID, NullTracer, Tracer, perf_clock, validate_trace


class Observability:
    """The telemetry bundle: registry + tracer + clock.

    Components that are not handed one create a private bundle (own
    registry, disabled tracer); pass one bundle down a serving stack to get
    one registry namespace and one per-request trace across tiers and
    pools."""

    __slots__ = ("registry", "tracer", "clock")

    def __init__(self, registry=None, tracer=None, clock=None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NullTracer()
        self.clock = clock if clock is not None else perf_clock

    @classmethod
    def private(cls) -> "Observability":
        """A self-contained bundle (fresh registry, disabled tracer)."""
        return cls()

    def scope(self, prefix: str) -> Scope:
        """A name-prefix handle over this bundle's registry."""
        return Scope(self.registry, prefix)


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullTracer",
    "Observability",
    "REQUEST_PID",
    "Scope",
    "StatsView",
    "TIME_BUCKETS_S",
    "Tracer",
    "UNIT_BUCKETS",
    "global_registry",
    "perf_clock",
    "validate_trace",
]

"""Counters and the process-wide metrics registry (the part of
``repro.obs.registry`` the ported serving path records into).

Metrics are get-or-created by dotted name (``host_fetch.calls``,
``kernels.agreement.launches``) and accept only host-resident Python
numbers: recording never synchronises with the device.
"""
from __future__ import annotations

from typing import Dict


class Counter:
    """Monotone accumulator (int or float — whatever callers add)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, v=1) -> None:
        self.value += v

    def reset(self) -> None:
        self.value = 0

    def __repr__(self):
        return f"Counter({self.name}={self.value})"


class MetricsRegistry:
    """Get-or-create store of named counters."""

    def __init__(self):
        self._metrics: Dict[str, Counter] = {}

    def counter(self, name: str) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name)
        return m

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()


_GLOBAL_REGISTRY = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-wide registry (host-fetch meters, kernel launch counts)."""
    return _GLOBAL_REGISTRY

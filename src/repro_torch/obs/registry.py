"""Metrics registry: counters, gauges, fixed-bucket histograms (a copy of
``repro.obs.registry``).

Metrics are get-or-created by dotted name (``host_fetch.calls``,
``kernels.agreement.launches``, ``slot_stream.tier0.admitted``) and accept
only host-resident Python numbers: recording never synchronises with the
device.  ``StatsView`` is the read-only dict facade the serving components
expose as ``.stats`` (``SlotStream.stats``, ``PagePool.stats``), computed
from registry metrics on access.
"""
from __future__ import annotations

import bisect
import math
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence


def _geometric_buckets(lo: float, hi: float, per_decade: int = 5) -> List[float]:
    """Geometric bucket upper bounds spanning [lo, hi]."""
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    return [lo * 10 ** (i / per_decade) for i in range(n)]


#: default histogram buckets: seconds, 1 us .. 100 s, 5 per decade
TIME_BUCKETS_S = tuple(_geometric_buckets(1e-6, 100.0))

#: unit-interval buckets (agreement margins, rates)
UNIT_BUCKETS = tuple(i / 20 for i in range(1, 21))


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


class Gauge:
    """Point-in-time level with a high-water mark (``peak``)."""

    __slots__ = ("name", "value", "peak")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.peak = 0

    def set(self, v) -> None:
        self.value = v
        if v > self.peak:
            self.peak = v

    def reset(self) -> None:
        self.value = 0
        self.peak = 0

    def __repr__(self):
        return f"Gauge({self.name}={self.value}, peak={self.peak})"


class Histogram:
    """Fixed-bucket histogram with an exact sum.

    ``buckets`` are upper bounds (sorted); one overflow bucket catches the
    tail.  ``percentile`` interpolates linearly inside the winning bucket."""

    __slots__ = ("name", "buckets", "counts", "sum", "count", "_min", "_max")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.buckets = tuple(buckets) if buckets is not None else TIME_BUCKETS_S
        self.counts = [0] * (len(self.buckets) + 1)  # + overflow
        self.sum = 0.0
        self.count = 0
        self._min = math.inf
        self._max = -math.inf

    def record(self, v: float) -> None:
        self.sum += v
        self.count += 1
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        self.counts[bisect.bisect_left(self.buckets, v)] += 1

    def reset(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self._min = math.inf
        self._max = -math.inf

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]) by linear interpolation
        within the winning bucket; exact at the recorded min/max ends."""
        assert 0.0 <= q <= 1.0, q
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else min(self._min, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else self._max
                lo = max(lo, self._min)
                hi = min(hi, self._max)
                if hi <= lo:
                    return lo
                # the JAX package's order of operations, bit for bit
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self._max

    def __repr__(self):
        return f"Histogram({self.name}: n={self.count}, sum={self.sum:.6g})"


class MetricsRegistry:
    """Get-or-create store of named metrics; asking for an existing name
    with a different metric kind raises (one name, one meaning)."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args)
        elif type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
        if name in self._metrics:
            return self._get(name, Histogram)
        return self._get(name, Histogram, buckets)

    def get(self, name: str):
        """The metric registered under ``name``, or None."""
        return self._metrics.get(name)

    def value(self, name: str):
        """Scalar reading of a metric: counter/gauge value, histogram sum."""
        m = self._metrics[name]
        return m.sum if isinstance(m, Histogram) else m.value

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()


class StatsView(Mapping):
    """Read-only stats-dict facade: each key maps to a zero-argument reader
    over registry metrics, evaluated on access; ``dict(view)`` gives a
    plain dict."""

    __slots__ = ("_readers",)

    def __init__(self, readers: Dict[str, Callable[[], object]]):
        self._readers = dict(readers)

    def __getitem__(self, key: str):
        return self._readers[key]()

    def __iter__(self) -> Iterator[str]:
        return iter(self._readers)

    def __len__(self) -> int:
        return len(self._readers)

    def __repr__(self):
        return repr({k: r() for k, r in self._readers.items()})


class Scope:
    """A name-prefix handle over one registry: ``scope.counter("admitted")``
    registers ``<prefix>.admitted``.  Resolve metrics once at construction;
    record on the resolved objects per event."""

    __slots__ = ("registry", "prefix")

    def __init__(self, registry: MetricsRegistry, prefix: str):
        self.registry = registry
        self.prefix = prefix

    def name(self, suffix: str) -> str:
        return f"{self.prefix}.{suffix}"

    def counter(self, suffix: str) -> Counter:
        return self.registry.counter(self.name(suffix))

    def gauge(self, suffix: str) -> Gauge:
        return self.registry.gauge(self.name(suffix))

    def histogram(self, suffix: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self.registry.histogram(self.name(suffix), buckets)


_GLOBAL_REGISTRY = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The process-wide registry (host-fetch meters, kernel launch counts)."""
    return _GLOBAL_REGISTRY

"""Open-loop workloads: seeded arrival traces (a copy of
``repro.serve.workload``).

Everything measured before this module was closed-loop: ``serve_continuous``
takes the whole request list up front, so the system never sees *offered
load* — exactly the regime where CascadeServe (PAPERS.md) shows cascade
gains evaporate, because deferral thresholds and tier capacities tuned for
one QPS are frozen while the arrival rate swings.  A ``Workload`` is the
open-loop counterpart: a replayable trace of ``(arrival_time_s, Request)``
pairs that ``CascadeServer.serve_open_loop`` admits by arrival time.

Determinism contract: every
generator is a pure function of its seed — arrival times, prompt tokens,
prompt lengths and output budgets all come from one
``np.random.default_rng(seed)`` stream, so the same seed replays the same
trace bit-for-bit.  Iterating a ``Workload`` materializes FRESH ``Request``
objects each pass (requests are mutated by serving), which is what makes
controller-on vs static A/B runs over *identical* traffic possible.

Time is injectable: ``VirtualClock`` is the deterministic ``obs.clock``
``serve_open_loop`` advances explicitly (per decode sweep and across idle
gaps), so an entire open-loop serve — arrivals, admissions, controller
ticks, SLO verdicts — replays bit-for-bit with no wall-clock dependence.
With the default real clock the same loop measures wall time instead.

Three arrival shapes (all with mixed prompt/output-length distributions):

``poisson``   stationary rate — exponential interarrivals.
``bursty``    Markov-modulated on/off (two-state MMPP): exponential dwell
              times in an ``on`` state (rate_hi) and an ``off`` state
              (rate_lo); the overload-recovery shape the controller bench
              drives.
``diurnal``   inhomogeneous Poisson via thinning against a raised-cosine
              rate curve between ``base_qps`` and ``peak_qps`` — a day's
              traffic compressed to ``period_s``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.serve.batching import Request


class VirtualClock:
    """Deterministic injectable clock (``Observability(clock=...)``).

    Reading never advances it; ``serve_open_loop`` advances it explicitly
    (``advance``) by the simulated service time per decode sweep and across
    idle gaps to the next arrival.  Two runs that make the same sequence of
    decisions therefore see the same timestamps — the replay half of the
    determinism contract."""

    __slots__ = ("now_s",)

    def __init__(self, start_s: float = 0.0):
        self.now_s = float(start_s)

    def __call__(self) -> float:
        return self.now_s

    def advance(self, dt_s: float) -> None:
        assert dt_s >= 0.0, f"clock cannot run backwards (dt={dt_s})"
        self.now_s += float(dt_s)


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One immutable trace entry; ``materialize`` builds the fresh mutable
    ``Request`` each replay serves."""

    t_s: float
    tokens: np.ndarray  # (S,) int32 prompt (never mutated)
    max_new_tokens: int

    def materialize(self) -> Request:
        return Request(
            tokens=np.array(self.tokens, np.int32, copy=True),
            max_new_tokens=int(self.max_new_tokens),
        )


class Workload:
    """A replayable open-loop arrival trace.

    Iteration yields ``(arrival_time_s, Request)`` in arrival order, with a
    FRESH ``Request`` per pass — serving mutates requests, so one
    ``Workload`` can drive any number of identical A/B runs."""

    def __init__(self, specs: Sequence[ArrivalSpec], *, name: str = "workload"):
        self.specs: List[ArrivalSpec] = sorted(specs, key=lambda s: s.t_s)
        self.name = name

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self) -> Iterator[Tuple[float, Request]]:
        for s in self.specs:
            yield s.t_s, s.materialize()

    @property
    def arrival_times(self) -> np.ndarray:
        """(N,) float64 arrival times — the stats tests' raw material."""
        return np.asarray([s.t_s for s in self.specs], np.float64)

    @property
    def duration_s(self) -> float:
        return float(self.specs[-1].t_s) if self.specs else 0.0

    @property
    def offered_qps(self) -> float:
        """Mean offered rate over the trace span."""
        d = self.duration_s
        return len(self.specs) / d if d > 0 else float("inf")

    def __repr__(self):
        return (
            f"Workload({self.name}: n={len(self)}, "
            f"span={self.duration_s:.3g}s, {self.offered_qps:.3g} q/s)"
        )


def _specs_from_times(
    times: Sequence[float],
    rng: np.random.Generator,
    prompt_len: Tuple[int, int],
    max_new_tokens: Tuple[int, int],
    vocab: int,
) -> List[ArrivalSpec]:
    """Attach the mixed prompt/output-length distribution to a time list.
    Lengths and tokens draw from the SAME seeded stream as the times'
    generator, so one seed pins the whole trace."""
    p_lo, p_hi = prompt_len
    m_lo, m_hi = max_new_tokens
    assert 1 <= p_lo <= p_hi and 1 <= m_lo <= m_hi, (prompt_len, max_new_tokens)
    specs = []
    for t in times:
        L = int(rng.integers(p_lo, p_hi + 1))
        specs.append(
            ArrivalSpec(
                t_s=float(t),
                tokens=rng.integers(0, vocab, L).astype(np.int32),
                max_new_tokens=int(rng.integers(m_lo, m_hi + 1)),
            )
        )
    return specs


def poisson(
    rate_qps: float,
    n_requests: int,
    *,
    seed: int,
    prompt_len: Tuple[int, int] = (8, 32),
    max_new_tokens: Tuple[int, int] = (2, 8),
    vocab: int = 256,
) -> Workload:
    """Stationary Poisson arrivals: interarrivals ~ Exp(rate)."""
    assert rate_qps > 0 and n_requests >= 1
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate_qps, n_requests))
    return Workload(
        _specs_from_times(times, rng, prompt_len, max_new_tokens, vocab),
        name=f"poisson@{rate_qps:g}qps",
    )


def bursty(
    rate_lo_qps: float,
    rate_hi_qps: float,
    n_requests: int,
    *,
    seed: int,
    mean_on_s: float = 1.0,
    mean_off_s: float = 1.0,
    prompt_len: Tuple[int, int] = (8, 32),
    max_new_tokens: Tuple[int, int] = (2, 8),
    vocab: int = 256,
) -> Workload:
    """Markov-modulated on/off arrivals (two-state MMPP).

    The process alternates between an ``on`` state emitting Poisson
    arrivals at ``rate_hi_qps`` and an ``off`` state at ``rate_lo_qps``;
    dwell times in each state are exponential with the given means.  The
    trace starts in ``off`` (so the serving system warms up before the
    first burst) and runs until ``n_requests`` have been emitted."""
    assert 0 < rate_lo_qps <= rate_hi_qps and n_requests >= 1
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t, on = 0.0, False
    while len(times) < n_requests:
        dwell = rng.exponential(mean_on_s if on else mean_off_s)
        rate = rate_hi_qps if on else rate_lo_qps
        # Poisson arrivals inside this dwell window
        tt = t + rng.exponential(1.0 / rate)
        while tt < t + dwell and len(times) < n_requests:
            times.append(tt)
            tt += rng.exponential(1.0 / rate)
        t += dwell
        on = not on
    return Workload(
        _specs_from_times(times, rng, prompt_len, max_new_tokens, vocab),
        name=f"bursty@{rate_lo_qps:g}-{rate_hi_qps:g}qps",
    )


def diurnal(
    base_qps: float,
    peak_qps: float,
    period_s: float,
    n_requests: int,
    *,
    seed: int,
    prompt_len: Tuple[int, int] = (8, 32),
    max_new_tokens: Tuple[int, int] = (2, 8),
    vocab: int = 256,
) -> Workload:
    """Inhomogeneous Poisson via thinning: the rate follows a raised
    cosine from ``base_qps`` (t=0, the trough) up to ``peak_qps`` at
    ``period_s/2`` and back — one compressed diurnal cycle per period."""
    assert 0 < base_qps <= peak_qps and period_s > 0 and n_requests >= 1
    rng = np.random.default_rng(seed)

    def rate(t: float) -> float:
        phase = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / period_s)
        return base_qps + (peak_qps - base_qps) * float(phase)

    times: List[float] = []
    t = 0.0
    while len(times) < n_requests:
        t += float(rng.exponential(1.0 / peak_qps))  # candidate at the peak rate
        if rng.random() * peak_qps <= rate(t):  # thin to the instantaneous rate
            times.append(t)
    return Workload(
        _specs_from_times(times, rng, prompt_len, max_new_tokens, vocab),
        name=f"diurnal@{base_qps:g}-{peak_qps:g}qps",
    )

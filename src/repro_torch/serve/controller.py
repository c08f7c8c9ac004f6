"""Greedy online admission controller for open-loop serving (a copy of
``repro.serve.controller``).

The controller closes the loop over the metrics registry: every signal it
reads is a streaming registry metric the serving path already records —
no new plumbing, no device traffic, no host syncs.  Each control interval
(``ControllerConfig.interval_s`` of VIRTUAL time — ``serve_open_loop``
ticks it, so control decisions replay bit-for-bit with the trace) it reads:

    slot_stream.tier{i}.queue_depth      ready-queue backlog (gauge)
    cascade.tier{i}.answered/deferred    per-tier exit counts (counters;
                                         the controller differences them
                                         into per-interval rates)
    cascade.tier{i}.agreement_margin     vote-share histogram
    serve.request_latency_s              request latency histogram (p50/p99)
    serve.open_loop.completed            completion count -> throughput EMA

and actuates at the admission point only (never at a slot mid-decode):

  * **deferral-threshold offsets** — ``run.theta_offset[i]`` shifts tier
    i's effective theta (``vote_frac <= clamp(theta + offset, 0, 1)``).
    Under backlog with a deferral-dominated exit mix, lowering theta keeps
    more answers at the cheap tier (vote fractions are quantized at k
    members, so one ``theta_step`` can retire a whole defer band); offsets
    recover toward 0 when the backlog clears.
  * **per-tier slot caps** — ``SlotStream.set_slot_limit`` shifts the slot
    budget toward the backlogged tier within the paged-pool budget;
    lowered limits drain naturally (admission-side actuation only).
  * **admission shedding** — ``should_shed`` estimates a new arrival's
    queue wait from the backlog and the completion-rate EMA; when the
    estimate exceeds ``slo_s * shed_margin`` ``serve_open_loop`` marks the request
    ``shed=True`` and returns it to the caller (never a silent drop).
    Shedding is disabled until the first completions exist — the
    controller never sheds blind at cold start.

Every actuation appends to ``controller.actions`` (a host-side audit log
the bench and tests read) and mirrors into ``controller.*`` registry
metrics.  Determinism: the module takes time as the
``now_s`` argument ``serve_open_loop`` passes from the virtual clock — there is no
wall-clock read and no RNG anywhere in the control path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Greedy-controller tuning knobs (all in virtual-time units).

    ``backlog_slots`` is the overload watermark in units of the tier's
    slot count (queue deeper than ``backlog_slots * n_slots`` = overload);
    ``shift_hysteresis`` is the queue-depth gap (in requests) that
    justifies moving one slot of admission budget between adjacent tiers;
    ``shed_margin`` scales the SLO before the estimated queue wait is
    declared hopeless (1.0 = shed exactly at the deadline estimate)."""

    interval_s: float = 0.25
    backlog_slots: float = 2.0
    theta_step: float = 0.35  # one step clears a whole vote band at k=3
    theta_min_offset: float = -1.0
    shift_hysteresis: int = 4
    shed_margin: float = 2.0
    rate_ema: float = 0.5  # weight of the newest completion-rate sample


class GreedyController:
    """Reads registry signals, actuates admission — see module docstring.

    Lifecycle: construct (optionally with a ``ControllerConfig``), pass to
    ``CascadeServer.serve_open_loop(..., controller=...)``, which
    calls ``bind`` once (resolving every metric handle against the run's
    registry), then ``should_shed()`` per arrival and ``tick(now_s)`` per
    control interval.  One controller drives one run — bind again (or
    build a fresh one) for the next."""

    def __init__(self, config: Optional[ControllerConfig] = None):
        self.config = config if config is not None else ControllerConfig()
        self.actions: List[dict] = []
        self.run = None

    # -- binding -----------------------------------------------------------
    def bind(self, run, *, slo_s: float) -> None:
        """Resolve metric handles once against the run's registry (the
        record-per-event / resolve-at-construction registry discipline)."""
        self.run = run
        self.slo_s = float(slo_s)
        self.actions = []
        reg = run.ob.registry
        n = len(run.streams)
        self._g_queue = [
            reg.gauge(f"slot_stream.tier{i}.queue_depth") for i in range(n)
        ]
        self._c_answered = [
            reg.counter(f"cascade.tier{i}.answered") for i in range(n)
        ]
        self._c_deferred = [
            reg.counter(f"cascade.tier{i}.deferred") for i in range(n)
        ]
        self._h_margin = [
            reg.histogram(f"cascade.tier{i}.agreement_margin")
            for i in range(n)
        ]
        self._h_lat = reg.histogram("serve.request_latency_s")
        self._c_completed = reg.counter("serve.open_loop.completed")
        sc = run.ob.scope("controller")
        self._c_ticks = sc.counter("ticks")
        self._c_shed_decisions = sc.counter("shed_decisions")
        self._g_theta = [sc.gauge(f"theta_offset.tier{i}") for i in range(n)]
        self._g_limit = [sc.gauge(f"slot_limit.tier{i}") for i in range(n)]
        for i, st in enumerate(run.streams):
            self._g_limit[i].set(st.slot_limit)
        # interval-differencing state (counters are cumulative)
        self._last_t: Optional[float] = None
        self._last_completed = self._c_completed.value
        self._last_answered = [c.value for c in self._c_answered]
        self._last_deferred = [c.value for c in self._c_deferred]
        self._rate: Optional[float] = None  # completions/s EMA

    def _record(
        self, now_s: float, action: str, tier: int, value, **extra
    ) -> None:
        self.actions.append(
            {"t_s": now_s, "action": action, "tier": tier, "value": value,
             **extra}
        )

    # -- per-arrival shed decision -----------------------------------------
    def should_shed(self) -> bool:
        """True when a new arrival's estimated queue wait already busts the
        SLO: backlog / completion-rate-EMA > slo_s * shed_margin.  The
        caller (``serve_open_loop``) marks and returns the request — the
        controller only decides."""
        if self._rate is None or self._rate <= 0.0:
            return False  # no throughput signal yet: never shed blind
        q0 = self._g_queue[0].value
        if q0 <= self.run.streams[0].n_slots:
            return False  # backlog fits the slot set: admission is cheap
        est_wait_s = q0 / self._rate
        if est_wait_s > self.slo_s * self.config.shed_margin:
            self._c_shed_decisions.add(1)
            return True
        return False

    # -- per-interval control step -----------------------------------------
    def tick(self, now_s: float) -> None:
        """One greedy control step at virtual time ``now_s``: refresh the
        throughput EMA, then actuate theta offsets and slot caps from this
        interval's signal deltas."""
        cfg = self.config
        run = self.run
        dt = (
            now_s - self._last_t
            if self._last_t is not None else cfg.interval_s
        )
        dt = max(dt, 1e-9)
        comp = self._c_completed.value
        sample = (comp - self._last_completed) / dt
        self._rate = (
            sample if self._rate is None
            else (1.0 - cfg.rate_ema) * self._rate + cfg.rate_ema * sample
        )
        self._last_completed = comp
        self._last_t = now_s
        n = len(run.streams)
        q = [g.value for g in self._g_queue]
        # the tail-latency overload signal: once observed p99 busts the
        # SLO, even a moderate backlog is already too deep
        hot = self._h_lat.count > 0 and self._h_lat.percentile(0.99) > self.slo_s
        # theta offsets: only tiers that CAN defer (the last tier always
        # answers) are actuated
        for i in range(n - 1):
            n_slots = run.streams[i].n_slots
            d_ans = self._c_answered[i].value - self._last_answered[i]
            d_dfr = self._c_deferred[i].value - self._last_deferred[i]
            self._last_answered[i] = self._c_answered[i].value
            self._last_deferred[i] = self._c_deferred[i].value
            overloaded = q[i] > cfg.backlog_slots * n_slots or (
                hot and q[i] > n_slots
            )
            off = run.theta_offset[i]
            if overloaded and d_dfr >= d_ans:
                # backlog and the interval's exit mix is deferral-dominated
                # (a zero-exit interval mid-burst counts: the backlog IS
                # the evidence): keep more answers at this tier by lowering
                # its effective theta
                new = max(cfg.theta_min_offset, off - cfg.theta_step)
            elif not overloaded and q[i] == 0 and off < 0.0:
                # backlog cleared: recover toward the configured theta
                new = min(0.0, off + cfg.theta_step)
            else:
                new = off
            if new != off:
                run.theta_offset[i] = new
                self._g_theta[i].set(new)
                # the tier's observed mean vote share rides along in the
                # audit log: it is the quality price of the offset (1.0 =
                # members were unanimous anyway, the offset is free)
                self._record(
                    now_s, "theta_offset", i, new,
                    mean_margin=self._h_margin[i].mean,
                )
        # slot budget: shift one slot of admission cap toward the
        # backlogged side of each tier boundary (total cap never grows —
        # the paged-pool budget is the ceiling)
        for i in range(n - 1):
            lo, hi = run.streams[i], run.streams[i + 1]
            if q[i] > q[i + 1] + cfg.shift_hysteresis and hi.slot_limit > 1:
                hi.set_slot_limit(hi.slot_limit - 1)
                lo.set_slot_limit(lo.slot_limit + 1)
            elif q[i + 1] > q[i] + cfg.shift_hysteresis and lo.slot_limit > 1:
                lo.set_slot_limit(lo.slot_limit - 1)
                hi.set_slot_limit(hi.slot_limit + 1)
            else:
                continue
            for j, st in ((i, lo), (i + 1, hi)):
                if self._g_limit[j].value != st.slot_limit:
                    self._g_limit[j].set(st.slot_limit)
                    self._record(now_s, "slot_limit", j, st.slot_limit)
        self._c_ticks.add(1)

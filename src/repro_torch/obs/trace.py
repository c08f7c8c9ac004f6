"""Per-request lifecycle tracing: Chrome/Perfetto trace-event JSON (a copy
of ``repro.obs.trace``).

One ``Tracer`` collects begin/end/instant events on per-request tracks
(pid = the ``requests`` process, tid = ``Request.rid``), timestamped in
microseconds from the tracer's construction through an injectable clock,
so tests drive traces with a fake clock and get deterministic timestamps.

Span vocabulary (what a request's track shows, in lifecycle order):

    queue_wait     B/E  submitted -> admitted
    admit          B/E  slot claim + prompt prefill; ``shared_tokens`` arg
      prefill_chunk B/E   one bucketed chunk dispatch (nested in admit)
      verify_draft  B/E   speculative draft scoring (nested in admit; args:
                          draft_tokens offered, accepted prefix length)
    decode         B/E  slot occupancy: admit -> completion
    defer_vote     i    the agreement vote (args: margin, defer, tier)
    forced_complete i   pool exhaustion cut the request short
    complete       i    terminal: the request exited the cascade

``export()`` returns the standard ``{"traceEvents": [...]}`` wrapping;
``validate_trace`` is the schema checker: required fields, per-track
monotone timestamps, strict B/E span nesting, and every track reaching a
terminal ``complete`` event.

``NullTracer`` is the disabled collector: ``enabled`` is False and every
record is a no-op — hot paths guard arg-dict construction behind
``if tracer.enabled`` so a disabled tracer costs one attribute check.
"""
from __future__ import annotations

import time
from typing import Dict, List

#: the default injectable clock — the function object, handed to components
#: so the serve layer holds a clock reference instead of calling
#: ``time.perf_counter()`` inline
perf_clock = time.perf_counter

#: the single process id for per-request tracks
REQUEST_PID = 1

_TERMINAL = ("complete", "forced_complete")


class NullTracer:
    """Disabled collector: every hook is a no-op, ``enabled`` gates the
    callers' arg construction."""

    enabled = False

    def begin(self, tid, name, **args):
        pass

    def end(self, tid, name, **args):
        pass

    def instant(self, tid, name, **args):
        pass

    def export(self) -> dict:
        return {"traceEvents": []}


class Tracer:
    """Collecting tracer.  All record methods take host scalars only: a
    device value must go through the metered ``core.cascade.host_fetch``
    before it may appear in ``args``."""

    enabled = True

    def __init__(self, clock=None, *, process_name: str = "requests"):
        self._clock = clock if clock is not None else perf_clock
        self._t0 = self._clock()
        self.events: List[dict] = [
            {
                "ph": "M",
                "pid": REQUEST_PID,
                "name": "process_name",
                "args": {"name": process_name},
            }
        ]
        self._named_tids: Dict[int, bool] = {}

    def _ts(self) -> float:
        """Microseconds since tracer construction (the trace epoch)."""
        return (self._clock() - self._t0) * 1e6

    def name_track(self, tid: int, name: str) -> None:
        """Label a request track (idempotent per tid)."""
        if tid not in self._named_tids:
            self._named_tids[tid] = True
            self.events.append(
                {
                    "ph": "M",
                    "pid": REQUEST_PID,
                    "tid": int(tid),
                    "name": "thread_name",
                    "args": {"name": name},
                }
            )

    def begin(self, tid, name, **args):
        self.name_track(int(tid), f"req {int(tid)}")
        self.events.append(
            {
                "ph": "B",
                "pid": REQUEST_PID,
                "tid": int(tid),
                "name": name,
                "cat": "serve",
                "ts": self._ts(),
                "args": args,
            }
        )

    def end(self, tid, name, **args):
        self.events.append(
            {
                "ph": "E",
                "pid": REQUEST_PID,
                "tid": int(tid),
                "name": name,
                "cat": "serve",
                "ts": self._ts(),
                "args": args,
            }
        )

    def instant(self, tid, name, **args):
        self.name_track(int(tid), f"req {int(tid)}")
        self.events.append(
            {
                "ph": "i",
                "pid": REQUEST_PID,
                "tid": int(tid),
                "name": name,
                "cat": "serve",
                "ts": self._ts(),
                "s": "t",
                "args": args,
            }
        )

    def export(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}


def validate_trace(trace: dict, *, require_terminal: bool = True) -> dict:
    """Schema-validate a Perfetto trace-event dump.

    Checks (raising ``AssertionError`` with the offending event):

    * the ``{"traceEvents": [...]}`` wrapping and per-event required fields
      (``ph``/``pid``; non-metadata events also ``tid``/``name``/numeric
      ``ts``; instants carry a scope ``s``);
    * per-(pid, tid) track timestamps are monotone non-decreasing in
      emission order;
    * B/E spans nest strictly (every E matches the innermost open B of the
      same name; no track ends with an open span);
    * with ``require_terminal``, every track that saw any lifecycle event
      contains a terminal ``complete``/``forced_complete`` instant — no
      admitted request may vanish mid-cascade.

    Returns a summary dict: ``{"events", "tracks", "spans"}``.
    """
    assert isinstance(trace, dict) and isinstance(
        trace.get("traceEvents"), list
    ), "trace must be a dict with a traceEvents list"
    tracks: Dict[tuple, List[dict]] = {}
    n_spans = 0
    for ev in trace["traceEvents"]:
        assert isinstance(ev, dict) and "ph" in ev and "pid" in ev, ev
        if ev["ph"] == "M":
            assert ev.get("name") in ("process_name", "thread_name"), ev
            assert "name" in ev.get("args", {}), ev
            continue
        assert ev["ph"] in ("B", "E", "i", "X"), ev
        assert isinstance(ev.get("name"), str) and ev["name"], ev
        assert isinstance(ev.get("tid"), int), ev
        assert isinstance(ev.get("ts"), (int, float)) and ev["ts"] >= 0, ev
        if ev["ph"] == "i":
            assert ev.get("s") in ("t", "p", "g"), ev
        tracks.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for key, evs in tracks.items():
        last_ts = -1.0
        stack: List[str] = []
        saw_terminal = False
        for ev in evs:
            assert ev["ts"] >= last_ts, (
                f"track {key}: non-monotone ts {ev['ts']} after {last_ts}: {ev}"
            )
            last_ts = ev["ts"]
            if ev["ph"] == "B":
                stack.append(ev["name"])
                n_spans += 1
            elif ev["ph"] == "E":
                assert stack, f"track {key}: E without open span: {ev}"
                assert stack[-1] == ev["name"], (
                    f"track {key}: E {ev['name']!r} does not close the "
                    f"innermost open span {stack[-1]!r}"
                )
                stack.pop()
            elif ev["ph"] == "i" and ev["name"] in _TERMINAL:
                saw_terminal = True
        assert not stack, f"track {key}: unclosed spans at end: {stack}"
        if require_terminal:
            assert saw_terminal, (
                f"track {key}: no terminal complete event — the request "
                "vanished mid-cascade"
            )
    return {
        "events": len(trace["traceEvents"]),
        "tracks": len(tracks),
        "spans": n_spans,
    }

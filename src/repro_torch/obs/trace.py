"""Structured trace recorder producing Chrome-trace JSON and JSONL.

``Tracer`` records flat event dicts in the Chrome trace-event format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):

* ``span("fit.hpa", k=8)`` — a context manager emitting one complete
  ("ph": "X") event on exit, with microsecond ``ts``/``dur`` relative to
  the tracer's epoch.  Spans nest naturally: synchronous callers share
  tid 0, so viewers reconstruct the tree from ts/dur containment.
* ``event("drift.fire")`` — an instant ("i") event.
* ``counter("online", served=..., inflight=...)`` — a counter ("C")
  event; Perfetto renders these as stacked time series.
* ``complete(name, t0, t1, **args)`` — an explicit complete event from
  two ``time.perf_counter()`` stamps, for work that does not nest as a
  ``with`` block (e.g. a migration transfer that starts in one
  ``advance()`` call and lands in a later one).

``to_chrome_trace()`` serialises to the JSON object format that
chrome://tracing and https://ui.perfetto.dev load directly;
``to_jsonl()`` emits one event per line for streaming consumers.

``NULL_TRACER`` implements the same surface as no-ops (``span`` returns a
shared no-op context manager), so hot paths pay one attribute check when
``flags.obs_level != "trace"``.
"""

from __future__ import annotations

import json
import time

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN"]


class _Span:
    """Context manager emitting one complete event on exit."""

    __slots__ = ("_tracer", "name", "args", "t0")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer.complete(self.name, self.t0, time.perf_counter(),
                              **self.args)
        return False


class Tracer:
    active = True

    def __init__(self, pid: int = 0):
        self.pid = pid
        self.events: list = []
        self.epoch = time.perf_counter()

    def _us(self, t_pc: float) -> float:
        return (t_pc - self.epoch) * 1e6

    # -- recording -------------------------------------------------------
    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def complete(self, name: str, t0: float, t1: float, **args):
        """Complete event from two ``time.perf_counter()`` stamps."""
        self.events.append({
            "name": name, "ph": "X", "ts": self._us(t0),
            "dur": (t1 - t0) * 1e6, "pid": self.pid, "tid": 0,
            "args": args,
        })

    def event(self, name: str, **args):
        self.events.append({
            "name": name, "ph": "i", "s": "t",
            "ts": self._us(time.perf_counter()), "pid": self.pid, "tid": 0,
            "args": args,
        })

    def counter(self, name: str, **values):
        self.events.append({
            "name": name, "ph": "C",
            "ts": self._us(time.perf_counter()), "pid": self.pid, "tid": 0,
            "args": values,
        })

    # -- export ----------------------------------------------------------
    def to_chrome_trace(self) -> str:
        return json.dumps(
            {"traceEvents": self.events, "displayTimeUnit": "ms"}
        )

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e) for e in self.events)

    def spans(self, name: str | None = None) -> list:
        """Complete ("X") events, optionally filtered by exact name."""
        return [e for e in self.events
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def clear(self):
        self.events.clear()
        self.epoch = time.perf_counter()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op stand-in for ``Tracer`` when tracing is disabled."""

    active = False
    events = ()

    def span(self, name: str, **args):
        return NULL_SPAN

    def complete(self, name: str, t0: float, t1: float, **args):
        pass

    def event(self, name: str, **args):
        pass

    def counter(self, name: str, **values):
        pass

    def to_chrome_trace(self) -> str:
        return '{"traceEvents": []}'

    def to_jsonl(self) -> str:
        return ""

    def spans(self, name: str | None = None) -> list:
        return []

    def clear(self):
        pass


NULL_TRACER = NullTracer()

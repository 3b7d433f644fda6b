"""repro_torch.obs — metrics registry, structured tracer, health.

Level selection is flag-driven and re-read on every accessor call:

* ``flags.FLAGS["obs_level"] == "off"`` -> ``registry()`` is
  ``NULL_REGISTRY`` and ``tracer()`` is ``NULL_TRACER`` (no-op singletons,
  zero allocations on hot paths);
* ``"counters"`` -> real ``Registry``, null tracer;
* ``"trace"`` -> real ``Registry`` + real ``Tracer``.

No level may change placement results: hooks only read state.
``timed(name, **args)`` always measures (``.seconds`` is valid at every
level) and records a trace span when ``obs_level == "trace"``.

Health: ``TimeSeriesStore`` keeps ring-buffered history of the periodic
registry snapshots, ``HealthMonitor`` evaluates SLO rules over it
(``Simulator.run_online(health=...)``), and ``analyze`` rebuilds span
trees from a trace for ``python -m repro_torch.obs.report``.
"""

from __future__ import annotations

import time

from .. import flags as _flags
from .registry import (Registry, NullRegistry, NULL_REGISTRY,
                       DEFAULT_BUCKETS, parse_prom_text)
from .trace import Tracer, NullTracer, NULL_TRACER, NULL_SPAN
from .timeseries import SeriesRing, TimeSeriesStore
from .health import SLORule, Alert, HealthMonitor
from .analyze import (load_events, build_span_tree, aggregate_spans,
                      critical_path, top_slowest, render_report)

__all__ = [
    "Registry", "NullRegistry", "NULL_REGISTRY", "DEFAULT_BUCKETS",
    "parse_prom_text", "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
    "SeriesRing", "TimeSeriesStore", "SLORule", "Alert", "HealthMonitor",
    "load_events", "build_span_tree", "aggregate_spans", "critical_path",
    "top_slowest", "render_report",
    "level", "registry", "tracer", "reset", "timed",
]

LEVELS = ("off", "counters", "trace")

_REGISTRY = Registry()
_TRACER = Tracer()


def level() -> str:
    """Current ``obs_level`` flag value (validated)."""
    lv = _flags.FLAGS.get("obs_level", "off")
    if lv not in LEVELS:
        raise ValueError(f"unknown obs_level {lv!r}; expected one of {LEVELS}")
    return lv


def registry():
    """The live ``Registry`` at "counters"/"trace", else ``NULL_REGISTRY``."""
    return NULL_REGISTRY if _flags.FLAGS.get("obs_level", "off") == "off" \
        else _REGISTRY


def tracer():
    """The live ``Tracer`` at "trace", else ``NULL_TRACER``."""
    return _TRACER if _flags.FLAGS.get("obs_level", "off") == "trace" \
        else NULL_TRACER


def reset():
    """Drop all recorded metrics and trace events (flags are untouched)."""
    _REGISTRY.clear()
    _TRACER.clear()


class timed:
    """Always-on timing context manager; trace span when tracing.

    ``with obs.timed("fit.place", algorithm="lmbr") as t: ...`` then read
    ``t.seconds``.
    """

    __slots__ = ("name", "args", "t0", "seconds")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.seconds = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        self.seconds = t1 - self.t0
        tr = tracer()
        if tr.active:
            tr.complete(self.name, self.t0, t1, **self.args)
        return False

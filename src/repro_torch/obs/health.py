"""Health monitoring: declarative SLO rules over windowed time series.

The paper's control signal is the *average query span*, not latency; the
metrics registry exposes it (and load, degraded counts, migration backlog)
as point-in-time counters.  This module is the bridge from observation to
control: a `HealthMonitor` evaluates declarative `SLORule`s against a
`TimeSeriesStore` fed by the periodic ``run_online`` registry snapshots,
drives a firing -> resolved alert state machine with hysteresis, and hands
every transition to an ``on_alert`` callback — the entry point for an
autoscaler.

* `SLORule` — name + a value function over the store (windowed avg span
  vs the fit-time baseline, p99 microbatch latency, degraded-query rate,
  partition load skew p99/mean, migration in-flight backlog are the
  built-ins from `HealthMonitor.from_flags`) + comparison + threshold +
  fire/resolve hysteresis counts.
* `Alert` — per-rule state: ``ok`` or ``firing``, with breach/clear
  streaks so a rule must breach ``fire_after`` consecutive evaluations to
  fire and hold clear for ``resolve_after`` to resolve — drift refits and
  failover storms cross a threshold for one window without flapping.
* EWMA z-score anomaly detection (``health_anomaly_z`` > 0): every rule's
  value stream additionally feeds an exponentially weighted mean/variance
  tracker; after a warmup, ``|value - ewma_mean| / ewma_std`` past the
  z threshold raises a ``<rule>_anomaly`` alert through the same state
  machine — a regime *change* fires even while the absolute SLO holds.

Alerts surface three ways, all read-only (the observation-changes-nothing
contract): tracer instant events (``alert.fire`` / ``alert.resolve``),
registry counters (``health_alerts_fired_total`` /
``health_alerts_resolved_total``, gauge ``health_alerts_active``), and the
``on_alert(alert, firing)`` callback.  `Simulator.run_online` folds the
fired/resolved totals into ``online_stats["alerts_fired"/"alerts_resolved"]``.

A copy of the JAX package's ``obs/health.py``: host Python over the
registry snapshots, reading no device state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from .. import flags as _flags
from .timeseries import TimeSeriesStore

__all__ = ["SLORule", "Alert", "HealthMonitor"]


@dataclasses.dataclass
class SLORule:
    """One declarative SLO: fire while ``value(store) <op> threshold``.

    ``value`` returns the rule's current reading off the store, or None
    when the window holds too little data (no state change).  ``op`` is
    ``">"`` or ``"<"``.  Hysteresis: ``fire_after`` consecutive breaches
    to fire, ``resolve_after`` consecutive clears to resolve."""

    name: str
    value: Callable[[TimeSeriesStore], "float | None"]
    op: str
    threshold: float
    fire_after: int = 1
    resolve_after: int = 2

    def breached(self, v: float) -> bool:
        if self.op == ">":
            return v > self.threshold
        if self.op == "<":
            return v < self.threshold
        raise ValueError(f"unknown SLO op {self.op!r}")


@dataclasses.dataclass
class Alert:
    """Mutable per-rule alert state (one per rule, plus one per anomaly
    tracker).  ``fired_at`` / ``resolved_at`` are the ingest time
    coordinates (served+degraded queries under ``run_online``) of the most
    recent transitions."""

    name: str
    threshold: float
    state: str = "ok"          # "ok" | "firing"
    breach_streak: int = 0
    clear_streak: int = 0
    fires: int = 0
    resolves: int = 0
    fired_at: float | None = None
    resolved_at: float | None = None
    last_value: float | None = None

    @property
    def firing(self) -> bool:
        return self.state == "firing"


class _Ewma:
    """EWMA mean/variance tracker for the z-score anomaly detector."""

    __slots__ = ("alpha", "mean", "var", "count")

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def zscore(self, x: float) -> float | None:
        """z of ``x`` against the PRE-update statistics, then update."""
        z: float | None = None
        if self.count > 0:
            diff = x - self.mean
            std = math.sqrt(self.var)
            if std > 1e-12:
                z = diff / std
            else:
                # a flat history: any movement is infinitely surprising
                z = 0.0 if abs(diff) <= 1e-12 else math.inf
        diff = x - self.mean
        incr = self.alpha * diff
        self.mean += incr
        self.var = (1.0 - self.alpha) * (self.var + diff * incr)
        self.count += 1
        return z


class HealthMonitor:
    """Evaluates SLO rules between microbatches; see module docstring.

    Construct with explicit rules, or `from_flags` for the built-in rule
    set configured by the ``health_*`` flags.  ``observe(snapshot, t)`` is
    the single entry point `run_online` calls at every periodic snapshot:
    it ingests the snapshot into the store and runs one evaluation pass.
    """

    def __init__(self, rules: "list[SLORule]",
                 store: TimeSeriesStore | None = None,
                 on_alert: "Callable[[Alert, bool], None] | None" = None,
                 anomaly_z: float = 0.0, anomaly_alpha: float = 0.3,
                 anomaly_warmup: int = 5):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names: {sorted(names)}")
        self.rules = list(rules)
        self.store = store if store is not None else TimeSeriesStore()
        self.on_alert = on_alert
        self.anomaly_z = float(anomaly_z)
        self.anomaly_alpha = float(anomaly_alpha)
        self.anomaly_warmup = int(anomaly_warmup)
        self.baseline_span: float | None = None
        self.alerts: dict[str, Alert] = {
            r.name: Alert(r.name, r.threshold) for r in self.rules
        }
        self._ewma: dict[str, _Ewma] = {}
        self.history: list[dict] = []   # transition log, append-only
        self.stats = dict(checks=0, alerts_fired=0, alerts_resolved=0)

    # ------------------------------------------------------------ baseline
    def set_baseline(self, avg_span: float) -> None:
        """Pin the fit-time average span the windowed span rule compares
        against (``run_online`` supplies it right after the fit)."""
        self.baseline_span = float(avg_span)

    # ------------------------------------------------------------- ingest
    def observe(self, snapshot: dict, t: float) -> "list[Alert]":
        """Ingest one registry snapshot at time ``t`` and evaluate every
        rule.  Returns the alerts that TRANSITIONED this pass."""
        self.store.ingest(snapshot, t)
        return self.evaluate(t)

    def evaluate(self, t: float) -> "list[Alert]":
        self.stats["checks"] += 1
        transitions: list[Alert] = []
        for rule in self.rules:
            v = rule.value(self.store)
            if v is None:
                continue
            alert = self.alerts[rule.name]
            alert.last_value = float(v)
            if self._update(alert, rule.breached(float(v)),
                            rule.fire_after, rule.resolve_after, t):
                transitions.append(alert)
            if self.anomaly_z > 0:
                a = self._anomaly_pass(rule, float(v), t)
                if a is not None:
                    transitions.append(a)
        return transitions

    def _anomaly_pass(self, rule: SLORule, v: float,
                      t: float) -> "Alert | None":
        tracker = self._ewma.get(rule.name)
        if tracker is None:
            tracker = self._ewma[rule.name] = _Ewma(self.anomaly_alpha)
        z = tracker.zscore(v)
        if z is None or tracker.count <= self.anomaly_warmup:
            return None
        name = f"{rule.name}_anomaly"
        alert = self.alerts.get(name)
        if alert is None:
            alert = self.alerts[name] = Alert(name, self.anomaly_z)
        alert.last_value = abs(z) if math.isfinite(z) else float("inf")
        fired = self._update(alert, abs(z) > self.anomaly_z,
                             rule.fire_after, rule.resolve_after, t)
        return alert if fired else None

    # -------------------------------------------------------- state machine
    def _update(self, alert: Alert, breach: bool, fire_after: int,
                resolve_after: int, t: float) -> bool:
        """Advance one alert's state machine; True iff it transitioned."""
        if breach:
            alert.breach_streak += 1
            alert.clear_streak = 0
            if alert.state == "ok" and alert.breach_streak >= fire_after:
                alert.state = "firing"
                alert.fires += 1
                alert.fired_at = float(t)
                self._transition(alert, firing=True, t=t)
                return True
        else:
            alert.clear_streak += 1
            alert.breach_streak = 0
            if alert.state == "firing" and alert.clear_streak >= resolve_after:
                alert.state = "ok"
                alert.resolves += 1
                alert.resolved_at = float(t)
                self._transition(alert, firing=False, t=t)
                return True
        return False

    def _transition(self, alert: Alert, firing: bool, t: float) -> None:
        from .. import obs as _obs  # runtime import: obs/__init__ imports us

        kind = "fire" if firing else "resolve"
        self.stats["alerts_fired" if firing else "alerts_resolved"] += 1
        self.history.append(dict(
            t=float(t), alert=alert.name, kind=kind,
            value=alert.last_value, threshold=alert.threshold,
        ))
        reg = _obs.registry()
        if reg.active:
            reg.inc(f"health_alerts_{kind}d_total")
            reg.set("health_alerts_active", float(len(self.active_alerts())))
            tr = _obs.tracer()
            if tr.active:
                tr.event(f"alert.{kind}", rule=alert.name,
                         value=alert.last_value, threshold=alert.threshold)
        if self.on_alert is not None:
            self.on_alert(alert, firing)

    # ------------------------------------------------------------ accessors
    def active_alerts(self) -> "list[str]":
        return sorted(n for n, a in self.alerts.items() if a.firing)

    # ---------------------------------------------------------- from_flags
    @classmethod
    def from_flags(cls, on_alert=None) -> "HealthMonitor":
        """The built-in rule set, thresholds from the ``health_*`` flags
        (a threshold of 0 disables its rule).  The span rule reads the
        monitor's ``baseline_span`` (set by ``run_online`` post-fit), so
        its value is the *ratio* windowed avg span / baseline and the
        threshold is ``health_span_slo`` directly."""
        F = _flags.FLAGS
        w = int(F.get("health_window", 8))
        if w < 2:
            raise ValueError(f"health_window must be >= 2, got {w}")
        fire_after = 1
        resolve_after = int(F.get("health_hysteresis", 2))
        if resolve_after < 1:
            raise ValueError(
                f"health_hysteresis must be >= 1, got {resolve_after}"
            )
        monitor: dict = {}  # forward cell so closures see the instance

        def span_ratio(store: TimeSeriesStore) -> "float | None":
            base = monitor["m"].baseline_span
            if base is None or base <= 0:
                return None
            ds = store.delta("online_span_sum", w)
            dq = store.delta("online_served_queries", w)
            if ds is None or dq is None or dq <= 0:
                return None
            return (ds / dq) / base

        def degraded_rate(store: TimeSeriesStore) -> "float | None":
            dd = store.delta("online_degraded_queries", w)
            dq = store.delta("online_served_queries", w)
            if dd is None or dq is None or dd + dq <= 0:
                return None
            return dd / (dd + dq)

        def load_skew(store: TimeSeriesStore) -> "float | None":
            d = store.vector_delta("online_partition_load", w)
            if not len(d):
                return None
            m = float(d.mean())
            if m <= 1e-12:
                return None
            return float(np.quantile(d, 0.99)) / m

        def p99_latency(store: TimeSeriesStore) -> "float | None":
            return store.histogram_quantile(
                "router_microbatch_seconds", 0.99, w
            )

        def backlog(store: TimeSeriesStore) -> "float | None":
            return store.mean("migration_inflight", w)

        specs = [
            ("span_slo", span_ratio, float(F.get("health_span_slo", 0.0))),
            ("degraded_rate", degraded_rate,
             float(F.get("health_degraded_slo", 0.0))),
            ("load_skew", load_skew, float(F.get("health_skew_slo", 0.0))),
            ("latency_p99", p99_latency,
             float(F.get("health_p99_slo", 0.0))),
            ("migration_backlog", backlog,
             float(F.get("health_backlog_slo", 0.0))),
        ]
        rules = [
            SLORule(name, fn, ">", thr, fire_after=fire_after,
                    resolve_after=resolve_after)
            for name, fn, thr in specs if thr > 0
        ]
        m = cls(rules, on_alert=on_alert,
                anomaly_z=float(F.get("health_anomaly_z", 0.0)))
        monitor["m"] = m
        return m

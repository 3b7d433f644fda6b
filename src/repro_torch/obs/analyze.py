"""Offline trace analytics over Chrome-trace events.

A `Tracer` records flat complete/instant/counter events; this module
turns them back into structure after the run:

* `load_events` — read a trace from JSONL (one event per line,
  ``Tracer.to_jsonl``) or the Chrome JSON object format
  (``{"traceEvents": [...]}``, ``Tracer.to_chrome_trace``).
* `build_span_tree` — reconstruct the span tree from ts/dur containment
  per tid (synchronous callers share tid 0, so nesting IS containment).
  Spans that only *partially* overlap an open span — e.g. a
  ``migration.transfer`` stamped at transfer start but landing several
  microbatches later — are treated as parentless roots rather than
  misattributed to whichever microbatch they happen to straddle.
* `aggregate_spans` — per-span-name count / total / self / min / max /
  mean wall time, where self time is the span's duration minus its direct
  children's (clamped at 0; clock jitter can make children sum past the
  parent).
* `critical_path` — from the named root (default ``fit.place``, the
  fit's umbrella span in ``run_online``), repeatedly descend into the
  longest child: the chain a latency optimisation has to shorten.
* `top_slowest` — top-k slowest events of one name (default
  ``serve.microbatch``).
* `render_report` — the plain-text run report ``python -m
  repro_torch.obs.report`` prints, optionally joined with a prom
  snapshot's headline counters.

Durations are microseconds throughout (the trace-event unit); the report
renders milliseconds.  A copy of the JAX package's ``obs/analyze.py``.
"""

from __future__ import annotations

import json

__all__ = [
    "load_events", "SpanNode", "build_span_tree", "aggregate_spans",
    "critical_path", "top_slowest", "render_report",
    "FIT_ROOT_SPAN", "MICROBATCH_SPAN",
]

FIT_ROOT_SPAN = "fit.place"
MICROBATCH_SPAN = "serve.microbatch"


def load_events(text: str) -> list:
    """Parse trace events from JSONL or Chrome JSON object text."""
    text = text.strip()
    if not text:
        return []
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        # multi-line JSONL: one event object per line
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    if isinstance(obj, dict) and "traceEvents" in obj:
        events = obj["traceEvents"]
        if not isinstance(events, list):
            raise ValueError("traceEvents is not a list")
        return events
    if isinstance(obj, list):
        return obj
    return [obj]  # a single-event JSONL file


class SpanNode:
    """One complete ("X") event with its reconstructed children."""

    __slots__ = ("event", "children", "parent")

    def __init__(self, event: dict):
        self.event = event
        self.children: list[SpanNode] = []
        self.parent: "SpanNode | None" = None

    @property
    def name(self) -> str:
        return self.event["name"]

    @property
    def ts(self) -> float:
        return float(self.event["ts"])

    @property
    def dur(self) -> float:
        return float(self.event.get("dur", 0.0))

    @property
    def end(self) -> float:
        return self.ts + self.dur

    @property
    def self_time(self) -> float:
        return max(0.0, self.dur - sum(c.dur for c in self.children))

    def __repr__(self) -> str:  # debugging aid
        return (f"SpanNode({self.name!r}, ts={self.ts:.1f}, "
                f"dur={self.dur:.1f}, children={len(self.children)})")


def build_span_tree(events: list) -> "list[SpanNode]":
    """Reconstruct the span forest from ts/dur containment; returns the
    roots in chronological order.  See the module docstring for how
    partially-overlapping spans are handled."""
    nodes = [SpanNode(e) for e in events if e.get("ph") == "X"]
    by_tid: dict = {}
    for node in nodes:
        key = (node.event.get("pid", 0), node.event.get("tid", 0))
        by_tid.setdefault(key, []).append(node)
    roots: list[SpanNode] = []
    for group in by_tid.values():
        # parents first at equal ts: longer duration wins
        group.sort(key=lambda s: (s.ts, -s.dur))
        stack: list[SpanNode] = []
        for node in group:
            while stack and node.ts >= stack[-1].end:
                stack.pop()
            if not stack:
                roots.append(node)
                stack.append(node)
            elif node.end <= stack[-1].end:
                node.parent = stack[-1]
                stack[-1].children.append(node)
                stack.append(node)
            else:
                # partial overlap (async span like migration.transfer):
                # parentless, and never a parent itself
                roots.append(node)
    roots.sort(key=lambda s: s.ts)
    return roots


def _walk(roots: "list[SpanNode]"):
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.children)


def aggregate_spans(events: list) -> dict:
    """Per-name aggregation over complete events: ``{name: {count,
    total_us, self_us, min_us, max_us, mean_us}}``."""
    agg: dict = {}
    for node in _walk(build_span_tree(events)):
        row = agg.get(node.name)
        if row is None:
            row = agg[node.name] = dict(
                count=0, total_us=0.0, self_us=0.0,
                min_us=float("inf"), max_us=0.0, mean_us=0.0,
            )
        row["count"] += 1
        row["total_us"] += node.dur
        row["self_us"] += node.self_time
        row["min_us"] = min(row["min_us"], node.dur)
        row["max_us"] = max(row["max_us"], node.dur)
    for row in agg.values():
        row["mean_us"] = row["total_us"] / row["count"]
    return agg


def critical_path(events: list,
                  root_name: str = FIT_ROOT_SPAN) -> "list[SpanNode]":
    """The longest root span named ``root_name`` (any root if absent),
    then its longest child, recursively — the chain to shorten first."""
    roots = build_span_tree(events)
    named = [r for r in roots if r.name == root_name]
    pool = named if named else roots
    if not pool:
        return []
    node = max(pool, key=lambda s: s.dur)
    path = [node]
    while node.children:
        node = max(node.children, key=lambda s: s.dur)
        path.append(node)
    return path


def top_slowest(events: list, name: str = MICROBATCH_SPAN,
                k: int = 5) -> list:
    """Top-``k`` slowest complete events named ``name`` (raw event
    dicts, slowest first)."""
    xs = [e for e in events
          if e.get("ph") == "X" and e.get("name") == name]
    xs.sort(key=lambda e: -float(e.get("dur", 0.0)))
    return xs[:k]


# --------------------------------------------------------------- reporting
_HEADLINE_METRICS = (
    "router_served_queries_total", "router_microbatches_total",
    "router_plan_swaps_total", "online_degraded_queries",
    "migration_transferred_total", "migration_wasted_total",
    "drift_fires_total", "drift_refits_total",
    "health_alerts_fired_total", "health_alerts_resolved_total",
    "health_alerts_active",
)


def _ms(us: float) -> str:
    return f"{us / 1e3:.3f}ms"


def render_report(events: list, prom_snapshot: "dict | None" = None,
                  top_k: int = 5) -> str:
    """Plain-text run report: event census, span aggregation, fit
    critical path, slowest microbatches, headline prom counters."""
    lines: list[str] = ["== trace =="]
    census: dict = {}
    for e in events:
        census[e.get("ph", "?")] = census.get(e.get("ph", "?"), 0) + 1
    lines.append(
        f"events: {len(events)} "
        f"({', '.join(f'{ph}={n}' for ph, n in sorted(census.items()))})"
    )

    agg = aggregate_spans(events)
    if agg:
        lines.append("")
        lines.append("-- spans by total time --")
        lines.append(f"{'name':<28} {'count':>6} {'total':>12} "
                     f"{'self':>12} {'mean':>12} {'max':>12}")
        for name, row in sorted(agg.items(),
                                key=lambda kv: -kv[1]["total_us"]):
            lines.append(
                f"{name:<28} {row['count']:>6} {_ms(row['total_us']):>12} "
                f"{_ms(row['self_us']):>12} {_ms(row['mean_us']):>12} "
                f"{_ms(row['max_us']):>12}"
            )

    path = critical_path(events)
    if path:
        lines.append("")
        lines.append(f"-- critical path ({path[0].name}) --")
        for depth, node in enumerate(path):
            lines.append(f"{'  ' * depth}{node.name:<28} "
                         f"dur={_ms(node.dur)} self={_ms(node.self_time)}")

    slow = top_slowest(events, k=top_k)
    if slow:
        lines.append("")
        lines.append(f"-- slowest {MICROBATCH_SPAN} (top {len(slow)}) --")
        for e in slow:
            args = e.get("args", {})
            extra = f" queries={args['queries']}" if "queries" in args else ""
            lines.append(f"dur={_ms(float(e.get('dur', 0.0)))} "
                         f"ts={_ms(float(e.get('ts', 0.0)))}{extra}")

    alerts = [e for e in events if e.get("ph") == "i"
              and str(e.get("name", "")).startswith("alert.")]
    if alerts:
        lines.append("")
        lines.append("-- alerts --")
        for e in alerts:
            args = e.get("args", {})
            lines.append(
                f"{e['name']:<14} rule={args.get('rule', '?')} "
                f"value={args.get('value')} threshold={args.get('threshold')}"
            )

    if prom_snapshot:
        lines.append("")
        lines.append("== metrics ==")
        for name in _HEADLINE_METRICS:
            if name in prom_snapshot:
                lines.append(f"{name:<32} {prom_snapshot[name]:g}")
    return "\n".join(lines) + "\n"

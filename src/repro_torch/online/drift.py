"""Workload-drift detection: sliding-window sketch + refit trigger.

A placement is fitted against yesterday's trace; when the live workload
drifts (new co-access patterns), the plan's spans regress.  Two pieces turn
that observation into an online repair:

* `WorkloadSketch` — a sliding window of the last W served queries with
  exponentially decayed edge-frequency weights, rebuildable into a
  `Hypergraph` at any time (``to_hypergraph``).  With ``decay=1.0`` (the
  default) the rebuild is exactly ``Hypergraph.from_edges(window)`` — same
  CSR, unit edge weights; a decay < 1 down-weights older queries so
  refits chase the live mixture.

* `DriftDetector` — monitors the windowed average span of served queries
  against the plan's fit-time baseline and, past
  ``baseline * flags.FLAGS["drift_threshold"]``, requests an incremental
  refit: `PlacementService.refit` warm-starts LMBR from the live plan on the
  sketch's window, so new replicas only move into free space and the
  resulting plan is cheap to hot-swap between router microbatches.

A copy of the JAX package's drift module.  The detector's spans run on the
plan's ``device``; without a service it refits with
``PlacementService("lmbr", device=plan.device)``.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from .. import flags as _flags
from .. import obs as _obs
from ..core.hypergraph import Hypergraph
from ..core.placement_service import PlacementPlan, PlacementService

__all__ = ["WorkloadSketch", "DriftDetector"]


class WorkloadSketch:
    """Sliding window of the last ``window`` queries, decayed.

    ``observe`` appends served queries (pin-deduplicated int arrays, the
    router's input form); ``to_hypergraph`` rebuilds the window into a
    `Hypergraph` whose edges are the window queries in arrival order (oldest
    first) and whose edge weight for the query at age ``a`` (0 = newest) is
    ``decay ** a``.  ``decay=1.0`` therefore reproduces
    ``Hypergraph.from_edges(window_queries)`` exactly.
    """

    def __init__(self, num_items: int, window: int | None = None,
                 decay: float = 1.0):
        if window is None:
            window = int(_flags.FLAGS.get("drift_window", 512))
        self.num_items = int(num_items)
        self.window = int(window)
        self.decay = float(decay)
        self._queries: deque[np.ndarray] = deque(maxlen=self.window)
        self.total_observed = 0

    def __len__(self) -> int:
        return len(self._queries)

    @property
    def full(self) -> bool:
        return len(self._queries) == self.window

    def observe(self, query) -> None:
        self._queries.append(np.asarray(query, dtype=np.int64))
        self.total_observed += 1

    def observe_batch(self, queries) -> None:
        for q in queries:
            self.observe(q)

    def window_queries(self) -> list[np.ndarray]:
        """The window's queries, oldest first."""
        return list(self._queries)

    def edge_weights(self) -> np.ndarray:
        """decay**age per window query (aligned with `window_queries`)."""
        n = len(self._queries)
        ages = np.arange(n - 1, -1, -1, dtype=np.float64)
        return self.decay ** ages

    def to_hypergraph(self) -> Hypergraph:
        """Rebuild the window into a Hypergraph (arrival order, decayed
        edge weights; ``decay=1.0`` == direct construction; an empty window
        rebuilds to an edge-free hypergraph)."""
        qs = self.window_queries()
        return Hypergraph.from_edges(
            qs, num_nodes=self.num_items,
            edge_weights=self.edge_weights() if qs else None,
        )


class DriftDetector:
    """Windowed avg_span monitor + `PlacementService.refit` trigger.

    ``baseline`` is the plan's fit-time average span (computed over the
    training workload by the caller, or over the first full window via
    `seed_baseline`).  After `observe` ingests each routed microbatch's
    queries and spans, `should_refit` is True once the window is full and

        windowed_avg_span > baseline * threshold.

    `refit` then rebuilds the window hypergraph, runs the incremental LMBR
    refit, adopts the new plan, and re-baselines against it — the caller
    hot-swaps the returned plan into its router.
    """

    def __init__(self, plan: PlacementPlan,
                 service: PlacementService | None = None,
                 window: int | None = None, threshold: float | None = None,
                 decay: float = 1.0, refit_moves: int = 256):
        if window is None:
            window = int(_flags.FLAGS.get("drift_window", 512))
        if threshold is None:
            threshold = float(_flags.FLAGS.get("drift_threshold", 1.25))
        self.plan = plan
        self.service = service or PlacementService("lmbr",
                                                   device=plan.device)
        self.threshold = float(threshold)
        self.refit_moves = int(refit_moves)
        self.sketch = WorkloadSketch(plan.member.shape[1], window, decay)
        self._span_window: deque[int] = deque(maxlen=window)
        self.baseline: float | None = None
        self.stats = dict(drift_checks=0, drift_fires=0, refits=0)

    # ------------------------------------------------------------- observe
    def set_baseline(self, avg_span: float) -> None:
        """Pin the fit-time baseline (avg span of the training workload
        under the freshly fitted plan)."""
        self.baseline = float(avg_span)

    def seed_baseline_from(self, queries) -> float:
        """Baseline = the live plan's avg span over `queries`."""
        self.baseline = float(self.plan.avg_span(queries))
        return self.baseline

    def observe(self, queries, spans) -> None:
        """Ingest one routed microbatch: the served queries (router input
        order) and their spans (RoutedBatch.spans)."""
        self.sketch.observe_batch(queries)
        self._span_window.extend(int(s) for s in np.asarray(spans))

    @property
    def windowed_avg_span(self) -> float:
        if not self._span_window:
            return 0.0
        return float(np.mean(self._span_window))

    # ------------------------------------------------------------- trigger
    def should_refit(self) -> bool:
        self.stats["drift_checks"] += 1
        if self.baseline is None:
            # no fit-time baseline given: adopt the first full window as one
            if self.sketch.full:
                self.baseline = self.windowed_avg_span
            return False
        if not self.sketch.full:
            return False
        fired = self.windowed_avg_span > self.baseline * self.threshold
        if fired:
            self.stats["drift_fires"] += 1
            reg = _obs.registry()
            if reg.active:
                reg.inc("drift_fires_total")
                _obs.tracer().event(
                    "drift.fire", windowed=self.windowed_avg_span,
                    baseline=self.baseline, threshold=self.threshold,
                )
        return fired

    def refit(self, dest_mask: np.ndarray | None = None) -> PlacementPlan:
        """Incremental refit on the sketch window; adopts and returns the
        new plan, with spans re-baselined against it.  The span window is
        cleared so the trigger re-arms on post-swap traffic only.

        ``dest_mask`` ((N,) bool) is the outage path: when the live layout
        has partitions down, the caller passes the surviving rows so the
        refit keeps adapting WITHOUT copying anything onto dead partitions
        (the down rows of ``self.plan.member`` are already masked, since the
        plan shares the live membership matrix)."""
        window = self.sketch.window_queries()
        with _obs.tracer().span("drift.refit", window=len(window)):
            new_plan = self.service.refit(
                self.plan, window, max_moves=self.refit_moves,
                dest_mask=dest_mask,
            )
        self.plan = new_plan
        self.stats["refits"] += 1
        _obs.registry().inc("drift_refits_total")
        self._span_window.clear()
        self.baseline = float(new_plan.avg_span(window))
        return new_plan

"""Streaming replica-selection router.

The batch engine (`setcover.batched_cover_csr`) resolves every query of a
static trace at once; serving is different — queries arrive a few at a time
and the layout underneath can change (drift refits, partition failures).
`ReplicaRouter` bridges the two: it accumulates incoming queries into
microbatches of ``flags.FLAGS["router_microbatch"]`` and resolves each
microbatch with ONE `batched_cover_csr` call, so the serving hot path stays
vectorized while the layout may be hot-swapped between microbatches.

Tie-break modes
---------------
* default (``router_balance=False``): bit-identical to per-query
  `cover_for_query` — maximal intersection gain, ties -> lowest partition id.
* balanced (``router_balance=True``): among maximal-gain partitions, prefer
  the one with the LOWEST entry in the router's running access-load ledger
  (power-of-two-choices style, at microbatch granularity).  Implemented by
  routing against the member matrix with rows permuted ascending by
  (load, partition id): the engine's argmax then picks the least-loaded
  maximal-gain partition, and the permutation is inverted on the way out.
  The greedy gain sequence is unchanged (only which *equal-gain* replica
  serves), so spans are typically identical and load spreads across replicas.

  The permutation is rebuilt lazily: ``flags.FLAGS["router_ledger_epsilon"]``
  is the stale-ledger tolerance — the (load, id) lexsort only re-runs when
  some partition's load has shifted by more than
  ``epsilon * max(its load at the last sort, 1.0)`` since that sort.  At
  epsilon=0 (the default) ANY shift re-sorts, which is bit-identical to
  sorting every microbatch (an unshifted ledger lexsorts to the same
  permutation); larger epsilons keep the
  O(N log N) sort off the steady-state hot path and only ever trade which
  equal-gain replica serves.

The ledger counts partition accesses (one per chosen cover member, the same
unit as ``SimulationResult.access_load``) and is updated once per microbatch.

A copy of the JAX package's router.  Each microbatch's cover runs on the
router's ``device`` (default ``"cuda"``; raises without CUDA unless
``device="cpu"``); the ledger, its lexsort and the counters stay numpy on
the host, and ``member`` stays the caller's numpy matrix.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .. import flags as _flags
from .. import obs as _obs
from ..device import resolve as _resolve_device
from ..core.setcover import Placement, batched_cover_csr, queries_to_csr

__all__ = ["RoutedBatch", "ReplicaRouter", "queries_to_csr"]


@dataclasses.dataclass
class RoutedBatch:
    """Replica selection for one routed batch of queries.

    spans:       (B,) cover size per query
    cover_ptr:   (B+1,) CSR offsets into cover_parts
    cover_parts: (sum spans,) chosen partitions in greedy selection order
    pin_parts:   (P,) serving partition of every pin, aligned with the input
                 CSR (edge_ptr/edge_nodes)
    edge_ptr/edge_nodes: the input queries, CSR form
    """

    spans: np.ndarray
    cover_ptr: np.ndarray
    cover_parts: np.ndarray
    pin_parts: np.ndarray
    edge_ptr: np.ndarray
    edge_nodes: np.ndarray

    def chosen(self, i: int) -> np.ndarray:
        return self.cover_parts[self.cover_ptr[i]: self.cover_ptr[i + 1]]

    def cover(self, i: int) -> dict[int, np.ndarray]:
        """{partition: items read from it} for query i, partitions in greedy
        selection order (same shape as ``cover_for_query``'s output)."""
        lo, hi = self.edge_ptr[i], self.edge_ptr[i + 1]
        q = self.edge_nodes[lo:hi]
        pp = self.pin_parts[lo:hi]
        return {int(p): q[pp == p] for p in self.chosen(i)}


def _concat_batches(parts: list[RoutedBatch]) -> RoutedBatch:
    if len(parts) == 1:
        return parts[0]
    spans = np.concatenate([b.spans for b in parts])
    cover_ptr = np.zeros(len(spans) + 1, dtype=np.int64)
    np.cumsum(spans, out=cover_ptr[1:])
    eptr = np.zeros(len(spans) + 1, dtype=np.int64)
    np.cumsum(np.concatenate([np.diff(b.edge_ptr) for b in parts]),
              out=eptr[1:])
    return RoutedBatch(
        spans, cover_ptr,
        np.concatenate([b.cover_parts for b in parts]),
        np.concatenate([b.pin_parts for b in parts]),
        eptr,
        np.concatenate([b.edge_nodes for b in parts]),
    )


class ReplicaRouter:
    """Microbatching online replica selector over a live member matrix.

    ``member`` is held BY REFERENCE: in-place membership edits (failover
    masking, repair copies) are visible to the next microbatch without any
    router-side notification, and `swap_plan` replaces the whole matrix
    between microbatches (drift refits).  The access-load ledger and serving
    counters survive swaps — load history is a property of the traffic, not
    of one layout.
    """

    def __init__(self, member, microbatch: int | None = None,
                 balance: bool | None = None, node_cost=None,
                 device="cuda"):
        self.device = _resolve_device(device)
        self.member = self._as_member(member)
        self.load = np.zeros(self.member.shape[0], dtype=np.float64)
        self._microbatch = microbatch
        self._balance = balance
        self._perm: np.ndarray | None = None       # cached tie-break rows
        self._perm_load: np.ndarray | None = None  # ledger at last sort
        self._perm_cost_aware = False              # key mode at last sort
        self._node_cost: np.ndarray | None = None
        self.stats = dict(served_queries=0, microbatches=0, plan_swaps=0,
                          ledger_sorts=0)
        if node_cost is not None:
            self.set_node_cost(node_cost)
        self._bind_load_gauge()

    def _bind_load_gauge(self) -> None:
        """(Re)bind the exported per-partition load GaugeVector to THIS
        router's live ledger.  The gauge holds a live reference (copied
        out lazily at snapshot time), so it must rebind whenever the
        ledger's identity could differ from what the registry last saw:
        at construction (a fresh router must not leave the gauge pointing
        at a previous router's ledger) and after ``swap_plan``."""
        reg = _obs.registry()
        if reg.active:
            reg.gauge_vector("router_partition_load").set(self.load)

    def set_node_cost(self, node_cost) -> None:
        """Install the per-partition serving-cost key the cost-aware
        tie-break multiplies into the ledger (typically
        `NodeProfile.routing_cost()`: access cost + normalized active
        power).  Only read when ``flags.FLAGS["router_cost_aware"]`` is on;
        a UNIFORM cost vector scales every ledger entry equally, so the
        permutation — and routing — stay bit-identical to least-loaded."""
        if node_cost is None:
            self._node_cost = None
        else:
            nc = np.asarray(node_cost, dtype=np.float64)
            if nc.shape != (self.num_partitions,):
                raise ValueError(
                    f"node_cost must be ({self.num_partitions},), "
                    f"got {nc.shape}"
                )
            if (nc <= 0).any():
                raise ValueError("node_cost entries must be positive")
            self._node_cost = nc
        self._perm = None  # cached permutation keyed on the old cost

    @staticmethod
    def _as_member(obj) -> np.ndarray:
        member = getattr(obj, "member", obj)
        member = np.asarray(member)
        if member.dtype != bool or member.ndim != 2:
            raise TypeError("router needs a (N, V) bool member matrix")
        return member

    @property
    def num_partitions(self) -> int:
        return self.member.shape[0]

    # --------------------------------------------------------------- config
    def _cfg(self) -> tuple[int, bool]:
        mb = self._microbatch
        if mb is None:
            mb = int(_flags.FLAGS.get("router_microbatch", 384))
        bal = self._balance
        if bal is None:
            bal = bool(_flags.FLAGS.get("router_balance", False))
        return max(1, mb), bal

    # ----------------------------------------------------------------- swap
    def swap_plan(self, member) -> None:
        """Hot-swap the layout (drift refit): takes effect at the next
        microbatch; ledger and counters carry over."""
        member = self._as_member(member)
        if member.shape[0] != self.num_partitions:
            raise ValueError("swap_plan cannot change the partition count")
        self.member = member
        self.stats["plan_swaps"] += 1
        reg = _obs.registry()
        if reg.active:
            reg.inc("router_plan_swaps_total")
            _obs.tracer().event("router.swap_plan",
                                swaps=self.stats["plan_swaps"])
        self._bind_load_gauge()

    # ---------------------------------------------------------------- route
    def route_one(self, query):
        """Scalar reference path: route a single query through the same
        selection the microbatched path performs."""
        batch = self.route([np.asarray(query, dtype=np.int64)])
        return batch.chosen(0), batch.cover(0)

    def route(self, queries) -> RoutedBatch:
        """Resolve `queries` (list of pin-deduplicated int sequences) in
        microbatches — one `batched_cover_csr` call each — and update the
        access-load ledger per microbatch.  Raises ValueError if a query
        contains an item with no live replica (pre-filter such queries with
        `FailoverManager.serveable_mask` during an outage)."""
        ptr, nodes = queries_to_csr(queries)
        return self.route_csr(ptr, nodes)

    def route_csr(self, edge_ptr, edge_nodes) -> RoutedBatch:
        """CSR-form `route` (the zero-copy path for Hypergraph traces)."""
        edge_ptr = np.asarray(edge_ptr, dtype=np.int64)
        edge_nodes = np.asarray(edge_nodes, dtype=np.int64)
        nq = len(edge_ptr) - 1
        mb, bal = self._cfg()
        out: list[RoutedBatch] = []
        for lo in range(0, max(nq, 1), mb):
            hi = min(lo + mb, nq)
            if hi <= lo:
                break
            ptr = edge_ptr[lo: hi + 1] - edge_ptr[lo]
            nodes = edge_nodes[edge_ptr[lo]: edge_ptr[hi]]
            out.append(self._route_microbatch(ptr, nodes, bal))
        if not out:
            z = np.zeros(0, dtype=np.int64)
            return RoutedBatch(z, np.zeros(1, dtype=np.int64), z, z,
                               np.zeros(1, dtype=np.int64), z)
        return _concat_batches(out)

    def _ledger_perm(self) -> np.ndarray:
        """Rows ascending by (ledger load, id), rebuilt only when the ledger
        has drifted past ``router_ledger_epsilon`` since the last sort.
        With ``router_cost_aware`` on and a node-cost vector installed the
        sort key becomes ``load * node_cost`` — least COST, not least
        load — steering equal-gain ties toward cheap partitions."""
        cost_aware = (
            bool(_flags.FLAGS.get("router_cost_aware", False))
            and self._node_cost is not None
        )
        if self._perm is not None and cost_aware == self._perm_cost_aware:
            eps = float(_flags.FLAGS.get("router_ledger_epsilon", 0.0))
            drift = np.abs(self.load - self._perm_load)
            if not (drift > eps * np.maximum(self._perm_load, 1.0)).any():
                return self._perm
        key = self.load * self._node_cost if cost_aware else self.load
        self._perm = np.lexsort(
            (np.arange(self.num_partitions), key)
        ).astype(np.int64)
        self._perm_load = self.load.copy()
        self._perm_cost_aware = cost_aware
        self.stats["ledger_sorts"] += 1
        return self._perm

    def _route_microbatch(self, ptr, nodes, balance: bool) -> RoutedBatch:
        reg = _obs.registry()
        t0 = time.perf_counter() if reg.active else 0.0
        if balance:
            # rows ascending by (ledger load, id): the engine's lowest-row-id
            # tie-break becomes "least-loaded maximal-gain partition"
            order = self._ledger_perm()
            cov = batched_cover_csr(
                ptr, nodes, self.member[order], with_pin_parts=True,
                device=self.device,
            )
            cover_parts = order[cov.cover_parts]
            pin_parts = order[cov.pin_parts]
        else:
            cov = batched_cover_csr(
                ptr, nodes, self.member, with_pin_parts=True,
                device=self.device,
            )
            cover_parts = cov.cover_parts
            pin_parts = cov.pin_parts
        if len(cover_parts):
            self.load += np.bincount(
                cover_parts, minlength=self.num_partitions
            )
        self.stats["served_queries"] += len(ptr) - 1
        self.stats["microbatches"] += 1
        if reg.active:
            t1 = time.perf_counter()
            reg.observe("router_microbatch_seconds", t1 - t0)
            reg.inc("router_served_queries_total", len(ptr) - 1)
            reg.inc("router_microbatches_total")
            # live reference: copied out lazily at snapshot time
            reg.gauge_vector("router_partition_load").set(self.load)
            tr = _obs.tracer()
            if tr.active:
                tr.complete("serve.microbatch", t0, t1,
                            queries=len(ptr) - 1,
                            span_sum=int(cov.spans.sum()))
        return RoutedBatch(cov.spans, cov.cover_ptr, cover_parts, pin_parts,
                           ptr, nodes)

    # ------------------------------------------------------------- accessors
    def load_imbalance(self) -> float:
        """max / mean of the access-load ledger (1.0 = perfectly spread)."""
        m = self.load.mean()
        return float(self.load.max() / m) if m > 0 else 0.0

    def as_placement(self, capacity: float, node_weights) -> Placement:
        return Placement(self.member, capacity, np.asarray(node_weights))

"""Production placement API.

Wraps the paper's algorithms behind a serializable, hierarchical service:

  * PlacementPlan   — fitted result; JSON-serializable; answers
    `partitions_of(item)`, `select(query)` (greedy-set-cover replica
    selection), span statistics (batched engine on the plan's device).
  * PlacementService.fit        — one-level placement (paper §4), with an
    optional durability pass (`cluster.ensure_durability`).
  * PlacementService.fit_sharded — cluster-scale fit through the
    `repro_torch.scale` pipeline (shard, per-shard fits, merge, boundary
    repair), with the same profile and durability handling.
  * PlacementService.fit_hierarchical — two-level pod/host placement: span
    is minimized at the pod level first, then per pod at the host level.
  * PlacementService.refit      — incremental re-placement when the workload
    drifts: LMBR warm-started from the current plan (new replicas only move
    into free space).  A ``dest_mask`` confines new copies to surviving
    partitions; ``as_migration=True`` returns the change as a paced
    `repro_torch.online.MigrationPlan`.
  * PlacementService.plan_migration — two plans diffed into a
    `MigrationPlan`.

A copy of the JAX package's ``core/placement_service.py``.  The service
takes ``device`` (default ``"cuda"``; raises without CUDA unless
``device="cpu"``) and passes it to every fit; a plan keeps it for its
span calls, and it is not part of the plan's JSON.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

from .. import flags as _flags
from .. import obs as _obs
from ..device import resolve as _resolve_device
from .algorithms import ALGORITHMS, lmbr
from .cluster import (
    NodeProfile,
    ensure_durability,
    normalize_capacity,
    validate_durability,
)
from .hypergraph import Hypergraph
from .setcover import (
    Placement,
    batched_spans_csr,
    cover_for_query,
    greedy_set_cover,
    queries_to_csr,
)

__all__ = ["PlacementPlan", "HierarchicalPlan", "PlacementService"]


@dataclasses.dataclass
class PlacementPlan:
    member: np.ndarray  # (N, V) bool
    capacity: "float | np.ndarray"  # scalar, or (N,) per-partition vector
    node_weights: np.ndarray
    algorithm: str
    # optional fitter diagnostics; never serialized, never
    # placement-semantic
    stats: dict | None = None
    # where `spans` runs the span engine; not serialized
    device: object = "cuda"

    # --------------------------------------------------------------- queries
    def partitions_of(self, item: int) -> np.ndarray:
        return np.flatnonzero(self.member[:, item])

    def select(self, query: Sequence[int]):
        """Replica selection: (partitions, items-read-from-each)."""
        return cover_for_query(np.asarray(query, dtype=np.int64), self.member)

    def span(self, query: Sequence[int]) -> int:
        """Greedy cover size of one query (duplicate ids are
        deduplicated like `Hypergraph` edges)."""
        return int(self.spans([query])[0])

    def spans(self, queries: Sequence[Sequence[int]]) -> np.ndarray:
        """Spans of many queries in one batched engine call on the plan's
        device."""
        ptr, nodes = queries_to_csr(
            [np.unique(np.asarray(q, dtype=np.int64)) for q in queries]
        )
        return batched_spans_csr(ptr, nodes, self.member, device=self.device)

    def avg_span(self, queries: Sequence[Sequence[int]]) -> float:
        return float(self.spans(queries).mean()) if len(queries) else 0.0

    def as_placement(self) -> Placement:
        return Placement(self.member, self.capacity, self.node_weights)

    @property
    def num_partitions(self) -> int:
        return self.member.shape[0]

    # --------------------------------------------------------- serialization
    def to_json(self) -> str:
        cap = self.capacity
        return json.dumps(
            dict(
                # heterogeneous vectors serialize as a per-partition list;
                # scalars stay a bare float (the historical wire format)
                capacity=(
                    np.asarray(cap, dtype=np.float64).tolist()
                    if isinstance(cap, np.ndarray) and cap.ndim
                    else float(cap)
                ),
                algorithm=self.algorithm,
                node_weights=self.node_weights.tolist(),
                partitions=[
                    np.flatnonzero(self.member[p]).tolist()
                    for p in range(self.member.shape[0])
                ],
                num_items=int(self.member.shape[1]),
            )
        )

    @staticmethod
    def from_json(s: str, device="cuda") -> "PlacementPlan":
        d = json.loads(s)
        member = np.zeros((len(d["partitions"]), d["num_items"]), dtype=bool)
        for p, items in enumerate(d["partitions"]):
            member[p, np.asarray(items, dtype=np.int64)] = True
        cap = d["capacity"]
        return PlacementPlan(
            member,
            # lists restore the per-partition vector (uniform ones collapse
            # back to the scalar path); bare numbers stay floats
            normalize_capacity(np.asarray(cap, dtype=np.float64))
            if isinstance(cap, list) else float(cap),
            np.asarray(d["node_weights"], dtype=np.float64),
            d["algorithm"],
            device=device,
        )


@dataclasses.dataclass
class HierarchicalPlan:
    """Two-level placement: pods then hosts-within-pod.

    host_member is the flat (num_pods*hosts_per_pod, V) matrix; global host id
    = pod * hosts_per_pod + local host."""

    pod_plan: PlacementPlan
    host_member: np.ndarray
    hosts_per_pod: int
    host_capacity: float
    node_weights: np.ndarray

    def select(self, query: Sequence[int]):
        return cover_for_query(
            np.asarray(query, dtype=np.int64), self.host_member
        )

    def spans(self, query: Sequence[int]) -> tuple[int, int]:
        """(pod_span, host_span) via hierarchical set cover: pods first, then
        hosts restricted to the chosen pods."""
        q = np.asarray(query, dtype=np.int64)
        pods = greedy_set_cover(q, self.pod_plan.member)
        host_rows = []
        for p in pods:
            lo = p * self.hosts_per_pod
            host_rows.extend(range(lo, lo + self.hosts_per_pod))
        sub = self.host_member[host_rows]
        hosts = greedy_set_cover(q, sub)
        return len(pods), len(hosts)

    def weighted_span(self, query, pod_weight: float = 8.0) -> float:
        """DCN hops are ~pod_weight x pricier than ICI hops."""
        ps, hs = self.spans(query)
        return pod_weight * (ps - 1) + (hs - 1)


class PlacementService:
    def __init__(self, algorithm: str = "lmbr", seed: int = 0, nruns: int = 2,
                 device="cuda"):
        if algorithm not in ALGORITHMS:
            raise KeyError(f"unknown algorithm {algorithm!r}; have {list(ALGORITHMS)}")
        self.algorithm = algorithm
        self.seed = seed
        self.nruns = nruns
        self.device = _resolve_device(device)

    # ------------------------------------------------------------- profiles
    @staticmethod
    def _resolve_profile(profile, num_partitions, capacity):
        """(capacity, profile) from the scalar-or-profile surface.  A
        profile supplies (and must agree on) the partition count; its
        capacity normalizes to the scalar float when uniform."""
        if profile is None:
            return capacity, None
        if profile.num_partitions != num_partitions:
            raise ValueError(
                f"profile has {profile.num_partitions} partitions, "
                f"want {num_partitions}"
            )
        if capacity is not None and not np.array_equal(
            np.asarray(capacity, dtype=np.float64),
            np.asarray(normalize_capacity(profile.capacity)),
        ):
            raise ValueError("capacity and profile.capacity disagree")
        return profile.capacity_arg(), profile

    def _apply_durability(self, pl, profile, num_partitions, capacity,
                          durability_eps):
        """Post-fit durability pass (``flags.durability_eps`` or the
        explicit argument): greedily copy under-replicated items onto
        low-fail-prob partitions until every item meets the ceiling, then
        re-validate both capacity and the ceiling."""
        eps = (float(_flags.FLAGS.get("durability_eps", 0.0))
               if durability_eps is None else float(durability_eps))
        if eps <= 0:
            return
        prof = profile if profile is not None else NodeProfile.homogeneous(
            num_partitions, float(np.min(np.asarray(capacity)))
        )
        touched = ensure_durability(pl, prof, eps)
        pl.validate()
        validate_durability(pl, prof, eps)
        if pl.stats is not None:
            pl.stats["durability_copies"] = int(len(touched))
        _obs.registry().inc("durability_copies_total", len(touched))

    # ------------------------------------------------------------------ fit
    def fit(
        self,
        queries: Sequence[Sequence[int]],
        num_items: int,
        num_partitions: int,
        capacity: float | None = None,
        node_weights: np.ndarray | None = None,
        query_weights: np.ndarray | None = None,
        profile: NodeProfile | None = None,
        durability_eps: float | None = None,
    ) -> PlacementPlan:
        capacity, profile = self._resolve_profile(
            profile, num_partitions, capacity
        )
        if capacity is None:
            raise ValueError("pass capacity or a NodeProfile")
        hg = Hypergraph.from_edges(
            queries, num_nodes=num_items,
            node_weights=node_weights, edge_weights=query_weights,
        )
        fn = ALGORITHMS[self.algorithm]
        algo_kwargs = {}
        if profile is not None:
            # the LMBR engine's optional access-cost penalty; other
            # algorithms swallow the kwarg
            algo_kwargs["node_cost"] = profile.access_cost
        with _obs.tracer().span("service.fit", algorithm=self.algorithm,
                                n=num_partitions):
            pl = fn(hg, num_partitions, capacity, seed=self.seed,
                    nruns=self.nruns, device=self.device, **algo_kwargs)
        pl.validate()
        self._apply_durability(
            pl, profile, num_partitions, capacity, durability_eps
        )
        return PlacementPlan(
            pl.member, capacity, hg.node_weights, self.algorithm,
            stats=pl.stats, device=self.device,
        )

    # -------------------------------------------------------------- sharded
    def fit_sharded(
        self,
        workload,
        num_partitions: int,
        capacity: float | None = None,
        num_items: int | None = None,
        node_weights: np.ndarray | None = None,
        query_weights: np.ndarray | None = None,
        num_shards: int | None = None,
        workers: int | None = None,
        boundary_repair: int | None = None,
        profile: NodeProfile | None = None,
        durability_eps: float | None = None,
        **algo_kwargs,
    ) -> PlacementPlan:
        """Cluster-scale fit through the `repro_torch.scale` pipeline.

        ``workload`` is either a built `Hypergraph` (the streaming-ingestion
        path — e.g. `StreamingHypergraphBuilder.build()`) or a query list as
        `fit` takes.  ``num_shards`` / ``workers`` / ``boundary_repair``
        default to ``flags.FLAGS["scale_shards" / "scale_workers" /
        "scale_boundary_repair"]``.  The result is deterministic for fixed
        inputs and seed regardless of worker count (serial and pooled
        execution are bit-identical), and the returned plan carries the
        pipeline diagnostics in ``.stats`` (shards, boundary_edges,
        boundary_cost, per-stage seconds, ...).  The fits run on the
        service's device, pooled workers included."""
        from ..scale import fit_sharded_placement

        capacity, profile = self._resolve_profile(
            profile, num_partitions, capacity
        )
        if capacity is None:
            raise ValueError("pass capacity or a NodeProfile")
        if isinstance(workload, Hypergraph):
            hg = workload
            if node_weights is not None or query_weights is not None:
                raise ValueError(
                    "pass weights inside the Hypergraph, not alongside it"
                )
        else:
            hg = Hypergraph.from_edges(
                workload, num_nodes=num_items,
                node_weights=node_weights, edge_weights=query_weights,
            )
        with _obs.tracer().span("service.fit_sharded",
                                algorithm=self.algorithm, n=num_partitions):
            res = fit_sharded_placement(
                hg, num_partitions, capacity, algorithm=self.algorithm,
                seed=self.seed, nruns=self.nruns, num_shards=num_shards,
                workers=workers, boundary_repair=boundary_repair,
                device=self.device, **algo_kwargs,
            )
        res.placement.validate()
        self._apply_durability(
            res.placement, profile, num_partitions, capacity, durability_eps
        )
        return PlacementPlan(
            res.placement.member, normalize_capacity(capacity),
            hg.node_weights, f"{self.algorithm}+sharded", stats=res.stats,
            device=self.device,
        )

    # -------------------------------------------------------------- 2-level
    def fit_hierarchical(
        self,
        queries: Sequence[Sequence[int]],
        num_items: int,
        num_pods: int,
        hosts_per_pod: int,
        host_capacity: float,
        node_weights: np.ndarray | None = None,
    ) -> HierarchicalPlan:
        pod_capacity = host_capacity * hosts_per_pod
        pod_plan = self.fit(
            queries, num_items, num_pods, pod_capacity, node_weights
        )
        hg = Hypergraph.from_edges(queries, num_nodes=num_items,
                                   node_weights=node_weights)
        host_member = np.zeros(
            (num_pods * hosts_per_pod, num_items), dtype=bool
        )
        fn = ALGORITHMS[self.algorithm]
        for pod in range(num_pods):
            pod_items = np.flatnonzero(pod_plan.member[pod])
            if len(pod_items) == 0:
                continue
            # queries restricted to this pod's replica of their items
            local_queries = []
            mask = np.zeros(num_items, dtype=bool)
            mask[pod_items] = True
            for e in range(hg.num_edges):
                q = hg.edge(e)
                lq = q[mask[q]]
                if len(lq) >= 2:
                    local_queries.append(lq)
            remap = np.full(num_items, -1, dtype=np.int64)
            remap[pod_items] = np.arange(len(pod_items))
            sub_hg = Hypergraph.from_edges(
                [remap[q] for q in local_queries] or [[]],
                num_nodes=len(pod_items),
                node_weights=hg.node_weights[pod_items],
            )
            # the algorithms swallow unknown kwargs, so device is passed
            # by name here as in `fit`
            sub_pl = fn(
                sub_hg, hosts_per_pod, host_capacity,
                seed=self.seed + pod, nruns=self.nruns, device=self.device,
            )
            for h in range(hosts_per_pod):
                host_member[pod * hosts_per_pod + h, pod_items] = sub_pl.member[h]
        return HierarchicalPlan(
            pod_plan, host_member, hosts_per_pod, host_capacity, hg.node_weights
        )

    # ---------------------------------------------------------------- refit
    def refit(
        self,
        plan: PlacementPlan,
        queries: Sequence[Sequence[int]],
        max_moves: int = 64,
        dest_mask: np.ndarray | None = None,
        profile: NodeProfile | None = None,
        as_migration: bool = False,
    ):
        """Incremental adaptation to workload drift: LMBR warm-started from
        the current placement; only copies items into free space (existing
        replicas never move).  ``dest_mask`` ((N,) bool) excludes partitions
        from receiving copies (the outage path).  A ``profile`` supplies
        the access-cost vector for the engine's optional
        ``node_cost_weight`` penalty.

        ``as_migration=True`` returns the change as a
        `repro_torch.online.MigrationPlan` (pacing from the ``migration_*``
        flags, ``.target`` carrying the new `PlacementPlan`) instead of a
        plan to swap atomically: a warm-started refit only adds replicas,
        so the schedule is pure copies."""
        hg = Hypergraph.from_edges(
            queries, num_nodes=plan.member.shape[1],
            node_weights=plan.node_weights,
        )
        with _obs.tracer().span("service.refit", max_moves=max_moves):
            pl = lmbr(
                hg, plan.num_partitions, plan.capacity,
                seed=self.seed, initial=plan.as_placement(),
                max_moves=max_moves, dest_mask=dest_mask,
                node_cost=profile.access_cost if profile is not None else None,
                device=self.device,
            )
        pl.validate()
        new_plan = PlacementPlan(
            pl.member, plan.capacity, plan.node_weights,
            f"{plan.algorithm}+refit", stats=pl.stats, device=self.device,
        )
        if as_migration:
            return self.plan_migration(plan, new_plan)
        return new_plan

    def plan_migration(
        self,
        old_plan: PlacementPlan,
        new_plan: PlacementPlan,
        bandwidth: float | None = None,
        concurrency: int | None = None,
        headroom: float | None = None,
    ):
        """Diff two plans into a `repro_torch.online.MigrationPlan`
        (deterministic copies-before-drops transfer schedule; pacing
        defaults to the ``migration_*`` flags).  The returned plan's
        ``.target`` is ``new_plan``."""
        from ..online.migration import plan_migration as _plan_migration

        return _plan_migration(
            old_plan, new_plan, node_weights=new_plan.node_weights,
            bandwidth=bandwidth, concurrency=concurrency, headroom=headroom,
            target=new_plan,
        )

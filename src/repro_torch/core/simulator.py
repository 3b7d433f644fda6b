"""Trace-driven simulation (paper §5): place once, replay the trace, or
serve it online.

Instantiates N partitions of capacity C, runs a placement algorithm, then
replays a query trace measuring: span profile, per-partition load, active
machines, estimated communication bytes, and estimated energy.  The
replay (`run`) is one batched greedy cover of the whole trace;
`run_online` serves it through the streaming router of
``repro_torch.online`` with failure, migration and drift events.

Energy model (affine, after the paper's fig. 1/5 measurements):

    E(query) = e_work * W + e_machine * span + e_net * bytes_shipped

with bytes_shipped = item sizes read from non-coordinator partitions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from .. import obs as _obs
from ..device import resolve as _resolve_device
from . import hpa as hpa_mod
from .cluster import (
    DEFAULT_POWER_ACTIVE, DEFAULT_POWER_IDLE, NodeProfile, normalize_capacity,
)
from .hypergraph import Hypergraph
from .setcover import Placement, batched_cover_csr

__all__ = ["SimulationResult", "Simulator", "EnergyModel"]


@dataclasses.dataclass
class EnergyModel:
    e_work_per_gb: float = 120.0  # J per GB scanned (CPU+IO)
    e_machine: float = 250.0      # J per activated machine per query
    e_net_per_gb: float = 60.0    # J per GB shipped cross-machine

    def query_energy(self, scanned_gb: float, span: int, shipped_gb: float) -> float:
        return (
            self.e_work_per_gb * scanned_gb
            + self.e_machine * span
            + self.e_net_per_gb * shipped_gb
        )

    def cluster_power(self, loads: np.ndarray,
                      profile: NodeProfile | None = None) -> float:
        """Steady-state cluster draw (W): a loaded partition bills its
        active power, an empty one its idle (powered-down) draw."""
        active = np.asarray(loads, dtype=np.float64) > 0
        if profile is not None:
            return float(
                np.where(active, profile.power_active,
                         profile.power_idle).sum()
            )
        return float(
            active.sum() * DEFAULT_POWER_ACTIVE
            + (~active).sum() * DEFAULT_POWER_IDLE
        )


@dataclasses.dataclass
class SimulationResult:
    algorithm: str
    spans: np.ndarray               # (NQ,) spans of the replayed queries
    loads: np.ndarray               # (N,) storage load (weight)
    access_load: np.ndarray         # (N,) #query-accesses per partition
    energy_joules: float
    shipped_gb: float
    placement_seconds: float
    replication_factor: float
    placement_stats: dict | None = None  # fitter diagnostics (Placement.stats)
    online_stats: dict | None = None     # serving counters (run_online)
    active_machines: int = 0             # partitions holding any data
    cluster_power_w: float = 0.0         # steady-state draw (EnergyModel)
    member: np.ndarray | None = None     # (N, V) fitted (run) or final
                                         # live (run_online) membership

    @property
    def avg_span(self) -> float:
        return float(self.spans.mean()) if len(self.spans) else 0.0

    @property
    def max_span(self) -> int:
        return int(self.spans.max()) if len(self.spans) else 0

    @property
    def load_imbalance(self) -> float:
        """max access load / mean access load (1.0 = perfectly balanced)."""
        m = self.access_load.mean()
        return float(self.access_load.max() / m) if m > 0 else 0.0

    def summary(self) -> dict:
        out = dict(
            algorithm=self.algorithm,
            avg_span=round(self.avg_span, 4),
            max_span=self.max_span,
            energy_kj=round(self.energy_joules / 1e3, 2),
            shipped_gb=round(self.shipped_gb, 3),
            rf=round(self.replication_factor, 3),
            placement_s=round(self.placement_seconds, 3),
            load_imbalance=round(self.load_imbalance, 3),
            active_machines=int(self.active_machines),
            cluster_power_w=round(self.cluster_power_w, 1),
        )
        if self.placement_stats:
            # fitter-side counters (e.g. LMBR moves / gain-cache hit rate)
            out.update(
                {f"fit_{k}": v for k, v in self.placement_stats.items()}
            )
        if self.online_stats:
            # serving-side counters (router / drift / failover / migration)
            out.update(self.online_stats)
        return out


def _traffic_gb(edge_ptr, edge_nodes, spans, cover_ptr, cover_parts,
                pin_parts, node_weights, item_gb):
    """Per-query (scanned_gb, shipped_gb) from a batched cover: the
    coordinator is the first chosen partition, every other cover member
    ships the bytes it serves."""
    w_pins = node_weights[edge_nodes]
    cw = np.concatenate([[0.0], np.cumsum(w_pins)])
    scanned = (cw[edge_ptr[1:]] - cw[edge_ptr[:-1]]) * item_gb
    first = np.full(len(edge_ptr) - 1, -1, dtype=np.int64)
    nz = spans > 0
    first[nz] = cover_parts[cover_ptr[:-1][nz]]
    local_w = np.where(
        pin_parts == np.repeat(first, np.diff(edge_ptr)), w_pins, 0.0,
    )
    cl = np.concatenate([[0.0], np.cumsum(local_w)])
    shipped = scanned - (cl[edge_ptr[1:]] - cl[edge_ptr[:-1]]) * item_gb
    return scanned, shipped


class Simulator:
    """Paper §5's simulator: place once, replay the trace (`run`), or serve
    it online through the streaming router with failure, migration and
    drift events (`run_online`).  Kernel work runs on ``device`` (default
    ``"cuda"``; raises when CUDA is absent unless ``device="cpu"`` is
    passed)."""

    def __init__(
        self,
        num_partitions: int,
        capacity: "float | np.ndarray | None" = None,
        energy_model: EnergyModel | None = None,
        item_gb: float = 1.0,
        profile: NodeProfile | None = None,
        device="cuda",
    ):
        self.device = _resolve_device(device)
        self.n = num_partitions
        if capacity is None:
            if profile is None:
                raise ValueError("pass capacity or a NodeProfile")
            capacity = profile.capacity_arg()
        elif isinstance(capacity, np.ndarray):
            capacity = normalize_capacity(capacity)
        self.capacity = capacity
        self.profile = profile
        self.energy = energy_model or EnergyModel()
        self.item_gb = item_gb  # GB per unit of item weight

    def run(
        self,
        hg: Hypergraph,
        algorithm: Callable[..., Placement],
        name: str | None = None,
        trace: Hypergraph | None = None,
        validate: bool = True,
        **algo_kwargs,
    ) -> SimulationResult:
        """Fit `algorithm` on workload `hg`, then replay `trace` (defaults to
        the training workload itself — the paper replays the same trace)."""
        algo_name = name or getattr(algorithm, "__name__", "custom")
        # fresh partition memo per run: each algorithm pays for its own
        # hpa.partition work, so placement_seconds is run-order independent
        with hpa_mod.fresh_partition_cache():
            with _obs.timed("fit.place", algorithm=algo_name) as _t:
                pl = algorithm(hg, self.n, self.capacity, device=self.device,
                               **algo_kwargs)
            dt = _t.seconds
        if validate:
            pl.validate()
        replay = trace if trace is not None else hg
        # one batched greedy cover for the whole trace (replica selection for
        # every query at once); pin_parts is the per-item serving partition
        with _obs.tracer().span("replay.cover", queries=replay.num_edges):
            cov = batched_cover_csr(
                replay.edge_ptr, replay.edge_nodes, pl.member,
                with_pin_parts=True, device=self.device,
            )
        spans = cov.spans
        access_load = np.bincount(
            cov.cover_parts, minlength=self.n
        ).astype(np.float64)
        scanned, shipped = _traffic_gb(
            replay.edge_ptr, replay.edge_nodes, spans, cov.cover_ptr,
            cov.cover_parts, cov.pin_parts, hg.node_weights, self.item_gb,
        )
        total_shipped = float(shipped.sum())
        total_energy = float(
            self.energy.query_energy(scanned, spans, shipped).sum()
        )
        loads = pl.partition_weights()
        return SimulationResult(
            algorithm=algo_name,
            spans=spans,
            loads=loads,
            access_load=access_load,
            energy_joules=total_energy,
            shipped_gb=total_shipped,
            placement_seconds=dt,
            replication_factor=pl.replication_factor(),
            placement_stats=pl.stats,
            active_machines=int((loads > 0).sum()),
            cluster_power_w=self.energy.cluster_power(loads, self.profile),
            member=pl.member,
        )

    def run_online(
        self,
        hg: Hypergraph,
        algorithm: Callable[..., Placement],
        name: str | None = None,
        trace: Hypergraph | None = None,
        events=None,
        service=None,
        refit_moves: int = 256,
        repair_k: int = 1,
        auto_repair: bool = True,
        validate: bool = True,
        health=None,
        on_alert=None,
        **algo_kwargs,
    ) -> SimulationResult:
        """Event-capable online replay: fit once, then SERVE the trace
        through the streaming router (`repro_torch.online.ReplicaRouter`,
        on ``self.device``) in microbatches of
        ``flags.FLAGS["router_microbatch"]``.

        ``events`` is an iterable of ``(query_index, kind, arg)`` applied
        just before the query at that trace position is served:

          * ``("down", p)`` — partition p fails (membership row masked); with
            ``auto_repair`` the failover manager immediately re-replicates
            items that fell below ``repair_k`` live copies into surviving
            free space (span-aware gain).  Queries that still reference an
            uncovered item are counted ``degraded_queries``, not served.
          * ``("up", p)`` — p's saved replicas come back.
          * ``("repair", k)`` — explicit repair pass to k live copies.
          * ``("migrate", target)`` — begin migrating the live layout onto
            ``target`` (a `PlacementPlan` / `Placement` / bool member
            matrix, or a prebuilt `MigrationPlan`).  With
            ``flags.FLAGS["migration_bandwidth"]`` == 0 (the default) the
            diff applies instantly between microbatches; > 0 streams it as
            bandwidth-paced replica transfers (one tick per served query)
            while queries keep routing against the union layout, old
            replicas dropped only after every new copy of their item has
            landed.  A dead transfer destination holds its copies (and the
            drops waiting on them) until it returns, and a paced migration
            may START during an outage: the diff is taken against the
            post-restore layout.

        Passing a `PlacementService` as ``service`` arms the drift detector:
        after each microbatch the windowed avg span is compared against the
        fit-time baseline and a regression past
        ``flags.FLAGS["drift_threshold"]`` triggers an incremental refit on
        the sketch window, hot-swapped into the router between microbatches
        (or streamed as a paced migration when ``migration_bandwidth`` > 0).
        During an outage the refit runs on the failure-masked surviving
        layout.  The result's ``spans`` cover the served queries only,
        ``member`` is the final live layout, and ``summary()`` carries the
        serving counters.

        The router, the failover manager, the migration executor and the
        detector's plan share ONE numpy member matrix: masking, repair
        copies and landed transfers are in-place edits that the next
        microbatch sees.

        ``health`` (a `repro_torch.obs.HealthMonitor`, or one built from
        the flags under ``obs_health``) observes every periodic registry
        snapshot, on the attempted-queries time axis; ``on_alert(alert,
        firing)`` receives its transitions.  It needs ``obs_level`` other
        than ``"off"`` and ``obs_snapshot_every`` > 0, reads only, and adds
        ``alerts_fired`` / ``alerts_resolved`` to the serving counters."""
        from .. import flags as _flags
        from ..online import DriftDetector, FailoverManager, ReplicaRouter
        from ..online.migration import (
            MigrationExecutor,
            MigrationPlan,
            plan_migration,
        )
        from .placement_service import PlacementPlan
        from .setcover import batched_spans_csr

        algo_name = name or getattr(algorithm, "__name__", "custom")
        with hpa_mod.fresh_partition_cache():
            with _obs.timed("fit.place", algorithm=algo_name) as _t:
                pl = algorithm(hg, self.n, self.capacity, device=self.device,
                               **algo_kwargs)
            dt = _t.seconds
        if validate:
            pl.validate()
        replay = trace if trace is not None else hg
        # the live layout: plan, router and failover manager SHARE the
        # member matrix, so masking/repair is visible to the next microbatch
        live = Placement(pl.member, self.capacity, pl.node_weights)
        router = ReplicaRouter(
            live.member,
            node_cost=(self.profile.routing_cost()
                       if self.profile is not None else None),
            device=self.device,
        )
        failover = FailoverManager(live, profile=self.profile)

        _fit_base: list = []  # lazy cache: detector AND health share it

        def _fit_baseline() -> float:
            if not _fit_base:
                _fit_base.append(float(batched_spans_csr(
                    hg.edge_ptr, hg.edge_nodes, pl.member,
                    device=self.device,
                ).mean()) if hg.num_edges else 0.0)
            return _fit_base[0]

        detector = None
        if service is not None:
            detector = DriftDetector(
                PlacementPlan(pl.member, self.capacity, pl.node_weights,
                              algo_name, device=self.device),
                service, refit_moves=refit_moves,
            )
            detector.set_baseline(_fit_baseline())

        migrator: MigrationExecutor | None = None
        migration_ticks = 0
        mig_totals = dict(
            migrations=0, migration_copies=0, migration_drops=0,
            transferred=0.0, wasted=0.0, max_inflight=0.0,
        )

        def _fold_migration_stats(ex: MigrationExecutor) -> None:
            nonlocal migration_ticks
            migration_ticks += ex.now
            mig_totals["migration_copies"] += ex.stats["copies_done"]
            mig_totals["migration_drops"] += ex.stats["drops_done"]
            mig_totals["transferred"] += ex.stats["migration_transferred"]
            mig_totals["wasted"] += ex.stats["migration_wasted"]
            mig_totals["max_inflight"] = max(
                mig_totals["max_inflight"], ex.stats["max_inflight"]
            )

        def _finish_migration() -> None:
            # transfers landed in-place in the shared live matrix; count the
            # completed swap, re-sync the failover load ledger, and point the
            # drift detector's warm-start plan at the (now target) layout
            nonlocal migrator
            _fold_migration_stats(migrator)
            migrator = None
            failover.resync_loads()
            router.swap_plan(live.member)
            if detector is not None:
                detector.plan.member = live.member

        def _start_migration(target) -> None:
            nonlocal migrator
            if migrator is not None:
                raise ValueError(
                    "a migration is already in flight; issue the next "
                    "migrate event after it completes"
                )
            if isinstance(target, MigrationPlan):
                mplan = target
            else:
                member = getattr(target, "member", target)
                # diff against the post-restore view: a down partition's
                # saved row comes back verbatim on 'up', so its stale
                # replicas need scheduled (deferred) drops, not silence
                old = (failover.restored_member()
                       if failover.down_partitions else live.member)
                mplan = plan_migration(
                    old, member, node_weights=live.node_weights,
                )
            mig_totals["migrations"] += 1
            if mplan.bandwidth <= 0 or mplan.is_noop:
                # atomic hot-swap between microbatches
                down = failover.down_partitions
                if len(down) and (
                    np.isin(mplan.copy_dest, down).any()
                    or np.isin(mplan.drop_part, down).any()
                ):
                    raise ValueError(
                        "instant migrate touches a down partition; set "
                        "migration_bandwidth > 0 to pace it through the "
                        "outage instead"
                    )
                mplan.apply(live.member)
                mig_totals["migration_copies"] += mplan.num_copies
                mig_totals["migration_drops"] += mplan.num_drops
                mig_totals["transferred"] += mplan.bytes_to_move(
                    live.node_weights
                )
                failover.resync_loads()
                router.swap_plan(live.member)
                if detector is not None:
                    detector.plan.member = live.member
            else:
                # partitions already down at migration start are seeded so
                # their copies/drops defer exactly like mid-flight failures
                migrator = MigrationExecutor(
                    mplan, live, down=failover.down_partitions
                )
                _obs.tracer().event(
                    "migration.start", copies=mplan.num_copies,
                    drops=mplan.num_drops,
                )

        def _repair_workload() -> Hypergraph:
            # repair against the live window when the sketch has traffic,
            # else against the fit workload
            if detector is not None and len(detector.sketch):
                return detector.sketch.to_hypergraph()
            return hg

        def _repair(k: int) -> None:
            if migrator is not None:
                failover.resync_loads()  # landed copies bypass the ledger
            failover.repair(_repair_workload(), k=k)
            if migrator is not None:
                migrator.refresh_loads()  # repair copies bypass the executor

        def _apply(kind: str, arg) -> None:
            if kind == "down":
                failover.partition_down(int(arg))
                if migrator is not None:
                    migrator.on_partition_down(int(arg))
                if auto_repair:
                    _repair(repair_k)
            elif kind == "up":
                failover.partition_up(int(arg))
                if migrator is not None:
                    migrator.on_partition_up(int(arg))
            elif kind == "repair":
                _repair(int(arg) if arg else repair_k)
            elif kind == "migrate":
                _start_migration(arg)
            else:
                raise ValueError(f"unknown online event kind {kind!r}")

        ev = sorted(
            ((int(at), kind, arg) for at, kind, arg in (events or [])),
            key=lambda t: t[0],
        )
        ev_i = 0
        nq = replay.num_edges
        mb = max(1, int(_flags.FLAGS.get("router_microbatch", 384)))
        pos = 0
        degraded = 0
        span_total = 0
        spans_parts: list[np.ndarray] = []
        total_energy = 0.0
        total_shipped = 0.0

        # periodic metrics snapshot every obs_snapshot_every served queries
        # (registry gauges always; a Chrome-trace counter event when tracing)
        snap_every = int(_flags.FLAGS.get("obs_snapshot_every", 0))
        _reg = _obs.registry()
        next_snap = snap_every if (snap_every > 0 and _reg.active) else 0

        # health monitoring rides on the periodic snapshots: flags-armed
        # construction here, or a caller-supplied monitor (inspectable
        # after the run).  It evaluates between microbatches and changes
        # no serving state.
        if health is None and bool(_flags.FLAGS.get("obs_health", False)):
            from ..obs.health import HealthMonitor

            health = HealthMonitor.from_flags(on_alert=on_alert)
        if health is not None:
            if on_alert is not None and health.on_alert is None:
                health.on_alert = on_alert
            if not _reg.active or snap_every <= 0:
                raise ValueError(
                    "health monitoring needs obs_level != 'off' and "
                    "obs_snapshot_every > 0 (the monitor consumes the "
                    "periodic registry snapshots)"
                )
            if health.baseline_span is None:
                health.set_baseline(_fit_baseline())

        def _emit_snapshot() -> None:
            served = int(router.stats["served_queries"])
            _reg.set("online_served_queries", served)
            _reg.set("online_degraded_queries", degraded)
            _reg.set("online_span_sum", float(span_total))
            _reg.gauge_vector("online_partition_load").set(router.load.copy())
            inflight = (migrator.inflight_bytes if migrator is not None
                        else 0.0)
            _reg.set("migration_inflight", inflight)
            tr = _obs.tracer()
            if tr.active:
                tr.counter(
                    "online.snapshot", served=served, degraded=degraded,
                    migration_inflight=inflight,
                    windowed_avg_span=(detector.windowed_avg_span
                                       if detector is not None else 0.0),
                )
            if health is not None:
                # deterministic time axis: attempted queries, so windows
                # and rates are reproducible run to run
                health.observe(_reg.snapshot(), t=float(served + degraded))

        while pos < nq:
            while ev_i < len(ev) and ev[ev_i][0] <= pos:
                _apply(ev[ev_i][1], ev[ev_i][2])
                ev_i += 1
            stop = min(pos + mb, nq)
            if ev_i < len(ev):
                stop = min(stop, max(ev[ev_i][0], pos + 1))
            ptr = replay.edge_ptr[pos: stop + 1] - replay.edge_ptr[pos]
            nodes = replay.edge_nodes[
                replay.edge_ptr[pos]: replay.edge_ptr[stop]
            ]
            ok = failover.serveable_mask(ptr, nodes)
            if not ok.all():
                degraded += int((~ok).sum())
                sptr, sidx = Hypergraph(
                    ptr, nodes, live.node_weights,
                    np.ones(len(ptr) - 1),
                ).pin_indices(np.flatnonzero(ok))
                ptr, nodes = sptr, nodes[sidx]
            batch = router.route_csr(ptr, nodes)
            spans_parts.append(batch.spans)
            if next_snap:  # running span sum only feeds snapshot gauges
                span_total += int(batch.spans.sum())
            scanned, shipped = _traffic_gb(
                batch.edge_ptr, batch.edge_nodes, batch.spans,
                batch.cover_ptr, batch.cover_parts, batch.pin_parts,
                live.node_weights, self.item_gb,
            )
            total_energy += float(
                self.energy.query_energy(scanned, batch.spans, shipped).sum()
            )
            total_shipped += float(shipped.sum())
            if migrator is not None:
                # one migration tick per served query: transfers pace
                # against traffic, so bandwidth is "bytes per query"
                migrator.advance(stop - pos)
                if migrator.done:
                    _finish_migration()
            if detector is not None:
                detector.observe(
                    [nodes[ptr[i]: ptr[i + 1]] for i in range(len(ptr) - 1)],
                    batch.spans,
                )
                # hot-swap between microbatches.  During an outage the refit
                # runs on the failure-masked layout with the down rows
                # excluded from receiving copies (dest_mask) — skipped only
                # while coverage is still broken (a refit cannot warm-start
                # from a layout with unplaced items) or while a migration is
                # in flight (the live layout is a union, not a fit result).
                if migrator is None and detector.should_refit():
                    down = failover.down_partitions
                    if not down:
                        new_plan = detector.refit()
                    elif len(failover.uncovered_items()) == 0:
                        survivors = np.ones(self.n, dtype=bool)
                        survivors[down] = False
                        new_plan = detector.refit(dest_mask=survivors)
                    else:
                        new_plan = None
                    if new_plan is None:
                        pass
                    elif float(_flags.FLAGS["migration_bandwidth"]) > 0:
                        # pace the hot-swap: stream the refit diff as
                        # transfers; `live` keeps serving (union layout)
                        # and adopts the target in place as copies land
                        _start_migration(new_plan)
                    else:
                        router.swap_plan(new_plan.member)
                        live = new_plan.as_placement()
                        failover.rebase(live)
            if next_snap and router.stats["served_queries"] >= next_snap:
                _emit_snapshot()
                while next_snap <= router.stats["served_queries"]:
                    next_snap += snap_every
            pos = stop
        while ev_i < len(ev):  # events scheduled at/after the trace end
            _apply(ev[ev_i][1], ev[ev_i][2])
            ev_i += 1

        online_stats = dict(
            served_queries=int(router.stats["served_queries"]),
            microbatches=int(router.stats["microbatches"]),
            plan_swaps=int(router.stats["plan_swaps"]),
            degraded_queries=int(degraded),
            partitions_down=int(failover.stats["partitions_down"]),
            repaired_items=int(failover.stats["repaired_items"]),
            unrepairable_items=int(failover.stats["unrepairable_items"]),
        )
        if detector is not None:
            online_stats.update(
                drift_fires=int(detector.stats["drift_fires"]),
                refits=int(detector.stats["refits"]),
                windowed_avg_span=round(detector.windowed_avg_span, 4),
            )
        if health is not None:
            online_stats.update(
                alerts_fired=int(health.stats["alerts_fired"]),
                alerts_resolved=int(health.stats["alerts_resolved"]),
            )
        if mig_totals["migrations"]:
            if migrator is not None:  # trace ended mid-migration
                _fold_migration_stats(migrator)
            online_stats.update(
                migrations=int(mig_totals["migrations"]),
                migration_copies=int(mig_totals["migration_copies"]),
                migration_drops=int(mig_totals["migration_drops"]),
                migration_transfer_gb=round(
                    mig_totals["transferred"] * self.item_gb, 4
                ),
                migration_wasted_gb=round(
                    mig_totals["wasted"] * self.item_gb, 4
                ),
                migration_max_inflight_gb=round(
                    mig_totals["max_inflight"] * self.item_gb, 4
                ),
                migration_ticks=int(migration_ticks),
                migration_done=bool(migrator is None),
            )
        spans = (
            np.concatenate(spans_parts) if spans_parts
            else np.zeros(0, dtype=np.int64)
        )
        live = failover.pl  # the final hot-swapped layout
        final_loads = live.partition_weights()
        return SimulationResult(
            algorithm=algo_name,
            spans=spans,
            loads=final_loads,
            access_load=router.load.copy(),
            energy_joules=total_energy,
            shipped_gb=total_shipped,
            placement_seconds=dt,
            replication_factor=live.replication_factor(),
            placement_stats=pl.stats,
            online_stats=online_stats,
            active_machines=int((final_loads > 0).sum()),
            cluster_power_w=self.energy.cluster_power(
                final_loads, self.profile
            ),
            member=live.member,
        )

    def compare(
        self, hg: Hypergraph, algorithms: dict[str, Callable[..., Placement]],
        **kw,
    ) -> dict[str, SimulationResult]:
        """`run` of every algorithm of ``algorithms`` (name -> fitter) on
        ``hg``, in the mapping's order."""
        return {
            name: self.run(hg, fn, name=name, **kw)
            for name, fn in algorithms.items()
        }

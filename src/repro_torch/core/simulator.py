"""Trace-driven simulation (paper §5): place once, replay the trace.

Instantiates N partitions of capacity C, runs a placement algorithm, then
replays a query trace measuring: span profile, per-partition load, active
machines, estimated communication bytes, and estimated energy.  The
replay is one batched greedy cover of the whole trace.

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
    active_machines: int = 0             # partitions holding any data
    cluster_power_w: float = 0.0         # steady-state draw (EnergyModel)
    member: np.ndarray | None = None     # (N, V) fitted membership matrix

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
    """Paper §5's simulator: place once, replay the trace (`run`).  Kernel
    work runs on ``device`` (default ``"cuda"``; raises when CUDA is
    absent unless ``device="cpu"`` is passed)."""

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

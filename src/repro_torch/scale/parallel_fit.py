"""Parallel per-shard fits + deterministic merge + boundary repair.

The third stage of the cluster-scale pipeline: every `ShardSpec` from
`sharder.shard_workload` is an independent placement problem (its own
sub-hypergraph, partition slice, capacity), so the fits dispatch onto a
process pool (``flags.FLAGS["scale_workers"]``) or run serially, with
BIT-IDENTICAL results, because

  * each shard's fit is a pure function of (algorithm, shard CSR, seed) —
    the shard seed is ``seed + shard_index``, never pool-order dependent;
  * results are merged in shard-index order regardless of completion order;
  * the flags snapshot and the device ride along in the worker payload, so
    worker processes compute under the caller's exact configuration.

The pool SPAWNS its workers (a CUDA context does not survive a fork), and
each worker builds its own context on the caller's device and loads the
kernel library, which the parent builds first so that the workers do not
race the compiler.  A pool that was asked for and cannot start raises:
nothing falls back to the serial path on its own.

Merge: shard s's fit occupies global partition rows
``part_offset[s]:part_offset[s+1]`` and its local item ids map back through
``ShardSpec.items`` — the merged membership matrix is block-structured, one
block per shard.  Capacity reconciliation then re-derives every row's load
from the merged matrix and validates it against the global capacity.

Boundary repair: the merged plan has never seen the cross-shard edges, so a
bounded LMBR pass (``flags.FLAGS["scale_boundary_repair"]`` moves) runs on
the hypergraph of exactly those edges, warm-started from the merged
placement.  LMBR only ever COPIES items into free space under the capacity
check, so the pass is capacity-safe by construction.

A copy of the JAX package's ``scale/parallel_fit.py``.  The shard fits and
the repair run the span engine and the LMBR peel on ``device`` (default
``"cuda"``; raises without CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .. import flags as _flags
from .. import obs as _obs
from ..core.algorithms import ALGORITHMS, lmbr
from ..core.cluster import normalize_capacity
from ..core.hypergraph import Hypergraph
from ..core.setcover import Placement
from ..device import resolve as _resolve_device
from .sharder import ShardingPlan, shard_workload

__all__ = ["ShardedFitResult", "fit_sharded_placement"]


def _fit_shard_worker(payload: tuple) -> tuple[np.ndarray, dict | None]:
    """Top-level (picklable) per-shard fit: rebuild the shard hypergraph
    from raw CSR arrays, restore the caller's flags, run the algorithm on
    the caller's device."""
    (algo_name, flag_snapshot, device, edge_ptr, edge_nodes, node_w, edge_w,
     n_parts, capacity, seed, nruns, algo_kwargs) = payload
    _flags.FLAGS.update(flag_snapshot)
    hg = Hypergraph(edge_ptr, edge_nodes, node_w, edge_w)
    fn = ALGORITHMS[algo_name]
    pl = fn(hg, n_parts, capacity, seed=seed, nruns=nruns, device=device,
            **algo_kwargs)
    pl.validate()
    return pl.member, pl.stats


@dataclasses.dataclass
class ShardedFitResult:
    """A merged sharded fit plus the pipeline's diagnostics."""

    placement: Placement
    sharding: ShardingPlan
    stats: dict

    @property
    def member(self) -> np.ndarray:
        return self.placement.member


def _shard_payloads(sharding: ShardingPlan, algorithm: str, seed: int,
                    nruns: int, device: str,
                    algo_kwargs: dict) -> list[tuple | None]:
    snapshot = dict(_flags.FLAGS)
    payloads: list[tuple | None] = []
    for s, spec in enumerate(sharding.shards):
        if len(spec.items) == 0:
            payloads.append(None)  # empty shard: rows stay empty
            continue
        payloads.append((
            algorithm, snapshot, device,
            spec.sub_hg.edge_ptr, spec.sub_hg.edge_nodes,
            spec.sub_hg.node_weights, spec.sub_hg.edge_weights,
            spec.num_partitions, spec.capacity, seed + s, nruns,
            algo_kwargs,
        ))
    return payloads


def _run_fits(payloads, workers: int, device):
    """(results aligned with payloads, used_pool) — a spawned pool when
    workers > 1 and more than one shard has items, else the serial path."""
    live = [(i, p) for i, p in enumerate(payloads) if p is not None]
    results: list = [None] * len(payloads)
    if workers > 1 and len(live) > 1:
        if device.type == "cuda":
            from .. import _build

            _build.build()  # the workers load it; none of them compiles
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            outs = list(ex.map(_fit_shard_worker, [p for _, p in live]))
        for (i, _), out in zip(live, outs):
            results[i] = out
        return results, True
    for i, p in live:
        results[i] = _fit_shard_worker(p)
    return results, False


def fit_sharded_placement(
    hg: Hypergraph,
    num_partitions: int,
    capacity: "float | np.ndarray",
    algorithm: str = "lmbr",
    seed: int = 0,
    nruns: int = 2,
    num_shards: int | None = None,
    workers: int | None = None,
    boundary_repair: int | None = None,
    device="cuda",
    **algo_kwargs,
) -> ShardedFitResult:
    """The full pipeline: shard -> parallel per-shard fits -> merge ->
    bounded boundary repair.  Deterministic for fixed (inputs, seed)
    regardless of worker count."""
    if algorithm not in ALGORITHMS:
        raise KeyError(f"unknown algorithm {algorithm!r}")
    device = _resolve_device(device)
    capacity = normalize_capacity(capacity)
    if num_shards is None:
        num_shards = int(_flags.FLAGS.get("scale_shards", 0))
    if num_shards <= 0:
        num_shards = max(1, num_partitions // 8)
    if workers is None:
        workers = int(_flags.FLAGS.get("scale_workers", 1))
    if boundary_repair is None:
        boundary_repair = int(_flags.FLAGS.get("scale_boundary_repair", 256))

    with _obs.timed("scale.shard", shards=num_shards) as _t:
        sharding = shard_workload(hg, num_partitions, capacity, num_shards,
                                  seed=seed)
    t_shard = _t.seconds

    with _obs.timed("scale.fit", workers=workers) as _t:
        payloads = _shard_payloads(sharding, algorithm, seed, nruns,
                                   str(device), algo_kwargs)
        results, used_pool = _run_fits(payloads, workers, device)
    t_fit = _t.seconds

    # ------------------------------------------------------------- merge
    with _obs.timed("scale.merge") as _t:
        member = np.zeros((num_partitions, hg.num_nodes), dtype=bool)
        shard_moves = 0
        for s, out in enumerate(results):
            if out is None:
                continue
            sub_member, sub_stats = out
            lo = int(sharding.part_offset[s])
            rows = np.arange(sub_member.shape[0]) + lo
            member[np.ix_(rows, sharding.shards[s].items)] = sub_member
            if sub_stats:
                shard_moves += int(sub_stats.get("moves", 0))
        merged = Placement(member, capacity, hg.node_weights)
        # capacity reconciliation: re-derive loads from the merged matrix
        # and enforce the global budget (raises on any overflowing row)
        merged.validate()
    t_merge = _t.seconds

    # -------------------------------------------------- boundary repair
    with _obs.timed("scale.repair") as _t:
        repair_moves = 0
        if boundary_repair > 0 and len(sharding.boundary_edges):
            bhg = hg.subhypergraph_edges(sharding.boundary_edges)
            repaired = lmbr(
                bhg, num_partitions, capacity, seed=seed,
                initial=merged, max_moves=int(boundary_repair),
                device=device,
            )
            repaired.validate()
            repair_moves = int((repaired.stats or {}).get("moves", 0))
            merged = Placement(
                repaired.member, capacity, hg.node_weights
            )
    t_repair = _t.seconds

    merged.stats = dict(
        shards=sharding.num_shards,
        components=sharding.num_components,
        boundary_edges=int(len(sharding.boundary_edges)),
        boundary_cost=round(float(sharding.boundary_cost), 3),
        workers=int(workers), used_pool=bool(used_pool),
        shard_moves=shard_moves, repair_moves=repair_moves,
        shard_seconds=round(t_shard, 3), fit_seconds=round(t_fit, 3),
        merge_seconds=round(t_merge, 3), repair_seconds=round(t_repair, 3),
    )
    return ShardedFitResult(placement=merged, sharding=sharding,
                            stats=merged.stats)

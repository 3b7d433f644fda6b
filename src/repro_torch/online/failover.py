"""Span-aware failover: partition down/up masking, coverage audit, repair.

Replication exists for fault tolerance; the paper exploits it for
co-location.  This module closes the loop in the other direction: when a
partition dies, the layout loses both a fault domain and part of its
co-location structure, and the repair should restore the former without
squandering the latter.

`FailoverManager` wraps the LIVE `Placement` the router serves from (the
member matrix is mutated in place, so masking and repair are visible to the
next router microbatch):

* `partition_down(p)` saves p's membership row and zeroes it; queries then
  cover against surviving replicas only.  Items whose last replica lived on
  p are reported lost.
* `coverage_audit` / `serveable_mask` identify lost items and the queries
  that cannot be served until repair (the replay counts these as degraded
  rather than crashing the batched engine's unplaced-item ValueError).
* `repair(hg, k)` re-replicates under-replicated items into surviving free
  space by LMBR-style gain: items are processed hottest-first (descending
  weighted incident-edge degree, ties -> lowest item id) and each new copy
  goes to the surviving partition with the largest co-location benefit —
  the summed weight of the item's incident edges that already read another
  item from that partition — so repair copies land where they keep spans
  low.  Ties -> most free space, then lowest partition id; capacity is never
  exceeded (items that fit nowhere stay lost and are reported).

  The benefit vectors come from ONE batched numpy pass per
  repair *wave* (`_batched_benefits`: a single gather over every pending
  item's incident-edge pins + one `logical_or.reduceat` + one sequential
  scatter-add) instead of a per-item Python loop over edges.  Placement
  stays strictly sequential in the same hottest-first order, and a wave
  ends exactly when a just-placed copy could invalidate the next item's
  precomputed benefit (they share an edge) — so the batched path is
  BIT-IDENTICAL to the retained per-item reference (`repair_reference`).
* `partition_up(p)` restores the saved row (the replicas come back; repair
  copies made meanwhile simply remain as extra replicas).

A copy of the JAX package's failover module.  It is host work over the
shared numpy member matrix and takes no device: the benefit scatter stays
``np.add.at``, whose index-order accumulation keeps it bit-identical to
the per-edge oracle.
"""

from __future__ import annotations

import time

import numpy as np

from .. import obs as _obs
from ..core.cluster import NodeProfile
from ..core.hypergraph import Hypergraph
from ..core.setcover import Placement

__all__ = ["FailoverManager"]


class FailoverManager:
    def __init__(self, placement: Placement,
                 profile: NodeProfile | None = None):
        self.pl = placement
        self._saved: dict[int, np.ndarray] = {}
        self._loads = placement.partition_weights()
        # per-partition failure probability: repair prefers reliable
        # survivors among equal-benefit candidates.  Without a profile the
        # vector is constant, which degenerates the preference away —
        # bit-identical to the pre-profile tie-break.
        self._fail = (
            np.asarray(profile.fail_prob, dtype=np.float64)
            if profile is not None
            else np.zeros(placement.num_partitions, dtype=np.float64)
        )
        if len(self._fail) != placement.num_partitions:
            raise ValueError(
                f"profile has {len(self._fail)} partitions, placement has "
                f"{placement.num_partitions}"
            )
        self.stats = dict(
            partitions_down=0, repaired_items=0, unrepairable_items=0,
        )

    # ------------------------------------------------------------- accessors
    @property
    def member(self) -> np.ndarray:
        return self.pl.member

    @property
    def down_partitions(self) -> list[int]:
        return sorted(self._saved)

    def restored_member(self) -> np.ndarray:
        """The member matrix as it will read once every down partition's
        saved row is restored by `partition_up` (a copy; the live matrix is
        untouched).  Migration planning diffs against this view so a down
        partition's stale replicas get scheduled (deferred) drops instead
        of silently surviving the row restore."""
        m = self.pl.member.copy()
        for p, row in self._saved.items():
            m[p] = row
        return m

    def rebase(self, placement: Placement) -> None:
        """Adopt a hot-swapped live placement (drift refit).

        Legal during an outage only when the new layout keeps every down
        partition's membership row EMPTY (the outage-refit contract: the
        fit ran on the failure-masked matrix with down rows excluded from
        receiving copies), so the saved pre-failure rows stay restorable by
        `partition_up` and the load ledger stays consistent."""
        for p in self._saved:
            if placement.member[p].any():
                raise RuntimeError(
                    f"cannot rebase: new placement stores items on down "
                    f"partition {p}"
                )
        self.pl = placement
        self._loads = placement.partition_weights()

    def resync_loads(self) -> None:
        """Re-sync the load ledger with the live member matrix after an
        external in-place mutation (live-migration copies and drops land
        directly in the shared matrix, bypassing this manager)."""
        self._loads = self.pl.partition_weights()

    # ------------------------------------------------------------ down / up
    def partition_down(self, p: int) -> np.ndarray:
        """Mask partition p's membership row.  Returns the items that lost
        their LAST live replica (weight > 0)."""
        p = int(p)
        if p in self._saved:
            raise ValueError(f"partition {p} is already down")
        self._saved[p] = self.pl.member[p].copy()
        self.pl.member[p] = False
        self._loads[p] = 0.0
        self.stats["partitions_down"] += 1
        reg = _obs.registry()
        if reg.active:
            reg.inc("failover_partitions_down_total")
            reg.gauge("failover_down_now").add(1.0)
            _obs.tracer().event("failover.down", partition=p)
        lost = (
            self._saved[p]
            & ~self.pl.member.any(axis=0)
            & (self.pl.node_weights > 0)
        )
        return np.flatnonzero(lost)

    def partition_up(self, p: int) -> None:
        """Restore partition p's saved membership row."""
        p = int(p)
        if p not in self._saved:
            raise ValueError(f"partition {p} is not down")
        row = self._saved.pop(p)
        self.pl.member[p] = row
        self._loads[p] = float(self.pl.node_weights[row].sum())
        reg = _obs.registry()
        if reg.active:
            reg.gauge("failover_down_now").add(-1.0)
            _obs.tracer().event("failover.up", partition=p)

    # ---------------------------------------------------------------- audit
    def uncovered_items(self) -> np.ndarray:
        """Items with weight > 0 and no live replica."""
        return np.flatnonzero(
            ~self.pl.member.any(axis=0) & (self.pl.node_weights > 0)
        )

    def serveable_mask(self, edge_ptr, edge_nodes) -> np.ndarray:
        """Per-CSR-query bool: True iff every pin has a live replica."""
        edge_ptr = np.asarray(edge_ptr, dtype=np.int64)
        edge_nodes = np.asarray(edge_nodes, dtype=np.int64)
        bad = (~self.pl.member.any(axis=0))[edge_nodes].astype(np.int64)
        cb = np.concatenate([[0], np.cumsum(bad)])
        return (cb[edge_ptr[1:]] - cb[edge_ptr[:-1]]) == 0

    def coverage_audit(self, hg: Hypergraph | None = None):
        """(lost_items, affected_edge_ids) — edge ids only when a workload
        hypergraph is given."""
        lost = self.uncovered_items()
        if hg is None:
            return lost, None
        affected = np.flatnonzero(
            ~self.serveable_mask(hg.edge_ptr, hg.edge_nodes)
        )
        return lost, affected

    # --------------------------------------------------------------- repair
    def replica_counts(self) -> np.ndarray:
        return self.pl.member.sum(axis=0)

    def _repair_order(self, hg: Hypergraph, k: int,
                      items: np.ndarray | None) -> np.ndarray:
        """Under-replicated items in repair order: hottest first (descending
        weighted degree, stable -> lowest item id on ties)."""
        if items is None:
            need = np.flatnonzero(
                (self.replica_counts() < k) & (self.pl.node_weights > 0)
            )
        else:
            need = np.asarray(items, dtype=np.int64)
        if not len(need):
            return need
        deg = hg.degrees()
        return need[np.argsort(-deg[need], kind="stable")]

    def _place_copies(self, hg: Hypergraph, v: int, k: int,
                      live_rows: np.ndarray, benefit: np.ndarray,
                      repaired: list[int]) -> bool:
        """Bring item v up to k live copies using a precomputed benefit
        vector (valid while no edge of v gains a new co-located pin).
        Returns True iff at least one copy was placed."""
        pl = self.pl
        placed = False
        while int(pl.member[live_rows, v].sum()) < k:
            wv = float(pl.node_weights[v])
            fits = (
                live_rows
                & (self._loads + wv <= pl.capacity + 1e-9)
                & ~pl.member[:, v]
            )
            if not fits.any():
                self.stats["unrepairable_items"] += 1
                break
            # max benefit; ties -> most reliable survivor, then most free
            # space, then lowest id (the fail key is constant without a
            # profile, so the legacy tie-break is untouched)
            cand = np.flatnonzero(fits)
            key = np.lexsort((
                cand,                       # lowest id last resort
                self._loads[cand],          # least loaded
                self._fail[cand],           # lowest failure probability
                -benefit[cand],             # max co-location benefit
            ))
            d = int(cand[key[0]])
            pl.member[d, v] = True
            self._loads[d] += wv
            repaired.append(int(v))
            placed = True
        return placed

    def _benefit_reference(self, hg: Hypergraph, v: int) -> np.ndarray:
        """Per-item co-location benefit, the retained per-edge oracle."""
        node_ptr, node_edges = hg.incidence()
        ev = node_edges[node_ptr[v]: node_ptr[v + 1]]
        benefit = np.zeros(self.pl.num_partitions, dtype=np.float64)
        for e in ev:
            pins = hg.edge(int(e))
            pins = pins[pins != v]
            if len(pins):
                benefit += float(hg.edge_weights[e]) * (
                    self.pl.member[:, pins].any(axis=1)
                )
        return benefit

    def _batched_benefits(self, hg: Hypergraph, items: np.ndarray) -> np.ndarray:
        """(len(items), N) co-location benefit matrix against the CURRENT
        layout, one vectorized engine pass for the whole repair wave.

        Exactness: row i accumulates `w_e * (partition holds another pin of
        e)` over item i's incident edges in incidence order — `np.add.at`
        is sequential over its index arrays, so each row's float-sum order
        matches `_benefit_reference`'s per-edge loop bit-for-bit."""
        pl = self.pl
        N = pl.num_partitions
        node_ptr, node_edges = hg.incidence()
        cnt = node_ptr[items + 1] - node_ptr[items]
        total = int(cnt.sum())
        out = np.zeros((len(items), N), dtype=np.float64)
        if not total:
            return out
        base = np.repeat(node_ptr[items], cnt)
        off = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt[:-1])]), cnt
        )
        pair_edge = node_edges[base + off]          # (F,) incident edges
        pair_row = np.repeat(
            np.arange(len(items), dtype=np.int64), cnt
        )
        pair_item = np.repeat(items, cnt)
        ptr, pidx = hg.pin_indices(pair_edge)
        pins = hg.edge_nodes[pidx]
        ppair = np.repeat(
            np.arange(len(pair_edge), dtype=np.int64), np.diff(ptr)
        )
        kept = np.flatnonzero(pins != pair_item[ppair])  # "other" pins only
        held = np.zeros((len(pair_edge), N), dtype=bool)
        if len(kept):
            kp = ppair[kept]
            starts = np.flatnonzero(
                np.concatenate([[True], kp[1:] != kp[:-1]])
            )
            red = np.logical_or.reduceat(
                pl.member[:, pins[kept]], starts, axis=1
            )  # (N, groups)
            held[kp[starts]] = red.T
        np.add.at(
            out, pair_row, hg.edge_weights[pair_edge][:, None] * held
        )
        return out

    def repair(self, hg: Hypergraph, k: int = 1,
               items: np.ndarray | None = None) -> np.ndarray:
        """Re-replicate under-replicated items into surviving free space.

        Ensures every item with weight > 0 (or the explicit `items`) has at
        least `k` live replicas where capacity allows.  Sequential greedy in
        hottest-first order; each copy's destination maximizes co-location
        benefit against the CURRENT live layout, so items repaired earlier
        attract their co-accessed peers.  Returns the unique repaired item
        ids; ``stats["repaired_items"]`` counts replica COPIES placed (== the
        returned length for k=1, larger when one item needs several copies).

        Benefits are computed one batched call per WAVE; a wave restarts at
        the first item whose benefit could be stale (it shares an edge with
        an item that just received a copy), so the placements — order,
        destinations, float ties — are bit-identical to `repair_reference`.
        """
        _tr = _obs.tracer()
        _t0 = time.perf_counter() if _tr.active else 0.0
        pl = self.pl
        live_rows = np.ones(pl.num_partitions, dtype=bool)
        live_rows[self.down_partitions] = False
        order = self._repair_order(hg, k, items)
        if not len(order):
            return order
        node_ptr, node_edges = hg.incidence()
        repaired: list[int] = []
        pos = 0
        while pos < len(order):
            # capped wave: on clustered workloads consecutive hot items
            # often share edges, so a wave can end after one placement —
            # the cap bounds the recompute waste to a constant factor
            # instead of going quadratic over the remaining tail
            wave = order[pos: pos + 64]
            benefits = self._batched_benefits(hg, wave)
            touched = np.zeros(hg.num_edges, dtype=bool)
            i = 0
            while i < len(wave):
                v = int(wave[i])
                ev = node_edges[node_ptr[v]: node_ptr[v + 1]]
                if i > 0 and len(ev) and touched[ev].any():
                    break  # precomputed benefit may be stale: new wave
                if self._place_copies(hg, v, k, live_rows, benefits[i],
                                      repaired):
                    touched[ev] = True
                i += 1
            pos += max(i, 1)
        self.stats["repaired_items"] += len(repaired)
        reg = _obs.registry()
        if reg.active:
            reg.inc("failover_repaired_items_total", len(repaired))
        if _tr.active:
            _tr.complete("failover.repair", _t0, time.perf_counter(),
                         copies=len(repaired))
        return np.asarray(sorted(set(repaired)), dtype=np.int64)

    def repair_reference(self, hg: Hypergraph, k: int = 1,
                         items: np.ndarray | None = None) -> np.ndarray:
        """The retained per-item oracle `repair` is asserted against:
        identical greedy order and tie-breaks, one per-edge Python benefit
        loop per copy instead of one batched call per wave."""
        pl = self.pl
        live_rows = np.ones(pl.num_partitions, dtype=bool)
        live_rows[self.down_partitions] = False
        order = self._repair_order(hg, k, items)
        if not len(order):
            return order
        repaired: list[int] = []
        for v in order:
            v = int(v)
            self._place_copies(
                hg, v, k, live_rows, self._benefit_reference(hg, v), repaired
            )
        self.stats["repaired_items"] += len(repaired)
        return np.asarray(sorted(set(repaired)), dtype=np.int64)

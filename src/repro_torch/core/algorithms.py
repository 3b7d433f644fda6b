"""Data placement algorithms with replication (paper §4).

  * random_placement — Random baseline (replicate & distribute randomly)
  * hpa_placement    — HPA baseline, no replication (straight line in fig. 6)
  * ihpa             — Algorithm 1, Iterative HPA
  * ds               — Algorithm 2, Dense-Subgraph based
  * pra              — Algorithm 3, Pre-Replication via hitting sets
  * lmbr             — Algorithms 4+5, improved Local-Move-Based Replication

All return a `Placement` (membership matrix), on which spans are computed by
greedy set cover (replica selection).  The host-side loops (IHPA's residual
rounds, DS's densest-subset peel, PRA's scoring and rewiring, LMBR's move
loop, projection and selection) are numpy copies of the JAX package's
``core/algorithms.py``.  Their span work goes through the batched engine on
the caller's device (span_gain, cover_rounds), and LMBR's dense peel
(``lmbr_peel="device"``) through the lockstep_peel kernel.  Every backend is
bit-identical.
"""

from __future__ import annotations

import heapq
import time
from typing import Callable

import numpy as np
import torch

from .. import flags as _flags
from .. import obs as _obs
from ..device import resolve as _resolve_device
from ..kernels.lockstep_peel.ops import lockstep_peel
from . import hpa as hpa_mod
from .cluster import capacity_vector, normalize_capacity
from .hypergraph import Hypergraph
from .setcover import (
    Placement,
    SpanMaintainer,
    batched_spans_csr,
    engine_counters,
    greedy_set_cover,
)

__all__ = [
    "random_placement", "hpa_placement", "ihpa", "ds", "pra", "lmbr",
    "min_partitions", "peel_counters", "ALGORITHMS",
]

# Dense-peel dispatch counters (observability, not control flow): pairs the
# lockstep_peel kernel took, pairs whose cell exceeds 2^22 floats and stay on
# the flat engine ("huge"), and pairs the flat engine took because the
# weights are outside the f32-exact integer domain ("inexact").
PEEL_COUNTERS = {"dense_pairs": 0, "huge_pairs": 0, "inexact_pairs": 0}


def peel_counters() -> dict:
    """Snapshot of the dense-peel dispatch counters."""
    return dict(PEEL_COUNTERS)


def min_partitions(hg: Hypergraph, capacity) -> int:
    """N_e = ceil(total item weight / C): the minimum number of partitions
    that can hold one copy of every item (exact up to the 1e-9 guard against
    float round-up on integer-weight workloads).  For a heterogeneous
    capacity vector, the count of largest-capacity partitions whose sum
    holds the total."""
    total = hg.total_node_weight()
    if isinstance(capacity, np.ndarray) and capacity.ndim:
        caps = np.sort(np.asarray(capacity, dtype=np.float64))[::-1]
        cum = np.cumsum(caps)
        k = int(np.searchsorted(cum, total - 1e-9)) + 1
        return min(k, len(caps))
    return int(np.ceil(total / capacity - 1e-9))


def _is_cap_vec(capacity) -> bool:
    return isinstance(capacity, np.ndarray) and capacity.ndim


def _cap_at(capacity, p: int):
    """Capacity of partition p: the scalar itself (unchanged object — the
    bit-identity path) or the vector entry."""
    return float(capacity[p]) if _is_cap_vec(capacity) else capacity


def _cap_slice(capacity, lo: int, hi: int):
    """Capacity restricted to partitions [lo, hi): scalar passes through;
    uniform vector slices collapse back to the scalar path."""
    return normalize_capacity(capacity[lo:hi]) if _is_cap_vec(capacity) \
        else capacity


def _base_partitions(hg: Hypergraph, capacity) -> int:
    """Rows [0, ne) for the base no-replication fit.  Scalar capacities use
    `min_partitions`; a heterogeneous vector takes the shortest PREFIX of
    rows whose capacities hold one copy of everything, because the base
    fits always fill rows in ascending id order."""
    if _is_cap_vec(capacity):
        cum = np.cumsum(np.asarray(capacity, dtype=np.float64))
        ne = int(np.searchsorted(cum, hg.total_node_weight() - 1e-9)) + 1
        return min(ne, len(cum))
    return min_partitions(hg, capacity)


def _assign_to_placement(
    hg: Hypergraph, assign: np.ndarray, num_partitions: int, capacity: float
) -> Placement:
    pl = Placement.empty(num_partitions, hg.num_nodes, capacity, hg.node_weights)
    for v in range(hg.num_nodes):
        pl.member[assign[v], v] = True
    return pl


# ------------------------------------------------------------------ baselines
def random_placement(
    hg: Hypergraph, n: int, capacity: float, seed: int = 0, device="cuda",
    **_
) -> Placement:
    """Place every item once at random, then fill all remaining space with
    random replicas (the paper's Random baseline uses all available space).
    Deterministic for a given `seed` (single `default_rng` stream).  Host
    work only; ``device`` is checked like every entry point's."""
    _resolve_device(device)
    rng = np.random.default_rng(seed)
    pl = Placement.empty(n, hg.num_nodes, capacity, hg.node_weights)
    loads = np.zeros(n, dtype=np.float64)
    for v in rng.permutation(hg.num_nodes):
        wv = hg.node_weights[v]
        ok = np.flatnonzero(loads + wv <= capacity)
        if len(ok) == 0:
            raise ValueError("random placement cannot fit items")
        p = int(rng.choice(ok))
        pl.member[p, v] = True
        loads[p] += wv
    # replicate randomly into leftover space
    order = rng.permutation(hg.num_nodes)
    for p in range(n):
        cap_p = _cap_at(capacity, p)
        for v in order:
            if loads[p] + hg.node_weights[v] > cap_p:
                continue
            if pl.member[p, v]:
                continue
            pl.member[p, v] = True
            loads[p] += hg.node_weights[v]
    return pl


def hpa_placement(
    hg: Hypergraph, n: int, capacity: float, seed: int = 0, nruns: int = 2,
    device="cuda", **_
) -> Placement:
    """Plain HPA into N_e partitions; no replication (extra partitions idle).

    This is the paper's no-replication baseline: its span does not improve as
    partitions are added (fig. 6a's flat line).  Host work only; ``device``
    is checked like every entry point's."""
    _resolve_device(device)
    ne = _base_partitions(hg, capacity)
    assign = hpa_mod.partition(
        hg, ne, _cap_slice(capacity, 0, ne), seed=seed, nruns=nruns
    )
    return _assign_to_placement(hg, assign, n, capacity)


# ----------------------------------------------------------- residual helpers
def _residual_edges(hg: Hypergraph, pl: Placement, min_span: int,
                    device="cuda") -> np.ndarray:
    """Edge ids with span > min_span (pruneHypergraphBySpan keeps these)."""
    spans = batched_spans_csr(hg.edge_ptr, hg.edge_nodes, pl.member,
                              device=device)
    return np.flatnonzero(spans > min_span)


# ------------------------------------------------------------ Algorithm 1: IHPA
def ihpa(
    hg: Hypergraph, n: int, capacity: float, seed: int = 0, nruns: int = 2,
    device="cuda", **_
) -> Placement:
    """Algorithm 1, Iterative HPA: partition, then repeatedly re-partition
    the residual hypergraph (edges with span > 1) into the spare partitions,
    replicating its items.

    Residual spans come from an incremental SpanMaintainer on ``device``
    (only the edges of touched items recompute); when the residual must
    shrink (§4.2), lowest-span hyperedges are dropped in stable
    ascending-span order, so one seed gives one placement."""
    device = _resolve_device(device)
    ne = _base_partitions(hg, capacity)
    assign = hpa_mod.partition(
        hg, ne, _cap_slice(capacity, 0, ne), seed=seed, nruns=nruns
    )
    pl = _assign_to_placement(hg, assign, n, capacity)
    spans = SpanMaintainer(hg, pl, device=device)
    used = ne
    round_ = 0
    while used < n:
        round_ += 1
        edge_ids = spans.residual_edges(1)
        if len(edge_ids) == 0:
            break
        resid = hg.subhypergraph_edges(edge_ids)
        resid, old_ids = resid.relabel()
        rem_parts = n - used
        rem_cap = (float(capacity[used:n].sum()) if _is_cap_vec(capacity)
                   else rem_parts * capacity)
        if resid.total_node_weight() > rem_cap:
            # §4.2: drop lowest-span hyperedges one at a time (these gain
            # least from replication) until the residual fits
            spans_r = batched_spans_csr(
                resid.edge_ptr, old_ids[resid.edge_nodes], pl.member,
                device=device,
            )
            order = np.argsort(spans_r, kind="stable")  # ascending span
            pin_deg = np.bincount(resid.edge_nodes, minlength=resid.num_nodes)
            live_w = float(
                resid.node_weights[np.flatnonzero(pin_deg > 0)].sum()
            )
            keep_mask = np.ones(resid.num_edges, dtype=bool)
            for e in order:
                if live_w <= rem_cap:
                    break
                keep_mask[e] = False
                for u in resid.edge(int(e)):
                    pin_deg[u] -= 1
                    if pin_deg[u] == 0:
                        live_w -= float(resid.node_weights[u])
            resid = resid.subhypergraph_edges(np.flatnonzero(keep_mask))
            sub, sub_ids = resid.relabel()
            old_ids = old_ids[sub_ids]
            resid = sub
            if resid.num_edges == 0 or resid.num_nodes == 0:
                break
        if _is_cap_vec(capacity):
            # shortest prefix of the spare rows that holds the residual
            cum = np.cumsum(capacity[used:n])
            n_new = min(rem_parts, max(1, int(np.searchsorted(
                cum, resid.total_node_weight() - 1e-9)) + 1))
        else:
            n_new = min(rem_parts,
                        max(1, int(np.ceil(resid.total_node_weight()
                                           / capacity))))
        sub_assign = hpa_mod.partition(
            resid, n_new, _cap_slice(capacity, used, used + n_new),
            seed=seed + round_, nruns=nruns
        )
        pl.member[used + sub_assign, old_ids] = True
        spans.notify_items(old_ids)
        used += n_new
    return pl


# -------------------------------------------------------------- Algorithm 2: DS
def ds(
    hg: Hypergraph, n: int, capacity: float, seed: int = 0, nruns: int = 2,
    device="cuda", **_
) -> Placement:
    """Algorithm 2, Dense-Subgraph based: fill each spare partition with the
    densest capacity-bounded node set of the current residual hypergraph.

    The peel inside `k_densest_nodes` is a host heap peel (lowest degree
    first, ties -> lowest node id); residual spans come from the batched
    engine on ``device``."""
    device = _resolve_device(device)
    ne = _base_partitions(hg, capacity)
    assign = hpa_mod.partition(
        hg, ne, _cap_slice(capacity, 0, ne), seed=seed, nruns=nruns
    )
    pl = _assign_to_placement(hg, assign, n, capacity)
    spans = SpanMaintainer(hg, pl, device=device)
    used = ne
    while used < n:
        edge_ids = spans.residual_edges(1)
        if len(edge_ids) == 0:
            break
        resid = hg.subhypergraph_edges(edge_ids)
        dense_nodes = resid.k_densest_nodes(_cap_at(capacity, used))
        if len(dense_nodes) == 0:
            break
        pl.member[used, dense_nodes] = True
        spans.notify_items(dense_nodes)
        used += 1
    return pl


# ------------------------------------------------------------- Algorithm 3: PRA
def _hitting_set(sets: list[list[int]]) -> list[int]:
    """Greedy hitting set: repeatedly take the element in the most sets
    (ties -> lowest element id)."""
    remaining = [set(s) for s in sets if s]
    hit: list[int] = []
    while remaining:
        counts: dict[int, int] = {}
        for s in remaining:
            for x in s:
                counts[x] = counts.get(x, 0) + 1
        best = max(counts.items(), key=lambda kv: (kv[1], -kv[0]))[0]
        hit.append(best)
        remaining = [s for s in remaining if best not in s]
    return hit


def pra(
    hg: Hypergraph, n: int, capacity: float, seed: int = 0, nruns: int = 2,
    device="cuda", **_
) -> Placement:
    """Algorithm 3, Pre-Replication: score items by how often they are the
    sole partition-local member of an edge, then clone high scorers across
    the partitions their edges must visit anyway (greedy hitting sets), and
    re-partition the rewired hypergraph.

    Scores accumulate in edge-major CSR order; items are processed in
    stable descending-score order (ties -> lowest item id); the hitting-set
    greedy breaks ties to the lowest element id.  Host work only (the
    per-edge covers are single queries); ``device`` is checked like every
    entry point's."""
    _resolve_device(device)
    ne = _base_partitions(hg, capacity)
    assign = hpa_mod.partition(
        hg, ne, _cap_slice(capacity, 0, ne), seed=seed, nruns=nruns
    )
    pl0 = _assign_to_placement(hg, assign, ne, _cap_slice(capacity, 0, ne))

    # score_v = #edges where v is the only member of its partition (line 4):
    # a pin is "solo" iff its (edge, partition) pin-count is exactly 1
    score = np.zeros(hg.num_nodes, dtype=np.float64)
    if hg.num_pins:
        pin_edge = np.repeat(
            np.arange(hg.num_edges, dtype=np.int64), hg.edge_sizes()
        )
        pin_part = assign[hg.edge_nodes]
        cnt = np.zeros((hg.num_edges, ne), dtype=np.int32)
        np.add.at(cnt, (pin_edge, pin_part), 1)
        solo = cnt[pin_edge, pin_part] == 1
        score = np.bincount(
            hg.edge_nodes[solo],
            weights=hg.edge_weights[pin_edge[solo]],
            minlength=hg.num_nodes,
        )

    budget = (float(capacity.sum()) if _is_cap_vec(capacity)
              else n * capacity) - hg.total_node_weight()  # spare room
    mutable = hg.copy_mutable()
    origins = list(range(hg.num_nodes))  # origins[new_id] = original item id
    node_ptr, node_edges = hg.incidence()
    order = np.argsort(-score, kind="stable")
    for v in order:
        if budget < hg.node_weights[v] or score[v] <= 0:
            continue
        ev = node_edges[node_ptr[v]: node_ptr[v + 1]]
        # spanning partitions of e \ {v}: copies of v are anchored to the
        # partitions each edge must visit anyway for its other items
        span_sets = []
        for e in ev:
            others = hg.edge(int(e))
            others = others[others != v]
            span_sets.append(
                list(greedy_set_cover(others, pl0.member)) if len(others)
                else []
            )
        hit = _hitting_set(span_sets)
        if len(hit) <= 1:
            continue
        # original v serves the first hitting-set member; each further member
        # gets a fresh copy, and edges spanned by it are rewired to that copy
        copies = {hit[0]: int(v)}
        for g in hit[1:]:
            if budget < hg.node_weights[v]:
                break
            copies[g] = mutable.add_node_copy(int(v))
            origins.append(int(v))
            budget -= hg.node_weights[v]
        for e, spans in zip(ev, span_sets):
            for g in hit:
                if g in spans and g in copies:
                    mutable.replace_in_edge(int(e), int(v), copies[g])
                    break
    replicated = mutable.freeze()
    final_assign = hpa_mod.partition(
        replicated, n, capacity, seed=seed + 1, nruns=nruns
    )
    # map copies back onto original item ids
    pl = Placement.empty(n, hg.num_nodes, capacity, hg.node_weights)
    copy_origin = np.asarray(origins, dtype=np.int64)
    for new_v in range(replicated.num_nodes):
        pl.member[final_assign[new_v], copy_origin[new_v]] = True
    return pl


# ----------------------------------------------------- Algorithms 4+5: LMBR
class _LMBRState:
    """Live set-cover assignment: for each edge, the partitions in its cover
    and the items it reads from each (the 'improved' LMBR bookkeeping).

    Covers live in a SpanMaintainer (cover mode), so both the initial build
    and every move's invalidation run through the batched bitset engine —
    no per-edge greedy Python loops.  The partition <-> edge incidence is a
    boolean matrix ``_edge_mask[p, e]`` (True iff e's cover touches p), so
    ``shared_edges`` / ``union_edges`` are single AND/OR + flatnonzero ops
    and edge ids come out ascending by construction.  DETERMINISTIC-ORDER is
    the access contract: every downstream float accumulation and tie-break
    depends only on edge ids, never on Python set iteration order.

    Epoch-keyed gain cache
    ----------------------
    ``max_gain(src, dest)`` memoizes Algorithm 5's (gain, items) per ordered
    pair.  Validity is checked at one of two granularities
    (``flags.FLAGS["lmbr_epochs"]``):

    ``"partition"`` stamps each entry with the epochs it
    is a pure function of:

      * ``cov_epoch[p]``  — bumped by ``recompute_edges`` for every partition
        that gained or lost a pin attribution (the old and new serving
        partitions of every changed pin; a superset of all part_edges /
        cover-content changes, since both are functions of pin attribution);
      * ``mem_epoch[d]``  — bumped by ``apply_move`` when d's membership row
        (and hence its free space and the free-pin mask) changes.

    A cached (src, dest) entry is valid iff cov_epoch[src], cov_epoch[dest]
    and mem_epoch[dest] are all unchanged.  Under the move loop nearly every
    move grazes some partition pair, so the hit rate is <1%.

    ``"item"`` (default) revalidates from the entry's OWN dependency
    set instead: a global move ``tick``, ``edge_tick[e]`` (last tick whose
    ``recompute_edges`` refreshed e's cover — conservative, stamps every
    refreshed edge), and ``item_tick[v]`` (last tick that copied item v
    somewhere).  An entry filled at tick t with shared-edge set ``sh`` and
    candidate pool ``pool`` is valid iff the pair's shared-edge COUNT is
    unchanged (O(1) off the maintained Gram matrix — an edge leaving the
    shared set was re-stamped, so count-neutral swaps are caught by the
    stamp, net changes by the count), ``edge_tick[sh].max() <= t`` and
    ``item_tick[pool].max() <= t``; free space is re-evaluated live from
    the cached trajectory (``_eval_traj``).  See ``_entry_hit`` for the
    full soundness argument.

    Either way a hit skips the recompute and returns the cached result
    verbatim (bit-identical by purity).  This collapses the
    O(N^2)-per-move rescan of Algorithm 4's refresh loop to the touched
    frontier: pairs whose covers, shared sets, and destination row did not
    change never re-peel.

    Mutation contract: membership changes MUST go through ``apply_move`` (or
    epochs go stale and the cache may serve outdated gains; direct
    ``pl.member`` writes are only safe with the cache unused)."""

    def __init__(self, hg: Hypergraph, pl: Placement, device="cuda"):
        self.hg = hg
        self.pl = pl
        self.device = _resolve_device(device)
        self.sm = SpanMaintainer(hg, pl, with_covers=True, device=self.device)
        n, E = pl.num_partitions, hg.num_edges
        self._edge_mask = np.zeros((n, E), dtype=bool)
        if E:
            counts = np.fromiter(
                (len(self.sm.chosen(e)) for e in range(E)), dtype=np.int64,
                count=E,
            )
            parts = (
                np.concatenate([self.sm.chosen(e) for e in range(E)])
                if counts.sum() else np.zeros(0, dtype=np.int64)
            )
            self._edge_mask[parts, np.repeat(np.arange(E), counts)] = True
        self.cov_epoch = np.zeros(n, dtype=np.int64)
        self.mem_epoch = np.zeros(n, dtype=np.int64)
        # item-granular cache state (``flags.lmbr_epochs="item"``):
        # edge_tick[e] records the move tick that last recomputed e's cover
        # (conservative: any refresh stamps, changed or not), item_tick[v]
        # the tick that last copied item v somewhere.  A cached pair
        # revalidates from gathers over ITS OWN shared edges and candidate
        # pool, so moves that cannot affect it never invalidate it.
        self.edge_tick = np.zeros(E, dtype=np.int64)
        self.item_tick = np.zeros(hg.num_nodes, dtype=np.int64)
        self.tick = 0
        sizes = np.diff(hg.edge_ptr)
        self._esz_mean = float(sizes.mean()) if E else 0.0
        # pairwise shared-edge counts for the "auto" peel dispatch: built on
        # first use, then maintained by rank-k updates in recompute_edges
        self._shared_cnt: np.ndarray | None = None
        self._loads = pl.partition_weights()
        self._gain_cache: dict[tuple[int, int], tuple] = {}
        self._traj_cache: dict[tuple[int, int], dict] = {}
        # device-peel exactness gate: f32 sums of integer-valued weights
        # below 2^24 are exact under any association order, so the dense
        # backends are bit-identical to the f64 oracle exactly then
        ew, nw = hg.edge_weights, hg.node_weights
        self._int_exact = bool(
            (ew.size == 0
             or (np.all(ew == np.rint(ew)) and float(ew.sum()) < 2 ** 24))
            and (nw.size == 0
                 or (np.all(nw == np.rint(nw)) and float(nw.sum()) < 2 ** 24))
        )
        self.stats = dict(gain_calls=0, gain_cache_hits=0, gain_fp_hits=0,
                          peel_pairs=0, moves=0)

    @property
    def part_edges(self) -> list[set[int]]:
        """Per-partition edge sets (compat view of the incidence mask)."""
        return [set(np.flatnonzero(row).tolist()) for row in self._edge_mask]

    def cover(self, e: int) -> dict[int, np.ndarray]:
        return self.sm.cover(e)

    def free_space(self, p: int) -> float:
        """Capacity headroom of p, tracked incrementally across moves
        (exact for integer item weights; for float weights it may differ
        from ``Placement.free_space`` in the last ulp — summation order)."""
        return self.pl.cap_of(p) - float(self._loads[p])

    def shared_edges(self, src: int, dest: int) -> list[int]:
        """Edges accessing both partitions, ascending edge id."""
        return np.flatnonzero(
            self._edge_mask[src] & self._edge_mask[dest]
        ).tolist()

    def union_edges(self, src: int, dest: int) -> np.ndarray:
        """Edges accessing either partition, ascending edge id."""
        return np.flatnonzero(self._edge_mask[src] | self._edge_mask[dest])

    def apply_move(self, dest: int, items: np.ndarray) -> None:
        """Copy `items` into partition dest (the only legal membership
        mutation): updates the load ledger and stamps dest's mem epoch."""
        self.pl.member[dest, items] = True
        self._loads[dest] += float(self.hg.node_weights[items].sum())
        self.mem_epoch[dest] += 1
        self.tick += 1
        self.item_tick[items] = self.tick
        self.stats["moves"] += 1

    def recompute_edges(self, edges: np.ndarray) -> None:
        """Re-derive the covers of `edges` in ONE batched engine call
        (bit-identical to per-edge cover_for_query), resync the incidence
        mask, and stamp the cov epoch of every partition whose pin
        attribution changed."""
        edges = np.asarray(edges, dtype=np.int64)
        if not len(edges):
            return
        _, pidx = self.hg.pin_indices(edges)
        old_pp = self.sm.pin_parts[pidx].copy()
        old_sub = self._edge_mask[:, edges].copy()
        self._edge_mask[:, edges] = False
        self.sm.refresh_edges(edges)
        new_pp = self.sm.pin_parts[pidx]
        counts = np.fromiter(
            (len(self.sm.chosen(int(e))) for e in edges), dtype=np.int64,
            count=len(edges),
        )
        parts = (
            np.concatenate([self.sm.chosen(int(e)) for e in edges])
            if counts.sum() else np.zeros(0, dtype=np.int64)
        )
        self._edge_mask[parts, np.repeat(edges, counts)] = True
        new_sub = self._edge_mask[:, edges]
        # any refresh stamps its edges (conservative: attribution can change
        # even when the cover set does not), behind its own tick bump so
        # entries cached earlier in the same move can never alias the stamp
        self.tick += 1
        self.edge_tick[edges] = self.tick
        if self._shared_cnt is not None:
            o64 = old_sub.astype(np.int64)
            n64 = new_sub.astype(np.int64)
            self._shared_cnt += n64 @ n64.T - o64 @ o64.T
        changed = old_pp != new_pp
        if changed.any():
            touched = np.unique(
                np.concatenate([old_pp[changed], new_pp[changed]])
            )
            self.cov_epoch[touched] += 1

    def _stamp(self, key: tuple[int, int]) -> tuple[int, int, int]:
        """The epochs (gain of key) is a pure function of."""
        src, dest = key
        return (
            int(self.cov_epoch[src]), int(self.cov_epoch[dest]),
            int(self.mem_epoch[dest]),
        )

    def max_gain(self, src: int, dest: int):
        """Algorithm 5 through the epoch cache: recompute only when an epoch
        the pair depends on moved, else return the memoized (gain, items)."""
        return self.max_gain_many([(src, dest)])[(src, dest)]

    def _peel_width_bounds(self, pairs: list[tuple[int, int]]) -> np.ndarray:
        """Per-pair degree-matrix width estimate for the ``lmbr_peel="auto"``
        size dispatch: (shared-edge count) * (mean edge size).  The count
        matrix is built once (edge-mask Gram product) and then maintained by
        rank-k updates in `recompute_edges`, so each estimate is an O(1)
        lookup — the dispatch signal never costs O(E) per pair.  The signal
        only picks a backend; both backends are bit-identical."""
        if self._shared_cnt is None:
            m = self._edge_mask.astype(np.int64)
            self._shared_cnt = m @ m.T
        srcs = np.fromiter((s for s, _ in pairs), dtype=np.int64,
                           count=len(pairs))
        dests = np.fromiter((d for _, d in pairs), dtype=np.int64,
                            count=len(pairs))
        return self._shared_cnt[srcs, dests] * self._esz_mean

    # ----------------------------------------- item-granular gain cache
    def _shared_count(self, key: tuple[int, int]) -> int:
        """O(1) shared-edge count off the maintained Gram matrix."""
        if self._shared_cnt is None:
            m = self._edge_mask.astype(np.int64)
            self._shared_cnt = m @ m.T
        return int(self._shared_cnt[key])

    def _entry_hit(self, key: tuple[int, int], ent: dict) -> bool:
        """Level-1 validity of a trajectory-cache entry: two tick gathers
        over the entry's OWN dependency footprint, no projection.

        Soundness — the pair's projection is a pure function of:

        * the covers / pin attributions of its shared edges, and every such
          change goes through ``recompute_edges``, which stamps
          ``edge_tick`` for all refreshed edges (conservatively: refreshed
          but unchanged still stamps), so ``edge_tick[sh].max() <= tick``
          proves the cached shared edges are untouched;
        * the shared-edge SET itself — an edge can only LEAVE it via a
          cover change (stamped, and it is in the cached ``sh``), so a
          count-preserving swap is caught by the leaving edge's tick and a
          net gain by the O(1) count compare;
        * which candidate-pool items are resident on dest — items only ever
          gain residency, and any copy of a pool item is caught by the
          per-item tick check (a copy of a non-pool item cannot change this
          pair's costly-pin set);
        * immutable node / edge weights.

        The destination's free space is NOT part of validity: trajectories
        are free-space-independent and re-evaluated under the live free
        space on every hit (empty projections stay empty under any of these
        checks, and a zero from exhausted free space stays zero because
        free space only shrinks).  Result-only entries (``strict``: the
        pure-Python oracle emits no trajectory) instead pin the global move
        tick, so they only serve while no mutation at all intervened."""
        if ent["strict"]:
            return ent["tick"] == self.tick
        if ent["scnt"] != self._shared_count(key):
            return False
        t = ent["tick"]
        sh = ent["sh"]
        if len(sh) and int(self.edge_tick[sh].max()) > t:
            return False
        pool = ent["pool"]
        if pool is None or not len(pool):
            return True
        return int(self.item_tick[pool].max()) <= t

    def _entry_eval(self, key: tuple[int, int], ent: dict):
        if ent["res"] is not None:
            return ent["res"]
        return _eval_traj(ent["pool"], ent["traj"], self.free_space(key[1]))

    def _cache_put(self, key, *, pool=None, fp=None, traj=None, res=None,
                   strict=False):
        if strict:
            sh, scnt = None, -1
        else:
            sh = np.flatnonzero(
                self._edge_mask[key[0]] & self._edge_mask[key[1]]
            )
            scnt = len(sh)
        self._traj_cache[key] = dict(
            tick=self.tick, sh=sh, scnt=scnt, pool=pool, fp=fp,
            traj=traj, res=res, strict=strict,
        )

    def _peel_with_traj(self, proj: list[tuple], backend: str):
        """Peel projected pairs, returning {key: (pool, fp, traj)}.  The
        dense kernel (``backend == "device"``) takes the integer-exact
        weight domain only; outside it — a domain dispatch, counted in
        ``PEEL_COUNTERS["inexact_pairs"]`` — and for every other backend
        the flat numpy lockstep records the trajectories.  A kernel failure
        raises."""
        if backend == "device":
            if self._int_exact:
                return _lmbr_peel_dense(self, proj)
            PEEL_COUNTERS["inexact_pairs"] += len(proj)
        return _lmbr_peel_flat(self, proj, collect_traj=True)

    def _max_gain_many_item(self, pairs, use_cache: bool):
        out: dict[tuple[int, int], tuple] = {}
        cache = self._traj_cache
        misses: list[tuple[int, int]] = []
        seen: set[tuple[int, int]] = set()
        for key in pairs:
            if key in seen:
                continue
            seen.add(key)
            if use_cache:
                ent = cache.get(key)
                if ent is not None and self._entry_hit(key, ent):
                    self.stats["gain_cache_hits"] += 1
                    out[key] = self._entry_eval(key, ent)
                    continue
            misses.append(key)
        if not misses:
            return out
        backend = _peel_backend()
        if backend == "reference":
            ref_keys, rest = misses, []
        elif backend == "auto":
            thresh = int(_flags.FLAGS.get("lmbr_peel_threshold", 256))
            bounds = self._peel_width_bounds(misses)
            ref_keys = [k for k, b in zip(misses, bounds) if b < thresh]
            rest = [k for k, b in zip(misses, bounds) if b >= thresh]
        else:
            ref_keys, rest = [], misses
        for k in ref_keys:
            res = _lmbr_max_gain_reference(self, *k)
            out[k] = res
            if use_cache:
                self._cache_put(k, res=res, strict=True)
        if rest:
            zero, proj = _lmbr_project(self, rest)
            for k, res in zero.items():
                out[k] = res
                if use_cache:
                    # empty projections are free-space-monotone (free space
                    # only shrinks within a fit), so stamp-valid is enough
                    self._cache_put(k, res=res)
            peel_list = []
            for p in proj:
                k = p[0]
                ent = cache.get(k) if use_cache else None
                if (ent is not None and ent["fp"] is not None
                        and _fp_equal(ent["fp"], p)):
                    # level 2: identical projection -> the cached trajectory
                    # is byte-for-byte what a re-peel would produce; re-file
                    # it under the CURRENT dependency footprint
                    self.stats["gain_fp_hits"] += 1
                    self._cache_put(k, pool=ent["pool"], fp=ent["fp"],
                                    traj=ent["traj"])
                    out[k] = _eval_traj(ent["pool"], ent["traj"], p[1])
                    continue
                peel_list.append(p)
            if peel_list:
                self.stats["peel_pairs"] += len(peel_list)
                reg = _obs.registry()
                if reg.active:
                    reg.inc("lmbr_peel_rounds")
                    reg.inc("lmbr_peel_pairs", len(peel_list))
                peeled = self._peel_with_traj(peel_list, backend)
                for p in peel_list:
                    k = p[0]
                    pool, fp, traj = peeled[k]
                    out[k] = _eval_traj(pool, traj, p[1])
                    if use_cache:
                        self._cache_put(k, pool=pool, fp=fp, traj=traj)
        return out

    def max_gain_many(self, pairs: list[tuple[int, int]]):
        """Epoch-cached batch gain evaluation.  Cache hits are answered from
        the memo; the misses run through ONE lockstep batched peel (or the
        pure-Python oracle pair-by-pair under ``lmbr_peel="reference"``;
        ``"auto"`` routes pairs whose degree-matrix width estimate is below
        ``flags.FLAGS["lmbr_peel_threshold"]`` to the oracle — on sparse
        near-span-1 workloads tiny peels beat the batch-array assembly —
        and batches the rest; all backends are bit-identical).

        Cache granularity follows ``flags.lmbr_epochs``: "item" (default)
        runs the two-level item-granular cache — per-pair epoch stamps plus
        a per-item tick intersection, then a projection fingerprint — and
        re-evaluates cached free-space-independent peel trajectories under
        the live free space; "partition" restores the per-partition
        epoch memo.  Both are exactness-neutral.
        Returns {pair: (gain, items)} covering every requested pair."""
        self.stats["gain_calls"] += len(pairs)
        use_cache = _flags.FLAGS.get("lmbr_gain_cache", True)
        if _flags.FLAGS.get("lmbr_epochs", "item") == "item":
            return self._max_gain_many_item(pairs, use_cache)
        out: dict[tuple[int, int], tuple] = {}
        misses: list[tuple[int, int]] = []
        pending: set[tuple[int, int]] = set()
        for key in pairs:
            if key in out or key in pending:
                continue
            if use_cache:
                hit = self._gain_cache.get(key)
                if hit is not None and hit[0] == self._stamp(key):
                    self.stats["gain_cache_hits"] += 1
                    out[key] = (hit[1], hit[2])
                    continue
            misses.append(key)
            pending.add(key)
        if misses:
            backend = _peel_backend()
            if backend == "reference":
                computed = {
                    k: _lmbr_max_gain_reference(self, *k) for k in misses
                }
            elif backend == "auto":
                thresh = int(_flags.FLAGS.get("lmbr_peel_threshold", 256))
                bounds = self._peel_width_bounds(misses)
                computed = {
                    k: _lmbr_max_gain_reference(self, *k)
                    for k, b in zip(misses, bounds) if b < thresh
                }
                big = [k for k, b in zip(misses, bounds) if b >= thresh]
                if big:
                    computed.update(_lmbr_gain_batch(self, big))
            else:
                computed = _lmbr_gain_batch(self, misses)
            if use_cache:
                for k, v in computed.items():
                    self._gain_cache[k] = (self._stamp(k), *v)
            out.update(computed)
        return out

    def spans(self) -> np.ndarray:
        return self.sm.spans()


def _peel_backend() -> str:
    backend = _flags.FLAGS.get("lmbr_peel", "vector")
    if backend not in _flags.PEEL_BACKENDS:
        raise ValueError(f"unknown lmbr_peel backend {backend!r}")
    return backend


def _lmbr_max_gain_reference(state: _LMBRState, src: int, dest: int):
    """Algorithm 5: best group of items to copy src->dest and its gain
    (benefit per unit weight copied).  Returns (gain, items) or (0, None).

    Pure-Python peel, the executable specification (kept as the oracle the
    vectorized engine is tested against — `_LMBRState.max_gain_many`
    dispatches between the two on ``flags.FLAGS["lmbr_peel"]``; both are
    bit-identical: same densest subset, same gain float, same tie-breaks —
    ascending edge id in the projection scan, lowest item id on density
    ties — enforced by tests/test_lmbr_peel.py).

    Projection: for each edge accessing both partitions (ascending edge id),
    the items it reads from src that are NOT already on dest — items already
    resident on dest are free pins (cost 0, never peeled), the weighted
    generalization of the paper's getKDensestNodes accounting.  The peel
    then repeatedly removes the lowest-degree item (ties -> lowest item id)
    and records the best benefit/weight ratio among states that fit dest's
    free space."""
    hg, pl = state.hg, state.pl
    shared = state.shared_edges(src, dest)  # ascending edge id, deterministic
    if not shared:
        return 0.0, None
    c_dest = state.free_space(dest)
    if c_dest <= 1e-12:
        return 0.0, None
    node_w = hg.node_weights
    dest_row = pl.member[dest]
    # project: for each shared edge, the items it reads from src
    proj: list[tuple[float, list[int]]] = []  # (edge_weight, costly pins)
    total_benefit = 0.0
    for e in shared:
        items = state.cover(e).get(src)
        if items is None or not len(items):
            continue
        costly = [int(v) for v in items if not dest_row[v]]
        if not costly:
            continue  # free benefit is claimed lazily by recompute_edges
        we = float(hg.edge_weights[e])
        proj.append((we, costly))
        total_benefit += we
    if not proj:
        return 0.0, None
    inc: dict[int, list[int]] = {}
    for i, (_, pins) in enumerate(proj):
        for v in pins:
            inc.setdefault(v, []).append(i)
    deg = {v: 0.0 for v in inc}
    for i, (we, pins) in enumerate(proj):
        for v in pins:
            deg[v] += we
    alive_nodes = set(inc)
    alive_edge = [True] * len(proj)
    # accumulate in inc insertion order (first-encounter over the ascending
    # shared-edge scan) — never in set iteration order
    total_w = sum(float(node_w[v]) for v in inc)
    heap = [(d, v) for v, d in deg.items()]
    heapq.heapify(heap)
    best_gain, best_items = 0.0, None
    while total_benefit > 1e-12 and alive_nodes:
        if total_w <= c_dest + 1e-12:
            gain = total_benefit / max(total_w, 1e-12)
            if gain > best_gain:
                best_gain = gain
                best_items = list(alive_nodes)
        # peel the lowest-degree alive node
        while heap:
            d, v = heapq.heappop(heap)
            if v in alive_nodes and abs(d - deg[v]) < 1e-9:
                break
        else:
            break
        alive_nodes.discard(v)
        total_w -= float(node_w[v])
        for i in inc[v]:
            if alive_edge[i]:
                alive_edge[i] = False
                we, pins = proj[i]
                total_benefit -= we
                for u in pins:
                    if u != v and u in alive_nodes:
                        deg[u] -= we
                        heapq.heappush(heap, (deg[u], u))
    if best_items is None:
        return 0.0, None
    return best_gain, np.asarray(sorted(best_items), dtype=np.int64)


def _ranged_gather(lo: np.ndarray, hi: np.ndarray):
    """Flat indices of the concatenated ranges [lo_i, hi_i); also sizes."""
    sizes = hi - lo
    total = int(sizes.sum())
    if not total:
        return np.zeros(0, dtype=np.int64), sizes
    start = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=start[1:])
    idx = np.repeat(lo, sizes) + (
        np.arange(total, dtype=np.int64) - np.repeat(start[:-1], sizes)
    )
    return idx, sizes


def _proj_entry(key, c_dest, bpins, bedges, node_w, edge_w):
    """One pair's peel inputs from its costly-pin subsequence.

    ``bpins``/``bedges`` hold the pair's costly pins in projection scan
    order — edges ascending, pins in edge order — exactly the sequence the
    pure-Python oracle iterates, so every left-fold below reproduces its
    float accumulations bit-for-bit."""
    first = np.concatenate([[True], bedges[1:] != bedges[:-1]])
    starts = np.flatnonzero(first)
    kept = bedges[starts]            # edges with >= 1 costly pin, ascending
    pin_cnt = np.diff(np.concatenate([starts, [len(bedges)]]))
    we = edge_w[kept].astype(np.float64)
    cedge = np.repeat(np.arange(len(kept), dtype=np.int64), pin_cnt)
    uniq, first_idx = np.unique(bpins, return_index=True)
    loc = np.searchsorted(uniq, bpins)
    # item pool weight: left-fold in first-encounter order, matching the
    # oracle's sequential sum over dict insertion order
    totw0 = float(np.cumsum(node_w[bpins[np.sort(first_idx)]])[-1])
    return (key, c_dest, we, uniq, loc, cedge, pin_cnt, totw0)


def _project_fan_in(state, dest, srcs, out, proj):
    """Project every (src, dest) pair of one destination in one pass: gather
    the pins of dest's covered edges once, drop the free ones (already on
    dest), and split the remainder into per-serving-partition blocks with a
    single stable argsort.  Each block is exactly the costly-pin sequence
    the per-pair projection would produce (edges ascending, pin order)."""
    hg, pl = state.hg, state.pl
    e_d = np.flatnonzero(state._edge_mask[dest])
    # span-1 edges live on dest alone: they are never shared with a source
    # and all their pins are resident (free), so drop them before gathering
    e_d = e_d[state.sm.spans()[e_d] > 1]
    c_dest = state.free_space(dest)
    if not len(e_d) or c_dest <= 1e-12:
        for s in srcs:
            out[(s, dest)] = (0.0, None)
        return
    ptr, pidx = hg.pin_indices(e_d)
    nodes = hg.edge_nodes[pidx]
    sp = state.sm.pin_parts[pidx]
    eids = np.repeat(e_d, np.diff(ptr))
    sel = np.flatnonzero(~pl.member[dest, nodes])  # costly pins only
    order = sel[np.argsort(sp[sel], kind="stable")]
    svals = sp[order]
    bstart = np.flatnonzero(
        np.concatenate([[True], svals[1:] != svals[:-1]])
    ) if len(order) else np.zeros(0, dtype=np.int64)
    bend = np.concatenate([bstart[1:], [len(order)]])
    lookup = {int(s): i for i, s in enumerate(svals[bstart])}
    for s in srcs:
        i = lookup.get(s)
        if i is None:  # no shared edge reads a costly item from s
            out[(s, dest)] = (0.0, None)
            continue
        block = order[bstart[i]: bend[i]]
        proj.append(_proj_entry(
            (s, dest), c_dest, nodes[block], eids[block],
            hg.node_weights, hg.edge_weights,
        ))


def _project_fan_out(state, src, dests, out, proj):
    """Project every (src, dest) pair of one source in one pass: gather the
    pins src serves once; each destination then masks that block to its
    shared edges and non-resident items (2 row gathers per pair)."""
    hg, pl = state.hg, state.pl
    e_s = np.flatnonzero(state._edge_mask[src])
    # span-1 edges live on src alone: never shared with any destination
    e_s = e_s[state.sm.spans()[e_s] > 1]
    if not len(e_s):
        for d in dests:
            out[(src, d)] = (0.0, None)
        return
    ptr, pidx = hg.pin_indices(e_s)
    nodes = hg.edge_nodes[pidx]
    served = np.flatnonzero(state.sm.pin_parts[pidx] == src)
    bpins = nodes[served]
    bedges = np.repeat(e_s, np.diff(ptr))[served]
    for d in dests:
        c_dest = state.free_space(d)
        if c_dest <= 1e-12:
            out[(src, d)] = (0.0, None)
            continue
        keep = state._edge_mask[d, bedges] & ~pl.member[d, bpins]
        if not keep.any():
            out[(src, d)] = (0.0, None)
            continue
        sub = np.flatnonzero(keep)
        proj.append(_proj_entry(
            (src, d), c_dest, bpins[sub], bedges[sub],
            hg.node_weights, hg.edge_weights,
        ))


def _eval_traj(pool: np.ndarray, traj, c: float):
    """Select (gain, items) from a peel trajectory under free space ``c``.

    The single selection rule shared by the cache-revalidation path and the
    dense device backends: float64 ``benefit / max(weight, 1e-12)`` over
    the head-of-round states that fit (``totw <= c + 1e-12``), earliest
    round on gain ties (``argmax`` first occurrence == the oracle's
    strict-improvement recording), surviving items = pool minus the first r
    peeled.  Trajectories never depend on ``c`` (the peel order ignores
    free space), which is what makes cached entries re-evaluable as the
    destination fills up."""
    if traj is None or c <= 1e-12:
        return 0.0, None
    order, rtot, rben = traj
    fits = rtot <= c + 1e-12
    if not fits.any():
        return 0.0, None
    gains = rben / np.maximum(rtot, 1e-12)
    r = int(np.argmax(np.where(fits, gains, -np.inf)))
    keep = np.ones(len(pool), dtype=bool)
    keep[order[:r]] = False
    return float(gains[r]), pool[keep]


def _fp_equal(fp: tuple, p: tuple) -> bool:
    """Projection fingerprint equality: identical kept-edge weights, item
    pool, pin->item and pin->edge maps, and per-edge pin counts.  Equal
    fingerprints mean the peel inputs are identical, so the cached
    trajectory is exactly what a re-peel would produce."""
    return all(
        x.shape == y.shape and np.array_equal(x, y)
        for x, y in zip(fp, (p[2], p[3], p[4], p[5], p[6]))
    )


def _lmbr_project(state: _LMBRState, pairs: list[tuple[int, int]]):
    """Shared-gather projection of many pairs.  Returns (zero, proj):
    ``zero`` maps pairs with an empty projection to (0.0, None); ``proj``
    holds one peel-input tuple per remaining pair.

    Grouping: fan-in pairs (*, d) reuse one gather of d's covered edges
    (blocks split by serving partition); the rest group by src, reusing one
    gather of src's served pins across destinations."""
    zero: dict[tuple[int, int], tuple] = {}
    proj: list[tuple] = []  # (key, c_dest, we, uniq, loc, cedge, pin_cnt, totw0)
    by_dest: dict[int, list[int]] = {}
    for s, d in pairs:
        by_dest.setdefault(d, []).append(s)
    by_src: dict[int, list[int]] = {}
    for d, srcs in by_dest.items():
        if len(srcs) >= 2:
            _project_fan_in(state, d, srcs, zero, proj)
        else:
            by_src.setdefault(srcs[0], []).append(d)
    for s, dests in by_src.items():
        _project_fan_out(state, s, dests, zero, proj)
    return zero, proj


def _lmbr_gain_batch(state: _LMBRState, pairs: list[tuple[int, int]]):
    """Batched Algorithm 5: evaluate MANY (src, dest) candidates in one
    lockstep peel.  Returns {(src, dest): (gain, items-or-None)}, each entry
    bit-identical to the pure-Python oracle run on that pair alone."""
    out, proj = _lmbr_project(state, pairs)
    if proj:
        out.update(_lmbr_peel_flat(state, proj))
    return out


def _lmbr_peel_dense(state: _LMBRState, proj: list[tuple]):
    """Device-resident lockstep peel (``lmbr_peel="device"``): densify each
    pair's projection into a (K, U) incidence cell on the state's device
    and run every round in the lockstep_peel kernel.  Only the
    free-space-independent trajectories come back; selection happens in
    ``_eval_traj``.  Caller guarantees the integer-exact weight domain, so
    the f32 trajectories are bit-identical to the flat f64 engine's.

    Cells are grouped into pow2 (U, K) classes, at most 2^22 floats per
    launch; a pair whose own cell exceeds that ("huge", counted in
    ``PEEL_COUNTERS``) keeps the flat CSR engine.
    Returns {key: (pool, fp, traj)} like ``_lmbr_peel_flat``."""
    dev = state.device
    node_w = state.hg.node_weights
    out: dict[tuple[int, int], tuple] = {}
    classes: dict[tuple[int, int], list[tuple]] = {}
    huge: list[tuple] = []
    for p in proj:
        u2 = 1 << max(2, (len(p[3]) - 1).bit_length())
        k2 = 1 << max(2, (len(p[2]) - 1).bit_length())
        if u2 * k2 > 1 << 22:
            huge.append(p)
        else:
            classes.setdefault((u2, k2), []).append(p)
    PEEL_COUNTERS["dense_pairs"] += len(proj) - len(huge)
    PEEL_COUNTERS["huge_pairs"] += len(huge)
    for (u2, k2), plist in classes.items():
        chunk = max(1, (1 << 22) // (u2 * k2))
        for lo in range(0, len(plist), chunk):
            sub = plist[lo: lo + chunk]
            G = len(sub)
            wem = np.zeros((G, k2), dtype=np.float32)
            nwm = np.zeros((G, u2), dtype=np.float32)
            nv = np.zeros(G, dtype=np.int32)
            cells = []
            for i, p in enumerate(sub):
                _, _, we, uniq, loc, cedge, _, _ = p
                cells.append((i * k2 + cedge) * u2 + loc)
                wem[i, : len(we)] = we
                nwm[i, : len(uniq)] = node_w[uniq]
                nv[i] = len(uniq)
            # scatter the 0/1 incidence on the device: only the pin
            # positions cross the bus, never the dense cell
            inc = torch.zeros(G * k2 * u2, dtype=torch.float32, device=dev)
            inc[torch.from_numpy(np.concatenate(cells)).to(dev)] = 1.0
            peel, rtot, rben = lockstep_peel(
                inc.view(G, k2, u2), torch.from_numpy(wem).to(dev),
                torch.from_numpy(nwm).to(dev), torch.from_numpy(nv).to(dev),
            )
            peel = peel.cpu().numpy().astype(np.int64)
            rtot = rtot.cpu().numpy().astype(np.float64)
            rben = rben.cpu().numpy().astype(np.float64)
            done = peel < 0  # -1s are a suffix: active never resumes
            for i, p in enumerate(sub):
                R = int(np.argmax(done[i])) if done[i].any() else peel.shape[1]
                traj = (
                    (peel[i, :R].copy(), rtot[i, :R].copy(),
                     rben[i, :R].copy())
                    if R else None
                )
                out[p[0]] = (p[3], (p[2], p[3], p[4], p[5], p[6]), traj)
    if huge:
        out.update(_lmbr_peel_flat(state, huge, collect_traj=True))
    return out


def _lmbr_peel_flat(state: _LMBRState, proj: list[tuple],
                    collect_traj: bool = False):
    """Flat lockstep peel over projected pairs.

    Peel (all pairs in lockstep): pair-local items live in dense (G, Umax)
    matrices (degree, alive, weight), edges in flat CSR arrays.  Each round
    peels one item from every still-active pair: a single row-wise
    ``argmin`` picks each pair's lowest-degree item (+inf padding; ties ->
    lowest item id because columns are sorted by item id), and scatter-adds
    (``np.add.at`` — sequential over its index arrays) retire dying edges
    and their degree contributions in the oracle's exact accumulation order
    (edges ascending within a pair, pins in edge order).  Pairs drop out of
    the round set when their remaining benefit or item pool is exhausted.
    Because every pair's float-op sequence is unchanged from its solo run,
    lockstep execution cannot perturb results — same subsets, same gain
    floats, even under adversarial near-ties.

    Returns {key: (gain, items)} by default (best state tracked in-loop);
    with ``collect_traj`` the head-of-round states are recorded instead and
    the return is {key: (pool, fp, traj)} for ``_eval_traj`` / the
    trajectory cache — same rounds, same floats, one selection rule."""
    hg = state.hg
    node_w = hg.node_weights
    out: dict[tuple[int, int], tuple] = {}

    # ---- flat batch assembly
    G = len(proj)
    U = np.array([len(p[3]) for p in proj], dtype=np.int64)
    K = np.array([len(p[2]) for p in proj], dtype=np.int64)
    Umax = int(U.max())
    ebase = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(K, out=ebase[1:])
    we_flat = np.concatenate([p[2] for p in proj])
    pair_of_edge = np.repeat(np.arange(G, dtype=np.int64), K)
    # edge -> costly pins CSR (pins are pair-major, edge-major, pin order)
    pin_cnt_flat = np.concatenate([p[6] for p in proj])
    eptr = np.zeros(int(ebase[-1]) + 1, dtype=np.int64)
    np.cumsum(pin_cnt_flat, out=eptr[1:])
    pin_col = np.concatenate([p[4] for p in proj])
    pin_edge = np.concatenate(
        [p[5] + ebase[i] for i, p in enumerate(proj)]
    )
    pin_row = pair_of_edge[pin_edge]
    # item slot (pair, col) -> incident kept edges, ascending scan order
    inc_edges = np.concatenate([
        (p[5] + ebase[i])[np.argsort(p[4], kind="stable")]
        for i, p in enumerate(proj)
    ])
    inc_cnt = np.zeros((G, Umax), dtype=np.int64)
    for i, p in enumerate(proj):
        inc_cnt[i, : U[i]] = np.bincount(p[4], minlength=U[i])
    inc_ptr = np.zeros(G * Umax + 1, dtype=np.int64)
    np.cumsum(inc_cnt.ravel(), out=inc_ptr[1:])
    # dense padded index tables: slot -> incident edges and edge -> pin
    # indices, -1-padded to the widest row.  Each round then runs ONE fancy
    # gather + mask instead of a CSR ranged gather (whose cumsum/repeat
    # chains dominate the loop); row-major flattening preserves the exact
    # scan order (edges ascending within a slot, pins in edge order), so
    # every np.add.at sequence — hence every float — is unchanged.  CSR
    # stays the fallback for pathologically wide rows.
    emax = int(inc_cnt.max()) if inc_cnt.size else 0
    pmax = int(pin_cnt_flat.max()) if pin_cnt_flat.size else 0
    E_flat = int(ebase[-1])
    use_dense = (0 < emax <= 32 and G * Umax * emax < (1 << 24)
                 and 0 < pmax <= 64 and E_flat * pmax < (1 << 24))
    if use_dense:
        cnt_r = inc_cnt.ravel()
        inc_dense = np.full((G * Umax, emax), -1, dtype=np.int64)
        inc_dense[
            np.repeat(np.arange(G * Umax, dtype=np.int64), cnt_r),
            np.arange(len(inc_edges), dtype=np.int64)
            - np.repeat(inc_ptr[:-1], cnt_r),
        ] = inc_edges
        pin_dense = np.full((E_flat, pmax), -1, dtype=np.int64)
        pin_dense[
            np.repeat(np.arange(E_flat, dtype=np.int64), pin_cnt_flat),
            np.arange(len(pin_col), dtype=np.int64)
            - np.repeat(eptr[:-1], pin_cnt_flat),
        ] = np.arange(len(pin_col), dtype=np.int64)
    # dense per-item state: +inf padding so argmin never picks a pad slot
    valid = np.arange(Umax, dtype=np.int64)[None, :] < U[:, None]
    cand = np.full((G, Umax), np.inf, dtype=np.float64)
    cand[valid] = 0.0
    # degrees accumulate in the oracle's scan order (np.add.at is
    # sequential over its index arrays), bit-for-bit the dict loop
    np.add.at(cand, (pin_row, pin_col), we_flat[pin_edge])
    alive = valid.copy()
    nodew = np.zeros((G, Umax), dtype=np.float64)
    nodew[valid] = np.concatenate([node_w[p[3]] for p in proj])
    # left-fold cumsum == the oracle's sequential `total_benefit += we`
    benefit = np.array(
        [float(np.cumsum(p[2])[-1]) for p in proj], dtype=np.float64
    )
    totw = np.array([p[7] for p in proj], dtype=np.float64)
    c_arr = np.array([p[1] for p in proj], dtype=np.float64)
    n_alive = U.copy()
    edge_alive = np.ones(int(ebase[-1]), dtype=bool)
    best_gain = np.zeros(G, dtype=np.float64)
    best_set = np.zeros((G, Umax), dtype=bool)
    has_best = np.zeros(G, dtype=bool)

    # ---- lockstep weighted peel (getKDensestNodes, Asahiro-style greedy)
    rec_rows: list[np.ndarray] = []
    rec_j: list[np.ndarray] = []
    rec_tot: list[np.ndarray] = []
    rec_ben: list[np.ndarray] = []
    act = np.flatnonzero((benefit > 1e-12) & (n_alive > 0))
    while len(act):
        t = totw[act]
        if collect_traj:
            # head-of-round snapshot (the fancy-index gathers are already
            # fresh arrays); selection is deferred to _eval_traj
            rec_rows.append(act)
            rec_tot.append(t)
            rec_ben.append(benefit[act])
        else:
            # record states that fit the destination's free space
            fits = t <= c_arr[act] + 1e-12
            if fits.any():
                rows = act[fits]
                g = benefit[rows] / np.maximum(t[fits], 1e-12)
                imp = g > best_gain[rows]
                if imp.any():
                    r2 = rows[imp]
                    best_gain[r2] = g[imp]
                    best_set[r2] = alive[r2]
                    has_best[r2] = True
        # peel each active pair's lowest-degree item (ties -> lowest id)
        j = np.argmin(cand[act], axis=1)
        if collect_traj:
            rec_j.append(j)
        alive[act, j] = False
        cand[act, j] = np.inf
        n_alive[act] -= 1
        totw[act] -= nodew[act, j]
        # retire this round's dying edges (ascending within each pair)
        slot = act * Umax + j
        if use_dense:
            ec = inc_dense[slot]                  # (A, emax), -1 padded
            cand_e = ec[ec >= 0]
        else:
            idx, _ = _ranged_gather(inc_ptr[slot], inc_ptr[slot + 1])
            cand_e = inc_edges[idx]
        de = cand_e[edge_alive[cand_e]]
        if len(de):
            edge_alive[de] = False
            np.add.at(benefit, pair_of_edge[de], -we_flat[de])
            if use_dense:
                pd = pin_dense[de]                # (D, pmax), -1 padded
                pm = pd >= 0
                cols = pin_col[pd[pm]]
                rows_t = np.broadcast_to(
                    pair_of_edge[de][:, None], pd.shape)[pm]
                wrep = np.broadcast_to(we_flat[de][:, None], pd.shape)[pm]
            else:
                pidx2, dsz = _ranged_gather(eptr[de], eptr[de + 1])
                cols = pin_col[pidx2]
                rows_t = np.repeat(pair_of_edge[de], dsz)
                wrep = np.repeat(we_flat[de], dsz)
            lv = alive[rows_t, cols]     # dead items never re-compared
            np.add.at(cand, (rows_t[lv], cols[lv]), -wrep[lv])
        act = act[(benefit[act] > 1e-12) & (n_alive[act] > 0)]

    if not collect_traj:
        for i, p in enumerate(proj):
            if has_best[i]:
                out[p[0]] = (float(best_gain[i]), p[3][best_set[i, : U[i]]])
            else:
                out[p[0]] = (0.0, None)
        return out

    # ---- group the recorded rounds back into per-pair trajectories
    # (stable sort by pair keeps round order within each pair)
    rows_all = (np.concatenate(rec_rows) if rec_rows
                else np.zeros(0, dtype=np.int64))
    j_all = (np.concatenate(rec_j) if rec_j
             else np.zeros(0, dtype=np.int64))
    tot_all = (np.concatenate(rec_tot) if rec_tot
               else np.zeros(0, dtype=np.float64))
    ben_all = (np.concatenate(rec_ben) if rec_ben
               else np.zeros(0, dtype=np.float64))
    order = np.argsort(rows_all, kind="stable")
    counts = np.bincount(rows_all, minlength=G)
    ptr = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    for i, p in enumerate(proj):
        sl = order[ptr[i]: ptr[i + 1]]
        traj = (
            (j_all[sl].astype(np.int64), tot_all[sl], ben_all[sl])
            if len(sl) else None
        )
        out[p[0]] = (p[3], (p[2], p[3], p[4], p[5], p[6]), traj)
    return out


def _energy_active_rows(hg: Hypergraph, n: int, capacity,
                        slack: float = 1.25) -> np.ndarray:
    """Active-partition mask for ``placement_objective="energy"``: the
    smallest capacity-descending prefix of rows (ties -> lowest id) whose
    total capacity holds ``slack``x the item weight.  Everything outside
    the mask stays empty — those machines can be powered down — while the
    in-mask slack is the replication budget the move engine spends."""
    caps = capacity_vector(capacity, n)
    order = np.lexsort((np.arange(n), -caps))
    cum = np.cumsum(caps[order])
    need = min(hg.total_node_weight() * slack, float(cum[-1]))
    k = int(np.searchsorted(cum, need - 1e-9)) + 1
    k = min(max(k, 1), n)
    mask = np.zeros(n, dtype=bool)
    mask[order[:k]] = True
    return mask


def lmbr(
    hg: Hypergraph,
    n: int,
    capacity: float,
    seed: int = 0,
    nruns: int = 2,
    max_moves: int | None = None,
    initial: Placement | None = None,
    dest_mask: np.ndarray | None = None,
    node_cost: np.ndarray | None = None,
    device="cuda",
    **_,
) -> Placement:
    """Improved LMBR (Algorithm 4 + Algorithm 5).

    Kernel work (the span engine's device rounds and the dense peel) runs
    on ``device``; the move loop and every selection stay on the host.

    `initial` warm-starts from an existing placement (incremental refits and
    the paper's use of LMBR as a capacity-fixup subroutine).

    `dest_mask` (optional, (n,) bool) restricts which partitions may RECEIVE
    copies: pairs with a masked destination are never evaluated or pushed.
    Sources are unrestricted — a masked partition that serves no covers
    (e.g. a failed partition whose membership row is zeroed) simply yields
    no gain.  An all-True mask is bit-identical to no mask; this is how
    online drift refits keep adapting during an outage (down rows masked)
    without ever copying data onto dead partitions.

    ``flags.placement_objective="energy"`` reuses the same plumbing on a
    cold start: the balanced start and the dest mask are restricted to a
    capacity-descending active-row prefix (`_energy_active_rows`), so the
    remaining partitions finish the fit empty and can be powered down.

    `node_cost` (optional, (n,) per-partition access cost, e.g.
    ``NodeProfile.access_cost``) with ``flags.node_cost_weight`` > 0
    charges each candidate move ``weight * node_cost[dest]`` against its
    gain before the accept test, steering replicas toward cheap nodes.
    The default (weight 0 or no vector) leaves every gain untouched —
    bit-identical to the unpenalized engine.

    Determinism contract: moves are applied in descending-gain order from a
    heap whose entries tie-break on (src, dest, version); candidate subsets
    come from the Algorithm 5 peel (ascending edge id in the projection,
    lowest item id on density ties), so repeated runs produce bit-identical
    placements regardless of peel backend (``flags.FLAGS["lmbr_peel"]``) or
    gain-cache setting (``flags.FLAGS["lmbr_gain_cache"]``).  The fitted
    ``Placement`` carries the move-engine counters in ``.stats`` (moves,
    gain_calls, gain_cache_hits, peel backend)."""
    device = _resolve_device(device)
    _tr = _obs.tracer()
    _t0 = time.perf_counter() if _tr.active else 0.0
    energy_mask: np.ndarray | None = None
    if initial is not None:
        pl = Placement(
            initial.member.copy(), capacity, hg.node_weights
        )
    elif _flags.FLAGS.get("placement_objective", "span") == "energy":
        # energy objective: fit into the active-row prefix only; idle rows
        # never receive copies (masked below), so they finish empty
        energy_mask = _energy_active_rows(hg, n, capacity)
        active = np.flatnonzero(energy_mask)
        k = len(active)
        caps_a = capacity_vector(capacity, n)[active]
        # capacity-proportional balance targets: each active row's share of
        # the load follows its share of the active capacity, so the clamped
        # sum always covers the total weight (flat per-row targets starve
        # rows smaller than the average)
        bal = (
            caps_a / float(caps_a.sum()) * hg.total_node_weight() * 1.1
            + float(hg.node_weights.max())
        )
        bal_cap = normalize_capacity(np.minimum(caps_a, bal))
        sub_assign = hpa_mod.partition(hg, k, bal_cap, seed=seed, nruns=nruns)
        pl = _assign_to_placement(hg, active[sub_assign], n, capacity)
    else:
        # Algorithm 4 line 1: balanced N-way start (hMETIS's UBfactor formula
        # allows only ~(C*N-total)/total slack, i.e. near-balance); the spare
        # capacity in every partition is the replication budget for the moves
        if _is_cap_vec(capacity):
            # heterogeneous rows: balance targets proportional to each
            # row's capacity share (a flat per-row target would starve the
            # sub-average rows and can make the start infeasible)
            bal_cap = normalize_capacity(np.minimum(
                capacity,
                capacity / float(capacity.sum())
                * hg.total_node_weight() * 1.1
                + float(hg.node_weights.max()),
            ))
        else:
            bal_cap = min(
                capacity,
                hg.total_node_weight() / n * 1.1
                + float(hg.node_weights.max()),
            )
        assign = hpa_mod.partition(hg, n, bal_cap, seed=seed, nruns=nruns)
        pl = _assign_to_placement(hg, assign, n, capacity)
    eng0 = engine_counters()
    state = _LMBRState(hg, pl, device)
    if max_moves is None:
        max_moves = 50 * n
    if dest_mask is None:
        dest_ok = np.ones(n, dtype=bool)
    else:
        dest_ok = np.asarray(dest_mask, dtype=bool)
        if dest_ok.shape != (n,):
            raise ValueError(f"dest_mask must be ({n},) bool")
    if energy_mask is not None:
        dest_ok = dest_ok & energy_mask
    # optional access-cost gain penalty (off by default: cost_pen is None
    # and every gain flows through unmodified — bit-identical)
    ncw = float(_flags.FLAGS.get("node_cost_weight", 0.0))
    cost_pen = (
        ncw * np.asarray(node_cost, dtype=np.float64)
        if ncw > 0 and node_cost is not None else None
    )

    # priority queue of (-gain, src, dest, version)
    version = np.zeros((n, n), dtype=np.int64)
    pq: list[tuple[float, int, int, int]] = []

    def _penalized(gain: float, d: int) -> float:
        return gain - float(cost_pen[d]) if cost_pen is not None else gain

    def push_many(pairlist: list[tuple[int, int]]):
        # one batched (epoch-cached) gain evaluation for the whole refresh
        # set; heap-entry content is insertion-order independent, so this is
        # behaviorally identical to pushing pair-by-pair
        results = state.max_gain_many(pairlist)
        for s, d in pairlist:
            gain, items = results[(s, d)]
            gain = _penalized(gain, d)
            version[s, d] += 1
            if gain > 0 and items is not None:
                heapq.heappush(pq, (-gain, s, d, int(version[s, d])))

    push_many([(s, d) for s in range(n) for d in range(n)
               if s != d and dest_ok[d]])

    moves = 0
    while pq and moves < max_moves:
        neg_gain, src, dest, ver = heapq.heappop(pq)
        if ver != version[src, dest]:
            continue  # stale entry
        gain, items = state.max_gain(src, dest)  # re-verify vs live state
        gain = _penalized(gain, dest)
        if items is None or gain <= 0:
            continue
        w = hg.node_weights[items].sum()
        if w > state.free_space(dest) + 1e-9:
            push_many([(src, dest)])
            continue
        # apply the move: copy items into dest
        state.apply_move(dest, items)
        moves += 1
        # recompute covers of edges that might benefit (those accessing src
        # or dest and touching a moved item) — ONE batched engine call over
        # the ascending-id affected set; per-edge covers are independent, so
        # refresh order cannot influence results.
        cand_arr = state.union_edges(src, dest)
        if len(cand_arr):
            ptr, nodes_ = hg.edges_csr(cand_arr)
            hit = np.isin(nodes_, items)
            ch = np.concatenate([[0], np.cumsum(hit)])
            touches = ch[ptr[1:]] > ch[ptr[:-1]]
            state.recompute_edges(cand_arr[touches])
        # refresh PQ entries involving dest (Algorithm 4 lines 12-15)
        pairs: list[tuple[int, int]] = []
        for g in range(n):
            if g != dest:
                pairs.append((g, dest))
                if dest_ok[g]:
                    pairs.append((dest, g))
        pairs.append((src, dest))
        push_many(pairs)
    calls = state.stats["gain_calls"]
    hits = state.stats["gain_cache_hits"] + state.stats["gain_fp_hits"]
    eng1 = engine_counters()
    pl.stats = dict(
        state.stats, peel=_flags.FLAGS.get("lmbr_peel", "vector"),
        gain_cache=bool(_flags.FLAGS.get("lmbr_gain_cache", True)),
        lmbr_epochs=_flags.FLAGS.get("lmbr_epochs", "item"),
        cache_hit_rate=(hits / calls) if calls else 0.0,
        cover_engine={k: eng1[k] - eng0[k] for k in eng0},
    )
    reg = _obs.registry()
    if reg.active:
        # mirror the move-engine counters into the registry; misses are
        # derivable as lmbr_gain_calls - hits
        for k in ("moves", "gain_calls", "gain_cache_hits", "gain_fp_hits"):
            reg.inc("lmbr_" + k, state.stats[k])
    if _tr.active:
        _tr.complete("fit.lmbr", _t0, time.perf_counter(), n=n,
                     moves=state.stats["moves"],
                     gain_calls=state.stats["gain_calls"])
    return pl


ALGORITHMS: dict[str, Callable[..., Placement]] = {
    "random": random_placement,
    "hpa": hpa_placement,
    "ihpa": ihpa,
    "ds": ds,
    "pra": pra,
    "lmbr": lmbr,
}

"""Workload decomposition: cut a trace into near-independent sub-workloads.

The paper's fit is monolithic — one hypergraph, one IHPA/DS/LMBR pass.  But
real traces decompose: queries touch items from one tenant / table family /
content cluster, so the co-access hypergraph splits into components that
never interact, plus a thin seam of cross-cluster queries.  Golab et al.
(arXiv:1312.0285) exploit exactly this structure for placement; here it
bounds fit cost — each sub-workload fits independently (and in parallel,
see `parallel_fit`), and only the seam needs global attention.

Decomposition runs in two stages:

1. **Connected components** of the item co-access graph (items are connected
   iff some query reads both), computed by vectorized label propagation with
   pointer jumping — per round, every hyperedge broadcasts its minimum label
   to its pins (`np.minimum.reduceat` + `np.minimum.at`), then labels
   pointer-jump to their root; rounds are O(log diameter), every round one
   pass over the pin array.  A component can never be split by a query, so
   per-component fits lose NOTHING — components are exactly independent.
2. **HPA-style coarse cut** of oversized components: a component heavier
   than the target shard weight is partitioned by the repo's multilevel
   partitioner (`hpa.partition`) into near-balanced pieces, minimizing the
   connectivity cost of the cut — the same objective the paper uses for
   placement, applied one level up.  This is where independence becomes
   approximate: edges crossing the cut become *boundary edges*.

Pieces then bin-pack into ``num_shards`` shards (worst-fit decreasing:
heaviest piece first into the currently LIGHTEST shard, ties -> lowest
shard id — deterministic, and it keeps shard weights balanced so partition
budgets and per-shard fit costs stay balanced too).

Boundary-edge cost model
------------------------
For edge e let ``lambda_e`` = number of distinct shards its pins land in.
``boundary_edges`` are those with lambda_e > 1.  Ignoring them during
per-shard fits costs at most

    boundary_cost = sum_e  w_e * (lambda_e - 1)

extra span: a query confined to one shard can always be covered within that
shard's partitions, while a boundary edge must touch >= lambda_e shards'
partition sets no matter how well each shard is fitted — (lambda_e - 1) is
the per-edge worst-case *additional* span versus a monolithic fit that
co-locates the edge (the same connectivity metric HPA minimizes, evaluated
at shard granularity).  `ShardingPlan.boundary_cost` reports it, and the
bounded LMBR repair pass in `parallel_fit` spends its move budget exactly
on these edges.

Each shard's sub-workload keeps every edge fully inside the shard, plus the
>= 2-pin *fragments* of boundary edges (their pins inside this shard, full
edge weight) — the same restriction `PlacementService.fit_hierarchical`
applies per pod, so the co-location signal of seam queries is not thrown
away, only their cross-shard part is deferred to the repair pass.

A copy of the JAX package's ``scale/sharder.py``: host numpy, and the
coarse cut is the port's `hpa.partition`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import hpa as hpa_mod
from ..core.cluster import normalize_capacity
from ..core.hypergraph import Hypergraph

__all__ = ["connected_components", "ShardSpec", "ShardingPlan", "shard_workload"]


def connected_components(hg: Hypergraph) -> np.ndarray:
    """(V,) component label per item — the minimum item id reachable through
    shared hyperedges (items in no edge are their own singleton component).
    Deterministic and fully vectorized (label propagation + pointer jump).
    """
    V = hg.num_nodes
    label = np.arange(V, dtype=np.int64)
    if hg.num_pins == 0:
        return label
    sizes = hg.edge_sizes()
    ne = np.flatnonzero(sizes > 0)  # reduceat cannot take empty segments
    pin_e = np.repeat(np.arange(len(ne), dtype=np.int64), sizes[ne])
    # the CSR pin array restricted to nonempty edges, contiguous
    nz_pins = hg.edge_nodes if len(ne) == hg.num_edges else (
        hg.edges_csr(ne)[1]
    )
    starts = np.zeros(len(ne), dtype=np.int64)
    np.cumsum(sizes[ne][:-1], out=starts[1:])
    while True:
        edge_min = np.minimum.reduceat(label[nz_pins], starts)
        before = label.copy()
        np.minimum.at(label, nz_pins, edge_min[pin_e])
        # pointer jumping: compress label chains to their current root
        while True:
            nxt = label[label]
            if np.array_equal(nxt, label):
                break
            label = nxt
        if np.array_equal(label, before):
            return label


@dataclasses.dataclass
class ShardSpec:
    """One shard's sub-workload, ready for an independent fit.

    items:        global item ids homed on this shard (ascending)
    sub_hg:       relabeled hypergraph over those items (internal edges +
                  local fragments of boundary edges)
    num_partitions / capacity: this shard's slice of the global budget
                  (capacity is the global scalar, or — heterogeneous
                  clusters — this shard's contiguous slice of the global
                  per-partition capacity vector)
    weight:       total item weight homed here
    """

    items: np.ndarray
    sub_hg: Hypergraph
    num_partitions: int
    capacity: "float | np.ndarray"
    weight: float


@dataclasses.dataclass
class ShardingPlan:
    """The decomposition: item->shard map, per-shard specs, boundary model."""

    item_shard: np.ndarray        # (V,) shard id per item
    shards: list[ShardSpec]
    part_offset: np.ndarray       # (S+1,) global partition rows per shard
    boundary_edges: np.ndarray    # global edge ids with lambda_e > 1
    boundary_lambda: np.ndarray   # distinct shards per boundary edge
    boundary_cost: float          # sum w_e * (lambda_e - 1)
    num_components: int

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def summary(self) -> dict:
        return dict(
            shards=self.num_shards,
            components=self.num_components,
            boundary_edges=int(len(self.boundary_edges)),
            boundary_cost=round(float(self.boundary_cost), 3),
            shard_items=[len(s.items) for s in self.shards],
            shard_parts=[s.num_partitions for s in self.shards],
        )


def _cut_component(hg: Hypergraph, comp_items: np.ndarray, pieces: int,
                   seed: int) -> list[np.ndarray]:
    """HPA coarse cut of one oversized component into `pieces` near-balanced
    item sets (global ids)."""
    mask = np.zeros(hg.num_nodes, dtype=bool)
    mask[comp_items] = True
    # components never split an edge, so e is in the component iff its
    # first pin is — no incidence walk needed
    nonempty = np.flatnonzero(hg.edge_sizes() > 0)
    eids = nonempty[mask[hg.edge_nodes[hg.edge_ptr[:-1][nonempty]]]]
    sub = hg.subhypergraph_edges(eids) if len(eids) else Hypergraph(
        np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.int64),
        hg.node_weights, np.zeros(0, dtype=np.float64),
    )
    remap = np.full(hg.num_nodes, -1, dtype=np.int64)
    remap[comp_items] = np.arange(len(comp_items))
    local = Hypergraph(
        sub.edge_ptr, remap[sub.edge_nodes],
        hg.node_weights[comp_items].copy(), sub.edge_weights,
    )
    w = float(local.node_weights.sum())
    # near-balance capacity, same slack formula as lmbr's Algorithm-4 start
    cap = w / pieces * 1.1 + float(local.node_weights.max())
    assign = hpa_mod.partition(local, pieces, cap, seed=seed, nruns=1)
    return [comp_items[assign == p] for p in range(pieces)]


def _het_partition_budget(caps: np.ndarray, num_partitions: int,
                          shard_w: np.ndarray, total_w: float) -> np.ndarray:
    """Split a heterogeneous capacity vector's rows across shards.

    Shards own CONTIGUOUS row slices (the merge in `parallel_fit` maps
    shard s onto rows ``part_offset[s]:part_offset[s+1]``), so the budget
    is a vector of row COUNTS: start weight-proportional (largest
    remainder, >= 1 row each), then sweep left-to-right moving rows from
    the largest-count donor into any shard whose slice cannot hold its
    weight.  Deterministic; raises when no contiguous split fits."""
    num_shards = len(shard_w)
    if len(caps) != num_partitions:
        raise ValueError(
            f"capacity vector has {len(caps)} entries, want {num_partitions}"
        )
    if total_w > float(caps.sum()) + 1e-9:
        raise ValueError(
            f"{num_partitions} heterogeneous partitions (total capacity "
            f"{float(caps.sum()):.1f}) cannot hold the sharded workload "
            f"(weight {total_w:.1f})"
        )
    share = shard_w / max(total_w, 1e-12) * num_partitions
    n_parts = np.maximum(1, np.floor(share).astype(np.int64))
    # trim the >= 1 floor's overshoot from the largest counts
    while int(n_parts.sum()) > num_partitions:
        d = int(np.argmax(n_parts))
        n_parts[d] -= 1
    rem = num_partitions - int(n_parts.sum())
    if rem > 0:
        frac_order = np.lexsort(
            (np.arange(num_shards), -(share - np.floor(share)))
        )
        for i in range(rem):
            n_parts[frac_order[i % num_shards]] += 1
    # feasibility sweep: contiguous slice capacities change whenever a
    # count changes, so re-derive offsets each round; bounded rounds
    for _ in range(4 * num_partitions):
        off = np.zeros(num_shards + 1, dtype=np.int64)
        np.cumsum(n_parts, out=off[1:])
        slice_cap = np.add.reduceat(caps, off[:-1])
        bad = np.flatnonzero(shard_w > slice_cap + 1e-9)
        if not len(bad):
            return n_parts
        s = int(bad[0])
        donors = np.flatnonzero((n_parts > 1) & (np.arange(num_shards) != s))
        if not len(donors):
            break
        d = int(donors[np.lexsort((donors, -n_parts[donors]))[0]])
        n_parts[d] -= 1
        n_parts[s] += 1
    raise ValueError(
        "no contiguous heterogeneous partition split fits the shard "
        "weights; reduce num_shards or rebalance capacities"
    )


def shard_workload(
    hg: Hypergraph,
    num_partitions: int,
    capacity: "float | np.ndarray",
    num_shards: int,
    seed: int = 0,
) -> ShardingPlan:
    """Decompose `hg` into `num_shards` near-independent sub-workloads and
    allocate the `num_partitions` x `capacity` budget across them
    (``capacity`` may be the global per-partition vector; each shard then
    receives its contiguous slice)."""
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    num_shards = min(num_shards, num_partitions)
    V = hg.num_nodes
    total_w = hg.total_node_weight()
    target_w = total_w / num_shards

    label = connected_components(hg)
    comp_ids, comp_of = np.unique(label, return_inverse=True)
    comp_w = np.bincount(comp_of, weights=hg.node_weights)
    num_components = len(comp_ids)

    # pieces to pack: whole small components, HPA-cut slices of big ones
    pieces: list[np.ndarray] = []
    order = np.argsort(-comp_w, kind="stable")  # heaviest first
    for ci in order:
        items = np.flatnonzero(comp_of == ci)
        w = float(comp_w[ci])
        if w > 1.25 * target_w and len(items) > 1 and num_shards > 1:
            k = min(num_shards, max(2, int(np.ceil(w / target_w))))
            pieces.extend(_cut_component(hg, items, k, seed=seed + int(ci)))
        else:
            pieces.append(items)
    pieces = [p for p in pieces if len(p)]

    # worst-fit decreasing bin pack of pieces into shards by weight
    pw = np.array([float(hg.node_weights[p].sum()) for p in pieces])
    porder = np.argsort(-pw, kind="stable")
    shard_w = np.zeros(num_shards, dtype=np.float64)
    item_shard = np.zeros(V, dtype=np.int64)
    for pi in porder:
        # lightest shard (ties -> lowest id): keeps shards balanced, which
        # keeps per-shard partition counts (and fit costs) balanced too
        s = int(np.argmin(shard_w))
        item_shard[pieces[pi]] = s
        shard_w[s] += pw[pi]

    het = isinstance(capacity, np.ndarray) and capacity.ndim
    if het:
        n_parts = _het_partition_budget(
            np.asarray(capacity, dtype=np.float64), num_partitions,
            shard_w, total_w,
        )
    else:
        # partition budget: every shard gets at least its feasibility
        # minimum (ceil(weight / capacity)); the remainder follows weight
        # (largest remainder method, ties -> lowest shard id)
        n_min = np.maximum(
            1, np.ceil(shard_w / capacity - 1e-9).astype(np.int64)
        )
        if int(n_min.sum()) > num_partitions:
            raise ValueError(
                f"{num_partitions} partitions x {capacity} cannot hold the "
                f"sharded workload (needs >= {int(n_min.sum())})"
            )
        spare = num_partitions - int(n_min.sum())
        share = shard_w / max(total_w, 1e-12) * spare
        extra = np.floor(share).astype(np.int64)
        rem = spare - int(extra.sum())
        if rem > 0:
            frac_order = np.lexsort((np.arange(num_shards), -(share - extra)))
            extra[frac_order[:rem]] += 1
        n_parts = n_min + extra
    part_offset = np.zeros(num_shards + 1, dtype=np.int64)
    np.cumsum(n_parts, out=part_offset[1:])

    # boundary accounting: lambda_e = distinct shards among e's pins
    sizes = hg.edge_sizes()
    pin_e = np.repeat(np.arange(hg.num_edges, dtype=np.int64), sizes)
    pin_shard = item_shard[hg.edge_nodes]
    # distinct count per edge via sort-by-(edge, shard) adjacent-diff
    so = np.lexsort((pin_shard, pin_e))
    ps, pe = pin_shard[so], pin_e[so]
    newv = np.ones(len(so), dtype=bool)
    if len(so):
        newv[1:] = (ps[1:] != ps[:-1]) | (pe[1:] != pe[:-1])
    lam = np.bincount(pe[newv], minlength=hg.num_edges) if len(so) else (
        np.zeros(hg.num_edges, dtype=np.int64)
    )
    boundary = np.flatnonzero(lam > 1)
    boundary_cost = float(
        (hg.edge_weights[boundary] * (lam[boundary] - 1)).sum()
    )

    # per-shard sub-workloads: internal edges + local >=2-pin fragments
    shards: list[ShardSpec] = []
    internal_of = np.full(hg.num_edges, -1, dtype=np.int64)
    nonempty = sizes > 0
    internal = (lam == 1) & nonempty
    internal_of[internal] = pin_shard[hg.edge_ptr[:-1][internal]]
    for s in range(num_shards):
        items = np.flatnonzero(item_shard == s)
        remap = np.full(V, -1, dtype=np.int64)
        remap[items] = np.arange(len(items))
        # internal edges of this shard, ascending edge id
        own = np.flatnonzero(internal_of == s)
        ptr_i, nodes_i = hg.edges_csr(own)
        frag_w = []
        frag_sizes = []
        frag_nodes = []
        if len(boundary):
            bptr, bnodes = hg.edges_csr(boundary)
            local = item_shard[bnodes] == s
            cl = np.concatenate([[0], np.cumsum(local)])
            nloc = cl[bptr[1:]] - cl[bptr[:-1]]
            keepb = np.flatnonzero(nloc >= 2)
            if len(keepb):
                sel = local.copy()
                # drop pins of boundary edges with < 2 local pins
                kmask = np.zeros(len(boundary), dtype=bool)
                kmask[keepb] = True
                sel &= np.repeat(kmask, np.diff(bptr))
                frag_nodes = [bnodes[sel]]
                frag_sizes = [nloc[keepb]]
                frag_w = [hg.edge_weights[boundary[keepb]]]
        sub_sizes = np.concatenate(
            [np.diff(ptr_i)] + ([frag_sizes[0]] if frag_sizes else [])
        ) if len(own) or frag_sizes else np.zeros(0, dtype=np.int64)
        sub_ptr = np.zeros(len(sub_sizes) + 1, dtype=np.int64)
        np.cumsum(sub_sizes, out=sub_ptr[1:])
        sub_nodes = np.concatenate(
            [nodes_i] + (frag_nodes if frag_nodes else [])
        ) if len(nodes_i) or frag_nodes else np.zeros(0, dtype=np.int64)
        sub_w = np.concatenate(
            [hg.edge_weights[own]] + (frag_w if frag_w else [])
        ) if len(own) or frag_w else np.zeros(0, dtype=np.float64)
        sub_hg = Hypergraph(
            sub_ptr, remap[sub_nodes] if len(sub_nodes) else sub_nodes,
            hg.node_weights[items].copy(), sub_w,
        )
        shards.append(ShardSpec(
            items=items, sub_hg=sub_hg, num_partitions=int(n_parts[s]),
            capacity=(
                normalize_capacity(
                    capacity[part_offset[s]:part_offset[s + 1]].copy()
                ) if het else float(capacity)
            ),
            weight=float(shard_w[s]),
        ))
    return ShardingPlan(
        item_shard=item_shard, shards=shards, part_offset=part_offset,
        boundary_edges=boundary, boundary_lambda=lam[boundary],
        boundary_cost=boundary_cost, num_components=num_components,
    )

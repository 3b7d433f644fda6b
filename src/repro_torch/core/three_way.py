"""Fixed replication-factor (3-way) algorithms (paper §4.6).

Large-scale stores (HDFS et al.) replicate every item exactly RF times; these
variants honor that constraint:

  * pra_3way — PRA with the importance filter removed: every node is
    replicated RF-way, the hitting-set technique distributes the copies
    among its incident hyperedges.
  * sda      — Simple Distribution Algorithm: RF copies assigned to incident
    hyperedges at random, |E_d|/RF edges per copy.
  * ihpa_3way — RF rounds of HPA on span-pruned residuals.

All produce a placement where every item has exactly RF copies (on distinct
partitions), using N = RF * N_e partitions.

A copy of the JAX package's ``core/three_way.py``: the same draws in the
same order, the same placements.  Each algorithm takes ``device`` (default
``"cuda"``; raises without CUDA unless ``device="cpu"``) and runs its span
engine calls there; the rest is host work.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve as _resolve_device
from . import hpa as hpa_mod
from .algorithms import _hitting_set, min_partitions
from .hypergraph import Hypergraph
from .setcover import Placement, batched_spans_csr, greedy_set_cover

__all__ = ["pra_3way", "sda", "ihpa_3way", "random_3way", "THREE_WAY_ALGORITHMS"]


def _partition_copies_placement(
    hg: Hypergraph,
    edge_copy_assign: dict[int, dict[int, int]],
    rf: int,
    n: int,
    capacity: float,
    seed: int,
    nruns: int,
) -> Placement:
    """Build the replicated hypergraph (each node -> rf copies, hyperedges
    rewired to copies per `edge_copy_assign[e][v] = copy_index`), partition it
    with HPA into n parts, and map back to original item ids."""
    num_copies = hg.num_nodes * rf
    copy_id = lambda v, c: v * rf + c  # noqa: E731
    edges = []
    for e in range(hg.num_edges):
        edges.append(
            [copy_id(int(v), edge_copy_assign[e].get(int(v), 0)) for v in hg.edge(e)]
        )
    # every copy exists even if no edge uses it (RF is a durability constraint)
    node_weights = np.repeat(hg.node_weights, rf)
    rep = Hypergraph.from_edges(
        edges, num_nodes=num_copies, node_weights=node_weights,
        edge_weights=hg.edge_weights.copy(),
    )
    assign = hpa_mod.partition(rep, n, capacity, seed=seed, nruns=nruns)
    # copies of one item must land on distinct partitions (durability).
    # With N = rf*Ne there may be zero slack, so collisions are repaired by
    # SWAPPING the duplicate copy with some copy resident in a partition that
    # lacks this item (keeps loads unchanged for homogeneous items).
    loads = np.zeros(n, dtype=np.float64)
    np.add.at(loads, assign, node_weights)
    part_copies: list[set[int]] = [set() for _ in range(n)]  # copy ids per part
    for cid, p in enumerate(assign):
        part_copies[int(p)].add(cid)
    rng = np.random.default_rng(seed + 17)

    def item_of(cid: int) -> int:
        return cid // rf

    for v in range(hg.num_nodes):
        seen: set[int] = set()
        for c in range(rf):
            cid = v * rf + c
            p = int(assign[cid])
            if p not in seen:
                seen.add(p)
                continue
            w = float(hg.node_weights[v])
            # try a pure move into free space first
            moved = False
            for q in np.argsort(loads):
                q = int(q)
                if q in seen:
                    continue
                if loads[q] + w <= capacity + 1e-9 and all(
                    item_of(x) != v for x in part_copies[q]
                ):
                    assign[cid] = q
                    part_copies[p].discard(cid)
                    part_copies[q].add(cid)
                    loads[p] -= w
                    loads[q] += w
                    seen.add(q)
                    moved = True
                    break
            if moved:
                continue
            # swap with a same-weight copy from a partition lacking item v
            done = False
            for q in rng.permutation(n):
                q = int(q)
                if q in seen or any(item_of(x) == v for x in part_copies[q]):
                    continue
                for other in list(part_copies[q]):
                    u = item_of(other)
                    if u == v:
                        continue
                    if abs(hg.node_weights[u] - w) > 1e-9:
                        continue
                    # u must not already be in p
                    if any(item_of(x) == u for x in part_copies[p]):
                        continue
                    assign[cid], assign[other] = q, p
                    part_copies[p].discard(cid)
                    part_copies[p].add(other)
                    part_copies[q].discard(other)
                    part_copies[q].add(cid)
                    seen.add(q)
                    done = True
                    break
                if done:
                    break
            if not done:
                seen.add(p)  # give up on strict distinctness for this copy
    pl = Placement.empty(n, hg.num_nodes, capacity, hg.node_weights)
    for v in range(hg.num_nodes):
        for c in range(rf):
            pl.member[assign[v * rf + c], v] = True
    return pl


def pra_3way(
    hg: Hypergraph, n: int | None = None, capacity: float = 0.0,
    rf: int = 3, seed: int = 0, nruns: int = 2, device="cuda", **_,
) -> Placement:
    _resolve_device(device)
    ne = min_partitions(hg, capacity)
    if n is None:
        n = rf * ne
    assign = hpa_mod.partition(hg, ne, capacity, seed=seed, nruns=nruns)
    pl0 = Placement.empty(ne, hg.num_nodes, capacity, hg.node_weights)
    for v in range(hg.num_nodes):
        pl0.member[assign[v], v] = True

    node_ptr, node_edges = hg.incidence()
    edge_copy_assign: dict[int, dict[int, int]] = {e: {} for e in range(hg.num_edges)}
    for v in range(hg.num_nodes):
        ev = node_edges[node_ptr[v] : node_ptr[v + 1]]
        if len(ev) == 0:
            continue
        # anchor copies to partitions the edges visit for their *other* items
        span_sets = []
        for e in ev:
            others = hg.edge(int(e))
            others = others[others != v]
            span_sets.append(
                list(greedy_set_cover(others, pl0.member)) if len(others) else []
            )
        hit = _hitting_set(span_sets)[:rf]  # at most rf copy anchors
        for e, spans in zip(ev, span_sets):
            c = 0
            for ci, g in enumerate(hit):
                if g in spans:
                    c = ci
                    break
            edge_copy_assign[int(e)][int(v)] = c
    return _partition_copies_placement(
        hg, edge_copy_assign, rf, n, capacity, seed + 1, nruns
    )


def sda(
    hg: Hypergraph, n: int | None = None, capacity: float = 0.0,
    rf: int = 3, seed: int = 0, nruns: int = 2, device="cuda", **_,
) -> Placement:
    """Simple Distribution Algorithm: random copy-to-edge distribution."""
    _resolve_device(device)
    ne = min_partitions(hg, capacity)
    if n is None:
        n = rf * ne
    rng = np.random.default_rng(seed)
    node_ptr, node_edges = hg.incidence()
    edge_copy_assign: dict[int, dict[int, int]] = {e: {} for e in range(hg.num_edges)}
    for v in range(hg.num_nodes):
        ev = node_edges[node_ptr[v] : node_ptr[v + 1]]
        if len(ev) == 0:
            continue
        perm = rng.permutation(len(ev))
        # contiguous |E_d|/rf chunks of the shuffled edges share one copy
        for rank, idx in enumerate(perm):
            c = int(rank * rf / len(ev))
            edge_copy_assign[int(ev[idx])][int(v)] = min(c, rf - 1)
    return _partition_copies_placement(
        hg, edge_copy_assign, rf, n, capacity, seed + 1, nruns
    )


def ihpa_3way(
    hg: Hypergraph, n: int | None = None, capacity: float = 0.0,
    rf: int = 3, seed: int = 0, nruns: int = 2, device="cuda", **_,
) -> Placement:
    """RF rounds of HPA; round r partitions the hypergraph with all edges of
    span<=r (w.r.t. the accumulated placement) removed, placing a fresh copy
    of every node each round."""
    device = _resolve_device(device)
    ne = min_partitions(hg, capacity)
    if n is None:
        n = rf * ne
    pl = Placement.empty(n, hg.num_nodes, capacity, hg.node_weights)
    used = 0
    cur = hg
    for r in range(rf):
        k = min(ne, n - used)
        if k <= 0:
            break
        assign = hpa_mod.partition(cur, k, capacity, seed=seed + r, nruns=nruns)
        pl.member[used + assign, np.arange(hg.num_nodes)] = True
        used += k
        # prune edges already at span 1 for the next round (batched engine)
        spans = batched_spans_csr(cur.edge_ptr, cur.edge_nodes, pl.member,
                                  device=device)
        nxt = cur.subhypergraph_edges(np.flatnonzero(spans > 1))
        # keep all nodes (every node still gets a copy each round)
        cur = Hypergraph(
            nxt.edge_ptr, nxt.edge_nodes, hg.node_weights, nxt.edge_weights
        )
    # durability fixup: ensure rf distinct partitions per item
    loads = pl.partition_weights()
    for v in range(hg.num_nodes):
        have = np.flatnonzero(pl.member[:, v])
        need = rf - len(have)
        w = hg.node_weights[v]
        while need > 0:
            cand = np.argsort(loads)
            placed = False
            for q in cand:
                if not pl.member[q, v] and loads[q] + w <= pl.capacity + 1e-9:
                    pl.member[q, v] = True
                    loads[q] += w
                    placed = True
                    break
            if not placed:
                break
            need -= 1
    return pl


def random_3way(
    hg: Hypergraph, n: int | None = None, capacity: float = 0.0,
    rf: int = 3, seed: int = 0, device="cuda", **_,
) -> Placement:
    """Random RF-way replication (fig. 6f-h baseline).

    Partitions are split into rf zones of Ne partitions; each zone receives a
    random balanced deal of all items, guaranteeing rf distinct partitions per
    item even at zero slack (N = rf*Ne)."""
    _resolve_device(device)
    ne = min_partitions(hg, capacity)
    if n is None:
        n = rf * ne
    zone = max(1, n // rf)
    rng = np.random.default_rng(seed)
    pl = Placement.empty(n, hg.num_nodes, capacity, hg.node_weights)
    for r in range(rf):
        lo = r * zone
        k = zone if r < rf - 1 else n - lo
        loads = np.zeros(k, dtype=np.float64)
        for v in rng.permutation(hg.num_nodes):
            w = hg.node_weights[v]
            ok = np.flatnonzero(loads + w <= capacity + 1e-9)
            p = int(rng.choice(ok)) if len(ok) else int(np.argmin(loads))
            pl.member[lo + p, v] = True
            loads[p] += w
    return pl


THREE_WAY_ALGORITHMS = {
    "random3": random_3way,
    "sda": sda,
    "ihpa3": ihpa_3way,
    "pra3": pra_3way,
}

"""HPA: a multilevel k-way hypergraph partitioner (hMETIS stand-in).

The paper uses hMETIS as a black box.  hMETIS is closed-source and not
installable offline, so we implement our own multilevel partitioner with the
same interface semantics the paper relies on:

  * k-way partitioning of a node-weighted hypergraph,
  * a hard per-partition capacity (the paper drives hMETIS's UBfactor so that
    no partition exceeds C; we take C directly),
  * minimizes the connectivity metric  sum_e w_e * (lambda_e - 1)  which is
    exactly (total span - #queries) when each item has a single copy — i.e.
    the right objective for the paper's average-span goal.

Structure: (1) coarsening by connectivity-weighted matching, (2) greedy
initial partitioning with random restarts, (3) FM-style refinement at every
uncoarsening level, (4) capacity fixup.

Host-side numpy, copied from the JAX package's ``core/hpa.py``: the same
arguments give the same assignment, bit for bit.
"""

from __future__ import annotations

import contextlib
import hashlib
import time
from collections import OrderedDict

import numpy as np

from .. import obs as _obs
from .hypergraph import Hypergraph

__all__ = ["partition", "connectivity_cost", "ubfactor", "fresh_partition_cache"]

_MAX_EDGE_FOR_MATCH = 64  # skip huge hyperedges during matching (hMETIS-like)


def _cap_at(capacity, p):
    """Capacity of part p: the scalar itself (unchanged object — the
    bit-identity path for homogeneous fits) or the vector entry."""
    if isinstance(capacity, np.ndarray) and capacity.ndim:
        return float(capacity[p])
    return capacity


def ubfactor(capacity: float, num_partitions: int, total_items: float) -> float:
    """The paper's UBfactor formula (§4.1) — retained for interface parity.

    UBfactor = 100 * (C*N - totalItems) / (totalItems * N)
    """
    return 100.0 * (capacity * num_partitions - total_items) / (
        total_items * num_partitions
    )


def connectivity_cost(hg: Hypergraph, assign: np.ndarray, k: int) -> float:
    """sum_e w_e * (lambda_e - 1), vectorized over the pin-count matrix."""
    if hg.num_edges == 0:
        return 0.0
    cnt = _edge_part_counts(hg, assign, k)
    lam = (cnt > 0).sum(axis=1)
    return float((hg.edge_weights * (lam - 1)).sum())


def _edge_part_counts(hg: Hypergraph, assign: np.ndarray, k: int) -> np.ndarray:
    """cnt[e, p] = number of pins of edge e in partition p."""
    cnt = np.zeros((hg.num_edges, k), dtype=np.int32)
    pin_edge = np.repeat(
        np.arange(hg.num_edges, dtype=np.int64), np.diff(hg.edge_ptr)
    )
    np.add.at(cnt, (pin_edge, assign[hg.edge_nodes]), 1)
    return cnt


# --------------------------------------------------------------- coarsening
def _coarsen_once(hg: Hypergraph, capacity: float, rng: np.random.Generator):
    """One level of connectivity-weighted matching.  Returns (coarse_hg, map)
    where map[v] = coarse cluster id.

    CSR-vectorized but bit-identical to the original per-node dict loop:
    neighbor scores accumulate in the same (incident-edge, pin) stream order,
    and ties between equal scores resolve to the first-encountered neighbor.
    """
    n = hg.num_nodes
    node_ptr, node_edges = hg.incidence()
    order = rng.permutation(n).tolist()
    esz = hg.edge_sizes()
    edge_ok = (esz >= 2) & (esz <= _MAX_EDGE_FOR_MATCH)
    wpe = np.where(edge_ok, hg.edge_weights / np.maximum(esz - 1, 1), 0.0)
    # per node, the concatenated pins of its eligible incident edges — the
    # neighbor-candidate stream, in the original scan order.  The scan below
    # is the original dict loop verbatim, just over plain Python lists (CSR
    # slicing and numpy scalar boxing were the cost, not the dict).
    counts = np.where(edge_ok[node_edges], esz[node_edges], 0)
    total = int(counts.sum())
    cstart = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=cstart[1:])
    entry = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    off = np.arange(total, dtype=np.int64) - cstart[entry]
    s_edges = node_edges[entry]
    s_pins = hg.edge_nodes[hg.edge_ptr[s_edges] + off].tolist()
    s_w = wpe[s_edges].tolist()
    v_start = cstart[node_ptr].tolist()
    nw = hg.node_weights.tolist()
    match = [-1] * n
    for v in order:
        if match[v] != -1:
            continue
        scores: dict[int, float] = {}
        for i in range(v_start[v], v_start[v + 1]):
            u = s_pins[i]
            if u != v and match[u] == -1:
                scores[u] = scores.get(u, 0.0) + s_w[i]
        best_u, best_s = -1, 0.0
        wv = nw[v]
        for u, s in scores.items():
            if s > best_s and wv + nw[u] <= capacity:
                best_u, best_s = u, s
        if best_u >= 0:
            match[v] = best_u
            match[best_u] = v
        else:
            match[v] = v
    # build cluster ids
    cmap = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for v in range(n):
        if cmap[v] == -1:
            cmap[v] = nxt
            if match[v] != v and match[v] != -1:
                cmap[match[v]] = nxt
            nxt += 1
    # contract
    cw = np.zeros(nxt, dtype=np.float64)
    np.add.at(cw, cmap, hg.node_weights)
    # rebuild edges on clusters: within-edge sort+dedup vectorized, then
    # identical edges merged in first-occurrence order (same as the dict)
    E = hg.num_edges
    cpins = cmap[hg.edge_nodes]
    pin_edge = np.repeat(np.arange(E, dtype=np.int64), esz)
    so = np.lexsort((cpins, pin_edge))
    sc, se = cpins[so], pin_edge[so]
    keep = np.ones(len(sc), dtype=bool)
    keep[1:] = (sc[1:] != sc[:-1]) | (se[1:] != se[:-1])
    sc, se = sc[keep], se[keep]
    new_sz = np.bincount(se, minlength=E)
    ptr2 = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(new_sz, out=ptr2[1:])
    edge_map: dict[bytes, int] = {}
    slices: list[np.ndarray] = []
    weights: list[float] = []
    for e in range(E):
        if new_sz[e] < 2:
            continue
        pins = sc[ptr2[e]: ptr2[e + 1]]
        key = pins.tobytes()
        i = edge_map.get(key)
        if i is None:
            edge_map[key] = len(slices)
            slices.append(pins)
            weights.append(float(hg.edge_weights[e]))
        else:
            weights[i] += float(hg.edge_weights[e])
    cptr = np.zeros(len(slices) + 1, dtype=np.int64)
    if slices:
        np.cumsum([len(s) for s in slices], out=cptr[1:])
        cnodes = np.concatenate(slices)
    else:
        cnodes = np.zeros(0, dtype=np.int64)
    coarse = Hypergraph(
        cptr, cnodes, cw, np.asarray(weights, dtype=np.float64)
    )
    return coarse, cmap


# ------------------------------------------------------- initial partitioning
def _initial_partition(
    hg: Hypergraph, k: int, capacity: float, rng: np.random.Generator
) -> np.ndarray:
    """Greedy growth: place heavy nodes first into the partition with max
    connectivity gain that still has room."""
    n = hg.num_nodes
    assign = np.full(n, -1, dtype=np.int64)
    loads = np.zeros(k, dtype=np.float64)
    node_ptr, node_edges = hg.incidence()
    # heaviest-first (FFD-style, keeps weighted instances packable), degree
    # as tie-break so connected nodes cluster; random jitter de-correlates runs
    deg = hg.degrees()
    wspan = hg.node_weights.max() - hg.node_weights.min()
    key = deg + rng.random(n)
    if wspan > 1e-12:
        key = hg.node_weights * (2 * deg.max() + 2) + key
    order = np.argsort(-key, kind="stable")
    cnt = np.zeros((hg.num_edges, k), dtype=np.int32)
    for v in order:
        wv = hg.node_weights[v]
        edges = node_edges[node_ptr[v] : node_ptr[v + 1]]
        gain = np.zeros(k, dtype=np.float64)
        if len(edges):
            sub = cnt[edges]  # (d, k)
            gain = (sub > 0).astype(np.float64).T @ hg.edge_weights[edges]
        feasible = loads + wv <= capacity
        if not feasible.any():
            p = int(np.argmin(loads))  # fixup pass will repair
        else:
            gain = np.where(feasible, gain, -np.inf)
            # tie-break toward least-loaded partitions for balance
            p = int(np.argmax(gain - 1e-9 * loads))
        assign[v] = p
        loads[p] += wv
        if len(edges):
            cnt[edges, p] += 1
    return assign


# ----------------------------------------------------------------- refinement
def _move_gains(cnt, edges, w, a):
    """Connectivity gain of moving a node (with incident `edges`, weights `w`,
    currently in part `a`) to every part.  gain[b]: edges where the node is
    the sole pin in `a` stop spanning `a` (gain w_e if `b` already pinned);
    edges unpinned in `b` start spanning it (loss w_e unless the sole pin
    travels along).  Computed as two masked vector-matrix products."""
    sub = cnt[edges]  # (d, k)
    sole = sub[:, a] == 1
    nz = sub > 0
    gain = (w * sole) @ nz - (w * ~sole) @ ~nz
    gain[a] = 0.0
    return gain


def _refine(
    hg: Hypergraph,
    assign: np.ndarray,
    k: int,
    capacity: float,
    rng: np.random.Generator,
    passes: int = 3,
    swap_candidates: int = 24,
) -> np.ndarray:
    """FM-style greedy passes on the connectivity objective, with pairwise
    swaps as a fallback when capacity blocks a single move (the zero-slack
    regime: |V| == k*C).

    Hot-path shortcut (exact): a move or swap of node v can only trigger if
    some gain[b] > 1e-12, and for non-negative edge weights that requires v
    to be the SOLE pin of an incident edge in its own partition.  Nodes whose
    best gain is known to be <= 1e-12 are "settled" and skipped without
    recomputing gains or touching the RNG (the skipped iteration is a no-op
    in the original loop too).  Settled status depends only on the pin-count
    rows of v's incident edges — NOT on loads or feasibility — so it stays
    valid across passes and is invalidated exactly when a pin of one of
    those edges moves."""
    if hg.num_edges == 0 or k == 1:
        return assign
    node_ptr, node_edges = hg.incidence()
    cnt = _edge_part_counts(hg, assign, k)
    loads = np.zeros(k, dtype=np.float64)
    np.add.at(loads, assign, hg.node_weights)
    part_nodes: list[set[int]] = [set() for _ in range(k)]
    for v, p in enumerate(assign):
        part_nodes[int(p)].add(v)
    w_stream = hg.edge_weights[node_edges]
    deg = np.diff(node_ptr)

    # nodes with no sole pin in their own partition start out settled
    col = cnt[node_edges, np.repeat(assign, deg)] == 1
    cum = np.zeros(len(col) + 1, dtype=np.int64)
    np.cumsum(col, out=cum[1:])
    settled = ~(cum[node_ptr[1:]] > cum[node_ptr[:-1]])
    cache_ok = np.ones(hg.num_nodes, dtype=bool)

    def invalidate(edge_ids):
        for e in edge_ids:
            cache_ok[hg.edge(int(e))] = False

    for _ in range(passes):
        improved = False
        for v in rng.permutation(hg.num_nodes):
            if cache_ok[v] and settled[v]:
                continue
            edges = node_edges[node_ptr[v] : node_ptr[v + 1]]
            if len(edges) == 0:
                continue
            a = int(assign[v])
            if not cache_ok[v]:
                cache_ok[v] = True
                if not (cnt[edges, a] == 1).any():
                    settled[v] = True
                    continue
            wv = hg.node_weights[v]
            w = w_stream[node_ptr[v] : node_ptr[v + 1]]
            gain = _move_gains(cnt, edges, w, a)
            settled[v] = bool(gain.max() <= 1e-12)
            feasible = loads + wv <= capacity
            feasible[a] = True
            move_gain = np.where(feasible, gain, -np.inf)
            b = int(np.argmax(move_gain))
            if b != a and move_gain[b] > 1e-12:
                assign[v] = b
                loads[a] -= wv
                loads[b] += wv
                cnt[edges, a] -= 1
                cnt[edges, b] += 1
                invalidate(edges)
                part_nodes[a].discard(int(v))
                part_nodes[b].add(int(v))
                improved = True
                continue
            # ---- swap fallback: the best *infeasible* target might pay for
            # sending one of its nodes back
            b = int(np.argmax(gain))
            if b == a or gain[b] <= 1e-12 or len(part_nodes[b]) == 0:
                continue
            # tentatively move v -> b
            cnt[edges, a] -= 1
            cnt[edges, b] += 1
            cand = list(part_nodes[b])
            if len(cand) > swap_candidates:
                cand = [cand[i] for i in rng.choice(len(cand),
                                                    swap_candidates,
                                                    replace=False)]
            best_u, best_total = -1, 1e-12
            for u in cand:
                wu = hg.node_weights[u]
                if (loads[a] - wv + wu > _cap_at(capacity, a)
                        or loads[b] + wv - wu > _cap_at(capacity, b)):
                    continue
                eu = node_edges[node_ptr[u] : node_ptr[u + 1]]
                if len(eu) == 0:
                    g_u = 0.0
                else:
                    g_u = _move_gains(cnt, eu, hg.edge_weights[eu], b)[a]
                total = gain[b] + g_u
                if total > best_total:
                    best_u, best_total = int(u), total
            if best_u >= 0:
                u = best_u
                eu = node_edges[node_ptr[u] : node_ptr[u + 1]]
                cnt[eu, b] -= 1
                cnt[eu, a] += 1
                invalidate(edges)
                invalidate(eu)
                assign[v], assign[u] = b, a
                loads[a] += hg.node_weights[u] - wv
                loads[b] += wv - hg.node_weights[u]
                part_nodes[a].discard(int(v))
                part_nodes[a].add(u)
                part_nodes[b].discard(u)
                part_nodes[b].add(int(v))
                improved = True
            else:
                cnt[edges, a] += 1  # revert tentative
                cnt[edges, b] -= 1
        if not improved:
            break
    return assign


def _fixup_capacity(
    hg: Hypergraph, assign: np.ndarray, k: int, capacity: float
) -> np.ndarray:
    """Repair capacity violations by evicting the loosest nodes (the paper
    uses an LMBR-style move for this; greedy lowest-connectivity move is the
    same idea without replication)."""
    loads = np.zeros(k, dtype=np.float64)
    np.add.at(loads, assign, hg.node_weights)
    node_ptr, node_edges = hg.incidence()
    for p in range(k):
        guard = 0
        while loads[p] > _cap_at(capacity, p) + 1e-9 and guard < hg.num_nodes:
            guard += 1
            members = np.flatnonzero(assign == p)
            # evict the node with the fewest incident pins in p (lightest on ties)
            best_v, best_key = -1, (np.inf, np.inf)
            for v in members:
                d = len(node_edges[node_ptr[v] : node_ptr[v + 1]])
                kkey = (d, -hg.node_weights[v])
                if kkey < best_key:
                    best_v, best_key = int(v), kkey
            wv = hg.node_weights[best_v]
            frees = capacity - loads
            frees[p] = -np.inf
            tgt = int(np.argmax(frees))
            if frees[tgt] >= wv - 1e-9:
                assign[best_v] = tgt
                loads[p] -= wv
                loads[tgt] += wv
                continue
            # swap fallback: exchange with a lighter node elsewhere
            done = False
            for q in np.argsort(-frees):
                q = int(q)
                if q == p:
                    continue
                for u in np.flatnonzero(assign == q):
                    wu = hg.node_weights[u]
                    if (wu < wv
                            and loads[q] - wu + wv <= _cap_at(capacity, q) + 1e-9
                            and loads[p] - wv + wu
                            <= _cap_at(capacity, p) + 1e-9 * 0 + loads[p]):
                        assign[best_v], assign[int(u)] = q, p
                        loads[p] += wu - wv
                        loads[q] += wv - wu
                        done = True
                        break
                if done:
                    break
            if not done:
                raise ValueError("cannot satisfy capacity constraints")
    return assign


# -------------------------------------------------------------------- driver
_PARTITION_CACHE: OrderedDict[str, np.ndarray] = OrderedDict()
_PARTITION_CACHE_MAX = 8


@contextlib.contextmanager
def fresh_partition_cache():
    """Scope the partition memo: run the body against an empty cache, then
    restore the previous one.

    `partition` is a pure function, so the memo never changes placements —
    only who gets billed for shared work.  Benchmarks that time algorithms
    individually (Simulator.run) enter this scope so each algorithm pays for
    its own partition calls instead of free-riding on whichever algorithm
    ran first; the memo still dedups identical calls *within* one run (e.g.
    IHPA's repeated base partition)."""
    global _PARTITION_CACHE
    saved = _PARTITION_CACHE
    _PARTITION_CACHE = OrderedDict()
    try:
        yield
    finally:
        _PARTITION_CACHE = saved


def _partition_key(hg, k, capacity, seed, nruns, passes, coarsen_to) -> str:
    h = hashlib.sha1()
    for arr in (hg.edge_ptr, hg.edge_nodes, hg.node_weights, hg.edge_weights):
        h.update(np.ascontiguousarray(arr).tobytes())
    if isinstance(capacity, np.ndarray) and capacity.ndim:
        h.update(np.ascontiguousarray(capacity, dtype=np.float64).tobytes())
        cap_repr = "het"
    else:
        cap_repr = float(capacity)
    h.update(
        repr((k, cap_repr, seed, nruns, passes, coarsen_to)).encode()
    )
    return h.hexdigest()


def partition(
    hg: Hypergraph,
    k: int,
    capacity: float | None = None,
    seed: int = 0,
    nruns: int = 2,
    passes: int = 3,
    coarsen_to: int | None = None,
) -> np.ndarray:
    """Partition `hg` into `k` parts under per-part `capacity`.

    Returns assign: (V,) int64, values in [0, k).  Items with zero degree are
    balanced across parts by weight.

    `partition` is a deterministic pure function of its arguments, and the
    placement algorithms routinely issue *identical* calls (HPA / IHPA / DS
    all start from the same N_e-way partition of the same workload), so
    results are memoized in a small content-addressed LRU."""
    n = hg.num_nodes
    if capacity is None:
        capacity = hg.total_node_weight() / k * 1.05 + hg.node_weights.max()
    het = isinstance(capacity, np.ndarray) and capacity.ndim
    if het and len(capacity) != k:
        raise ValueError(
            f"capacity vector has {len(capacity)} entries, want k={k}"
        )
    total_cap = float(capacity.sum()) if het else k * capacity
    if hg.total_node_weight() > total_cap + 1e-9:
        raise ValueError(
            f"items (w={hg.total_node_weight()}) cannot fit {k} x {capacity}"
        )
    if k <= 1:
        return np.zeros(n, dtype=np.int64)
    if coarsen_to is None:
        coarsen_to = max(128, 12 * k)

    key = _partition_key(hg, k, capacity, seed, nruns, passes, coarsen_to)
    cached = _PARTITION_CACHE.get(key)
    if cached is not None:
        _PARTITION_CACHE.move_to_end(key)
        return cached.copy()

    _tr = _obs.tracer()
    _t0 = time.perf_counter() if _tr.active else 0.0
    best_assign, best_cost = None, np.inf
    for run in range(max(1, nruns)):
        rng = np.random.default_rng(seed + 7919 * run)
        # ---- coarsening phase
        _tc = time.perf_counter() if _tr.active else 0.0
        levels: list[tuple[Hypergraph, np.ndarray]] = []
        cur = hg
        # heterogeneous capacities coarsen against the tightest part: no
        # cluster may exceed the smallest capacity (same semantics as the
        # scalar bound); the scalar object passes through untouched
        coarse_cap = float(np.min(capacity)) if het else capacity
        while cur.num_nodes > coarsen_to:
            coarse, cmap = _coarsen_once(cur, coarse_cap, rng)
            if coarse.num_nodes >= 0.95 * cur.num_nodes:
                break  # diminishing returns
            levels.append((cur, cmap))
            cur = coarse
        if _tr.active:
            _tr.complete("fit.hpa.coarsen", _tc, time.perf_counter(),
                         run=run, levels=len(levels), coarse_n=cur.num_nodes)
        # ---- initial partition on coarsest graph
        _tc = time.perf_counter() if _tr.active else 0.0
        assign = _initial_partition(cur, k, capacity, rng)
        assign = _refine(cur, assign, k, capacity, rng, passes)
        # ---- uncoarsen + refine
        for fine, cmap in reversed(levels):
            assign = assign[cmap]
            assign = _refine(fine, assign, k, capacity, rng, passes)
        assign = _fixup_capacity(hg, assign, k, capacity)
        if _tr.active:
            _tr.complete("fit.hpa.refine", _tc, time.perf_counter(), run=run)
        cost = connectivity_cost(hg, assign, k)
        if cost < best_cost:
            best_cost, best_assign = cost, assign.copy()
    _PARTITION_CACHE[key] = best_assign.copy()
    if len(_PARTITION_CACHE) > _PARTITION_CACHE_MAX:
        _PARTITION_CACHE.popitem(last=False)
    if _tr.active:
        _tr.complete("fit.hpa", _t0, time.perf_counter(), k=k,
                     n=n, nruns=nruns)
    return best_assign

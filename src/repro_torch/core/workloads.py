"""Workload generators (paper §5.2) used by the placement pipeline.

  * random_workload      — queries are connected subgraphs of a random
    data-item graph of given density (the paper's Random dataset);
  * lmbr_stress_workload — the LMBR stress tier (2 500 items, 10 000
    queries, density 12, 64 partitions);
  * ispd_like_workload   — sparse hypergraphs matching ISPD98 statistics
    (density ~1.1, mostly 2-3 pins with a geometric tail).

Copies of the JAX package's generators: the same seed gives byte-identical
CSR arrays and weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .hypergraph import Hypergraph

__all__ = [
    "Workload", "random_workload", "ispd_like_workload",
    "lmbr_stress_workload", "LMBR_STRESS_DEFAULTS",
]


@dataclasses.dataclass
class Workload:
    hypergraph: Hypergraph
    name: str
    item_graph_edges: np.ndarray | None = None  # (M,2) underlying item graph


def _connected_subgraph_query(
    adj: list[np.ndarray], rng: np.random.Generator, size: int
) -> list[int]:
    """Random connected subgraph by frontier growth from a random seed."""
    n = len(adj)
    start = int(rng.integers(n))
    chosen = {start}
    frontier = list(adj[start])
    while len(chosen) < size and frontier:
        idx = int(rng.integers(len(frontier)))
        v = int(frontier.pop(idx))
        if v in chosen:
            continue
        chosen.add(v)
        frontier.extend(int(u) for u in adj[v] if u not in chosen)
    return sorted(chosen)


def _build_adj(num_items: int, edges: np.ndarray) -> list[np.ndarray]:
    adj: list[list[int]] = [[] for _ in range(num_items)]
    for a, b in edges:
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    return [np.asarray(sorted(set(x)), dtype=np.int64) for x in adj]


def random_workload(
    num_items: int = 1000,
    num_queries: int = 4000,
    min_query: int = 3,
    max_query: int = 11,
    density: float = 20,
    seed: int = 0,
) -> Workload:
    rng = np.random.default_rng(seed)
    num_edges = int(density * num_items)
    # random item graph over a spanning-tree backbone (keeps it connected)
    tree = np.stack(
        [np.arange(1, num_items),
         rng.integers(0, np.arange(1, num_items))], axis=1
    )
    extra = rng.integers(0, num_items, size=(max(0, num_edges - num_items + 1), 2))
    extra = extra[extra[:, 0] != extra[:, 1]]
    edges = np.concatenate([tree, extra], axis=0)
    adj = _build_adj(num_items, edges)
    queries = []
    for _ in range(num_queries):
        size = int(rng.integers(min_query, max_query + 1))
        queries.append(_connected_subgraph_query(adj, rng, size))
    hg = Hypergraph.from_edges(queries, num_nodes=num_items)
    return Workload(hg, f"random(d={density})", edges)


LMBR_STRESS_DEFAULTS = dict(
    num_items=2500, num_queries=10000, density=12,
    capacity=50, num_partitions=64, max_moves=1200,
)


def lmbr_stress_workload(
    num_items: int = LMBR_STRESS_DEFAULTS["num_items"],
    num_queries: int = LMBR_STRESS_DEFAULTS["num_queries"],
    density: float = LMBR_STRESS_DEFAULTS["density"],
    seed: int = 0,
) -> Workload:
    """The LMBR stress tier: a Random-dataset instance ~6x the paper's
    default LMBR workload; partition count and capacity live in
    ``LMBR_STRESS_DEFAULTS``."""
    wl = random_workload(
        num_items=num_items, num_queries=num_queries,
        min_query=3, max_query=11, density=density, seed=seed,
    )
    wl.name = f"lmbr-stress(V={num_items},E={num_queries})"
    return wl


def ispd_like_workload(
    num_nodes: int = 12752,
    num_edges: int | None = None,
    seed: int = 0,
) -> Workload:
    """Sparse circuit-like hypergraph: density ~1.1, hyperedge sizes follow
    the ISPD98 profile (mostly 2-3 pins, geometric tail to ~20)."""
    rng = np.random.default_rng(seed)
    if num_edges is None:
        num_edges = int(1.1 * num_nodes)
    sizes = 2 + rng.geometric(0.55, size=num_edges)
    sizes = np.clip(sizes, 2, 24)
    # locality structure: nodes near each other (in a shuffled order)
    # connect, as placed circuits do
    perm = rng.permutation(num_nodes)
    queries = []
    for s in sizes:
        center = int(rng.integers(num_nodes))
        window = 64
        lo = max(0, center - window)
        hi = min(num_nodes, center + window)
        pick = rng.choice(np.arange(lo, hi), size=min(s, hi - lo), replace=False)
        queries.append(sorted(set(int(perm[i]) for i in pick)))
    hg = Hypergraph.from_edges(queries, num_nodes=num_nodes)
    return Workload(hg, f"ispd-like(n={num_nodes})")

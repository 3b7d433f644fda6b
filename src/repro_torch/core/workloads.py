"""Workload generators (paper §5.2) used by the placement pipeline.

  * random_workload      — queries are connected subgraphs of a random
    data-item graph of given density (the paper's Random dataset);
  * snowflake_workload   — the data-item graph is a tree mimicking a
    star/snowflake SQL schema; queries are connected subgraphs;
  * tpch_heterogeneous   — snowflake with TPC-H-skewed item sizes (fig. 8);
  * lmbr_stress_workload — the LMBR stress tier (2 500 items, 10 000
    queries, density 12, 64 partitions);
  * ispd_like_workload   — sparse hypergraphs matching ISPD98 statistics
    (density ~1.1, mostly 2-3 pins with a geometric tail);
  * web_scale_chunks / web_scale_workload — the web-scale tier (100 000
    items in power-law content clusters, a million queries with a thin
    cross-cluster seam), streamed as raw CSR chunks.

Copies of the JAX package's generators: the same seed gives byte-identical
CSR arrays and weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .hypergraph import Hypergraph

__all__ = [
    "Workload", "random_workload", "snowflake_workload",
    "ispd_like_workload", "tpch_heterogeneous", "lmbr_stress_workload",
    "PAPER_DEFAULTS", "LMBR_STRESS_DEFAULTS", "WEB_SCALE_DEFAULTS",
    "web_scale_chunks", "web_scale_workload",
]

PAPER_DEFAULTS = dict(
    num_items=1000, min_query=3, max_query=11, num_queries=4000,
    capacity=50, num_partitions=40, density=20,
)


@dataclasses.dataclass
class Workload:
    hypergraph: Hypergraph
    name: str
    item_graph_edges: np.ndarray | None = None  # (M,2) underlying item graph

    @property
    def queries(self):
        return [self.hypergraph.edge(e) for e in range(self.hypergraph.num_edges)]


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


def snowflake_workload(
    levels: int = 3,
    degree: int = 5,
    attrs_per_table: int = 15,
    num_items: int = 2000,
    num_queries: int = 4000,
    min_query: int = 3,
    max_query: int = 11,
    seed: int = 0,
    item_weights: np.ndarray | None = None,
) -> Workload:
    """Tree-shaped data-item graph: tables form a tree (fan-out `degree`,
    `levels` levels); each table contributes a key item plus attribute
    items hanging off the key, attached round-robin.  Queries = connected
    subgraphs (joins along the tree + attribute accesses).
    ``attrs_per_table`` is accepted as the reference's is, and unused."""
    rng = np.random.default_rng(seed)
    edges = []
    table_keys = [0]  # item 0 = root fact-table key
    next_item = 1
    frontier = [0]
    level = 1
    while next_item < num_items and level < levels:
        new_frontier = []
        for parent_key in frontier:
            for _ in range(degree):
                if next_item >= num_items:
                    break
                child_key = next_item
                next_item += 1
                edges.append((parent_key, child_key))  # join edge
                table_keys.append(child_key)
                new_frontier.append(child_key)
        frontier = new_frontier
        level += 1
    ti = 0
    while next_item < num_items:
        edges.append((table_keys[ti % len(table_keys)], next_item))
        next_item += 1
        ti += 1
    edges = np.asarray(edges, dtype=np.int64)
    adj = _build_adj(num_items, edges)
    queries = []
    for _ in range(num_queries):
        size = int(rng.integers(min_query, max_query + 1))
        queries.append(_connected_subgraph_query(adj, rng, size))
    hg = Hypergraph.from_edges(
        queries, num_nodes=num_items, node_weights=item_weights
    )
    return Workload(hg, "snowflake", edges)


def tpch_heterogeneous(
    num_items: int = 2000,
    num_queries: int = 4000,
    scale_factor: int = 25,
    seed: int = 0,
    target_min_partitions: int = 20,
    capacity: float = 100.0,
    **kw,
) -> Workload:
    """Snowflake workload with TPC-H-skewed column sizes (fig. 8).

    Log-uniform sizes between 25 KB and 28 GB (SF = 25) in GB, 15% large
    fact-table columns and 85% small dimension columns, scaled so that
    N_e == ``target_min_partitions`` at ``capacity`` (the skew ratio is
    kept).  ``scale_factor`` only names the workload."""
    rng = np.random.default_rng(seed + 1)
    lo, hi = 25e-6, 28.0  # GB at SF=25
    big = rng.uniform(np.log(1.0), np.log(hi), size=num_items)
    small = rng.uniform(np.log(lo), np.log(0.5), size=num_items)
    is_big = rng.random(num_items) < 0.15
    weights = np.exp(np.where(is_big, big, small))
    target_total = 0.97 * target_min_partitions * capacity
    weights = weights * (target_total / weights.sum())
    wl = snowflake_workload(
        num_items=num_items, num_queries=num_queries, seed=seed,
        item_weights=weights, **kw,
    )
    wl.name = f"tpch-hetero(sf={scale_factor})"
    return wl


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


# the web-scale tier: item catalog clustered into power-law content
# domains, a million queries with power-law domain popularity and a thin
# seam of cross-domain queries — the structure repro_torch.scale's sharder
# exploits.  Capacity is ~2x the feasibility minimum.
WEB_SCALE_DEFAULTS = dict(
    num_items=100_000, num_queries=1_000_000, num_partitions=256,
    capacity=800, num_clusters=2048, min_query=2, max_query=8,
    cross_frac=0.02,
)


def web_scale_chunks(
    num_items: int = WEB_SCALE_DEFAULTS["num_items"],
    num_queries: int = WEB_SCALE_DEFAULTS["num_queries"],
    num_clusters: int = WEB_SCALE_DEFAULTS["num_clusters"],
    min_query: int = WEB_SCALE_DEFAULTS["min_query"],
    max_query: int = WEB_SCALE_DEFAULTS["max_query"],
    cross_frac: float = WEB_SCALE_DEFAULTS["cross_frac"],
    skew: float = 1.1,
    seed: int = 0,
    chunk: int = 200_000,
):
    """Yield the web-scale trace as raw CSR chunks ``(edge_ptr, edge_nodes)``
    — the streaming ingestion shape
    (`repro_torch.scale.StreamingHypergraphBuilder.add_csr`).  Pins may
    repeat within a query (canonicalization dedups).

    Items split into ``num_clusters`` power-law-sized content clusters;
    each query samples one cluster by power-law popularity and draws
    ``min_query..max_query`` pins inside it; a ``cross_frac`` fraction
    draws its second half from another cluster (the cross-shard seam).
    Vectorized over each chunk; the chunk size shapes the random stream."""
    num_clusters = min(num_clusters, max(1, num_items // 4))
    rng = np.random.default_rng(seed)
    raw = (np.arange(1, num_clusters + 1, dtype=np.float64)) ** (-skew)
    csize = np.maximum(4, (raw / raw.sum() * num_items).astype(np.int64))
    # reconcile the rounding drift against the biggest cluster
    csize[0] += num_items - int(csize.sum())
    cstart = np.zeros(num_clusters, dtype=np.int64)
    np.cumsum(csize[:-1], out=cstart[1:])
    pop = np.cumsum(raw / raw.sum())
    done = 0
    while done < num_queries:
        B = min(chunk, num_queries - done)
        c1 = np.searchsorted(pop, rng.random(B)).clip(0, num_clusters - 1)
        c2 = rng.integers(0, num_clusters, size=B)
        cross = rng.random(B) < cross_frac
        k = rng.integers(min_query, max_query + 1, size=B)
        ptr = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(k, out=ptr[1:])
        pin_q = np.repeat(np.arange(B, dtype=np.int64), k)
        pos = np.arange(int(ptr[-1]), dtype=np.int64) - np.repeat(ptr[:-1], k)
        use2 = cross[pin_q] & (pos >= (k[pin_q] // 2))
        cl = np.where(use2, c2[pin_q], c1[pin_q])
        pins = cstart[cl] + rng.integers(0, csize[cl])
        yield ptr, pins
        done += B


def web_scale_workload(seed: int = 0, chunk: int = 200_000, **kw) -> Workload:
    """The web-scale tier as a built `Workload`, streamed through
    `StreamingHypergraphBuilder`.  ``**kw`` forwards to
    `web_scale_chunks`."""
    from ..scale.stream import StreamingHypergraphBuilder  # avoid cycle

    params = {k: v for k, v in WEB_SCALE_DEFAULTS.items()
              if k not in ("num_partitions", "capacity")}
    params.update(kw)
    builder = StreamingHypergraphBuilder(params["num_items"])
    for ptr, pins in web_scale_chunks(seed=seed, chunk=chunk, **params):
        builder.add_csr(ptr, pins)
    hg = builder.build()
    return Workload(hg, f"web-scale(V={hg.num_nodes},E={hg.num_edges})")


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

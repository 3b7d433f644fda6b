"""Hypergraph workload model (paper §3).

Nodes are data items (possibly weighted); hyperedges are queries (possibly
weighted by frequency).  Backed by CSR numpy arrays.  A copy of the JAX
package's ``core/hypergraph.py`` cut down to what the placement pipeline
reads (the paper's algorithms 1-5 included); ``from_reference_arrays``
takes that package's arrays as they are.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, Sequence

import numpy as np

__all__ = ["Hypergraph", "MutableHypergraph", "build_incidence",
           "canonicalize_csr", "csr_ranges", "from_reference_arrays"]


def csr_ranges(ptr: np.ndarray, ids: np.ndarray):
    """Flat-gather indices of the CSR rows `ids`: returns (out_ptr, idx)
    where ``idx`` concatenates the ranges ``[ptr[i], ptr[i+1])`` for each
    id in order and ``out_ptr`` is the CSR of the result."""
    ids = np.asarray(ids, dtype=np.int64)
    sizes = ptr[ids + 1] - ptr[ids]
    out_ptr = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(sizes, out=out_ptr[1:])
    total = int(out_ptr[-1])
    base = np.repeat(ptr[ids], sizes)
    off = np.arange(total, dtype=np.int64) - np.repeat(out_ptr[:-1], sizes)
    return out_ptr, base + off


def build_incidence(edge_ptr: np.ndarray, edge_nodes: np.ndarray, num_nodes: int):
    """Invert the edge->node CSR into a node->edge CSR."""
    num_edges = len(edge_ptr) - 1
    pin_edge = np.repeat(np.arange(num_edges, dtype=np.int64), np.diff(edge_ptr))
    order = np.argsort(edge_nodes, kind="stable")
    node_edges = pin_edge[order]
    sorted_nodes = edge_nodes[order]
    node_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    counts = np.bincount(sorted_nodes, minlength=num_nodes)
    node_ptr[1:] = np.cumsum(counts)
    return node_ptr, node_edges


def canonicalize_csr(edge_ptr: np.ndarray, edge_nodes: np.ndarray):
    """Sort and deduplicate the pins of every CSR edge in one vectorized
    pass: each edge's pins become exactly ``np.unique(edge)``."""
    edge_ptr = np.asarray(edge_ptr, dtype=np.int64)
    edge_nodes = np.asarray(edge_nodes, dtype=np.int64)
    E = len(edge_ptr) - 1
    sizes = np.diff(edge_ptr)
    if len(edge_nodes) == 0:
        return edge_ptr.copy(), edge_nodes.copy()
    eid = np.repeat(np.arange(E, dtype=np.int64), sizes)
    order = np.lexsort((edge_nodes, eid))
    nodes = edge_nodes[order]
    eids = eid[order]
    keep = np.ones(len(nodes), dtype=bool)
    keep[1:] = (nodes[1:] != nodes[:-1]) | (eids[1:] != eids[:-1])
    new_nodes = nodes[keep]
    counts = np.bincount(eids[keep], minlength=E)
    new_ptr = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(counts, out=new_ptr[1:])
    return new_ptr, new_nodes


@dataclasses.dataclass
class Hypergraph:
    """Immutable CSR hypergraph.

    edge_ptr:    (E+1,) int64 — CSR offsets into edge_nodes
    edge_nodes:  (P,)   int64 — node ids, pins of each hyperedge
    node_weights:(V,)   float64 — item sizes (1.0 for homogeneous)
    edge_weights:(E,)   float64 — query frequencies (1.0 default)
    """

    edge_ptr: np.ndarray
    edge_nodes: np.ndarray
    node_weights: np.ndarray
    edge_weights: np.ndarray
    # lazily built node->edge incidence
    _node_ptr: np.ndarray | None = None
    _node_edges: np.ndarray | None = None

    @staticmethod
    def from_edges(
        edges: Sequence[Iterable[int]],
        num_nodes: int | None = None,
        node_weights: np.ndarray | None = None,
        edge_weights: np.ndarray | None = None,
    ) -> "Hypergraph":
        edge_lists = [np.unique(np.asarray(list(e), dtype=np.int64)) for e in edges]
        if num_nodes is None:
            num_nodes = (
                int(max((int(e.max()) for e in edge_lists if len(e)), default=-1)) + 1
            )
        edge_ptr = np.zeros(len(edge_lists) + 1, dtype=np.int64)
        edge_ptr[1:] = np.cumsum([len(e) for e in edge_lists])
        edge_nodes = (
            np.concatenate(edge_lists)
            if edge_lists
            else np.zeros(0, dtype=np.int64)
        )
        if node_weights is None:
            node_weights = np.ones(num_nodes, dtype=np.float64)
        else:
            node_weights = np.asarray(node_weights, dtype=np.float64)
            assert len(node_weights) == num_nodes
        if edge_weights is None:
            edge_weights = np.ones(len(edge_lists), dtype=np.float64)
        else:
            edge_weights = np.asarray(edge_weights, dtype=np.float64)
        return Hypergraph(edge_ptr, edge_nodes, node_weights, edge_weights)

    @property
    def num_nodes(self) -> int:
        return len(self.node_weights)

    @property
    def num_edges(self) -> int:
        return len(self.edge_ptr) - 1

    @property
    def num_pins(self) -> int:
        return len(self.edge_nodes)

    def edge(self, e: int) -> np.ndarray:
        return self.edge_nodes[self.edge_ptr[e] : self.edge_ptr[e + 1]]

    def edge_sizes(self) -> np.ndarray:
        return np.diff(self.edge_ptr)

    def total_node_weight(self) -> float:
        return float(self.node_weights.sum())

    def density(self) -> float:
        return self.num_edges / max(self.num_nodes, 1)

    def avg_items_per_query(self) -> float:
        """avgDataItemsPerQuery subroutine (paper §4.1)."""
        if self.num_edges == 0:
            return 0.0
        return float(self.edge_sizes().mean())

    def incidence(self):
        if self._node_ptr is None:
            self._node_ptr, self._node_edges = build_incidence(
                self.edge_ptr, self.edge_nodes, self.num_nodes
            )
        return self._node_ptr, self._node_edges

    def node_edges_of(self, v: int) -> np.ndarray:
        node_ptr, node_edges = self.incidence()
        return node_edges[node_ptr[v] : node_ptr[v + 1]]

    def degrees(self, edge_mask: np.ndarray | None = None) -> np.ndarray:
        """Weighted degree of every node (sum of incident edge weights)."""
        if edge_mask is None:
            w = self.edge_weights
        else:
            w = self.edge_weights * edge_mask
        pin_edge = np.repeat(
            np.arange(self.num_edges, dtype=np.int64), np.diff(self.edge_ptr)
        )
        return np.bincount(
            self.edge_nodes, weights=w[pin_edge], minlength=self.num_nodes
        )

    def pin_indices(self, edge_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """CSR (ptr, idx) of the given hyperedges where ``idx`` are positions
        into the global pin arrays; edges appear in ``edge_ids`` order."""
        return csr_ranges(self.edge_ptr, edge_ids)

    def edges_csr(self, edge_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """CSR (ptr, nodes) of the given hyperedges, vectorized gather."""
        ptr, idx = self.pin_indices(edge_ids)
        return ptr, self.edge_nodes[idx]

    def subhypergraph_edges(self, edge_ids: np.ndarray) -> "Hypergraph":
        """Keep the given hyperedges; node ids are preserved (no relabel)
        and the node weights are shared with ``self``."""
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
        ptr, nodes = self.edges_csr(edge_ids)
        return Hypergraph(
            ptr, nodes, self.node_weights, self.edge_weights[edge_ids]
        )

    def active_nodes(self) -> np.ndarray:
        """Nodes with degree >= 1 (contained in at least one hyperedge)."""
        return np.unique(self.edge_nodes)

    def relabel(self) -> tuple["Hypergraph", np.ndarray]:
        """Compact to active nodes.  Returns (new_graph, old_ids) where
        old_ids[new_id] = original node id."""
        old_ids = self.active_nodes()
        remap = np.full(self.num_nodes, -1, dtype=np.int64)
        remap[old_ids] = np.arange(len(old_ids))
        g = Hypergraph(
            self.edge_ptr.copy(),
            remap[self.edge_nodes],
            self.node_weights[old_ids].copy(),
            self.edge_weights.copy(),
        )
        return g, old_ids

    def k_densest_nodes(self, max_weight: float) -> np.ndarray:
        """getKDensestNodes (paper §4.1): greedily peel the lowest-degree node
        (ties -> lowest node id) until the total remaining node weight is
        at most ``max_weight``.  Returns the surviving node ids."""
        alive_nodes, _, _, _ = self._peel_to_weight(max_weight)
        return np.flatnonzero(alive_nodes)

    def prune_to_size(self, max_weight: float) -> "Hypergraph":
        """pruneHypergraphToSize: the same peel; returns the hypergraph of
        the edges whose every pin survived."""
        _, alive_edges, _, _ = self._peel_to_weight(max_weight)
        return self.subhypergraph_edges(np.flatnonzero(alive_edges))

    def _peel_to_weight(self, max_weight: float):
        """Heap peel on (weighted degree, node id): a node's death kills
        each incident edge, which lowers its surviving pins' degrees."""
        node_ptr, node_edges = self.incidence()
        deg = self.degrees().astype(np.float64)
        alive_nodes = np.zeros(self.num_nodes, dtype=bool)
        active = self.active_nodes()
        alive_nodes[active] = True
        alive_edges = np.ones(self.num_edges, dtype=bool)
        total_w = float(self.node_weights[alive_nodes].sum())
        heap = [(deg[v], int(v)) for v in active]
        heapq.heapify(heap)
        while total_w > max_weight and heap:
            d, v = heapq.heappop(heap)
            if not alive_nodes[v] or d != deg[v]:
                continue  # stale
            alive_nodes[v] = False
            total_w -= float(self.node_weights[v])
            for e in node_edges[node_ptr[v]: node_ptr[v + 1]]:
                if alive_edges[e]:
                    alive_edges[e] = False
                    w = self.edge_weights[e]
                    for u in self.edge(int(e)):
                        if alive_nodes[u]:
                            deg[u] -= w
                            heapq.heappush(heap, (deg[u], int(u)))
        return alive_nodes, alive_edges, deg, total_w

    def equals(self, other: "Hypergraph") -> bool:
        """Exact structural equality: same CSR arrays, same weights."""
        return (
            np.array_equal(self.edge_ptr, other.edge_ptr)
            and np.array_equal(self.edge_nodes, other.edge_nodes)
            and np.array_equal(self.node_weights, other.node_weights)
            and np.array_equal(self.edge_weights, other.edge_weights)
        )

    def copy_mutable(self) -> "MutableHypergraph":
        return MutableHypergraph(
            [list(self.edge(e)) for e in range(self.num_edges)],
            list(self.node_weights),
            list(self.edge_weights),
        )

    def __repr__(self):
        return (
            f"Hypergraph(V={self.num_nodes}, E={self.num_edges}, "
            f"pins={self.num_pins}, density={self.density():.2f})"
        )


class MutableHypergraph:
    """List-of-lists hypergraph used by PRA, which rewrites hyperedges while
    replicating nodes (paper Algorithm 3)."""

    def __init__(self, edges, node_weights, edge_weights):
        self.edges = [list(e) for e in edges]
        self.node_weights = list(node_weights)
        self.edge_weights = list(edge_weights)

    @property
    def num_nodes(self):
        return len(self.node_weights)

    def add_node_copy(self, v: int) -> int:
        """makeNewCopy: clone node v, return the new node id."""
        self.node_weights.append(self.node_weights[v])
        return len(self.node_weights) - 1

    def replace_in_edge(self, e: int, old: int, new: int) -> bool:
        """Rewire the first pin ``old`` of edge e to ``new``."""
        edge = self.edges[e]
        for i, u in enumerate(edge):
            if u == old:
                edge[i] = new
                return True
        return False

    def freeze(self) -> Hypergraph:
        return Hypergraph.from_edges(
            self.edges,
            num_nodes=self.num_nodes,
            node_weights=np.asarray(self.node_weights),
            edge_weights=np.asarray(self.edge_weights),
        )


def from_reference_arrays(edge_ptr, edge_nodes, node_weights, edge_weights,
                          num_nodes: int) -> Hypergraph:
    """A `Hypergraph` from the JAX package's CSR arrays (copied, so neither
    side can mutate the other's).  ``node_weights``/``edge_weights`` may be
    None for unit weights."""
    edge_ptr = np.array(edge_ptr, dtype=np.int64)
    edge_nodes = np.array(edge_nodes, dtype=np.int64)
    if node_weights is None:
        node_weights = np.ones(num_nodes, dtype=np.float64)
    node_weights = np.array(node_weights, dtype=np.float64)
    if len(node_weights) != num_nodes:
        raise ValueError(
            f"node_weights has {len(node_weights)} entries, want {num_nodes}"
        )
    if edge_weights is None:
        edge_weights = np.ones(len(edge_ptr) - 1, dtype=np.float64)
    edge_weights = np.array(edge_weights, dtype=np.float64)
    if len(edge_weights) != len(edge_ptr) - 1:
        raise ValueError("edge_weights must hold one weight per edge")
    if len(edge_nodes) and (edge_nodes.min() < 0
                            or edge_nodes.max() >= num_nodes):
        raise ValueError("edge_nodes must lie in [0, num_nodes)")
    return Hypergraph(edge_ptr, edge_nodes, node_weights, edge_weights)

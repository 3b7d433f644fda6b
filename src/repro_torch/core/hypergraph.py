"""Hypergraph workload model (paper §3).

Nodes are data items (possibly weighted); hyperedges are queries (possibly
weighted by frequency).  Backed by CSR numpy arrays.  A copy of the JAX
package's ``core/hypergraph.py`` cut down to what the placement pipeline
reads; ``from_reference_arrays`` takes that package's arrays as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

__all__ = ["Hypergraph", "build_incidence", "canonicalize_csr", "csr_ranges",
           "from_reference_arrays"]


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

    def incidence(self):
        if self._node_ptr is None:
            self._node_ptr, self._node_edges = build_incidence(
                self.edge_ptr, self.edge_nodes, self.num_nodes
            )
        return self._node_ptr, self._node_edges

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

    def equals(self, other: "Hypergraph") -> bool:
        """Exact structural equality: same CSR arrays, same weights."""
        return (
            np.array_equal(self.edge_ptr, other.edge_ptr)
            and np.array_equal(self.edge_nodes, other.edge_nodes)
            and np.array_equal(self.node_weights, other.node_weights)
            and np.array_equal(self.edge_weights, other.edge_weights)
        )

    def __repr__(self):
        return (
            f"Hypergraph(V={self.num_nodes}, E={self.num_edges}, "
            f"pins={self.num_pins}, density={self.density():.2f})"
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

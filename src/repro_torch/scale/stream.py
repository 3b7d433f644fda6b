"""Out-of-core streaming trace ingestion (`StreamingHypergraphBuilder`).

`Hypergraph.from_edges` is the dict-era constructor: one Python iteration +
`np.unique` per query.  Fine for the paper's 4k-query figures; at the
web-scale tier (a million queries) the per-query interpreter overhead
alone dominates the build.  The streaming builder ingests the trace
in CHUNKS — each chunk arrives as raw CSR arrays (or a list of sequences)
straight off a log shard, is canonicalized in one vectorized pass
(`hypergraph.canonicalize_csr`: a single lexsort sorts and dedups every
query's pins at once), and is appended into growing amortized-doubling CSR
buffers.  No per-query Python object is ever materialized, and the source
trace never has to fit in memory as Python lists.

Exactness contract
------------------
* ``merge_duplicates=False`` (default): ``build()`` is bit-identical to
  ``Hypergraph.from_edges(all_queries, num_nodes, ...)`` — same
  ``edge_ptr`` / ``edge_nodes`` dtypes and values, same weights.
* ``merge_duplicates=True``: queries with the same canonical pin set fold
  into ONE hyperedge, ordered by first occurrence, with their weights
  summed in arrival order — bit-identical to the dict-based reference
  (``{tuple(np.unique(q)): summed weight}`` in first-seen order).
  Duplicate detection is vectorized: every canonical edge gets a 64-bit
  position-mixed hash; edges group by (hash, size) via one argsort and each
  group is verified pin-exact against its first member (a verified hash
  collision falls back to an exact byte-keyed regroup of just that group,
  so correctness never rests on hash uniqueness).

A copy of the JAX package's ``scale/stream.py``: host numpy, no device.
"""

from __future__ import annotations

import numpy as np

from ..core.hypergraph import Hypergraph, canonicalize_csr, csr_ranges

__all__ = ["StreamingHypergraphBuilder"]

# splitmix64 constants for the per-pin mix; the per-edge hash is then a
# position-weighted sum, so permutations of DIFFERENT multisets that share a
# sum cannot collide silently (and any residual collision is verify-caught)
_MIX_MUL = np.uint64(0x9E3779B97F4A7C15)
_MIX_A = np.uint64(0xBF58476D1CE4E5B9)
_MIX_B = np.uint64(0x94D049BB133111EB)
_POS_MUL = np.uint64(0x100000001B3)  # FNV prime, position weighting


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64."""
    x = (x + _MIX_MUL).astype(np.uint64)
    x ^= x >> np.uint64(30)
    x *= _MIX_A
    x ^= x >> np.uint64(27)
    x *= _MIX_B
    x ^= x >> np.uint64(31)
    return x


def _edge_hashes(edge_ptr: np.ndarray, edge_nodes: np.ndarray) -> np.ndarray:
    """64-bit hash per canonical edge: sum of mixed pins weighted by an
    in-edge position power (wrapping uint64 arithmetic)."""
    E = len(edge_ptr) - 1
    if E == 0:
        return np.zeros(0, dtype=np.uint64)
    sizes = np.diff(edge_ptr)
    h = np.zeros(E, dtype=np.uint64)
    filled = sizes > 0
    if not filled.any():
        return h
    pos = np.arange(len(edge_nodes), dtype=np.int64) - np.repeat(
        edge_ptr[:-1], sizes
    )
    mixed = _mix64(edge_nodes.astype(np.uint64)) * (
        _POS_MUL ** pos.astype(np.uint64)
    )
    csum = np.concatenate([
        np.zeros(1, dtype=np.uint64), np.cumsum(mixed, dtype=np.uint64)
    ])
    h[filled] = csum[edge_ptr[1:][filled]] - csum[edge_ptr[:-1][filled]]
    return h


class _GrowBuf:
    """Amortized-doubling 1-D append buffer."""

    def __init__(self, dtype):
        self._arr = np.zeros(1024, dtype=dtype)
        self._len = 0

    def append(self, chunk: np.ndarray) -> None:
        need = self._len + len(chunk)
        if need > len(self._arr):
            cap = max(need, 2 * len(self._arr))
            grown = np.zeros(cap, dtype=self._arr.dtype)
            grown[: self._len] = self._arr[: self._len]
            self._arr = grown
        self._arr[self._len: need] = chunk
        self._len = need

    def view(self) -> np.ndarray:
        return self._arr[: self._len]


class StreamingHypergraphBuilder:
    """Chunked CSR ingester producing a `Hypergraph`.

    Feed chunks with ``add_csr(ptr, nodes[, weights])`` (raw per-chunk CSR;
    pins need not be sorted or deduplicated) or ``add_queries(list)``
    (convenience for small chunks), then call ``build()``.  ``build()`` is
    non-destructive — more chunks may be appended afterwards and ``build()``
    called again for the longer trace.
    """

    def __init__(self, num_items: int, node_weights: np.ndarray | None = None,
                 merge_duplicates: bool = False):
        self.num_items = int(num_items)
        if node_weights is None:
            self._node_weights = np.ones(self.num_items, dtype=np.float64)
        else:
            self._node_weights = np.asarray(node_weights, dtype=np.float64)
            assert len(self._node_weights) == self.num_items
        self.merge_duplicates = bool(merge_duplicates)
        self._nodes = _GrowBuf(np.int64)     # canonical pins, edge-major
        self._sizes = _GrowBuf(np.int64)     # canonical pins per edge
        self._weights = _GrowBuf(np.float64)  # per-edge weight, arrival order
        self._hashes = _GrowBuf(np.uint64)   # per-edge canonical hash
        self.num_chunks = 0

    # ------------------------------------------------------------- ingestion
    def __len__(self) -> int:
        return self._sizes._len  # edges ingested so far (pre-merge)

    def add_csr(self, edge_ptr, edge_nodes, edge_weights=None) -> None:
        """Append one chunk of queries in CSR form (`edge_ptr` offsets into
        `edge_nodes`; duplicate pins within a query are allowed and fold
        away during canonicalization)."""
        ptr, nodes = canonicalize_csr(edge_ptr, edge_nodes)
        E = len(ptr) - 1
        if nodes.size and int(nodes.max()) >= self.num_items:
            raise ValueError(
                f"pin {int(nodes.max())} out of range for {self.num_items} items"
            )
        if nodes.size and int(nodes.min()) < 0:
            raise ValueError("negative pin id in chunk")
        if edge_weights is None:
            w = np.ones(E, dtype=np.float64)
        else:
            w = np.asarray(edge_weights, dtype=np.float64)
            if len(w) != E:
                raise ValueError("edge_weights length != chunk edge count")
        self._nodes.append(nodes)
        self._sizes.append(np.diff(ptr))
        self._weights.append(w)
        if self.merge_duplicates:
            self._hashes.append(_edge_hashes(ptr, nodes))
        self.num_chunks += 1

    def add_queries(self, queries, edge_weights=None) -> None:
        """Append one chunk given as a list of int sequences (convenience;
        the packing loop is per-query, so prefer `add_csr` for big chunks)."""
        lists = [np.asarray(q, dtype=np.int64) for q in queries]
        ptr = np.zeros(len(lists) + 1, dtype=np.int64)
        ptr[1:] = np.cumsum([len(q) for q in lists])
        nodes = (
            np.concatenate(lists) if lists else np.zeros(0, dtype=np.int64)
        )
        self.add_csr(ptr, nodes, edge_weights)

    # ----------------------------------------------------------------- build
    def _csr(self):
        sizes = self._sizes.view()
        ptr = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=ptr[1:])
        return ptr, self._nodes.view()

    def build(self) -> Hypergraph:
        ptr, nodes = self._csr()
        weights = self._weights.view()
        if not self.merge_duplicates:
            return Hypergraph(
                ptr.copy(), nodes.copy(), self._node_weights.copy(),
                weights.copy(),
            )
        rep = self._dedup_map(ptr, nodes)
        # first-occurrence order: output slot k = k-th distinct edge seen
        first_seen = rep == np.arange(len(rep), dtype=np.int64)
        slot_of_rep = np.cumsum(first_seen) - 1
        slot = slot_of_rep[rep]
        keep = np.flatnonzero(first_seen)
        out_ptr = np.zeros(len(keep) + 1, dtype=np.int64)
        np.cumsum(ptr[keep + 1] - ptr[keep], out=out_ptr[1:])
        _, pidx = csr_ranges(ptr, keep)
        out_nodes = nodes[pidx]
        out_w = np.zeros(len(keep), dtype=np.float64)
        # np.add.at is sequential over its index array, so weights of
        # duplicates accumulate in arrival order — the dict reference's sum
        np.add.at(out_w, slot, weights)
        return Hypergraph(out_ptr, out_nodes, self._node_weights.copy(), out_w)

    # ------------------------------------------------------------- internals
    def _dedup_map(self, ptr: np.ndarray, nodes: np.ndarray) -> np.ndarray:
        """rep[e] = lowest edge id with the same canonical pin set as e.

        Candidate groups come from one stable argsort over (hash, size);
        every group member is then verified pin-exact against the group's
        first (lowest-id) edge in a single vectorized gather-compare.
        Verified mismatches (true 64-bit collisions) re-group exactly by
        pin bytes — a cold path that keeps the map correct regardless of
        hash quality."""
        E = len(ptr) - 1
        rep = np.arange(E, dtype=np.int64)
        if E <= 1:
            return rep
        sizes = np.diff(ptr)
        h = self._hashes.view()
        order = np.lexsort((np.arange(E), sizes, h))  # stable: lowest id first
        hs, ss = h[order], sizes[order]
        new_group = np.ones(E, dtype=bool)
        new_group[1:] = (hs[1:] != hs[:-1]) | (ss[1:] != ss[:-1])
        gid = np.cumsum(new_group) - 1
        first_of_group = order[np.flatnonzero(new_group)]  # lowest edge id
        cand_rep = first_of_group[gid]                     # per sorted pos
        # verify members against their representative pin-for-pin
        member = order
        _, m_idx = csr_ranges(ptr, member)
        _, r_idx = csr_ranges(ptr, cand_rep)
        same = np.ones(E, dtype=bool)
        neq_pin = nodes[m_idx] != nodes[r_idx]
        if neq_pin.any():
            pin_member = np.repeat(np.arange(E, dtype=np.int64),
                                   sizes[member])
            bad = np.unique(pin_member[neq_pin])
            same[bad] = False
        rep[member[same]] = cand_rep[same]
        mismatched = member[~same]
        if len(mismatched):
            # true hash collision: regroup those edges exactly by bytes
            # (an edge equal to its group's first member was caught above;
            # a mismatched edge can only equal another mismatched edge of
            # the same (hash, size) group)
            seen: dict[bytes, int] = {}
            for e in sorted(int(x) for x in mismatched):
                key = nodes[ptr[e]: ptr[e + 1]].tobytes()
                if key in seen:
                    rep[e] = seen[key]
                else:
                    seen[key] = e
        return rep

"""Replica selection via greedy set cover (paper §3, §4.1).

With replication, a query's span is a minimum set cover (NP-hard); the
greedy cover gives the best-known log|Q| approximation and doubles as the
replica-selection policy.  `Placement` is the layout every algorithm
produces: a boolean membership matrix (partitions x items).

Span engine
-----------
Two evaluation paths produce bit-identical covers:

* the per-query reference (`greedy_set_cover` / `cover_for_query`);
* the batched bitset engine (`batched_cover_csr`): queries are bucketed by
  word count W = ceil(|q|/64) and each query's membership submatrix is
  packed into uint64 words — ``codes[e, p, w]`` holds bit j iff partition
  p stores the query's (64*w + j)-th pin.  One greedy round for every
  still-uncovered query of a bucket is a popcount of ``codes & remaining``
  and a row-wise argmax.

Backends (``flags.FLAGS``): per greedy round, ``span_backend`` sends the
gain matrix to numpy (``bitwise_count``) or to the span_gain kernel; per
bucket, ``span_round_backend`` runs the rounds in the host loop or all of
them in the cover_rounds kernel.  ``"device"`` means the kernel on the
caller's device: the CUDA kernel on a GPU, its plain PyTorch version on
the CPU.  A kernel failure raises; no path falls back to another.

Tie-break contract: every engine picks the LOWEST partition id among
partitions with maximal gain (``np.argmax`` semantics).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import flags as _flags
from .. import obs as _obs
from ..device import resolve as _resolve_device
from ..kernels.cover_rounds.ops import cover_rounds
from ..kernels.span_gain.ops import span_gains
from .cluster import normalize_capacity

__all__ = [
    "Placement",
    "greedy_set_cover",
    "cover_for_query",
    "WorkloadCover",
    "batched_cover_csr",
    "batched_spans_csr",
    "SpanMaintainer",
    "engine_counters",
]

_WORD = 64


@dataclasses.dataclass
class Placement:
    """Layout of items onto partitions. member[p, v] == True iff a copy of
    item v is stored on partition p.

    ``stats`` is an optional fitting-diagnostics dict attached by the
    producing algorithm; it never influences placement semantics.
    ``capacity`` is the scalar (every partition holds the same weight) or
    an (N,) per-partition vector."""

    member: np.ndarray  # (N, V) bool
    capacity: "float | np.ndarray"
    node_weights: np.ndarray  # (V,)
    stats: dict | None = None

    @staticmethod
    def empty(num_partitions: int, num_items: int, capacity,
              node_weights: np.ndarray | None = None) -> "Placement":
        if node_weights is None:
            node_weights = np.ones(num_items, dtype=np.float64)
        return Placement(
            np.zeros((num_partitions, num_items), dtype=bool),
            normalize_capacity(capacity),
            np.asarray(node_weights, dtype=np.float64),
        )

    @staticmethod
    def from_member(member, capacity, node_weights=None) -> "Placement":
        """A `Placement` over a copy of a (N, V) bool member matrix, e.g.
        the JAX package's ``Placement.member``."""
        member = np.array(member, dtype=bool)
        if member.ndim != 2:
            raise ValueError(f"member must be (N, V), got {member.shape}")
        if node_weights is None:
            node_weights = np.ones(member.shape[1], dtype=np.float64)
        node_weights = np.array(node_weights, dtype=np.float64)
        if node_weights.shape != (member.shape[1],):
            raise ValueError("node_weights must hold one weight per item")
        return Placement(member, normalize_capacity(capacity), node_weights)

    @property
    def num_partitions(self) -> int:
        return self.member.shape[0]

    @property
    def num_items(self) -> int:
        return self.member.shape[1]

    def partition_weights(self) -> np.ndarray:
        return self.member @ self.node_weights

    def cap_of(self, p: int) -> float:
        """Capacity of partition p (scalar capacities apply to every row)."""
        cap = self.capacity
        if isinstance(cap, np.ndarray) and cap.ndim:
            return float(cap[p])
        return float(cap)

    @property
    def capacity_vec(self) -> np.ndarray:
        """(N,) per-partition capacity (scalar capacity broadcast)."""
        cap = self.capacity
        if isinstance(cap, np.ndarray) and cap.ndim:
            return cap
        return np.full(self.num_partitions, float(cap))

    def replication_factor(self) -> float:
        placed = self.member.sum(axis=0)
        placed = placed[placed > 0]
        return float(placed.mean()) if len(placed) else 0.0

    def validate(self, tol: float = 1e-9) -> None:
        w = self.partition_weights()
        if (w > self.capacity + tol).any():
            cap = self.capacity_vec
            bad = int(np.argmax(w - cap))
            raise ValueError(
                f"partition {bad} over capacity: {w[bad]:.1f} > {cap[bad]}"
            )
        placed = self.member.any(axis=0)
        # unplaced items are only legal if they are phantom (weight 0)
        missing = np.flatnonzero(~placed & (self.node_weights > 0))
        if len(missing):
            raise ValueError(f"{len(missing)} items unplaced, e.g. {missing[:5]}")


def greedy_set_cover(query: np.ndarray, member: np.ndarray) -> list[int]:
    """getSpanningPartitions: iteratively pick the partition with the
    largest intersection with the still-uncovered items (ties -> lowest
    partition id)."""
    query = np.asarray(query, dtype=np.int64)
    remaining = np.ones(len(query), dtype=bool)
    sub = member[:, query]  # (N, |q|)
    chosen: list[int] = []
    while remaining.any():
        gains = (sub & remaining[None, :]).sum(axis=1)
        p = int(np.argmax(gains))
        if gains[p] == 0:
            raise ValueError(
                f"query items {query[remaining][:5]} not stored on any partition"
            )
        chosen.append(p)
        remaining &= ~sub[p]
    return chosen


def cover_for_query(query: np.ndarray, member: np.ndarray):
    """Like greedy_set_cover but also returns, per chosen partition, the
    item ids the query reads from it (items go to the first chosen
    partition that holds them)."""
    query = np.asarray(query, dtype=np.int64)
    remaining = np.ones(len(query), dtype=bool)
    sub = member[:, query]
    chosen: list[int] = []
    accessed: list[np.ndarray] = []
    while remaining.any():
        gains = (sub & remaining[None, :]).sum(axis=1)
        p = int(np.argmax(gains))
        if gains[p] == 0:
            raise ValueError("query contains an unplaced item")
        newly = sub[p] & remaining
        chosen.append(p)
        accessed.append(query[newly])
        remaining &= ~newly
    return chosen, accessed


# ===================================================================== engine
def _to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint64 words as an int64 tensor on ``device`` (bit pattern kept)."""
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int64)).to(device)


def _device_gains(codes: np.ndarray, rem: np.ndarray,
                  device: torch.device) -> np.ndarray:
    """codes (A, N, W) uint64, rem (A, W) -> (A, N) int32 via span_gain."""
    return span_gains(_to_device(codes, device),
                      _to_device(rem, device)).cpu().numpy()


def _gain_backend(words: int) -> str:
    backend = _flags.FLAGS.get("span_backend", "auto")
    if backend == "auto":
        thresh = int(_flags.FLAGS.get("span_dispatch_threshold", 48_000))
        return "numpy" if words < thresh else "device"
    if backend not in ("numpy", "device"):
        raise ValueError(f"unknown span_backend {backend!r}")
    return backend


def _gain_matrix_w1(codes1: np.ndarray, rem1: np.ndarray,
                    device: torch.device) -> np.ndarray:
    """Single-word variant of `_gain_matrix`: codes1 (A, N) uint64, rem1
    (A,) -> (A, N) gains (dtype differs by backend, values do not)."""
    if _gain_backend(codes1.size) == "numpy":
        return np.bitwise_count(codes1 & rem1[:, None])
    return _device_gains(codes1[:, :, None], rem1[:, None], device)


def _gain_matrix(codes: np.ndarray, rem: np.ndarray,
                 device: torch.device) -> np.ndarray:
    """Gain matrix of one greedy round, dispatched per (bucket, round) on
    its A * N * W words: numpy below ``span_dispatch_threshold``, the
    span_gain kernel above it."""
    if _gain_backend(codes.size) == "numpy":
        return np.bitwise_count(codes & rem[:, None, :]).sum(axis=2,
                                                             dtype=np.int64)
    return _device_gains(codes, rem, device)


# Engine-level dispatch counters (observability, not control flow): how many
# word-count buckets resolved on which cover loop and how many greedy rounds
# each side ran.  `lmbr` snapshots deltas into Placement.stats.
ENGINE_COUNTERS = {
    "device_buckets": 0,
    "host_buckets": 0,
    "device_rounds": 0,
    "host_rounds": 0,
}


def engine_counters() -> dict:
    """Snapshot of the cover-engine dispatch counters."""
    return dict(ENGINE_COUNTERS)


def _device_cover_rounds(codes: np.ndarray, rem: np.ndarray,
                         device: torch.device):
    """Resolve one packed bucket with the cover_rounds kernel.  codes
    (B, N, W) uint64, rem (B, W) uint64 -> ch (B, R) int64, or None when a
    query of the bucket is uncoverable (the host loop then raises the
    canonical error)."""
    ch_t, bad_t = cover_rounds(_to_device(codes, device),
                               _to_device(rem, device))
    if bool(bad_t.any()):
        return None
    ch = ch_t.cpu().numpy()
    used = int((ch >= 0).any(axis=0).sum())  # rounds are prefix-dense
    return ch[:, :used].astype(np.int64)


@dataclasses.dataclass
class WorkloadCover:
    """Batched cover of a CSR query set.

    spans:       (E,) greedy cover size per query
    cover_ptr:   (E+1,) CSR offsets into cover_parts
    cover_parts: (sum spans,) chosen partitions in greedy selection order
    pin_parts:   (P,) or None — for every pin of the input CSR, the partition
                 that serves it (the replica-selection decision)
    """

    spans: np.ndarray
    cover_ptr: np.ndarray
    cover_parts: np.ndarray
    pin_parts: np.ndarray | None = None

    def chosen(self, e: int) -> np.ndarray:
        return self.cover_parts[self.cover_ptr[e]: self.cover_ptr[e + 1]]


def _cover_bucket(edge_ptr, edge_nodes, member, b_idx, W, spans, pin_parts,
                  device):
    """Run batched greedy cover for one word-count bucket.  Returns the
    per-round chosen matrix ch (B, R) with -1 padding."""
    sizes = edge_ptr[b_idx + 1] - edge_ptr[b_idx]
    B = len(b_idx)
    loc_ptr = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(sizes, out=loc_ptr[1:])
    P = int(loc_ptr[-1])
    pin_e = np.repeat(np.arange(B, dtype=np.int64), sizes)
    pos = np.arange(P, dtype=np.int64) - loc_ptr[pin_e]
    pins = edge_nodes[edge_ptr[b_idx][pin_e] + pos]

    # pack the per-query membership submatrices into uint64 words
    codes = np.zeros((B, member.shape[0], W), dtype=np.uint64)
    L = int(sizes.max()) if P else 0
    if P and W == 1 and B * L * member.shape[0] <= 4_000_000:
        # single-word fast pack: pad each query's pins to (B, Lmax) indices
        # into a transposed member copy (dummy index -> all-False row) and
        # SUM the per-slot bit weights — bits are distinct within a query,
        # so the sum is exactly the OR.  Microbatch-sized; huge one-shot
        # buckets keep the reduceat pack, whose memory tracks total pins
        mt = np.zeros((member.shape[1] + 1, member.shape[0]), dtype=bool)
        mt[:-1] = member.T
        pinpad = np.full((B, L), member.shape[1], dtype=np.int64)
        pinpad[pin_e, pos] = pins
        bits_w = np.uint64(1) << np.arange(L, dtype=np.uint64)
        codes[:, :, 0] = (
            mt[pinpad] * bits_w[None, :, None]
        ).sum(axis=1, dtype=np.uint64)
    elif P:
        wid = pos >> 6
        bit = (pos & 63).astype(np.uint64)
        shifted = member[:, pins] * (np.uint64(1) << bit)[None, :]  # (N, P)
        seg = pin_e * W + wid
        starts = np.flatnonzero(
            np.concatenate([[True], seg[1:] != seg[:-1]])
        )
        red = np.bitwise_or.reduceat(shifted, starts, axis=1)  # (N, G)
        codes[pin_e[starts], :, wid[starts]] = red.T

    # remaining-items masks: the low |q| bits set
    rem = np.zeros((B, W), dtype=np.uint64)
    for j in range(W):
        bits = np.clip(sizes - _WORD * j, 0, _WORD)
        low = (np.uint64(1) << bits.clip(0, _WORD - 1).astype(np.uint64)) - np.uint64(1)
        rem[:, j] = np.where(bits >= _WORD, np.uint64(0xFFFFFFFFFFFFFFFF), low)

    # whole-bucket dispatch: the cover_rounds kernel for big buckets, the
    # per-round host loop otherwise (bit-identical, purely perf)
    ch = None
    round_backend = _flags.FLAGS.get("span_round_backend", "auto")
    if round_backend == "auto":
        thresh = int(_flags.FLAGS.get("span_round_threshold", 200_000))
        round_backend = "device" if codes.size >= thresh else "numpy"
    elif round_backend not in ("numpy", "device"):
        raise ValueError(f"unknown span_round_backend {round_backend!r}")
    if round_backend == "device":
        ch = _device_cover_rounds(codes, rem, device)
    if ch is not None:
        ENGINE_COUNTERS["device_buckets"] += 1
        ENGINE_COUNTERS["device_rounds"] += ch.shape[1]
        reg = _obs.registry()
        if reg.active:
            reg.inc("cover_buckets", backend="device")
            reg.inc("cover_rounds", ch.shape[1], backend="device")
        spans[b_idx] = (ch >= 0).sum(axis=1)
        _attribute_pins(ch, member, b_idx, edge_ptr, pin_e, pos, pins,
                        pin_parts)
        return ch

    rounds: list[tuple[np.ndarray, np.ndarray]] = []
    if W == 1:
        # single-word fast path: word axis squeezed, still-active queries
        # kept COMPACT (codes_a/rem_a/eidx shrink together)
        eidx = np.flatnonzero(rem[:, 0])
        codes_a = codes[eidx, :, 0]
        rem_a = rem[eidx, 0]
        ar = np.arange(B, dtype=np.int64)
        while len(eidx):
            g = _gain_matrix_w1(codes_a, rem_a, device)
            p = g.argmax(axis=1)                # ties -> lowest partition id
            a = ar[: len(p)]
            gmax = g[a, p]
            if not gmax.all():
                bad = int(eidx[int(np.argmax(gmax == 0))])
                e = int(b_idx[bad])
                raise ValueError(
                    f"query {e} contains items not stored on any partition"
                )
            rounds.append((eidx, p))
            rem_a &= ~codes_a[a, p]
            alive = rem_a != 0
            if not alive.all():
                eidx = eidx[alive]
                codes_a = codes_a[alive]
                rem_a = rem_a[alive]
    else:
        active = np.flatnonzero(rem.any(axis=1))
        while len(active):
            sub = codes[active]                     # (A, N, W)
            g = _gain_matrix(sub, rem[active], device)  # (A, N)
            p = g.argmax(axis=1)                    # ties -> lowest partition id
            gmax = g[np.arange(len(p)), p]
            if (gmax == 0).any():
                bad = int(active[int(np.argmax(gmax == 0))])
                e = int(b_idx[bad])
                raise ValueError(
                    f"query {e} contains items not stored on any partition"
                )
            rounds.append((active, p))
            newly = sub[np.arange(len(p)), p]       # (A, W)
            rem[active] &= ~newly
            active = active[rem[active].any(axis=1)]

    R = len(rounds)
    ch = np.full((B, R), -1, dtype=np.int64)
    for r, (ai, pi) in enumerate(rounds):
        ch[ai, r] = pi
    ENGINE_COUNTERS["host_buckets"] += 1
    ENGINE_COUNTERS["host_rounds"] += R
    reg = _obs.registry()
    if reg.active:
        reg.inc("cover_buckets", backend="host")
        reg.inc("cover_rounds", R, backend="host")
    spans[b_idx] = (ch >= 0).sum(axis=1)
    _attribute_pins(ch, member, b_idx, edge_ptr, pin_e, pos, pins, pin_parts)
    return ch


def _attribute_pins(ch, member, b_idx, edge_ptr, pin_e, pos, pins, pin_parts):
    """Replica-selection attribution: for every pin, the first chosen round
    whose partition stores the item serves it."""
    if pin_parts is None or not len(pins):
        return
    assigned = np.full(len(pins), -1, dtype=np.int64)
    for r in range(ch.shape[1]):
        pe = ch[pin_e, r]
        idx = np.flatnonzero((assigned < 0) & (pe >= 0))
        if not len(idx):
            continue
        hit = member[pe[idx], pins[idx]]
        sel = idx[hit]
        assigned[sel] = pe[sel]
    pin_parts[edge_ptr[b_idx][pin_e] + pos] = assigned


def batched_cover_csr(
    edge_ptr: np.ndarray,
    edge_nodes: np.ndarray,
    member: np.ndarray,
    with_pin_parts: bool = False,
    device="cuda",
) -> WorkloadCover:
    """Greedy set cover of every CSR query against `member`, batched.

    Bit-identical to running `cover_for_query` per query (same covers in
    the same order, same lowest-id tie-break, ValueError on unplaced
    items).  Queries must be pin-deduplicated.  Kernel work runs on
    ``device``."""
    device = _resolve_device(device)
    edge_ptr = np.asarray(edge_ptr, dtype=np.int64)
    edge_nodes = np.asarray(edge_nodes, dtype=np.int64)
    E = len(edge_ptr) - 1
    spans = np.zeros(E, dtype=np.int64)
    pin_parts = (
        np.full(len(edge_nodes), -1, dtype=np.int64) if with_pin_parts else None
    )
    sizes = np.diff(edge_ptr)
    words = np.maximum((sizes + _WORD - 1) // _WORD, 1)
    bucket_chosen: list[tuple[np.ndarray, np.ndarray]] = []
    for W in np.unique(words[sizes > 0]) if E else []:
        b_idx = np.flatnonzero((words == W) & (sizes > 0))
        ch = _cover_bucket(edge_ptr, edge_nodes, member, b_idx, int(W),
                           spans, pin_parts, device)
        bucket_chosen.append((b_idx, ch))

    cover_ptr = np.zeros(E + 1, dtype=np.int64)
    np.cumsum(spans, out=cover_ptr[1:])
    cover_parts = np.zeros(int(cover_ptr[-1]), dtype=np.int64)
    for b_idx, ch in bucket_chosen:
        sp = spans[b_idx]
        total = int(sp.sum())
        if not total:
            continue
        # flat (edge-major, round-minor) order matches ch[ch >= 0] row-major
        base = np.zeros(len(b_idx) + 1, dtype=np.int64)
        np.cumsum(sp, out=base[1:])
        within = np.arange(total, dtype=np.int64) - base[
            np.repeat(np.arange(len(b_idx)), sp)
        ]
        cover_parts[np.repeat(cover_ptr[b_idx], sp) + within] = ch[ch >= 0]
    return WorkloadCover(spans, cover_ptr, cover_parts, pin_parts)


def batched_spans_csr(edge_ptr: np.ndarray, edge_nodes: np.ndarray,
                      member: np.ndarray, device="cuda") -> np.ndarray:
    """Spans only; element-wise equal to the per-query greedy cover size."""
    return batched_cover_csr(edge_ptr, edge_nodes, member,
                             device=device).spans


# ======================================================== incremental spans
class SpanMaintainer:
    """Per-edge span cache over the batched engine.

    With ``with_covers=True`` it also keeps every edge's replica selection
    in FLAT form — ``pin_parts`` holds, for every pin of the hypergraph's
    CSR, the partition that serves it, and ``chosen(e)`` the partitions of
    e's cover in greedy selection order.  ``refresh_edges`` re-derives an
    explicit edge set in one batched cover; callers name every edge whose
    cover may have changed (LMBR's move loop does)."""

    def __init__(self, hg, placement: Placement, with_covers: bool = False,
                 device="cuda"):
        self.hg = hg
        self.placement = placement
        self.device = _resolve_device(device)
        self._pin_part: np.ndarray | None = None  # (P,) serving partition
        self._chosen: list[np.ndarray] | None = None  # per edge, greedy order
        if with_covers:
            cov = batched_cover_csr(
                hg.edge_ptr, hg.edge_nodes, placement.member,
                with_pin_parts=True, device=self.device,
            )
            self._spans = cov.spans
            self._pin_part = cov.pin_parts
            self._chosen = [cov.chosen(e).copy() for e in range(hg.num_edges)]
        else:
            self._spans = batched_spans_csr(
                hg.edge_ptr, hg.edge_nodes, placement.member,
                device=self.device,
            )

    @property
    def pin_parts(self) -> np.ndarray:
        """Serving partition of every pin, aligned with ``hg.edge_nodes``
        (requires with_covers=True)."""
        return self._pin_part

    def chosen(self, e: int) -> np.ndarray:
        """Partitions of edge e's cover in greedy selection order (requires
        with_covers=True)."""
        return self._chosen[e]

    def cover(self, e: int) -> dict[int, np.ndarray]:
        """Replica selection of edge e (requires with_covers=True): maps each
        chosen partition, in greedy selection order, to the items the edge
        reads from it."""
        lo, hi = self.hg.edge_ptr[e], self.hg.edge_ptr[e + 1]
        q = self.hg.edge_nodes[lo:hi]
        pp = self._pin_part[lo:hi]
        return {int(p): q[pp == p] for p in self._chosen[e]}

    def refresh_edges(self, edge_ids) -> None:
        """Batched recompute of exactly `edge_ids` — bit-identical to calling
        `cover_for_query` per edge, one engine invocation total."""
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
        if not len(edge_ids):
            return
        ptr, pidx = self.hg.pin_indices(edge_ids)
        nodes = self.hg.edge_nodes[pidx]
        cov = batched_cover_csr(
            ptr, nodes, self.placement.member,
            with_pin_parts=self._pin_part is not None, device=self.device,
        )
        self._spans[edge_ids] = cov.spans
        if self._pin_part is not None:
            self._pin_part[pidx] = cov.pin_parts
            for i, e in enumerate(edge_ids):
                self._chosen[int(e)] = cov.chosen(i).copy()

    def spans(self) -> np.ndarray:
        return self._spans

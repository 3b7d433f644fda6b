"""MoE expert placement from routing traces — the paper's technique applied
beyond the paper.

Mapping onto the paper's model:
  data items   -> experts
  query        -> the set of experts co-activated by one token group
                  (a sequence / microbatch shard; mined from routing traces)
  partitions   -> expert-parallel (EP) ranks, capacity = expert slots per rank
  query span   -> number of EP ranks one token group's all-to-all must reach

Standard EP assigns experts round-robin/contiguously and every token group
all-to-alls with every rank.  With workload-driven placement plus replicas of
hot/co-firing experts in spare slots, the average fan-out (span) drops, which
directly cuts all-to-all participants and bytes — the paper's
communication-minimization thesis restated for MoE.

The plan exposes the dispatch tables (`expert_slot_table`,
`slot_to_expert`) an MoE layer uses for locality-aware dispatch, plus
trace-level estimates of the all-to-all reduction.

A copy of the JAX package's ``core/expert_placement.py``;
`plan_expert_placement` takes ``device`` (default ``"cuda"``; raises
without CUDA unless ``device="cpu"``) and fits there.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..device import resolve as _resolve_device
from .algorithms import ALGORITHMS
from .hypergraph import Hypergraph
from .setcover import Placement, greedy_set_cover
from .three_way import THREE_WAY_ALGORITHMS

__all__ = [
    "ExpertPlacementPlan",
    "routing_trace_to_hypergraph",
    "plan_expert_placement",
    "baseline_contiguous_placement",
    "synthetic_routing_trace",
]


def routing_trace_to_hypergraph(
    group_expert_sets: list[np.ndarray], num_experts: int
) -> Hypergraph:
    """Dedupe identical expert-sets, weighting hyperedges by frequency."""
    counts: dict[tuple, float] = {}
    for s in group_expert_sets:
        key = tuple(sorted(set(int(x) for x in s)))
        if len(key) < 1:
            continue
        counts[key] = counts.get(key, 0.0) + 1.0
    edges = list(counts.keys())
    return Hypergraph.from_edges(
        edges, num_nodes=num_experts,
        edge_weights=np.asarray([counts[e] for e in edges]),
    )


def synthetic_routing_trace(
    num_experts: int,
    num_groups: int,
    top_k: int = 8,
    zipf_a: float = 1.2,
    cluster_size: int = 16,
    seed: int = 0,
) -> list[np.ndarray]:
    """Synthetic but structured trace: expert popularity is Zipfian and
    co-activation is clustered (domain-specialized experts co-fire), which is
    what production MoE routing looks like after convergence."""
    rng = np.random.default_rng(seed)
    num_clusters = max(1, num_experts // cluster_size)
    cluster_pop = 1.0 / np.arange(1, num_clusters + 1) ** zipf_a
    cluster_pop /= cluster_pop.sum()
    perm = rng.permutation(num_experts)
    clusters = [
        perm[c * cluster_size : (c + 1) * cluster_size]
        for c in range(num_clusters)
    ]
    groups = []
    for _ in range(num_groups):
        c = int(rng.choice(num_clusters, p=cluster_pop))
        pool = clusters[c]
        # tokens in a group mostly hit one cluster, with some leakage
        n_local = max(1, int(round(top_k * 0.75)))
        local = rng.choice(pool, size=min(n_local, len(pool)), replace=False)
        n_leak = top_k - len(local)
        leak = rng.integers(0, num_experts, size=max(0, n_leak))
        groups.append(np.unique(np.concatenate([local, leak])))
    return groups


@dataclasses.dataclass
class ExpertPlacementPlan:
    num_experts: int
    num_ranks: int
    slots_per_rank: int
    member: np.ndarray           # (ranks, experts) bool
    slot_to_expert: np.ndarray   # (ranks, slots_per_rank) int32, -1 = empty
    expert_slot_table: np.ndarray  # (experts, ranks) int32: slot id on rank, -1
    algorithm: str

    # ------------------------------------------------------------- metrics
    def avg_span(self, group_expert_sets: list[np.ndarray]) -> float:
        return float(
            np.mean([
                len(greedy_set_cover(np.asarray(sorted(set(map(int, g)))),
                                     self.member))
                for g in group_expert_sets if len(g)
            ])
        )

    def a2a_bytes(
        self, group_expert_sets: list[np.ndarray],
        tokens_per_group: int, bytes_per_token: int,
    ) -> float:
        """Estimated all-to-all payload: each group ships its tokens to every
        rank in its cover and receives them back (2x)."""
        total = 0.0
        for g in group_expert_sets:
            if not len(g):
                continue
            span = len(
                greedy_set_cover(np.asarray(sorted(set(map(int, g)))), self.member)
            )
            # tokens split across `span` ranks; payload ~ tokens * bytes * 2
            total += 2.0 * tokens_per_group * bytes_per_token * max(span - 1, 0) / max(span, 1)
        return total

    def replica_counts(self) -> np.ndarray:
        return self.member.sum(axis=0)


def _plan_from_placement(
    pl: Placement, num_experts: int, num_ranks: int, slots: int, algo: str
) -> ExpertPlacementPlan:
    slot_to_expert = np.full((num_ranks, slots), -1, dtype=np.int32)
    expert_slot_table = np.full((num_experts, num_ranks), -1, dtype=np.int32)
    for r in range(num_ranks):
        experts = np.flatnonzero(pl.member[r])
        for s, e in enumerate(experts[:slots]):
            slot_to_expert[r, s] = e
            expert_slot_table[e, r] = s
    return ExpertPlacementPlan(
        num_experts, num_ranks, slots, pl.member.copy(),
        slot_to_expert, expert_slot_table, algo,
    )


def baseline_contiguous_placement(
    num_experts: int, num_ranks: int, slots_per_rank: int | None = None
) -> ExpertPlacementPlan:
    """Standard EP layout: expert e lives (only) on rank e // (E/R)."""
    per = int(np.ceil(num_experts / num_ranks))
    slots = slots_per_rank or per
    member = np.zeros((num_ranks, num_experts), dtype=bool)
    for e in range(num_experts):
        member[min(e // per, num_ranks - 1), e] = True
    pl = Placement(member, float(slots), np.ones(num_experts))
    return _plan_from_placement(pl, num_experts, num_ranks, slots, "contiguous")


def plan_expert_placement(
    group_expert_sets: list[np.ndarray],
    num_experts: int,
    num_ranks: int,
    slots_per_rank: int,
    algorithm: str = "lmbr",
    seed: int = 0,
    device="cuda",
) -> ExpertPlacementPlan:
    """Fit the paper's placement machinery to a routing trace.

    slots_per_rank * num_ranks >= num_experts must hold; the surplus is the
    replication budget (the paper's 'extra partitions')."""
    device = _resolve_device(device)
    if slots_per_rank * num_ranks < num_experts:
        raise ValueError("not enough expert slots to place every expert once")
    hg = routing_trace_to_hypergraph(group_expert_sets, num_experts)
    if algorithm in THREE_WAY_ALGORITHMS:
        rf = max(1, (slots_per_rank * num_ranks) // num_experts)
        pl = THREE_WAY_ALGORITHMS[algorithm](
            hg, n=num_ranks, capacity=float(slots_per_rank), rf=rf, seed=seed,
            device=device,
        )
    else:
        pl = ALGORITHMS[algorithm](hg, num_ranks, float(slots_per_rank),
                                   seed=seed, device=device)
    # every expert must exist somewhere even if it never fired in the trace
    placed = pl.member.any(axis=0)
    loads = pl.member.sum(axis=1).astype(np.int64)
    for e in np.flatnonzero(~placed):
        r = int(np.argmin(loads))
        pl.member[r, e] = True
        loads[r] += 1
    # enforce the slot cap strictly (placement capacity is in weight units,
    # which equals slot count for unit-weight experts)
    for r in range(num_ranks):
        experts = np.flatnonzero(pl.member[r])
        if len(experts) > slots_per_rank:
            # drop surplus replicas (never the last copy of an expert)
            copies = pl.member.sum(axis=0)
            removable = sorted(
                (int(e) for e in experts if copies[e] > 1),
                key=lambda e: -copies[e],
            )
            for e in removable:
                if len(np.flatnonzero(pl.member[r])) <= slots_per_rank:
                    break
                pl.member[r, e] = False
                copies[e] -= 1
    return _plan_from_placement(
        pl, num_experts, num_ranks, slots_per_rank, algorithm
    )

"""Dataset-shard placement for the input pipeline (paper technique at the
storage layer).

Mapping onto the paper's model:
  data items  -> dataset shards (files / file chunks)
  query       -> one global batch's shard-set (mixture sampling reads several
                 shards together; the batch is the read unit)
  partitions  -> data hosts, capacity = local shard cache size
  span        -> hosts a batch must gather from (cross-host input traffic)

Shards are replicated RF-way for fault tolerance anyway (HDFS-style); placing
those replicas with PRA-3W/LMBR makes most batches assemble from few hosts,
and — per the paper — lets untouched hosts idle.  The same plan doubles as
the straggler/failure story: when a host is slow or dead, replica selection
re-covers its shards from surviving replicas with minimal extra span
(`cover_excluding`).

A copy of the JAX package's ``core/shard_placement.py``;
`plan_shard_placement` takes ``device`` (default ``"cuda"``; raises without
CUDA unless ``device="cpu"``) and fits there.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..device import resolve as _resolve_device
from .algorithms import ALGORITHMS
from .three_way import THREE_WAY_ALGORITHMS
from .hypergraph import Hypergraph
from .setcover import cover_for_query, greedy_set_cover

__all__ = ["ShardPlacementPlan", "plan_shard_placement", "mixture_batch_recipes"]


def mixture_batch_recipes(
    num_shards: int,
    num_batches: int,
    shards_per_batch: int = 8,
    num_mixtures: int = 12,
    zipf_a: float = 1.3,
    seed: int = 0,
) -> list[np.ndarray]:
    """Batch recipes under mixture sampling: each training batch draws from
    one of a few data mixtures (web/code/math/...), and each mixture reads a
    stable subset of shards — exactly the 'same queries run regularly'
    workload the paper assumes."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, num_mixtures + 1) ** zipf_a
    pop /= pop.sum()
    mixture_pools = [
        rng.choice(num_shards, size=min(num_shards, 4 * shards_per_batch),
                   replace=False)
        for _ in range(num_mixtures)
    ]
    recipes = []
    for _ in range(num_batches):
        m = int(rng.choice(num_mixtures, p=pop))
        recipes.append(
            np.unique(rng.choice(mixture_pools[m], size=shards_per_batch))
        )
    return recipes


@dataclasses.dataclass
class ShardPlacementPlan:
    member: np.ndarray  # (hosts, shards) bool
    capacity: float
    algorithm: str
    shard_weights: np.ndarray

    @property
    def num_hosts(self) -> int:
        return self.member.shape[0]

    def hosts_for_batch(self, recipe: np.ndarray):
        """(hosts, shards-read-from-each): replica selection for one batch."""
        return cover_for_query(np.asarray(recipe, dtype=np.int64), self.member)

    def span(self, recipe: np.ndarray) -> int:
        return len(greedy_set_cover(np.asarray(recipe, dtype=np.int64), self.member))

    def avg_span(self, recipes: list[np.ndarray]) -> float:
        return float(np.mean([self.span(r) for r in recipes]))

    def cover_excluding(self, recipe: np.ndarray, dead_hosts: set[int]):
        """Failure/straggler path: cover the batch without `dead_hosts`.
        Raises if some shard's every replica is dead."""
        mask = np.ones(self.member.shape[0], dtype=bool)
        for h in dead_hosts:
            mask[h] = False
        sub = self.member[mask]
        alive_ids = np.flatnonzero(mask)
        chosen, accessed = cover_for_query(
            np.asarray(recipe, dtype=np.int64), sub
        )
        return [int(alive_ids[c]) for c in chosen], accessed

    def survives_failures(self, max_failures: int = 1) -> bool:
        """Every shard keeps >=1 replica after any `max_failures` host losses
        iff every shard has > max_failures replicas."""
        return bool((self.member.sum(axis=0) > max_failures).all())


def plan_shard_placement(
    recipes: list[np.ndarray],
    num_shards: int,
    num_hosts: int,
    capacity: float,
    algorithm: str = "pra3",
    rf: int = 3,
    shard_weights: np.ndarray | None = None,
    seed: int = 0,
    device="cuda",
) -> ShardPlacementPlan:
    """Fit placement.  `algorithm` may be any unconstrained paper algorithm
    (lmbr/ihpa/ds/pra) or a fixed-RF one (pra3/sda/ihpa3/random3) when the
    deployment mandates exactly `rf` copies for durability."""
    device = _resolve_device(device)
    hg = Hypergraph.from_edges(
        recipes, num_nodes=num_shards, node_weights=shard_weights
    )
    if algorithm in THREE_WAY_ALGORITHMS:
        pl = THREE_WAY_ALGORITHMS[algorithm](
            hg, n=num_hosts, capacity=capacity, rf=rf, seed=seed,
            device=device,
        )
    else:
        pl = ALGORITHMS[algorithm](hg, num_hosts, capacity, seed=seed,
                                   device=device)
    # durability floor: every shard (even never-sampled ones) placed once
    placed = pl.member.any(axis=0)
    loads = pl.partition_weights()
    w = hg.node_weights
    for s in np.flatnonzero(~placed):
        r = int(np.argmin(loads))
        pl.member[r, s] = True
        loads[r] += w[s]
    return ShardPlacementPlan(pl.member, capacity, algorithm, hg.node_weights)

"""Input pipeline with workload-driven shard placement (the paper's
technique at the storage layer; the reference's ``data/pipeline.py``).

The pipeline owns dataset shards replicated across data hosts.  At set-up
it mines the mixture schedule for batch recipes (shard sets read
together), fits the paper's placement (PRA-3W by default) with the
port's ``plan_shard_placement`` on ``device``, and then assembles every
global batch by greedy set-cover replica selection, touching as few hosts
as possible and covering around dead or slow hosts from surviving
replicas.  The host store is an in-memory simulation with the control
flow of per-machine file caches; batches are host numpy, the same bits as
the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import plan_shard_placement
from ..core.shard_placement import ShardPlacementPlan, mixture_batch_recipes

__all__ = ["SyntheticTokenSource", "HostStats", "PlacementAwarePipeline"]


class SyntheticTokenSource:
    """Deterministic synthetic corpus: shard s yields tokens from a stream
    seeded by s (a stand-in for tokenized files)."""

    def __init__(self, vocab_size: int, shard_tokens: int = 1 << 16):
        self.vocab = vocab_size
        self.shard_tokens = shard_tokens

    def read(self, shard: int, offset: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(shard * 1_000_003 + offset)
        return rng.integers(0, self.vocab, size=n, dtype=np.int32)


@dataclasses.dataclass
class HostStats:
    reads: int = 0
    bytes: int = 0


class PlacementAwarePipeline:
    def __init__(
        self,
        num_shards: int,
        num_hosts: int,
        vocab_size: int,
        batch_size: int,
        seq_len: int,
        cache_capacity: int = 64,
        algorithm: str = "pra3",
        num_batches_trace: int = 512,
        shards_per_batch: int = 8,
        seed: int = 0,
        device=None,
    ):
        self.source = SyntheticTokenSource(vocab_size)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.num_hosts = num_hosts
        self.seed = seed
        # workload trace -> the paper's placement
        self.recipes = mixture_batch_recipes(
            num_shards, num_batches_trace, shards_per_batch=shards_per_batch,
            seed=seed,
        )
        self.plan: ShardPlacementPlan = plan_shard_placement(
            self.recipes, num_shards, num_hosts, capacity=cache_capacity,
            algorithm=algorithm, seed=seed, device=device,
        )
        self.dead_hosts: set[int] = set()
        self.slow_hosts: set[int] = set()
        self.host_stats = [HostStats() for _ in range(num_hosts)]
        self._step = 0
        self.span_log: list[int] = []

    # ------------------------------------------------------------- failures
    def mark_dead(self, host: int):
        self.dead_hosts.add(host)

    def mark_slow(self, host: int):
        """Straggler mitigation: a slow host is avoided exactly like a dead
        one (its shards re-covered from replicas), but may recover."""
        self.slow_hosts.add(host)

    def mark_recovered(self, host: int):
        self.dead_hosts.discard(host)
        self.slow_hosts.discard(host)

    # --------------------------------------------------------------- batches
    def next_batch(self) -> dict:
        """{"tokens", "targets"}: int32 (B, S) numpy, the targets the
        tokens shifted by one; "hosts": the hosts read."""
        recipe = self.recipes[self._step % len(self.recipes)]
        avoid = self.dead_hosts | self.slow_hosts
        if avoid:
            hosts, accessed = self.plan.cover_excluding(recipe, avoid)
        else:
            hosts, accessed = self.plan.hosts_for_batch(recipe)
        self.span_log.append(len(hosts))
        # deterministic interleave of shard streams into (B, S+1)
        per = self.batch_size * (self.seq_len + 1)
        chunks = []
        for h, shard_ids in zip(hosts, accessed):
            st = self.host_stats[h]
            for s in shard_ids:
                take = per // max(1, sum(len(a) for a in accessed))
                tok = self.source.read(int(s), self._step, take + 1)
                chunks.append(tok)
                st.reads += 1
                st.bytes += tok.nbytes
        flat = np.concatenate(chunks)
        reps = -(-per // len(flat))
        flat = np.tile(flat, reps)[:per].reshape(
            self.batch_size, self.seq_len + 1
        )
        self._step += 1
        return {
            "tokens": flat[:, :-1].copy(),
            "targets": flat[:, 1:].copy(),
            "hosts": hosts,
        }

    # --------------------------------------------------------------- metrics
    def avg_span(self) -> float:
        return float(np.mean(self.span_log)) if self.span_log else 0.0

    def idle_host_fraction(self) -> float:
        """Hosts that no batch touched can sleep (the paper's energy
        story)."""
        touched = sum(1 for s in self.host_stats if s.reads > 0)
        return 1.0 - touched / self.num_hosts

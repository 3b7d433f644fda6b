"""repro_torch.scale — the cluster-scale placement pipeline.

The paper fits one hypergraph in one pass; this package decomposes
million-query traces along the workload's own structure:

  stream        — `StreamingHypergraphBuilder`: out-of-core chunked trace
                  ingestion into growing CSR buffers (vectorized
                  canonicalization, optional duplicate-edge weight
                  merging); bit-identical to `Hypergraph.from_edges`
  sharder       — `shard_workload`: connected components + HPA coarse cut
                  of oversized components into near-independent
                  sub-workloads, with explicit boundary-edge accounting
                  (`boundary_cost` = sum w_e * (lambda_e - 1))
  parallel_fit  — `fit_sharded_placement`: per-shard fits, serial or on
                  spawned worker processes (bit-identical), block-structured
                  merge + capacity reconciliation, and a bounded LMBR
                  repair pass restricted to cross-shard boundary edges

`PlacementService.fit_sharded` (``repro_torch.core.placement_service``) is
the production entry point.  Ingestion and sharding are host numpy; the
shard fits and the repair run the span engine and the LMBR peel on the
caller's ``device``.
"""

from .stream import StreamingHypergraphBuilder  # noqa: F401
from .sharder import (  # noqa: F401
    ShardSpec,
    ShardingPlan,
    connected_components,
    shard_workload,
)
from .parallel_fit import (  # noqa: F401
    ShardedFitResult,
    fit_sharded_placement,
)

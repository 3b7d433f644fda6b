"""repro_torch.core — the placement pipeline: a workload becomes a
`Hypergraph`, HPA gives the balanced start, one of the paper's replicating
algorithms (IHPA, DS, PRA, LMBR) places copies over the batched span
engine, and `Simulator.run` replays the trace.

Layout:
  hypergraph  — workload model (queries = hyperedges over data items)
  cluster     — node profiles, the scalar/vector capacity seam, durability
  workloads   — Random / Snowflake / TPC-H-hetero / LMBR-stress / ISPD-like
                generators
  setcover    — greedy replica selection and the batched span engine
  hpa         — multilevel hypergraph partitioner (hMETIS stand-in)
  algorithms  — IHPA, DS, PRA, LMBR (+ Random, HPA baselines)
  three_way   — fixed RF=3 variants (PRA-3W, SDA, IHPA-3W, Random-3W)
  simulator   — trace-driven simulator + energy model; `run_online` serves
                the trace through ``repro_torch.online``
  placement_service — fit / refit / hierarchical (pod/host) service API
  expert_placement  — MoE expert->EP-rank placement from routing traces
  shard_placement   — dataset shard->host placement for the input pipeline
"""

from .hypergraph import (  # noqa: F401
    Hypergraph,
    MutableHypergraph,
    canonicalize_csr,
    from_reference_arrays,
)
from .cluster import (  # noqa: F401
    NodeProfile,
    capacity_vector,
    ensure_durability,
    min_replicas,
    normalize_capacity,
    validate_durability,
)
from .setcover import (  # noqa: F401
    Placement,
    SpanMaintainer,
    WorkloadCover,
    batched_cover_csr,
    batched_spans_csr,
    cover_for_query,
    engine_counters,
    greedy_set_cover,
    queries_to_csr,
    query_span,
    spans_for_workload,
)
from .hpa import fresh_partition_cache  # noqa: F401
from .hpa import partition as hpa_partition  # noqa: F401
from .algorithms import (  # noqa: F401
    ALGORITHMS,
    ds,
    hpa_placement,
    ihpa,
    lmbr,
    min_partitions,
    peel_counters,
    pra,
    random_placement,
)
from .three_way import (  # noqa: F401
    THREE_WAY_ALGORITHMS,
    ihpa_3way,
    pra_3way,
    random_3way,
    sda,
)
from .simulator import EnergyModel, SimulationResult, Simulator  # noqa: F401
from .workloads import (  # noqa: F401
    LMBR_STRESS_DEFAULTS,
    PAPER_DEFAULTS,
    Workload,
    ispd_like_workload,
    lmbr_stress_workload,
    random_workload,
    snowflake_workload,
    tpch_heterogeneous,
)
from .placement_service import (  # noqa: F401
    HierarchicalPlan,
    PlacementPlan,
    PlacementService,
)
from .expert_placement import (  # noqa: F401
    ExpertPlacementPlan,
    baseline_contiguous_placement,
    plan_expert_placement,
    routing_trace_to_hypergraph,
    synthetic_routing_trace,
)
from .shard_placement import (  # noqa: F401
    ShardPlacementPlan,
    mixture_batch_recipes,
    plan_shard_placement,
)

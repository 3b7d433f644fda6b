"""repro_torch.core — the placement pipeline: a workload becomes a
`Hypergraph`, HPA gives the balanced start, one of the paper's replicating
algorithms (IHPA, DS, PRA, LMBR) places copies over the batched span
engine, and `Simulator.run` replays the trace.

Layout:
  hypergraph  — workload model (queries = hyperedges over data items)
  cluster     — node profiles and the scalar/vector capacity seam
  workloads   — Random / LMBR-stress / ISPD-like generators
  setcover    — greedy replica selection and the batched span engine
  hpa         — multilevel hypergraph partitioner (hMETIS stand-in)
  algorithms  — IHPA, DS, PRA, LMBR (+ Random, HPA baselines)
  simulator   — trace-driven simulator + energy model
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
    normalize_capacity,
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
from .simulator import EnergyModel, SimulationResult, Simulator  # noqa: F401
from .workloads import (  # noqa: F401
    LMBR_STRESS_DEFAULTS,
    Workload,
    ispd_like_workload,
    lmbr_stress_workload,
    random_workload,
)

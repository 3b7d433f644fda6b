"""repro_torch — the PyTorch/CUDA port of the placement system.

It imports torch and numpy, never jax and nothing of the JAX package.  Host
control code (HPA, the LMBR move loop, greedy-round bookkeeping, pin
attribution) is numpy; device work runs on an explicit ``device`` through
hand-written CUDA kernels (``repro_torch.kernels``), each with a plain
PyTorch version that serves CPU tensors.  ``repro_torch.online`` serves
queries against a changing layout (router, drift refits, failover,
live migration).  The model stack
(``repro_torch.configs``, ``repro_torch.models``,
``repro_torch.launch.serve``) serves hymba-1.5b the same way.
"""

from . import flags  # noqa: F401
from .core import (  # noqa: F401
    Hypergraph,
    Placement,
    SimulationResult,
    Simulator,
    batched_cover_csr,
    from_reference_arrays,
    hpa_placement,
    ispd_like_workload,
    lmbr,
    lmbr_stress_workload,
    random_placement,
    random_workload,
)

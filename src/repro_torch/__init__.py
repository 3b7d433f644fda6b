"""repro_torch — the PyTorch/CUDA port of the placement system.

It imports torch and numpy, never jax and nothing of the JAX package.  Host
control code (HPA, the LMBR move loop, greedy-round bookkeeping, pin
attribution) is numpy; device work runs on an explicit ``device`` through
hand-written CUDA kernels (``repro_torch.kernels``), each with a plain
PyTorch version that serves CPU tensors.
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

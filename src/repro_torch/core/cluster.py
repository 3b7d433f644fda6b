"""Per-partition node profiles and the scalar/vector capacity seam.

A copy of the part of the JAX package's ``core/cluster.py`` the placement
pipeline reads.  ``normalize_capacity`` collapses a uniform per-partition
capacity vector back to the plain Python float, so a homogeneous
``NodeProfile`` takes exactly the code paths of the scalar capacity it
replaces; only genuinely heterogeneous vectors flow through the (N,)
broadcasting paths.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "NodeProfile", "normalize_capacity", "capacity_vector",
    "DEFAULT_FAIL_PROB", "DEFAULT_POWER_IDLE", "DEFAULT_POWER_ACTIVE",
    "DEFAULT_ACCESS_COST",
]

DEFAULT_FAIL_PROB = 0.01     # per-partition loss probability
DEFAULT_POWER_IDLE = 100.0   # W drawn by an empty (powered-down) partition
DEFAULT_POWER_ACTIVE = 250.0  # W drawn by a loaded partition (~ e_machine)
DEFAULT_ACCESS_COST = 1.0    # relative per-access serving cost


def normalize_capacity(capacity):
    """Collapse a uniform per-partition capacity vector to the scalar float
    path; non-uniform vectors pass through as float64 (N,) arrays."""
    if isinstance(capacity, np.ndarray):
        cap = np.asarray(capacity, dtype=np.float64)
        if cap.ndim == 0:
            return float(cap)
        if cap.ndim != 1:
            raise ValueError(f"capacity must be scalar or 1-D, got {cap.shape}")
        if cap.size and np.all(cap == cap[0]):
            return float(cap[0])
        return cap
    return float(capacity)


def capacity_vector(capacity, n: int) -> np.ndarray:
    """(n,) float64 view of a scalar-or-vector capacity."""
    if isinstance(capacity, np.ndarray) and capacity.ndim:
        cap = np.asarray(capacity, dtype=np.float64)
        if len(cap) != n:
            raise ValueError(f"capacity vector has {len(cap)} entries, want {n}")
        return cap
    return np.full(n, float(capacity))


def _as_col(x, n: int, name: str) -> np.ndarray:
    arr = np.asarray(x, dtype=np.float64)
    if arr.ndim == 0:
        arr = np.full(n, float(arr))
    if arr.shape != (n,):
        raise ValueError(f"{name} must be scalar or ({n},), got {arr.shape}")
    return arr


@dataclasses.dataclass(frozen=True)
class NodeProfile:
    """Per-partition attribute table: every column is an (N,) float64
    array; scalars broadcast at construction.  Immutable."""

    capacity: np.ndarray
    fail_prob: np.ndarray
    power_idle: np.ndarray
    power_active: np.ndarray
    access_cost: np.ndarray

    def __post_init__(self):
        n = len(np.atleast_1d(np.asarray(self.capacity, dtype=np.float64)))
        for name in ("capacity", "fail_prob", "power_idle", "power_active",
                     "access_cost"):
            object.__setattr__(
                self, name, _as_col(getattr(self, name), n, name)
            )
        if (self.capacity <= 0).any():
            raise ValueError("capacity must be positive")
        if ((self.fail_prob <= 0) | (self.fail_prob >= 1)).any():
            raise ValueError("fail_prob must lie strictly in (0, 1)")

    @classmethod
    def homogeneous(
        cls,
        num_partitions: int,
        capacity: float,
        fail_prob: float = DEFAULT_FAIL_PROB,
        power_idle: float = DEFAULT_POWER_IDLE,
        power_active: float = DEFAULT_POWER_ACTIVE,
        access_cost: float = DEFAULT_ACCESS_COST,
    ) -> "NodeProfile":
        """N identical partitions (bit-identical to the scalar model)."""
        n = int(num_partitions)
        return cls(
            capacity=np.full(n, float(capacity)),
            fail_prob=np.full(n, float(fail_prob)),
            power_idle=np.full(n, float(power_idle)),
            power_active=np.full(n, float(power_active)),
            access_cost=np.full(n, float(access_cost)),
        )

    @property
    def num_partitions(self) -> int:
        return len(self.capacity)

    @property
    def is_homogeneous(self) -> bool:
        return all(
            col.size == 0 or bool(np.all(col == col[0]))
            for col in (self.capacity, self.fail_prob, self.power_idle,
                        self.power_active, self.access_cost)
        )

    def capacity_arg(self):
        """The capacity to hand the fitters: the plain scalar float when
        uniform, the (N,) vector otherwise."""
        return normalize_capacity(self.capacity)

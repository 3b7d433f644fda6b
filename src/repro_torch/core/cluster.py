"""Per-partition node profiles, the scalar/vector capacity seam, and
durability.

A copy of the JAX package's ``core/cluster.py``.  ``normalize_capacity``
collapses a uniform per-partition capacity vector back to the plain Python
float, so a homogeneous ``NodeProfile`` takes exactly the code paths of the
scalar capacity it replaces; only genuinely heterogeneous vectors flow
through the (N,) broadcasting paths.

Durability: under independent failures an item stored on partitions S is
lost with probability ``prod_{p in S} fail_prob[p]``.  `min_replicas` is
the smallest k whose k most reliable partitions meet ``eps``;
`ensure_durability` greedily adds copies (lowest fail_prob first, ties ->
least loaded, then lowest id) until every item meets the ceiling, never
exceeding capacity; `validate_durability` re-checks it from scratch.  All
of it is host numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "NodeProfile", "normalize_capacity", "capacity_vector",
    "min_replicas", "ensure_durability", "validate_durability",
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

    def routing_cost(self) -> np.ndarray:
        """Static per-partition serving-cost key: access cost plus
        mean-normalized active power (constant for uniform profiles)."""
        pa = self.power_active
        scale = float(pa.mean()) if pa.size and float(pa.mean()) > 0 else 1.0
        return self.access_cost + pa / scale

    def subset(self, rows) -> "NodeProfile":
        """Profile restricted to a row subset."""
        rows = np.asarray(rows)
        return NodeProfile(
            capacity=self.capacity[rows].copy(),
            fail_prob=self.fail_prob[rows].copy(),
            power_idle=self.power_idle[rows].copy(),
            power_active=self.power_active[rows].copy(),
            access_cost=self.access_cost[rows].copy(),
        )


# ------------------------------------------------------------- durability
def min_replicas(fail_probs, eps: float) -> int:
    """Smallest k such that the k most reliable partitions satisfy
    ``prod(fail_prob) <= eps``; ``len(fail_probs) + 1`` when no subset
    does (infeasible)."""
    p = np.sort(np.asarray(fail_probs, dtype=np.float64))
    prod = 1.0
    for k in range(len(p)):
        prod *= float(p[k])
        if prod <= eps:
            return k + 1
    return len(p) + 1


def _loss_probs(member: np.ndarray, fail: np.ndarray) -> np.ndarray:
    """(V,) per-item loss probability ``prod_{p holds v} fail[p]``, one
    pass per partition (the reference's product order)."""
    loss = np.ones(member.shape[1], dtype=np.float64)
    for p in range(member.shape[0]):
        row = member[p]
        if row.any():
            loss[row] *= float(fail[p])
    return loss


def ensure_durability(pl, profile: NodeProfile, eps: float) -> np.ndarray:
    """Greedily add replicas until every placed item (weight > 0) has loss
    probability <= ``eps``.

    Items ascend by id; each copy goes to the feasible partition with the
    lowest ``fail_prob`` (ties -> least loaded, then lowest id).  Mutates
    ``pl.member`` in place (copies only) and returns the ids of items that
    received copies.  Raises ValueError when capacity cannot satisfy the
    ceiling."""
    if eps <= 0:
        raise ValueError(f"durability_eps must be > 0, got {eps}")
    member = pl.member
    n = member.shape[0]
    fail = _as_col(profile.fail_prob, n, "fail_prob")
    cap = capacity_vector(pl.capacity, n)
    weights = np.asarray(pl.node_weights, dtype=np.float64)
    loads = member @ weights
    loss = _loss_probs(member, fail)
    placed = member.any(axis=0)
    need = np.flatnonzero((loss > eps) & placed & (weights > 0))
    touched: list[int] = []
    for v in need:
        v = int(v)
        wv = float(weights[v])
        p_loss = float(loss[v])
        while p_loss > eps:
            cand = np.flatnonzero(
                ~member[:, v] & (loads + wv <= cap + 1e-9)
            )
            if not len(cand):
                raise ValueError(
                    f"cannot satisfy durability_eps={eps}: item {v} at "
                    f"p_loss={p_loss:.2e} has no feasible partition left"
                )
            key = np.lexsort((cand, loads[cand], fail[cand]))
            d = int(cand[key[0]])
            member[d, v] = True
            loads[d] += wv
            p_loss *= float(fail[d])
            touched.append(v)
    return np.unique(np.asarray(touched, dtype=np.int64))


def validate_durability(pl, profile: NodeProfile, eps: float,
                        rtol: float = 1e-9) -> None:
    """Raise ValueError unless every placed item (weight > 0) satisfies
    ``prod fail_prob <= eps`` (small relative tolerance for float
    products)."""
    member = pl.member
    fail = _as_col(profile.fail_prob, member.shape[0], "fail_prob")
    weights = np.asarray(pl.node_weights, dtype=np.float64)
    loss = _loss_probs(member, fail)
    bad = np.flatnonzero(
        (loss > eps * (1 + rtol)) & member.any(axis=0) & (weights > 0)
    )
    if len(bad):
        v = int(bad[0])
        raise ValueError(
            f"{len(bad)} items violate durability_eps={eps}, e.g. item {v} "
            f"at p_loss={loss[v]:.2e}"
        )

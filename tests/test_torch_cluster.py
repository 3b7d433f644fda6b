"""Durability and node-profile helpers of ``repro_torch.core.cluster``
against the JAX package's on the same inputs: ``min_replicas``,
``ensure_durability`` (touched ids and the member matrix it leaves),
``validate_durability`` and its errors, ``routing_cost`` and ``subset``.
Every comparison is exact."""

import numpy as np
import pytest

from repro.core import cluster as ref
from repro.core.setcover import Placement as RefPlacement
from repro_torch.core import cluster
from repro_torch.core.setcover import Placement


def _profiles(n, seed, capacity=10.0):
    rng = np.random.default_rng(seed)
    cols = dict(capacity=np.full(n, capacity),
                fail_prob=rng.uniform(0.01, 0.3, n),
                power_idle=rng.uniform(50, 150, n),
                power_active=rng.uniform(150, 400, n),
                access_cost=rng.uniform(0, 2, n))
    return ref.NodeProfile(**cols), cluster.NodeProfile(**cols)


@pytest.mark.parametrize("seed", range(6))
def test_min_replicas(seed):
    rng = np.random.default_rng(seed)
    fail = rng.uniform(0.001, 0.9, int(rng.integers(1, 9)))
    for eps in (1e-9, 1e-4, 1e-2, 0.05, 0.5, float(np.min(fail)), 1.0):
        assert cluster.min_replicas(fail, eps) == ref.min_replicas(fail, eps)
    # the edges: an exact product, unsatisfiable, and no partitions
    assert cluster.min_replicas([0.5, 0.01, 0.1], 1e-3) == 2
    assert cluster.min_replicas([0.5, 0.5], 1e-3) == 3
    assert cluster.min_replicas([], 0.1) == ref.min_replicas([], 0.1) == 1


def _layout(seed, n=8, v=40, copies=2):
    rng = np.random.default_rng(seed)
    member = np.zeros((n, v), dtype=bool)
    for item in range(v):
        member[rng.choice(n, size=int(rng.integers(1, copies + 1)),
                          replace=False), item] = True
    member[:, -1] = False  # a phantom (weight 0, unplaced) item
    weights = rng.integers(1, 4, size=v).astype(np.float64)
    weights[-1] = 0.0
    return member, weights


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("eps", [0.05, 0.003])
def test_ensure_durability_touched_and_member(seed, eps):
    member, weights = _layout(seed)
    rp, tp = _profiles(8, seed + 10, capacity=80.0)
    want_pl = RefPlacement(member.copy(), 80.0, weights)
    got_pl = Placement(member.copy(), 80.0, weights)
    want = ref.ensure_durability(want_pl, rp, eps)
    got = cluster.ensure_durability(got_pl, tp, eps)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert len(got)
    assert got_pl.member.tobytes() == want_pl.member.tobytes()
    cluster.validate_durability(got_pl, tp, eps)
    ref.validate_durability(want_pl, rp, eps)


def test_ensure_durability_vector_capacity():
    member, weights = _layout(7, copies=1)
    cap = np.linspace(30.0, 70.0, 8)
    rp, tp = _profiles(8, 3)
    want_pl = RefPlacement(member.copy(), cap, weights)
    got_pl = Placement(member.copy(), cap, weights)
    want = ref.ensure_durability(want_pl, rp, 0.01)
    got = cluster.ensure_durability(got_pl, tp, 0.01)
    assert got.tobytes() == want.tobytes()
    assert got_pl.member.tobytes() == want_pl.member.tobytes()


def _err(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


def test_durability_errors_match_the_reference():
    # tests/test_cluster.py's two ValueError paths, both packages
    member = np.zeros((3, 2), dtype=bool)
    member[2, 0] = True
    member[0, 1] = True
    cols = dict(capacity=np.full(3, 10.0),
                fail_prob=np.array([0.01, 0.1, 0.5]), power_idle=100.0,
                power_active=250.0, access_cost=1.0)
    rp, tp = ref.NodeProfile(**cols), cluster.NodeProfile(**cols)
    want_pl = RefPlacement(member.copy(), 10.0, np.ones(2))
    got_pl = Placement(member.copy(), 10.0, np.ones(2))
    assert (_err(cluster.validate_durability, got_pl, tp, 0.05)
            == _err(ref.validate_durability, want_pl, rp, 0.05))
    assert (cluster.ensure_durability(got_pl, tp, 0.05).tolist()
            == ref.ensure_durability(want_pl, rp, 0.05).tolist() == [0])
    assert got_pl.member[:, 0].tolist() == [True, False, True]
    assert (_err(cluster.ensure_durability, got_pl, tp, 0.0)
            == _err(ref.ensure_durability, want_pl, rp, 0.0))

    full = np.zeros((2, 2), dtype=bool)
    full[0] = True
    cols = dict(capacity=np.array([2.0, 0.5]), fail_prob=0.2,
                power_idle=1.0, power_active=2.0, access_cost=1.0)
    msg = _err(cluster.ensure_durability, Placement(full.copy(), 2.0,
                                                    np.ones(2)),
               cluster.NodeProfile(**cols), 1e-3)
    assert "durability" in msg
    assert msg == _err(ref.ensure_durability,
                       RefPlacement(full.copy(), 2.0, np.ones(2)),
                       ref.NodeProfile(**cols), 1e-3)


@pytest.mark.parametrize("seed", range(3))
def test_routing_cost_and_subset(seed):
    rp, tp = _profiles(9, seed)
    assert tp.routing_cost().tobytes() == rp.routing_cost().tobytes()
    hom = (ref.NodeProfile.homogeneous(4, 5.0),
           cluster.NodeProfile.homogeneous(4, 5.0))
    assert hom[1].routing_cost().tobytes() == hom[0].routing_cost().tobytes()
    rows = np.random.default_rng(seed).choice(9, size=4, replace=False)
    got, want = tp.subset(rows), rp.subset(rows)
    for name in ("capacity", "fail_prob", "power_idle", "power_active",
                 "access_cost"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()
    assert got.num_partitions == 4

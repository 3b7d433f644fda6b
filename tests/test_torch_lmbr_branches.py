"""LMBR's branches that the service path reaches, port (on the CPU)
against the JAX package: the energy objective (cold start and a warm
``initial``), the capacity-vector cold start, ``initial``, ``dest_mask``,
``node_cost`` under ``nodecost0.3`` / ``nodecost2``, and the engine
variants ``lmbrepochpartition``, ``lmbrcache0``, ``peelauto`` and
``peelreference``.  The member matrix and every ``stats`` entry must be
equal.  The workload has unit node weights, so the reference's oracle
peel (``peelreference``) is exact there; on non-integer weights it differs
from the reference's own batched engine in the last ulp."""

import numpy as np
import pytest

from repro import flags as ref_flags
from repro.core import lmbr as ref_lmbr
from repro.core.setcover import Placement as RefPlacement
from repro.core.workloads import random_workload as ref_random
from repro_torch import flags
from repro_torch.core import Placement, from_reference_arrays, hpa, lmbr

N = 12
_GRAPH = {}


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _graphs():
    if not _GRAPH:
        hg = ref_random(200, 500, density=6, seed=7).hypergraph
        _GRAPH["ref"] = hg
        _GRAPH["port"] = from_reference_arrays(
            hg.edge_ptr, hg.edge_nodes, hg.node_weights, hg.edge_weights,
            hg.num_nodes)
    return _GRAPH["ref"], _GRAPH["port"]


def _initial(cap):
    """A short LMBR fit of another seed: the warm start a refit gets."""
    hg, _ = _graphs()
    return ref_lmbr(hg, N, float(cap), seed=3, max_moves=10).member


def _mask():
    m = np.ones(N, dtype=bool)
    m[[2, 9]] = False
    return m


_COST = np.random.default_rng(5).uniform(0.0, 1.0, N)

# branch -> (variant, kwargs maker given the capacity, vector capacity?)
BRANCHES = {
    "energy": ("energy", lambda cap: {}, False),
    "energy-initial": ("energy", lambda cap: dict(initial=_initial(cap)),
                       False),
    "capacity-vector": ("", lambda cap: {}, True),
    "initial": ("", lambda cap: dict(initial=_initial(cap)), False),
    "dest-mask": ("", lambda cap: dict(dest_mask=_mask()), False),
    "nodecost0.3": ("nodecost0.3", lambda cap: dict(node_cost=_COST), False),
    "nodecost2": ("nodecost2", lambda cap: dict(node_cost=_COST,
                                                dest_mask=_mask()), False),
    "lmbrepochpartition": ("lmbrepochpartition", lambda cap: {}, False),
    "lmbrcache0": ("lmbrcache0", lambda cap: {}, False),
    "peelauto": ("peelauto", lambda cap: {}, False),
    "peelreference": ("peelreference", lambda cap: {}, False),
}


@pytest.mark.parametrize("cap", [20, 40])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_lmbr_branch_matches_reference(branch, cap):
    variant, make_kw, vector = BRANCHES[branch]
    ref_hg, hg = _graphs()
    capacity = (np.linspace(0.75 * cap, 1.25 * cap, N) if vector
                else float(cap))
    kw = make_kw(cap)
    ref_kw, port_kw = dict(kw), dict(kw)
    if "initial" in kw:
        ref_kw["initial"] = RefPlacement(kw["initial"].copy(), capacity,
                                         ref_hg.node_weights)
        port_kw["initial"] = Placement.from_member(kw["initial"], capacity)
    ref_flags.set_variant(variant)
    flags.set_variant(variant)
    want = ref_lmbr(ref_hg, N, capacity, seed=0, max_moves=150, **ref_kw)
    with hpa.fresh_partition_cache():
        got = lmbr(hg, N, capacity, seed=0, max_moves=150, device="cpu",
                   **port_kw)
    assert got.member.tobytes() == want.member.tobytes()
    assert got.stats == want.stats
    assert want.stats["moves"] > 0
    got.validate()
    if "dest_mask" in kw:
        start = (kw["initial"] if "initial" in kw else None)
        assert start is None or not (got.member & ~start)[~kw[
            "dest_mask"]].any()
    if variant == "energy" and "initial" not in kw:
        assert (got.member.sum(axis=1) == 0).any()

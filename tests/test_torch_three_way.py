"""The fixed replication-factor algorithms (paper §4.6) of the port
against the JAX package's: ``pra_3way``, ``sda``, ``ihpa_3way`` and
``random_3way`` on three small workloads, at rf 2 and 3, at the default
N = rf * N_e and at an explicit N; member matrices equal byte for byte,
every item on exactly rf distinct partitions, and ``Simulator.compare``'s
summaries equal (minus ``placement_s``)."""

import numpy as np
import pytest

from repro.core import THREE_WAY_ALGORITHMS as REF_THREE_WAY
from repro.core import Simulator as RefSimulator
from repro.core import min_partitions as ref_min_partitions
from repro.core.workloads import random_workload as ref_random
from repro.core.workloads import snowflake_workload as ref_snowflake
from repro_torch import flags
from repro_torch.core import THREE_WAY_ALGORITHMS, Simulator, hpa
from repro_torch.core import from_reference_arrays

WORKLOADS = {
    "random": (lambda: ref_random(120, 300, 3, 8, 6, seed=1).hypergraph, 20),
    "snowflake": (lambda: ref_snowflake(num_items=150, num_queries=250,
                                        seed=2).hypergraph, 25),
    "weighted": (lambda: ref_snowflake(
        num_items=100, num_queries=200, seed=3,
        item_weights=np.random.default_rng(3).integers(
            1, 3, 100).astype(np.float64)).hypergraph, 30),
}
_GRAPHS = {}


def _graphs(name):
    if name not in _GRAPHS:
        make, cap = WORKLOADS[name]
        hg = make()
        _GRAPHS[name] = (hg, from_reference_arrays(
            hg.edge_ptr, hg.edge_nodes, hg.node_weights, hg.edge_weights,
            hg.num_nodes), cap)
    return _GRAPHS[name]


@pytest.mark.parametrize("algo", list(REF_THREE_WAY))
@pytest.mark.parametrize("rf", [2, 3])
@pytest.mark.parametrize("explicit_n", [False, True])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_three_way_matches_reference(workload, explicit_n, rf, algo):
    ref_hg, hg, cap = _graphs(workload)
    kw = dict(capacity=float(cap), rf=rf, seed=1)
    if explicit_n:
        kw["n"] = rf * ref_min_partitions(ref_hg, cap) + 2
    want = REF_THREE_WAY[algo](ref_hg, **kw)
    with hpa.fresh_partition_cache():
        got = THREE_WAY_ALGORITHMS[algo](hg, device="cpu", **kw)
    assert got.member.tobytes() == want.member.tobytes()
    assert got.member.shape == want.member.shape
    assert (got.member.sum(axis=0) == rf).all()
    got.validate()


def test_compare_summaries_match_reference():
    ref_hg, hg, cap = _graphs("random")
    n = 3 * ref_min_partitions(ref_hg, cap)
    want = RefSimulator(n, cap).compare(ref_hg, REF_THREE_WAY, seed=0)
    flags.set_variant("spandevice")
    try:
        got = Simulator(n, cap, device="cpu").compare(
            hg, THREE_WAY_ALGORITHMS, seed=0)
    finally:
        flags.reset()
    assert list(got) == list(want) == ["random3", "sda", "ihpa3", "pra3"]
    for name in want:
        a, b = got[name].summary(), want[name].summary()
        a.pop("placement_s")
        b.pop("placement_s")
        assert a == b, name
        assert np.array_equal(got[name].spans, want[name].spans)
        assert got[name].member.sum(axis=0).tolist() == [3] * hg.num_nodes

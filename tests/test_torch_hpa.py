"""HPA: the port's multilevel partitioner against the JAX package's on the
same hypergraphs, part counts, capacities and seeds — identical
assignments."""

import numpy as np
import pytest

from repro.core import hpa as ref_hpa
from repro.core.workloads import ispd_like_workload as ref_ispd
from repro.core.workloads import random_workload as ref_random
from repro_torch.core import from_reference_arrays, hpa


def _port_graph(ref):
    return from_reference_arrays(ref.edge_ptr, ref.edge_nodes,
                                 ref.node_weights, ref.edge_weights,
                                 ref.num_nodes)


CASES = [
    ("random", dict(k=12, capacity=20.0, seed=0)),
    ("random", dict(k=5, capacity=45.0, seed=3, nruns=1)),
    ("random", dict(k=4, capacity=None, seed=1)),
    ("ispd", dict(k=35, capacity=100.0, seed=0)),
    ("ispd", dict(k=20, capacity=np.linspace(90.0, 130.0, 20), seed=2)),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_partition_identical(name, kw):
    ref = (ref_random(200, 500, density=6, seed=7).hypergraph
           if name == "random"
           else ref_ispd(num_nodes=2000, seed=0).hypergraph)
    with ref_hpa.fresh_partition_cache():
        want = ref_hpa.partition(ref, **kw)
    with hpa.fresh_partition_cache():
        got = hpa.partition(_port_graph(ref), **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    k = kw["k"]
    assert hpa.connectivity_cost(_port_graph(ref), got, k) == \
        ref_hpa.connectivity_cost(ref, want, k)


def test_partition_memo_is_scoped():
    ref = ref_random(80, 120, density=4, seed=2).hypergraph
    hg = _port_graph(ref)
    with hpa.fresh_partition_cache():
        a = hpa.partition(hg, 4, 25.0, seed=0)
        assert len(hpa._PARTITION_CACHE) == 1
        a[:] = -1  # callers get copies; the memo is unharmed
        b = hpa.partition(hg, 4, 25.0, seed=0)
    assert (b >= 0).all()
    with pytest.raises(ValueError):
        hpa.partition(hg, 2, 10.0)

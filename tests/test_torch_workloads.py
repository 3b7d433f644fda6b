"""The port's Snowflake and TPC-H-heterogeneous generators against the
JAX package's: the same seed and arguments give byte-identical CSR arrays,
weights and item graphs, and ``Workload.queries`` the same queries."""

import numpy as np
import pytest

from repro.core import workloads as ref
from repro_torch.core import workloads

ARRAYS = ("edge_ptr", "edge_nodes", "node_weights", "edge_weights")


def _same(got, want):
    for name in ARRAYS:
        a, b = getattr(got.hypergraph, name), getattr(want.hypergraph, name)
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    assert got.name == want.name
    if want.item_graph_edges is None:
        assert got.item_graph_edges is None
    else:
        assert (got.item_graph_edges.tobytes()
                == want.item_graph_edges.tobytes())


SNOWFLAKE = [
    dict(num_items=300, num_queries=400, seed=0),
    dict(num_items=250, num_queries=300, seed=3, levels=4, degree=3),
    dict(num_items=120, num_queries=200, seed=5, levels=2, degree=7,
         min_query=2, max_query=5),
    dict(num_items=6, num_queries=20, seed=1, levels=5, degree=2),
]


@pytest.mark.parametrize("kw", SNOWFLAKE)
def test_snowflake_workload(kw):
    _same(workloads.snowflake_workload(**kw), ref.snowflake_workload(**kw))


def test_snowflake_item_weights():
    w = np.random.default_rng(2).uniform(0.5, 3.0, 150)
    kw = dict(num_items=150, num_queries=250, seed=4, item_weights=w)
    _same(workloads.snowflake_workload(**kw), ref.snowflake_workload(**kw))


TPCH = [
    dict(num_items=300, num_queries=500, seed=0),
    dict(num_items=400, num_queries=300, seed=2, scale_factor=10),
    dict(num_items=200, num_queries=300, seed=1, target_min_partitions=6,
         capacity=50.0, levels=4, degree=3),
]


@pytest.mark.parametrize("kw", TPCH)
def test_tpch_heterogeneous(kw):
    _same(workloads.tpch_heterogeneous(**kw), ref.tpch_heterogeneous(**kw))


def test_workload_queries_and_paper_defaults():
    got = workloads.tpch_heterogeneous(num_items=200, num_queries=150, seed=1)
    want = ref.tpch_heterogeneous(num_items=200, num_queries=150, seed=1)
    gq, wq = got.queries, want.queries
    assert len(gq) == len(wq) == 150
    for a, b in zip(gq, wq):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    rq = workloads.random_workload(80, 60, density=4, seed=2).queries
    assert [q.tolist() for q in rq] == [
        q.tolist() for q in ref.random_workload(80, 60, density=4,
                                                seed=2).queries]
    assert workloads.PAPER_DEFAULTS == ref.PAPER_DEFAULTS

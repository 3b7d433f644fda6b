"""Inputs of the placement pipeline: the port's hypergraph helpers, capacity
seam and workload generators against the JAX package's, byte for byte on
the same seeds."""

import numpy as np
import pytest

from repro.core import cluster as ref_cluster
from repro.core import hypergraph as ref_hg
from repro.core import workloads as ref_wl
from repro_torch.core import cluster, hypergraph, workloads
from repro_torch.core import from_reference_arrays


def _assert_same_graph(got, want):
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kw", [
    dict(num_items=200, num_queries=500, density=6),
    dict(num_items=60, num_queries=90, min_query=1, max_query=30,
         density=3),
])
def test_random_workload_identical(kw, seed):
    got = workloads.random_workload(seed=seed, **kw)
    want = ref_wl.random_workload(seed=seed, **kw)
    _assert_same_graph(got.hypergraph, want.hypergraph)
    assert got.item_graph_edges.tobytes() == want.item_graph_edges.tobytes()
    assert got.name == want.name


@pytest.mark.parametrize("seed", [0, 3])
def test_ispd_like_workload_identical(seed):
    got = workloads.ispd_like_workload(num_nodes=2000, seed=seed)
    want = ref_wl.ispd_like_workload(num_nodes=2000, seed=seed)
    _assert_same_graph(got.hypergraph, want.hypergraph)
    assert got.name == want.name


def test_lmbr_stress_workload_identical():
    assert workloads.LMBR_STRESS_DEFAULTS == ref_wl.LMBR_STRESS_DEFAULTS
    kw = dict(num_items=300, num_queries=800, density=12, seed=2)
    got = workloads.lmbr_stress_workload(**kw)
    want = ref_wl.lmbr_stress_workload(**kw)
    _assert_same_graph(got.hypergraph, want.hypergraph)
    assert got.name == want.name


def test_csr_helpers_identical():
    rng = np.random.default_rng(5)
    sizes = rng.integers(0, 9, size=40)
    ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    nodes = rng.integers(0, 25, size=int(ptr[-1])).astype(np.int64)
    for a, b in zip(hypergraph.canonicalize_csr(ptr, nodes),
                    ref_hg.canonicalize_csr(ptr, nodes)):
        assert a.tobytes() == b.tobytes()
    cptr, cnodes = ref_hg.canonicalize_csr(ptr, nodes)
    for a, b in zip(hypergraph.build_incidence(cptr, cnodes, 25),
                    ref_hg.build_incidence(cptr, cnodes, 25)):
        assert a.tobytes() == b.tobytes()
    ids = rng.choice(40, size=15, replace=False)
    for a, b in zip(hypergraph.csr_ranges(cptr, ids),
                    ref_hg.csr_ranges(cptr, ids)):
        assert a.tobytes() == b.tobytes()


def test_hypergraph_methods_identical():
    want = ref_wl.random_workload(100, 150, density=4, seed=1).hypergraph
    got = from_reference_arrays(want.edge_ptr, want.edge_nodes,
                                want.node_weights, want.edge_weights,
                                want.num_nodes)
    _assert_same_graph(got, want)
    assert got.edge_nodes is not want.edge_nodes
    for a, b in zip(got.incidence(), want.incidence()):
        assert a.tobytes() == b.tobytes()
    assert got.degrees().tobytes() == want.degrees().tobytes()
    ids = np.array([5, 0, 17, 3])
    for a, b in zip(got.edges_csr(ids), want.edges_csr(ids)):
        assert a.tobytes() == b.tobytes()
    assert (got.num_nodes, got.num_edges, got.num_pins) == (
        want.num_nodes, want.num_edges, want.num_pins)
    assert got.total_node_weight() == want.total_node_weight()
    edges = [[3, 1, 3], [0], [2, 4]]
    _assert_same_graph(hypergraph.Hypergraph.from_edges(edges, 6),
                       ref_hg.Hypergraph.from_edges(edges, 6))


def test_from_reference_arrays_validates():
    with pytest.raises(ValueError):
        from_reference_arrays([0, 2], [0, 5], None, None, 3)
    with pytest.raises(ValueError):
        from_reference_arrays([0, 2], [0, 1], [1.0], None, 3)
    hg = from_reference_arrays([0, 2], [0, 1], None, None, 3)
    assert hg.node_weights.tolist() == [1.0, 1.0, 1.0]
    assert hg.edge_weights.tolist() == [1.0]


@pytest.mark.parametrize("cap", [50, 50.0, np.array([4.0, 4.0, 4.0]),
                                 np.array([1.0, 2.0, 3.0]), np.array(7.0)])
def test_capacity_seam_identical(cap):
    got, want = cluster.normalize_capacity(cap), ref_cluster.normalize_capacity(cap)
    assert type(got) is type(want)
    assert np.array_equal(got, want)
    assert np.array_equal(cluster.capacity_vector(got, 3),
                          ref_cluster.capacity_vector(want, 3))
    prof = cluster.NodeProfile.homogeneous(3, 9.0)
    ref_prof = ref_cluster.NodeProfile.homogeneous(3, 9.0)
    assert prof.capacity_arg() == ref_prof.capacity_arg()
    assert prof.is_homogeneous and ref_prof.is_homogeneous


@pytest.mark.parametrize("seed", [0, 5])
def test_query_size_and_incidence_helpers(seed):
    want = ref_wl.random_workload(150, 300, min_query=1, max_query=9,
                                  density=4, seed=seed).hypergraph
    got = workloads.random_workload(150, 300, min_query=1, max_query=9,
                                    density=4, seed=seed).hypergraph
    assert got.avg_items_per_query() == want.avg_items_per_query()
    for v in range(0, 150, 7):
        a, b = got.node_edges_of(v), want.node_edges_of(v)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    empty = hypergraph.Hypergraph.from_edges([], num_nodes=3)
    assert empty.avg_items_per_query() == ref_hg.Hypergraph.from_edges(
        [], num_nodes=3).avg_items_per_query() == 0.0

"""The paper's Algorithms 1-3 (IHPA, DS, PRA) and the pieces they stand on:
the port (on the CPU) against the JAX package on the same workloads.

Helpers: the hypergraph's subgraph, relabel and heap-peel functions,
``MutableHypergraph``, PRA's greedy hitting set, the ``Placement`` helpers
and ``SpanMaintainer``'s dirty tracking, each equal to the reference's.
Algorithms: ``Simulator.run`` of each algorithm gives the reference's
summary (minus ``placement_s``) and member matrix exactly, also under
``spandevice+spanrounddevice`` (the span kernels' plain versions)."""

import numpy as np
import pytest

from repro import flags as ref_flags
from repro.core import ALGORITHMS as REF_ALGORITHMS
from repro.core import Simulator as RefSimulator
from repro.core import algorithms as ref_algorithms
from repro.core.hypergraph import Hypergraph as RefHypergraph
from repro.core.setcover import Placement as RefPlacement
from repro.core.setcover import SpanMaintainer as RefMaintainer
from repro.core.workloads import ispd_like_workload as ref_ispd
from repro.core.workloads import random_workload as ref_random
from repro_torch import flags
from repro_torch.core import (ALGORITHMS, MutableHypergraph, Placement,
                              Simulator, SpanMaintainer, batched_spans_csr,
                              ds, from_reference_arrays, ihpa, pra)
from repro_torch.core import algorithms

DEVICE_VARIANT = "spandevice+spanrounddevice"


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _port(hg):
    return from_reference_arrays(hg.edge_ptr, hg.edge_nodes, hg.node_weights,
                                 hg.edge_weights, hg.num_nodes)


def _assert_same_graph(got, want):
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name


def _weighted(seed, V=80, E=160, max_q=9, ties=False):
    """A reference hypergraph with node and edge weights; ``ties`` makes
    every weight 1 or 2, so degrees tie often."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_q + 1, size=E)
    edges = [rng.choice(V - 5, size=int(s), replace=False) for s in sizes]
    if ties:
        nw = rng.integers(1, 3, size=V).astype(np.float64)
        ew = rng.integers(1, 3, size=E).astype(np.float64)
    else:
        nw = rng.uniform(0.5, 3.0, size=V)
        ew = rng.uniform(0.1, 2.0, size=E)
    # the last 5 nodes lie in no edge: inactive
    return RefHypergraph.from_edges(edges, num_nodes=V, node_weights=nw,
                                    edge_weights=ew)


# ------------------------------------------------------------ hypergraph
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subhypergraph_and_relabel_match_reference(seed):
    ref = _weighted(seed)
    hg = _port(ref)
    rng = np.random.default_rng(100 + seed)
    ids = np.sort(rng.choice(ref.num_edges, size=ref.num_edges // 3,
                             replace=False))
    want, got = ref.subhypergraph_edges(ids), hg.subhypergraph_edges(ids)
    _assert_same_graph(got, want)
    assert got.node_weights is hg.node_weights  # shared, as in the reference
    np.testing.assert_array_equal(got.active_nodes(), want.active_nodes())
    (want_r, want_ids), (got_r, got_ids) = want.relabel(), got.relabel()
    _assert_same_graph(got_r, want_r)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got_r.num_nodes < hg.num_nodes


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.35, 0.7, 1.0])
def test_heap_peel_matches_reference(frac, ties):
    ref = _weighted(11, ties=ties)
    hg = _port(ref)
    max_weight = frac * ref.total_node_weight()
    np.testing.assert_array_equal(hg.k_densest_nodes(max_weight),
                                  ref.k_densest_nodes(max_weight))
    _assert_same_graph(hg.prune_to_size(max_weight),
                       ref.prune_to_size(max_weight))
    for got, want in zip(hg._peel_to_weight(max_weight),
                         ref._peel_to_weight(max_weight)):
        np.testing.assert_array_equal(got, want)


def test_mutable_hypergraph_matches_reference():
    ref = _weighted(5)
    hg = _port(ref)
    want, got = ref.copy_mutable(), hg.copy_mutable()
    assert isinstance(got, MutableHypergraph)
    assert got.edges == want.edges and got.num_nodes == want.num_nodes
    rng = np.random.default_rng(9)
    for _ in range(40):
        v = int(rng.integers(want.num_nodes))
        assert got.add_node_copy(v) == want.add_node_copy(v)
        for e in rng.choice(ref.num_edges, size=3, replace=False):
            old = int(rng.integers(ref.num_nodes))
            assert (got.replace_in_edge(int(e), old, got.num_nodes - 1)
                    == want.replace_in_edge(int(e), old, want.num_nodes - 1))
        # rewiring a pin to a node the edge already holds dedups on freeze
        e = int(rng.integers(ref.num_edges))
        if len(want.edges[e]) > 1:
            a, b = want.edges[e][:2]
            assert (got.replace_in_edge(e, a, b)
                    == want.replace_in_edge(e, a, b))
    assert got.edges == want.edges
    assert got.node_weights == want.node_weights
    _assert_same_graph(got.freeze(), want.freeze())
    assert got.freeze().num_nodes == ref.num_nodes + 40


# ------------------------------------------------------------ hitting set
HITTING_SETS = {
    "empty": [],
    "all_empty": [[], []],
    "one": [[4, 2, 9]],
    "tie_two": [[3, 1], [1, 3]],
    "tie_lowest_id": [[5, 7], [7, 5], [2, 9], [9, 2]],
    "chain": [[0, 1], [1, 2], [2, 3], [3, 4], [4, 0]],
    "disjoint": [[8], [6], [7], [6]],
}


@pytest.mark.parametrize("name", list(HITTING_SETS) + ["random0", "random1",
                                                         "random2"])
def test_hitting_set_matches_reference(name):
    if name.startswith("random"):
        rng = np.random.default_rng(int(name[-1]))
        sets = [list(rng.choice(6, size=int(rng.integers(0, 4)),
                                replace=False))
                for _ in range(int(rng.integers(5, 30)))]
        sets = [[int(x) for x in s] for s in sets]
    else:
        sets = HITTING_SETS[name]
    want = ref_algorithms._hitting_set(sets)
    assert algorithms._hitting_set(sets) == want
    hit = set(want)
    assert all(hit & set(s) for s in sets if s)


# -------------------------------------------------- placement, maintainer
def _member(rng, N, V, density=0.25):
    member = rng.random((N, V)) < density
    member[rng.integers(0, N, size=V), np.arange(V)] = True  # all placed
    return member


def test_placement_helpers_match_reference():
    rng = np.random.default_rng(4)
    member = _member(rng, 6, 50)
    nw = rng.uniform(0.5, 2.0, size=50)
    caps = np.array([30.0, 10.0, 20.0, 25.0, 40.0, 15.0])
    for cap in (40.0, caps):
        want = RefPlacement(member.copy(), cap, nw.copy())
        got = Placement.from_member(member, cap, nw)
        for p in range(6):
            np.testing.assert_array_equal(got.partition_items(p),
                                          want.partition_items(p))
            assert got.partition_weight(p) == want.partition_weight(p)
            assert got.free_space(p) == want.free_space(p)
        for v in range(50):
            np.testing.assert_array_equal(got.copies_of(v), want.copies_of(v))
        items = rng.choice(50, size=7, replace=False)
        got.add(2, items)
        want.add(2, list(items))
        np.testing.assert_array_equal(got.member, want.member)


@pytest.mark.parametrize("variant", ["", DEVICE_VARIANT, "spandevice"])
@pytest.mark.parametrize("with_covers", [False, True])
def test_span_maintainer_notify_matches_reference(with_covers, variant):
    rng = np.random.default_rng(21)
    wl = ref_random(150, 400, density=5, seed=3)
    ref = wl.hypergraph
    hg = _port(ref)
    member = _member(rng, 8, ref.num_nodes, density=0.05)
    want_pl = RefPlacement(member.copy(), 1e9, ref.node_weights)
    got_pl = Placement.from_member(member, 1e9, ref.node_weights)
    want = RefMaintainer(ref, want_pl, with_covers=with_covers)
    flags.set_variant(variant)
    got = SpanMaintainer(hg, got_pl, with_covers=with_covers, device="cpu")
    for step in range(6):
        p = int(rng.integers(8))
        items = rng.choice(ref.num_nodes, size=int(rng.integers(1, 25)),
                           replace=False)
        got_pl.member[p, items] = True
        want_pl.member[p, items] = True
        if step % 3 == 2:  # a row that loses copies too
            keep = got_pl.member.sum(axis=0) > 1
            drop = np.flatnonzero(got_pl.member[p] & keep)[:5]
            got_pl.member[p, drop] = False
            want_pl.member[p, drop] = False
            items = np.concatenate([items, drop])
        got.notify_items(items)
        want.notify_items(items)
        np.testing.assert_array_equal(got._dirty, want._dirty)
        fresh = batched_spans_csr(hg.edge_ptr, hg.edge_nodes, got_pl.member,
                                  device="cpu")
        np.testing.assert_array_equal(got.spans(), fresh)
        np.testing.assert_array_equal(got.spans(), want.spans())
        assert not got._dirty.any()
        for min_span in (1, 2):
            np.testing.assert_array_equal(got.residual_edges(min_span),
                                          want.residual_edges(min_span))
        if with_covers:
            np.testing.assert_array_equal(got.pin_parts, want.pin_parts)
            for e in range(0, ref.num_edges, 37):
                np.testing.assert_array_equal(got.chosen(e), want.chosen(e))
    got.notify_items(np.zeros(0, dtype=np.int64))
    assert not got._dirty.any()


def test_refresh_edges_clears_the_dirty_bits_it_resolves():
    rng = np.random.default_rng(8)
    ref = ref_random(100, 250, density=4, seed=5).hypergraph
    hg = _port(ref)
    member = _member(rng, 6, ref.num_nodes, density=0.05)
    want_pl = RefPlacement(member.copy(), 1e9, ref.node_weights)
    got_pl = Placement.from_member(member, 1e9, ref.node_weights)
    want = RefMaintainer(ref, want_pl, with_covers=True)
    got = SpanMaintainer(hg, got_pl, with_covers=True, device="cpu")
    items = rng.choice(ref.num_nodes, size=12, replace=False)
    for pl in (got_pl, want_pl):
        pl.member[3, items] = True
    for m in (got, want):
        m.notify_items(items)
    dirty = np.flatnonzero(got._dirty)
    half = dirty[: len(dirty) // 2]
    got.refresh_edges(half)
    want.refresh_edges(half)
    np.testing.assert_array_equal(got._dirty, want._dirty)
    assert got._dirty.sum() == len(dirty) - len(half)
    np.testing.assert_array_equal(got.spans(), want.spans())
    np.testing.assert_array_equal(got.pin_parts, want.pin_parts)


# ------------------------------------------------------------ algorithms
CASES = {
    # the slice test's random workload
    "random": (lambda: ref_random(200, 500, density=6, seed=7).hypergraph,
               12, 20),
    # the fig6 workload at 30 partitions, where IHPA's §4.2 shrink runs
    "shrink": (lambda: ref_random(1000, 4000, 3, 11, 20, seed=0).hypergraph,
               30, 50),
    # a heterogeneous capacity vector (IHPA's prefix rule, DS's per-row cap)
    "capvec": (lambda: ref_random(300, 900, seed=2).hypergraph, 16,
               np.tile([60.0, 20.0], 8)),
    "ispd": (lambda: ref_ispd(num_nodes=2000, seed=0).hypergraph, 35, 100),
    # fig6's paper default (|D| 1000, NQ 4000, density 20; NPar 40, C 50)
    "fig6": (lambda: ref_random(1000, 4000, 3, 11, 20, seed=0).hypergraph,
             40, 50),
}
FIG6_AVG_SPAN = {"ihpa": 4.3455, "ds": 4.51525, "pra": 4.74225}


def _shrink_counter(monkeypatch, module):
    """Count ``batched_spans_csr`` calls made from ``module``'s algorithms:
    in IHPA only the §4.2 shrink calls it (the maintainer calls its own
    module's)."""
    calls = []
    fn = module.batched_spans_csr

    def counting(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, "batched_spans_csr", counting)
    return calls


def _ref_run(hg, n, cap, name):
    members = []

    def fit(*a, **kw):
        pl = REF_ALGORITHMS[name](*a, **kw)
        members.append(pl.member.copy())
        return pl

    res = RefSimulator(n, cap).run(hg, fit, name=name, seed=0)
    return res, members[0]


def _port_run(hg, n, cap, name, variant):
    flags.set_variant(variant)
    res = Simulator(n, cap, device="cpu").run(hg, ALGORITHMS[name],
                                              name=name, seed=0)
    flags.reset()
    return res


@pytest.mark.parametrize("name,case", [
    (name, case) for case in CASES for name in ("ihpa", "ds", "pra")
    if case != "shrink" or name == "ihpa"])
def test_algorithm_matches_reference(name, case, monkeypatch):
    make, n, cap = CASES[case]
    ref_hg = make()
    hg = _port(ref_hg)
    ref_shrinks = _shrink_counter(monkeypatch, ref_algorithms)
    port_shrinks = _shrink_counter(monkeypatch, algorithms)
    want, want_member = _ref_run(ref_hg, n, cap, name)
    want_s = want.summary()
    want_s.pop("placement_s")
    assert not any(k.startswith("fit_") for k in want_s)
    runs = {}
    for variant in ("", DEVICE_VARIANT):
        got = _port_run(hg, n, cap, name, variant)
        got_s = got.summary()
        got_s.pop("placement_s")
        assert got_s == want_s, variant
        np.testing.assert_array_equal(got.member, want_member,
                                      err_msg=variant)
        np.testing.assert_array_equal(got.spans, want.spans, err_msg=variant)
        runs[variant] = got
    assert len(port_shrinks) == 2 * len(ref_shrinks)  # both variants
    if name == "ihpa" and case == "shrink":
        assert len(ref_shrinks) >= 1
    if case == "fig6":
        assert want.avg_span == FIG6_AVG_SPAN[name]
        if name == "ihpa":
            assert not ref_shrinks  # no shrink at 40 partitions
    # replication happened: some item has more than one copy
    assert runs[""].replication_factor > 1.0


@pytest.mark.parametrize("fn", [ihpa, ds, pra])
def test_new_entry_points_raise_without_cuda(fn, monkeypatch):
    import torch

    hg = _port(ref_random(30, 40, density=3, seed=0).hypergraph)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(hg, 4, 20.0)
    assert fn(hg, 4, 20.0, device="cpu").member.shape == (4, 30)

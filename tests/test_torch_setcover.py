"""Batched span engine: the port's ``batched_cover_csr`` and
``SpanMaintainer`` against the JAX package's on the same seeded
hypergraphs and member matrices — spans, cover order, pin attribution and
incremental refreshes identical for single- and multi-word buckets, under
every backend pinning of the port (on the CPU)."""

import numpy as np
import pytest

from repro import flags as ref_flags
from repro.core.hypergraph import Hypergraph as RefHypergraph
from repro.core.setcover import Placement as RefPlacement
from repro.core.setcover import SpanMaintainer as RefMaintainer
from repro.core.setcover import batched_cover_csr as ref_cover
from repro_torch import flags
from repro_torch.core import (Placement, SpanMaintainer, batched_cover_csr,
                              cover_for_query, engine_counters,
                              from_reference_arrays, greedy_set_cover)

VARIANTS = ["", "spannumpy+spanroundnumpy", "spandevice+spanroundnumpy",
            "spanrounddevice", "spanth0+spanroundth0"]


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _instance(seed, V=300, N=9, E=60, max_q=200, density=0.3):
    rng = np.random.default_rng(seed)
    member = rng.random((N, V)) < density
    member[rng.integers(0, N, size=V), np.arange(V)] = True  # all placed
    sizes = rng.integers(1, max_q + 1, size=E)
    edges = [rng.choice(V, size=int(s), replace=False) for s in sizes]
    ref = RefHypergraph.from_edges(edges, num_nodes=V)
    hg = from_reference_arrays(ref.edge_ptr, ref.edge_nodes,
                               ref.node_weights, ref.edge_weights, V)
    return ref, hg, member


def _assert_cover_equal(got, want):
    np.testing.assert_array_equal(got.spans, want.spans)
    np.testing.assert_array_equal(got.cover_ptr, want.cover_ptr)
    np.testing.assert_array_equal(got.cover_parts, want.cover_parts)
    np.testing.assert_array_equal(got.pin_parts, want.pin_parts)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("max_q", [64, 128, 192])   # W = 1, up to 2, up to 3
def test_batched_cover_matches_reference(variant, max_q):
    ref, hg, member = _instance(seed=max_q, max_q=max_q)
    want = ref_cover(ref.edge_ptr, ref.edge_nodes, member,
                     with_pin_parts=True)
    flags.set_variant(variant)
    got = batched_cover_csr(hg.edge_ptr, hg.edge_nodes, member,
                            with_pin_parts=True, device="cpu")
    _assert_cover_equal(got, want)
    e = int(np.argmax(want.spans))
    chosen, accessed = cover_for_query(hg.edge(e), member)
    assert chosen == list(got.chosen(e))
    assert chosen == greedy_set_cover(hg.edge(e), member)


@pytest.mark.parametrize("variant", VARIANTS)
def test_lowest_id_ties(variant):
    # partitions 0..3 store identical item sets: covers must use the
    # lowest id of each tied group
    V = 80
    member = np.zeros((6, V), dtype=bool)
    member[[0, 1, 2, 3], :40] = True
    member[[4, 5], 40:] = True
    edges = [range(0, 80), range(30, 50), [5], range(40, 80)]
    ref = RefHypergraph.from_edges(edges, num_nodes=V)
    hg = from_reference_arrays(ref.edge_ptr, ref.edge_nodes, None, None, V)
    want = ref_cover(ref.edge_ptr, ref.edge_nodes, member,
                     with_pin_parts=True)
    flags.set_variant(variant)
    got = batched_cover_csr(hg.edge_ptr, hg.edge_nodes, member,
                            with_pin_parts=True, device="cpu")
    _assert_cover_equal(got, want)
    assert set(got.cover_parts.tolist()) == {0, 4}


def test_device_bucket_counters():
    ref, hg, member = _instance(seed=1, max_q=64)
    flags.set_variant("spanrounddevice")
    before = engine_counters()
    got = batched_cover_csr(hg.edge_ptr, hg.edge_nodes, member, device="cpu")
    after = engine_counters()
    assert after["device_buckets"] - before["device_buckets"] == 1
    assert (after["device_rounds"] - before["device_rounds"]
            == int(got.spans.max()))
    assert after["host_buckets"] == before["host_buckets"]


@pytest.mark.parametrize("variant", ["", "spandevice+spanrounddevice"])
def test_maintainer_refresh_matches_reference(variant):
    ref, hg, member = _instance(seed=7, max_q=100)
    rng = np.random.default_rng(70)
    ref_pl = RefPlacement(member.copy(), 1e9, np.ones(hg.num_nodes))
    pl = Placement.from_member(member, 1e9)
    want_sm = RefMaintainer(ref, ref_pl, with_covers=True)
    flags.set_variant(variant)
    sm = SpanMaintainer(hg, pl, with_covers=True, device="cpu")
    for step in range(6):
        p = int(rng.integers(0, member.shape[0]))
        items = rng.choice(hg.num_nodes, size=12, replace=False)
        ref_pl.member[p, items] = True
        pl.member[p, items] = True
        edges = rng.choice(hg.num_edges, size=15, replace=False)
        want_sm.refresh_edges(edges)
        sm.refresh_edges(edges)
        np.testing.assert_array_equal(sm.pin_parts, want_sm.pin_parts)
        np.testing.assert_array_equal(sm.spans(), want_sm.spans())
        for e in edges:
            np.testing.assert_array_equal(sm.chosen(int(e)),
                                          want_sm.chosen(int(e)))
            got_cov, want_cov = sm.cover(int(e)), want_sm.cover(int(e))
            assert list(got_cov) == list(want_cov)
            for k in want_cov:
                np.testing.assert_array_equal(got_cov[k], want_cov[k])


def test_from_member_copies_and_validates():
    member = np.ones((2, 3), dtype=bool)
    pl = Placement.from_member(member, np.array([6.0, 6.0]), [1, 2, 3])
    assert pl.capacity == 6.0 and isinstance(pl.capacity, float)
    pl.member[0, 0] = False
    assert member[0, 0]
    pl.validate()
    pl.member[:, 2] = False  # item 2 now stored nowhere
    with pytest.raises(ValueError):
        pl.validate()
    with pytest.raises(ValueError):
        Placement.from_member(member, 5.0, [1, 2])

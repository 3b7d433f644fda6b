"""The port's cluster-scale pipeline (``repro_torch.scale``, the web-scale
generators and ``PlacementService.fit_sharded``) against the JAX
package's on the same seeded inputs: streamed CSRs, components, sharding
plans, merged members, pipeline stats (apart from the seconds) and plan
JSON are equal, and a fit on spawned worker processes equals the serial
fit.  Exact everywhere: every quantity is an integer or comes from the
same numpy float ops.  The port runs at ``device="cpu"``."""

import inspect

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.scale as ref_scale
from repro import flags as ref_flags
from repro.scale import sharder as ref_sharder
from repro.scale import stream as ref_stream
from repro_torch import core, flags, scale
from repro_torch.core import (NodeProfile, PlacementService,
                              from_reference_arrays)
from repro_torch.scale import (StreamingHypergraphBuilder,
                               connected_components, fit_sharded_placement,
                               shard_workload)
from repro_torch.scale import sharder, stream

SECONDS = {"shard_seconds", "fit_seconds", "merge_seconds", "repair_seconds"}


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


def _same_graph(got, want):
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def _queries(rng, num_items, n):
    return [rng.integers(0, num_items, size=int(rng.integers(1, 9)))
            for _ in range(n)]


# -------------------------------------------------------------- generators
@pytest.mark.parametrize("kw", [
    dict(num_items=500, num_queries=2000, num_clusters=16, seed=0,
         chunk=512),
    dict(num_items=2500, num_queries=10_000, num_clusters=48,
         cross_frac=0.05, seed=0),
    dict(num_items=37, num_queries=301, num_clusters=64, min_query=1,
         max_query=3, skew=0.5, seed=9, chunk=100),
])
def test_web_scale_chunks_match_reference(kw):
    got = list(core.web_scale_chunks(**kw))
    want = list(ref_core.web_scale_chunks(**kw))
    assert len(got) == len(want)
    for (p, n), (rp, rn) in zip(got, want):
        assert p.dtype == rp.dtype and p.tobytes() == rp.tobytes()
        assert n.dtype == rn.dtype and n.tobytes() == rn.tobytes()
    wl = core.web_scale_workload(**kw)
    ref_wl = ref_core.web_scale_workload(**kw)
    _same_graph(wl.hypergraph, ref_wl.hypergraph)
    assert wl.name == ref_wl.name


def test_web_scale_defaults_match_reference():
    assert core.WEB_SCALE_DEFAULTS == ref_core.WEB_SCALE_DEFAULTS
    assert inspect.signature(core.web_scale_chunks).parameters.keys() == \
        inspect.signature(ref_core.web_scale_chunks).parameters.keys()


# ------------------------------------------------------------------ stream
@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("seed,num_items", [(1, 80), (3, 12), (6, 5)])
def test_streaming_builder_matches_reference(merge, seed, num_items):
    """Uneven chunks of raw queries (duplicate pins, empty queries,
    weights) through both builders; a small universe makes many duplicate
    edges.  Without merging both equal ``Hypergraph.from_edges``."""
    rng = np.random.default_rng(seed)
    qs = _queries(rng, num_items, 700) + [np.zeros(0, dtype=np.int64)]
    weights = rng.uniform(0.5, 3.0, size=len(qs))
    got = StreamingHypergraphBuilder(num_items, merge_duplicates=merge)
    want = ref_stream.StreamingHypergraphBuilder(num_items,
                                                 merge_duplicates=merge)
    for lo in range(0, len(qs), 123):
        for b in (got, want):
            b.add_queries(qs[lo: lo + 123], weights[lo: lo + 123])
        _same_graph(got.build(), want.build())
    assert len(got) == len(want) and got.num_chunks == want.num_chunks
    if not merge:
        _same_graph(got.build(), core.Hypergraph.from_edges(
            qs, num_nodes=num_items, edge_weights=weights))
    else:
        assert got.build().num_edges < len(qs)


def test_streaming_builder_csr_chunks_match_reference():
    """Raw CSR chunks straight off the generator, with node weights,
    rebuilt after more chunks arrive."""
    nw = np.random.default_rng(2).uniform(1, 4, size=500)
    got = StreamingHypergraphBuilder(500, node_weights=nw,
                                     merge_duplicates=True)
    want = ref_stream.StreamingHypergraphBuilder(500, node_weights=nw,
                                                 merge_duplicates=True)
    for ptr, pins in core.web_scale_chunks(500, 4000, 16, seed=3,
                                           chunk=700):
        got.add_csr(ptr, pins)
        want.add_csr(ptr, pins)
        _same_graph(got.build(), want.build())


def test_edge_hashes_and_collision_regroup_match_reference():
    rng = np.random.default_rng(4)
    qs = [np.unique(q) for q in _queries(rng, 30, 400)]
    ptr = np.zeros(len(qs) + 1, dtype=np.int64)
    ptr[1:] = np.cumsum([len(q) for q in qs])
    nodes = np.concatenate(qs)
    assert stream._mix64(nodes.astype(np.uint64)).tobytes() == \
        ref_stream._mix64(nodes.astype(np.uint64)).tobytes()
    assert stream._edge_hashes(ptr, nodes).tobytes() == \
        ref_stream._edge_hashes(ptr, nodes).tobytes()
    # force every edge into one hash group: the exact regroup must find
    # the same duplicate map as the reference
    maps = []
    for mod in (stream, ref_stream):
        b = mod.StreamingHypergraphBuilder(30, merge_duplicates=True)
        b.add_csr(ptr, nodes)
        b._hashes._arr[: len(qs)] = 7
        maps.append(b._dedup_map(*b._csr()))
        _same_graph(b.build(), b.build())
    assert maps[0].tobytes() == maps[1].tobytes()


def test_streaming_builder_errors_match_reference():
    for bad in ([[0, 10]], [[0, -1]]):
        msgs = []
        for mod in (stream, ref_stream):
            with pytest.raises(ValueError) as info:
                mod.StreamingHypergraphBuilder(10).add_queries(bad)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]
    for mod in (stream, ref_stream):
        with pytest.raises(ValueError, match="edge_weights length"):
            mod.StreamingHypergraphBuilder(10).add_queries(
                [[0, 1]], edge_weights=[1.0, 2.0])


# ----------------------------------------------------------------- sharder
@pytest.mark.parametrize("seed", [4, 5, 6])
def test_connected_components_match_reference(seed):
    rng = np.random.default_rng(seed)
    qs = _queries(rng, 60, 25) + [[]]
    hg = ref_core.Hypergraph.from_edges(qs, num_nodes=60)
    got = connected_components(_port(hg))
    assert got.tobytes() == ref_sharder.connected_components(hg).tobytes()
    assert got.tobytes() == connected_components(
        core.Hypergraph.from_edges(qs, num_nodes=60)).tobytes()


def _same_sharding(got, want):
    for name in ("item_shard", "part_offset", "boundary_edges",
                 "boundary_lambda"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()
    assert got.boundary_cost == want.boundary_cost
    assert got.num_components == want.num_components
    assert got.summary() == want.summary()
    for a, b in zip(got.shards, want.shards, strict=True):
        assert a.items.tobytes() == b.items.tobytes()
        _same_graph(a.sub_hg, b.sub_hg)
        assert a.num_partitions == b.num_partitions
        assert a.weight == b.weight
        assert np.asarray(a.capacity).tobytes() == \
            np.asarray(b.capacity).tobytes()
        assert type(a.capacity) is type(b.capacity)


@pytest.mark.parametrize("case", [
    ("random", dict(num_items=300, num_queries=1000, density=5, seed=5),
     12, 60, 4),
    ("web", dict(num_items=800, num_queries=4000, num_clusters=16,
                 cross_frac=0.05, seed=7), 16, 110, 4),
    ("web", dict(num_items=600, num_queries=3000, num_clusters=8,
                 cross_frac=0.2, seed=11), 8, 84, 3),
    ("web-het", dict(num_items=800, num_queries=4000, num_clusters=16,
                     cross_frac=0.05, seed=7), 16, None, 4),
], ids=["random", "web-mid-like", "near-full", "heterogeneous"])
def test_shard_workload_matches_reference(case):
    kind, kw, n, cap, shards = case
    make = (ref_core.random_workload if kind == "random"
            else ref_core.web_scale_workload)
    hg = make(**kw).hypergraph
    if cap is None:
        cap = np.linspace(60.0, 160.0, n)
    got = shard_workload(_port(hg), n, cap, shards, seed=3)
    want = ref_sharder.shard_workload(hg, n, cap, shards, seed=3)
    _same_sharding(got, want)
    assert np.diff(got.part_offset).sum() == n


def test_het_partition_budget_matches_reference():
    rng = np.random.default_rng(8)
    for _ in range(20):
        n = int(rng.integers(4, 20))
        s = int(rng.integers(1, min(n, 6) + 1))
        caps = rng.uniform(10, 100, size=n)
        w = rng.uniform(1, 60, size=s)
        out = []
        for mod in (sharder, ref_sharder):
            try:
                out.append(mod._het_partition_budget(caps, n, w,
                                                     float(w.sum())).tolist())
            except ValueError as exc:
                out.append(str(exc))
        assert out[0] == out[1]


def test_shard_workload_errors_match_reference():
    hg = ref_core.random_workload(num_items=100, num_queries=200, density=5,
                                  seed=0).hypergraph
    for args in ((2, 10, 2), (4, 30, 0), (3, np.array([10.0, 20.0]), 2)):
        msgs = []
        for mod, g in ((sharder, _port(hg)), (ref_sharder, hg)):
            with pytest.raises(ValueError) as info:
                mod.shard_workload(g, *args)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


# ------------------------------------------------------------ parallel fit
@pytest.fixture(scope="module")
def clustered():
    hg = ref_core.web_scale_workload(num_items=800, num_queries=4000,
                                     num_clusters=16, cross_frac=0.05,
                                     seed=7).hypergraph
    return hg, _port(hg)


def _stats(stats):
    return {k: v for k, v in stats.items() if k not in SECONDS}


@pytest.fixture(scope="module")
def serial_fits(clustered):
    """The serial sharded lmbr fit of the clustered workload on 16 x 110,
    by both packages."""
    hg, phg = clustered
    kw = dict(num_shards=4, workers=1, seed=0, max_moves=40)
    return (fit_sharded_placement(phg, 16, 110, device="cpu", **kw),
            ref_scale.fit_sharded_placement(hg, 16, 110, **kw))


def test_fit_sharded_matches_reference(serial_fits):
    got, want = serial_fits
    assert got.member.tobytes() == want.member.tobytes()
    assert _stats(got.stats) == _stats(want.stats)
    assert set(got.stats) == set(want.stats)
    assert got.stats["used_pool"] is False
    assert got.stats["repair_moves"] > 0 and got.stats["shard_moves"] > 0
    _same_sharding(got.sharding, want.sharding)
    got.placement.validate()


@pytest.mark.parametrize("algo,kw", [
    ("hpa", dict(num_shards=3, boundary_repair=20)),
    ("lmbr", dict(num_shards=4, boundary_repair=0, max_moves=20)),
    ("random", dict(num_shards=None)),
])
def test_fit_sharded_algorithms_match_reference(clustered, algo, kw):
    hg, phg = clustered
    cap = np.linspace(90.0, 130.0, 16)
    got = fit_sharded_placement(phg, 16, cap, algorithm=algo, seed=1,
                                workers=1, device="cpu", **kw)
    want = ref_scale.fit_sharded_placement(hg, 16, cap, algorithm=algo,
                                           seed=1, workers=1, **kw)
    assert got.member.tobytes() == want.member.tobytes()
    assert _stats(got.stats) == _stats(want.stats)


def test_pooled_fit_equals_serial(clustered, serial_fits):
    """Two spawned worker processes give the serial fit's member and
    stats; the pool really ran."""
    _, phg = clustered
    pooled = fit_sharded_placement(phg, 16, 110, num_shards=4, workers=2,
                                   seed=0, max_moves=40, device="cpu")
    serial = serial_fits[0]
    assert pooled.stats["used_pool"] is True
    assert pooled.member.tobytes() == serial.member.tobytes()
    a, b = _stats(pooled.stats), _stats(serial.stats)
    assert (a.pop("workers"), a.pop("used_pool")) == (2, True)
    assert (b.pop("workers"), b.pop("used_pool")) == (1, False)
    assert a == b


def test_boundary_repair_near_full_matches_reference():
    """Adversarial near-full layout: the repair has cross-shard pressure
    and almost nowhere to copy; no row may go over capacity."""
    hg = ref_core.web_scale_workload(num_items=600, num_queries=3000,
                                     num_clusters=8, cross_frac=0.2,
                                     seed=11).hypergraph
    for repair in (200, 0):
        kw = dict(num_shards=4, workers=1, seed=0, max_moves=40,
                  boundary_repair=repair)
        got = fit_sharded_placement(_port(hg), 8, 84, device="cpu", **kw)
        want = ref_scale.fit_sharded_placement(hg, 8, 84, **kw)
        assert got.member.tobytes() == want.member.tobytes()
        assert _stats(got.stats) == _stats(want.stats)
        got.placement.validate()
        assert (got.placement.partition_weights() <= 84 + 1e-9).all()
    assert got.stats["repair_moves"] == 0


def test_fit_sharded_unknown_algorithm_raises():
    hg = core.Hypergraph.from_edges([[0, 1]], num_nodes=2)
    with pytest.raises(KeyError, match="unknown algorithm"):
        fit_sharded_placement(hg, 2, 4, algorithm="nope", device="cpu")


# ------------------------------------------------------------------ service
def test_service_fit_sharded_matches_reference(clustered):
    """Through the service: a built Hypergraph and a query list, with a
    heterogeneous profile and the durability pass; the plan's JSON, name
    and stats equal the reference's."""
    hg, phg = clustered
    rng = np.random.default_rng(0)
    cols = dict(capacity=np.linspace(120.0, 170.0, 16),
                fail_prob=rng.uniform(0.01, 0.1, 16), power_idle=100.0,
                power_active=300.0, access_cost=rng.uniform(0, 1, 16))
    kw = dict(num_shards=4, workers=1, max_moves=40, durability_eps=0.02)
    got = PlacementService("lmbr", seed=0, device="cpu").fit_sharded(
        phg, 16, profile=NodeProfile(**cols), **kw)
    want = ref_core.PlacementService("lmbr", seed=0).fit_sharded(
        hg, 16, profile=ref_core.NodeProfile(**cols), **kw)
    assert got.to_json() == want.to_json()
    assert got.algorithm == "lmbr+sharded"
    assert _stats(got.stats) == _stats(want.stats)
    assert got.stats["durability_copies"] > 0
    queries = [hg.edge(e) for e in range(1500)]
    got = PlacementService("lmbr", seed=2, device="cpu").fit_sharded(
        queries, 16, 110, num_items=800, num_shards=2, workers=1,
        boundary_repair=30, max_moves=30)
    want = ref_core.PlacementService("lmbr", seed=2).fit_sharded(
        queries, 16, 110, num_items=800, num_shards=2, workers=1,
        boundary_repair=30, max_moves=30)
    assert got.to_json() == want.to_json()
    assert _stats(got.stats) == _stats(want.stats)
    spans = got.spans(queries)
    assert spans.tolist() == want.spans(queries).tolist()


def test_service_fit_sharded_flags_and_errors_match_reference(clustered):
    hg, phg = clustered
    variant = "shards4+scalew1+brepair64"
    flags.set_variant(variant)
    ref_flags.set_variant(variant)
    got = PlacementService("hpa", device="cpu").fit_sharded(phg, 16, 110)
    want = ref_core.PlacementService("hpa").fit_sharded(hg, 16, 110)
    assert got.to_json() == want.to_json()
    assert got.stats["shards"] == 4
    msgs = []
    for svc, g in ((PlacementService("hpa", device="cpu"), phg),
                   (ref_core.PlacementService("hpa"), hg)):
        row = []
        for kw in (dict(num_partitions=16),
                   dict(num_partitions=16, capacity=110,
                        node_weights=np.ones(800))):
            with pytest.raises(ValueError) as info:
                svc.fit_sharded(g, **kw)
            row.append(str(info.value))
        msgs.append(row)
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------------- flags
@pytest.mark.parametrize("variant", ["shards16+scalew4+brepair128",
                                     "shards0+scalew1+brepair0",
                                     "baseline"])
def test_scale_flag_variants_match_reference(variant):
    flags.set_variant(variant)
    ref_flags.set_variant(variant)
    for key in ("scale_shards", "scale_workers", "scale_boundary_repair"):
        assert flags.FLAGS[key] == ref_flags.FLAGS[key], key


@pytest.mark.parametrize("bad", ["scalew0", "brepair-1", "shards-2"])
def test_scale_flag_validation_matches_reference(bad):
    msgs = []
    for f in (flags, ref_flags):
        with pytest.raises(ValueError) as info:
            f.set_variant(bad)
        msgs.append(str(info.value))
        f.reset()
    assert msgs[0] == msgs[1]


# ------------------------------------------------------- devices, names
def test_scale_entry_points_raise_without_cuda(clustered, monkeypatch):
    _, phg = clustered
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_sharded_placement(phg, 16, 110, num_shards=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PlacementService("lmbr").fit_sharded(phg, 16, 110)


def test_port_scale_modules_match_the_reference():
    """The submodules' names and the entry points' signatures (the port's
    adds ``device``); the package's names are pinned in
    ``tests/test_torch_placement_service.py``."""
    for sub in ("stream", "sharder", "parallel_fit"):
        assert getattr(scale, sub).__all__ == getattr(ref_scale, sub).__all__
    got = inspect.signature(fit_sharded_placement).parameters
    want = inspect.signature(ref_scale.fit_sharded_placement).parameters
    assert [n for n in got if n != "device"] == list(want)
    assert list(inspect.signature(PlacementService.fit_sharded).parameters) \
        == list(inspect.signature(
            ref_core.PlacementService.fit_sharded).parameters)

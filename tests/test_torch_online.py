"""The port's online serving (``repro_torch.online`` and
``Simulator.run_online``) against the JAX package's on the same seeded
inputs, bit for bit: the router's covers, pin attribution and ledger in
both tie-break modes, the sketch, the drift detector, failover repair
(batched and per-item oracle), and ``run_online`` summaries, spans and
final layouts under failures, drift, long outages and a fault storm.
Everything runs at ``device="cpu"``; the entry points that reach the span
engine raise without CUDA."""

import inspect

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.online as ref_online
from repro import flags as ref_flags
from repro.core.setcover import Placement as RefPlacement
from repro_torch import flags, online
from repro_torch.core import (ALGORITHMS, Hypergraph, Placement,
                              PlacementPlan, PlacementService, Simulator,
                              cover_for_query, from_reference_arrays)
from repro_torch.online import (DriftDetector, FailoverManager,
                                ReplicaRouter, WorkloadSketch)

N, CAP = 10, 32


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _port_hg(hg):
    return from_reference_arrays(hg.edge_ptr, hg.edge_nodes, hg.node_weights,
                                 hg.edge_weights, hg.num_nodes)


@pytest.fixture(scope="module")
def fitted():
    """``random_workload(150, 400, density=6, seed=3)`` and its lmbr
    layout on 10 x 32, fitted by both packages (the same matrix)."""
    hg = ref_core.random_workload(num_items=150, num_queries=400, density=6,
                                  seed=3).hypergraph
    ref_pl = ref_core.ALGORITHMS["lmbr"](hg, N, CAP, seed=0, max_moves=40)
    phg = _port_hg(hg)
    pl = ALGORITHMS["lmbr"](phg, N, CAP, seed=0, max_moves=40, device="cpu")
    assert pl.member.tobytes() == ref_pl.member.tobytes()
    return hg, phg, pl.member


class _RecordingFailover(ref_online.FailoverManager):
    """The reference's manager, remembering itself: its ``pl`` is the
    final live layout of a reference ``run_online``."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _RecordingFailover.made.append(self)


def _ref_run_online(monkeypatch, sim, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(ref_online, "FailoverManager", _RecordingFailover)
        res = sim.run_online(*args, **kw)
    return res, _RecordingFailover.made[-1].pl.member


def _same_result(got, want, want_member):
    a, b = got.summary(), want.summary()
    a.pop("placement_s")
    b.pop("placement_s")
    assert a == b
    assert got.spans.tobytes() == want.spans.tobytes()
    assert got.access_load.tobytes() == want.access_load.tobytes()
    assert got.loads.tobytes() == want.loads.tobytes()
    assert got.member.tobytes() == want_member.tobytes()
    assert got.energy_joules == want.energy_joules
    assert got.shipped_gb == want.shipped_gb


# ------------------------------------------------------------------- router
def _batch_bytes(b):
    return [x.tobytes() for x in (b.spans, b.cover_ptr, b.cover_parts,
                                  b.pin_parts, b.edge_ptr, b.edge_nodes)]


@pytest.mark.parametrize("balance", [False, True], ids=["default",
                                                        "balanced"])
@pytest.mark.parametrize("microbatch", [64, 384])
def test_router_matches_reference(fitted, balance, microbatch):
    hg, _, member = fitted
    want = ref_online.ReplicaRouter(member.copy(), microbatch=microbatch,
                                    balance=balance)
    got = ReplicaRouter(member.copy(), microbatch=microbatch,
                        balance=balance, device="cpu")
    for lo, hi in ((0, 150), (150, 400)):   # the ledger carries over
        ptr = hg.edge_ptr[lo: hi + 1] - hg.edge_ptr[lo]
        nodes = hg.edge_nodes[hg.edge_ptr[lo]: hg.edge_ptr[hi]]
        wb, gb = want.route_csr(ptr, nodes), got.route_csr(ptr, nodes)
        assert _batch_bytes(gb) == _batch_bytes(wb)
        assert got.load.tobytes() == want.load.tobytes()
    assert got.stats == want.stats
    assert got.load_imbalance() == want.load_imbalance()
    assert got.stats["microbatches"] == (-(-150 // microbatch)
                                         - (-250 // microbatch))


def test_router_default_equals_cover_for_query(fitted):
    _, phg, member = fitted
    router = ReplicaRouter(member, microbatch=64, device="cpu")
    batch = router.route_csr(phg.edge_ptr, phg.edge_nodes)
    for e in range(phg.num_edges):
        chosen, accessed = cover_for_query(phg.edge(e), member)
        assert batch.chosen(e).tolist() == chosen
        cov = batch.cover(e)
        assert list(cov) == chosen
        for p, items in zip(chosen, accessed):
            assert cov[p].tolist() == items.tolist()
    assert np.array_equal(
        router.load, np.bincount(batch.cover_parts, minlength=N))


@pytest.mark.parametrize("balance", [False, True])
def test_route_one_and_route_match_reference(fitted, balance):
    hg, _, member = fitted
    want = ref_online.ReplicaRouter(member, balance=balance)
    got = ReplicaRouter(member, balance=balance, device="cpu")
    for e in range(0, hg.num_edges, 37):
        a, b = got.route_one(hg.edge(e)), want.route_one(hg.edge(e))
        assert a[0].tolist() == b[0].tolist()
        assert [(p, v.tolist()) for p, v in a[1].items()] == [
            (p, v.tolist()) for p, v in b[1].items()]
    queries = [hg.edge(e) for e in range(0, hg.num_edges, 3)]
    assert _batch_bytes(got.route(queries)) == _batch_bytes(
        want.route(queries))
    assert got.load.tobytes() == want.load.tobytes()
    empty_g, empty_w = got.route([]), want.route([])
    assert _batch_bytes(empty_g) == _batch_bytes(empty_w)


@pytest.mark.parametrize("eps", ["0", "0.5", "3"])
def test_router_ledger_epsilon_matches_reference(fitted, eps):
    hg, _, member = fitted
    queries = [hg.edge(e) for e in range(hg.num_edges)]
    variant = f"routerbal1+routereps{eps}+routermb32"
    ref_flags.set_variant(variant)
    flags.set_variant(variant)
    want = ref_online.ReplicaRouter(member)
    got = ReplicaRouter(member, device="cpu")
    assert _batch_bytes(got.route(queries)) == _batch_bytes(
        want.route(queries))
    assert got.stats == want.stats
    if eps != "0":
        assert got.stats["ledger_sorts"] < got.stats["microbatches"]


@pytest.mark.parametrize("cost_aware", [0, 1])
def test_router_cost_aware_matches_reference(fitted, cost_aware):
    hg, _, member = fitted
    rng = np.random.default_rng(1)
    cost = rng.uniform(0.5, 2.0, N)
    variant = f"routerbal1+routercost{cost_aware}+routermb48"
    ref_flags.set_variant(variant)
    flags.set_variant(variant)
    want = ref_online.ReplicaRouter(member, node_cost=cost)
    got = ReplicaRouter(member, node_cost=cost, device="cpu")
    assert _batch_bytes(got.route_csr(hg.edge_ptr, hg.edge_nodes)) == \
        _batch_bytes(want.route_csr(hg.edge_ptr, hg.edge_nodes))
    assert got.stats == want.stats
    for bad in (np.ones(N + 1), np.zeros(N)):
        with pytest.raises(ValueError):
            got.set_node_cost(bad)


def test_router_swap_plan_and_as_placement(fitted):
    hg, _, member = fitted
    want = ref_online.ReplicaRouter(member.copy(), microbatch=50)
    got = ReplicaRouter(member.copy(), microbatch=50, device="cpu")
    other = np.ones_like(member)
    for r in (want, got):
        r.route_csr(hg.edge_ptr[:101], hg.edge_nodes[:hg.edge_ptr[100]])
        r.swap_plan(other)
        assert r.member is other
        r.route_csr(hg.edge_ptr, hg.edge_nodes)
        with pytest.raises(ValueError):
            r.swap_plan(np.ones((N + 1, member.shape[1]), dtype=bool))
        with pytest.raises(TypeError):
            r.swap_plan(np.ones((N, member.shape[1])))
    assert got.load.tobytes() == want.load.tobytes()
    assert got.stats == want.stats == dict(
        served_queries=500, microbatches=10, plan_swaps=1, ledger_sorts=0)
    pl = got.as_placement(CAP, np.ones(member.shape[1]))
    assert pl.member is other and isinstance(pl, Placement)


def test_router_obs_counters_match_reference(fitted):
    from repro import obs as ref_obs
    from repro_torch import obs

    hg, _, member = fitted
    for f in (flags, ref_flags):
        f.set_variant("obstrace+routerbal1+routermb100")
    obs.reset()
    ref_obs.reset()
    got = ReplicaRouter(member.copy(), device="cpu")
    want = ref_online.ReplicaRouter(member.copy())
    for r in (got, want):
        r.route_csr(hg.edge_ptr, hg.edge_nodes)
        r.swap_plan(np.ones_like(member))
    a, b = obs.registry().snapshot(), ref_obs.registry().snapshot()
    timed = {k for k in b if "seconds" in k}
    assert set(a) == set(b)
    assert {k: v for k, v in a.items() if k not in timed} == {
        k: v for k, v in b.items() if k not in timed}
    assert len(obs.tracer().spans("serve.microbatch")) == 4
    obs.reset()
    ref_obs.reset()


# ------------------------------------------------------------------- sketch
@pytest.mark.parametrize("decay", [1.0, 0.5])
@pytest.mark.parametrize("seen", [0, 30, 120])
def test_sketch_matches_reference(fitted, decay, seen):
    hg, _, _ = fitted
    want = ref_online.WorkloadSketch(hg.num_nodes, window=50, decay=decay)
    got = WorkloadSketch(hg.num_nodes, window=50, decay=decay)
    queries = [hg.edge(e) for e in range(seen)]
    want.observe_batch(queries)
    got.observe_batch(queries)
    assert (len(got), got.full, got.total_observed) == (
        len(want), want.full, want.total_observed)
    assert got.edge_weights().tobytes() == want.edge_weights().tobytes()
    a, b = got.to_hypergraph(), want.to_hypergraph()
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes()
    assert a.num_nodes == hg.num_nodes
    if decay == 1.0 and seen:
        direct = Hypergraph.from_edges(queries[-50:], num_nodes=hg.num_nodes)
        assert a.edge_nodes.tobytes() == direct.edge_nodes.tobytes()


def test_sketch_window_from_flag():
    flags.set_variant("driftw77+driftth1.5")
    ref_flags.set_variant("driftw77+driftth1.5")
    assert WorkloadSketch(10).window == ref_online.WorkloadSketch(10).window \
        == 77


# -------------------------------------------------------------------- drift
def _drift_pair():
    old = ref_core.random_workload(num_items=120, num_queries=300, density=6,
                                   seed=2)
    new = ref_core.random_workload(num_items=120, num_queries=300, density=6,
                                   seed=9)
    ref_plan = ref_core.PlacementService("hpa", seed=0).fit(
        old.queries, 120, 10, 30)
    plan = PlacementService("hpa", seed=0, device="cpu").fit(
        old.queries, 120, 10, 30)
    assert plan.to_json() == ref_plan.to_json()
    return old, new, ref_plan, plan


@pytest.mark.parametrize("baseline", ["seeded", "first-window"])
def test_drift_detector_matches_reference(baseline):
    old, new, ref_plan, plan = _drift_pair()
    want = ref_online.DriftDetector(
        ref_plan, ref_core.PlacementService("lmbr", seed=0), window=100,
        threshold=1.05, refit_moves=128)
    got = DriftDetector(plan, PlacementService("lmbr", seed=0, device="cpu"),
                        window=100, threshold=1.05, refit_moves=128)
    if baseline == "seeded":
        assert got.seed_baseline_from(old.queries) == \
            want.seed_baseline_from(old.queries)
    fired = []
    for qs in (old.queries[:100], new.queries[:100], new.queries[100:200]):
        for det, p in ((want, ref_plan), (got, plan)):
            det.observe(qs, p.spans(qs))
        assert got.windowed_avg_span == want.windowed_avg_span
        assert got.baseline == want.baseline
        f = got.should_refit()
        assert f == want.should_refit()
        fired.append(f)
        if f:
            a, b = got.refit(), want.refit()
            assert a.to_json() == b.to_json() and a.stats == b.stats
            assert got.plan is a and (a.member >= plan.member).all()
            assert got.baseline == want.baseline
    assert got.stats == want.stats
    assert any(fired) and got.stats["refits"] >= 1


def test_drift_detector_refit_with_dest_mask():
    old, new, ref_plan, plan = _drift_pair()
    want = ref_online.DriftDetector(
        ref_plan, ref_core.PlacementService("lmbr", seed=0), window=100,
        refit_moves=64)
    got = DriftDetector(plan, PlacementService("lmbr", seed=0, device="cpu"),
                        window=100, refit_moves=64)
    mask = np.ones(10, dtype=bool)
    mask[[2, 6]] = False
    want.observe(new.queries[:100], ref_plan.spans(new.queries[:100]))
    got.observe(new.queries[:100], plan.spans(new.queries[:100]))
    a, b = got.refit(dest_mask=mask), want.refit(dest_mask=mask)
    assert a.to_json() == b.to_json()
    assert not (a.member & ~plan.member)[[2, 6]].any()
    assert got.windowed_avg_span == 0.0 and got.baseline == want.baseline


def test_drift_detector_default_service_runs_on_the_plans_device():
    _, _, _, plan = _drift_pair()
    det = DriftDetector(plan, window=10)
    assert det.service.algorithm == "lmbr"
    assert det.service.device == torch.device("cpu")
    assert det.threshold == 1.25


# ----------------------------------------------------------------- failover
KILLS = [[p] for p in range(N)] + [[0, 1], [3, 7], [2, 5, 8]]


def _both_down(member, node_weights, kills, capacity=CAP):
    ref_live = RefPlacement(member.copy(), capacity, node_weights)
    live = Placement(member.copy(), capacity, node_weights)
    fo_r, fo = ref_online.FailoverManager(ref_live), FailoverManager(live)
    for p in kills:
        assert fo.partition_down(p).tolist() == fo_r.partition_down(
            p).tolist()
    return ref_live, live, fo_r, fo


@pytest.mark.parametrize("kills", KILLS, ids=["-".join(map(str, k))
                                              for k in KILLS])
def test_repair_matches_reference(fitted, kills):
    hg, phg, member = fitted
    ref_live, live, fo_r, fo = _both_down(member, phg.node_weights, kills)
    assert fo.uncovered_items().tolist() == fo_r.uncovered_items().tolist()
    lost, affected = fo.coverage_audit(phg)
    lost_r, affected_r = fo_r.coverage_audit(hg)
    assert lost.tolist() == lost_r.tolist()
    assert affected.tolist() == affected_r.tolist()
    got = fo.repair(phg, k=1)
    want = fo_r.repair(hg, k=1)
    assert got.tolist() == want.tolist()
    assert live.member.tobytes() == ref_live.member.tobytes()
    assert fo.stats == fo_r.stats
    assert len(fo.uncovered_items()) == 0
    live.validate()
    # the per-item oracle lands on the same layout
    _, oracle, _, fo_o = _both_down(member, phg.node_weights, kills)
    assert fo_o.repair_reference(phg, k=1).tolist() == got.tolist()
    assert oracle.member.tobytes() == live.member.tobytes()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cap_factor", [1, 4])
def test_repair_k_matches_reference(fitted, k, cap_factor):
    hg, phg, member = fitted
    ref_live, live, fo_r, fo = _both_down(member, phg.node_weights, [0, 4],
                                          CAP * cap_factor)
    got, want = fo.repair(phg, k=k), fo_r.repair(hg, k=k)
    assert got.tolist() == want.tolist()
    assert live.member.tobytes() == ref_live.member.tobytes()
    assert fo.stats == fo_r.stats
    assert fo.replica_counts().tolist() == fo_r.replica_counts().tolist()
    _, oracle, _, fo_o = _both_down(member, phg.node_weights, [0, 4],
                                    CAP * cap_factor)
    assert fo_o.repair_reference(phg, k=k).tolist() == got.tolist()
    assert oracle.member.tobytes() == live.member.tobytes()
    if cap_factor == 4:
        counts = live.member.sum(axis=0)
        assert (counts[phg.node_weights > 0] >= k).all()


def test_repair_with_profile_and_items_matches_reference(fitted):
    hg, phg, member = fitted
    rng = np.random.default_rng(5)
    cols = dict(capacity=np.full(N, float(CAP)),
                fail_prob=rng.uniform(0.01, 0.1, N), power_idle=100.0,
                power_active=300.0, access_cost=rng.uniform(0, 1, N))
    from repro_torch.core import NodeProfile

    ref_live = RefPlacement(member.copy(), CAP * 2, phg.node_weights)
    live = Placement(member.copy(), CAP * 2, phg.node_weights)
    fo_r = ref_online.FailoverManager(ref_live,
                                      profile=ref_core.NodeProfile(**cols))
    fo = FailoverManager(live, profile=NodeProfile(**cols))
    items = np.arange(0, 150, 7)
    for f, g in ((fo, phg), (fo_r, hg)):
        f.partition_down(3)
        f.repair(g, k=2, items=items)
    assert live.member.tobytes() == ref_live.member.tobytes()
    assert fo.stats == fo_r.stats
    with pytest.raises(ValueError, match="partitions"):
        FailoverManager(live, profile=NodeProfile(
            **{k: (v[:4] if isinstance(v, np.ndarray) else v)
               for k, v in cols.items()}))


def test_repair_tight_capacity_matches_reference():
    edges = [[0, 1], [1, 2], [2, 3]]
    member = np.array([[True, True, False, False],
                       [False, False, True, True]])
    hg = ref_core.Hypergraph.from_edges(edges, num_nodes=4)
    phg = Hypergraph.from_edges(edges, num_nodes=4)
    ref_live = RefPlacement(member.copy(), 2.0, np.ones(4))
    live = Placement(member.copy(), 2.0, np.ones(4))
    fo_r, fo = ref_online.FailoverManager(ref_live), FailoverManager(live)
    assert fo.partition_down(0).tolist() == fo_r.partition_down(0).tolist() \
        == [0, 1]
    assert fo.repair(phg, k=1).tolist() == fo_r.repair(hg, k=1).tolist() \
        == []
    assert fo.stats == fo_r.stats
    assert fo.stats["unrepairable_items"] == 2
    assert live.member.tobytes() == ref_live.member.tobytes()


def test_failover_down_up_rebase_and_restore(fitted):
    hg, phg, member = fitted
    ref_live, live, fo_r, fo = _both_down(member, phg.node_weights, [1])
    assert fo.down_partitions == fo_r.down_partitions == [1]
    assert fo.serveable_mask(phg.edge_ptr, phg.edge_nodes).tobytes() == \
        fo_r.serveable_mask(hg.edge_ptr, hg.edge_nodes).tobytes()
    assert fo.restored_member().tobytes() == \
        fo_r.restored_member().tobytes() == member.tobytes()
    assert not live.member[1].any()
    bad = Placement(np.ones_like(member), CAP * 100, phg.node_weights)
    with pytest.raises(RuntimeError, match="down partition 1"):
        fo.rebase(bad)
    with pytest.raises(ValueError, match="already down"):
        fo.partition_down(1)
    fo.rebase(live)
    fo_r.rebase(ref_live)
    assert fo.pl is live and fo.member is live.member
    for f in (fo, fo_r):
        f.partition_up(1)
        f.resync_loads()
    assert live.member.tobytes() == ref_live.member.tobytes() == \
        member.tobytes()
    assert fo._loads.tobytes() == fo_r._loads.tobytes()
    with pytest.raises(ValueError, match="not down"):
        fo.partition_up(1)


def test_rebase_during_outage_then_repair(fitted):
    """A refit layout adopted mid-outage (down row kept empty) repairs and
    restores like the reference's."""
    hg, phg, member = fitted
    ref_live, live, fo_r, fo = _both_down(member, phg.node_weights, [6])
    grown = live.member.copy()
    grown[0, :40] = True      # copies onto a live row only
    fo.rebase(Placement(grown.copy(), CAP * 2, phg.node_weights))
    fo_r.rebase(RefPlacement(grown.copy(), CAP * 2, phg.node_weights))
    assert fo.repair(phg, k=1).tolist() == fo_r.repair(hg, k=1).tolist()
    fo.partition_up(6)
    fo_r.partition_up(6)
    assert fo.pl.member.tobytes() == fo_r.pl.member.tobytes()
    assert fo.stats == fo_r.stats


# --------------------------------------------------------------- run_online
def _sims():
    return ref_core.Simulator(N, CAP), Simulator(N, CAP, device="cpu")


@pytest.mark.parametrize("mb", ["routermb384", "routermb64+routerbal1"])
def test_run_online_matches_reference_and_batch_replay(fitted, monkeypatch,
                                                       mb):
    hg, phg, _ = fitted
    flags.set_variant(mb)
    ref_flags.set_variant(mb)
    ref_sim, sim = _sims()
    want, member = _ref_run_online(monkeypatch, ref_sim, hg,
                                   ref_core.ALGORITHMS["lmbr"], name="lmbr",
                                   seed=0, max_moves=40)
    got = sim.run_online(phg, ALGORITHMS["lmbr"], name="lmbr", seed=0,
                         max_moves=40)
    _same_result(got, want, member)
    batch = sim.run(phg, ALGORITHMS["lmbr"], name="lmbr", seed=0,
                    max_moves=40)
    assert got.member.tobytes() == batch.member.tobytes()
    if mb == "routermb384":
        assert got.spans.tobytes() == batch.spans.tobytes()
        assert got.access_load.tobytes() == batch.access_load.tobytes()
    s = got.summary()
    assert s["served_queries"] == 400 and s["degraded_queries"] == 0


EVENTS = {
    "down-up": [(100, "down", 0), (250, "up", 0)],
    "pair-repair2": [(50, "down", 2), (60, "down", 5), (200, "repair", 2),
                     (300, "up", 2), (399, "up", 5)],
    "after-end": [(30, "down", 4), (400, "up", 4)],
}


@pytest.mark.parametrize("events", list(EVENTS))
def test_run_online_failure_events_match_reference(fitted, monkeypatch,
                                                   events):
    hg, phg, _ = fitted
    ref_sim, sim = _sims()
    want, member = _ref_run_online(
        monkeypatch, ref_sim, hg, ref_core.ALGORITHMS["lmbr"], name="lmbr",
        seed=0, max_moves=40, events=EVENTS[events])
    got = sim.run_online(phg, ALGORITHMS["lmbr"], name="lmbr", seed=0,
                         max_moves=40, events=EVENTS[events])
    _same_result(got, want, member)
    s = got.summary()
    assert s["served_queries"] + s["degraded_queries"] == 400


def test_run_online_degraded_without_repair_matches_reference(fitted,
                                                              monkeypatch):
    hg, phg, member0 = fitted
    assert (member0[0] & ~member0[1:].any(axis=0)).any()
    ref_sim, sim = _sims()
    kw = dict(name="lmbr", seed=0, max_moves=40, auto_repair=False,
              events=[(0, "down", 0), (200, "up", 0)])
    want, member = _ref_run_online(monkeypatch, ref_sim, hg,
                                   ref_core.ALGORITHMS["lmbr"], **kw)
    got = sim.run_online(phg, ALGORITHMS["lmbr"], **kw)
    _same_result(got, want, member)
    s = got.summary()
    assert s["degraded_queries"] > 0 and s["repaired_items"] == 0
    assert len(got.spans) == s["served_queries"]


def _drift_trace(ref=True):
    old = ref_core.random_workload(num_items=120, num_queries=600, density=6,
                                   seed=2)
    new = ref_core.random_workload(num_items=120, num_queries=600, density=6,
                                   seed=9)
    edges = ([old.hypergraph.edge(e) for e in range(200)]
             + [new.hypergraph.edge(e) for e in range(600)])
    make = ref_core.Hypergraph.from_edges if ref else Hypergraph.from_edges
    return old.hypergraph, make(edges, num_nodes=120)


@pytest.mark.parametrize("events", [[], [(50, "down", 0)],
                                    [(50, "down", 0), (500, "up", 0)]],
                         ids=["no-outage", "long-outage", "outage"])
def test_run_online_drift_matches_reference(monkeypatch, events):
    old, trace = _drift_trace()
    _, ptrace = _drift_trace(ref=False)
    variant = "driftw128+driftth1.1+routermb64"
    flags.set_variant(variant)
    ref_flags.set_variant(variant)
    want, member = _ref_run_online(
        monkeypatch, ref_core.Simulator(10, 30), old,
        ref_core.ALGORITHMS["hpa"], name="hpa+drift", trace=trace,
        service=ref_core.PlacementService("lmbr", seed=0), refit_moves=128,
        seed=0, events=events)
    got = Simulator(10, 30, device="cpu").run_online(
        _port_hg(old), ALGORITHMS["hpa"], name="hpa+drift", trace=ptrace,
        service=PlacementService("lmbr", seed=0, device="cpu"),
        refit_moves=128, seed=0, events=events)
    _same_result(got, want, member)
    s = got.summary()
    assert s["drift_fires"] >= 1 and s["plan_swaps"] >= 1
    assert s["refits"] == s["plan_swaps"]
    assert (got.loads <= 30 + 1e-9).all()
    if events == [(50, "down", 0)]:
        assert got.loads[0] == 0.0


@pytest.mark.parametrize("fault_seed", [3, 8])
def test_run_online_fault_storm_matches_reference(fault_injected_run,
                                                  monkeypatch, fault_seed):
    wl = ref_core.random_workload(num_items=120, num_queries=500, density=5,
                                  seed=4)
    sim = Simulator(10, 30, device="cpu")
    got, events = fault_injected_run(
        sim, _port_hg(wl.hypergraph), ALGORITHMS["lmbr"],
        fault_seed=fault_seed, num_events=10, seed=0, max_moves=40)
    want, member = _ref_run_online(
        monkeypatch, ref_core.Simulator(10, 30), wl.hypergraph,
        ref_core.ALGORITHMS["lmbr"], events=events, seed=0, max_moves=40)
    assert len(events) > 0
    _same_result(got, want, member)
    assert (got.loads <= 30 + 1e-9).all()


def test_run_online_snapshots_match_reference(fitted):
    from repro import obs as ref_obs
    from repro_torch import obs

    hg, phg, _ = fitted
    variant = "obstrace+obssnap100+routermb64"
    flags.set_variant(variant)
    ref_flags.set_variant(variant)
    obs.reset()
    ref_obs.reset()
    ref_sim, sim = _sims()
    events = [(120, "down", 3), (300, "up", 3)]
    want = ref_sim.run_online(hg, ref_core.ALGORITHMS["lmbr"], seed=0,
                              max_moves=40, events=events)
    got = sim.run_online(phg, ALGORITHMS["lmbr"], seed=0, max_moves=40,
                         events=events)
    assert got.spans.tobytes() == want.spans.tobytes()
    a, b = obs.registry().snapshot(), ref_obs.registry().snapshot()
    timed = {k for k in b if "seconds" in k}
    assert {k: v for k, v in a.items() if k not in timed} == {
        k: v for k, v in b.items() if k not in timed}
    assert a["online_served_queries"] == 400
    snaps = [e for e in obs.tracer().events if e.get("name")
             == "online.snapshot"]
    ref_snaps = [e for e in ref_obs.tracer().events if e.get("name")
                 == "online.snapshot"]
    assert [e["args"] for e in snaps] == [e["args"] for e in ref_snaps]
    assert len(snaps) == 4
    obs.reset()
    ref_obs.reset()


def test_run_online_unknown_event_and_health_raise(fitted):
    _, phg, _ = fitted
    sim = Simulator(N, CAP, device="cpu")
    with pytest.raises(ValueError, match="unknown online event"):
        sim.run_online(phg, ALGORITHMS["lmbr"], seed=0, max_moves=40,
                       events=[(0, "explode", 1)])
    for kw in (dict(health=object()), dict(on_alert=print)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            sim.run_online(phg, ALGORITHMS["lmbr"], seed=0, max_moves=40,
                           **kw)


# ------------------------------------------------------ devices, names
def test_online_entry_points_raise_without_cuda(fitted, monkeypatch):
    _, phg, member = fitted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplicaRouter(member)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulator(N, CAP).run_online(phg, ALGORITHMS["lmbr"])
    plan = PlacementPlan(member, CAP, phg.node_weights, "lmbr")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DriftDetector(plan)
    assert ReplicaRouter(member, device="cpu").device == torch.device("cpu")


def test_online_exports_match_reference():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    assert set(online.__all__) == public(ref_online) == public(online)
    for sub in ("router", "drift", "failover", "migration"):
        assert getattr(online, sub).__all__ == getattr(ref_online,
                                                       sub).__all__
    assert inspect.signature(Simulator.run_online).parameters.keys() == \
        inspect.signature(ref_core.Simulator.run_online).parameters.keys()


@pytest.mark.parametrize("variant", [
    "routermb96+routerbal1+routereps0.25+routercost1",
    "driftw200+driftth1.4", "migbw2.5+migconc8+mighead0.25", "obssnap50",
    "baseline"])
def test_online_flag_variants_match_reference(variant):
    ref_flags.set_variant(variant)
    flags.set_variant(variant)
    for key, value in flags.FLAGS.items():
        assert ref_flags.FLAGS[key] == value, key


@pytest.mark.parametrize("bad", ["routereps-1", "migbw-1", "migconc0",
                                 "mighead-0.5", "obssnap-2"])
def test_online_flag_validation_matches_reference(bad):
    msgs = []
    for f in (ref_flags, flags):
        with pytest.raises(ValueError) as info:
            f.set_variant(bad)
        msgs.append(str(info.value))
        f.reset()
    assert msgs[0] == msgs[1]

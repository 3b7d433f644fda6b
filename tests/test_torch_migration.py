"""The port's live migration (``repro_torch.online.migration``,
``PlacementService.refit(as_migration=True)`` / ``plan_migration`` and
``run_online``'s migrate events) against the JAX package's on the same
seeded inputs, bit for bit: diffs and their brute-force oracle, the
``MigrationPlan`` JSON string, failure-free schedules, the executor through
a seeded down and a mid-flight destination failure, and ``run_online``
under instant and paced migrations, an outage, drift and a fault storm."""

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.online as ref_online
from repro import flags as ref_flags
from repro.core.placement_service import PlacementPlan as RefPlacementPlan
from repro.core.setcover import Placement as RefPlacement
from repro_torch import flags
from repro_torch.core import (ALGORITHMS, Hypergraph, Placement,
                              PlacementPlan, PlacementService, Simulator,
                              from_reference_arrays)
from repro_torch.online import (MigrationExecutor, MigrationPlan,
                                TransferEvent, diff_plans,
                                diff_plans_reference, plan_migration)

N, CAP = 10, 32


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


@pytest.fixture(scope="module")
def plans():
    """``random_workload(150, 400, density=6, seed=3)`` on 10 x 32 and two
    layouts of it (hpa, lmbr with 400 moves) whose diff has copies and
    drops; the port's fits equal the reference's."""
    hg = ref_core.random_workload(num_items=150, num_queries=400, density=6,
                                  seed=3).hypergraph
    pa = ref_core.ALGORITHMS["hpa"](hg, N, CAP, seed=0)
    pb = ref_core.ALGORITHMS["lmbr"](hg, N, CAP, seed=0, max_moves=400)
    phg = from_reference_arrays(hg.edge_ptr, hg.edge_nodes, hg.node_weights,
                                hg.edge_weights, hg.num_nodes)
    ta = ALGORITHMS["hpa"](phg, N, CAP, seed=0, device="cpu")
    tb = ALGORITHMS["lmbr"](phg, N, CAP, seed=0, max_moves=400,
                            device="cpu")
    assert ta.member.tobytes() == pa.member.tobytes()
    assert tb.member.tobytes() == pb.member.tobytes()
    d = diff_plans(pa.member, pb.member)
    assert d.num_copies > 0 and d.num_drops > 0
    return hg, phg, pa.member, pb.member, pa.node_weights


def _same_diff(a, b):
    for f in ("copy_dest", "copy_item", "drop_part", "drop_item"):
        assert getattr(a, f).dtype == getattr(b, f).dtype == np.int64
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f


def _events(events):
    return [(e.tick, e.kind, e.partition, e.item, e.src) for e in events]


# ------------------------------------------------------------------- diffs
def test_diff_matches_reference_on_fits(plans):
    _, _, a, b, _ = plans
    got = diff_plans(a, b)
    _same_diff(got, ref_online.diff_plans(a, b))
    _same_diff(got, diff_plans_reference(a, b))
    _same_diff(diff_plans_reference(a, b),
               ref_online.diff_plans_reference(a, b))
    assert (got.num_copies, got.num_drops) == (
        ref_online.diff_plans(a, b).num_copies,
        ref_online.diff_plans(a, b).num_drops)
    # Placements and plans diff like their member matrices
    _same_diff(diff_plans(Placement(a, CAP, np.ones(150)),
                          PlacementPlan(b, CAP, np.ones(150), "x",
                                        device="cpu")), got)


@pytest.mark.parametrize("seed", range(6))
def test_diff_matches_reference_on_random_matrices(seed):
    rng = np.random.default_rng(seed)
    n, v = int(rng.integers(1, 7)), int(rng.integers(1, 30))
    a, b = rng.random((n, v)) < 0.4, rng.random((n, v)) < 0.4
    _same_diff(diff_plans(a, b), ref_online.diff_plans(a, b))
    _same_diff(diff_plans_reference(a, b), ref_online.diff_plans(a, b))
    mp = plan_migration(a, b, bandwidth=1.0)
    assert np.array_equal(mp.apply(a.copy()), b)


def test_diff_errors_match_reference():
    for mod in (ref_online, None):
        diff = ref_online.diff_plans if mod else diff_plans
        ref = ref_online.diff_plans_reference if mod else diff_plans_reference
        for fn in (diff, ref):
            with pytest.raises(ValueError, match="shapes differ"):
                fn(np.zeros((2, 3), dtype=bool), np.zeros((2, 4), dtype=bool))
            with pytest.raises(TypeError):
                fn(np.zeros((2, 3)), np.zeros((2, 3)))


# -------------------------------------------------------------- plan, json
PACING = [dict(bandwidth=7.5, concurrency=3, headroom=0.2),
          dict(bandwidth=0.0, concurrency=1, headroom=0.0),
          dict(bandwidth=1e-3, concurrency=8, headroom=1.0 / 3.0)]


@pytest.mark.parametrize("pacing", PACING, ids=["paced", "instant", "odd"])
def test_migration_plan_json_matches_reference(plans, pacing):
    _, _, a, b, w = plans
    got = plan_migration(a, b, node_weights=w, **pacing)
    want = ref_online.plan_migration(a, b, node_weights=w, **pacing)
    assert got.to_json() == want.to_json()
    for f in ("copy_dest", "copy_item", "copy_src", "drop_part",
              "drop_item"):
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes()
    back = MigrationPlan.from_json(got.to_json())
    assert back.to_json() == got.to_json()
    assert ref_online.MigrationPlan.from_json(got.to_json()).to_json() == \
        got.to_json()
    assert got.bytes_to_move(w) == want.bytes_to_move(w)
    assert got.inflight_bound(w) == want.inflight_bound(w)
    assert got.is_noop == want.is_noop is False


def test_plan_migration_from_flags_and_errors(plans):
    _, _, a, b, w = plans
    variant = "migbw2.5+migconc8+mighead0.25"
    flags.set_variant(variant)
    ref_flags.set_variant(variant)
    got = plan_migration(a, b)
    assert got.to_json() == ref_online.plan_migration(a, b).to_json()
    assert (got.bandwidth, got.concurrency, got.headroom) == (2.5, 8, 0.25)
    # an item never held in the old layout has no source
    old = a.copy()
    old[:, 0] = False
    src = plan_migration(old, b).copy_src
    assert src.tobytes() == ref_online.plan_migration(old, b).copy_src \
        .tobytes()
    assert (src[plan_migration(old, b).copy_item == 0] == -1).all()
    for mod in (ref_online, None):
        fn = mod.plan_migration if mod else plan_migration
        with pytest.raises(ValueError, match="uncovered"):
            fn(a, np.zeros_like(a), node_weights=w)
        for kw, word in ((dict(bandwidth=-1.0), "bandwidth"),
                         (dict(concurrency=0), "concurrency"),
                         (dict(headroom=-0.1), "headroom")):
            with pytest.raises(ValueError, match=word):
                fn(a, b, **kw)


# ---------------------------------------------------------------- schedule
@pytest.mark.parametrize("pacing", [
    dict(bandwidth=8.0, concurrency=3, headroom=0.15),
    dict(bandwidth=2.0, concurrency=1, headroom=0.25),
    dict(bandwidth=50.0, concurrency=4, headroom=0.10)],
    ids=["bw8", "bw2", "bw50"])
def test_schedule_matches_reference(plans, pacing):
    _, _, a, b, w = plans
    got = plan_migration(a, b, node_weights=w, **pacing)
    want = ref_online.plan_migration(a, b, node_weights=w, **pacing)
    start = Placement(a.copy(), CAP, w)
    ev = got.schedule(start)
    assert start.member.tobytes() == a.tobytes()   # the input is untouched
    assert _events(ev) == _events(want.schedule(RefPlacement(a.copy(), CAP,
                                                             w)))
    assert all(isinstance(e, TransferEvent) for e in ev)
    assert len(ev) == got.num_copies + got.num_drops
    member = a.copy()
    for e in ev:
        member[e.partition, e.item] = e.kind == "copy"
    assert member.tobytes() == b.tobytes()


def _step_both(got_ex, want_ex, ticks, live, ref_live):
    for _ in range(ticks):
        got_ex.advance(1)
        want_ex.advance(1)
        assert got_ex.now == want_ex.now
        assert got_ex.done == want_ex.done
        assert got_ex.loads().tobytes() == want_ex.loads().tobytes()
        assert got_ex.inflight_bytes == want_ex.inflight_bytes
        assert live.member.tobytes() == ref_live.member.tobytes()


def _executors(plans, down=(), **pacing):
    _, _, a, b, w = plans
    live, ref_live = Placement(a.copy(), CAP, w), RefPlacement(a.copy(),
                                                               CAP, w)
    for p in down:
        live.member[p] = False
        ref_live.member[p] = False
    got = MigrationExecutor(plan_migration(a, b, node_weights=w, **pacing),
                            live, down=down)
    want = ref_online.MigrationExecutor(
        ref_online.plan_migration(a, b, node_weights=w, **pacing), ref_live,
        down=down)
    return got, want, live, ref_live


def _finish(got, want, live, ref_live, b):
    guard = 0
    while not got.done:
        _step_both(got, want, 16, live, ref_live)
        guard += 1
        assert guard < 10_000
    assert want.done
    assert live.member.tobytes() == b.tobytes()
    assert got.stats == want.stats
    assert _events(got.events) == _events(want.events)


def test_executor_seeded_down_matches_reference(plans):
    _, _, a, b, _ = plans
    dead = int(diff_plans(a, b).copy_dest[0])
    got, want, live, ref_live = _executors(
        plans, down=[dead], bandwidth=4.0, concurrency=3, headroom=0.25)
    _step_both(got, want, 200, live, ref_live)
    assert not live.member[dead].any() and not got.done
    live.member[dead] = a[dead]
    ref_live.member[dead] = a[dead]
    got.on_partition_up(dead)
    want.on_partition_up(dead)
    _finish(got, want, live, ref_live, b)


def test_executor_mid_flight_destination_failure_matches_reference(plans):
    _, _, _, b, _ = plans
    got, want, live, ref_live = _executors(
        plans, bandwidth=4.0, concurrency=3, headroom=0.25)
    dead = int(got.plan.copy_dest[0])
    _step_both(got, want, 8, live, ref_live)
    saved = live.member[dead].copy()
    for pl, ex in ((live, got), (ref_live, want)):
        pl.member[dead] = False
        ex.on_partition_down(dead)
    _step_both(got, want, 30, live, ref_live)
    assert not got.done
    assert got.stats == want.stats and got.stats["aborted_transfers"] >= 1
    for pl, ex in ((live, got), (ref_live, want)):
        pl.member[dead] = saved | pl.member[dead]
        ex.on_partition_up(dead)
    _finish(got, want, live, ref_live, b)
    end = got.now
    got.advance(100)
    assert got.now == end


def test_executor_refresh_after_external_copy_matches_reference(plans):
    _, _, _, b, _ = plans
    got, want, live, ref_live = _executors(
        plans, bandwidth=3.0, concurrency=2, headroom=0.2)
    _step_both(got, want, 5, live, ref_live)
    # a repair beats a pending transfer to its destination
    idx = got._pending[-1]
    d, v = int(got.plan.copy_dest[idx]), int(got.plan.copy_item[idx])
    for pl, ex in ((live, got), (ref_live, want)):
        pl.member[d, v] = True
        ex.refresh_loads()
    _finish(got, want, live, ref_live, b)


def test_executor_errors_match_reference():
    old = np.array([[True, False], [False, True]])
    new = np.array([[False, True], [True, False]])
    w = np.ones(2)
    msgs = []
    for mod in (ref_online, None):
        pm = mod.plan_migration if mod else plan_migration
        Ex = mod.MigrationExecutor if mod else MigrationExecutor
        Pl = RefPlacement if mod else Placement
        with pytest.raises(ValueError, match="bandwidth"):
            Ex(pm(old, new, node_weights=w, bandwidth=0.0),
               Pl(old.copy(), 1.0, w))
        with pytest.raises(ValueError, match="shape"):
            Ex(pm(old, new, bandwidth=1.0), Pl(np.ones((3, 2), bool), 1.0,
                                              w))
        ex = Ex(pm(old, new, node_weights=w, bandwidth=5.0, concurrency=2,
                   headroom=0.0), Pl(old.copy(), 1.0, w))
        with pytest.raises(RuntimeError, match="stalled") as info:
            ex.advance(10)
        msgs.append(str(info.value))
        one = np.array([[True, False]])
        ex = Ex(pm(one, np.array([[True, True]]), bandwidth=5.0,
                   headroom=0.0), Pl(one.copy(), 5.0, w))
        with pytest.raises(RuntimeError, match="no live source") as info:
            ex.advance(5)
        msgs.append(str(info.value))
    assert msgs[:2] == msgs[2:]


# -------------------------------------------------------------- run_online
class _RecordingFailover(ref_online.FailoverManager):
    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _RecordingFailover.made.append(self)


def _both_runs(monkeypatch, plans, events, variant="", **kw):
    """The same run_online through both packages, from the hpa layout;
    ``events`` may name the target as "tgt"."""
    hg, phg, a, b, w = plans
    if variant:
        flags.set_variant(variant)
        ref_flags.set_variant(variant)

    def fit_old(h, n_, c_, **_):
        return Placement(a.copy(), CAP, w)

    def ref_fit_old(h, n_, c_, **_):
        return RefPlacement(a.copy(), CAP, w)

    tgt = PlacementPlan(b.copy(), float(CAP), w, "lmbr", device="cpu")
    ref_tgt = RefPlacementPlan(b.copy(), float(CAP), w, "lmbr")
    with monkeypatch.context() as m:
        m.setattr(ref_online, "FailoverManager", _RecordingFailover)
        want = ref_core.Simulator(N, CAP).run_online(
            hg, ref_fit_old, name="old",
            events=[(at, k, ref_tgt if x == "tgt" else x)
                    for at, k, x in events], **kw)
    got = Simulator(N, CAP, device="cpu").run_online(
        phg, fit_old, name="old", events=[(at, k, tgt if x == "tgt" else x)
                              for at, k, x in events], **kw)
    a_, b_ = got.summary(), want.summary()
    a_.pop("placement_s")
    b_.pop("placement_s")
    assert a_ == b_
    assert got.spans.tobytes() == want.spans.tobytes()
    assert got.access_load.tobytes() == want.access_load.tobytes()
    assert got.loads.tobytes() == want.loads.tobytes()
    assert got.member.tobytes() == \
        _RecordingFailover.made[-1].pl.member.tobytes()
    return got.online_stats


@pytest.mark.parametrize("variant", ["", "migbw6.0+mighead0.15",
                                     "migbw0.5+mighead0.3+migconc1"],
                         ids=["instant", "paced", "slow"])
def test_run_online_migrate_matches_reference(plans, monkeypatch, variant):
    s = _both_runs(monkeypatch, plans, [(120, "migrate", "tgt")], variant)
    assert s["migrations"] == 1 and s["degraded_queries"] == 0
    if variant == "":
        assert s["migration_ticks"] == 0 and s["plan_swaps"] == 1
    if variant != "migbw0.5+mighead0.3+migconc1":
        assert s["migration_done"]


def test_run_online_migrate_prebuilt_plan_matches_reference(plans):
    hg, phg, a, b, w = plans
    got = Simulator(N, CAP, device="cpu").run_online(
        phg, lambda *x, **k: Placement(a.copy(), CAP, w),
        events=[(40, "migrate", plan_migration(a, b, node_weights=w,
                                               bandwidth=5.0))])
    want = ref_core.Simulator(N, CAP).run_online(
        hg, lambda *x, **k: RefPlacement(a.copy(), CAP, w),
        events=[(40, "migrate", ref_online.plan_migration(
            a, b, node_weights=w, bandwidth=5.0))])
    assert got.online_stats == want.online_stats
    assert got.member.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", ["down-migrate-up", "through-failover",
                                  "no-repair"])
def test_run_online_migration_with_outage_matches_reference(plans,
                                                            monkeypatch,
                                                            case):
    _, _, a, b, w = plans
    dead = int(plan_migration(a, b, node_weights=w).copy_dest[0])
    if case == "down-migrate-up":
        events = [(10, "down", dead), (50, "migrate", "tgt"),
                  (220, "up", dead)]
        kw = dict(variant="migbw6.0+mighead0.25", auto_repair=False)
    elif case == "through-failover":
        events = [(60, "migrate", "tgt"), (100, "down", dead),
                  (250, "up", dead)]
        kw = dict(variant="migbw2.0+mighead0.25")
    else:
        events = [(60, "migrate", "tgt"), (100, "down", dead),
                  (250, "up", dead)]
        kw = dict(variant="migbw2.0+mighead0.25", auto_repair=False)
    s = _both_runs(monkeypatch, plans, events, **kw)
    assert s["served_queries"] + s["degraded_queries"] == 400
    assert s["partitions_down"] == 1


def test_run_online_migrate_errors_match_reference(plans):
    hg, phg, a, b, w = plans
    dead = int(plan_migration(a, b, node_weights=w).copy_dest[0])
    tgt = PlacementPlan(b.copy(), float(CAP), w, "lmbr", device="cpu")
    ref_tgt = RefPlacementPlan(b.copy(), float(CAP), w, "lmbr")
    for events, variant, word in (
            ([(10, "migrate", 0), (20, "migrate", 0)], "migbw0.5",
             "already in flight"),
            ([(10, "down", dead), (50, "migrate", 0)], "", "down partition")):
        for f in (flags, ref_flags):
            f.set_variant(variant or "baseline")
        for sim, t, h, pl in (
                (Simulator(N, CAP, device="cpu"), tgt, phg, Placement),
                (ref_core.Simulator(N, CAP), ref_tgt, hg, RefPlacement)):
            with pytest.raises(ValueError, match=word):
                sim.run_online(h, lambda *x, _p=pl, **k: _p(a.copy(), CAP, w),
                               events=[(at, k, t if k == "migrate" else x)
                                       for at, k, x in events])


def test_run_online_paced_drift_matches_reference(monkeypatch):
    old = ref_core.random_workload(num_items=120, num_queries=600, density=6,
                                   seed=2)
    new = ref_core.random_workload(num_items=120, num_queries=600, density=6,
                                   seed=9)
    edges = ([old.hypergraph.edge(e) for e in range(200)]
             + [new.hypergraph.edge(e) for e in range(600)])
    variant = "driftw128+driftth1.1+routermb64+migbw40.0+mighead0.2"
    flags.set_variant(variant)
    ref_flags.set_variant(variant)
    ohg = old.hypergraph
    want = ref_core.Simulator(10, 40).run_online(
        ohg, ref_core.ALGORITHMS["hpa"], name="hpa+drift",
        trace=ref_core.Hypergraph.from_edges(edges, num_nodes=120),
        service=ref_core.PlacementService("lmbr", seed=0), refit_moves=128,
        seed=0)
    got = Simulator(10, 40, device="cpu").run_online(
        from_reference_arrays(ohg.edge_ptr, ohg.edge_nodes, ohg.node_weights,
                              ohg.edge_weights, ohg.num_nodes),
        ALGORITHMS["hpa"], name="hpa+drift",
        trace=Hypergraph.from_edges(edges, num_nodes=120),
        service=PlacementService("lmbr", seed=0, device="cpu"),
        refit_moves=128, seed=0)
    a, b = got.summary(), want.summary()
    a.pop("placement_s")
    b.pop("placement_s")
    assert a == b
    assert got.spans.tobytes() == want.spans.tobytes()
    s = got.online_stats
    assert s["migrations"] == s["refits"] == s["plan_swaps"] >= 1
    assert s["migration_done"]
    assert (got.loads <= 40.0 * 1.2 + 1e-9).all()


def test_run_online_migration_under_fault_storm_matches_reference(
        plans, monkeypatch, fault_injected_run):
    hg, phg, a, b, w = plans
    variant = "migbw50.0+mighead0.35"
    flags.set_variant(variant)
    ref_flags.set_variant(variant)
    tgt = PlacementPlan(b.copy(), float(CAP), w, "lmbr", device="cpu")
    got, events = fault_injected_run(
        Simulator(N, CAP, device="cpu"), phg,
        lambda *x, **k: Placement(a.copy(), CAP, w), fault_seed=5,
        num_events=6, extra_events=[(5, "migrate", tgt)])
    ref_tgt = RefPlacementPlan(b.copy(), float(CAP), w, "lmbr")
    want = ref_core.Simulator(N, CAP).run_online(
        hg, lambda *x, **k: RefPlacement(a.copy(), CAP, w),
        events=[(at, k, ref_tgt if k == "migrate" else x)
                for at, k, x in events])
    assert got.online_stats == want.online_stats
    assert got.spans.tobytes() == want.spans.tobytes()
    assert got.loads.tobytes() == want.loads.tobytes()
    assert (got.loads <= CAP * 1.35 + 1e-9).all()


# -------------------------------------------------------------- the service
@pytest.mark.parametrize("pacing", ["", "migbw3+migconc2+mighead0.3"])
def test_refit_as_migration_matches_reference(pacing):
    wl = ref_core.random_workload(num_items=120, num_queries=500, density=5,
                                  seed=3)
    flags.set_variant(pacing or "baseline")
    ref_flags.set_variant(pacing or "baseline")
    ref_svc = ref_core.PlacementService("lmbr", seed=0)
    svc = PlacementService("lmbr", seed=0, device="cpu")
    # a fit cut at 40 moves leaves LMBR free space (a converged service fit
    # fills it, and its refit adds nothing)
    ref_pl = ref_core.ALGORITHMS["lmbr"](wl.hypergraph, 10, 40, seed=0,
                                         max_moves=40)
    ref_plan = RefPlacementPlan(ref_pl.member, 40, ref_pl.node_weights,
                                "lmbr")
    plan = PlacementPlan(ref_pl.member.copy(), 40, ref_pl.node_weights,
                         "lmbr", device="cpu")
    # a window of drifted traffic
    drift = ref_core.random_workload(num_items=120, num_queries=200,
                                     density=5, seed=8).queries
    got = svc.refit(plan, drift, max_moves=64, as_migration=True)
    want = ref_svc.refit(ref_plan, drift, max_moves=64, as_migration=True)
    assert isinstance(got, MigrationPlan)
    assert got.to_json() == want.to_json()
    assert got.num_drops == 0 and got.num_copies > 0
    assert got.target.to_json() == want.target.to_json()
    assert got.target.algorithm == "lmbr+refit"
    assert got.target.device == svc.device == torch.device("cpu")
    assert np.array_equal(got.apply(plan.member.copy()), got.target.member)
    plain = svc.refit(plan, drift, max_moves=64)
    assert plain.to_json() == got.target.to_json()


def test_service_plan_migration_matches_reference(plans):
    _, _, a, b, w = plans
    old = PlacementPlan(a, float(CAP), w, "hpa", device="cpu")
    new = PlacementPlan(b, float(CAP), w, "lmbr", device="cpu")
    svc = PlacementService("lmbr", device="cpu")
    got = svc.plan_migration(old, new, bandwidth=4.0, concurrency=2,
                             headroom=0.5)
    want = ref_core.PlacementService("lmbr").plan_migration(
        RefPlacementPlan(a, float(CAP), w, "hpa"),
        RefPlacementPlan(b, float(CAP), w, "lmbr"), bandwidth=4.0,
        concurrency=2, headroom=0.5)
    assert got.to_json() == want.to_json()
    assert got.target is new
    with pytest.raises(ValueError, match="uncovered"):
        svc.plan_migration(old, PlacementPlan(np.zeros_like(b), float(CAP), w,
                                              "x", device="cpu"))

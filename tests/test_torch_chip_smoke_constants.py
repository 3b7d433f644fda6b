"""``chip_smoke.py``'s tables against the JAX package: every paper-algos
row's avg_span is what the reference's ``Simulator.run`` gives on the CPU,
every placement-api value is what the reference's service, 3-way and
bridge calls give there, every online value is what the reference's
router, ``run_online`` and ``refit(as_migration=True)`` give there, and
the port's generators build the reference's inputs, so the card run is
held to the reference without importing it."""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
import repro.online as ref_online
from repro import flags as ref_flags
from repro.core import ALGORITHMS as REF_ALGORITHMS
from repro.core import hpa as ref_hpa
from repro.core import Simulator as RefSimulator
from repro.core import workloads as ref_workloads
from repro_torch.core import workloads

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

sys.path.remove(str(ROOT))

_GRAPHS = {}


def _ref_graph(key):
    if key not in _GRAPHS:
        fn, kw = chip_smoke.PAPER_WORKLOADS[key]
        _GRAPHS[key] = getattr(ref_workloads, fn)(**kw).hypergraph
    return _GRAPHS[key]


def test_table_covers_every_algorithm_at_both_points():
    runs = {(w, n, name) for w, n, _, name, _, _ in chip_smoke.PAPER_RUNS}
    assert len(runs) == len(chip_smoke.PAPER_RUNS)
    for w, n in (("fig6", 40), ("fig9-ibm01", 35)):
        assert {name for w_, n_, name in runs if (w_, n_) == (w, n)} \
            == set(REF_ALGORITHMS)
    assert ("fig6", 30, "ihpa") in runs
    assert "paper-algos" in chip_smoke.PHASES


@pytest.mark.parametrize("key", list(chip_smoke.PAPER_WORKLOADS))
def test_port_generators_build_the_reference_graphs(key):
    fn, kw = chip_smoke.PAPER_WORKLOADS[key]
    got = getattr(workloads, fn)(**kw).hypergraph
    want = _ref_graph(key)
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()


@pytest.mark.parametrize(
    "row", chip_smoke.PAPER_RUNS,
    ids=[f"{w}-{n}-{name}" for w, n, _, name, _, _ in chip_smoke.PAPER_RUNS])
def test_reference_avg_span(row):
    workload, n, cap, name, extra, want = row
    res = RefSimulator(n, cap).run(_ref_graph(workload), REF_ALGORITHMS[name],
                                   name=name, seed=0, **extra)
    assert res.avg_span == want


# ------------------------------------------------------------ placement-api
def _api_inputs():
    """The reference's inputs of the placement-api runs (the port builds
    the same ones in ``chip_smoke.api_inputs``)."""
    if "api" not in _GRAPHS:
        rng = np.random.default_rng(0)
        profile = ref_core.NodeProfile(
            capacity=np.full(45, 100.0),
            fail_prob=rng.uniform(0.01, 0.1, 45), power_idle=100.0,
            power_active=300.0, access_cost=rng.uniform(0, 1, 45))
        mask = np.ones(45, dtype=bool)
        mask[[3, 17]] = False
        _GRAPHS["api"] = dict(
            tpch=ref_core.tpch_heterogeneous(num_items=2000,
                                             num_queries=4000, seed=0),
            tpch1=ref_core.tpch_heterogeneous(num_items=2000,
                                              num_queries=4000, seed=1),
            profile=profile, mask=mask,
            fig6=ref_core.random_workload(1000, 4000, 3, 11, 20, seed=0),
            trace=ref_core.synthetic_routing_trace(256, 4096, top_k=8,
                                                   seed=0),
            recipes=ref_core.mixture_batch_recipes(1000, 2000, seed=0),
        )
    return _GRAPHS["api"]


def _ref_service_fit(inp):
    if "plan" not in _GRAPHS:
        _GRAPHS["plan"] = ref_core.PlacementService("lmbr", seed=0).fit(
            inp["tpch"].queries, 2000, 45, profile=inp["profile"],
            durability_eps=0.05)
    return _GRAPHS["plan"]


def _ref_held(name):
    inp = _api_inputs()
    svc = ref_core.PlacementService("lmbr", seed=0)
    if name == "service-fit":
        plan = _ref_service_fit(inp)
        return dict(json_sha256=chip_smoke._sha256(plan.to_json()),
                    durability_copies=plan.stats["durability_copies"],
                    avg_span=plan.avg_span(inp["tpch"].queries))
    if name == "service-refit":
        old = _ref_service_fit(inp)
        q1 = inp["tpch1"].queries
        ref_flags.set_variant("nodecost0.5")
        try:
            new = svc.refit(old, q1, max_moves=64, dest_mask=inp["mask"],
                            profile=inp["profile"])
        finally:
            ref_flags.reset()
        added = new.member & ~old.member
        assert not added[~inp["mask"]].any()
        return dict(json_sha256=chip_smoke._sha256(new.to_json()),
                    copies_added=int(added.sum()),
                    avg_span_before=old.avg_span(q1),
                    avg_span_after=new.avg_span(q1))
    if name == "service-hier":
        queries = inp["tpch"].queries
        plan = svc.fit_hierarchical(queries, 2000, num_pods=4,
                                    hosts_per_pod=10, host_capacity=100.0)
        spans = np.array([plan.spans(q) for q in queries])
        weighted = [plan.weighted_span(q) for q in queries]
        return dict(
            host_member_sha256=chip_smoke._sha256(plan.host_member.tobytes()),
            mean_pod_span=float(spans[:, 0].mean()),
            mean_host_span=float(spans[:, 1].mean()),
            mean_weighted_span=float(np.mean(weighted)))
    if name == "three-way":
        hg = inp["fig6"].hypergraph
        n = 3 * ref_core.min_partitions(hg, 50)
        assert n == 60
        held = {}
        for algo, fn in ref_core.THREE_WAY_ALGORITHMS.items():
            # what Simulator(n, 50).compare runs for each algorithm: the
            # fit in a fresh partition memo, then the replay of hg itself
            with ref_hpa.fresh_partition_cache():
                pl = fn(hg, n, 50, seed=0)
            held[algo] = dict(
                avg_span=float(ref_core.spans_for_workload(hg, pl).mean()),
                member_sha256=chip_smoke._sha256(pl.member.tobytes()))
        return held
    if name == "experts":
        trace = inp["trace"]
        plan = ref_core.plan_expert_placement(trace, 256, 32,
                                              slots_per_rank=9,
                                              algorithm="lmbr", seed=0)
        base = ref_core.baseline_contiguous_placement(256, 32, 9)
        return dict(
            member_sha256=chip_smoke._sha256(plan.member.tobytes()),
            tables_sha256=chip_smoke._sha256(
                plan.slot_to_expert.tobytes()
                + plan.expert_slot_table.tobytes()),
            avg_span=plan.avg_span(trace),
            baseline_avg_span=base.avg_span(trace))
    if name == "shards":
        recipes = inp["recipes"]
        plan = ref_core.plan_shard_placement(recipes, 1000, 48, capacity=80,
                                             algorithm="pra3")
        return dict(member_sha256=chip_smoke._sha256(plan.member.tobytes()),
                    survives_2_failures=plan.survives_failures(2),
                    avg_span=plan.avg_span(recipes))
    raise ValueError(name)


def test_placement_api_table():
    assert "placement-api" in chip_smoke.PHASES
    assert list(chip_smoke.API_HELD) == list(chip_smoke.API_RUNS)
    assert set(chip_smoke.API_HELD["three-way"]) == set(
        ref_core.THREE_WAY_ALGORITHMS)


@pytest.mark.parametrize("name", list(chip_smoke.API_HELD))
def test_placement_api_reference_values(name):
    assert _ref_held(name) == chip_smoke.API_HELD[name]


def test_port_generators_build_the_placement_api_inputs():
    got = chip_smoke.api_inputs(np)
    want = _api_inputs()
    for key in ("tpch", "tpch1"):
        assert len(got[key]) == 4000
        for a, b in zip(got[key], want[key].queries):
            assert a.tobytes() == b.tobytes()
    port_tpch = workloads.tpch_heterogeneous(num_items=2000, num_queries=4000,
                                             seed=0).hypergraph
    assert (port_tpch.node_weights.tobytes()
            == want["tpch"].hypergraph.node_weights.tobytes())
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        assert (getattr(got["fig6"], name).tobytes()
                == getattr(want["fig6"].hypergraph, name).tobytes())
    for key in ("trace", "recipes"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for col in ("capacity", "fail_prob", "power_idle", "power_active",
                "access_cost"):
        assert (getattr(got["profile"], col).tobytes()
                == getattr(want["profile"], col).tobytes())
    assert got["mask"].tobytes() == want["mask"].tobytes()


# ------------------------------------------------------------------- online
def _online_inputs():
    """The reference's inputs of the online runs (the port builds the same
    ones in ``chip_smoke.online_inputs``)."""
    if "online" not in _GRAPHS:
        fig6 = ref_core.random_workload(1000, 4000, 3, 11, 20,
                                        seed=0).hypergraph
        new = ref_core.random_workload(1000, 4000, 3, 11, 20,
                                       seed=7).hypergraph
        _GRAPHS["online"] = dict(
            stress=ref_core.lmbr_stress_workload(seed=0).hypergraph,
            fig6=fig6,
            splice=ref_core.Hypergraph.from_edges(
                [fig6.edge(e) for e in range(2000)]
                + [new.edge(e) for e in range(new.num_edges)],
                num_nodes=1000),
            seed1=ref_core.random_workload(1000, 4000, 3, 11, 20,
                                           seed=1).queries,
        )
    return _GRAPHS["online"]


class _RecordingFailover(ref_online.FailoverManager):
    """The reference's failover manager, remembering itself: its ``pl``
    is the final live layout of a ``run_online``."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _RecordingFailover.made.append(self)


def _ref_online_run(monkeypatch, sim, *args, **kw):
    with monkeypatch.context() as m:
        m.setattr(ref_online, "FailoverManager", _RecordingFailover)
        res = sim.run_online(*args, **kw)
    held = {k: v for k, v in res.summary().items()
            if k not in chip_smoke.BACKEND_KEYS}
    held.update(
        spans_sha256=chip_smoke._sha256(res.spans.tobytes()),
        member_sha256=chip_smoke._sha256(
            _RecordingFailover.made[-1].pl.member.tobytes()))
    return held


def _ref_online_held(name, monkeypatch):
    inp = _online_inputs()
    lmbr = REF_ALGORITHMS["lmbr"]
    sim = RefSimulator(40, 50)
    if name == "router":
        hg = inp["stress"]
        pl = REF_ALGORITHMS["random"](hg, 64, 50, seed=0)
        held = {}
        for mode, balance in (("default", False), ("balanced", True)):
            router = ref_online.ReplicaRouter(pl.member, balance=balance)
            b = router.route_csr(hg.edge_ptr, hg.edge_nodes)
            held[mode] = dict(
                cover_sha256=chip_smoke._sha256(
                    b.spans.tobytes() + b.cover_parts.tobytes()
                    + b.pin_parts.tobytes()),
                ledger_sha256=chip_smoke._sha256(router.load.tobytes()),
                avg_span=float(b.spans.mean()),
                load_imbalance=router.load_imbalance(),
                microbatches=router.stats["microbatches"])
        return held
    if name == "drift":
        return _ref_online_run(
            monkeypatch, sim, inp["fig6"], lmbr, name="lmbr+drift",
            trace=inp["splice"],
            service=ref_core.PlacementService("lmbr", seed=0),
            refit_moves=400, seed=0, max_moves=120)
    if name == "failover":
        return _ref_online_run(
            monkeypatch, sim, inp["fig6"], lmbr, name="lmbr", seed=0,
            max_moves=120, repair_k=1,
            events=chip_smoke.ONLINE_EVENTS["failover"])
    if name == "migration":
        with ref_hpa.fresh_partition_cache():
            target = lmbr(inp["fig6"], 40, 50, seed=0, max_moves=120)
        events = [(at, kind, target if kind == "migrate" else arg)
                  for at, kind, arg in chip_smoke.ONLINE_EVENTS["migration"]]
        ref_flags.set_variant("migbw1")
        try:
            return _ref_online_run(
                monkeypatch, sim, inp["fig6"], REF_ALGORITHMS["random"],
                name="random", seed=0, events=events)
        finally:
            ref_flags.reset()
    if name == "refit-migration":
        with ref_hpa.fresh_partition_cache():
            pl = lmbr(inp["fig6"], 40, 50, seed=0, max_moves=120)
        plan = ref_core.PlacementPlan(pl.member, 50, pl.node_weights, "lmbr")
        mp = ref_core.PlacementService("lmbr", seed=0).refit(
            plan, inp["seed1"], max_moves=64, as_migration=True)
        return dict(json_sha256=chip_smoke._sha256(mp.to_json()),
                    copies=mp.num_copies, drops=mp.num_drops,
                    avg_span_before=plan.avg_span(inp["seed1"]),
                    avg_span_after=mp.target.avg_span(inp["seed1"]))
    raise ValueError(name)


def test_online_table():
    phases = chip_smoke.PHASES
    assert phases.index("placement-api") + 1 == phases.index("online") \
        == phases.index("serve") - 1
    assert list(chip_smoke.ONLINE_HELD) == list(chip_smoke.ONLINE_RUNS)
    # the event runs' reference values on the CPU, named one by one
    held = chip_smoke.ONLINE_HELD
    assert (held["drift"]["avg_span"], held["drift"]["drift_fires"],
            held["drift"]["refits"], held["drift"]["plan_swaps"],
            held["drift"]["windowed_avg_span"]) == (5.6605, 2, 2, 2, 5.5762)
    assert (held["failover"]["avg_span"], held["failover"]["repaired_items"],
            held["failover"]["degraded_queries"],
            held["failover"]["partitions_down"]) == (5.1143, 76, 0, 3)
    m = held["migration"]
    assert (m["avg_span"], m["migration_copies"], m["migration_drops"],
            m["migration_ticks"], m["repaired_items"], m["degraded_queries"],
            m["migration_done"]) == (5.5365, 1074, 1942, 1322, 24, 0, True)
    assert held["router"]["default"]["microbatches"] == 27
    assert held["refit-migration"]["drops"] == 0
    assert held["refit-migration"]["copies"] > 0


@pytest.mark.parametrize("name", list(chip_smoke.ONLINE_HELD))
def test_online_reference_values(name, monkeypatch):
    assert _ref_online_held(name, monkeypatch) == \
        chip_smoke.ONLINE_HELD[name]


def test_port_generators_build_the_online_inputs():
    got = chip_smoke.online_inputs(np)
    want = _online_inputs()
    for key in ("stress", "fig6", "splice"):
        for name in ("edge_ptr", "edge_nodes", "node_weights",
                     "edge_weights"):
            assert (getattr(got[key], name).tobytes()
                    == getattr(want[key], name).tobytes()), (key, name)
    assert len(got["seed1"]) == 4000
    for a, b in zip(got["seed1"], want["seed1"]):
        assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------------- health
def _ref_health_held(name, monkeypatch):
    """The reference's values of one health run: the storm or the clean
    replay of fig6's paper default under its flags-built monitor."""
    import repro.obs as ref_obs

    variant = chip_smoke.HEALTH_VARIANT.replace("peeldevice+spandevice+", "")
    ref_flags.set_variant(variant)
    ref_obs.reset()
    try:
        monitor = ref_obs.HealthMonitor.from_flags()
        held = _ref_online_run(
            monkeypatch, RefSimulator(40, 50), _online_inputs()["fig6"],
            REF_ALGORITHMS["lmbr"], name="lmbr", seed=0, max_moves=120,
            events=list(chip_smoke.HEALTH_EVENTS[name]), auto_repair=False,
            health=monitor)
    finally:
        ref_flags.reset()
        ref_obs.reset()
    held["history"] = [[h["alert"], h["kind"], h["t"]]
                       for h in monitor.history]
    return held


def test_health_table():
    assert chip_smoke.PHASES[-2:] == ("health", "scale")
    assert list(chip_smoke.HEALTH_HELD) == list(chip_smoke.HEALTH_EVENTS)
    storm = chip_smoke.HEALTH_HELD["health-storm"]
    assert [(a, k) for a, k, _ in storm["history"]] == [
        ("degraded_rate", "fire"), ("degraded_rate", "resolve")]
    assert storm["alerts_fired"] == storm["alerts_resolved"] == 1
    assert storm["degraded_queries"] > 0
    clean = chip_smoke.HEALTH_HELD["health-clean"]
    assert clean["history"] == [] and clean["alerts_fired"] == 0
    assert clean["degraded_queries"] == 0
    # the storm is the one of the JAX package's health bench, at N 40
    assert chip_smoke.HEALTH_VARIANT.endswith(
        "routermb64+obscounters+obssnap100+obshealth1+healthw4"
        "+healthskew3.0")


@pytest.mark.parametrize("name", list(chip_smoke.HEALTH_EVENTS))
def test_health_reference_values(name, monkeypatch):
    assert _ref_health_held(name, monkeypatch) == \
        chip_smoke.HEALTH_HELD[name]


def test_port_generator_builds_the_health_input():
    got = chip_smoke.health_inputs(np)["fig6"]
    want = _online_inputs()["fig6"]
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()


# -------------------------------------------------------------------- scale
@functools.lru_cache(maxsize=None)
def _ref_scale_graph(fit):
    """The reference's hypergraph of one scale fit, built once a session."""
    return ref_core.web_scale_workload(
        **chip_smoke.SCALE_FITS[fit][0]).hypergraph


def _ref_scale_held(name):
    """The reference's values of one scale run (its fits serial)."""
    from repro.scale import StreamingHypergraphBuilder, fit_sharded_placement

    if name == "stream":
        held = {}
        for mode, merge in (("plain", False), ("merged", True)):
            builder = StreamingHypergraphBuilder(
                ref_core.WEB_SCALE_DEFAULTS["num_items"],
                merge_duplicates=merge)
            for ptr, pins in ref_core.web_scale_chunks(seed=0):
                builder.add_csr(ptr, pins)
            held[mode] = chip_smoke._csr_held(builder.build())
        return held
    fit = "web-mid" if name == "service" else name
    _, n, cap, fit_kw = chip_smoke.SCALE_FITS[fit]
    hg = _ref_scale_graph(fit)
    if name == "service":
        rng = np.random.default_rng(0)
        profile = ref_core.NodeProfile(
            capacity=np.full(24, 210.0),
            fail_prob=rng.uniform(0.005, 0.05, 24), power_idle=100.0,
            power_active=250.0, access_cost=rng.uniform(0, 1, 24))
        plan = ref_core.PlacementService("lmbr", seed=0).fit_sharded(
            hg, n, profile=profile, workers=1,
            durability_eps=chip_smoke.SCALE_SERVICE_EPS, **fit_kw)
        return dict(json_sha256=chip_smoke._sha256(plan.to_json()),
                    algorithm=plan.algorithm,
                    durability_copies=plan.stats["durability_copies"],
                    **{k: plan.stats[k] for k in chip_smoke.SCALE_STATS})
    with ref_hpa.fresh_partition_cache():
        res = fit_sharded_placement(hg, n, cap, seed=0, workers=1, **fit_kw)
    held = {k: res.stats[k] for k in chip_smoke.SCALE_STATS}
    held.update(
        member_sha256=chip_smoke._sha256(res.member.tobytes()),
        avg_span=float(ref_core.spans_for_workload(hg,
                                                   res.placement).mean()))
    return held


def test_scale_table():
    assert list(chip_smoke.SCALE_HELD) == list(chip_smoke.SCALE_RUNS)
    assert chip_smoke.SCALE_RUNS["stream"] == ()
    assert set(chip_smoke.SCALE_POOLED) <= set(chip_smoke.SCALE_FITS)
    held = chip_smoke.SCALE_HELD
    assert held["stream"]["plain"]["edges"] == 1_000_000
    assert held["stream"]["merged"]["edges"] < 1_000_000
    assert held["fit-quick"]["shards"] == 8 and held["web-mid"]["shards"] == 4
    assert held["service"]["algorithm"] == "lmbr+sharded"
    assert held["service"]["durability_copies"] > 0
    for name in ("fit-quick", "web-mid"):
        assert held[name]["repair_moves"] > 0
        assert held[name]["boundary_edges"] > 0


@pytest.mark.parametrize("name", list(chip_smoke.SCALE_RUNS))
def test_scale_reference_values(name):
    assert _ref_scale_held(name) == chip_smoke.SCALE_HELD[name]


def test_port_generators_build_the_scale_inputs():
    got = chip_smoke.scale_inputs(np)
    assert list(got) == list(chip_smoke.SCALE_FITS)
    for name in chip_smoke.SCALE_FITS:
        want = _ref_scale_graph(name)
        for col in ("edge_ptr", "edge_nodes", "node_weights",
                    "edge_weights"):
            assert (getattr(got[name], col).tobytes()
                    == getattr(want, col).tobytes()), (name, col)
    profile = chip_smoke.scale_service_profile(np)
    rng = np.random.default_rng(0)
    assert profile.fail_prob.tobytes() == rng.uniform(0.005, 0.05,
                                                      24).tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_peel_equals_the_plain_version(seed):
    """The port's plain lockstep peel, which walks only the edges that die
    in a round (what the CPU twins run), gives the JAX package's float64
    oracle's trajectories exactly: 0/1 cells, integer weights (heavy ones
    included), padded slots, empty pairs and ties, and one batch of the
    kernels phase's generator at a scale fit's global-class cell (K 2048,
    U 512)."""
    import torch

    from repro.kernels.lockstep_peel.ref import lockstep_peel_ref
    from repro_torch.kernels.lockstep_peel.ops import lockstep_peel_plain

    def check(args, label):
        got = lockstep_peel_plain(*args)
        assert got[0].dtype == torch.int32, label
        assert got[1].dtype == got[2].dtype == torch.float32, label
        want = lockstep_peel_ref(*(a.numpy() for a in args))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy().astype(w.dtype), w), label

    rng = np.random.default_rng(seed)
    for trial in range(60):
        G = int(rng.integers(1, 9))
        K = int(rng.choice([4, 8, 16, 64, 128]))
        U = int(rng.choice([4, 8, 32, 64]))
        nv = rng.integers(0, U + 1, size=G).astype(np.int32)
        inc = (rng.random((G, K, U)) < rng.uniform(0.02, 0.6)).astype(
            np.float32)
        inc *= np.arange(U)[None, None, :] < nv[:, None, None]
        we = rng.integers(0, 1000 if trial % 3 == 0 else 3,
                          size=(G, K)).astype(np.float32)
        nodew = rng.integers(1, 4, size=(G, U)).astype(np.float32)
        check([torch.from_numpy(x) for x in (inc, we, nodew, nv)], trial)
    check(chip_smoke._peel_inputs(np, torch, rng, 2, 2048, 512, "cpu"),
          "G2.K2048.U512")

"""``chip_smoke.py``'s tables against the JAX package: every paper-algos
row's avg_span is what the reference's ``Simulator.run`` gives on the CPU,
every placement-api value is what the reference's service, 3-way and
bridge calls give there, every online value is what the reference's
router, ``run_online`` and ``refit(as_migration=True)`` give there, and
the port's generators build the reference's inputs, so the card run is
held to the reference without importing it."""

import functools
import re
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
    # a twin kept as its recorded dispatch is a fit whose member the
    # reference pins, counted for every kernel, each it needs called; a
    # fit of the same code keeps its twin
    assert list(chip_smoke.SCALE_DISPATCH) == ["fit-quick"]
    for name, dispatch in chip_smoke.SCALE_DISPATCH.items():
        assert name in chip_smoke.SCALE_FITS and "member_sha256" in held[name]
        assert set(dispatch) == {"span_gain", "cover_rounds",
                                 "lockstep_peel"}
        assert all(dispatch[k] > 0 for k in chip_smoke.SCALE_RUNS[name])
    assert "web-mid" not in chip_smoke.SCALE_DISPATCH


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


# ------------------------------------------------------- the dense slice
def _source(name):
    return (ROOT / "src" / "repro_torch" / "csrc" / name).read_text()


def test_decode_group_limits_match_the_kernel_source():
    from repro_torch.kernels.decode_attention.ops import (BLOCK_GROUP,
                                                          MAX_GROUP,
                                                          head_groups)
    src = _source("decode_attention.cu")
    limits = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                  src).group(1))
              for name in ("kMaxG", "kBlockG")}
    assert limits == {"kMaxG": MAX_GROUP, "kBlockG": BLOCK_GROUP}
    # glm4-9b's 32 / 2 query heads per KV head fit, in two head groups
    assert MAX_GROUP >= 16 and head_groups(16) == 2
    # the launch switch has one instance per head-group size 1..kBlockG
    cases = re.findall(r"REPRO_DECODE_G\((\d+)\)", src)
    assert sorted(map(int, cases)) == list(range(1, BLOCK_GROUP + 1))


def test_flash_head_dims_match_the_kernel_dispatch():
    from repro_torch.kernels.flash_attention.ops import _HEAD_DIMS, instance
    src = _source("flash_attention.cu")
    body = src[src.index('extern "C" int flash_attention_launch'):]
    pairs = set(re.findall(r"dtype == (\d) && D == (\d+)", body))
    assert pairs == {(dt, str(d)) for dt in "01" for d in _HEAD_DIMS}
    assert [d for d in _HEAD_DIMS if d not in (32, 64)] == [80, 128]
    # bf16 at the dense configs' dims (and hymba's 64) runs the tensor-core
    # instance, f32 the CUDA-core one, as the source's dispatch says
    import torch
    wgmma = re.findall(r"dtype == 1 && D == (\d+)\)\s*return \(int\)"
                       r"launch_wgmma<(\d+)>", body)
    assert sorted((int(a), int(b)) for a, b in wgmma) == sorted(
        (d, d) for d in chip_smoke.WGMMA_HEAD_DIMS)
    for d in _HEAD_DIMS:
        want = "wgmma" if d in chip_smoke.WGMMA_HEAD_DIMS else "fma"
        assert instance(torch.bfloat16, d) == want
        assert instance(torch.float32, d) == "fma"
    for d in (80, 128):
        assert instance(torch.bfloat16, d) == "wgmma"


def test_serve_dense_configs_are_the_reference_configs():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    from repro_torch.models import layer_windows

    archs = {row[0] for row in chip_smoke.DENSE_SERVES}
    assert archs == {"glm4-9b", "olmo-1b", "h2o-danube-1.8b",
                     "nemotron-4-15b"}
    for arch, layers, requests, decode_len in chip_smoke.DENSE_SERVES:
        cfg, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.family == "dense"
        assert layers is None or layers < ref.num_layers
    # glm4-9b at its published depth, with serve's traffic
    assert chip_smoke.DENSE_SERVES[0] == (
        "glm4-9b", None, chip_smoke.SERVE["requests"],
        chip_smoke.SERVE["decode_len"])
    assert ref_get_config("glm4-9b").num_layers == 40
    assert {a for a, _ in chip_smoke.DENSE_CHECKS} <= archs
    # the kernel rows sit at each config's (H, K, D) and window
    for table in (chip_smoke.DENSE_FLASH, chip_smoke.DENSE_DECODE):
        assert {row[0] for row in table} == archs
        for label, h, k, d, windows in table:
            ref = ref_get_config(label)
            assert (h, k, d) == (ref.num_heads, ref.num_kv_heads,
                                 ref.resolved_head_dim)
            assert windows[0] is None
            assert all(w is None for w in layer_windows(
                get_config(label))) == (len(windows) == 1)


def test_flash_edge_rows_reach_the_tensor_core_instance_edges():
    import torch

    from repro.configs import get_config as ref_get_config
    from repro_torch.kernels.flash_attention.ops import instance

    dims = {}
    for label, b, s, h, k, d, windows in chip_smoke.DENSE_FLASH_EDGES:
        # a dense config's (H, K, D), on the tensor-core instance in bf16
        assert any((h, k, d) == (r.num_heads, r.num_kv_heads,
                                 r.resolved_head_dim)
                   for r in map(ref_get_config,
                                (row[0] for row in chip_smoke.DENSE_FLASH)))
        assert instance(torch.bfloat16, d) == "wgmma"
        assert windows[0] is None and len(windows) == 2
        dims.setdefault(label, set()).add(d)
        if label == "window40":
            # under one 64-key tile: whole tiles skipped per warpgroup
            assert windows[1] < 64 and s % 128 == 0
        else:
            # no tile size divides the ragged length
            assert s == 1528 and s % 64 and windows[1] == 1024
    assert dims == {"window40": {80, 128}, "ragged": {80}}


def test_build_requirements_name_the_instances():
    # every tensor-core flash instance is held to no spills by the build
    # phase; the CUDA-core instances it must find are the dense configs'
    # f32 flash and bf16 decode ones, and glm4-9b's decode may not spill
    assert sorted(chip_smoke.WGMMA_HEAD_DIMS) == [64, 80, 128]
    assert ("flash", "f32", 128) in chip_smoke.DENSE_INSTANCES
    assert ("flash", "f32", 80) in chip_smoke.DENSE_INSTANCES
    assert not any(dt == "bf16" and kind == "flash"
                   for kind, dt, _ in chip_smoke.DENSE_INSTANCES)
    assert chip_smoke.DENSE_NO_SPILL == (("decode", "bf16", 8),)
    assert set(chip_smoke.DENSE_NO_SPILL) <= set(chip_smoke.DENSE_INSTANCES)
    assert chip_smoke._wgmma_instance(
        "_ZN12_GLOBAL__N_128flash_attention_wgmma_kernelILi80EEEvPK13"
        "__nv_bfloat16") == ("flash", "bf16", 80)
    assert chip_smoke._attention_instance(
        "_ZN12_GLOBAL__N_128flash_attention_wgmma_kernelILi80EEEv") is None


# ------------------------------------------------------- the pure-SSM slice
def test_serve_ssm_config_and_traffic_are_the_reference_ones():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import block_kind

    arch = chip_smoke.SSM_ARCH
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert arch == "mamba2-2.7b"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert block_kind(cfg) == "ssm"
    # serve's traffic at the published depth; the check phase at the
    # published widths, cut in depth only
    assert ref.num_layers == 64
    assert chip_smoke.SERVE == dict(batch=8, requests=16, prefill_len=2048,
                                    decode_len=64)
    assert 1 <= chip_smoke.SSM_CHECK_LAYERS < ref.num_layers
    # the serving row sits at the config's SSM widths
    rows = dict((label, (nh, n)) for label, nh, n in chip_smoke.SSD_SERVING)
    s = ref.ssm
    assert rows[arch] == (ref.d_model * s.expand // s.head_dim, s.state_dim)
    hymba = ref_get_config("hymba-1.5b")
    assert rows["hymba-1.5b"] == (
        hymba.d_model * hymba.ssm.expand // hymba.ssm.head_dim,
        hymba.ssm.state_dim)
    assert s.head_dim == hymba.ssm.head_dim == 64
    assert s.chunk_size == hymba.ssm.chunk_size == 256


def test_ssd_rows_sit_inside_the_kernel_domain():
    from repro_torch.kernels.ssd_scan.ops import kernel_takes, run_chunk

    for label, B, S, H, P, N, L in chip_smoke.SSD_DOMAIN:
        assert kernel_takes(P, N, L), label
    for _, _, n in chip_smoke.SSD_SERVING:
        assert kernel_takes(64, n, 256)
    assert not kernel_takes(*chip_smoke.SSD_REFUSED)
    # mamba2's widths run at chunk 128, at the requested chunk and over a
    # ragged prefill; some row runs below its requested chunk besides
    rows = {label: row for label, *row in chip_smoke.SSD_DOMAIN}
    for label in ("N128.L256", "mamba2-ragged"):
        B, S, H, P, N, L = rows[label]
        assert (H, P, N, L) == (80, 64, 128, 256) and run_chunk(N, L) == 128
    assert rows["mamba2-ragged"][1] % 128 != 0
    assert any(run_chunk(N, L) not in (L, 128)
               for _, _, _, _, _, N, L in chip_smoke.SSD_DOMAIN)


def test_ssd_bound_counts_each_product_at_its_peak():
    # the data sheet's dense peaks (H100 SXM, 700 W)
    assert chip_smoke.FP32_OPS_PER_S == 67e12
    assert chip_smoke.TF32_OPS_PER_S == 495e12
    assert chip_smoke.BF16_OPS_PER_S == 989e12
    B, S, P, Lr = 8, 2048, 64, 128
    for bf16 in (True, False):
        for _, nh, n in chip_smoke.SSD_SERVING:
            work = chip_smoke._ssd_work(bf16, B, S, nh, P, n, Lr)
            fp32, tf32, bf = work
            assert fp32[1] == chip_smoke.FP32_OPS_PER_S
            assert tf32[1] == chip_smoke.TF32_OPS_PER_S
            assert bf[1] == chip_smoke.BF16_OPS_PER_S
            assert (bf[0] > 0) == bf16
            # the tensor-core parts are three products each: a third of
            # them, with the fp32 part, is the scan's own work
            chunks = B * nh * (S // Lr)
            tri = Lr * (Lr + 1) / 2
            own = chunks * (tri * 2 * (n + P) + 4 * Lr * P * n + 2 * P * n)
            assert fp32[0] + (tf32[0] + bf[0]) / 3 == pytest.approx(own)
            assert fp32[0] == chunks * (2 * Lr * P * n + 2 * P * n)
            # the parts run one after another; no bytes, so ops bound it
            ms, by = chip_smoke._bound_ms_by_type(0.0, work)
            assert by == "operations"
            assert ms == pytest.approx(
                sum(o / p for o, p in work) * 1e3)
            assert ms < chip_smoke._bound_ms(0.0, own)[0]


def test_phase_order_keeps_health_and_scale_last():
    phases = chip_smoke.PHASES
    assert phases[-2:] == ("health", "scale")
    assert phases.index("serve-ssm") + 1 == phases.index("serve-ssm-check")
    assert phases.index("serve-dense-check") < phases.index("serve-ssm")
    assert len(set(phases)) == len(phases)


# ------------------------------------------------------------ the MoE slice
def test_serve_moe_config_is_the_reference_config():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import block_kind

    arch = chip_smoke.MOE_ARCH
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert arch == "qwen3-moe-30b-a3b"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert block_kind(cfg) == "moe"
    # serve's traffic at the published depth; the check phase at the
    # published widths, cut in depth only
    assert ref.num_layers == 48 and ref.moe.first_k_dense == 0
    assert 1 <= chip_smoke.MOE_CHECK_LAYERS < ref.num_layers
    assert chip_smoke.SERVE == dict(batch=8, requests=16, prefill_len=2048,
                                    decode_len=64)


def test_phase_order_puts_the_moe_phases_before_health():
    phases = chip_smoke.PHASES
    assert phases.index("serve-ssm-check") + 1 == phases.index("serve-moe")
    assert phases.index("serve-moe") + 1 == phases.index("serve-moe-check")
    # then the MLA phases, then the training ones, then health
    i = phases.index("serve-moe-check")
    assert phases[i:i + 10] == ("serve-moe-check", "serve-mla",
                                "serve-mla-check", "train", "train-check",
                                "train-ssm", "train-ssm-check", "train-mla",
                                "train-mla-check", "health")
    assert phases[-2:] == ("health", "scale")


def test_moe_kernel_rows_sit_at_the_config_shapes():
    import torch

    from repro.configs import get_config as ref_get_config
    from repro_torch.kernels.decode_attention.ops import head_groups
    from repro_torch.kernels.flash_attention.ops import instance

    ref = ref_get_config(chip_smoke.MOE_ARCH)
    for table in (chip_smoke.MOE_FLASH, chip_smoke.MOE_DECODE):
        assert len(table) == 1
        label, h, k, d, windows = table[0]
        assert label == chip_smoke.MOE_ARCH
        assert (h, k, d) == (ref.num_heads, ref.num_kv_heads,
                             ref.resolved_head_dim) == (32, 4, 128)
        assert windows == (None,) and ref.sliding_window is None
    # prefill on the tensor-core instance, decode in one head group of 8
    assert instance(torch.bfloat16, 128) == "wgmma"
    assert head_groups(32 // 4) == 1
    # the bounds at qwen3's shapes: flash's ops as glm4-9b's (same H and D),
    # decode's full-cache bytes at B 8, T 2112, K 4, D 128, bf16
    B, S, T = 8, 2048, 2112
    pairs = S * (S + 1) / 2
    flash, by = chip_smoke._bound_ms(0.0, 4.0 * 128 * pairs * B * 32,
                                     chip_smoke.BF16_OPS_PER_S)
    assert by == "operations" and flash == pytest.approx(0.2781, abs=1e-4)
    dec = 2 * B * 4 * T * 128 * 2 / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert dec == pytest.approx(0.0103, abs=1e-4)


def test_moe_refit_spans_are_the_reference_ones():
    cfg = chip_smoke.MOE_ARCH
    from repro.configs import get_config as ref_get_config

    m = ref_get_config(cfg).moe
    trace = ref_core.synthetic_routing_trace(m.num_experts, 200,
                                             top_k=m.top_k, seed=1)
    slots = m.num_experts // 4 + 2
    plan = ref_core.plan_expert_placement(trace, m.num_experts, 4, slots,
                                          algorithm="lmbr")
    base = ref_core.baseline_contiguous_placement(m.num_experts, 4, slots)
    assert (base.avg_span(trace), plan.avg_span(trace)) == \
        chip_smoke.MOE_REFIT
    # the port's refit on the CPU gives the same plan
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import expert_refit

    got_base, got_span, got_plan = expert_refit(get_config(cfg),
                                                device="cpu")
    assert (got_base, got_span) == chip_smoke.MOE_REFIT
    assert (got_plan.member == plan.member).all()
    assert got_plan.slot_to_expert.shape == (4, slots)


# ------------------------------------------------------------ the MLA slice
def test_serve_mla_config_is_the_reference_config():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import block_kind

    arch = chip_smoke.MLA_ARCH
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert arch == "deepseek-v3-671b"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert block_kind(cfg) == "moe" and ref.attention == "mla"
    # cut in depth only: the dense layers and one MoE layer for serve-mla,
    # the dense layers alone for serve-mla-check
    kd = ref.moe.first_k_dense
    assert chip_smoke.MLA_LAYERS == kd + 1 == 4
    assert chip_smoke.MLA_CHECK_LAYERS == kd == 3
    # the latent kernels' widths and scale are the config's
    m = ref.mla
    assert (chip_smoke.MLA_HEADS, chip_smoke.MLA_RANK,
            chip_smoke.MLA_ROPE) == (ref.num_heads, m.kv_lora_rank,
                                     m.qk_rope_head_dim)
    assert chip_smoke.MLA_SCALE == (m.qk_nope_head_dim
                                    + m.qk_rope_head_dim) ** -0.5


def test_mla_kernel_rows_sit_at_serve_shapes():
    serve = chip_smoke.SERVE
    H = chip_smoke.MLA_HEADS
    # the serve row comes first: it is the row of the kernels line
    assert chip_smoke.MLA_FLASH[0] == ("serve", serve["batch"],
                                       serve["prefill_len"], H)
    assert chip_smoke.MLA_DECODE[0] == (
        "serve", serve["batch"], serve["prefill_len"] + serve["decode_len"],
        H)
    # serve-mla-check's prefill length and serve's warm-up cache
    assert ("ragged", 2, 1528, H) in chip_smoke.MLA_FLASH
    assert ("warm-up", 1, 18, H) in chip_smoke.MLA_DECODE
    assert all(s % 64 and s % 32 for _, _, s, _ in chip_smoke.MLA_FLASH[1:])
    # a row whose 64-row blocks span positions: H not a multiple of 64,
    # and more than one position a block
    small = [(b, s, h) for _, b, s, h in chip_smoke.MLA_FLASH if h % 64]
    assert small == [(1, 77, 3)] and 64 // 3 > 1
    # decode's small-H row: a partial row tile and, in bf16, 13 splits of
    # one 64-slot tile, the last partial; batch row 1's first 128 slots
    # (two splits) are empty, so those splits see no visible slot
    import inspect

    from repro_torch.kernels.decode_attention.ops import latent_split_plan
    small = [row for row in chip_smoke.MLA_DECODE if row[3] % 64]
    assert small == [("small-H", 2, 777, 3)]
    assert latent_split_plan(2, 3, 777, 132, 64) == (13, 64) and 777 % 64
    src = inspect.getsource(chip_smoke._latent_rows)
    assert 'kv_pos[1, :30 if label == "serve" else 128] = -1' in src


def test_mla_bounds():
    bf16, f32 = chip_smoke.BF16_OPS_PER_S, chip_smoke.FP32_OPS_PER_S
    B, S, H = 8, 2048, 128
    # 2 B H S (S + 1) / 2 (576 + 512) flops: 4.68e12, 4.73 ms of bf16
    ms, by = chip_smoke._latent_prefill_bound(B, S, H, 2, bf16)
    assert by == "operations"
    assert ms == pytest.approx(4.675e12 / bf16 * 1e3, rel=1e-3)
    assert ms == pytest.approx(4.727, abs=1e-3)
    ms32, by32 = chip_smoke._latent_prefill_bound(B, S, H, 4, f32)
    assert by32 == "operations" and ms32 == pytest.approx(ms * bf16 / f32)
    # decode over a full cache: 19.5 MB of latent rows, plus q, out and
    # the positions, bound by bytes
    T = 2112
    ms, by = chip_smoke._latent_decode_bound(B, T, H, B * T, 2, bf16)
    rows = B * T * 576 * 2
    assert rows == pytest.approx(19.46e6, rel=1e-3)
    extra = B * T * 4 + B * 4 + B * H * (512 + 576) * 2
    assert by == "bytes"
    assert ms == pytest.approx((rows + extra) / chip_smoke.HBM_BYTES_PER_S
                               * 1e3)
    assert 0.0058 < ms < 0.0066


def test_mla_refit_spans_are_the_reference_ones():
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import expert_refit

    arch = chip_smoke.MLA_ARCH
    m = ref_get_config(arch).moe
    trace = ref_core.synthetic_routing_trace(m.num_experts, 200,
                                             top_k=m.top_k, seed=1)
    slots = m.num_experts // 4 + 2
    assert slots == 66
    plan = ref_core.plan_expert_placement(trace, m.num_experts, 4, slots,
                                          algorithm="lmbr")
    base = ref_core.baseline_contiguous_placement(m.num_experts, 4, slots)
    assert (base.avg_span(trace), plan.avg_span(trace)) == \
        chip_smoke.MLA_REFIT
    got_base, got_span, got_plan = expert_refit(get_config(arch),
                                                device="cpu")
    assert (got_base, got_span) == chip_smoke.MLA_REFIT
    assert (got_plan.member == plan.member).all()


def test_mla_instances_are_parsed_from_their_mangled_names():
    names = {
        "_ZN49_GLOBAL__N__c8312cf2_16_mla_attention_cu_38189a8120mla_"
        "attention_kernelIfLb1EEEvNS_4ArgsE": ("f32", "decode", "fma"),
        "_ZN49_GLOBAL__N__c8312cf2_16_mla_attention_cu_38189a8120mla_"
        "attention_kernelIfLb0EEEvNS_4ArgsE": ("f32", "prefill", "fma"),
        "_ZN49_GLOBAL__N__c8312cf2_16_mla_attention_cu_38189a8126mla_"
        "attention_wgmma_kernelILb0EEEvNS_4ArgsEi": ("bf16", "prefill",
                                                    "wgmma"),
        "_ZN49_GLOBAL__N__c8312cf2_16_mla_attention_cu_38189a8126mla_"
        "attention_wgmma_kernelILb1EEEvNS_4ArgsEi": ("bf16", "decode",
                                                    "wgmma"),
    }
    for entry, want in names.items():
        assert chip_smoke._mla_instance(entry) == want
        # no other instance parser takes them
        assert chip_smoke._attention_instance(entry) is None
        assert chip_smoke._wgmma_instance(entry) is None
    assert chip_smoke._mla_instance(
        "_ZN12_GLOBAL__N_123mla_decode_merge_kernelIfEEvPKfPT_i") is None
    # a bf16 CUDA-core instance still parses (as one the build refuses)
    assert chip_smoke._mla_instance(
        "_ZN12_GLOBAL__N_120mla_attention_kernelI13__nv_bfloat16Lb1EEEvNS_"
        "4ArgsE") == ("bf16", "decode", "fma")
    # the build requires these four, one each; bf16 runs on the
    # tensor-core kernel in prefill and decode (the wrappers' dispatch),
    # and neither bf16 instance may spill
    import torch

    from repro_torch.kernels.decode_attention.ops import (
        latent_decode_instance)
    from repro_torch.kernels.flash_attention.ops import latent_instance
    assert sorted(chip_smoke.MLA_INSTANCES) == sorted(names.values())
    pick = {"prefill": latent_instance, "decode": latent_decode_instance}
    for dt, kind, route in chip_smoke.MLA_INSTANCES:
        dtype = (torch.bfloat16 if dt == "bf16" else torch.float32)
        assert pick[kind](dtype) == route
    assert chip_smoke.MLA_NO_SPILL == (("bf16", "prefill", "wgmma"),
                                       ("bf16", "decode", "wgmma"))


def test_mla_serving_phases_require_the_latent_decode_instances():
    import inspect

    # serve-mla: 4 layers x 64 steps x 2 batches, all on the tensor-core
    # kernel; serve-mla-check: 3 layers x 8 decode steps, all on the
    # CUDA-core one (its f32 route)
    serve = chip_smoke.SERVE
    assert (chip_smoke.MLA_LAYERS * serve["decode_len"]
            * serve["requests"] // serve["batch"]) == 512
    src = inspect.getsource(chip_smoke.phase_serve_mla)
    assert '"decode_attention_latent": L * SERVE["decode_len"] * nb' in src
    assert re.search(r'decode_instances == \{\s*"wgmma": want\['
                     r'"decode_attention_latent"\], "fma": 0\}', src)
    src = inspect.getsource(chip_smoke.phase_serve_mla_check)
    assert "B, S, n_prefill = 2, 1536, 1528" in src
    assert chip_smoke.MLA_CHECK_LAYERS * (1536 - 1528) == 24
    assert '"decode_attention_latent": (S - n_prefill) * L' in src
    assert re.search(r'decode_instances == \{\s*"wgmma": 0, "fma": '
                     r'want\["decode_attention_latent"\]\}', src)
    assert 'held["instance_launches"]["decode_attention_latent"]' in src


# ------------------------------------- the encoder-decoder and VLM slice
FRONTEND_PHASES = ("serve-encdec", "serve-encdec-check", "serve-vlm",
                   "serve-vlm-check")


def test_frontend_configs_are_the_reference_configs():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    assert (chip_smoke.ENCDEC_ARCH, chip_smoke.VLM_ARCH) == (
        "seamless-m4t-medium", "internvl2-2b")
    for arch in (chip_smoke.ENCDEC_ARCH, chip_smoke.VLM_ARCH):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_get_config(arch))
    # the -check phases cut depth only: 4 layers (seamless 4 + 4)
    checks = chip_smoke.FRONTEND_CHECKS
    assert set(checks) == {"serve-encdec-check", "serve-vlm-check"}
    arch, overrides, frames, S, n_prefill = checks["serve-encdec-check"]
    assert arch == chip_smoke.ENCDEC_ARCH
    assert overrides == dict(num_layers=4, encoder_layers=4)
    assert (frames, S, n_prefill) == (1000, 768, 760)
    arch, overrides, patches, S, n_prefill = checks["serve-vlm-check"]
    assert arch == chip_smoke.VLM_ARCH and overrides == dict(num_layers=4)
    assert patches == ref_get_config(arch).frontend_len == 256
    assert (S, n_prefill) == (1536, 1528) and n_prefill >= patches


def test_phase_order_puts_the_frontend_phases_after_the_dense_ones():
    phases = chip_smoke.PHASES
    i = phases.index("serve-dense-check")
    assert phases[i + 1:i + 6] == FRONTEND_PHASES + ("serve-ssm",)
    assert len(set(phases)) == len(phases)


def test_frontend_launch_counts_follow_the_configs():
    from repro.configs import get_config as ref_get_config

    serve = chip_smoke.SERVE
    batches = -(-serve["requests"] // serve["batch"])
    steps = serve["decode_len"]
    # seamless: per batch 12 encoder layers, then 12 decoder layers of
    # self- and cross-attention in prefill and in every decode step
    enc = ref_get_config(chip_smoke.ENCDEC_ARCH)
    assert (enc.encoder_layers, enc.num_layers) == (12, 12)
    flash = (enc.encoder_layers + 2 * enc.num_layers) * batches
    decode = 2 * enc.num_layers * steps * batches
    assert (flash, decode) == (72, 3072)
    assert chip_smoke.frontend_launches(enc, batches, steps) == dict(
        flash_attention=flash, decode_attention=decode)
    # internvl2: one self-attention a layer
    vlm = ref_get_config(chip_smoke.VLM_ARCH)
    assert (vlm.encoder_layers, vlm.num_layers) == (0, 24)
    assert chip_smoke.frontend_launches(vlm, batches, steps) == dict(
        flash_attention=vlm.num_layers * batches,
        decode_attention=vlm.num_layers * steps * batches) == dict(
        flash_attention=48, decode_attention=3072)
    # the -check phases: a forward and a prefill (4 + 2 x 4 flash each for
    # seamless), then 8 decode steps
    import dataclasses
    for phase, (flash, decode) in (("serve-encdec-check", (24, 64)),
                                   ("serve-vlm-check", (8, 32))):
        arch, overrides, _, S, n_prefill = chip_smoke.FRONTEND_CHECKS[phase]
        cfg = dataclasses.replace(ref_get_config(arch), **overrides)
        assert chip_smoke.frontend_launches(cfg, 2, 0)["flash_attention"] \
            == flash
        assert chip_smoke.frontend_launches(
            cfg, 1, S - n_prefill)["decode_attention"] == decode


def test_frontend_check_decode_positions_lie_below_the_frames():
    _, _, frames, S, n_prefill = \
        chip_smoke.FRONTEND_CHECKS["serve-encdec-check"]
    # every decode position sees frames past itself, so a query at the
    # decoder's position would hide some
    assert all(t < frames - 1 for t in range(n_prefill, S))
    # the prefill's cross-attention runs at S != T, neither a multiple of
    # the 64-key tile or the 128-row block
    assert n_prefill != frames and n_prefill % 64 and frames % 64
    # the kernels phase's wrong decode variant sits at those positions
    B = chip_smoke.CROSS_DECODE[0][1]
    assert chip_smoke.CROSS_DECODE_LOW_POS == n_prefill
    assert chip_smoke.CROSS_DECODE_LOW_POS + B - 1 < \
        chip_smoke.CROSS_DECODE[0][2] - 1


def test_frontend_kernel_rows_sit_at_the_config_shapes():
    from repro.configs import get_config as ref_get_config

    enc = ref_get_config(chip_smoke.ENCDEC_ARCH)
    vlm = ref_get_config(chip_smoke.VLM_ARCH)
    serve = chip_smoke.SERVE
    B, P = serve["batch"], serve["prefill_len"]
    e_heads = (enc.num_heads, enc.num_kv_heads, enc.resolved_head_dim)
    v_heads = (vlm.num_heads, vlm.num_kv_heads, vlm.resolved_head_dim)
    assert e_heads == (16, 16, 64) and v_heads == (16, 8, 128)
    F = enc.frontend_len
    _, _, frames, _, n_prefill = \
        chip_smoke.FRONTEND_CHECKS["serve-encdec-check"]
    rows = {r[0]: r[1:] for r in chip_smoke.FRONTEND_FLASH}
    assert rows == {
        "seamless-encoder": (B, F, F) + e_heads + (False, False),
        "seamless-cross": (B, P, F) + e_heads + (False, False),
        "ragged-cross": (2, n_prefill, frames) + e_heads + (False, True),
        "internvl2-2b": (B, P, P) + v_heads + (True, False),
    }
    assert chip_smoke.CROSS_DECODE == (("seamless-cross", B, F)
                                       + e_heads,)
    assert chip_smoke.VLM_DECODE == (("internvl2-2b",) + v_heads
                                     + ((None,),),)
    # bf16 at D 64 and 128 on the tensor-core instance; the f32 ragged
    # cross row on the CUDA-core one
    import torch

    from repro_torch.kernels.flash_attention.ops import instance
    assert instance(torch.bfloat16, 64) == instance(torch.bfloat16, 128) \
        == "wgmma"
    assert instance(torch.float32, 64) == "fma"


def test_frontend_bounds():
    import torch

    bf16, hbm = chip_smoke.BF16_OPS_PER_S, chip_smoke.HBM_BYTES_PER_S
    want = {"seamless-encoder": 0.0347, "seamless-cross": 0.0695,
            "internvl2-2b": 0.1391}
    for label, B, S, T, H, K, D, causal, _ in chip_smoke.FRONTEND_FLASH:
        mask, pairs = chip_smoke._flash_pairs(torch, "cpu", S, T, causal,
                                              None)
        # non-causal: every (query, key) pair, no mask; causal: S (S + 1) / 2
        assert pairs == (S * (S + 1) / 2 if causal else S * T)
        assert (mask is None) == (not causal)
        ms, by = chip_smoke._bound_ms(
            (2 * B * S * H * D + 2 * B * T * K * D) * 2,
            4.0 * D * pairs * B * H, bf16)
        if label in want:
            assert by == "operations"
            assert ms == pytest.approx(want[label], abs=1e-4)
    # cross decode: the encoder's k and v, every slot, are the bytes
    _, B, T, H, K, D = chip_smoke.CROSS_DECODE[0]
    kv = 2 * B * T * K * D * 2
    ms, by = chip_smoke._bound_ms(kv + B * T * 4 + B * 4 + 2 * B * H * D * 2,
                                  4.0 * D * H * B * T, bf16)
    assert by == "bytes" and ms == pytest.approx(0.0100, abs=1e-4)
    assert kv / hbm * 1e3 == pytest.approx(0.0100, abs=1e-4)
    # internvl2's decode over a full serving cache, bytes
    label, H, K, D, _ = chip_smoke.VLM_DECODE[0]
    T = chip_smoke.SERVE["prefill_len"] + chip_smoke.SERVE["decode_len"]
    assert 2 * 8 * T * K * D * 2 / hbm * 1e3 == pytest.approx(0.0207,
                                                              abs=1e-4)


# ------------------------------------------------------ the training slice
def test_phase_order_puts_the_training_phases_after_serving():
    phases = chip_smoke.PHASES
    i = phases.index("serve-mla-check")
    assert phases[i + 1:] == ("train", "train-check", "train-ssm",
                              "train-ssm-check", "train-mla",
                              "train-mla-check", "health", "scale")


def test_train_phase_is_olmo_at_full_width_and_depth():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    train = chip_smoke.TRAIN
    # the reference's trainer test trains olmo-1b (tests/test_e2e_train.py)
    assert train["arch"] == "olmo-1b"
    assert "olmo-1b" in (ROOT / "tests" / "test_e2e_train.py").read_text()
    cfg = get_config(train["arch"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_get_config(train["arch"]))
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.dtype) == (16, 2048, 16, 16, 128,
                                                  "bfloat16")
    assert (train["batch"], train["seq"], train["steps"], train["lr"]) == (
        8, 1024, 8, 3e-4)
    # a remat step runs each block's forward twice and its backward once
    assert chip_smoke.train_launches(cfg, 1) == dict(forward=32, backward=16)
    assert chip_smoke.train_launches(cfg, train["steps"]) == dict(
        forward=256, backward=128)
    check = chip_smoke.TRAIN_CHECK
    assert check == dict(layers=2, batch=4, seq=1024)


def test_train_cli_runs_the_reference_e2e_arguments():
    text = (ROOT / "tests" / "test_e2e_train.py").read_text()
    args = re.findall(r'"(--[a-z-]+)"(?:, "([^"-][^"]*)")?', text.split(
        "def test_serve_driver")[0])
    want = []
    for flag, value in args:
        if flag != "--ckpt-dir":
            want += [flag] + ([value] if value else [])
    assert list(chip_smoke.TRAIN_CLI) == want
    assert "--device" not in chip_smoke.TRAIN_CLI   # the card, by default


def test_flash_backward_rows_sit_at_the_configs_shapes():
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduce_config as ref_reduce_config

    rows = {r[0]: r[1:] for r in chip_smoke.FLASH_BWD}
    olmo, glm4 = ref_get_config("olmo-1b"), ref_get_config("glm4-9b")
    train = chip_smoke.TRAIN
    assert rows["olmo-1b"] == (train["batch"], train["seq"], train["seq"],
                               olmo.num_heads, olmo.num_kv_heads,
                               olmo.resolved_head_dim, True, None,
                               ("bf16", "f32"))
    assert rows["glm4-9b"][3:6] == (glm4.num_heads, glm4.num_kv_heads,
                                    glm4.resolved_head_dim) == (32, 2, 128)
    for label, d in (("D64.window", 64), ("D80.window", 80)):
        b, s, t, h, k, dd, causal, window, _ = rows[label]
        assert dd == d and causal and window == 1024 < s == t
    assert rows["ragged"][1] == rows["ragged"][2] == 1000
    _, _, frames, _, n_prefill = \
        chip_smoke.FRONTEND_CHECKS["serve-encdec-check"]
    assert rows["noncausal"][1:3] == (n_prefill, frames) == (760, 1000)
    assert rows["noncausal"][6] is False
    red = ref_reduce_config(olmo, dtype="float32")
    cli = chip_smoke.TRAIN_CLI
    batch, seq = (int(cli[cli.index(f) + 1]) for f in ("--batch", "--seq"))
    assert rows["reduced"] == (batch, seq, seq, red.num_heads,
                               red.num_kv_heads, red.resolved_head_dim,
                               True, None, ("f32",))
    assert red.num_heads // red.num_kv_heads == 4
    # every (dtype, D) instance of the backward's dispatch runs in some row,
    # so every kernel the build makes runs
    ran = {(dt, r[6]) for r in chip_smoke.FLASH_BWD for dt in r[9]}
    assert set(chip_smoke.BWD_DISPATCH) == ran
    assert {(dt, d) for p, dt, d, _ in chip_smoke.BWD_INSTANCES
            if p != "delta"} == ran
    assert {inst for r in chip_smoke.FLASH_BWD for dt in r[9]
            for inst in [chip_smoke.BWD_DISPATCH[dt, r[6]]]} == {"wgmma",
                                                                "fma"}


def test_flash_backward_bound_at_olmos_shape():
    import torch

    B, S, T, H, K, D = chip_smoke.FLASH_BWD[0][1:7]
    mask, pairs = chip_smoke._flash_pairs(torch, "cpu", S, T, True, None)
    assert pairs == S * (S + 1) / 2
    nbytes = (4 * B * S * H * D + 4 * B * T * K * D) * 2
    assert nbytes == pytest.approx(268e6, rel=2e-3)
    ms, by = chip_smoke._bound_ms(nbytes, 10.0 * D * pairs * B * H,
                                  chip_smoke.BF16_OPS_PER_S)
    # five products of 2 B H S T D / 2 flops: ~85.9 GFLOP at 989 TFLOP/s
    assert 10.0 * D * pairs * B * H == pytest.approx(85.9e9, rel=2e-3)
    assert by == "operations" and ms == pytest.approx(0.0869, abs=1e-4)
    assert nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        0.080, abs=1e-3)


def test_backward_tolerances_and_build_instances():
    import torch

    assert chip_smoke.BWD_TOL32 == 2e-4
    assert chip_smoke.BWD_TOL_BF16 == (2.0 ** -6, 2.0 ** -8)
    want = torch.tensor([1.0, -0.5, 0.0])
    assert chip_smoke._bwd_err(torch, [want], [want], torch.float32) == 0.0
    off = want + torch.tensor([0.0, 0.0, 2e-4])
    assert chip_smoke._bwd_err(torch, [off], [want],
                               torch.float32) == pytest.approx(1.0)
    # bf16: 2^-6 of the element plus 2^-8 of the largest
    off = want + torch.tensor([2.0 ** -6 + 2.0 ** -8, 0.0, 0.0])
    assert chip_smoke._bwd_err(torch, [off], [want],
                               torch.bfloat16) == pytest.approx(1.0)
    assert set(chip_smoke.BWD_WRONG) == {"no_causal", "causal", "first_head"}
    # the delta pass in two dtypes, then dk / dv and dq of the eight
    # (dtype, D) of the dispatch: 2 + 2 x 8
    assert len(chip_smoke.BWD_INSTANCES) == 18
    assert len(set(chip_smoke.BWD_INSTANCES)) == 18
    assert chip_smoke._bwd_instance(
        "_ZN12_GLOBAL__N_119flash_bwd_kv_kernelI13__nv_bfloat16Li32ELi1EEEv"
        "PKT_") == ("kv", "bf16", 32, "fma")
    assert chip_smoke._bwd_instance(
        "_ZN12_GLOBAL__N_118flash_bwd_q_kernelIfLi128ELi4EEEvPKT_") == (
        "q", "f32", 128, "fma")
    assert chip_smoke._bwd_instance(
        "_ZN12_GLOBAL__N_122flash_bwd_delta_kernelIfEEvPKT_S3_Pfxiiiii") == (
        "delta", "f32", None, None)
    assert chip_smoke._bwd_instance(
        "_ZN12_GLOBAL__N_122flash_bwd_delta_kernelI13__nv_bfloat16EEvPKT_"
        ) == ("delta", "bf16", None, None)
    assert chip_smoke._attention_instance(
        "_ZN12_GLOBAL__N_118flash_bwd_q_kernelIfLi32ELi1EEEv") is None
    # the stats pass that recomputed lse is gone with its instances
    assert chip_smoke._bwd_instance(
        "_ZN12_GLOBAL__N_122flash_bwd_stats_kernelIfLi32ELi1EEEvPKT_") is None


def test_build_names_the_tensor_core_backward():
    # bf16 at the tensor-core flash head dims runs both passes on wgmma,
    # and the build must report each with no spill; the rest run the
    # CUDA-core passes
    wgmma = [(p, dt, d) for p, dt, d, inst in chip_smoke.BWD_INSTANCES
             if inst == "wgmma"]
    assert sorted(wgmma) == sorted(
        (p, "bf16", d) for p in ("kv", "q") for d in (64, 80, 128))
    assert sorted(d for (dt, d), inst in chip_smoke.BWD_DISPATCH.items()
                  if inst == "wgmma") == sorted(chip_smoke.WGMMA_HEAD_DIMS)
    assert all(dt == "bf16" for (dt, _), inst in
               chip_smoke.BWD_DISPATCH.items() if inst == "wgmma")
    assert chip_smoke._bwd_instance(
        "_ZN12_GLOBAL__N_125flash_bwd_kv_wgmma_kernelILi128EEEvPK13"
        "__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiiiiiif") == (
        "kv", "bf16", 128, "wgmma")
    assert chip_smoke._bwd_instance(
        "_ZN12_GLOBAL__N_124flash_bwd_q_wgmma_kernelILi80EEEvPK13"
        "__nv_bfloat16") == ("q", "bf16", 80, "wgmma")
    assert chip_smoke._wgmma_instance(
        "_ZN12_GLOBAL__N_124flash_bwd_q_wgmma_kernelILi80EEEv") is None


def test_backward_dispatch_matches_the_source():
    from repro_torch import _build
    from repro_torch.kernels.flash_attention.ops import instance

    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    body = src[src.index("cudaError_t dispatch("):]
    body = body[:body.index("}  // namespace")]
    routes = dict(((int(dt), int(d)), (route, int(n)))
                  for dt, d, route, n in re.findall(
                      r"dtype == (\d) && D == (\d+)\)\s*return "
                      r"launch_bwd_(fma|wgmma)<(?:__nv_bfloat16, |float, )?"
                      r"(\d+)>", body))
    tags = {0: "f32", 1: "bf16"}
    assert {(tags[dt], d): route for (dt, d), (route, _) in routes.items()
            } == chip_smoke.BWD_DISPATCH
    assert all(d == n for (_, d), (_, n) in routes.items())
    import torch
    for (dt, d), inst in chip_smoke.BWD_DISPATCH.items():
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        assert instance(dtype, d) == inst
    # the forward takes an lse pointer after out; the backward reads one
    args, _ = _build._SIGNATURES["flash_attention_launch"]
    fwd = (_build.CSRC / "flash_attention.cu").read_text()
    sig = re.search(r'extern "C" int flash_attention_launch\(([^)]*)\)',
                    fwd).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(args) == 16
    assert [("*" in p) for p in params] == [a is _build._P for a in args]
    assert params[4] == "void* lse_p"
    bwd = re.search(r'extern "C" int flash_attention_bwd_launch\(([^)]*)\)',
                    src).group(1)
    assert "const void* lse" in bwd


def test_lse_tolerance():
    import torch

    assert chip_smoke.LSE_TOL == (1e-5, 1e-4)
    want = torch.tensor([2.5, -10069.0776, 0.0])
    assert chip_smoke._lse_err(torch, want, want) == 0.0
    off = want + torch.tensor([0.0, 0.0, 1e-4])
    assert chip_smoke._lse_err(torch, off, want) == pytest.approx(1.0,
                                                                  rel=1e-3)
    off = want + torch.tensor([1e-4 + 2.5e-5, 0.0, 0.0])
    assert chip_smoke._lse_err(torch, off, want) == pytest.approx(1.0,
                                                                  rel=1e-3)


def test_the_backward_source_is_built():
    from repro_torch import _build

    assert "flash_attention_bwd.cu" in _build.SOURCES
    args, res = _build._SIGNATURES["flash_attention_bwd_launch"]
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    sig = re.search(r'extern "C" int flash_attention_bwd_launch\(([^)]*)\)',
                    src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(args) == 21
    assert [("*" in p) for p in params] == [a is _build._P for a in args]

"""``chip_smoke.py``'s tables against the JAX package: every paper-algos
row's avg_span is what the reference's ``Simulator.run`` gives on the CPU,
every placement-api value is what the reference's service, 3-way and
bridge calls give there, and the port's generators build the reference's
inputs, so the card run is held to the reference without importing it."""

import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref_core
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

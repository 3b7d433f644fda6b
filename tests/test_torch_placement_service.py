"""The port's placement service against the JAX package's on the same
queries: ``fit`` for all six algorithms, with a ``NodeProfile`` and the
durability pass (argument and ``durab`` flag), ``refit`` with a
destination mask and an access-cost profile under ``nodecost0.5``,
``fit_hierarchical``, replica selection, and the plan's JSON (the
reference's exact string; ``from_json`` restores scalar and vector
capacities).  Also pins which names of ``repro.core`` the port still
lacks, and that ``repro_torch.online`` exports the reference's names."""

import inspect

import numpy as np
import pytest

import repro.core as ref_core
from repro import flags as ref_flags
from repro import obs as ref_obs
from repro.core import cover_for_query as ref_cover
from repro_torch import flags, obs
import repro_torch.core as core
from repro_torch.core import NodeProfile, PlacementPlan, PlacementService

N, CAP = 12, 100.0
_TRACES = {}


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _trace(seed):
    """Queries of a small TPC-H-heterogeneous workload (N_e = 6)."""
    if seed not in _TRACES:
        wl = ref_core.tpch_heterogeneous(num_items=300, num_queries=600,
                                         seed=seed, target_min_partitions=6)
        _TRACES[seed] = (wl.queries, wl.hypergraph.node_weights)
    return _TRACES[seed]


def _profile_cols(capacity=None):
    rng = np.random.default_rng(0)
    return dict(capacity=np.full(N, CAP) if capacity is None else capacity,
                fail_prob=rng.uniform(0.01, 0.1, N), power_idle=100.0,
                power_active=300.0, access_cost=rng.uniform(0, 1, N))


def _profiles(capacity=None):
    cols = _profile_cols(capacity)
    return ref_core.NodeProfile(**cols), NodeProfile(**cols)


def _same_plan(got, want):
    assert got.to_json() == want.to_json()
    assert got.member.tobytes() == want.member.tobytes()
    assert got.algorithm == want.algorithm
    assert got.stats == want.stats


@pytest.mark.parametrize("algo", list(ref_core.ALGORITHMS))
def test_fit_matches_reference(algo):
    queries, _ = _trace(0)
    want = ref_core.PlacementService(algo).fit(queries, 300, N, CAP)
    got = PlacementService(algo, device="cpu").fit(queries, 300, N, CAP)
    _same_plan(got, want)
    assert got.avg_span(queries) == want.avg_span(queries)
    spans = got.spans(queries)
    assert spans.tolist() == want.spans(queries).tolist()
    assert got.span(queries[3]) == want.span(queries[3])


@pytest.mark.parametrize("algo", ["lmbr", "ihpa"])
@pytest.mark.parametrize("how", ["argument", "flag"])
def test_fit_with_profile_and_durability(algo, how):
    queries, _ = _trace(0)
    rp, tp = _profiles()
    variant = "obstrace" + ("+durab0.05" if how == "flag" else "")
    eps = 0.05 if how == "argument" else None
    ref_flags.set_variant(variant)
    flags.set_variant(variant)
    ref_obs.reset()
    obs.reset()
    want = ref_core.PlacementService(algo).fit(queries, 300, N, profile=rp,
                                               durability_eps=eps)
    got = PlacementService(algo, device="cpu").fit(queries, 300, N,
                                                   profile=tp,
                                                   durability_eps=eps)
    _same_plan(got, want)
    copies = ref_obs.registry().snapshot()["durability_copies_total"]
    assert copies > 0
    assert obs.registry().snapshot()["durability_copies_total"] == copies
    if algo == "lmbr":
        assert got.stats["durability_copies"] == copies
    assert len(obs.tracer().spans("service.fit")) == 1
    core.validate_durability(got.as_placement(), tp, 0.05)
    ref_obs.reset()
    obs.reset()


def test_durability_default_profile_and_error():
    queries, _ = _trace(0)
    want = ref_core.PlacementService("lmbr").fit(queries, 300, N, CAP,
                                                 durability_eps=0.001)
    got = PlacementService("lmbr", device="cpu").fit(queries, 300, N, CAP,
                                                     durability_eps=0.001)
    _same_plan(got, want)
    msgs = []
    for svc in (ref_core.PlacementService("random"),
                PlacementService("random", device="cpu")):
        with pytest.raises(ValueError) as info:
            svc.fit(queries, 300, N, profile=_profiles()[0 if not msgs
                                                         else 1],
                    durability_eps=0.05)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and "durability" in msgs[0]


def test_refit_with_mask_and_node_cost():
    queries, _ = _trace(0)
    queries1, _ = _trace(1)
    rp, tp = _profiles()
    ref_svc = ref_core.PlacementService("lmbr")
    svc = PlacementService("lmbr", device="cpu")
    old_ref = ref_svc.fit(queries, 300, N, profile=rp, durability_eps=0.05)
    old = svc.fit(queries, 300, N, profile=tp, durability_eps=0.05)
    mask = np.ones(N, dtype=bool)
    mask[[3, 7]] = False
    ref_flags.set_variant("nodecost0.5")
    flags.set_variant("nodecost0.5")
    want = ref_svc.refit(old_ref, queries1, max_moves=64, dest_mask=mask,
                         profile=rp)
    got = svc.refit(old, queries1, max_moves=64, dest_mask=mask, profile=tp)
    _same_plan(got, want)
    added = got.member & ~old.member
    assert added.any() and not added[[3, 7]].any()
    assert (got.member | ~old.member).all()
    assert got.algorithm == "lmbr+refit"
    assert got.avg_span(queries1) <= old.avg_span(queries1)


def test_fit_hierarchical():
    queries, weights = _trace(0)
    want = ref_core.PlacementService("lmbr").fit_hierarchical(
        queries, 300, num_pods=3, hosts_per_pod=4, host_capacity=CAP)
    got = PlacementService("lmbr", device="cpu").fit_hierarchical(
        queries, 300, num_pods=3, hosts_per_pod=4, host_capacity=CAP)
    _same_plan(got.pod_plan, want.pod_plan)
    assert got.host_member.tobytes() == want.host_member.tobytes()
    for q in queries[:200]:
        assert got.spans(q) == want.spans(q)
        assert got.weighted_span(q) == want.weighted_span(q)
        assert got.weighted_span(q, pod_weight=3.0) == want.weighted_span(
            q, pod_weight=3.0)
    a, b = got.select(queries[5]), want.select(queries[5])
    assert a[0] == b[0] and [x.tolist() for x in a[1]] == [
        x.tolist() for x in b[1]]


@pytest.mark.parametrize("hosts_per_pod", [1, 2])
def test_fit_hierarchical_small_pods(hosts_per_pod):
    # three items on three pods: with one host a pod, every pod holds one
    # item, no query keeps two there and each pod's sub-hypergraph is
    # [[]]; with two, one pod stays empty and is skipped
    queries = [[0, 1], [1, 2], [0, 2]]
    kw = dict(num_pods=3, hosts_per_pod=hosts_per_pod, host_capacity=1.0)
    want = ref_core.PlacementService("lmbr").fit_hierarchical(queries, 3,
                                                               **kw)
    got = PlacementService("lmbr", device="cpu").fit_hierarchical(
        queries, 3, **kw)
    assert got.pod_plan.member.tobytes() == want.pod_plan.member.tobytes()
    assert got.host_member.tobytes() == want.host_member.tobytes()
    assert got.pod_plan.member.sum(axis=1).tolist() == (
        [1, 1, 1] if hosts_per_pod == 1 else [2, 2, 0])


def test_select_and_json():
    queries, _ = _trace(0)
    got = PlacementService("lmbr", device="cpu").fit(queries, 300, N, CAP)
    for q in queries[:50]:
        a = got.select(q)
        b = ref_cover(np.asarray(q, dtype=np.int64), got.member)
        assert a[0] == b[0]
        assert [x.tolist() for x in a[1]] == [x.tolist() for x in b[1]]
        assert got.partitions_of(int(q[0])).tolist() == np.flatnonzero(
            got.member[:, int(q[0])]).tolist()
    back = PlacementPlan.from_json(got.to_json(), device="cpu")
    assert back.to_json() == got.to_json()
    assert isinstance(back.capacity, float) and back.capacity == CAP
    assert back.avg_span(queries) == got.avg_span(queries)
    ref_back = ref_core.PlacementPlan.from_json(got.to_json())
    assert ref_back.to_json() == got.to_json()


def test_vector_capacity_json():
    queries, _ = _trace(0)
    cap = np.linspace(80.0, 130.0, N)
    rp, tp = _profiles(cap)
    want = ref_core.PlacementService("lmbr").fit(queries, 300, N, profile=rp)
    got = PlacementService("lmbr", device="cpu").fit(queries, 300, N,
                                                     profile=tp)
    _same_plan(got, want)
    back = PlacementPlan.from_json(got.to_json(), device="cpu")
    ref_back = ref_core.PlacementPlan.from_json(want.to_json())
    assert isinstance(back.capacity, np.ndarray)
    assert back.capacity.tobytes() == ref_back.capacity.tobytes()
    assert back.to_json() == ref_back.to_json() == want.to_json()
    # a uniform list collapses back to the scalar path, as in the reference
    uniform = PlacementPlan(got.member, np.full(N, 150.0), got.node_weights,
                            "x", device="cpu")
    ref_uniform = ref_core.PlacementPlan(got.member, np.full(N, 150.0),
                                         got.node_weights, "x")
    assert uniform.to_json() == ref_uniform.to_json()
    cap_back = PlacementPlan.from_json(uniform.to_json(), device="cpu")
    assert isinstance(cap_back.capacity, float)
    assert cap_back.capacity == ref_core.PlacementPlan.from_json(
        ref_uniform.to_json()).capacity == 150.0


# names of the reference that the port does not have yet; each went as it
# was ported, and the web-scale generators and fit_sharded were the last
CORE_NOT_YET = set()
SERVICE_NOT_YET = set()


def test_port_exports_the_reference_core():
    want = {n for n in dir(ref_core) if not n.startswith("_")
            and not inspect.ismodule(getattr(ref_core, n))}
    have = {n for n in dir(core) if not n.startswith("_")}
    assert want - have == CORE_NOT_YET
    methods = {n for n, _ in inspect.getmembers(ref_core.PlacementService)
               if not n.startswith("__")}
    port = {n for n, _ in inspect.getmembers(PlacementService)
            if not n.startswith("__")}
    assert methods - port == SERVICE_NOT_YET
    assert port - methods == set()
    assert "as_migration" in inspect.signature(
        PlacementService.refit).parameters
    assert "as_migration" in inspect.signature(
        ref_core.PlacementService.refit).parameters
    for name in ("refit", "plan_migration", "fit_sharded"):
        assert list(inspect.signature(
            getattr(PlacementService, name)).parameters) == list(
            inspect.signature(getattr(ref_core.PlacementService,
                                      name)).parameters)


def test_port_exports_the_reference_online():
    import repro.online as ref_online
    import repro_torch.online as online

    want = sorted(n for n in dir(ref_online) if not n.startswith("_")
                  and not inspect.ismodule(getattr(ref_online, n)))
    assert sorted(online.__all__) == want
    assert all(hasattr(online, n) for n in online.__all__)


@pytest.mark.parametrize("package", ["obs", "scale"])
def test_port_exports_the_reference_obs_and_scale(package):
    import importlib

    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    want = sorted(n for n in dir(ref) if not n.startswith("_")
                  and not inspect.ismodule(getattr(ref, n)))
    have = sorted(n for n in dir(port) if not n.startswith("_")
                  and not inspect.ismodule(getattr(port, n)))
    assert have == want
    if package == "obs":
        assert port.__all__ == ref.__all__

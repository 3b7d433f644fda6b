"""The port's expert and shard placement bridges against the JAX
package's: the trace and recipe generators, the plans' member matrices
and tables, their metrics, the fixed-RF route, and the failure paths.
Every comparison is exact."""

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as core


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_generators_match_reference():
    kw = dict(top_k=6, seed=3)
    _same_arrays(core.synthetic_routing_trace(64, 300, **kw),
                 ref.synthetic_routing_trace(64, 300, **kw))
    _same_arrays(core.synthetic_routing_trace(40, 100, zipf_a=0.8,
                                              cluster_size=8, seed=1),
                 ref.synthetic_routing_trace(40, 100, zipf_a=0.8,
                                             cluster_size=8, seed=1))
    _same_arrays(core.mixture_batch_recipes(150, 200, seed=2),
                 ref.mixture_batch_recipes(150, 200, seed=2))
    _same_arrays(core.mixture_batch_recipes(20, 50, shards_per_batch=4,
                                            num_mixtures=3, seed=0),
                 ref.mixture_batch_recipes(20, 50, shards_per_batch=4,
                                           num_mixtures=3, seed=0))
    trace = ref.synthetic_routing_trace(64, 300, seed=0) + [np.array([])]
    got = core.routing_trace_to_hypergraph(trace, 64)
    want = ref.routing_trace_to_hypergraph(trace, 64)
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()


def _same_expert_plan(got, want):
    for name in ("member", "slot_to_expert", "expert_slot_table"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (got.num_experts, got.num_ranks, got.slots_per_rank,
            got.algorithm) == (want.num_experts, want.num_ranks,
                               want.slots_per_rank, want.algorithm)


EXPERT_CASES = [
    ("lmbr", 64, 8, 10),
    ("ihpa", 64, 8, 9),
    ("random", 48, 6, 8),
    ("pra3", 32, 8, 12),    # the fixed-RF route, rf = 96 // 32 = 3
    ("sda", 40, 10, 8),
]


@pytest.mark.parametrize("algo,experts,ranks,slots", EXPERT_CASES)
def test_expert_plan_matches_reference(algo, experts, ranks, slots):
    trace = ref.synthetic_routing_trace(experts, 400, top_k=6, seed=1)
    want = ref.plan_expert_placement(trace, experts, ranks, slots,
                                     algorithm=algo, seed=2)
    got = core.plan_expert_placement(trace, experts, ranks, slots,
                                     algorithm=algo, seed=2, device="cpu")
    _same_expert_plan(got, want)
    assert got.avg_span(trace) == want.avg_span(trace)
    assert got.a2a_bytes(trace, 512, 7168) == want.a2a_bytes(trace, 512, 7168)
    assert got.replica_counts().tobytes() == want.replica_counts().tobytes()
    assert (got.member.sum(axis=1) <= slots).all()
    assert (got.replica_counts() >= 1).all()


def test_expert_baseline_and_errors():
    for args in ((256, 32, 9), (10, 4, None), (64, 8, 8)):
        _same_expert_plan(core.baseline_contiguous_placement(*args),
                          ref.baseline_contiguous_placement(*args))
    trace = ref.synthetic_routing_trace(32, 50, seed=0)
    msgs = []
    for fn, kw in ((ref.plan_expert_placement, {}),
                   (core.plan_expert_placement, dict(device="cpu"))):
        with pytest.raises(ValueError) as info:
            fn(trace, 32, 4, 7, **kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == (
        "not enough expert slots to place every expert once")


SHARD_CASES = [("pra3", 3), ("ihpa3", 2), ("sda", 3), ("random3", 3),
               ("lmbr", 3), ("pra", 3)]


@pytest.mark.parametrize("algo,rf", SHARD_CASES)
def test_shard_plan_matches_reference(algo, rf):
    recipes = ref.mixture_batch_recipes(150, 300, seed=0)
    weights = None if algo != "lmbr" else np.random.default_rng(0).integers(
        1, 3, 150).astype(np.float64)
    kw = dict(algorithm=algo, rf=rf, shard_weights=weights, seed=1)
    want = ref.plan_shard_placement(recipes, 150, 12, 50.0, **kw)
    got = core.plan_shard_placement(recipes, 150, 12, 50.0, device="cpu",
                                    **kw)
    assert got.member.tobytes() == want.member.tobytes()
    assert got.shard_weights.tobytes() == want.shard_weights.tobytes()
    assert (got.capacity, got.algorithm, got.num_hosts) == (
        want.capacity, want.algorithm, want.num_hosts)
    assert got.avg_span(recipes) == want.avg_span(recipes)
    for f in (0, 1, 2, 3):
        assert got.survives_failures(f) == want.survives_failures(f)
    dead = {0, 5}
    for r in recipes[:40]:
        a, b = got.hosts_for_batch(r), want.hosts_for_batch(r)
        assert a[0] == b[0]
        assert [x.tolist() for x in a[1]] == [x.tolist() for x in b[1]]
        assert got.span(r) == want.span(r)
        try:
            b = want.cover_excluding(r, dead)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err)[:20]):
                got.cover_excluding(r, dead)
            continue
        a = got.cover_excluding(r, dead)
        assert a[0] == b[0] and not set(a[0]) & dead
        assert [x.tolist() for x in a[1]] == [x.tolist() for x in b[1]]

"""The port's health monitoring (``repro_torch.obs`` timeseries, health,
analyze, the report CLI, and ``Simulator.run_online(health=...)``) against
the JAX package's on the same seeded inputs: the same snapshot sequences,
made with numpy from a seed, go into both stores and both monitors, and
every reading, alert transition and report must be equal.  Exact
everywhere: the modules are host Python over float64 numpy."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.core as ref_core
import repro.obs as ref_obs
from repro import flags as ref_flags
from repro_torch import flags, obs
from repro_torch.core import ALGORITHMS, Simulator, from_reference_arrays

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tools", "fixtures")


@pytest.fixture(autouse=True)
def _clean():
    for f, o in ((flags, obs), (ref_flags, ref_obs)):
        f.reset()
        o.reset()
    yield
    for f, o in ((flags, obs), (ref_flags, ref_obs)):
        f.reset()
        o.reset()


def _both(variant):
    flags.set_variant(variant)
    ref_flags.set_variant(variant)


# ------------------------------------------------------- snapshot sequences
BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1)


def _snapshots(seed, n=40, parts=6):
    """A run's registry snapshots, made from ``seed``: served and degraded
    counters, a span sum, a partition-load gauge vector (one partition
    appears mid-run), a migration gauge and a cumulative latency
    histogram, with times on the attempted-queries axis."""
    rng = np.random.default_rng(seed)
    served = degraded = 0.0
    span = 0.0
    load = np.zeros(parts)
    counts = np.zeros(len(BUCKETS) + 1)
    total = 0.0
    out = []
    for i in range(n):
        q = float(rng.integers(50, 150))
        d = float(rng.integers(0, 30)) if rng.random() < 0.3 else 0.0
        served += q
        degraded += d
        span += q * float(rng.uniform(1.0, 3.0 if i < n // 2 else 6.0))
        load += rng.integers(0, 40, size=parts) * (rng.random(parts) < 0.8)
        lat = rng.lognormal(-5.0, 1.2, size=int(rng.integers(1, 6)))
        idx = np.searchsorted(BUCKETS, lat)
        counts += np.bincount(idx, minlength=len(BUCKETS) + 1)
        total += float(lat.sum())
        snap = {
            "online_served_queries": served,
            "online_degraded_queries": degraded,
            "online_span_sum": span,
            "migration_inflight": float(rng.uniform(0, 20)),
        }
        for p in range(parts if i >= 5 else parts - 1):
            snap[f'online_partition_load{{index="{p}"}}'] = float(load[p])
        cum = np.cumsum(counts)
        for b, c in zip(BUCKETS, cum[:-1]):
            snap[f'router_microbatch_seconds_bucket{{le="{b}"}}'] = float(c)
        snap['router_microbatch_seconds_bucket{le="+Inf"}'] = float(cum[-1])
        snap["router_microbatch_seconds_count"] = float(cum[-1])
        snap["router_microbatch_seconds_sum"] = total
        out.append((served + degraded, snap))
    return out


def _readings(store):
    """Every aggregation of a store over a grid of windows."""
    got = {"names": store.names()}
    for name in store.names():
        if "{" in name:
            continue
        got[name] = [store.last(name), store.mean(name), store.vmin(name),
                     store.vmax(name), store.ewma(name),
                     store.ewma(name, alpha=0.7, n=5)]
        for n in (2, 3, 8, 100):
            got[name] += [store.delta(name, n), store.rate(name, n),
                          store.mean(name, n)]
    for n in (2, 4, 9):
        got[f"vec{n}"] = store.vector_delta("online_partition_load",
                                            n).tolist()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        for n in (None, 2, 5, 50):
            got[f"q{q}-{n}"] = store.histogram_quantile(
                "router_microbatch_seconds", q, n)
    got["absent"] = [store.last("x"), store.delta("x", 2),
                     store.vector_delta("x", 2).tolist(),
                     store.histogram_quantile("x", 0.5)]
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("capacity", [4, 16, 512])
def test_store_readings_match_reference(seed, capacity):
    got, want = obs.TimeSeriesStore(capacity), ref_obs.TimeSeriesStore(
        capacity)
    for t, snap in _snapshots(seed):
        got.ingest(snap, t)
        want.ingest(snap, t)
        assert _readings(got) == _readings(want)


def test_series_ring_matches_reference():
    rng = np.random.default_rng(5)
    got, want = obs.SeriesRing(7), ref_obs.SeriesRing(7)
    assert len(got) == len(want) == 0
    for i in range(30):
        t, v = float(i), float(rng.normal())
        got.append(t, v)
        want.append(t, v)
        for n in (None, 1, 3, 7, 50):
            assert got.values(n).tolist() == want.values(n).tolist()
            assert got.times(n).tolist() == want.times(n).tolist()
        assert got.last() == want.last() and len(got) == len(want)
    msgs = []
    for mod in (obs, ref_obs):
        with pytest.raises(ValueError) as info:
            mod.SeriesRing(1)
        msgs.append(str(info.value))
        with pytest.raises(ValueError, match="empty series"):
            mod.SeriesRing(2).last()
    assert msgs[0] == msgs[1]


def test_histogram_quantile_from_both_registries():
    """The registries' own histograms, fed the same latencies, give the
    same windowed and whole-run quantiles."""
    _both("obscounters")
    rng = np.random.default_rng(3)
    stores = (obs.TimeSeriesStore(), ref_obs.TimeSeriesStore())
    regs = (obs.registry(), ref_obs.registry())
    for reg in regs:
        reg.histogram("lat_seconds", buckets=(0.1, 0.25, 0.5, 1.0))
    for t in range(6):
        lat = rng.uniform(0.0, 1.5, size=int(rng.integers(1, 9)))
        for reg, st in zip(regs, stores):
            for v in lat:
                reg.observe("lat_seconds", float(v))
            st.ingest(reg.snapshot(), t=float(t))
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        for n in (None, 2, 4):
            a, b = (st.histogram_quantile("lat_seconds", q, n)
                    for st in stores)
            assert a == b
    for st in stores:
        with pytest.raises(ValueError, match="quantile"):
            st.histogram_quantile("lat_seconds", 1.5)


# ------------------------------------------------------ alert state machine
def _replay_rule(mod, name, values, op=">", threshold=5.0, **kw):
    it = iter(values)
    return mod.SLORule(name, lambda store: next(it), op, threshold, **kw)


def _history(m):
    return [dict(h) for h in m.history]


def _alert_states(m):
    return {n: (a.state, a.fires, a.resolves, a.fired_at, a.resolved_at,
                a.last_value, a.breach_streak, a.clear_streak, a.threshold)
            for n, a in m.alerts.items()}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("fire_after,resolve_after,op",
                         [(1, 2, ">"), (3, 1, ">"), (2, 3, "<")])
def test_alert_state_machine_matches_reference(seed, fire_after,
                                               resolve_after, op):
    rng = np.random.default_rng(seed)
    vals = [None if rng.random() < 0.15 else float(rng.integers(0, 11))
            for _ in range(60)]
    seen = ([], [])
    mons = [mod.HealthMonitor(
        [_replay_rule(mod, "r", vals, op=op, fire_after=fire_after,
                      resolve_after=resolve_after)],
        on_alert=lambda a, firing, s=s: s.append((a.name, firing, a.state)))
        for mod, s in ((obs, seen[0]), (ref_obs, seen[1]))]
    for t in range(len(vals)):
        got, want = (m.evaluate(float(t)) for m in mons)
        assert [a.name for a in got] == [a.name for a in want]
    assert _history(mons[0]) == _history(mons[1])
    assert _alert_states(mons[0]) == _alert_states(mons[1])
    assert mons[0].stats == mons[1].stats
    assert seen[0] == seen[1]
    assert mons[0].active_alerts() == mons[1].active_alerts()


@pytest.mark.parametrize("z,warmup,alpha", [(3.0, 5, 0.3), (0.5, 2, 0.6),
                                            (2.0, 40, 0.3)])
def test_anomaly_alerts_match_reference(z, warmup, alpha):
    """EWMA z-scores over a stream with flat stretches (infinite z) and
    regime changes, warm-up included."""
    rng = np.random.default_rng(11)
    vals = ([10.0] * 8 + [100.0, 100.0] + [10.0] * 5
            + list(rng.normal(20.0, 3.0, size=25)) + [80.0, 5.0, 5.0])
    mons = [mod.HealthMonitor(
        [_replay_rule(mod, "flat", vals, resolve_after=2),
         _replay_rule(mod, "low", [v / 20 for v in vals], op="<",
                      threshold=0.6)],
        anomaly_z=z, anomaly_alpha=alpha, anomaly_warmup=warmup)
        for mod in (obs, ref_obs)]
    for t in range(len(vals)):
        for m in mons:
            m.evaluate(float(t))
    assert _history(mons[0]) == _history(mons[1])
    assert _alert_states(mons[0]) == _alert_states(mons[1])
    assert sorted(mons[0]._ewma) == sorted(mons[1]._ewma)
    for k in mons[0]._ewma:
        a, b = mons[0]._ewma[k], mons[1]._ewma[k]
        assert (a.mean, a.var, a.count) == (b.mean, b.var, b.count)


def test_monitor_errors_match_reference():
    msgs = []
    for mod in (obs, ref_obs):
        r = mod.SLORule("dup", lambda s: 0.0, ">", 1.0)
        with pytest.raises(ValueError) as dup:
            mod.HealthMonitor([r, mod.SLORule("dup", lambda s: 0.0, ">",
                                              1.0)])
        with pytest.raises(ValueError) as op:
            mod.SLORule("r", lambda s: 0.0, ">=", 1.0).breached(2.0)
        msgs.append((str(dup.value), str(op.value)))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("level", ["off", "counters", "trace"])
def test_alert_surfacing_matches_reference(level):
    """Registry counters, the active-alerts gauge and the tracer's alert
    events, at every obs level."""
    _both(f"obs{level}")
    vals = [9, 1, 9, 9, 1, 1, 1, 9]
    mons = [mod.HealthMonitor([_replay_rule(mod, "a", vals),
                               _replay_rule(mod, "b", vals[::-1])])
            for mod in (obs, ref_obs)]
    for t in range(len(vals)):
        for m in mons:
            m.evaluate(float(t))
    assert _history(mons[0]) == _history(mons[1])
    assert obs.registry().snapshot() == ref_obs.registry().snapshot()

    def alerts(tr):
        return [(e["name"], e["args"]) for e in tr.events
                if e["name"].startswith("alert.")]

    assert alerts(obs.tracer()) == alerts(ref_obs.tracer())
    if level == "trace":
        assert alerts(obs.tracer())


# ----------------------------------------------------------- from_flags
FLAG_SETS = [
    "obscounters+obssnap50+obshealth1",
    "obscounters+obssnap50+obshealth1+healthw4+healthskew3.0",
    "obscounters+obssnap50+obshealth1+healthp990.004+healthbacklog5.0"
    "+healthhyst3+healthw3",
    "obscounters+obssnap50+obshealth1+healthspan1.2+healthdeg0.05"
    "+healthz2.0+healthw5",
    "obscounters+obssnap50+obshealth1+healthspan0+healthdeg0+healthskew0",
]


@pytest.mark.parametrize("variant", FLAG_SETS)
@pytest.mark.parametrize("seed", [0, 4])
def test_from_flags_monitors_match_reference(variant, seed):
    """The flags-built rule sets, the p99 latency rule included, over the
    same synthetic registry snapshots."""
    _both(variant)
    fired = ([], [])
    mons = [mod.HealthMonitor.from_flags(
        on_alert=lambda a, f, s=s: s.append((a.name, f)))
        for mod, s in ((obs, fired[0]), (ref_obs, fired[1]))]
    assert [(r.name, r.op, r.threshold, r.fire_after, r.resolve_after)
            for r in mons[0].rules] == [
        (r.name, r.op, r.threshold, r.fire_after, r.resolve_after)
        for r in mons[1].rules]
    assert mons[0].anomaly_z == mons[1].anomaly_z
    for m in mons:
        m.set_baseline(2.0)
    for t, snap in _snapshots(seed, n=60):
        got, want = (m.observe(snap, t) for m in mons)
        assert [a.name for a in got] == [a.name for a in want]
    assert _history(mons[0]) == _history(mons[1])
    assert _alert_states(mons[0]) == _alert_states(mons[1])
    assert fired[0] == fired[1]
    if "healthp99" in variant:
        assert mons[0].alerts["latency_p99"].last_value is not None


@pytest.mark.parametrize("key,value", [("health_window", 1),
                                       ("health_hysteresis", 0)])
def test_from_flags_validation_matches_reference(key, value):
    msgs = []
    for f, mod in ((flags, obs), (ref_flags, ref_obs)):
        f.FLAGS[key] = value
        with pytest.raises(ValueError) as info:
            mod.HealthMonitor.from_flags()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("variant", [
    "obshealth1+healthw16+healthhyst4+healthspan2.0+healthp990.5"
    "+healthdeg0.1+healthskew5.0+healthbacklog2.5+healthz3.0",
    "obshealth0+healthw2+healthhyst1",
    "routermb64+obscounters+obssnap100+obshealth1+healthw4+healthskew3.0",
])
def test_health_variants_match_reference(variant):
    _both(variant)
    for key in ("obs_health", "health_window", "health_hysteresis",
                "health_span_slo", "health_p99_slo", "health_degraded_slo",
                "health_skew_slo", "health_backlog_slo", "health_anomaly_z",
                "obs_level", "obs_snapshot_every"):
        assert flags.FLAGS[key] == ref_flags.FLAGS[key], key
    flags.reset()
    ref_flags.reset()
    for key in flags.FLAGS:
        assert flags.FLAGS[key] == ref_flags.FLAGS[key], key


@pytest.mark.parametrize("bad", ["healthw1", "healthhyst0", "healthz-1"])
def test_health_variant_validation_matches_reference(bad):
    msgs = []
    for f in (flags, ref_flags):
        with pytest.raises(ValueError) as info:
            f.set_variant(bad)
        msgs.append(str(info.value))
        f.reset()
    assert msgs[0] == msgs[1]


# ------------------------------------------------- run_online integration
@pytest.fixture(scope="module")
def storm_graph():
    hg = ref_core.random_workload(num_items=120, num_queries=3000, density=6,
                                  seed=2).hypergraph
    return hg, from_reference_arrays(hg.edge_ptr, hg.edge_nodes,
                                     hg.node_weights, hg.edge_weights,
                                     hg.num_nodes)


STORM = [(1000, "down", 3), (1000, "down", 5), (1000, "down", 7),
         (2500, "repair", 1), (2501, "up", 3), (2501, "up", 5),
         (2501, "up", 7)]
HEALTH_VARIANT = ("routermb64+obscounters+obssnap100+obshealth1+healthw4"
                  "+healthskew3.0")


def _run_pair(storm_graph, variant, algo, events, monitored, **kw):
    hg, phg = storm_graph
    _both(variant)
    obs.reset()
    ref_obs.reset()
    fired = ([], [])
    mons = ([obs.HealthMonitor.from_flags(),
             ref_obs.HealthMonitor.from_flags()] if monitored
            else [None, None])
    got = Simulator(10, 30, device="cpu").run_online(
        phg, ALGORITHMS[algo], seed=0, events=list(events),
        auto_repair=False, health=mons[0],
        on_alert=(lambda a, f: fired[0].append((a.name, f))) if monitored
        else None, **kw)
    want = ref_core.Simulator(10, 30).run_online(
        hg, ref_core.ALGORITHMS[algo], seed=0, events=list(events),
        auto_repair=False, health=mons[1],
        on_alert=(lambda a, f: fired[1].append((a.name, f))) if monitored
        else None, **kw)
    return got, want, mons, fired


def _summary(res):
    s = res.summary()
    s.pop("placement_s")
    return s


@pytest.mark.parametrize("algo,kw", [("hpa", {}),
                                     ("lmbr", dict(max_moves=30))])
def test_run_online_storm_matches_reference(storm_graph, algo, kw):
    got, want, mons, fired = _run_pair(storm_graph, HEALTH_VARIANT, algo,
                                       STORM, True, **kw)
    assert _summary(got) == _summary(want)
    assert got.spans.tobytes() == want.spans.tobytes()
    assert got.access_load.tobytes() == want.access_load.tobytes()
    assert _history(mons[0]) == _history(mons[1])
    assert _alert_states(mons[0]) == _alert_states(mons[1])
    assert mons[0].baseline_span == mons[1].baseline_span
    assert fired[0] == fired[1]
    s = got.summary()
    assert s["alerts_fired"] == mons[0].stats["alerts_fired"] > 0
    assert s["alerts_resolved"] == mons[0].stats["alerts_resolved"] > 0
    assert ("degraded_rate", True) in fired[0]
    a, b = obs.registry().snapshot(), ref_obs.registry().snapshot()
    timed = {k for k in b if "seconds" in k}
    assert {k: v for k, v in a.items() if k not in timed} == {
        k: v for k, v in b.items() if k not in timed}
    assert a["health_alerts_fired_total"] == s["alerts_fired"]
    # observation changes nothing: the same run unmonitored
    off, _, _, _ = _run_pair(storm_graph, "routermb64", algo, STORM, False,
                             **kw)
    assert off.spans.tobytes() == got.spans.tobytes()
    assert off.access_load.tobytes() == got.access_load.tobytes()
    assert off.member.tobytes() == got.member.tobytes()
    a, b = _summary(off), _summary(got)
    for key in ("alerts_fired", "alerts_resolved"):
        b.pop(key)
    assert a == b


def test_run_online_clean_replay_fires_nothing(storm_graph):
    got, want, mons, fired = _run_pair(storm_graph, HEALTH_VARIANT, "hpa",
                                       [], True)
    assert _summary(got) == _summary(want)
    assert got.summary()["alerts_fired"] == 0
    assert got.summary()["alerts_resolved"] == 0
    assert mons[0].history == mons[1].history == []
    assert mons[0].stats == mons[1].stats
    assert mons[0].stats["checks"] > 0


def test_run_online_flags_armed_monitor_matches_reference(storm_graph):
    """``obs_health`` builds the monitor inside ``run_online``; the
    callback still sees its transitions.  Without ``obs_health`` the alert
    keys stay out of the summary."""
    got, want, _, fired = _run_pair(storm_graph, HEALTH_VARIANT, "hpa",
                                    STORM, False)
    assert _summary(got) == _summary(want)
    assert got.summary()["alerts_fired"] > 0
    got, want, _, _ = _run_pair(storm_graph, "routermb64+obscounters"
                                "+obssnap100", "hpa", STORM, False)
    assert _summary(got) == _summary(want)
    assert "alerts_fired" not in got.summary()
    # a flags-armed monitor hands its transitions to on_alert
    _both(HEALTH_VARIANT)
    seen = []
    Simulator(10, 30, device="cpu").run_online(
        storm_graph[1], ALGORITHMS["hpa"], seed=0, events=STORM,
        auto_repair=False, on_alert=lambda a, f: seen.append((a.name, f)))
    assert ("degraded_rate", True) in seen


@pytest.mark.parametrize("variant", ["obshealth1", "obscounters+obshealth1"])
def test_run_online_health_errors_match_reference(storm_graph, variant):
    hg, phg = storm_graph
    _both(variant)
    msgs = []
    for sim, g, fit in ((Simulator(10, 30, device="cpu"), phg,
                         ALGORITHMS["hpa"]),
                        (ref_core.Simulator(10, 30), hg,
                         ref_core.ALGORITHMS["hpa"])):
        with pytest.raises(ValueError) as info:
            sim.run_online(g, fit, seed=0)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert "obs_snapshot_every" in msgs[0]


# -------------------------------------------------------------- analyze
def _random_events(seed):
    """A trace with nested spans, partial overlaps, a second tid,
    microbatches with and without ``queries``, instant alerts and
    counters, made from ``seed``."""
    rng = np.random.default_rng(seed)
    events = [{"name": "fit.place", "ph": "X", "ts": 0.0, "dur": 5000.0,
               "pid": 0, "tid": 0, "args": {}}]
    ts = 10.0
    for depth_name in ("fit.hpa", "fit.hpa.refine", "fit.lmbr"):
        dur = float(rng.uniform(100, 1500))
        events.append({"name": depth_name, "ph": "X", "ts": ts,
                       "dur": dur, "pid": 0, "tid": 0, "args": {}})
        ts += float(rng.uniform(1, 50))
    ts = 6000.0
    for i in range(int(rng.integers(5, 15))):
        dur = float(rng.uniform(10, 400))
        args = {"queries": int(rng.integers(1, 64))} if i % 3 else {}
        events.append({"name": "serve.microbatch", "ph": "X", "ts": ts,
                       "dur": dur, "pid": 0, "tid": int(i % 4 == 0),
                       "args": args})
        if rng.random() < 0.3:
            events.append({"name": "migration.transfer", "ph": "X",
                           "ts": ts + dur / 2, "dur": dur * 3, "pid": 0,
                           "tid": 0, "args": {}})
        if rng.random() < 0.3:
            kind = "fire" if rng.random() < 0.5 else "resolve"
            events.append({"name": f"alert.{kind}", "ph": "i",
                           "ts": ts + 1, "pid": 0, "tid": 0,
                           "args": {"rule": "degraded_rate",
                                    "value": float(rng.uniform()),
                                    "threshold": 0.02}})
        events.append({"name": "online.snapshot", "ph": "C", "ts": ts + 2,
                       "pid": 0, "tid": 0, "args": {"served": i}})
        ts += dur + float(rng.uniform(0, 100))
    order = rng.permutation(len(events))
    return [events[i] for i in order]


def _tree(roots):
    return [(r.name, r.ts, r.dur, r.self_time, _tree(r.children))
            for r in roots]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_analyze_matches_reference(seed):
    events = _random_events(seed)
    assert _tree(obs.build_span_tree(events)) == _tree(
        ref_obs.build_span_tree(events))
    assert obs.aggregate_spans(events) == ref_obs.aggregate_spans(events)
    for root in ("fit.place", "serve.microbatch", "absent"):
        assert [(n.name, n.dur) for n in obs.critical_path(events, root)] \
            == [(n.name, n.dur) for n in ref_obs.critical_path(events, root)]
    for k in (1, 3, 50):
        assert obs.top_slowest(events, k=k) == ref_obs.top_slowest(events,
                                                                   k=k)
    prom = {"router_served_queries_total": 3.0, "health_alerts_active": 1.0,
            "not_headline": 2.0}
    for snap in (None, prom):
        assert obs.render_report(events, snap, top_k=4) == \
            ref_obs.render_report(events, snap, top_k=4)
    assert obs.critical_path([]) == ref_obs.critical_path([]) == []


def test_load_events_matches_reference():
    _both("obstrace")
    tr = obs.tracer()
    with tr.span("outer"):
        with tr.span("inner", k=1):
            pass
    tr.event("mark")
    tr.counter("c", x=1.0)
    texts = [tr.to_jsonl(), tr.to_chrome_trace(), "",
             '{"name": "solo", "ph": "X", "ts": 0, "dur": 1}',
             json.dumps([{"name": "a", "ph": "i", "ts": 1}])]
    for text in texts:
        assert obs.load_events(text) == ref_obs.load_events(text)
    msgs = []
    for mod in (obs, ref_obs):
        with pytest.raises(ValueError) as info:
            mod.load_events('{"traceEvents": 3}')
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------- report CLI
def _cli(args, module):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    cmd = ([sys.executable, "-m", "repro_torch.obs.report"] if module
           else [sys.executable, os.path.join(REPO_ROOT, "tools",
                                              "obs_report.py")])
    return subprocess.run(cmd + args, capture_output=True, text=True,
                          timeout=120, env=env, cwd=REPO_ROOT)


def test_report_cli_equals_the_reference_tool():
    args = [os.path.join(FIXTURES, "tiny_trace.jsonl"), "--prom",
            os.path.join(FIXTURES, "tiny_prom.txt")]
    got, want = _cli(args, True), _cli(args, False)
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert "== metrics ==" in got.stdout and "alert.fire" in got.stdout
    got = _cli(args[:1] + ["--top-k", "2"], True)
    want = _cli(args[:1] + ["--top-k", "2"], False)
    assert got.returncode == 0 and got.stdout == want.stdout


def test_report_cli_missing_file_fails_cleanly():
    missing = os.path.join(REPO_ROOT, "does_not_exist.jsonl")
    got = _cli([missing], True)
    assert got.returncode == 1
    assert "cannot load trace" in got.stderr
    assert got.stdout == ""


# ----------------------------------------------------------------- names
def test_port_obs_modules_match_the_reference():
    """The submodules' names and the public classes' members; the
    package's names are pinned in
    ``tests/test_torch_placement_service.py``."""
    for sub in ("timeseries", "health", "analyze"):
        assert getattr(obs, sub).__all__ == getattr(ref_obs, sub).__all__
    for cls in ("TimeSeriesStore", "HealthMonitor", "SLORule", "Alert"):
        a, b = getattr(obs, cls), getattr(ref_obs, cls)
        assert {n for n in dir(a) if not n.startswith("__")} == {
            n for n in dir(b) if not n.startswith("__")}
    assert inspect.signature(obs.HealthMonitor).parameters.keys() == \
        inspect.signature(ref_obs.HealthMonitor).parameters.keys()

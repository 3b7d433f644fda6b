"""Knobs of the placement pipeline (HPA -> LMBR -> replay).

A cut-down copy of the JAX package's flag table holding only the keys this
package reads.  Defaults are the reference's; the two span thresholds were
calibrated on a CPU host and have not been re-measured on a GPU yet.

Backend values:

* ``span_backend``: ``"auto"`` (per greedy round: numpy below
  ``span_dispatch_threshold`` gain words, the span_gain kernel above it),
  ``"numpy"``, ``"device"``.
* ``span_round_backend``: ``"auto"`` (per word-count bucket: the host round
  loop below ``span_round_threshold`` packed words, the cover_rounds kernel
  above it), ``"numpy"``, ``"device"``.
* ``lmbr_peel``: ``"vector"`` (flat numpy lockstep), ``"reference"``
  (pure-Python oracle), ``"auto"`` (oracle for narrow pairs, vector for the
  rest), ``"device"`` (the lockstep_peel kernel).

``"device"`` means the CUDA kernel when the caller's device is a GPU and the
kernel's plain PyTorch version when it is the CPU.  Every backend is
bit-identical, so these are performance knobs only.

``durability_eps`` (variant ``durab<eps>``) is the per-item loss ceiling
``prod fail_prob <= eps`` that `PlacementService` fits meet by adding
copies after the fit; 0.0 (the default) turns the pass off.

Online serving (``repro_torch.online``, ``Simulator.run_online``):

* ``router_microbatch`` (``routermb<n>``): queries per batched cover call;
  ``router_balance`` (``routerbal<0|1>``): least-loaded tie-break among
  equal-gain partitions; ``router_ledger_epsilon`` (``routereps<x>``):
  ledger shift that re-sorts the tie-break rows (0 re-sorts on any
  shift); ``router_cost_aware`` (``routercost<0|1>``): sort by load times
  the profile's routing cost.
* ``drift_window`` (``driftw<n>``) and ``drift_threshold``
  (``driftth<x>``): the sketch's window and the windowed-span ratio that
  triggers a refit.
* ``migration_bandwidth`` (``migbw<x>``, weight units per served query;
  0 swaps plans at once), ``migration_concurrency`` (``migconc<n>``,
  transfers in flight per destination), ``migration_headroom``
  (``mighead<x>``, capacity slack of the union layout).
* ``obs_snapshot_every`` (``obssnap<n>``): a metrics snapshot every n
  served queries (0: none).

Health monitoring (``repro_torch.obs.health``, ``run_online``):

* ``obs_health`` (``obshealth<0|1>``): arm the flags-built
  `HealthMonitor` inside ``run_online``; it needs ``obs_level`` other
  than ``"off"`` and ``obs_snapshot_every`` > 0, and reads only.
* ``health_window`` (``healthw<n>``, >= 2): snapshots per windowed rule;
  ``health_hysteresis`` (``healthhyst<n>``, >= 1): clear evaluations
  before a firing alert resolves.
* SLO thresholds, 0 turning a rule off: ``health_span_slo``
  (``healthspan<x>``, windowed avg span over the fit's),
  ``health_p99_slo`` (``healthp99<x>``, seconds of microbatch latency),
  ``health_degraded_slo`` (``healthdeg<x>``), ``health_skew_slo``
  (``healthskew<x>``, p99 / mean partition load delta),
  ``health_backlog_slo`` (``healthbacklog<x>``, migration in flight);
  ``health_anomaly_z`` (``healthz<x>``): EWMA z-score anomaly alerts.

Cluster-scale fits (``repro_torch.scale``):

* ``scale_shards`` (``shards<n>``; 0: ``max(1, num_partitions // 8)``),
  ``scale_workers`` (``scalew<n>``, >= 1; above 1 the shard fits run on
  spawned worker processes), ``scale_boundary_repair`` (``brepair<n>``:
  the LMBR move budget over the cross-shard edges; 0 turns it off).

MoE (``repro_torch.models.moe``):

* ``moe_cf`` (``cf<x>``): the capacity factor of ``apply_moe`` when the
  caller passes none; ``None`` (the default) leaves the config's.

Training (``repro_torch.launch.steps``):

* ``accum_steps`` (``accum<n>``, default 1): microbatches of a train step,
  whose gradients are summed in the parameter dtype.

The reference's other training knobs are not here yet: ``mla_decomp`` (the
decompressed MLA prefill) waits for ROADMAP Queue 1 item 9.8, ``sp`` and
``sp_attn`` (sequence parallelism) for the mesh, item 9.6.
"""

from __future__ import annotations

_DEFAULTS = dict(
    span_backend="auto",
    span_dispatch_threshold=48_000,
    span_round_backend="auto",
    span_round_threshold=200_000,
    lmbr_peel="vector",
    lmbr_peel_threshold=256,
    lmbr_gain_cache=True,
    lmbr_epochs="item",
    placement_objective="span",
    node_cost_weight=0.0,
    durability_eps=0.0,
    router_microbatch=384,
    router_balance=False,
    router_ledger_epsilon=0.0,
    router_cost_aware=False,
    drift_window=512,
    drift_threshold=1.25,
    migration_bandwidth=0.0,
    migration_concurrency=4,
    migration_headroom=0.10,
    obs_level="off",
    obs_snapshot_every=0,
    obs_health=False,
    health_window=8,
    health_hysteresis=2,
    health_span_slo=1.5,
    health_p99_slo=0.0,
    health_degraded_slo=0.02,
    health_skew_slo=4.0,
    health_backlog_slo=0.0,
    health_anomaly_z=0.0,
    scale_shards=0,
    scale_workers=1,
    scale_boundary_repair=256,
    moe_cf=None,
    accum_steps=1,
)

FLAGS = dict(_DEFAULTS)

SPAN_BACKENDS = ("auto", "numpy", "device")
SPAN_ROUND_BACKENDS = ("auto", "numpy", "device")
PEEL_BACKENDS = ("vector", "reference", "auto", "device")


def set_variant(spec: str):
    """'peeldevice+spanrounddevice+accum2' -> flag settings."""
    reset()
    for part in filter(None, spec.split("+")):
        if part == "baseline":
            continue
        elif part.startswith("accum"):
            FLAGS["accum_steps"] = int(part[len("accum"):])
        elif part.startswith("cf"):
            FLAGS["moe_cf"] = float(part[2:])
        elif part.startswith("spanth"):
            FLAGS["span_dispatch_threshold"] = int(part[len("spanth"):])
        elif part.startswith("spanroundth"):
            FLAGS["span_round_threshold"] = int(part[len("spanroundth"):])
        elif part.startswith("spanround"):
            backend = part[len("spanround"):]
            if backend not in SPAN_ROUND_BACKENDS:
                raise ValueError(f"unknown span round backend {backend!r}")
            FLAGS["span_round_backend"] = backend
        elif part.startswith("peelth"):
            FLAGS["lmbr_peel_threshold"] = int(part[len("peelth"):])
        elif part.startswith("peel"):
            backend = part[len("peel"):]
            if backend not in PEEL_BACKENDS:
                raise ValueError(f"unknown lmbr peel backend {backend!r}")
            FLAGS["lmbr_peel"] = backend
        elif part.startswith("lmbrepoch"):
            mode = part[len("lmbrepoch"):]
            if mode not in ("item", "partition"):
                raise ValueError(f"unknown lmbr epoch mode {mode!r}")
            FLAGS["lmbr_epochs"] = mode
        elif part.startswith("lmbrcache"):
            FLAGS["lmbr_gain_cache"] = bool(int(part[len("lmbrcache"):]))
        elif part == "energy":
            FLAGS["placement_objective"] = "energy"
        elif part.startswith("durab"):
            eps = float(part[len("durab"):])
            if eps < 0:
                raise ValueError(f"durability_eps must be >= 0, got {eps}")
            FLAGS["durability_eps"] = eps
        elif part.startswith("nodecost"):
            w = float(part[len("nodecost"):])
            if w < 0:
                raise ValueError(f"node_cost_weight must be >= 0, got {w}")
            FLAGS["node_cost_weight"] = w
        elif part.startswith("routereps"):
            eps = float(part[len("routereps"):])
            if eps < 0:
                raise ValueError(
                    f"router_ledger_epsilon must be >= 0, got {eps}")
            FLAGS["router_ledger_epsilon"] = eps
        elif part.startswith("routerbal"):
            FLAGS["router_balance"] = bool(int(part[len("routerbal"):]))
        elif part.startswith("routermb"):
            FLAGS["router_microbatch"] = int(part[len("routermb"):])
        elif part.startswith("routercost"):
            FLAGS["router_cost_aware"] = bool(int(part[len("routercost"):]))
        elif part.startswith("driftw"):
            FLAGS["drift_window"] = int(part[len("driftw"):])
        elif part.startswith("driftth"):
            FLAGS["drift_threshold"] = float(part[len("driftth"):])
        elif part.startswith("migbw"):
            bw = float(part[len("migbw"):])
            if bw < 0:
                raise ValueError(f"migration_bandwidth must be >= 0, got {bw}")
            FLAGS["migration_bandwidth"] = bw
        elif part.startswith("migconc"):
            conc = int(part[len("migconc"):])
            if conc < 1:
                raise ValueError(
                    f"migration_concurrency must be >= 1, got {conc}")
            FLAGS["migration_concurrency"] = conc
        elif part.startswith("mighead"):
            head = float(part[len("mighead"):])
            if head < 0:
                raise ValueError(f"migration_headroom must be >= 0, got {head}")
            FLAGS["migration_headroom"] = head
        elif part.startswith("shards"):
            shards = int(part[len("shards"):])
            if shards < 0:
                raise ValueError(f"scale_shards must be >= 0, got {shards}")
            FLAGS["scale_shards"] = shards
        elif part.startswith("scalew"):
            workers = int(part[len("scalew"):])
            if workers < 1:
                raise ValueError(f"scale_workers must be >= 1, got {workers}")
            FLAGS["scale_workers"] = workers
        elif part.startswith("brepair"):
            moves = int(part[len("brepair"):])
            if moves < 0:
                raise ValueError(
                    f"scale_boundary_repair must be >= 0, got {moves}"
                )
            FLAGS["scale_boundary_repair"] = moves
        elif part.startswith("obshealth"):
            FLAGS["obs_health"] = bool(int(part[len("obshealth"):]))
        elif part.startswith("obssnap"):
            every = int(part[len("obssnap"):])
            if every < 0:
                raise ValueError(
                    f"obs_snapshot_every must be >= 0, got {every}")
            FLAGS["obs_snapshot_every"] = every
        elif part.startswith("obs"):
            lv = part[len("obs"):]
            if lv not in ("off", "counters", "trace"):
                raise ValueError(f"unknown obs level {lv!r}")
            FLAGS["obs_level"] = lv
        elif part.startswith("healthw"):
            w = int(part[len("healthw"):])
            if w < 2:
                raise ValueError(f"health_window must be >= 2, got {w}")
            FLAGS["health_window"] = w
        elif part.startswith("healthhyst"):
            h = int(part[len("healthhyst"):])
            if h < 1:
                raise ValueError(f"health_hysteresis must be >= 1, got {h}")
            FLAGS["health_hysteresis"] = h
        elif part.startswith("healthspan"):
            FLAGS["health_span_slo"] = float(part[len("healthspan"):])
        elif part.startswith("healthp99"):
            FLAGS["health_p99_slo"] = float(part[len("healthp99"):])
        elif part.startswith("healthdeg"):
            FLAGS["health_degraded_slo"] = float(part[len("healthdeg"):])
        elif part.startswith("healthskew"):
            FLAGS["health_skew_slo"] = float(part[len("healthskew"):])
        elif part.startswith("healthbacklog"):
            FLAGS["health_backlog_slo"] = float(part[len("healthbacklog"):])
        elif part.startswith("healthz"):
            z = float(part[len("healthz"):])
            if z < 0:
                raise ValueError(f"health_anomaly_z must be >= 0, got {z}")
            FLAGS["health_anomaly_z"] = z
        elif part.startswith("span"):
            backend = part[len("span"):]
            if backend not in SPAN_BACKENDS:
                raise ValueError(f"unknown span backend {backend!r}")
            FLAGS["span_backend"] = backend
        else:
            raise ValueError(f"unknown variant component {part!r}")


def reset():
    FLAGS.clear()
    FLAGS.update(_DEFAULTS)

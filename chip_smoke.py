#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the placement pipeline
and the hymba-1.5b serving path.

    python3 chip_smoke.py                      # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernels

Phases, each printed on a line of its own:

1. build       — compile the six CUDA kernels from ``src/repro_torch/csrc``;
                 the line gives the registers and spills of the tensor-core
                 (wgmma) instance of flash_attention, of the serving
                 path's decode_attention instance (bf16, G 5) and of every
                 ssd_scan instance (state, chain and output pass), and
                 requires no spills in the serving path's ssd passes.
2. kernels     — hold each kernel against its plain PyTorch version on the
                 card and time kernel, plain version, library call (where
                 one PyTorch call computes the same function) and the
                 bound of the work: the placement kernels at the
                 pipeline's shapes (exact match required), flash_attention,
                 decode_attention and ssd_scan at hymba-1.5b's serving
                 shapes in bf16 (within one bf16 ulp of the output, and
                 differing from the plain version in under 1% of the
                 elements) and f32 (within 2e-4); each check must also
                 reject a wrong variant (no window mask, a truncating
                 bf16 store).  flash_attention in bf16 (the wgmma instance)
                 is also checked at serve-check's prefill length, S = T =
                 1528 (batch 2), which no tile size divides.
                 decode_attention is also checked, by the same rule, over a
                 wrapped ring buffer with empty slots and per-row q_pos
                 (window None and 40), at D 32 with G 1 and D 128 with G 8,
                 at batch 1, and at serve's warm-up step (18 slots, one
                 split, q at an odd offset); its serving rows add
                 ``device_ms``, the profiler's device time per call, for the
                 kernel and SDPA.  ssd_scan (y and h_last, f32 for either x
                 dtype, within 2e-4) must also reject the scan with h0
                 dropped; its serving rows add ``device_ms`` in total and
                 per pass.  It is also checked at serve's warm-up (S 16),
                 serve-check's prompt (S 1536) and prefill (S 1528), P 16
                 and P 32, N 64 at chunk 64 and 256, N 128 at chunk 128,
                 odd N and chunk, and x at an odd element offset; every
                 ssd instance the build made must have run in one of these
                 rows, and N 128 at chunk 256 must be refused before any
                 launch.  lockstep_peel is checked at LMBR's pow2 classes,
                 in both size classes (the C side's class choice must agree
                 with ``uses_shared_memory`` at the class edges), at the
                 fit's shapes ((K, U) 128 x 64 at G 1, 8 and 512, 64 x 64
                 and 64 x 32, 128 x 256), odd K and U, weights too heavy
                 for the packed argmin, and on a tie-heavy batch, where
                 the check must also reject ties broken to the highest
                 slot; its rows add ``device_ms`` and device us per round.
                 cover_rounds is also checked at fig9's path bucket
                 (14 027, 35, 1) and at each edge of its three classes
                 (the C side's class must agree with ``rounds_class``), on
                 tied best gains (the lowest id must win) and on queries
                 that go bad after good rounds; its rows add
                 ``device_ms``.
3. fit-stress  — ``Simulator(64, 50).run(lmbr_stress_workload(seed=0), lmbr,
                 seed=0, max_moves=1200)`` on the card with the dense peel
                 and the span_gain kernel pinned; the summary and member
                 matrix must equal the same call on the CPU bit for bit, and
                 every placement kernel must have launched.  The line gives
                 the peel launches by (K, U) class and the peel's rounds
                 (each launch's longest pair, summed).
4. fit-paper   — the same fit and CPU cross-check on the largest fig9
                 circuit (ibm10-like, 69 429 nodes, 35 partitions, capacity
                 ceil(n/20), max_moves 600).
5. paper-algos — the paper's six algorithms (random, hpa, ihpa, ds, pra,
                 lmbr) through ``Simulator(n, cap, device="cuda").run(hg,
                 ALGORITHMS[name], name=name, seed=0)`` with the dense peel
                 and the span_gain kernel pinned, at fig6's paper default
                 (``random_workload(1000, 4000, 3, 11, 20, seed=0)``, 40
                 partitions, capacity 50), IHPA alone at 30 partitions
                 (where its §4.2 shrink runs), and fig9's ibm01-like circuit
                 (12 752 nodes, 35 partitions, capacity 638, lmbr
                 ``max_moves=600``).  Each run must equal the same call on
                 the CPU bit for bit and its avg_span the JAX package's
                 (``PAPER_RUNS``, pinned by a CPU test); span_gain must
                 launch in every ihpa and ds run and in fig6's pra run,
                 cover_rounds in every fig9 run, lockstep_peel in every
                 lmbr run.  The line
                 gives each run's launches and the (B, N, W) of every
                 cover_rounds launch.
6. placement-api — the production API, the fixed-RF algorithms and the
                 bridges through the port's entry points at full size,
                 each run on the card and again at ``device="cpu"`` (each
                 inside its own partition memo), held against its CPU twin
                 and the JAX package's values (``API_HELD``, pinned by a
                 CPU test): ``PlacementService("lmbr").fit`` of fig8's
                 TPC-H-heterogeneous workload (2 000 items, 4 000
                 queries) on 45 partitions of 100 GB with a random
                 ``NodeProfile`` and ``durability_eps=0.05``, then its
                 avg_span on cover_rounds; ``refit`` on the seed-1 trace
                 under ``nodecost0.5`` with partitions 3 and 17 masked
                 (no copy may land there, the old plan must stay inside
                 the new one); ``fit_hierarchical`` at 4 pods x 10 hosts;
                 ``Simulator(60, 50).compare`` of the four 3-way
                 algorithms at fig. 6(f)-(h)'s paper point; an expert plan
                 for DeepSeek-V3's 256 experts, top-8, on 32 ranks x 9
                 slots against the contiguous layout; a pra3 shard plan
                 (1 000 shards, 2 000 recipes, 48 hosts, capacity 80)
                 whose spans run once more on the span engine.  Each run
                 must launch the kernels ``API_RUNS`` names; the line
                 gives its held values, walls and launches.
7. online      — online serving through the port's entry points, each run
                 on the card and again at ``device="cpu"`` (each inside its
                 own partition memo), held against its CPU twin and the JAX
                 package's values (``ONLINE_HELD``, pinned by a CPU test):
                 ``ReplicaRouter.route_csr`` of the lmbr-stress trace
                 (10 000 queries) on the random layout of 64 x 50 in
                 27 microbatches of 384, default and balanced (sha256s of
                 covers, pin attribution and ledger; every 97th default
                 cover against ``cover_for_query``), then its queries/s
                 pinned to cover_rounds, under ``auto`` and on the CPU;
                 ``Simulator(40, 50).run_online`` with the drift detector
                 on fig6's splice (2 000 queries of seed 0, then 4 000 of
                 seed 7; lmbr ``max_moves=120``, ``refit_moves=400``), with
                 three partitions failing and returning, and migrating the
                 random layout onto lmbr's paced by ``migbw1`` through an
                 outage (summaries, sha256s of spans and final member);
                 ``refit(as_migration=True)`` of that lmbr plan on the seed-1
                 queries (the schedule's JSON, copies only).  Each run must
                 launch the kernels ``ONLINE_RUNS`` names, and every kernel
                 exactly as often as the CPU twin's dispatch calls its
                 wrapper; the line gives its held values, walls and
                 launches.
8. serve       — ``repro_torch.launch.serve`` on hymba-1.5b at full width
                 and depth (32 layers, bf16, random weights from seed 0):
                 16 requests in batches of 8, prompt 2048, 64 greedy decode
                 steps; finite logits, prefill tokens/s, decode ms/step,
                 peak memory, and each model kernel's launch count, which
                 must be 32 x 2 (flash, ssd) and 32 x 64 x 2 (decode), every
                 flash launch on the tensor-core (wgmma) instance.
9. serve-check — hymba-1.5b at full width and 4 layers (global, window,
                 window, global) in f32 with TF32 off, prompt 1536: the
                 kernel route against the plain route on the card (logits
                 within 1e-3) and teacher-forced decode after prefill
                 against the cache-free forward (within 2e-3).
10. health     — ``Simulator(40, 50).run_online`` of fig6's paper default
                 (lmbr ``max_moves=120``) under the flags-built
                 ``HealthMonitor`` (``HEALTH_VARIANT``: snapshots every 100
                 queries, window 4, skew SLO 3.0), with a storm (partitions
                 3, 5 and 7 down at query 1 000, no automatic repair, a
                 repair pass at 2 500, back at 2 501) and with no events;
                 each run on the card and again at ``device="cpu"``, held
                 against its CPU twin and the JAX package's values
                 (``HEALTH_HELD``: the summary with ``alerts_fired`` /
                 ``alerts_resolved``, sha256s of spans and member, the
                 monitor's transitions); launches as the twin's dispatch.
                 The storm fires and resolves degraded_rate, and the same
                 storm unmonitored serves the same spans, access load and
                 member; the clean replay fires nothing.
11. scale      — the cluster-scale pipeline at bench_scale's sizes:
                 ``web_scale_chunks(seed=0)`` (100 000 items, 1 000 000
                 queries) through ``StreamingHypergraphBuilder``, plain and
                 with duplicates merged (host only); the sharded lmbr fits
                 fit-quick (10 000 items, 50 000 queries on 32 x 650, 8
                 shards) and web-mid (2 500 items, 10 000 queries on 24 x
                 210, 4 shards), serial, with their avg_span on the span
                 engine; ``PlacementService.fit_sharded`` of web-mid with
                 a profile and the durability pass.  Each run is held
                 against its CPU twin (run after the card runs) and the JAX
                 package's values (``SCALE_HELD``), with launches as the
                 twin's dispatch and the peel's launches printed by
                 (K, U) class; then fit-quick (on
                 min(8, cores), at least 2, workers) and web-mid (on 2)
                 once more with their shards on spawned card workers, each
                 equal to its serial fit.

``--profile`` runs each fit once more under torch.profiler and the
package's tracer, and one serving batch (prefill, 8 decode steps) under
torch.profiler, and prints where the time goes (for the fits also
lockstep_peel's device time per launch and per peel round and
cover_rounds' device time per launch; for
paper-algos, fig9's IHPA fit with span_gain's and cover_rounds' device
time per launch; for placement-api, service-fit split into HPA, the LMBR
move loop, the durability pass and the plan's spans, with each placement
kernel's device time per launch; for online, the drift run split into
the fit, routing, the refits and the rest, with the device's idle
share; for scale, fit-quick's serial fit split into its shard, fit,
merge and repair stages, with the device's idle share).

Then: the card's name and power limit (nvidia-smi), one JSON line with
every kernel's numbers, and the device line.  Any failed check raises and
the script exits non-zero without the device line.  Exits non-zero at once
when CUDA is unavailable or the package sources are missing.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM non-tensor fp32, NVIDIA data sheet
BF16_OPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores, data sheet
PHASES = ("build", "kernels", "fit-stress", "fit-paper", "paper-algos",
          "placement-api", "online", "serve", "serve-check", "health",
          "scale")
PAPER_NODES = 69429          # ibm10, the largest fig9 circuit
# paper-algos: the workloads (generator, arguments) and the runs (workload,
# partitions, capacity, algorithm, extra arguments, avg_span of the JAX
# package's ``Simulator(n, cap).run(hg, ALGORITHMS[name], name=name,
# seed=0, **extra)`` on the CPU; tests/test_torch_chip_smoke_constants.py
# recomputes every row)
PAPER_WORKLOADS = {
    "fig6": ("random_workload", dict(num_items=1000, num_queries=4000,
                                     min_query=3, max_query=11, density=20,
                                     seed=0)),
    "fig9-ibm01": ("ispd_like_workload", dict(num_nodes=12752, seed=0)),
}
PAPER_RUNS = (
    ("fig6", 40, 50, "random", {}, 6.309),
    ("fig6", 40, 50, "hpa", {}, 4.969),
    ("fig6", 40, 50, "ihpa", {}, 4.3455),
    ("fig6", 40, 50, "ds", {}, 4.51525),
    ("fig6", 40, 50, "pra", {}, 4.74225),
    ("fig6", 40, 50, "lmbr", {}, 4.21625),
    ("fig6", 30, 50, "ihpa", {}, 4.733),
    ("fig9-ibm01", 35, 638, "random", {}, 3.5707563983745634),
    ("fig9-ibm01", 35, 638, "hpa", {}, 1.1980466243672916),
    ("fig9-ibm01", 35, 638, "ihpa", {}, 1.0),
    ("fig9-ibm01", 35, 638, "ds", {}, 1.0),
    ("fig9-ibm01", 35, 638, "pra", {}, 1.0562486632922221),
    ("fig9-ibm01", 35, 638, "lmbr", dict(max_moves=600), 1.0),
)
# summary keys that record wall time or which backend ran
BACKEND_KEYS = {"placement_s", "fit_peel", "fit_cover_engine"}
# placement-api: the runs in order, each with its flag variant, the
# kernels it must launch (at least that many times) and the values it
# holds; every held value is what the JAX package gives for the same call
# on the CPU (tests/test_torch_chip_smoke_constants.py recomputes them)
API_RUNS = {
    "service-fit": ("peeldevice+spandevice",
                    {"span_gain": 1, "lockstep_peel": 1, "cover_rounds": 1}),
    "service-refit": ("peeldevice+spandevice+nodecost0.5",
                      {"span_gain": 1, "lockstep_peel": 1}),
    "service-hier": ("peeldevice+spandevice",
                     {"span_gain": 1, "lockstep_peel": 1}),
    # the replay bucket (4 000 queries x 60 partitions x 1 word) is above
    # span_round_threshold, so every replay goes whole to cover_rounds
    "three-way": ("spandevice", {"cover_rounds": 4}),
    "experts": ("peeldevice+spandevice",
                {"span_gain": 1, "lockstep_peel": 1}),
    "shards": ("spandevice", {"span_gain": 1}),
}
API_HELD = {
    "service-fit": dict(
        json_sha256="7e52dceb1dcb13a614e4720e5cc2813b"
                    "6142c57367233846cdcd3477291c6686",
        durability_copies=753, avg_span=1.00725),
    "service-refit": dict(
        json_sha256="835ee1bafb7f1f57abed46a5cf32f56f"
                    "6b1b1639ecb986c9a24528f2cd367d21",
        copies_added=169, avg_span_before=1.0895, avg_span_after=1.0685),
    "service-hier": dict(
        host_member_sha256="5b61d8000746f6520bdb777ea5d3ac22"
                           "1d9c3cbb82f9b04db849ad7f71a5bf36",
        mean_pod_span=1.0, mean_host_span=1.00825,
        mean_weighted_span=0.00825),
    "three-way": {
        "random3": dict(avg_span=5.036, member_sha256=(
            "ce9dfd3b451941d0c2ccf938f7b77db866f3ab852fdda3497c57ff4fd5d1c795")),
        "sda": dict(avg_span=4.30875, member_sha256=(
            "54548a69f494038c4be9bb0d92608eb4cd2076eb30203f79d539e83371715981")),
        "ihpa3": dict(avg_span=4.0025, member_sha256=(
            "22deb3ae0477c057f832917edc31f021164ea94344c8ab90902da70f6b6dd746")),
        "pra3": dict(avg_span=4.1935, member_sha256=(
            "18c8a0c137d4e8082b7bb5503d803eff0ccbd2704a37b65969911d2f3f436570")),
    },
    "experts": dict(
        member_sha256="3782656412f3e2f54eca33c6429c7425"
                      "18b536839c8b8202fc118bf3a0c7eb4e",
        tables_sha256="313b97ea0901d430e585e040188e8488"
                      "2c665eb0e240d3980d9bf450b84755b2",
        avg_span=4.028564453125, baseline_avg_span=7.18115234375),
    "shards": dict(
        member_sha256="a2edc84e8f2d2b7d8e6b7b485ef316df"
                      "d458ae160a1994686fc954e9abd6e830",
        survives_2_failures=True, avg_span=1.1255),
}


# online: the runs in order, each with its flag variant and the kernels it
# must launch (as many times as the CPU twin's dispatch calls their
# wrappers), the events of the failover and migration runs (the migrate
# target is the lmbr fit the run makes), and the held values, each what
# the JAX package gives for the same call on the CPU
# (tests/test_torch_chip_smoke_constants.py recomputes them)
ONLINE_RUNS = {
    # one 384-query microbatch at N 64, W 1 packs to 24 576 words, under
    # span_round_threshold, so the router reaches cover_rounds only pinned
    "router": ("spandevice+spanrounddevice", ("cover_rounds",)),
    "drift": ("peeldevice+spandevice", ("span_gain", "lockstep_peel")),
    "failover": ("peeldevice+spandevice", ("span_gain", "lockstep_peel")),
    "migration": ("peeldevice+spandevice+migbw1",
                  ("span_gain", "lockstep_peel")),
    "refit-migration": ("peeldevice+spandevice",
                        ("span_gain", "lockstep_peel")),
}
ONLINE_EVENTS = {
    "failover": ((400, "down", 7), (800, "down", 21), (1300, "up", 7),
                 (2000, "down", 33), (2600, "up", 21), (3300, "up", 33)),
    "migration": ((500, "migrate", None), (900, "down", 5),
                  (1800, "up", 5)),
}
ONLINE_HELD = {
    "router": {
        "default": {
            "cover_sha256": "8c2a15bbabc2f85fbddf645e86f49c3e"
                            "5e675762720d28d571fc0701ecce2b7b",
            "ledger_sha256": "12d34a15a983f43ffd8706e43fbb8112"
                             "de02f216ccf9961522d6c613bb9666fe",
            "avg_span": 6.6261,
            "load_imbalance": 1.3077979505289687,
            "microbatches": 27,
        },
        "balanced": {
            "cover_sha256": "ddb8a6cc06b7f7c260514204b2287a4d"
                            "26a774597f12f233725562e9c5b2dc5e",
            "ledger_sha256": "2d26ee51a7bc6f560d9dbadd9e7a70cd"
                             "27665bc86ef37971c743ee7e48a899d3",
            "avg_span": 6.6262,
            "load_imbalance": 1.307778213757508,
            "microbatches": 27,
        },
    },
    "drift": {
        "algorithm": 'lmbr+drift',
        "avg_span": 5.6605,
        "max_span": 11,
        "energy_kj": 15437.31,
        "shipped_gb": 30878.0,
        "rf": 1.8,
        "load_imbalance": 1.359,
        "active_machines": 36,
        "cluster_power_w": 9400.0,
        "fit_gain_calls": 11160,
        "fit_gain_cache_hits": 1126,
        "fit_gain_fp_hits": 2158,
        "fit_peel_pairs": 7456,
        "fit_moves": 120,
        "fit_gain_cache": True,
        "fit_lmbr_epochs": 'item',
        "fit_cache_hit_rate": 0.2942652329749104,
        "served_queries": 6000,
        "microbatches": 16,
        "plan_swaps": 2,
        "degraded_queries": 0,
        "partitions_down": 0,
        "repaired_items": 0,
        "unrepairable_items": 0,
        "drift_fires": 2,
        "refits": 2,
        "windowed_avg_span": 5.5762,
        "spans_sha256": "dac8007494ba93cd31b9703e36193937"
                        "433d710b6f4b80bf3761a84a6ba72744",
        "member_sha256": "fe79ce43b3c81fb8ffe7b04e47df2d11"
                         "683cff95bb528050ffcfb32e103335c4",
    },
    "failover": {
        "algorithm": 'lmbr',
        "avg_span": 5.1143,
        "max_span": 11,
        "energy_kj": 9655.53,
        "shipped_gb": 19244.0,
        "rf": 1.208,
        "load_imbalance": 1.605,
        "active_machines": 36,
        "cluster_power_w": 9400.0,
        "fit_gain_calls": 11160,
        "fit_gain_cache_hits": 1126,
        "fit_gain_fp_hits": 2158,
        "fit_peel_pairs": 7456,
        "fit_moves": 120,
        "fit_gain_cache": True,
        "fit_lmbr_epochs": 'item',
        "fit_cache_hit_rate": 0.2942652329749104,
        "served_queries": 4000,
        "microbatches": 14,
        "plan_swaps": 0,
        "degraded_queries": 0,
        "partitions_down": 3,
        "repaired_items": 76,
        "unrepairable_items": 0,
        "spans_sha256": "461c1d5cce2b26b9abcd2b8ceaa83172"
                        "8c438c438248d7efd5da67eea99675c6",
        "member_sha256": "f1346a443bfa8762fab0d7db3d136745"
                         "bdde5da170009acf2294a8b214dc6a42",
    },
    "migration": {
        "algorithm": 'random',
        "avg_span": 5.5365,
        "max_span": 11,
        "energy_kj": 10131.48,
        "shipped_gb": 20139.0,
        "rf": 1.152,
        "load_imbalance": 1.3,
        "active_machines": 37,
        "cluster_power_w": 9550.0,
        "served_queries": 4000,
        "microbatches": 13,
        "plan_swaps": 1,
        "degraded_queries": 0,
        "partitions_down": 1,
        "repaired_items": 24,
        "unrepairable_items": 0,
        "migrations": 1,
        "migration_copies": 1074,
        "migration_drops": 1942,
        "migration_transfer_gb": 1070.0,
        "migration_wasted_gb": 0.0,
        "migration_max_inflight_gb": 144.0,
        "migration_ticks": 1322,
        "migration_done": True,
        "spans_sha256": "ce2f037e02c520ddb7eb0d3b5370f44c"
                        "8f5cdffc3900e4c7ec07a8076b40a8f3",
        "member_sha256": "477a7a7f5aee7e2320a4273b5982f5d5"
                         "0aa8d57db2a068658e9119dcbe15b428",
    },
    "refit-migration": {
        "json_sha256": "0b28125648806818fa7d32ebcd51c3ef"
                       "00dc956a20ed369532eeb42c29cfe83d",
        "copies": 69,
        "drops": 0,
        "avg_span_before": 6.198,
        "avg_span_after": 5.9755,
    },
}

# health: fig6's paper default (lmbr, 120 moves, on 40 x 50) served under
# the flags-built health monitor, each run with its events and the values
# it holds, each what the JAX package gives for the same call on the CPU
# (tests/test_torch_chip_smoke_constants.py recomputes them).  The storm
# is benchmarks/bench_obs.py:239-244 at N 40: partitions 3, 5 and 7 down at
# query 1 000 with no automatic repair, a repair pass at 2 500, the
# partitions back at 2 501; degraded_rate fires and resolves.
HEALTH_VARIANT = ("peeldevice+spandevice+routermb64+obscounters+obssnap100"
                  "+obshealth1+healthw4+healthskew3.0")
HEALTH_OFF_VARIANT = "peeldevice+spandevice+routermb64"
HEALTH_KERNELS = ("span_gain", "lockstep_peel")
HEALTH_EVENTS = {
    "health-storm": ((1000, "down", 3), (1000, "down", 5),
                     (1000, "down", 7), (2500, "repair", 1),
                     (2501, "up", 3), (2501, "up", 5), (2501, "up", 7)),
    "health-clean": (),
}
HEALTH_HELD = {
    "health-storm": {
        "algorithm": "lmbr",
        "avg_span": 5.051,
        "max_span": 11,
        "energy_kj": 8262.24,
        "shipped_gb": 16384.0,
        "rf": 1.205,
        "load_imbalance": 1.524,
        "active_machines": 36,
        "cluster_power_w": 9400.0,
        "fit_gain_calls": 11160,
        "fit_gain_cache_hits": 1126,
        "fit_gain_fp_hits": 2158,
        "fit_peel_pairs": 7456,
        "fit_moves": 120,
        "fit_gain_cache": True,
        "fit_lmbr_epochs": "item",
        "fit_cache_hit_rate": 0.2942652329749104,
        "served_queries": 3471,
        "microbatches": 65,
        "plan_swaps": 0,
        "degraded_queries": 529,
        "partitions_down": 3,
        "repaired_items": 73,
        "unrepairable_items": 0,
        "alerts_fired": 1,
        "alerts_resolved": 1,
        "spans_sha256": "5ef4618ababddc8427fe38c814af3b4b"
                        "1dfe793dc9e3e196a36d06486e636268",
        "member_sha256": "fb2a258236d975e82be3f9821ed8ea14"
                         "fd4dbc777f33a1bbca5259e5a6d3afc3",
        "history": [["degraded_rate", "fire", 1192.0],
                    ["degraded_rate", "resolve", 2949.0]],
    },
    "health-clean": {
        "algorithm": "lmbr",
        "avg_span": 5.155,
        "max_span": 11,
        "energy_kj": 9701.92,
        "shipped_gb": 19338.0,
        "rf": 1.132,
        "load_imbalance": 1.344,
        "active_machines": 36,
        "cluster_power_w": 9400.0,
        "fit_gain_calls": 11160,
        "fit_gain_cache_hits": 1126,
        "fit_gain_fp_hits": 2158,
        "fit_peel_pairs": 7456,
        "fit_moves": 120,
        "fit_gain_cache": True,
        "fit_lmbr_epochs": "item",
        "fit_cache_hit_rate": 0.2942652329749104,
        "served_queries": 4000,
        "microbatches": 63,
        "plan_swaps": 0,
        "degraded_queries": 0,
        "partitions_down": 0,
        "repaired_items": 0,
        "unrepairable_items": 0,
        "alerts_fired": 0,
        "alerts_resolved": 0,
        "spans_sha256": "a3240cb2093616a28c47ce2edf640071"
                        "a797bd4b15235495d77873bb2882ad21",
        "member_sha256": "3ce9afb3ff3a1d59610752b5649abd42"
                         "b383ef441104c33264ec53ba706a993e",
        "history": [],
    },
}

# scale: benchmarks/bench_scale.py's streaming tier and sharded fits
# (:127-130, :248-265) through the port's entry points, each run with the
# kernels it must launch (as often as the CPU twin's dispatch calls their
# wrappers) and the values it holds, each what the JAX package gives for
# the same call on the CPU (tests/test_torch_chip_smoke_constants.py
# recomputes them).  Each fit: the web_scale_workload arguments,
# partitions, capacity and fit arguments; the pooled runs' worker counts
# (fit-quick's follows the host's cores, as bench_scale's does).
SCALE_VARIANT = "peeldevice+spandevice"
SCALE_RUNS = {
    "stream": (),
    "fit-quick": ("span_gain", "lockstep_peel", "cover_rounds"),
    "web-mid": ("span_gain", "lockstep_peel", "cover_rounds"),
    "service": ("span_gain", "lockstep_peel"),
}
SCALE_FITS = {
    "fit-quick": (dict(num_items=10_000, num_queries=50_000,
                       num_clusters=256, seed=0), 32, 650,
                  dict(num_shards=8, max_moves=100, boundary_repair=64)),
    "web-mid": (dict(num_items=2500, num_queries=10_000, num_clusters=48,
                     cross_frac=0.05, seed=0), 24, 210,
                dict(num_shards=4, max_moves=150, boundary_repair=128)),
}
SCALE_POOLED = {"fit-quick": None, "web-mid": 2}
SCALE_STATS = ("shards", "components", "boundary_edges", "boundary_cost",
               "shard_moves", "repair_moves")
SCALE_SECONDS = ("shard_seconds", "fit_seconds", "merge_seconds",
                 "repair_seconds")
SCALE_SERVICE_EPS = 0.02
SCALE_HELD = {
    "stream": {
        "plain": {
            "edges": 1000000,
            "pins": 4780516,
            "csr_sha256": "1518c176106344986f15ace5c9fd80b0"
                          "0aba43b847c485089035d7902c52e59a",
        },
        "merged": {
            "edges": 966454,
            "pins": 4671425,
            "csr_sha256": "268999a5a46c625410a2e24e3aaee6be"
                          "84947030bed31fe8f590cbaa48f1f428",
        },
    },
    "fit-quick": {
        "shards": 8,
        "components": 2,
        "boundary_edges": 7933,
        "boundary_cost": 10025.0,
        "shard_moves": 255,
        "repair_moves": 64,
        "member_sha256": "e9e1ef48e90f7306536a85d2742081b0"
                         "bade42de63ff9796eb0446db6b1ef4c1",
        "avg_span": 1.41094,
    },
    "web-mid": {
        "shards": 4,
        "components": 1,
        "boundary_edges": 1783,
        "boundary_cost": 1799.0,
        "shard_moves": 232,
        "repair_moves": 128,
        "member_sha256": "7f106e3596d76c0185fb0cb77a9f4ee4"
                         "0f741ca950753eb6baa05614b5ead85f",
        "avg_span": 1.3408,
    },
    "service": {
        "json_sha256": "65431e2e4484b88fde6f19aadaa69051"
                       "aaf91937ef981e9904ae633dc40c9884",
        "algorithm": "lmbr+sharded",
        "durability_copies": 965,
        "shards": 4,
        "components": 1,
        "boundary_edges": 1783,
        "boundary_cost": 1799.0,
        "shard_moves": 232,
        "repair_moves": 128,
    },
}

def _bound_ms(nbytes: float, ops: float,
              peak: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _cuda_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_times(torch, fn, iters: int) -> dict:
    """Device ms per call of each kernel (by name) that ``iters`` calls of
    ``fn`` launch: the profiler's self device time over ``iters`` (empty
    when the profiler saw no device activity).  Unlike ``_cuda_ms`` it
    leaves out the host's share of a call that the device waits for."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def _device_ms(torch, fn, iters: int) -> float | None:
    """Device time per call of everything ``fn`` launches (None when the
    profiler saw no device activity)."""
    times = _device_times(torch, fn, iters)
    return sum(times.values()) if times else None


def _fmt_ms(x) -> str:
    return "not_measured" if x is None else f"{x:.4f}"


def _max_abs(got, want) -> float:
    diffs = [float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
             for g, w in zip(got, want)]
    return max(diffs)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------------ inputs
def _span_inputs(np, torch, rng, A, N, W, dev):
    codes = rng.integers(0, 2**64, size=(A, N, W), dtype=np.uint64)
    rem = rng.integers(0, 2**64, size=(A, W), dtype=np.uint64)
    # all-ones words, the sign bit of the int64 view included
    codes[: A // 8, 0, :] = np.uint64(0xFFFFFFFFFFFFFFFF)
    rem[: A // 16, :] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return (torch.from_numpy(codes.view(np.int64)).to(dev),
            torch.from_numpy(rem.view(np.int64)).to(dev))


def _cover_inputs(np, torch, rng, B, N, W, dev, copies=3):
    """Packed buckets whose every pin is stored on 1..copies partitions;
    a few queries fill a whole word on one partition."""
    lo = 3 if W == 1 else 64 * (W - 1) + 1
    hi = 11 if W == 1 else 64 * W
    sizes = rng.integers(lo, hi + 1, size=B)
    sizes[: max(1, B // 100)] = 64 * W
    codes = np.zeros((B, N, W), dtype=np.uint64)
    rem = np.zeros((B, W), dtype=np.uint64)
    for b in range(B):
        s = int(sizes[b])
        for j in range(s):
            rem[b, j // 64] |= np.uint64(1) << np.uint64(j % 64)
        if b < max(1, B // 100):
            codes[b, int(rng.integers(N)), :] = rem[b]
            continue
        j = np.arange(s)
        for _ in range(int(rng.integers(1, copies + 1))):
            parts = rng.integers(0, N, size=s)
            np.bitwise_or.at(codes[b], (parts, j // 64),
                             np.uint64(1) << (j % 64).astype(np.uint64))
    return (torch.from_numpy(codes.view(np.int64)).to(dev),
            torch.from_numpy(rem.view(np.int64)).to(dev))


def _peel_inputs(np, torch, rng, G, K, U, dev):
    """Integer-weight peel batch: every edge holds 1..4 of its pair's valid
    item slots; weights below 2^24 in total."""
    nvalid = rng.integers(max(1, U // 2), U + 1, size=G).astype(np.int32)
    pins = (rng.random((G, K, 4)) * nvalid[:, None, None]).astype(np.int64)
    cnt = rng.integers(1, 5, size=(G, K))
    keep = np.arange(4)[None, None, :] < cnt[:, :, None]
    g_idx = np.broadcast_to(np.arange(G)[:, None, None], pins.shape)[keep]
    k_idx = np.broadcast_to(np.arange(K)[None, :, None], pins.shape)[keep]
    inc = torch.zeros(G * K * U, dtype=torch.float32, device=dev)
    inc[torch.from_numpy((g_idx * K + k_idx) * U + pins[keep]).to(dev)] = 1.0
    we = rng.integers(1, 9, size=(G, K)).astype(np.float32)
    nodew = rng.integers(1, 5, size=(G, U)).astype(np.float32)
    nodew[np.arange(U)[None, :] >= nvalid[:, None]] = 0.0
    return (inc.view(G, K, U), torch.from_numpy(we).to(dev),
            torch.from_numpy(nodew).to(dev), torch.from_numpy(nvalid).to(dev))


def _peel_tie_inputs(torch, G, K, U, dev):
    """Equal weights over a regular incidence: pair g's edge k holds slots
    k mod U and (k + 1 + g) mod U, every slot valid, so every degree starts
    equal and most rounds are decided by the lowest-slot rule."""
    k = torch.arange(K, device=dev)
    inc = torch.zeros((G, K, U), dtype=torch.float32, device=dev)
    for g in range(G):
        inc[g, k, k % U] = 1.0
        inc[g, k, (k + 1 + g) % U] = 1.0
    return (inc, torch.ones((G, K), device=dev),
            torch.ones((G, U), device=dev),
            torch.full((G,), U, dtype=torch.int32, device=dev))


def _peel_highest_slot(torch, plain, inc, we, nodew, nv):
    """The plain peel with ties broken to the highest slot (every slot
    valid): the plain version over the slots in reverse order, mapped
    back."""
    U = inc.shape[2]
    _require(bool((nv == U).all()), "highest-slot variant needs nvalid U")
    peel, rtot, rben = plain(inc.flip(2).contiguous(), we,
                             nodew.flip(1).contiguous(), nv)
    return torch.where(peel >= 0, U - 1 - peel, peel), rtot, rben


# ------------------------------------------------------------------ phases
def _ptxas_entries(report: str) -> list[dict]:
    """Each kernel entry of a ``ptxas -v`` report: its source, mangled name,
    registers and spill bytes."""
    out, source, entry, spills = [], None, None, (0, 0)
    for line in report.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry, spills = m.group(1), (0, 0)
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line):
            spills = (int(m.group(1)), int(m.group(2)))
        if (m := re.search(r"Used (\d+) registers", line)) and entry:
            out.append(dict(source=source, entry=entry,
                            registers=int(m.group(1)),
                            spill_stores=spills[0], spill_loads=spills[1]))
            entry = None
    return out


def _ssd_instance(entry: str):
    """(pass, x dtype, P) of an ssd_scan kernel's mangled name; the chain
    pass has neither dtype nor P."""
    m = re.search(r"ssd_scan_(state|chain|output)_kernel", entry)
    if not m:
        return None
    if m.group(1) == "chain":
        return ("chain", None, None)
    p = re.search(r"Li(\d+)E", entry)
    return (m.group(1), "bf16" if "__nv_bfloat16" in entry else "f32",
            int(p.group(1)))


def phase_build(_build):
    so = _build.build(force=True)
    entries = _ptxas_entries(_build.BUILD_INFO["ptxas"])
    tc = [e for e in entries if "flash_attention_wgmma_kernel" in e["entry"]]
    _require(len(tc) == 1, "build: no ptxas report of the tensor-core "
             "flash_attention instance")
    # the decode instance of the serving path: bf16, G = 5
    dec = [e for e in entries
           if "decode_attention_kernelI13__nv_bfloat16Li5E" in e["entry"]]
    _require(len(dec) == 1, "build: no ptxas report of the bf16 G 5 "
             "decode_attention instance")
    # every ssd_scan instance: (pass, x dtype, P) -> registers and spills
    ssd = {_ssd_instance(e["entry"]): e for e in entries
           if _ssd_instance(e["entry"])}
    serving = [("state", "bf16", 64), ("chain", None, None),
               ("output", "bf16", 64)]
    for inst in serving:
        _require(inst in ssd, f"build: no ptxas report of ssd_scan {inst}")
        e = ssd[inst]
        _require(e["spill_stores"] == 0 and e["spill_loads"] == 0,
                 f"build: the serving ssd_scan instance {inst} spills "
                 f"({e['spill_stores']} / {e['spill_loads']} bytes)")
    ssd_line = ", ".join(
        f"{k[0]}{'' if k[1] is None else f' {k[1]} P {k[2]}'} "
        f"registers={e['registers']} spills={e['spill_stores']}/"
        f"{e['spill_loads']}"
        for k, e in sorted(ssd.items(), key=lambda kv: str(kv[0])))
    print(f"build: {_build.BUILD_INFO['seconds']:.2f} s -> {Path(so).name} "
          f"flash_attention wgmma instance: registers={tc[0]['registers']} "
          f"spill_stores={tc[0]['spill_stores']} "
          f"spill_loads={tc[0]['spill_loads']}; decode_attention bf16 G 5 "
          f"instance: registers={dec[0]['registers']} "
          f"spill_stores={dec[0]['spill_stores']} "
          f"spill_loads={dec[0]['spill_loads']}; ssd_scan instances "
          f"(spill stores/loads bytes): {ssd_line}", flush=True)
    for e in entries:
        print(f"  {e['source']} {e['entry'][:60]} registers={e['registers']} "
              f"spill_stores={e['spill_stores']} "
              f"spill_loads={e['spill_loads']}")
    return set(ssd)


def phase_kernels(np, torch, dev):
    from repro_torch import _build
    from repro_torch.kernels.cover_rounds.ops import (
        cover_rounds, cover_rounds_plain, rounds_class)
    from repro_torch.kernels.lockstep_peel.ops import (
        lockstep_peel, lockstep_peel_plain, uses_shared_memory)
    from repro_torch.kernels.span_gain.ops import span_gains, span_gains_plain

    rng = np.random.default_rng(0)
    rows = {}

    # span_gain: one greedy round of 4096 active queries
    sg = []
    for N in (35, 64, 256):
        for W in (1, 2):
            c, r = _span_inputs(np, torch, rng, 4096, N, W, dev)
            got, want = span_gains(c, r), span_gains_plain(c, r)
            torch.cuda.synchronize()
            err = _max_abs([got], [want])
            _require(err == 0, f"span_gain N={N} W={W}: max|diff| {err}")
            A = 4096
            nbytes = A * N * W * 8 + A * W * 8 + A * N * 4
            bound, by = _bound_ms(nbytes, 3 * A * N * W)
            sg.append(dict(shape=f"A4096.N{N}.W{W}", max_abs_err=err,
                           ms=_cuda_ms(torch, lambda: span_gains(c, r), 200),
                           plain_ms=_cuda_ms(
                               torch, lambda: span_gains_plain(c, r), 20),
                           bound_ms=bound, bound_by=by))
    rows["span_gain"] = dict(sg[2], shapes=sg)   # stress tier: N=64, W=1

    # cover_rounds: the class the C side picks agrees with ops.py at the
    # class edges
    lib = _build.lib()
    classes = ("register", "shared", "global")
    for N in (0, 1, 31, 32, 33, 64, 65, 128, 129, 255, 256, 257, 1024, 1025,
              2048, 2049, 65536):
        for W in (0, 1, 2, 3, 7, 8, 9, 32):
            _require(rounds_class(N, W)
                     == classes[lib.cover_rounds_class(N, W)],
                     f"cover_rounds class of N={N} W={W}: ops.py and the "
                     "source disagree")
    # the stress tier's full bucket (10 000 queries, N 64, W 1), a
    # multi-word bucket, one over the warp classes, fig9's path bucket
    # (14 027 queries, N 35, W 1), then each class edge: the rows a lane
    # holds in the register class (32 / 33, 64 / 65, 128 / 129, 256), the
    # shared class past it (N 257 at W 1) up to 2048 words (N 2048 at W 1,
    # N 256 at W 8), and one past that (global)
    cr = []
    cases = [(10_000, 64, 1), (2_000, 35, 2), (64, 256, 32), (14_027, 35, 1),
             (4096, 32, 1), (4096, 33, 1), (4096, 65, 1), (4096, 128, 1),
             (4096, 129, 1), (4096, 256, 1), (2048, 257, 1), (512, 2048, 1),
             (512, 2049, 1), (1024, 256, 8), (1024, 257, 8), (1024, 40, 5),
             (512, 16, 9)]
    for i, (B, N, W) in enumerate(cases):
        c, r = _cover_inputs(np, torch, rng, B, N, W, dev)
        (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
        torch.cuda.synchronize()
        err = _max_abs([ch, bad.int()], [ch_p, bad_p.int()])
        _require(err == 0, f"cover_rounds B={B} N={N} W={W}: max|diff| {err}")
        _require(not bool(bad.any()), "coverable bucket flagged bad")
        spans = (ch_p >= 0).sum(dim=1)
        Rmax = ch.shape[1]
        nbytes = B * N * W * 8 + B * W * 8 + B * Rmax * 4 + B
        ops = float(spans.sum()) * N * (3 * W + 1)
        bound, by = _bound_ms(nbytes, ops)
        times = _device_times(torch, lambda: cover_rounds(c, r), 50)
        dev_ms = sum(t for k, t in times.items() if "cover_rounds" in k)
        cr.append(dict(shape=f"B{B}.N{N}.W{W}", cls=rounds_class(N, W),
                       max_abs_err=err,
                       ms=_cuda_ms(torch, lambda: cover_rounds(c, r), 50),
                       device_ms=dev_ms if times else None,
                       plain_ms=_cuda_ms(
                           torch, lambda: cover_rounds_plain(c, r), 3)
                       if i < 4 else None,
                       bound_ms=bound, bound_by=by,
                       spans_max=int(spans.max())))
    _require({row["cls"] for row in cr} == set(classes),
             "a cover_rounds class was not exercised")
    _require(cr[0]["cls"] == cr[3]["cls"] == "register",
             "a path shape of cover_rounds left the register class")
    # equal best gains: every query stores all its pins on two or more
    # partitions (on one lane or on several); the lowest id must win, and
    # the check must be able to see a highest-id rule
    for B, N, W in ((4096, 35, 1), (4096, 256, 1), (1024, 100, 3),
                    (64, 256, 32)):
        c, r = _cover_inputs(np, torch, rng, B, N, W, dev)
        tied = torch.from_numpy(rng.random((B, N)) < 4.0 / N).to(dev)
        tied[:, 5] = tied[:, 37 % N] = True
        c = torch.where(tied[:, :, None], r[:, None, :], c)
        # every partition that stores all the pins (a few queries of the
        # inputs already hold one)
        tied = ((c & r[:, None, :]) == r[:, None, :]).all(dim=2)
        (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
        low = torch.argmax(tied.int(), dim=1).int()
        high = N - 1 - torch.argmax(tied.flip(1).int(), dim=1).int()
        _require(torch.equal(ch, ch_p) and torch.equal(bad, bad_p),
                 f"cover_rounds ties B={B} N={N} W={W}: kernel and plain "
                 "version differ")
        _require(torch.equal(ch[:, 0], low) and bool((ch[:, 1] == -1).all()),
                 f"cover_rounds ties N={N} W={W}: not the lowest id")
        _require(bool((high != low).all()), "tie check cannot see a "
                 "highest-id rule")
    # an uncoverable query is flagged, the others still resolve
    c, r = _cover_inputs(np, torch, rng, 8, 16, 1, dev)
    c[3] = 0
    (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
    _require(bad.tolist() == bad_p.tolist() and bool(bad[3])
             and int(bad.sum()) == 1, "bad flag mismatch")
    _require(torch.equal(ch, ch_p), "cover_rounds bad-row chosen mismatch")
    # queries that go bad after good rounds (pin 0 stored nowhere) keep
    # their earlier choices, in every class; a spoiled query that uses all
    # N partitions first ends at Rmax, not bad, as in the reference
    for B, N, W in ((14_027, 35, 1), (2_000, 35, 2), (64, 256, 32)):
        c, r = _cover_inputs(np, torch, rng, B, N, W, dev)
        spoil = torch.from_numpy(rng.random(B) < 0.05).to(dev)
        c[:, :, 0] = torch.where(spoil[:, None], c[:, :, 0] & ~1, c[:, :, 0])
        (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
        _require(torch.equal(bad, bad_p) and bool(bad.any())
                 and not bool((bad & ~spoil).any()),
                 f"cover_rounds late-bad B={B} N={N} W={W}: bad flags")
        _require(torch.equal(ch, ch_p),
                 f"cover_rounds late-bad B={B} N={N} W={W}: chosen mismatch")
        _require(bool((ch[bad, 0] >= 0).any()),
                 "no query went bad after a good round")
    rows["cover_rounds"] = dict(cr[0], shapes=cr)

    # lockstep_peel: the size class the C side picks agrees with ops.py at
    # the class edges
    for K in (0, 1, 31, 32, 33, 255, 256, 257, 1024, 8192, 65536):
        for U in (1, 31, 32, 33, 255, 256, 257, 512):
            _require(uses_shared_memory(K, U)
                     == bool(lib.lockstep_peel_uses_shared_memory(K, U)),
                     f"lockstep_peel size class of K={K} U={U}: ops.py and "
                     "the source disagree")
    # pow2 classes of the LMBR dispatch (at most 2^22 floats per launch):
    # the widest warp class, then the global-scratch class, with the scale
    # fits' heaviest cells (K, U) (4096, 1024), (4096, 512) and (2048, 512);
    # then the warp class at fit-stress's and fit-paper's shapes: (128, 64)
    # at G 1, 8 (the headline) and 512 (a full launch), (64, 64) and
    # (64, 32), odd K and U, fit-paper's widest class (128, 256), a
    # tie-heavy batch, and weights too heavy for the packed argmin
    lp = []
    cases = [((256, 256, 64), "random"), ((64, 1024, 64), "random"),
             ((1, 8192, 512), "random"), ((1, 4096, 1024), "random"),
             ((2, 4096, 512), "random"), ((2, 2048, 512), "random"),
             ((1, 128, 64), "random"),
             ((8, 128, 64), "random"), ((512, 128, 64), "random"),
             ((3, 64, 64), "random"), ((3, 64, 32), "random"),
             ((4, 101, 97), "random"), ((3, 128, 256), "random"),
             ((8, 128, 64), "ties"),
             ((8, 128, 64), "heavy")]
    for (G, K, U), kind in cases:
        if kind == "ties":
            inc, we, nodew, nv = _peel_tie_inputs(torch, G, K, U, dev)
        else:
            inc, we, nodew, nv = _peel_inputs(np, torch, rng, G, K, U, dev)
        if kind == "heavy":
            # totals past 2^21 (still below 2^24): the kernel's argmin
            # cannot pack degree and slot into one key
            we = we * 16384.0
        got = lockstep_peel(inc, we, nodew, nv)
        want = lockstep_peel_plain(inc, we, nodew, nv)
        torch.cuda.synchronize()
        err = _max_abs(got, want)
        label = f"G{G}.K{K}.U{U}" + ("" if kind == "random" else f".{kind}")
        _require(err == 0, f"lockstep_peel {label}: max|diff| {err}")
        extra = {}
        if kind == "ties":
            # the check sees the tie rule: ties to the highest slot differ
            high = _peel_highest_slot(torch, lockstep_peel_plain, inc, we,
                                      nodew, nv)
            _require(not torch.equal(high[0], got[0]),
                     f"lockstep_peel {label}: the check cannot see ties "
                     "broken to the highest slot")
            extra["highest_slot_peels_differ"] = int(
                (high[0] != got[0]).sum())
        rounds = (want[0] >= 0).sum(dim=1).double()
        nbytes = (G * K * U * 4 + G * K * 4 + G * U * 4 + G * 4
                  + 3 * G * U * 4)
        # degree build + updates (2 K U each) and per-round argmin + column
        design_ops = float((4.0 * K * U + rounds * (U + K)).sum())
        bound, by = _bound_ms(nbytes, design_ops)
        dev_ms = _device_ms(torch, lambda: lockstep_peel(inc, we, nodew, nv),
                            20)
        lp.append(dict(shape=label, max_abs_err=err,
                       smem=uses_shared_memory(K, U),
                       ms=_cuda_ms(torch,
                                   lambda: lockstep_peel(inc, we, nodew, nv),
                                   20),
                       device_ms=dev_ms,
                       plain_ms=_cuda_ms(
                           torch,
                           lambda: lockstep_peel_plain(inc, we, nodew, nv),
                           2),
                       bound_ms=bound, bound_by=by,
                       rounds_max=int(rounds.max()),
                       device_us_per_round=(
                           None if dev_ms is None or not rounds.max()
                           else dev_ms * 1e3 / float(rounds.max())),
                       design_ops=design_ops,
                       tpu_design_ops=float(rounds.max()) * 2 * K * U * G,
                       **extra))
    _require(not any(r["smem"] for r in lp[1:6]),
             "a global-scratch peel shape left its class")
    _require(all(r["smem"] for r in lp[6:]), "a warp-class peel shape left "
             "the warp class")
    rows["lockstep_peel"] = dict(lp[7], shapes=lp)   # (128, 64) at G 8

    parts = []
    for name, row in rows.items():
        parts.append(f"{name} max|diff|={row['max_abs_err']:g} "
                     f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                     f"bound_ms={row['bound_ms']:.5f}")
    print("kernels: " + "; ".join(parts), flush=True)
    for name, row in rows.items():
        for s in row["shapes"]:
            print(f"  {name} {json.dumps(s)}")
    return rows


# hymba-1.5b serving shapes: batch 8, 25 query / 5 kv heads of 64, a 2048-
# token prompt and 64 decode steps (cache 2112), 50 SSM heads of 64,
# state 16, chunk 256
SERVE = dict(batch=8, requests=16, prefill_len=2048, decode_len=64)
# Kernel and plain version both compute in fp32 and round once on the bf16
# store, so their outputs differ by at most one bf16 ulp of the output
# (2^-7 of |x| at most; atol covers the fp32 difference near zero), and only
# where the two fp32 values straddle a rounding boundary, which is rare.
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_DIFF_SHARE = 0.01                # largest share of differing elements
TOL32 = dict(rtol=2e-4, atol=2e-4)    # f32


def _close(torch, got, want, tol) -> bool:
    return all(bool(torch.allclose(g.float(), w.float(), **tol))
               for g, w in zip(got, want))


def _attention_check(torch, label, dtype, got, want, plain32, unmasked):
    """Hold an attention kernel's output against its plain version and
    show that the check rejects two wrong variants: the plain version
    without the window mask (``unmasked``, window layers only) and, in
    bf16, a store that truncates the fp32 result (``plain32``) instead of
    rounding it.  Returns the row's check fields."""
    err = _max_abs([got], [want])
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL32
    _require(_close(torch, [got], [want], tol),
             f"{label}: max|diff| {err}")
    out = dict(max_abs_err=err)
    if dtype == torch.bfloat16:
        share = float((got != want).float().mean())
        _require(share <= BF16_DIFF_SHARE,
                 f"{label}: {share:.4%} of the bf16 outputs differ")
        trunc = (plain32.view(torch.int32) & -65536).view(torch.float32)
        trunc_share = float((trunc.to(dtype) != want).float().mean())
        _require(trunc_share > BF16_DIFF_SHARE,
                 f"{label}: the check cannot see a truncating store")
        out.update(bf16_diff_share=share, trunc_store_share=trunc_share,
                   trunc_store_err=_max_abs([trunc], [want]))
    if unmasked is not None:
        out["no_window_err"] = _max_abs([unmasked], [want])
        _require(not _close(torch, [unmasked], [want], tol),
                 f"{label}: the check cannot see a missing window mask")
    return out


def _flash_rows(torch, randn, dev, dtype, peak, B, S, H, K, D):
    """flash_attention at (B, S = T, H, K, D) in the global and window-1024
    layers: the check against the plain version and the times."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain, instance)

    esz = torch.finfo(dtype).bits // 8
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    q = randn(B, S, H, D).to(dtype)
    k, v = randn(B, S, K, D).to(dtype), randn(B, S, K, D).to(dtype)
    qT, kT, vT = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    wants, rows = {}, []
    for window in (None, 1024):
        got = flash_attention(q, k, v, window=window)
        wants[window] = want = flash_attention_plain(q, k, v, window=window)
        plain32 = (flash_attention_plain(q.float(), k.float(), v.float(),
                                         window=window)
                   if dtype == torch.bfloat16 else None)
        torch.cuda.synchronize()
        check = _attention_check(
            torch, f"flash_attention {tag} S={S} window={window}", dtype, got,
            want, plain32, wants[None] if window else None)
        del got, plain32
        qi = torch.arange(S, device=dev)[:, None]
        kj = torch.arange(S, device=dev)[None, :]
        mask = kj <= qi
        if window is not None:
            mask &= kj > qi - window
        pairs = float(mask.sum())
        nbytes = (2 * B * S * H * D + 2 * B * S * K * D) * esz
        bound, by = _bound_ms(nbytes, 4.0 * D * pairs * B * H, peak)
        rows.append(dict(
            shape=f"B{B}.S{S}.H{H}.K{K}.D{D}.{tag}.w{window}",
            instance=instance(dtype, D),
            **check,
            ms=_cuda_ms(torch, lambda: flash_attention(
                q, k, v, window=window), 5),
            plain_ms=_cuda_ms(torch, lambda: flash_attention_plain(
                q, k, v, window=window), 2),
            library_ms=_cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qT, kT, vT, attn_mask=mask, enable_gqa=True), 5),
            bound_ms=bound, bound_by=by))
    return rows


def _decode_domain_rows(torch, dev, dtype):
    """decode_attention beyond the serving shape, through the same check:
    (a) a ring buffer that wrapped (positions out of slot order), empty
    slots, one row with nothing visible, per-row q_pos, T no multiple of
    the 64-slot chunks the splits take; (b) the same with a window of 40,
    under one chunk; (c) D 32 with G 1 and D 128 with G 8; (d) batch 1 at
    the serving cache, global and window 1024; and serve's warm-up step,
    batch 1 with 17 of 18 slots filled (one split), windows none, 8 and
    1024, its q a view at an odd element offset (only k and v must be
    16-byte aligned)."""
    from repro_torch.kernels.decode_attention.ops import (
        CHUNK, decode_attention, decode_attention_plain, resident_blocks,
        split_plan)

    gen = torch.Generator(device=dev).manual_seed(14)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    # fill: slots 0 .. fill - 1 hold positions 0 .. fill - 1; None: a ring
    cases = (  # label, B, H, K, D, T, fill, windows
        ("ring", 8, 25, 5, 64, 1000, None, (None, 40)),
        ("D32.G1", 2, 4, 4, 32, 777, None, (None, 40)),
        ("D128.G8", 2, 16, 2, 128, 1500, None, (None, 40)),
        ("batch1", 1, 25, 5, 64, 2112, 2080, (None, 1024)),
        ("warmup", 1, 25, 5, 64, 18, 17, (None, 8, 1024)),
    )
    rows = []
    for label, B, H, K, D, T, fill, windows in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        if label == "warmup":
            q = randn(B * H * D + 1).to(dtype)[1:].view(B, H, D)
            _require(q.data_ptr() % 16 != 0, "decode warmup: q is aligned")
        else:
            q = randn(B, H, D).to(dtype)
        k, v = randn(B, T, K, D).to(dtype), randn(B, T, K, D).to(dtype)
        slot = torch.arange(T, device=dev, dtype=torch.int32)
        if fill is None:
            roll = torch.tensor([0, 17, 150, 611, 3, 999, 500, 64][:B],
                                device=dev, dtype=torch.int32)
            kv_pos = ((slot[None] - roll[:, None]) % T).to(torch.int32)
            kv_pos[min(2, B - 1), :30] = -1
            if B > 3:
                kv_pos[3] = -1
            q_pos = torch.randint(60, T, (B,), generator=gen, device=dev,
                                  dtype=torch.int32)
        else:
            kv_pos = torch.where(slot < fill, slot, -1)[None].expand(B, T)
            q_pos = torch.full((B,), fill - 1, dtype=torch.int32, device=dev)
        kv_pos = kv_pos.contiguous()
        ns = split_plan(B, K, T, resident_blocks(
            torch.cuda.current_device(), H // K))
        if fill is None:
            _require(T % CHUNK != 0, f"decode {label}: T {T} is a multiple "
                     f"of the {CHUNK}-slot chunk the splits are cut into")
        wants = {}
        for window in windows:
            got = decode_attention(q, k, v, kv_pos, q_pos, window=window)
            wants[window] = want = decode_attention_plain(
                q, k, v, kv_pos, q_pos, window=window)
            plain32 = (decode_attention_plain(q.float(), k.float(),
                                              v.float(), kv_pos, q_pos,
                                              window=window)
                       if dtype == torch.bfloat16 else None)
            torch.cuda.synchronize()
            # the no-window variant is a wrong kernel only where the window
            # hides a slot that is otherwise visible (not so at warm-up's
            # 1024)
            seen = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
            hides = window is not None and bool(
                (seen & (kv_pos <= q_pos[:, None] - window)).any())
            check = _attention_check(
                torch, f"decode_attention {label} {tag} window={window}",
                dtype, got, want, plain32, wants[None] if hides else None)
            rows.append(dict(shape=f"{label}.B{B}.T{T}.H{H}.K{K}.D{D}.{tag}"
                             f".w{window}", splits=ns, **check))
    return rows


def _ssd_serving_row(torch, randn, dtype):
    """ssd_scan at hymba-1.5b's prefill (B 8, S 2048, 50 heads of 64, state
    16, chunk 256) from a nonzero h0: the check against the plain version
    (which must also refuse the scan with h0 dropped), times per call and
    per pass, and the bound of the work."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain

    B, S = SERVE["batch"], SERVE["prefill_len"]
    NH, P, N, L = 50, 64, 16, 256
    esz = torch.finfo(dtype).bits // 8
    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    x = randn(B, S, NH, P).to(dtype)
    dt = F.softplus(randn(B, S, NH) - 1.0)
    a = -torch.exp(randn(NH, scale=0.3))
    bm, cm = randn(B, S, N, scale=0.3), randn(B, S, N, scale=0.3)
    h0 = randn(B, NH, P, N, scale=0.1)
    got = ssd_scan(x, dt, a, bm, cm, chunk=L, h0=h0)
    want = ssd_scan_plain(x, dt, a, bm, cm, chunk=L, h0=h0)
    torch.cuda.synchronize()
    err = _max_abs(got, want)
    _require(_close(torch, got, want, TOL32),
             f"ssd_scan {tag}: max|diff| {err}")
    # a kernel that dropped h0 (started from zero) must fail the check
    no_h0 = ssd_scan_plain(x, dt, a, bm, cm, chunk=L)
    no_h0_err = _max_abs(no_h0, want)
    _require(not _close(torch, no_h0, want, TOL32),
             f"ssd_scan {tag}: the check cannot see a dropped h0")
    del got, want, no_h0
    nch = -(-S // L)
    ops = B * NH * nch * (L * (L + 1) / 2 * 2 * (N + P) + 4 * L * P * N)
    nbytes = (B * S * NH * P * (esz + 4) + B * S * NH * 4 + NH * 4
              + 2 * B * S * N * 4 + 2 * B * NH * P * N * 4)
    bound, by = _bound_ms(nbytes, ops, FP32_OPS_PER_S)

    def kern():
        return ssd_scan(x, dt, a, bm, cm, chunk=L, h0=h0)

    times = _device_times(torch, kern, 20)
    return dict(
        shape=f"B{B}.S{S}.H{NH}.P{P}.N{N}.L{L}.{tag}", instance=f"{tag}.P{P}",
        max_abs_err=err, no_h0_err=no_h0_err,
        ms=_cuda_ms(torch, kern, 20),
        device_ms=sum(times.values()) if times else None,
        device_ms_by_pass={p: sum(t for k, t in times.items()
                                  if f"ssd_scan_{p}_kernel" in k)
                           for p in ("state", "chain", "output")},
        plain_ms=_cuda_ms(torch, lambda: ssd_scan_plain(
            x, dt, a, bm, cm, chunk=L, h0=h0), 2),
        library_ms=None, library_device_ms=None, bound_ms=bound,
        bound_by=by)


# ssd_scan beyond the serving shape: label, B, S, H, P, N, chunk
SSD_DOMAIN = (
    ("warmup", 1, 16, 50, 64, 16, 256),         # serve's warm-up prompt
    ("serve-check", 2, 1536, 50, 64, 16, 256),  # serve-check's prompt
    ("ragged", 2, 1528, 50, 64, 16, 256),       # ... and its prefill
    ("P16", 2, 1000, 8, 16, 16, 256),
    ("P32", 2, 1000, 8, 32, 16, 256),
    ("N64.L64", 2, 1000, 8, 64, 64, 64),
    ("N64.L256", 1, 1000, 8, 64, 64, 256),      # the most shared memory
    ("N128.L128", 1, 2048, 80, 64, 128, 128),   # mamba2-2.7b's SSM widths
    ("N12.L100", 2, 777, 8, 32, 12, 100),       # N, chunk and S unpadded
    ("P16.N24.L72", 2, 500, 4, 16, 24, 72),
    ("x-offset", 1, 300, 4, 32, 16, 128),       # x at an odd element offset
)
SSD_REFUSED = (64, 128, 256)   # P, N, chunk: B and C overflow shared memory


def _ssd_domain_rows(torch, dev, dtype):
    """ssd_scan at every row of ``SSD_DOMAIN`` from a nonzero h0, y and
    h_last against the plain version within TOL32; and a shape outside the
    kernel's domain, which the wrapper must refuse before any launch."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan.ops import (
        kernel_takes, ssd_scan, ssd_scan_plain)

    gen = torch.Generator(device=dev).manual_seed(18)
    tag = "bf16" if dtype == torch.bfloat16 else "f32"

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def inputs(B, S, H, P, N):
        return (randn(B, S, H, P).to(dtype), F.softplus(randn(B, S, H) - 1.0),
                -torch.exp(randn(H, scale=0.3)), randn(B, S, N, scale=0.3),
                randn(B, S, N, scale=0.3), randn(B, H, P, N, scale=0.1))

    rows = []
    for label, B, S, H, P, N, L in SSD_DOMAIN:
        _require(kernel_takes(P, N, L), f"ssd_scan {label}: outside the "
                 "kernel's domain")
        x, dt, a, bm, cm, h0 = inputs(B, S, H, P, N)
        if label == "x-offset":   # the wrapper copies x to 16-byte alignment
            x = torch.empty(x.numel() + 1, dtype=dtype,
                            device=dev)[1:].view_as(x).copy_(x)
            _require(x.data_ptr() % 16 != 0, "ssd_scan x-offset: x aligned")
        got = ssd_scan(x, dt, a, bm, cm, chunk=L, h0=h0)
        want = ssd_scan_plain(x, dt, a, bm, cm, chunk=L, h0=h0)
        torch.cuda.synchronize()
        err = _max_abs(got, want)
        _require(_close(torch, got, want, TOL32),
                 f"ssd_scan {label} {tag}: max|diff| {err}")
        rows.append(dict(shape=f"{label}.B{B}.S{S}.H{H}.P{P}.N{N}.L{L}.{tag}",
                         instance=f"{tag}.P{P}", max_abs_err=err))
    P, N, L = SSD_REFUSED
    _require(not kernel_takes(P, N, L), "ssd_scan: the refused shape is in "
             "the domain")
    before = ssd_scan.launches
    try:
        ssd_scan(*inputs(1, 64, 2, P, N)[:5], chunk=L)
        refused = False
    except ValueError:
        refused = True
    torch.cuda.synchronize()
    _require(refused and ssd_scan.launches == before,
             f"ssd_scan P={P} N={N} chunk={L}: not refused before launch")
    return rows


def phase_model_kernels(np, torch, dev):
    """flash_attention, decode_attention and ssd_scan against their plain
    versions at the serving path's shapes, in bf16 and f32, with kernel,
    plain and library times and the bound of the work."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, decode_attention_plain)

    gen = torch.Generator(device=dev).manual_seed(12)
    B, H, K, D = SERVE["batch"], 25, 5, 64
    S = SERVE["prefill_len"]
    Tc = S + SERVE["decode_len"]
    rows = {"flash_attention": [], "decode_attention": [], "ssd_scan": []}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    gen_ragged = torch.Generator(device=dev).manual_seed(13)

    def randn_ragged(*shape):
        return torch.randn(shape, generator=gen_ragged, device=dev)

    for dtype, peak in ((torch.bfloat16, BF16_OPS_PER_S),
                        (torch.float32, FP32_OPS_PER_S)):
        esz = torch.finfo(dtype).bits // 8
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        # flash_attention: prefill, causal, global and window-1024 layers;
        # in bf16 also serve-check's prefill length, a multiple of neither
        # the 64-key tile nor the 128-row block
        shapes = ((B, S, randn), (2, 1528, randn_ragged))
        for fb, fs, rnd in shapes if tag == "bf16" else shapes[:1]:
            rows["flash_attention"] += _flash_rows(
                torch, rnd, dev, dtype, peak, fb, fs, H, K, D)

        # decode_attention: one step in the middle of decode (2080 of the
        # 2112 slots filled), global and window-1024 layers
        fill = S + SERVE["decode_len"] // 2
        q = randn(B, H, D).to(dtype)
        k, v = randn(B, Tc, K, D).to(dtype), randn(B, Tc, K, D).to(dtype)
        slot = torch.arange(Tc, device=dev, dtype=torch.int32)
        kv_pos = torch.where(slot < fill, slot, -1)[None].expand(B, Tc)
        kv_pos = kv_pos.contiguous()
        q_pos = torch.full((B,), fill - 1, dtype=torch.int32, device=dev)
        qT, kT, vT = (q[:, :, None], k.transpose(1, 2).contiguous(),
                      v.transpose(1, 2).contiguous())
        wants = {}
        for window in (None, 1024):
            got = decode_attention(q, k, v, kv_pos, q_pos, window=window)
            wants[window] = want = decode_attention_plain(
                q, k, v, kv_pos, q_pos, window=window)
            plain32 = (decode_attention_plain(q.float(), k.float(),
                                              v.float(), kv_pos, q_pos,
                                              window=window)
                       if dtype == torch.bfloat16 else None)
            torch.cuda.synchronize()
            check = _attention_check(
                torch, f"decode_attention {tag} window={window}", dtype, got,
                want, plain32, wants[None] if window else None)
            vis = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
            if window is not None:
                vis &= kv_pos > q_pos[:, None] - window
            nvis = float(vis.sum())
            nbytes = (nvis * K * D * 2 * esz + B * Tc * 4 + B * 4
                      + 2 * B * H * D * esz)
            bound, by = _bound_ms(nbytes, 4.0 * D * (H // K) * K * nvis, peak)
            mask = vis[:, None, None, :]

            def kern():
                return decode_attention(q, k, v, kv_pos, q_pos, window=window)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qT, kT, vT, attn_mask=mask, enable_gqa=True)

            rows["decode_attention"].append(dict(
                shape=f"B{B}.T{Tc}.fill{fill}.H{H}.K{K}.D{D}.{tag}.w{window}",
                **check,
                ms=_cuda_ms(torch, kern, 50),
                device_ms=_device_ms(torch, kern, 50),
                plain_ms=_cuda_ms(torch, lambda: decode_attention_plain(
                    q, k, v, kv_pos, q_pos, window=window), 10),
                library_ms=_cuda_ms(torch, sdpa, 50),
                library_device_ms=_device_ms(torch, sdpa, 50),
                bound_ms=bound, bound_by=by))
        del q, k, v, qT, kT, vT, wants, want
        rows["decode_attention"] += _decode_domain_rows(torch, dev, dtype)

        # ssd_scan: prefill of the SSM branch from a nonzero state, then
        # the domain rows
        rows["ssd_scan"].append(_ssd_serving_row(torch, randn, dtype))
        rows["ssd_scan"] += _ssd_domain_rows(torch, dev, dtype)

    out = {}
    for name, shapes in rows.items():
        # the row of the line: bf16, the global (window-free) layer first
        out[name] = dict(shapes[0], shapes=shapes)
        for row in shapes:
            print(f"  {name} {json.dumps(row)}")
    print("kernels (model): " + "; ".join(
        f"{n}{'[' + r['instance'] + ']' if 'instance' in r else ''} "
        f"max|diff|={r['max_abs_err']:g} ms={r['ms']:.4f} "
        f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f}"
        + ("" if "device_ms" not in r else
           f" device_ms={_fmt_ms(r['device_ms'])} library_ms="
           f"{_fmt_ms(r['library_ms'])} library_device_ms="
           f"{_fmt_ms(r['library_device_ms'])}")
        for n, r in out.items()), flush=True)
    return out


def phase_serve(torch, kernels, dev):
    """The full-width, full-depth hymba-1.5b serving run through
    ``repro_torch.launch.serve``: 16 requests in batches of 8, prompt 2048,
    64 greedy decode steps, bf16, random weights from seed 0."""
    from repro_torch.launch.serve import load_model, serve

    t0 = time.perf_counter()
    cfg, params = load_model("hymba-1.5b", device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparams = sum(t.numel() for t in _leaves(params))
    # warm-up (cuBLAS handles, allocator), outside the measured run
    serve(cfg, params, requests=1, batch=1, prefill_len=16, decode_len=2)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    res = serve(cfg, params, **SERVE)
    launches = _counts(kernels)
    flash_instances = dict(kernels["flash_attention"].instance_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L, nb = cfg.num_layers, res["batches"]
    want = {"flash_attention": L * nb,
            "decode_attention": L * SERVE["decode_len"] * nb,
            "ssd_scan": L * nb}
    for name, n in want.items():
        _require(launches[name] == n,
                 f"serve: {name} launched {launches[name]} times, want {n}")
    _require(flash_instances == {"wgmma": L * nb, "fma": 0},
             f"serve: flash_attention instances {flash_instances}, want "
             f"every launch on the tensor-core (wgmma) instance")
    _require(bool(torch.isfinite(res["logits"]).all()),
             "serve: non-finite logits")
    _require(res["logits"].shape == (SERVE["batch"], cfg.vocab_size),
             "serve: logits shape")
    prefill_tps = res["prefill_tokens"] / res["prefill_s"]
    decode_ms = res["decode_s"] * 1e3 / (nb * SERVE["decode_len"])
    print(f"serve: hymba-1.5b layers={L} d_model={cfg.d_model} "
          f"params={nparams} bf16 init_s={init_s:.2f} "
          f"requests={SERVE['requests']} batch={SERVE['batch']} "
          f"prefill_len={SERVE['prefill_len']} "
          f"decode_len={SERVE['decode_len']} prefill_s={res['prefill_s']:.3f} "
          f"prefill_tok_per_s={prefill_tps:.1f} decode_s={res['decode_s']:.3f} "
          f"decode_ms_per_step={decode_ms:.3f} peak_mem_gb={peak_gb:.3f} "
          f"launches={ {n: launches[n] for n in want} } "
          f"flash_attention_instances={flash_instances}", flush=True)
    return dict(launches=launches, flash_instances=flash_instances,
                prefill_tok_per_s=prefill_tps,
                decode_ms_per_step=decode_ms, peak_mem_gb=peak_gb)


def phase_serve_profile(np, torch, dev):
    """One serving batch once more under torch.profiler: the prefill, then
    8 decode steps, each with its device busy time, idle share and device
    time by kernel group.  Numbers are under the profiler (its per-op cost
    inflates the host-bound decode's wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import load_model
    from repro_torch.models import decode_step, prefill

    cfg, params = load_model("hymba-1.5b", device=dev, seed=0)
    B, S, n_dec = SERVE["batch"], SERVE["prefill_len"], 8
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to(dev)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(
            cfg, params, {"tokens": tokens}, max_len=S + SERVE["decode_len"])

    def run_decode():
        tok = state["logits"].argmax(-1)[:, None]
        for t in range(n_dec):
            pos = torch.full((B, 1), S + t, dtype=torch.int32, device=dev)
            logits, state["cache"] = decode_step(cfg, params, state["cache"],
                                                 tok, pos)
            tok = logits.argmax(-1)[:, None]

    groups = (("flash_attention", ("flash_attention",)),
              ("decode_attention", ("decode_attention",)),
              ("ssd_scan", ("ssd_scan",)),
              ("gemm", ("gemm", "gemv", "nvjet", "xmma", "cutlass")))
    for label, fn in (("prefill", run_prefill), ("decode x8", run_decode)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total]
        if not rows:
            print(f"profile serve {label}: wall_s={wall:.3f} device time not "
                  "measured (the profiler saw no device activity)")
            continue
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        by_group = {g: 0.0 for g, _ in groups}
        by_group["other"] = 0.0
        for e in rows:
            name = e.key.lower()
            g = next((g for g, keys in groups
                      if any(k in name for k in keys)), "other")
            by_group[g] += e.self_device_time_total / 1e6
        print(f"profile serve {label}: wall_s={wall:.3f} "
              f"device_launches={sum(e.count for e in rows)} "
              f"device_busy_s={busy:.4f} device_idle_share="
              f"{1 - busy / wall:.4f} device_s_by_group="
              f"{ {g: round(v, 4) for g, v in by_group.items()} }",
              flush=True)
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.key[:70]!r} count={e.count} "
                  f"device_ms={e.self_device_time_total / 1e3:.3f}")
    del params, state


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _route_run(torch, cfg, params, tokens, n_prefill):
    """Cache-free forward logits, prefill's last logits and teacher-forced
    decode logits of one route."""
    from repro_torch.models import decode_step, forward, prefill

    full, _ = forward(cfg, params, tokens)
    last, cache = prefill(cfg, params, {"tokens": tokens[:, :n_prefill]},
                          max_len=tokens.shape[1])
    steps = []
    for t in range(n_prefill, tokens.shape[1]):
        pos = torch.full((tokens.shape[0], 1), t, dtype=torch.int32,
                         device=tokens.device)
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1],
                                    pos)
        steps.append(logits)
    torch.cuda.synchronize()
    return full, last, torch.stack(steps, dim=1)


def phase_serve_check(np, torch, kernels, dev):
    """hymba-1.5b at full width and 4 layers (global, window, window,
    global; window 1024) in f32, prompt 1536: the kernel route against the
    plain route on the card (logits within 1e-3), and teacher-forced decode
    after prefill against the cache-free forward (within 2e-3).  TF32 is
    off for both matmul and cuDNN, so f32 products run in full f32."""
    from repro_torch.kernels.decode_attention.ops import decode_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_plain
    from repro_torch.launch.serve import load_model
    from repro_torch.models import attention, layer_windows, ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = load_model("hymba-1.5b", device=dev, seed=1, num_layers=4,
                             dtype="float32")
    wins = layer_windows(cfg)
    _require(wins == [None, 1024, 1024, None], f"serve-check windows {wins}")
    B, S, n_prefill = 2, 1536, 1528
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)

    _zero_counts(kernels)
    kern = _route_run(torch, cfg, params, tokens, n_prefill)
    kern_launches = _counts(kernels)
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        _require(kern_launches[name] > 0,
                 f"serve-check: kernel route never launched {name}")
    patched = [(attention, "flash_attention", flash_attention_plain),
               (attention, "decode_attention", decode_attention_plain),
               (ssm, "ssd_scan", ssd_scan_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    _zero_counts(kernels)
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        plain = _route_run(torch, cfg, params, tokens, n_prefill)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    _require(all(n == 0 for n in _counts(kernels).values()),
             "serve-check: the plain route launched a kernel")
    route_err = _max_abs(kern, plain)
    _require(_close(torch, kern, plain, dict(rtol=1e-3, atol=1e-3)),
             f"serve-check: kernel vs plain route max|diff| {route_err}")
    full, last, steps = kern
    tf_err = _max_abs([last, steps],
                      [full[:, n_prefill - 1], full[:, n_prefill:]])
    _require(_close(torch, [last, steps],
                    [full[:, n_prefill - 1], full[:, n_prefill:]],
                    dict(rtol=2e-3, atol=2e-3)),
             f"serve-check: decode vs forward max|diff| {tf_err}")
    _require(all(bool(torch.isfinite(t).all()) for t in kern),
             "serve-check: non-finite logits")
    print(f"serve-check: hymba-1.5b full width, layers=4 windows={wins} f32 "
          f"tf32=off batch={B} prompt={S} prefill={n_prefill} "
          f"decode={S - n_prefill} kernel_vs_plain_max_abs={route_err:.3e} "
          f"(tol 1e-3) decode_vs_forward_max_abs={tf_err:.3e} (tol 2e-3) "
          f"max_abs_logit={float(full.abs().max()):.4f} "
          f"launches={kern_launches}", flush=True)


def _zero_counts(kernels):
    for fn in kernels.values():
        fn.launches = 0
        for inst in getattr(fn, "instance_launches", {}):
            fn.instance_launches[inst] = 0
        getattr(fn, "class_launches", {}).clear()


def _counts(kernels):
    return {name: fn.launches for name, fn in kernels.items()}


def _compare(np, dev_res, cpu_res, label):
    a, b = dev_res.summary(), cpu_res.summary()
    _require(set(a) == set(b), f"{label}: summary keys differ")
    diff = {k: (a[k], b[k]) for k in a if k not in BACKEND_KEYS and a[k] != b[k]}
    _require(not diff, f"{label}: summary differs from the CPU run: {diff}")
    _require(np.array_equal(dev_res.member, cpu_res.member),
             f"{label}: member matrix differs from the CPU run")
    _require(np.array_equal(dev_res.spans, cpu_res.spans),
             f"{label}: replay spans differ from the CPU run")


def _check_result(np, res, hg, label):
    _require(res.spans.shape == (hg.num_edges,), f"{label}: spans shape")
    _require(bool((res.spans >= 1).all()), f"{label}: a query has span 0")
    _require(math.isfinite(res.avg_span) and math.isfinite(res.energy_joules),
             f"{label}: non-finite result")


def phase_fit(np, torch, kernels, label, hg, n, capacity, max_moves,
              cpu_check):
    from repro_torch import flags
    from repro_torch.core import Simulator, lmbr, peel_counters

    from repro_torch.core import algorithms

    flags.set_variant("peeldevice+spandevice")
    peel0 = peel_counters()
    _zero_counts(kernels)
    # keep each dense-peel launch's peel tensor: its rounds are read after
    # the fit, so the fit itself does no extra device work or sync
    peels, peel_fn = [], algorithms.lockstep_peel

    def recording(inc, we, nodew, nvalid):
        out = peel_fn(inc, we, nodew, nvalid)
        peels.append(out[0])
        return out

    algorithms.lockstep_peel = recording
    try:
        t0 = time.perf_counter()
        res = Simulator(n, capacity, device="cuda").run(
            hg, lmbr, seed=0, max_moves=max_moves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        algorithms.lockstep_peel = peel_fn
    launches = _counts(kernels)
    peel_classes = dict(kernels["lockstep_peel"].class_launches)
    peel1 = peel_counters()
    flags.reset()
    _check_result(np, res, hg, label)
    for name, count in launches.items():
        _require(count > 0, f"{label}: kernel {name} never launched")
    _require(sum(peel_classes.values()) == launches["lockstep_peel"]
             == len(peels), f"{label}: peel launches by class do not add up")
    # the peel is a chain of rounds: each launch lasts as long as its
    # longest pair
    peel_rounds = sum(int((p >= 0).sum(dim=1).max()) for p in peels)
    del peels
    classes = ", ".join(f"K{k}.U{u}: {c}" for (k, u), c in sorted(
        peel_classes.items(), key=lambda kv: -kv[1]))
    line = (f"{label}: avg_span={res.avg_span:.4f} "
            f"placement_s={res.placement_seconds:.2f} wall_s={wall:.2f} "
            f"moves={res.placement_stats['moves']} launches={launches} "
            f"peel_pairs={ {k: peel1[k] - peel0[k] for k in peel0} } "
            f"peel_launches_by_class={{{classes}}} "
            f"peel_rounds={peel_rounds}")
    cpu_wall = None
    if cpu_check:
        t0 = time.perf_counter()
        cpu = Simulator(n, capacity, device="cpu").run(
            hg, lmbr, seed=0, max_moves=max_moves)
        cpu_wall = time.perf_counter() - t0
        _compare(np, res, cpu, label)
        line += (f" cpu_placement_s={cpu.placement_seconds:.2f} "
                 f"cpu_wall_s={cpu_wall:.2f} cpu_match=bitwise")
    print(line, flush=True)
    return dict(launches=launches, wall=wall, cpu_wall=cpu_wall,
                placement_s=res.placement_seconds, avg_span=res.avg_span,
                peel_rounds=peel_rounds)


def phase_profile(torch, label, hg, n, capacity, max_moves, peel_rounds):
    """The fit of ``phase_fit`` once more under torch.profiler and the
    package tracer: host-side split (HPA, LMBR move loop, replay), the
    device's busy time by kernel, lockstep_peel's device time per peel
    round (``peel_rounds`` from ``phase_fit``'s run of the same fit) and
    cover_rounds' device ms per launch.  Numbers are under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import flags, obs
    from repro_torch.core import Simulator, lmbr

    flags.set_variant("peeldevice+spandevice+obstrace")
    obs.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        Simulator(n, capacity, device="cuda").run(hg, lmbr, seed=0,
                                                  max_moves=max_moves)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = {name: sum(e["dur"] for e in obs.tracer().spans(name)) / 1e6
            for name in ("fit.place", "fit.hpa", "fit.lmbr", "replay.cover")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    print(f"profile {label}: wall_s={wall:.3f} hpa_s={host['fit.hpa']:.3f} "
          f"lmbr_loop_s={host['fit.lmbr'] - host['fit.hpa']:.3f} "
          f"replay_s={host['replay.cover']:.3f} device_busy_s={busy:.4f} "
          f"device_idle_share={1 - busy / wall:.4f}"
          if rows else f"profile {label}: wall_s={wall:.3f} device time "
          "not measured (the profiler saw no device activity)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    peel = [e for e in rows if "lockstep_peel" in e.key]
    if peel:
        peel_ms = sum(e.self_device_time_total for e in peel) / 1e3
        count = sum(e.count for e in peel)
        print(f"profile {label} lockstep_peel: device_ms={peel_ms:.3f} "
              f"count={count} device_ms_per_launch={peel_ms / count:.5f} "
              f"rounds={peel_rounds} device_us_per_round="
              + (f"{peel_ms * 1e3 / peel_rounds:.4f}" if peel_rounds
                 else "not_measured"), flush=True)
    _print_kernel_device_ms(rows, f"profile {label}", "cover_rounds")


def _paper_kernels_required(workload: str, name: str) -> set:
    """The kernels a paper-algos run must launch: span_gain in IHPA's and
    DS's residual rounds and in fig6's replay rounds, cover_rounds in
    fig9's whole buckets (at or above ``span_round_threshold`` words),
    lockstep_peel in LMBR.  PRA's only span work is the replay (its
    per-edge covers are host numpy, as in the reference), so at fig9 it
    launches cover_rounds alone."""
    need = set()
    if name in ("ihpa", "ds") or (name == "pra" and workload == "fig6"):
        need.add("span_gain")
    if workload.startswith("fig9"):
        need.add("cover_rounds")
    if name == "lmbr":
        need.add("lockstep_peel")
    return need


def phase_paper_algos(np, torch, kernels, graphs):
    """Every run of ``PAPER_RUNS`` on the card, each held bit for bit
    against the same call on the CPU and against the JAX package's
    avg_span.  Records each run's kernel launches and the (B, N, W) of
    every cover_rounds launch."""
    from repro_torch import flags
    from repro_torch.core import ALGORITHMS, Simulator, setcover

    rounds_fn = setcover.cover_rounds
    shapes = []

    def recording(codes, rem):
        if codes.shape[0]:
            shapes.append(tuple(codes.shape))
        return rounds_fn(codes, rem)

    runs = []
    for workload, n, cap, name, extra, want in PAPER_RUNS:
        hg = graphs[workload]
        label = f"paper-algos {workload} ({n}, {cap}) {name}"
        flags.set_variant("peeldevice+spandevice")
        _zero_counts(kernels)
        first = len(shapes)
        setcover.cover_rounds = recording
        try:
            t0 = time.perf_counter()
            res = Simulator(n, cap, device="cuda").run(
                hg, ALGORITHMS[name], name=name, seed=0, **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            setcover.cover_rounds = rounds_fn
        launches = _counts(kernels)
        flags.reset()
        _check_result(np, res, hg, label)
        run_shapes = shapes[first:]
        _require(len(run_shapes) == launches["cover_rounds"],
                 f"{label}: cover_rounds shapes do not match its launches")
        for kernel in sorted(_paper_kernels_required(workload, name)):
            _require(launches[kernel] > 0,
                     f"{label}: kernel {kernel} never launched")
        t0 = time.perf_counter()
        cpu = Simulator(n, cap, device="cpu").run(
            hg, ALGORITHMS[name], name=name, seed=0, **extra)
        cpu_wall = time.perf_counter() - t0
        _compare(np, res, cpu, label)
        _require(res.avg_span == want,
                 f"{label}: avg_span {res.avg_span!r} is not the "
                 f"reference's {want!r}")
        counted = {}
        for shape in run_shapes:
            counted[shape] = counted.get(shape, 0) + 1
        print(f"{label}: avg_span={res.avg_span!r} reference={want!r} "
              f"placement_s={res.placement_seconds:.3f} wall_s={wall:.3f} "
              f"cpu_placement_s={cpu.placement_seconds:.3f} "
              f"cpu_wall_s={cpu_wall:.3f} cpu_match=bitwise "
              f"launches={launches} cover_rounds_shapes="
              + "{" + ", ".join(f"{b}x{n_}x{w}: {c}" for (b, n_, w), c
                                in sorted(counted.items())) + "}",
              flush=True)
        runs.append(dict(workload=workload, n=n, name=name,
                         launches=launches, wall=wall, cpu_wall=cpu_wall))
    return runs


def phase_paper_profile(torch, hg, n, capacity, name):
    """One paper-algos run once more under torch.profiler and the package
    tracer: host split (HPA, the algorithm's own loop, replay), the
    device's busy time, and span_gain's and cover_rounds' device ms per
    launch.  Numbers are under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import flags, obs
    from repro_torch.core import ALGORITHMS, Simulator

    label = f"paper-algos {name} (n={hg.num_nodes}, {n}, {capacity})"
    flags.set_variant("peeldevice+spandevice+obstrace")
    obs.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        Simulator(n, capacity, device="cuda").run(hg, ALGORITHMS[name],
                                                  name=name, seed=0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = {key: sum(e["dur"] for e in obs.tracer().spans(key)) / 1e6
            for key in ("fit.place", "fit.hpa", "replay.cover")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    # the wall also holds the profiler's start; the fit and the replay are
    # what the traced spans time
    traced = host["fit.place"] + host["replay.cover"]
    print(f"profile {label}: wall_s={wall:.3f} hpa_s={host['fit.hpa']:.3f} "
          f"algorithm_loop_s={host['fit.place'] - host['fit.hpa']:.3f} "
          f"replay_s={host['replay.cover']:.3f} device_busy_s={busy:.4f} "
          f"device_idle_share={1 - busy / wall:.4f} "
          f"device_idle_share_of_fit_replay={1 - busy / traced:.4f}"
          if rows else f"profile {label}: wall_s={wall:.3f} device time "
          "not measured (the profiler saw no device activity)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    for kernel in ("span_gain", "cover_rounds"):
        _print_kernel_device_ms(rows, f"profile {label}", kernel)


def _sha256(data) -> str:
    import hashlib

    if isinstance(data, str):
        data = data.encode()
    return hashlib.sha256(data).hexdigest()


def api_inputs(np):
    """The placement-api runs' inputs, made by the port's generators:
    fig8's TPC-H-heterogeneous workload at its largest N (2 000 items,
    4 000 queries, seeds 0 and 1), a 45-partition profile of 100 GB nodes,
    the refit's mask of partitions 3 and 17, fig. 6(f)-(h)'s 3-way paper
    point, DeepSeek-V3's routing trace and the shard recipes."""
    from repro_torch import core

    rng = np.random.default_rng(0)
    profile = core.NodeProfile(
        capacity=np.full(45, 100.0), fail_prob=rng.uniform(0.01, 0.1, 45),
        power_idle=100.0, power_active=300.0,
        access_cost=rng.uniform(0, 1, 45))
    mask = np.ones(45, dtype=bool)
    mask[[3, 17]] = False
    return dict(
        tpch=core.tpch_heterogeneous(num_items=2000, num_queries=4000,
                                     seed=0).queries,
        tpch1=core.tpch_heterogeneous(num_items=2000, num_queries=4000,
                                      seed=1).queries,
        profile=profile, mask=mask,
        fig6=core.random_workload(1000, 4000, 3, 11, 20,
                                  seed=0).hypergraph,
        trace=core.synthetic_routing_trace(256, 4096, top_k=8, seed=0),
        recipes=core.mixture_batch_recipes(1000, 2000, seed=0),
    )


def api_run(np, name, inp, device, state):
    """One placement-api run on ``device`` through the port's entry
    points; returns the values it holds.  ``state`` carries the fitted
    plan from service-fit to service-refit and each run's results."""
    from repro_torch import core, flags

    svc = core.PlacementService("lmbr", seed=0, device=device)
    if name == "service-fit":
        plan = svc.fit(inp["tpch"], 2000, 45, profile=inp["profile"],
                       durability_eps=0.05)
        state["plan"] = plan
        flags.set_variant("spanrounddevice")
        return dict(json_sha256=_sha256(plan.to_json()),
                    durability_copies=plan.stats["durability_copies"],
                    avg_span=plan.avg_span(inp["tpch"]))
    if name == "service-refit":
        old = state["plan"]
        new = svc.refit(old, inp["tpch1"], max_moves=64,
                        dest_mask=inp["mask"], profile=inp["profile"])
        added = new.member & ~old.member
        _require(not added[~inp["mask"]].any(),
                 "service-refit: a copy landed on a masked partition")
        _require(bool((new.member | ~old.member).all()),
                 "service-refit: the old plan is not inside the new one")
        return dict(json_sha256=_sha256(new.to_json()),
                    copies_added=int(added.sum()),
                    avg_span_before=old.avg_span(inp["tpch1"]),
                    avg_span_after=new.avg_span(inp["tpch1"]))
    if name == "service-hier":
        plan = svc.fit_hierarchical(inp["tpch"], 2000, num_pods=4,
                                    hosts_per_pod=10, host_capacity=100.0)
        spans = np.array([plan.spans(q) for q in inp["tpch"]])
        weighted = [plan.weighted_span(q) for q in inp["tpch"]]
        return dict(host_member_sha256=_sha256(plan.host_member.tobytes()),
                    mean_pod_span=float(spans[:, 0].mean()),
                    mean_host_span=float(spans[:, 1].mean()),
                    mean_weighted_span=float(np.mean(weighted)))
    if name == "three-way":
        hg = inp["fig6"]
        n = 3 * core.min_partitions(hg, 50)
        res = core.Simulator(n, 50, device=device).compare(
            hg, core.THREE_WAY_ALGORITHMS, seed=0)
        state["three-way"] = res
        return {algo: dict(avg_span=r.avg_span,
                           member_sha256=_sha256(r.member.tobytes()))
                for algo, r in res.items()}
    if name == "experts":
        trace = inp["trace"]
        plan = core.plan_expert_placement(trace, 256, 32, slots_per_rank=9,
                                          algorithm="lmbr", seed=0,
                                          device=device)
        base = core.baseline_contiguous_placement(256, 32, 9)
        return dict(member_sha256=_sha256(plan.member.tobytes()),
                    tables_sha256=_sha256(plan.slot_to_expert.tobytes()
                                          + plan.expert_slot_table.tobytes()),
                    avg_span=plan.avg_span(trace),
                    baseline_avg_span=base.avg_span(trace))
    if name == "shards":
        recipes = inp["recipes"]
        plan = core.plan_shard_placement(recipes, 1000, 48, capacity=80,
                                         algorithm="pra3", device=device)
        # the plan's spans once more through the span engine on ``device``
        spans = core.spans_for_workload(
            core.Hypergraph.from_edges(recipes, num_nodes=1000),
            core.Placement.from_member(plan.member, 80.0), device=device)
        _require(float(spans.mean()) == plan.avg_span(recipes),
                 "shards: the engine's spans differ from the plan's")
        return dict(member_sha256=_sha256(plan.member.tobytes()),
                    survives_2_failures=plan.survives_failures(2),
                    avg_span=float(spans.mean()))
    raise ValueError(f"unknown placement-api run {name!r}")


def phase_placement_api(np, torch, kernels, inp):
    """Every run of ``API_RUNS`` on the card, each inside its own
    partition memo, held against the same call on the CPU (also in its
    own memo) and against ``API_HELD``; each must launch the kernels
    ``API_RUNS`` names."""
    from repro_torch import core, flags

    dev_state, cpu_state, runs = {}, {}, []
    for name, (variant, need) in API_RUNS.items():
        label = f"placement-api {name}"
        flags.set_variant(variant)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            held = api_run(np, name, inp, "cuda", dev_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(kernels)
        flags.set_variant(variant)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            cpu_held = api_run(np, name, inp, "cpu", cpu_state)
        cpu_wall = time.perf_counter() - t0
        flags.reset()
        _require(held == cpu_held,
                 f"{label}: {held} differs from the CPU run's {cpu_held}")
        _require(held == API_HELD[name],
                 f"{label}: {held} is not the reference's {API_HELD[name]}")
        if name == "three-way":
            for algo in held:
                _compare(np, dev_state[name][algo], cpu_state[name][algo],
                         f"{label} {algo}")
        for kernel, least in need.items():
            _require(launches[kernel] >= least,
                     f"{label}: kernel {kernel} launched {launches[kernel]} "
                     f"times, fewer than {least}")
        print(f"{label}: {json.dumps(held)} wall_s={wall:.3f} "
              f"cpu_wall_s={cpu_wall:.3f} cpu_match=bitwise "
              f"reference_match=exact launches={launches}", flush=True)
        runs.append(dict(name=name, launches=launches, wall=wall,
                         cpu_wall=cpu_wall))
    return runs


def phase_api_profile(torch, inp):
    """service-fit once more under torch.profiler and the package tracer:
    host split (HPA, the LMBR move loop, the durability pass, the plan's
    spans), the device's busy time and each placement kernel's device ms
    per launch.  Numbers are under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, flags, obs
    from repro_torch.core import placement_service

    timed = {"durability": 0.0}
    originals = (placement_service.ensure_durability,
                 placement_service.validate_durability)

    def clocked(fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                timed["durability"] += time.perf_counter() - t
        return run

    flags.set_variant("peeldevice+spandevice+obstrace")
    obs.reset()
    placement_service.ensure_durability = clocked(originals[0])
    placement_service.validate_durability = clocked(originals[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            with core.fresh_partition_cache():
                plan = core.PlacementService("lmbr", seed=0).fit(
                    inp["tpch"], 2000, 45, profile=inp["profile"],
                    durability_eps=0.05)
            torch.cuda.synchronize()
            fit_wall = time.perf_counter() - t1
            flags.FLAGS["span_round_backend"] = "device"
            t1 = time.perf_counter()
            plan.avg_span(inp["tpch"])
            torch.cuda.synchronize()
            spans_s = time.perf_counter() - t1
    finally:
        (placement_service.ensure_durability,
         placement_service.validate_durability) = originals
    wall = time.perf_counter() - t0
    host = {key: sum(e["dur"] for e in obs.tracer().spans(key)) / 1e6
            for key in ("service.fit", "fit.hpa", "fit.lmbr")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    label = "profile placement-api service-fit"
    # the wall also holds the profiler's start and teardown; the fit and
    # the spans are what the host clock and the traced spans time
    print(f"{label}: wall_s={wall:.3f} fit_wall_s={fit_wall:.3f} "
          f"algorithm_s={host['service.fit']:.3f} "
          f"hpa_s={host['fit.hpa']:.3f} "
          f"lmbr_loop_s={host['fit.lmbr'] - host['fit.hpa']:.3f} "
          f"durability_s={timed['durability']:.3f} spans_s={spans_s:.3f} "
          f"device_busy_s={busy:.4f} device_idle_share={1 - busy / wall:.4f} "
          f"device_idle_share_of_fit_spans="
          f"{1 - busy / (fit_wall + spans_s):.4f}"
          if rows else f"{label}: wall_s={wall:.3f} device time not "
          "measured (the profiler saw no device activity)", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    for kernel in ("span_gain", "lockstep_peel", "cover_rounds"):
        _print_kernel_device_ms(rows, label, kernel)


# ------------------------------------------------------------------ online
def online_inputs(np):
    """The online runs' inputs, made by the port's generators: the
    lmbr-stress trace (2 500 items, 10 000 queries), fig6's paper default
    (``random_workload(1000, 4000, 3, 11, 20, seed=0)``), the drift splice
    (its first 2 000 queries, then the 4 000 of seed 7) and the seed-1
    queries the refit-migration run adapts to."""
    from repro_torch import core

    fig6 = core.random_workload(1000, 4000, 3, 11, 20, seed=0).hypergraph
    new = core.random_workload(1000, 4000, 3, 11, 20, seed=7).hypergraph
    splice = core.Hypergraph.from_edges(
        [fig6.edge(e) for e in range(2000)]
        + [new.edge(e) for e in range(new.num_edges)], num_nodes=1000)
    return dict(
        stress=core.lmbr_stress_workload(seed=0).hypergraph,
        fig6=fig6, splice=splice,
        seed1=core.random_workload(1000, 4000, 3, 11, 20, seed=1).queries,
    )


def online_held(np, res):
    """What an online run holds: its summary without the wall and backend
    keys, and the sha256s of its served spans and its final member."""
    held = {k: v for k, v in res.summary().items()
            if k not in BACKEND_KEYS}
    held.update(spans_sha256=_sha256(res.spans.tobytes()),
                member_sha256=_sha256(res.member.tobytes()))
    return held


def _routed(np, router, hg):
    """The router's held values after routing all of ``hg``."""
    batch = router.route_csr(hg.edge_ptr, hg.edge_nodes)
    return batch, dict(
        cover_sha256=_sha256(batch.spans.tobytes()
                             + batch.cover_parts.tobytes()
                             + batch.pin_parts.tobytes()),
        ledger_sha256=_sha256(router.load.tobytes()),
        avg_span=float(batch.spans.mean()),
        load_imbalance=router.load_imbalance(),
        microbatches=router.stats["microbatches"])


def online_run(np, name, inp, device, state):
    """One online run on ``device`` through the port's entry points;
    returns the values it holds.  ``state`` keeps the router run's layout
    for the throughput rows and each run's result."""
    from repro_torch import core, flags
    from repro_torch.online import ReplicaRouter

    variant = ONLINE_RUNS[name][0]
    if name == "router":
        hg = inp["stress"]
        pl = core.ALGORITHMS["random"](hg, 64, 50, seed=0, device=device)
        state["router_member"] = pl.member
        batch, default = _routed(np, ReplicaRouter(pl.member, device=device),
                                 hg)
        for e in range(0, hg.num_edges, 97):
            chosen, accessed = core.cover_for_query(hg.edge(e), pl.member)
            _require(batch.chosen(e).tolist() == chosen
                     and [x.tolist() for x in batch.cover(e).values()]
                     == [x.tolist() for x in accessed],
                     f"online router: query {e} differs from "
                     "cover_for_query")
        flags.set_variant(variant + "+routerbal1")
        _, balanced = _routed(np, ReplicaRouter(pl.member, device=device), hg)
        flags.set_variant(variant)
        return dict(default=default, balanced=balanced)
    sim = core.Simulator(40, 50, device=device)
    lmbr = core.ALGORITHMS["lmbr"]
    if name == "drift":
        res = sim.run_online(
            inp["fig6"], lmbr, name="lmbr+drift", trace=inp["splice"],
            service=core.PlacementService("lmbr", seed=0, device=device),
            refit_moves=400, seed=0, max_moves=120)
    elif name == "failover":
        res = sim.run_online(
            inp["fig6"], lmbr, name="lmbr", seed=0, max_moves=120,
            repair_k=1, events=ONLINE_EVENTS["failover"])
        _require(bool((res.loads <= 50 + 1e-9).all()),
                 "online failover: a load is over capacity")
    elif name == "migration":
        target = lmbr(inp["fig6"], 40, 50, seed=0, max_moves=120,
                      device=device)
        events = [(at, kind, target if kind == "migrate" else arg)
                  for at, kind, arg in ONLINE_EVENTS["migration"]]
        res = sim.run_online(inp["fig6"], core.ALGORITHMS["random"],
                             name="random", seed=0, events=events)
        _require(bool((res.loads <= 50 * 1.10 + 1e-9).all()),
                 "online migration: a load is over the headroom bound")
    elif name == "refit-migration":
        # the fit the other runs make: a service fit fills the space that
        # LMBR can use, and a refit of it adds no copy
        pl = lmbr(inp["fig6"], 40, 50, seed=0, max_moves=120, device=device)
        plan = core.PlacementPlan(pl.member, 50, pl.node_weights, "lmbr",
                                  device=device)
        svc = core.PlacementService("lmbr", seed=0, device=device)
        mp = svc.refit(plan, inp["seed1"], max_moves=64, as_migration=True)
        _require(mp.num_drops == 0,
                 "online refit-migration: a warm-started refit dropped "
                 "a replica")
        _require(bool((mp.apply(plan.member.copy())
                       == mp.target.member).all()),
                 "online refit-migration: the schedule does not land on "
                 "its target")
        return dict(json_sha256=_sha256(mp.to_json()),
                    copies=mp.num_copies, drops=mp.num_drops,
                    avg_span_before=plan.avg_span(inp["seed1"]),
                    avg_span_after=mp.target.avg_span(inp["seed1"]))
    else:
        raise ValueError(f"unknown online run {name!r}")
    state[name] = res
    return online_held(np, res)


class _DispatchCount:
    """Counts the kernel wrapper calls that the span engine and LMBR make
    (each one a launch on the card), by patching the wrappers where the
    engine calls them; used on the CPU twin, whose wrappers run the plain
    versions."""

    def __init__(self):
        from repro_torch.core import algorithms, setcover

        self.sites = ((setcover, "span_gains", "span_gain",
                       lambda c, r: c.shape[0] * c.shape[1] > 0),
                      (setcover, "cover_rounds", "cover_rounds",
                       lambda c, r: c.shape[0] > 0),
                      (algorithms, "lockstep_peel", "lockstep_peel",
                       lambda inc, *_: inc.shape[0] * inc.shape[2] > 0))
        self.counts = {kernel: 0 for _, _, kernel, _ in self.sites}

    def __enter__(self):
        self.saved = []
        for module, attr, kernel, nonempty in self.sites:
            fn = getattr(module, attr)
            self.saved.append((module, attr, fn))

            def counted(*args, _fn=fn, _kernel=kernel, _nonempty=nonempty):
                if _nonempty(*args):
                    self.counts[_kernel] += 1
                return _fn(*args)
            setattr(module, attr, counted)
        return self

    def __exit__(self, *exc):
        for module, attr, fn in self.saved:
            setattr(module, attr, fn)
        return False


def phase_online(np, torch, kernels, inp):
    """Every run of ``ONLINE_RUNS`` on the card, each inside its own
    partition memo, held against the same call on the CPU (also in its own
    memo) and against ``ONLINE_HELD``.  Each run must launch every kernel
    that it names, as many times as the CPU twin's dispatch called the
    kernel's wrapper."""
    from repro_torch import core, flags

    dev_state, cpu_state, runs = {}, {}, []
    for name, (variant, need) in ONLINE_RUNS.items():
        label = f"online {name}"
        flags.set_variant(variant)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            held = online_run(np, name, inp, "cuda", dev_state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(kernels)
        flags.set_variant(variant)
        t0 = time.perf_counter()
        with core.fresh_partition_cache(), _DispatchCount() as dispatch:
            cpu_held = online_run(np, name, inp, "cpu", cpu_state)
        cpu_wall = time.perf_counter() - t0
        flags.reset()
        _require(held == cpu_held,
                 f"{label}: {held} differs from the CPU run's {cpu_held}")
        _require(held == ONLINE_HELD[name],
                 f"{label}: {held} is not the reference's "
                 f"{ONLINE_HELD[name]}")
        if name in dev_state:
            _compare(np, dev_state[name], cpu_state[name], label)
        _require(launches == dispatch.counts,
                 f"{label}: launches {launches} differ from the CPU "
                 f"dispatch's {dispatch.counts}")
        for kernel in need:
            _require(launches[kernel] > 0,
                     f"{label}: kernel {kernel} never launched")
        print(f"{label}: {json.dumps(held)} wall_s={wall:.3f} "
              f"cpu_wall_s={cpu_wall:.3f} cpu_match=bitwise "
              f"reference_match=exact launches={launches} "
              f"cpu_dispatch={dispatch.counts}", flush=True)
        runs.append(dict(name=name, launches=launches, wall=wall,
                         cpu_wall=cpu_wall))
        if name == "router":
            _router_throughput(torch, inp["stress"],
                               dev_state["router_member"])
    return runs


def _router_throughput(torch, hg, member):
    """Queries/s of the default router over the whole lmbr-stress trace,
    best of three, on the card with the kernels pinned, on the card under
    ``auto`` (the host loop at this microbatch) and on the CPU."""
    from repro_torch import flags
    from repro_torch.online import ReplicaRouter

    for label, variant, device in (
            ("card spandevice+spanrounddevice", "spandevice+spanrounddevice",
             "cuda"),
            ("card auto", "baseline", "cuda"),
            ("cpu auto", "baseline", "cpu")):
        flags.set_variant(variant)
        router = ReplicaRouter(member, device=device)
        router.route_csr(hg.edge_ptr, hg.edge_nodes)
        best = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            router.route_csr(hg.edge_ptr, hg.edge_nodes)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        flags.reset()
        print(f"online router throughput {label}: "
              f"queries_per_s={hg.num_edges / best:.1f} "
              f"wall_s={best:.4f}", flush=True)


def phase_online_profile(torch, inp):
    """The drift run once more under torch.profiler and the package
    tracer: the fit, the routing (every microbatch), the refits and the
    rest, the device's busy time and each placement kernel's device ms per
    launch.  Numbers are under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, flags, obs

    flags.set_variant(ONLINE_RUNS["drift"][0] + "+obstrace")
    obs.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            core.Simulator(40, 50).run_online(
                inp["fig6"], core.ALGORITHMS["lmbr"], name="lmbr+drift",
                trace=inp["splice"],
                service=core.PlacementService("lmbr", seed=0),
                refit_moves=400, seed=0, max_moves=120)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    part = {key: sum(e["dur"] for e in obs.tracer().spans(key)) / 1e6
            for key in ("fit.place", "serve.microbatch", "drift.refit")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    rest = wall - sum(part.values())
    label = "profile online drift"
    print(f"{label}: wall_s={wall:.3f} fit_s={part['fit.place']:.3f} "
          f"routing_s={part['serve.microbatch']:.3f} "
          f"refits_s={part['drift.refit']:.3f} rest_s={rest:.3f} "
          + (f"device_busy_s={busy:.4f} "
             f"device_idle_share={1 - busy / wall:.4f}" if rows else
             "device time not measured (the profiler saw no device "
             "activity)"), flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    for kernel in ("span_gain", "lockstep_peel", "cover_rounds"):
        _print_kernel_device_ms(rows, label, kernel)


def _print_kernel_device_ms(rows, label: str, kernel: str) -> None:
    """One kernel's device ms in all and per launch, from the profiler's
    device rows of a profiled run."""
    hits = [e for e in rows if kernel in e.key]
    if hits:
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        count = sum(e.count for e in hits)
        print(f"{label} {kernel}: device_ms={ms:.4f} count={count} "
              f"device_ms_per_launch={ms / count:.5f}", flush=True)
    else:
        print(f"{label} {kernel}: not measured (no launch under the "
              "profiler)", flush=True)


# ------------------------------------------------------------------ health
def health_inputs(np):
    """The health runs' input, made by the port's generator: fig6's paper
    default (``random_workload(1000, 4000, 3, 11, 20, seed=0)``)."""
    from repro_torch import core

    return dict(fig6=core.random_workload(1000, 4000, 3, 11, 20,
                                          seed=0).hypergraph)


def health_run(np, name, inp, device, monitored=True):
    """One health run on ``device``: the storm or the clean replay served
    under the flags-built monitor (or under no monitor); returns the held
    values (``online_held`` and, monitored, the monitor's transitions as
    [alert, kind, t]) and the result."""
    from repro_torch import core, flags, obs

    flags.set_variant(HEALTH_VARIANT if monitored else HEALTH_OFF_VARIANT)
    obs.reset()
    monitor = obs.HealthMonitor.from_flags() if monitored else None
    res = core.Simulator(40, 50, device=device).run_online(
        inp["fig6"], core.ALGORITHMS["lmbr"], name="lmbr", seed=0,
        max_moves=120, events=list(HEALTH_EVENTS[name]), auto_repair=False,
        health=monitor)
    obs.reset()
    held = online_held(np, res)
    if monitor is not None:
        held["history"] = [[h["alert"], h["kind"], h["t"]]
                           for h in monitor.history]
    return held, res


def phase_health(np, torch, kernels, inp):
    """Every run of ``HEALTH_EVENTS`` on the card, each inside its own
    partition memo, held against the same call on the CPU (also in its own
    memo) and against ``HEALTH_HELD``; launches as the CPU twin's dispatch
    calls the wrappers.  The storm runs once more on the card with no
    monitor and must serve the same spans, access load and member:
    observation changes nothing."""
    from repro_torch import core, flags

    runs = []
    for name in HEALTH_EVENTS:
        label = f"health {name}"
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            held, res = health_run(np, name, inp, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache(), _DispatchCount() as dispatch:
            cpu_held, cpu_res = health_run(np, name, inp, "cpu")
        cpu_wall = time.perf_counter() - t0
        flags.reset()
        _require(held == cpu_held,
                 f"{label}: {held} differs from the CPU run's {cpu_held}")
        _require(held == HEALTH_HELD[name],
                 f"{label}: {held} is not the reference's "
                 f"{HEALTH_HELD[name]}")
        _compare(np, res, cpu_res, label)
        _require(launches == dispatch.counts,
                 f"{label}: launches {launches} differ from the CPU "
                 f"dispatch's {dispatch.counts}")
        for kernel in HEALTH_KERNELS:
            _require(launches[kernel] > 0,
                     f"{label}: kernel {kernel} never launched")
        line = ""
        if HEALTH_EVENTS[name]:
            _require(held["alerts_fired"] > 0 and held["alerts_resolved"] > 0,
                     f"{label}: the storm fired or resolved no alert")
            with core.fresh_partition_cache():
                _, off = health_run(np, name, inp, "cuda", monitored=False)
            flags.reset()
            _require(np.array_equal(off.spans, res.spans)
                     and np.array_equal(off.access_load, res.access_load)
                     and np.array_equal(off.member, res.member),
                     f"{label}: the monitor changed what was served")
            line = " unmonitored_match=spans,access_load,member"
        else:
            _require(held["alerts_fired"] == 0 and not held["history"],
                     f"{label}: the clean replay fired an alert")
        print(f"{label}: {json.dumps(held)} wall_s={wall:.3f} "
              f"cpu_wall_s={cpu_wall:.3f} cpu_match=bitwise "
              f"reference_match=exact launches={launches} "
              f"cpu_dispatch={dispatch.counts}{line}", flush=True)
        runs.append(dict(name=name, launches=launches, wall=wall,
                         cpu_wall=cpu_wall))
    return runs


# ------------------------------------------------------------------- scale
def scale_inputs(np):
    """The sharded fits' workloads, streamed by the port's generator."""
    from repro_torch import core

    return {name: core.web_scale_workload(**kw).hypergraph
            for name, (kw, _, _, _) in SCALE_FITS.items()}


def _csr_held(hg) -> dict:
    return dict(edges=hg.num_edges, pins=hg.num_pins,
                csr_sha256=_sha256(hg.edge_ptr.tobytes()
                                   + hg.edge_nodes.tobytes()
                                   + hg.edge_weights.tobytes()))


def scale_service_profile(np):
    """web-mid's partitions as a profile: capacity 210, fail probabilities
    and access costs from seed 0, so that the durability pass at
    ``SCALE_SERVICE_EPS`` copies the items held only where p > eps."""
    from repro_torch import core

    rng = np.random.default_rng(0)
    return core.NodeProfile(
        capacity=np.full(24, 210.0), fail_prob=rng.uniform(0.005, 0.05, 24),
        power_idle=100.0, power_active=250.0,
        access_cost=rng.uniform(0, 1, 24))


def sharded_fit(name, inp, device, workers):
    """``fit_sharded_placement`` of one of ``SCALE_FITS`` on ``device``."""
    from repro_torch.scale import fit_sharded_placement

    _, n, cap, kw = SCALE_FITS[name]
    return fit_sharded_placement(inp[name], n, cap, seed=0, workers=workers,
                                 device=device, **kw)


def scale_run(np, name, inp, device):
    """One scale run on ``device`` through the port's entry points (the
    fits serial); returns the values it holds and the pipeline stats."""
    from repro_torch import core
    from repro_torch.scale import StreamingHypergraphBuilder

    if name == "stream":
        held = {}
        for mode, merge in (("plain", False), ("merged", True)):
            builder = StreamingHypergraphBuilder(
                core.WEB_SCALE_DEFAULTS["num_items"], merge_duplicates=merge)
            for ptr, pins in core.web_scale_chunks(seed=0):
                builder.add_csr(ptr, pins)
            held[mode] = _csr_held(builder.build())
        return held, None
    if name == "service":
        _, n, _, kw = SCALE_FITS["web-mid"]
        service = core.PlacementService("lmbr", seed=0, device=device)
        plan = service.fit_sharded(
            inp["web-mid"], n, profile=scale_service_profile(np), workers=1,
            durability_eps=SCALE_SERVICE_EPS, **kw)
        return dict(json_sha256=_sha256(plan.to_json()),
                    algorithm=plan.algorithm,
                    durability_copies=plan.stats["durability_copies"],
                    **{k: plan.stats[k] for k in SCALE_STATS}), plan.stats
    res = sharded_fit(name, inp, device, 1)
    held = {k: res.stats[k] for k in SCALE_STATS}
    held.update(member_sha256=_sha256(res.member.tobytes()),
                avg_span=float(core.spans_for_workload(
                    inp[name], res.placement, device=device).mean()))
    return held, res.stats


def scale_twins(np, inp) -> dict:
    """The CPU twins of the scale runs, each inside its own partition memo
    under ``SCALE_VARIANT``, counting the dispatch."""
    from repro_torch import core, flags

    out = {}
    for name in SCALE_RUNS:
        flags.set_variant(SCALE_VARIANT)
        t0 = time.perf_counter()
        with core.fresh_partition_cache(), _DispatchCount() as dispatch:
            held, _ = scale_run(np, name, inp, "cpu")
        out[name] = dict(held=held, wall=time.perf_counter() - t0,
                         dispatch=dispatch.counts)
        flags.reset()
    return out


def phase_scale(np, torch, kernels, inp):
    """Every run of ``SCALE_RUNS`` on the card, each inside its own
    partition memo, held against its CPU twin (``scale_twins``, run after
    the card runs so that these have the host to themselves) and against
    ``SCALE_HELD``, with launches as the twin's dispatch calls the
    wrappers.  ``stream`` is host numpy and launches nothing.  Then the
    fits of ``SCALE_POOLED`` once more with their shards on spawned card
    workers: the pool must have run and the member must equal the serial
    run's.  The pooled runs' launches are the parent's (the repair); the
    workers' own are not counted."""
    import os

    from repro_torch import core, flags

    card = {}
    for name in SCALE_RUNS:
        flags.set_variant(SCALE_VARIANT)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            held, stats = scale_run(np, name, inp, "cuda")
        torch.cuda.synchronize()
        card[name] = dict(
            held=held, stats=stats, launches=_counts(kernels),
            peel_classes=dict(kernels["lockstep_peel"].class_launches),
            wall=time.perf_counter() - t0)
        flags.reset()
    twins = scale_twins(np, inp)
    runs = []
    for name, need in SCALE_RUNS.items():
        label = f"scale {name}"
        held, launches = card[name]["held"], card[name]["launches"]
        twin = twins[name]
        _require(held == twin["held"],
                 f"{label}: {held} differs from the CPU run's {twin['held']}")
        _require(held == SCALE_HELD[name],
                 f"{label}: {held} is not the reference's "
                 f"{SCALE_HELD[name]}")
        _require(launches == twin["dispatch"],
                 f"{label}: launches {launches} differ from the CPU "
                 f"dispatch's {twin['dispatch']}")
        for kernel in need:
            _require(launches[kernel] > 0,
                     f"{label}: kernel {kernel} never launched")
        stats = card[name]["stats"] or {}
        seconds = {k: stats[k] for k in SCALE_SECONDS if k in stats}
        classes = ", ".join(f"K{k}.U{u}: {c}" for (k, u), c in sorted(
            card[name]["peel_classes"].items(), key=lambda kv: -kv[1]))
        print(f"{label}: {json.dumps(held)} wall_s={card[name]['wall']:.3f} "
              f"cpu_wall_s={twin['wall']:.3f} cpu_match=bitwise "
              f"reference_match=exact launches={launches} "
              f"cpu_dispatch={twin['dispatch']}"
              + (f" stage_s={json.dumps(seconds)}" if seconds else "")
              + (f" peel_launches_by_class={{{classes}}}" if classes
                 else ""), flush=True)
        runs.append(dict(name=name, launches=launches,
                         wall=card[name]["wall"], cpu_wall=twin["wall"]))
    for name, workers in SCALE_POOLED.items():
        if workers is None:
            workers = max(2, min(8, os.cpu_count() or 1))
        label = f"scale {name} pooled"
        flags.set_variant(SCALE_VARIANT)
        _zero_counts(kernels)
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            res = sharded_fit(name, inp, "cuda", workers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts(kernels)
        flags.reset()
        _require(res.stats["used_pool"] is True and
                 res.stats["workers"] == workers,
                 f"{label}: the shard fits did not run on {workers} "
                 f"spawned workers: {res.stats}")
        _require(_sha256(res.member.tobytes())
                 == SCALE_HELD[name]["member_sha256"],
                 f"{label}: the member differs from the serial run's")
        _require({k: res.stats[k] for k in SCALE_STATS}
                 == {k: card[name]["stats"][k] for k in SCALE_STATS},
                 f"{label}: stats differ from the serial run's")
        print(f"{label}: workers={workers} used_pool=True "
              f"wall_s={wall:.3f} serial_wall_s={card[name]['wall']:.3f} "
              f"member_match=serial parent_launches={launches} stage_s="
              f"{json.dumps({k: res.stats[k] for k in SCALE_SECONDS})}",
              flush=True)
    return runs


def phase_scale_profile(torch, inp):
    """fit-quick's serial fit once more under torch.profiler and the
    package tracer: the pipeline's stages (``scale.shard``, ``scale.fit``,
    ``scale.merge``, ``scale.repair``), the device's busy time and idle
    share, and each placement kernel's device ms per launch.  Numbers are
    under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import core, flags, obs

    flags.set_variant(SCALE_VARIANT + "+obstrace")
    obs.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with core.fresh_partition_cache():
            sharded_fit("fit-quick", inp, "cuda", 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages = {key: sum(e["dur"] for e in obs.tracer().spans(key)) / 1e6
              for key in ("scale.shard", "scale.fit", "scale.merge",
                          "scale.repair")}
    flags.reset()
    obs.reset()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    label = "profile scale fit-quick"
    print(f"{label}: wall_s={wall:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in stages.items()) + " "
          + (f"device_busy_s={busy:.4f} "
             f"device_idle_share={1 - busy / wall:.4f}" if rows else
             "device time not measured (the profiler saw no device "
             "activity)"), flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:70]!r} count={e.count} "
              f"device_ms={e.self_device_time_total / 1e3:.3f}")
    for kernel in ("span_gain", "lockstep_peel", "cover_rounds"):
        _print_kernel_device_ms(rows, label, kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after each fit phase and the serve phase, run "
                    "it once more under torch.profiler and print where the "
                    "time goes")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: package sources not found under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import _build
    from repro_torch.core import (ispd_like_workload, lmbr_stress_workload,
                                  random_workload)
    from repro_torch.core import LMBR_STRESS_DEFAULTS as STRESS
    from repro_torch.kernels.cover_rounds.ops import cover_rounds
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.lockstep_peel.ops import lockstep_peel
    from repro_torch.kernels.span_gain.ops import span_gains
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    fit_kernels = {"span_gain": span_gains, "cover_rounds": cover_rounds,
                   "lockstep_peel": lockstep_peel}
    model_kernels = {"flash_attention": flash_attention,
                     "decode_attention": decode_attention,
                     "ssd_scan": ssd_scan}
    kernels = {**fit_kernels, **model_kernels}
    rows = {}
    launches = {}
    path_launches = {}   # phase -> kernel -> launches on that path
    flash_instances = None
    ssd_built = None
    if "build" in phases:
        ssd_built = phase_build(_build)
    if "kernels" in phases:
        rows = phase_kernels(np, torch, dev)
        rows.update(phase_model_kernels(np, torch, dev))
        if ssd_built is not None:
            # every ssd_scan instance the build made ran in a checked row
            ran = {r["instance"] for r in rows["ssd_scan"]["shapes"]}
            missed = sorted(f"{d}.P{p}" for _, d, p in ssd_built
                            if d is not None and f"{d}.P{p}" not in ran)
            _require(not missed, f"kernels: no ssd_scan row ran {missed}")
    if "fit-stress" in phases:
        hg = lmbr_stress_workload(seed=0).hypergraph
        stress = phase_fit(np, torch, fit_kernels, "fit-stress", hg,
                           STRESS["num_partitions"], STRESS["capacity"],
                           STRESS["max_moves"], cpu_check=True)
        launches.update(stress["launches"])
        path_launches["fit-stress"] = stress["launches"]
        if args.profile:
            phase_profile(torch, "fit-stress", hg, STRESS["num_partitions"],
                          STRESS["capacity"], STRESS["max_moves"],
                          stress["peel_rounds"])
    if "fit-paper" in phases:
        n_nodes = PAPER_NODES
        hg = ispd_like_workload(num_nodes=n_nodes, seed=9).hypergraph
        label = f"fit-paper(n={n_nodes})"
        cap = int(math.ceil(n_nodes / 20))
        paper = phase_fit(np, torch, fit_kernels, label, hg, 35, cap, 600,
                          cpu_check=True)
        path_launches["fit-paper"] = paper["launches"]
        if args.profile:
            phase_profile(torch, label, hg, 35, cap, 600,
                          paper["peel_rounds"])
    if "paper-algos" in phases:
        makers = {"random_workload": random_workload,
                  "ispd_like_workload": ispd_like_workload}
        graphs = {key: makers[fn](**kw).hypergraph
                  for key, (fn, kw) in PAPER_WORKLOADS.items()}
        algo_runs = phase_paper_algos(np, torch, fit_kernels, graphs)
        path_launches["paper-algos"] = {
            name: sum(r["launches"][name] for r in algo_runs)
            for name in fit_kernels}
        if args.profile:
            phase_paper_profile(torch, graphs["fig9-ibm01"], 35, 638, "ihpa")
    if "placement-api" in phases:
        inp = api_inputs(np)
        api_runs = phase_placement_api(np, torch, fit_kernels, inp)
        path_launches["placement-api"] = {
            name: sum(r["launches"][name] for r in api_runs)
            for name in fit_kernels}
        if args.profile:
            phase_api_profile(torch, inp)
    if "online" in phases:
        inp = online_inputs(np)
        online_runs = phase_online(np, torch, fit_kernels, inp)
        path_launches["online"] = {
            name: sum(r["launches"][name] for r in online_runs)
            for name in fit_kernels}
        if args.profile:
            phase_online_profile(torch, inp)
    if "serve" in phases:
        served = phase_serve(torch, kernels, dev)
        launches.update({n: served["launches"][n] for n in model_kernels})
        path_launches["serve"] = {n: served["launches"][n]
                                  for n in model_kernels}
        flash_instances = served["flash_instances"]
        if args.profile:
            phase_serve_profile(np, torch, dev)
    if "serve-check" in phases:
        phase_serve_check(np, torch, kernels, dev)
    if "health" in phases:
        health_runs = phase_health(np, torch, fit_kernels, health_inputs(np))
        path_launches["health"] = {
            name: sum(r["launches"][name] for r in health_runs)
            for name in fit_kernels}
    if "scale" in phases:
        inp = scale_inputs(np)
        scale_runs = phase_scale(np, torch, fit_kernels, inp)
        path_launches["scale"] = {
            name: sum(r["launches"][name] for r in scale_runs)
            for name in fit_kernels}
        if args.profile:
            phase_scale_profile(torch, inp)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    replaces = {
        "span_gain": ("src/repro_torch/csrc/span_gain.cu",
                      "src/repro/kernels/span_gain/kernel.py:41"),
        "cover_rounds": ("src/repro_torch/csrc/cover_rounds.cu",
                         "src/repro/core/setcover.py:338"),
        "lockstep_peel": ("src/repro_torch/csrc/lockstep_peel.cu",
                          "src/repro/kernels/lockstep_peel/kernel.py:89"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:94"),
        "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:77"),
        "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:71"),
    }
    report = []
    for name, (source, tpu) in replaces.items():
        row = rows.get(name, {})
        report.append(dict(
            name=name, route="cuda", source=source, replaces=tpu,
            launches=launches.get(name),
            max_abs_err=row.get("max_abs_err"), ms=row.get("ms"),
            plain_ms=row.get("plain_ms"), bound_ms=row.get("bound_ms"),
            bound_by=row.get("bound_by"), library_ms=row.get("library_ms"),
            device_ms=row.get("device_ms"),
            library_device_ms=row.get("library_device_ms"),
            launches_by_path={path: counts[name] for path, counts
                              in path_launches.items() if name in counts},
        ))
        if name == "flash_attention":
            # ms is the instance's that the serving path runs
            report[-1].update(instance=row.get("instance"),
                              instance_launches=flash_instances)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

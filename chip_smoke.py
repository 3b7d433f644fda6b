#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's placement pipeline on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, as CI runs it
    python3 chip_smoke.py --phases build,kernels

Phases, each printed on a line of its own:

1. build      — compile the CUDA kernels from ``src/repro_torch/csrc``.
2. kernels    — hold each kernel against its plain PyTorch version on the
                card at the pipeline's shapes (exact match required) and
                time kernel, plain version and the bound of the work.
3. fit-stress — ``Simulator(64, 50).run(lmbr_stress_workload(seed=0), lmbr,
                seed=0, max_moves=1200)`` on the card with the dense peel
                and the span_gain kernel pinned; the summary and member
                matrix must equal the same call on the CPU bit for bit, and
                every kernel must have launched.
4. fit-paper  — the same fit and CPU cross-check on the largest fig9
                circuit (ibm10-like, 69 429 nodes, 35 partitions, capacity
                ceil(n/20), max_moves 600).

``--profile`` runs each fit once more under torch.profiler and the
package's tracer and prints where its time goes.

Then: the card's name and power limit (nvidia-smi), one JSON line with
every kernel's numbers, and the device line.  Any failed check raises and
the script exits non-zero without the device line.  Exits non-zero at once
when CUDA is unavailable or the package sources are missing.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM non-tensor fp32, NVIDIA data sheet
PHASES = ("build", "kernels", "fit-stress", "fit-paper")
PAPER_NODES = 69429          # ibm10, the largest fig9 circuit
# summary keys that record wall time or which backend ran
BACKEND_KEYS = {"placement_s", "fit_peel", "fit_cover_engine"}


def _bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
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


# ------------------------------------------------------------------ phases
def phase_build(_build):
    so = _build.build(force=True)
    print(f"build: {_build.BUILD_INFO['seconds']:.2f} s -> {Path(so).name}",
          flush=True)
    for line in _build.BUILD_INFO["ptxas"].splitlines():
        if "registers" in line or line.startswith("=="):
            print(f"  {line.strip()}")


def phase_kernels(np, torch, dev):
    from repro_torch.kernels.cover_rounds.ops import (
        cover_rounds, cover_rounds_plain)
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

    # cover_rounds: the stress tier's full bucket (10 000 queries, N=64,
    # W=1), plus a multi-word bucket and one over the shared-memory class
    cr = []
    for B, N, W in ((10_000, 64, 1), (2_000, 35, 2), (64, 256, 32)):
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
        cr.append(dict(shape=f"B{B}.N{N}.W{W}", max_abs_err=err,
                       ms=_cuda_ms(torch, lambda: cover_rounds(c, r), 50),
                       plain_ms=_cuda_ms(
                           torch, lambda: cover_rounds_plain(c, r), 3),
                       bound_ms=bound, bound_by=by))
    # an uncoverable query is flagged, the others still resolve
    c, r = _cover_inputs(np, torch, rng, 8, 16, 1, dev)
    c[3] = 0
    (ch, bad), (ch_p, bad_p) = cover_rounds(c, r), cover_rounds_plain(c, r)
    _require(bad.tolist() == bad_p.tolist() and bool(bad[3])
             and int(bad.sum()) == 1, "bad flag mismatch")
    _require(torch.equal(ch, ch_p), "cover_rounds bad-row chosen mismatch")
    rows["cover_rounds"] = dict(cr[0], shapes=cr)

    # lockstep_peel: pow2 classes of the LMBR dispatch (at most 2^22 floats
    # per launch), and one class whose state exceeds shared memory
    lp = []
    for G, K, U in ((256, 256, 64), (64, 1024, 64), (1, 8192, 512)):
        inc, we, nodew, nv = _peel_inputs(np, torch, rng, G, K, U, dev)
        got = lockstep_peel(inc, we, nodew, nv)
        want = lockstep_peel_plain(inc, we, nodew, nv)
        torch.cuda.synchronize()
        err = _max_abs(got, want)
        _require(err == 0, f"lockstep_peel G={G} K={K} U={U}: max|diff| {err}")
        rounds = (want[0] >= 0).sum(dim=1).double()
        nbytes = (G * K * U * 4 + G * K * 4 + G * U * 4 + G * 4
                  + 3 * G * U * 4)
        # degree build + updates (2 K U each) and per-round argmin + column
        design_ops = float((4.0 * K * U + rounds * (U + K)).sum())
        bound, by = _bound_ms(nbytes, design_ops)
        lp.append(dict(shape=f"G{G}.K{K}.U{U}", max_abs_err=err,
                       smem=uses_shared_memory(K, U),
                       ms=_cuda_ms(torch,
                                   lambda: lockstep_peel(inc, we, nodew, nv),
                                   20),
                       plain_ms=_cuda_ms(
                           torch,
                           lambda: lockstep_peel_plain(inc, we, nodew, nv),
                           2),
                       bound_ms=bound, bound_by=by,
                       design_ops=design_ops,
                       tpu_design_ops=float(rounds.max()) * 2 * K * U * G))
    _require(not lp[-1]["smem"], "global-scratch peel class not exercised")
    rows["lockstep_peel"] = dict(lp[0], shapes=lp)

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


def _zero_counts(kernels):
    for fn in kernels.values():
        fn.launches = 0


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

    flags.set_variant("peeldevice+spandevice")
    peel0 = peel_counters()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    res = Simulator(n, capacity, device="cuda").run(
        hg, lmbr, seed=0, max_moves=max_moves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(kernels)
    peel1 = peel_counters()
    flags.reset()
    _check_result(np, res, hg, label)
    for name, count in launches.items():
        _require(count > 0, f"{label}: kernel {name} never launched")
    line = (f"{label}: avg_span={res.avg_span:.4f} "
            f"placement_s={res.placement_seconds:.2f} wall_s={wall:.2f} "
            f"moves={res.placement_stats['moves']} launches={launches} "
            f"peel_pairs={ {k: peel1[k] - peel0[k] for k in peel0} }")
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
                placement_s=res.placement_seconds, avg_span=res.avg_span)


def phase_profile(torch, label, hg, n, capacity, max_moves):
    """The fit of ``phase_fit`` once more under torch.profiler and the
    package tracer: host-side split (HPA, LMBR move loop, replay) and the
    device's busy time by kernel.  Numbers are under the profiler."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="after each fit phase, run it once more under "
                    "torch.profiler and print where the time goes")
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
    from repro_torch.core import ispd_like_workload, lmbr_stress_workload
    from repro_torch.core import LMBR_STRESS_DEFAULTS as STRESS
    from repro_torch.kernels.cover_rounds.ops import cover_rounds
    from repro_torch.kernels.lockstep_peel.ops import lockstep_peel
    from repro_torch.kernels.span_gain.ops import span_gains

    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    kernels = {"span_gain": span_gains, "cover_rounds": cover_rounds,
               "lockstep_peel": lockstep_peel}
    rows = {}
    stress = None
    if "build" in phases:
        phase_build(_build)
    if "kernels" in phases:
        rows = phase_kernels(np, torch, dev)
    if "fit-stress" in phases:
        hg = lmbr_stress_workload(seed=0).hypergraph
        stress = phase_fit(np, torch, kernels, "fit-stress", hg,
                           STRESS["num_partitions"], STRESS["capacity"],
                           STRESS["max_moves"], cpu_check=True)
        if args.profile:
            phase_profile(torch, "fit-stress", hg, STRESS["num_partitions"],
                          STRESS["capacity"], STRESS["max_moves"])
    if "fit-paper" in phases:
        n_nodes = PAPER_NODES
        hg = ispd_like_workload(num_nodes=n_nodes, seed=9).hypergraph
        label = f"fit-paper(n={n_nodes})"
        cap = int(math.ceil(n_nodes / 20))
        phase_fit(np, torch, kernels, label, hg, 35, cap, 600,
                  cpu_check=True)
        if args.profile:
            phase_profile(torch, label, hg, 35, cap, 600)

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
    }
    report = []
    for name, (source, tpu) in replaces.items():
        row = rows.get(name, {})
        report.append(dict(
            name=name, route="cuda", source=source, replaces=tpu,
            launches=stress["launches"][name] if stress else None,
            max_abs_err=row.get("max_abs_err"), ms=row.get("ms"),
            plain_ms=row.get("plain_ms"), bound_ms=row.get("bound_ms"),
            bound_by=row.get("bound_by"), library_ms=None,
        ))
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

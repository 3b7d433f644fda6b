#!/usr/bin/env python3
"""Device time of the cover_rounds CUDA kernel on the buckets its path
launches, beside another version of its source.

    python3 tools/cover_rounds_probe.py
    python3 tools/cover_rounds_probe.py --other path/to/cover_rounds.cu

Records the buckets (codes, rem) that ``cover_rounds`` gets on two paths
of the port on the card: fig9's ibm01-like circuit under IHPA (35
partitions, capacity 638: the full build, IHPA's residual recompute and
the replay) and the LMBR stress fit (64 partitions, capacity 50,
``max_moves=1200``: the full build and the replay); adds chip_smoke's
synthetic buckets at the same shapes.  For each bucket it launches the
kernel as built (``src/repro_torch/csrc/cover_rounds.cu``) and, with
``--other``, the kernel built from the other source (same entry point),
holds both against the plain version bit for bit, and times them in turns
(other, built, built, other): the profiler's device ms per launch and
CUDA events over back-to-back launches.  Prints one line per bucket and
the card's name and power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import _bound_ms, _cover_inputs  # noqa: E402
from repro_torch import _build  # noqa: E402  (nvcc and its flags)

LAUNCH_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def build_other(source: Path, tmp: str):
    so = Path(tmp) / "other_cover_rounds.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          str(source), "-o", str(so)], capture_output=True,
                         text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed on {source}:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).cover_rounds_launch
    fn.argtypes, fn.restype = LAUNCH_ARGS, ctypes.c_int
    return fn


def record_paths(device: str = "cuda"):
    """(label, codes, rem) of every cover_rounds call of the two paths."""
    from repro_torch import flags
    from repro_torch.core import (ALGORITHMS, LMBR_STRESS_DEFAULTS,
                                  Simulator, ispd_like_workload, lmbr,
                                  lmbr_stress_workload, setcover)

    rounds_fn = setcover.cover_rounds
    seen = []

    def recording(codes, rem):
        if codes.shape[0]:
            seen.append((codes.clone(), rem.clone()))
        return rounds_fn(codes, rem)

    out = []
    fig9 = ispd_like_workload(num_nodes=12752, seed=0).hypergraph
    stress = lmbr_stress_workload(seed=0).hypergraph
    runs = [("fig9-ihpa", lambda: Simulator(35, 638, device=device).run(
                fig9, ALGORITHMS["ihpa"], name="ihpa", seed=0)),
            ("fit-stress", lambda: Simulator(
                LMBR_STRESS_DEFAULTS["num_partitions"],
                LMBR_STRESS_DEFAULTS["capacity"], device=device).run(
                stress, lmbr, seed=0,
                max_moves=LMBR_STRESS_DEFAULTS["max_moves"]))]
    for label, run in runs:
        flags.set_variant("peeldevice+spandevice")
        setcover.cover_rounds = recording
        try:
            run()
        finally:
            setcover.cover_rounds = rounds_fn
            flags.reset()
        out += [(f"{label}#{i}", c, r) for i, (c, r) in enumerate(seen)]
        seen.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path,
                    help="another cover_rounds.cu to time beside the built "
                    "one")
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.cover_rounds.ops import (cover_rounds_plain,
                                                      max_rounds,
                                                      rounds_class)

    if not torch.cuda.is_available():
        print("cover_rounds_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    built = _build.lib().cover_rounds_launch
    rng = np.random.default_rng(0)
    buckets = record_paths()
    for B, N, W in ((14_027, 35, 1), (10_000, 64, 1)):
        c, r = _cover_inputs(np, torch, rng, B, N, W, dev)
        buckets.append((f"synthetic B{B}.N{N}.W{W}", c, r))

    def timed(fn, codes, rem, ch, bad, iters):
        B, N, W = codes.shape

        def call():
            err = fn(codes.data_ptr(), rem.data_ptr(), ch.data_ptr(),
                     bad.data_ptr(), B, N, W, ch.shape[1], dev.index or 0,
                     stream)
            if err:
                raise RuntimeError(f"cover_rounds: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        device = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and "cover_rounds" in e.key) / 1e3 / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        return device, start.elapsed_time(end) / iters

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}; device ms per launch (profiler) "
          f"and event ms per launch, {args.iters} launches each, in turns "
          "other, built, built, other", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        other = build_other(args.other, tmp) if args.other else None
        for label, codes, rem in buckets:
            B, N, W = codes.shape
            want_ch, want_bad = cover_rounds_plain(codes, rem)
            spans = (want_ch >= 0).sum(dim=1)
            Rmax = max_rounds(N, W)
            bound, by = _bound_ms(
                B * N * W * 8 + B * W * 8 + B * Rmax * 4 + B,
                float(spans.sum()) * N * (3 * W + 1))
            fns = {"built": built}
            if other is not None:
                fns["other"] = other
            for name, fn in fns.items():
                ch = torch.empty((B, Rmax), dtype=torch.int32, device=dev)
                bad = torch.empty(B, dtype=torch.uint8, device=dev)
                timed(fn, codes, rem, ch, bad, 1)
                if not (torch.equal(ch, want_ch)
                        and torch.equal(bad.bool(), want_bad)):
                    raise SystemExit(f"{label}: the {name} kernel differs "
                                     "from the plain version")
            order = (["other", "built", "built", "other"] if other
                     else ["built", "built"])
            res = {k: [] for k in fns}
            for name in order:
                ch = torch.empty((B, Rmax), dtype=torch.int32, device=dev)
                bad = torch.empty(B, dtype=torch.uint8, device=dev)
                res[name].append(timed(fns[name], codes, rem, ch, bad,
                                       args.iters))
            parts = [f"{name} device_ms={[round(d, 6) for d, _ in v]} "
                     f"event_ms={[round(e, 6) for _, e in v]}"
                     for name, v in res.items()]
            print(f"{label} B{B}.N{N}.W{W} class={rounds_class(N, W)} "
                  f"spans_mean={float(spans.float().mean()):.4f} "
                  f"spans_max={int(spans.max())} "
                  f"bound_ms={bound:.6f} bound_by={by} match=bitwise "
                  + " ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

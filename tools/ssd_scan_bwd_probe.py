#!/usr/bin/env python3
"""Where the time of ssd_scan's backward CUDA kernel goes, pass by pass.

    python3 tools/ssd_scan_bwd_probe.py               # every variant
    python3 tools/ssd_scan_bwd_probe.py base grad-no-bg
    python3 tools/ssd_scan_bwd_probe.py base --other OLD.cu [--shape hymba]

Builds ``src/repro_torch/csrc/ssd_scan_bwd.cu`` once as it stands and once
per variant with one part of a pass cut out (the source text is patched
in a temporary copy; a variant whose text no longer matches the source
fails), all builds at once, then runs each at mamba2-2.7b's training shape
(bf16 x, B 8, S 1024, 80 heads of 64, state 128; ``--shape hymba``: 50
heads, state 16) in turns, twice, and prints the profiler's device ms per
call of each pass.  ``--other`` adds another source of the same C
interface (``other``), e.g. an earlier version of the file.  A variant
computes wrong gradients: its time says what the part it cuts costs,
nothing else.  Needs a CUDA card and ``nvcc``.
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
from repro_torch import _build  # noqa: E402  (nvcc and its flags)

SOURCE = _build.CSRC / "ssd_scan_bwd.cu"


def _skip(loop: str) -> tuple:
    """The loop header ``loop`` made to run no iteration."""
    head, rest = loop.split(";", 1)
    cond, step = rest.split(";", 1)
    var = head.split()[-3]
    return loop, f"{head}; {var} < -1 &&{cond};{step}"


VARIANTS = {
    "base": [],
    # state pass: x^T (w B) / dy^T (e C) skipped
    "state-no-own": [_skip("for (int u0 = 0; u0 < L; u0 += 16) {")],
    "state-no-rev": [_skip("for (int t0 = 0; t0 < L; t0 += 8) {\n"
                           "        const float* dr")],
    # state pass: no slot stored / no chunk after the first two staged
    "state-no-store": [
        ("        store_pair(slot, N, p0 + g, nt * 8 + 2 * q, st[j][0], "
         "st[j][1]);\n        store_pair(slot, N, p0 + g + 8, nt * 8 + 2 * "
         "q, st[j][2], st[j][3]);", "")],
    "state-no-stage": [("    if (i + 2 < nc) stage(i + 2, k);", "")],
    # gradient pass: one product skipped: the gated dy x^T, att^T dy, B
    # g^T, the dC rank part, the dB rank part
    "grad-no-mg": [_skip("for (int p0 = 0; p0 < P; p0 += 16) {\n"
                         "          const float* dr")],
    "grad-no-att": [_skip("for (int t0 = u0; t0 < L; t0 += 8) {")],
    "grad-no-bg": [_skip("for (int k0 = 0; k0 < Np; k0 += 8) {\n"
                         "        const float* br = bs + ua")],
    "grad-no-dc": [_skip("for (int p0 = 0; p0 < P; p0 += 8) {\n"
                         "        const float* dr = dys + (rt0")],
    "grad-no-db": [_skip("for (int p0 = 0; p0 < P; p0 += 16) {\n"
                         "          const T* xr")],
    # gradient pass: every product above skipped / warp 0's dcum, scan
    # and ddt skipped
    "grad-no-products": [],
    "grad-no-dcum": [("    if (warp == 0) {\n      const int u0 = 2 * lane",
                      "    if (warp < 0) {\n      const int u0 = 2 * lane")],
    # gradient pass: no head after the first two staged (grad-bare: nor
    # any product)
    "grad-no-stage": [("    if (hh + 2 < H) stage_head(hh + 2, k);", ""),
                      ("      stage_f32<kGradThreads>(hsm, SG, "
                       "hslot(hh + 1), N, P, P, N, Np);", "      ;")],
}
VARIANTS["state-no-products"] = [
    edit for name in ("state-no-own", "state-no-rev")
    for edit in VARIANTS[name]]
VARIANTS["grad-no-products"] = [
    edit for name in ("grad-no-mg", "grad-no-att", "grad-no-bg", "grad-no-dc",
                      "grad-no-db") for edit in VARIANTS[name]]
VARIANTS["grad-bare"] = VARIANTS["grad-no-products"] + VARIANTS[
    "grad-no-stage"]
PASSES = ("state", "chain", "grad", "reduce")  # chain: earlier sources
SHAPES = {"mamba2": (8, 1024, 80, 64, 128), "hymba": (8, 1024, 50, 64, 16)}


def _sources(names, other, tmp) -> dict:
    srcs = {}
    base = SOURCE.read_text()
    for name in names:
        src = base
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"variant {name}: source text not found:\n"
                                 f"{old}")
            src = src.replace(old, new, 1)
        srcs[name] = src
    if other:
        srcs["other"] = Path(other).read_text()
    paths = {}
    for name, src in srcs.items():
        cu = Path(tmp) / f"{name}.cu"
        cu.write_text(src)
        paths[name] = cu
    return paths


def build_all(paths: dict, tmp: str) -> dict:
    procs = {}
    for name, cu in paths.items():
        so = Path(tmp) / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{err}")
        regs = [line.split("Used ")[1].split(",")[0] for line in
                err.splitlines() if "Used" in line and "registers" in line]
        print(f"{name}: built, registers by entry {regs}", flush=True)
        out[name] = str(so)
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help=", ".join(VARIANTS))
    ap.add_argument("--other", help="another ssd_scan_bwd source to time")
    ap.add_argument("--shape", default="mamba2", choices=sorted(SHAPES))
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ssd_scan_bwd_probe: CUDA is not available", file=sys.stderr)
        return 2
    names = args.variants or list(VARIANTS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    B, S, H, P, N = SHAPES[args.shape]
    x = randn(B, S, H, P).to(torch.bfloat16)
    dt = F.softplus(randn(B, S, H) - 2.0)
    a = -torch.exp(randn(H, scale=0.3))
    bm, cm = randn(B, S, N, scale=0.3), randn(B, S, N, scale=0.3)
    h0, dh = randn(B, H, P, N, scale=0.1), randn(B, H, P, N, scale=0.1)
    dy, y = randn(B, S, H, P), randn(B, S, H, P)
    outs = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a),
            torch.empty_like(bm), torch.empty_like(cm), torch.empty_like(h0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}; B {B} S {S} H {H} P {P} N {N} bf16;"
          " device ms per call, 10 calls, two turns", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(_sources(names, args.other, tmp), tmp)
        calls = {}
        for name, so in libs.items():
            lib = ctypes.CDLL(so)
            fn = lib.ssd_scan_bwd_launch
            fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.ssd_scan_bwd_workspace.restype = ctypes.c_longlong
            ws = torch.empty(lib.ssd_scan_bwd_workspace(B, S, H, P, N),
                             device=dev)

            def call(fn=fn, ws=ws, name=name):
                err = fn(x.data_ptr(), dy.data_ptr(), y.data_ptr(),
                         dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                         cm.data_ptr(), h0.data_ptr(), dh.data_ptr(),
                         *(o.data_ptr() for o in outs), ws.data_ptr(), B, S,
                         H, P, N, 1, dev.index or 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            calls[name] = (call, ws.numel() * 4)
        for turn in range(2):
            for name, (call, ws_bytes) in calls.items():
                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                rows = [e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA]
                ms = {p: sum(e.self_device_time_total for e in rows
                             if f"ssd_bwd_{p}_kernel" in e.key) / 1e3 / 10
                      for p in PASSES}
                print(f"turn {turn} {name}: "
                      + " ".join(f"{p}={ms[p]:.4f}" for p in PASSES)
                      + f" total={sum(ms.values()):.4f} "
                      f"workspace_bytes={ws_bytes}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

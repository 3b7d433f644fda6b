#!/usr/bin/env python3
"""Where the time of the ssd_scan CUDA kernel goes, pass by pass.

    python3 tools/ssd_scan_probe.py               # every variant
    python3 tools/ssd_scan_probe.py base output-no-intra

Builds ``src/repro_torch/csrc/ssd_scan.cu`` once as it stands and once per
variant with one part of a pass cut out (the source text is patched in a
temporary copy; a variant whose text no longer matches the source fails),
runs each build at hymba-1.5b's prefill shape (bf16 x, B 8, S 2048, 50
heads of 64, state 16, chunk 256) and prints the profiler's device ms per
call of each pass.  A variant computes a wrong y: its time says what the
part it cuts costs, nothing else.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import _build  # noqa: E402  (nvcc and its flags)

SOURCE = _build.CSRC / "ssd_scan.cu"
NO_FMA = ("    for (int u = grp * span; u < u1; ++u) {",
          "    for (int u = grp * span; u < grp * span; ++u) {")
VARIANTS = {
    "base": [],
    # state pass: x not staged / the x^T (w B) product skipped
    "state-no-x": [("  stage_x<T, P, P>(xs, x, row0, H, h, Lc, Lp);", "")],
    "state-no-fma": [NO_FMA],
    # output pass: no intra-chunk loop / att . x, C B^T products replaced by
    # adds / x, B, C not staged / y not stored
    "output-no-intra": [
        ("for (int u0 = 0; u0 < mt * 16 + 16; u0 += 16) {",
         "for (int u0 = 0; u0 < 0; u0 += 16) {")],
    "output-no-att-x": [
        ("            mma_bf16(acc[j], ap[k], bx[0], bx[1]);\n"
         "            mma_bf16(acc[j + 1], ap[k], bx[2], bx[3]);",
         "            acc[j][0] += __uint_as_float(ap[k][0] ^ bx[0]);\n"
         "            acc[j + 1][1] += __uint_as_float(ap[k][1] ^ bx[3]);")],
    "output-no-cb": [
        ("          mma3(cbt[i], ah, al, bh, bl);",
         "          cbt[i][0] += __uint_as_float(bh[0] ^ al[1]);\n"
         "          cbt[i][3] += __uint_as_float(bl[1] ^ ah[2]);")],
    "output-no-stage": [
        ("  stage_x<T, P, SX>(xs, x, row0, H, h, Lc, Lp);\n"
         "  stage_rows(bs, bm + row0 * N, Lc, Lp, N, Np, SN);\n"
         "  stage_rows(cs, cm + row0 * N, Lc, Lp, N, Np, SN);", "")],
    "output-no-store": [
        ("      if (ta < Lc)\n", "      if (ta < 0)\n"),
        ("      if (tb < Lc)\n", "      if (tb < 0)\n")],
}
PASSES = ("state", "chain", "output")


def build(name: str, tmp: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: source text not found:\n{old}")
        src = src.replace(old, new)
    cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          str(cu), "-o", str(so)], capture_output=True,
                         text=True)
    if res.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{res.stderr}")
    return str(so)


def main(argv: list[str]) -> int:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ssd_scan_probe: CUDA is not available", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    B, S, H, P, N, L = 8, 2048, 50, 64, 16, 256
    nc = -(-S // L)
    x = randn(B, S, H, P).to(torch.bfloat16)
    dt = F.softplus(randn(B, S, H) - 1.0)
    a = -torch.exp(randn(H, scale=0.3))
    bm, cm = randn(B, S, N, scale=0.3), randn(B, S, N, scale=0.3)
    h0 = randn(B, H, P, N, scale=0.1)
    y, h_last = torch.empty(B, S, H, P, device=dev), torch.empty_like(h0)
    ws = torch.empty(B * H * nc * (P * N + 1), device=dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}; B {B} S {S} H {H} P {P} N {N} "
          f"chunk {L} bf16; device ms per call, 20 calls", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            fn = ctypes.CDLL(build(name, tmp)).ssd_scan_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call():
                err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                         bm.data_ptr(), cm.data_ptr(), h0.data_ptr(),
                         y.data_ptr(), h_last.data_ptr(), ws.data_ptr(), B,
                         S, H, P, N, L, 1, dev.index or 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            ms = {p: sum(e.self_device_time_total for e in rows
                         if f"ssd_scan_{p}_kernel" in e.key) / 1e3 / 20
                  for p in PASSES}
            print(f"{name}: " + " ".join(f"{p}={ms[p]:.4f}" for p in PASSES)
                  + f" total={sum(ms.values()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

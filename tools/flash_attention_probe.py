#!/usr/bin/env python3
"""Time builds of the flash_attention CUDA kernel against each other.

    python3 tools/flash_attention_probe.py          # base and every variant
    python3 tools/flash_attention_probe.py base \
        --other benchmarks/results/parent/flash_attention.cu

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it stands ("base"),
once per variant (the source text is patched in a temporary copy; a
variant whose text no longer matches the source fails) and, with each
``--other PATH``, another source of the same C interface (named by its
directory and stem, e.g. the parent commit's, copied into the git-ignored
``benchmarks/results/parent/``).
All builds are compiled at once.  Each build's ptxas report of the flash
kernels is printed (registers, spill bytes).  Then every build runs the
serving shapes (B 8, S = T 2048, bf16: hymba-1.5b's H 25 / K 5 at D 64,
glm4-9b's 32 / 2 at D 128, h2o-danube-1.8b's 32 / 8 at D 80, global and
window 1024), is held to the plain version by the card's bf16 rule (one
bf16 ulp, at most 1% of the outputs differing), and is timed by the
profiler's device ms per call over 10 calls; the builds take turns, in
order and then in reverse order, so that a drift of the card shows.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import _build  # noqa: E402  (nvcc and its flags)

SOURCE = _build.CSRC / "flash_attention.cu"
VARIANTS = {
    "base": [],
    # the D 80 / 128 instances built for one block an SM (255 registers)
    "one-block": [("constexpr int kTcWideBlocks = 2;",
                   "constexpr int kTcWideBlocks = 1;")],
    # the D 64 instance with the warpgroup index broadcast as well
    "d64-uniform": [(
        "const int wg = NSUB > 1 ? __shfl_sync(0xffffffffu, tid >> 7, 0) "
        ": tid >> 7;",
        "const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);")],
}
SHAPES = (  # label, H, K, D, window
    ("hymba-1.5b", 25, 5, 64, None),
    ("glm4-9b", 32, 2, 128, None),
    ("h2o-danube-1.8b", 32, 8, 80, None),
    ("h2o-danube-1.8b", 32, 8, 80, 1024),
)
B, S = 8, 2048


def start_build(name: str, src: str, tmp: str, include=None):
    """nvcc on ``src``; ``include``, a directory searched for wgmma.cuh
    before this tree's (another tree's header may differ)."""
    stem = name.replace("/", "-")
    cu, so = Path(tmp) / f"{stem}.cu", Path(tmp) / f"{stem}.so"
    cu.write_text(src)
    first = ["-I", str(include)] if include is not None else []
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                             *first, "-I", str(_build.CSRC),
                             str(cu), "-o", str(so)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return so, proc


def patched(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: source text not found:\n{old}")
        src = src.replace(old, new)
    return src


def ptxas_lines(report: str) -> list[str]:
    """'entry registers spills' of each flash kernel in a ptxas report."""
    out, entry, spills = [], None, "0/0"
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry, spills = m.group(1), "0/0"
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line):
            spills = f"{m.group(1)}/{m.group(2)}"
        if (m := re.search(r"Used (\d+) registers", line)) and entry:
            k = re.search(r"flash_attention_(wgmma_)?kernelI"
                          r"(13__nv_bfloat16|f)?Li(\d+)E", entry)
            if k:
                name = (f"wgmma<{k.group(3)}>" if k.group(1) else
                        f"fma<{'f32' if k.group(2) == 'f' else 'bf16'},"
                        f"{k.group(3)}>")
                out.append(f"{name} registers={m.group(1)} spills={spills}")
            entry = None
    return out


def main(argv: list[str]) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.ops import flash_attention_plain

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="another flash_attention.cu to build and time "
                         "(repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_attention_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}; B {B} S = T {S} bf16; device ms per "
          f"call, 10 calls", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        sources = {name: patched(name) for name in args.variants}
        includes = {}
        for path in args.other:
            sources[f"{path.parent.name}/{path.stem}"] = path.read_text()
            includes[f"{path.parent.name}/{path.stem}"] = path.parent
        procs = {name: start_build(name, src, tmp, includes.get(name))
                 for name, src in sources.items()}
        libs = {}
        for name, (so, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{err}")
            print(f"{name} ptxas: " + "; ".join(ptxas_lines(out + err)),
                  flush=True)
            fn = ctypes.CDLL(str(so)).flash_attention_launch
            # sources since the forward stores lse take its buffer after out
            takes_lse = "void* lse_p" in sources[name]
            fn.argtypes = [ctypes.c_void_p] * (5 if takes_lse else 4) + [
                ctypes.c_int] * 10 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            libs[name] = (fn, takes_lse)

        gen = torch.Generator(device=dev).manual_seed(27)
        for label, H, K, D, window in SHAPES:
            q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
            k = torch.randn((B, S, K, D), generator=gen, device=dev).bfloat16()
            v = torch.randn((B, S, K, D), generator=gen, device=dev).bfloat16()
            want = flash_attention_plain(q, k, v, window=window)
            out = torch.empty_like(q)
            times = {name: [] for name in libs}

            def call(lib):
                fn, takes_lse = lib
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), *([None] if takes_lse else []),
                         B, S, S, H, K, D, 1, window or 0, 1, dev.index or 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            for name in [*libs, *reversed(libs)]:
                lib = libs[name]
                out.zero_()
                call(lib)
                torch.cuda.synchronize()
                close = bool(torch.allclose(out.float(), want.float(),
                                            rtol=2.0 ** -7, atol=1e-5))
                share = float((out != want).float().mean())
                if not close or share > 0.01:
                    raise SystemExit(f"{name} {label} D {D} window {window}: "
                                     f"fails the bf16 rule (share {share})")
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call(lib)
                    torch.cuda.synchronize()
                times[name].append(sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3 / 10)
            print(f"{label} H {H} K {K} D {D} window {window}: " + " ".join(
                f"{name}=" + "/".join(f"{t:.4f}" for t in ts)
                for name, ts in times.items()), flush=True)
            del q, k, v, want, out
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

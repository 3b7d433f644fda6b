#!/usr/bin/env python3
"""Build the latent (MLA) attention kernels and check them quickly.

    python3 tools/mla_attention_probe.py

Builds the package's kernels (``src/repro_torch/csrc``), prints the ptxas
report of ``mla_attention.cu`` (registers, spill bytes of each instance),
then runs ``flash_attention_latent`` and ``decode_attention_latent`` in
bf16 and f32 at deepseek-v3-671b's widths (H 128, R 512, Dr 64, scale
192^-0.5) and at small odd shapes, against their plain versions: the
largest difference, the share of outputs that differ, and the kernel's
time by CUDA events (prefill at S >= 1528 over 2 calls, with its fp32
rate; decode over 20 calls).  Decode runs over a wrapped cache with empty
slots and per-row query positions.  The first check of a new kernel on
the card; ``chip_smoke.py``'s ``kernels`` phase holds the same kernels to
the card's rules.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_latent, decode_attention_latent_plain)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_latent, flash_attention_latent_plain)

SCALE = 192 ** -0.5
PREFILL = ((2, 200, 128), (1, 77, 3), (8, 2048, 128), (2, 1528, 128))
DECODE = ((8, 2112, 128), (2, 300, 5), (8, 18, 128), (3, 1536, 128))


def _event_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _diff(got, want) -> str:
    err = float((got.float() - want.float()).abs().max())
    share = float((got != want).float().mean())
    return f"err={err:.3e} diffshare={share:.4f}"


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_attention_probe: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.time()
    _build.lib()
    print(f"build_s {time.time() - t0:.1f}", flush=True)
    report = _build.BUILD_INFO.get("ptxas", "")
    if "== mla_attention.cu" in report:
        section = report[report.index("== mla_attention.cu"):]
        for line in section.splitlines()[1:]:
            if line.startswith("== "):
                break
            if "registers" in line or "spill" in line or "entry" in line:
                print(line.strip()[:200])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h in PREFILL:
            args = (randn(b, s, h, 512).to(dtype),
                    randn(b, s, h, 64).to(dtype),
                    randn(b, s, 512).to(dtype), randn(b, s, 64).to(dtype))
            got = flash_attention_latent(*args, scale=SCALE)
            want = flash_attention_latent_plain(*args, scale=SCALE)
            torch.cuda.synchronize()
            line = f"prefill {dtype} B{b} S{s} H{h} {_diff(got, want)}"
            if s >= 1528:
                ms = _event_ms(lambda: flash_attention_latent(
                    *args, scale=SCALE), 2)
                flops = 2 * b * h * s * (s + 1) / 2 * (512 + 576)
                line += f" ms={ms:.2f} tflops={flops / ms / 1e9:.1f}"
            print(line, flush=True)
            del args, got, want
        for b, t, h in DECODE:
            slot = torch.arange(t, device=dev, dtype=torch.int32)
            roll = torch.randint(0, t, (b,), generator=gen, device=dev,
                                 dtype=torch.int32)
            kv_pos = ((slot[None] - roll[:, None]) % t).to(torch.int32)
            kv_pos[min(1, b - 1), :30] = -1
            q_pos = torch.randint(t // 2, t, (b,), generator=gen, device=dev,
                                  dtype=torch.int32)
            args = (randn(b, h, 512).to(dtype), randn(b, h, 64).to(dtype),
                    randn(b, t, 512).to(dtype), randn(b, t, 64).to(dtype),
                    kv_pos, q_pos)
            got = decode_attention_latent(*args, scale=SCALE)
            want = decode_attention_latent_plain(*args, scale=SCALE)
            torch.cuda.synchronize()
            ms = _event_ms(lambda: decode_attention_latent(
                *args, scale=SCALE), 20)
            print(f"decode {dtype} B{b} T{t} H{h} {_diff(got, want)} "
                  f"ms={ms:.4f}", flush=True)
    print("launches", flash_attention_latent.launches,
          decode_attention_latent.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())

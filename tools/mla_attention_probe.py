#!/usr/bin/env python3
"""Build the latent (MLA) attention kernels and check them quickly.

    python3 tools/mla_attention_probe.py

Builds the package's kernels (``src/repro_torch/csrc``), prints a ptxas
line for each kernel of ``mla_attention.cu`` (registers, spill bytes: the
bf16 tensor-core kernel ``mla_attention_wgmma_kernel<decode>`` in
prefill and decode, the f32 CUDA-core ``mla_attention_kernel<f32,
decode>`` instances and the decode merge), then runs
``flash_attention_latent`` and ``decode_attention_latent`` in bf16 and
f32 at deepseek-v3-671b's widths (H 128, R 512, Dr 64, scale 192^-0.5)
and at small odd shapes (H 3 and 5, whose 64-row blocks span positions
or hold fewer than 64 heads), against their plain versions: the largest
difference, the share of outputs that differ, and the kernel's time by
CUDA events (prefill at S >= 1528 over 2 calls, with its rate in TFLOP/s
of counted work; decode over 20 calls).  Decode runs over a wrapped
cache with empty slots and per-row query positions.  The first check of
a new kernel on the card; ``chip_smoke.py``'s ``kernels`` phase holds the
same kernels to the card's rules.  Needs a CUDA card and ``nvcc``.

    python3 tools/mla_attention_probe.py --variants [NAME ...] \
        [--other benchmarks/results/parent/mla_attention.cu]

instead builds ``mla_attention.cu`` as it stands ("base") and copies of
it with one part of the bf16 tensor-core kernel cut out (``VARIANTS``:
its S products, its P V products, its key-tile copies after the first
tile, or both products), a copy that issues its key copies under the
asynchronous products, and copies with L2 hints on its copies, all at
once, checks "base" against the plain versions and times each, in bf16,
at deepseek-v3's prefill (B 8, S = T 2048, H 128) and at its serving
decode (B 8, T 2112, H 128, the wrapper's split plan, the merge launch
included) in turns (in order, then reversed) by profiler device time:
what a cut saves is roughly what that part costs.  Prefill and decode
share the kernel's body, so each cut acts on both.  The cut variants
compute wrong outputs; they are timed, never used.  ``--other`` adds
another source (say the parent commit's, copied into the git-ignored
``benchmarks/results/``), checked, compared with "base" bit for bit
(``bits_equal_base``) and timed beside them.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    LATENT_TILE_KEYS, decode_attention_latent, decode_attention_latent_plain,
    latent_split_plan)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_latent, flash_attention_latent_plain)

SCALE = 192 ** -0.5
SOURCE = _build.CSRC / "mla_attention.cu"
VARIANTS = {
    "base": [],
    "no-qk": [("""        wgmma_ss_n32(s, q_desc + j * (kPiece >> 4) + 2 * kk, kd + 2 * kk,
                     j + kk > 0);""", "        (void)kd;")],
    "no-pv": [("""        wgmma_rs(o[u], own + 4 * kk, v_own + 128 * kk);
        wgmma_rs(o[u], own + 8 + 4 * kk, v_own + 128 * kk);
        wgmma_rs(o[u], other + 4 * kk, v_other + 128 * kk);
        wgmma_rs(o[u], other + 8 + 4 * kk, v_other + 128 * kk);""",
               "        (void)v_own; (void)v_other;")],
    "no-loads": [
        ("      for (int j = 0; j < kPieces - 1; ++j) load_piece(n + 1, j);",
         "      ;"),
        ("    if (n + 1 < ntiles) load_piece(n + 1, kPieces - 1);", "")],
}
# two cuts at once: the copies and the barriers alone
VARIANTS["loads-only"] = VARIANTS["no-qk"] + VARIANTS["no-pv"]
# the copies issued while the tensor cores run S (tile n + 1's pieces
# 0..7 and, in decode, its slot positions) and P V (its last piece),
# instead of before each
_FIRST_COPIES = """    if (n + 1 < ntiles) {
      for (int j = 0; j < kPieces - 1; ++j) load_piece(n + 1, j);
      load_pos(n + 1);
    }
    cp_async_commit();
"""
VARIANTS["copies-under-products"] = [
    ("    __syncthreads();\n" + _FIRST_COPIES, "    __syncthreads();\n"),
    ("""    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);""", """    wgmma_commit();
""" + _FIRST_COPIES + """    wgmma_wait_all();
    fence_regs(s);"""),
    ("""    __syncthreads();
    if (n + 1 < ntiles) load_piece(n + 1, kPieces - 1);
    cp_async_commit();""", "    __syncthreads();"),
    ("""    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < 4; ++u) fence_regs(o[u]);""", """    wgmma_commit();
    if (n + 1 < ntiles) load_piece(n + 1, kPieces - 1);
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < 4; ++u) fence_regs(o[u]);""")]
# L2 hints on the copies: a 256-byte L2 prefetch on the key copies; or the
# keys kept in L2 (evict-last) while q, read once, goes first (evict-first).
# The copies sit in wgmma.cuh's staging helpers, so a variant puts their
# loops in place of the calls, with its own copy instruction
_KEY_STAGE = """    stage_latent_piece(ring + ring_slot(n, j) * kPiece, kr, ck,
                       t_begin + n * 64, t_end, j, tid, kTcThreads);"""
_Q_STAGE = "  stage_latent_rows(sq, qr, ql, r0, rows, tid, kTcThreads);"


def _key_loop(copy: str) -> str:
    """The key tile's piece copies (stage_latent_piece) with ``copy``
    (of dst, src and ok) in place of cp_async16."""
    return """    const uint32_t dst = ring + ring_slot(n, j) * kPiece;
    for (int e = tid; e < 64 * 8; e += kTcThreads) {
      const int k = e >> 3, c = e & 7;
      const bool ok = t_begin + n * 64 + k < t_end;
      const long long t = ok ? t_begin + n * 64 + k : 0;
      const __nv_bfloat16* src =
          j == 0 ? kr + t * kDr + 8 * c : ck + t * kR + 64 * (j - 1) + 8 * c;
      const uint32_t at = swizzled(dst, k, c);
""" + copy + """
    }"""


def _q_loop(copy: str) -> str:
    """Q's copies (stage_latent_rows) with ``copy`` in place of
    cp_async16."""
    return """  for (int e = tid; e < 64 * kPieces * 8; e += kTcThreads) {
    const int i = e / (kPieces * 8), c = e - i * (kPieces * 8);
    const bool ok = r0 + i < rows;
    const long long r = ok ? r0 + i : 0;
    const __nv_bfloat16* src =
        c < 8 ? qr + r * kDr + 8 * c : ql + r * kR + 8 * (c - 8);
    const uint32_t at = swizzled(sq + (c >> 3) * kPiece, i, c & 7);
""" + copy + """
  }"""


VARIANTS["l2-prefetch"] = [(_KEY_STAGE, _key_loop("""      asm volatile(
          "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\\n"
          ::"r"(at), "l"(src), "r"(ok ? 16 : 0));"""))]
VARIANTS["l2-policy"] = [
    (_Q_STAGE, """  uint64_t keep, drop;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(keep));
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(drop));
""" + _q_loop("""    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\\n"
        ::"r"(at), "l"(src), "r"(ok ? 16 : 0), "l"(drop));""")),
    (_KEY_STAGE, _key_loop("""      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, "
          "%3;\\n" ::"r"(at), "l"(src), "r"(ok ? 16 : 0), "l"(keep));"""))]
PREFILL = ((2, 200, 128), (1, 77, 3), (8, 2048, 128), (2, 1528, 128))
DECODE = ((8, 2112, 128), (2, 300, 5), (8, 18, 128), (3, 1536, 128),
          (2, 777, 3))


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


def ptxas_lines(report: str) -> list[str]:
    """'kernel registers spills' of each kernel of mla_attention.cu in a
    ptxas report (empty when the library was already built)."""
    out, source, entry, spills = [], None, None, "0/0"
    for line in report.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry, spills = m.group(1), "0/0"
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line):
            spills = f"{m.group(1)}/{m.group(2)}"
        if (m := re.search(r"Used (\d+) registers", line)) and entry:
            if source == "mla_attention.cu":
                k = re.search(r"mla_(attention_wgmma|attention|decode_merge)"
                              r"_kernelI(13__nv_bfloat16|f)?(Lb([01]))?E",
                              entry)
                name = f"mla_{k.group(1)}_kernel" if k else entry[:60]
                if k:
                    args = [] if not k.group(2) else [
                        "bf16" if k.group(2) != "f" else "f32"]
                    if k.group(4):
                        args.append("decode" if k.group(4) == "1"
                                    else "prefill")
                    name += "<" + ", ".join(args) + ">"
                out.append(f"{name} registers={m.group(1)} "
                           f"spills={spills}")
            entry = None
    return out


def _variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: source text found "
                             f"{src.count(old)} times, want once:\n{old}")
        src = src.replace(old, new)
    return src


def _device_ms(fn, n: int) -> tuple[float, float]:
    """Profiler device time of ``n`` calls of ``fn`` per call: of every
    kernel they launch, and of the decode merge's alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = [(e.key, e.self_device_time_total / 1e3 / n)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(t for _, t in times),
            sum(t for k, t in times if "mla_decode_merge_kernel" in k))


def _decode_inputs(dev, gen, b: int, t: int, h: int, dtype):
    """Decode arguments over a wrapped cache with empty slots and per-row
    query positions."""
    slot = torch.arange(t, device=dev, dtype=torch.int32)
    roll = torch.randint(0, t, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    kv_pos = ((slot[None] - roll[:, None]) % t).to(torch.int32)
    kv_pos[min(1, b - 1), :30] = -1
    q_pos = torch.randint(t // 2, t, (b,), generator=gen, device=dev,
                          dtype=torch.int32)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, h, 512), (b, h, 64), (b, t, 512),
                               (b, t, 64))) + (kv_pos, q_pos)


def time_variants(names: list[str], others: list[Path]) -> int:
    """Build ``names`` of ``VARIANTS`` and the sources ``others`` at once
    and time each at the serve shapes of the bf16 prefill and decode, in
    turns, by profiler device time per call."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    b, s, h, t = 8, 2048, 128, 2112
    print(f"card: {smi.stdout.strip()}; bf16 latent prefill B {b} S = T {s} "
          f"H {h}, device ms per call over 5 calls; bf16 latent decode B "
          f"{b} T {t} H {h}, over 50 calls", flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        sources = {name: _variant_source(name)
                   for name in ["base", *(n for n in names if n != "base")]}
        # another source includes the wgmma.cuh beside it, where there is
        # one (another tree's header may differ from this one's)
        includes = {}
        for path in others:
            sources[f"{path.parent.name}/{path.stem}"] = path.read_text()
            includes[f"{path.parent.name}/{path.stem}"] = path.parent
        procs = {}
        for name, src in sources.items():
            stem = name.replace("/", "-")
            cu, so = Path(tmp) / f"{stem}.cu", Path(tmp) / f"{stem}.so"
            cu.write_text(src)
            first = ["-I", str(includes[name])] if name in includes else []
            procs[name] = so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *first, "-I",
                 str(_build.CSRC), str(cu), "-o", str(so)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        libs = {}
        for name, (so, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{err}")
            lines = [x for x in ptxas_lines("== mla_attention.cu\n" + out
                                            + err) if "wgmma" in x]
            lines += [x.strip() for x in (out + err).splitlines()
                      if "warning" in x.lower()]
            print(f"{name} ptxas: " + "; ".join(lines), flush=True)
            lib = ctypes.CDLL(str(so))
            for entry in ("flash_attention_latent_launch",
                          "decode_attention_latent_launch"):
                getattr(lib, entry).argtypes, getattr(lib, entry).restype = \
                    _build._SIGNATURES[entry]
            # a source from before the forward could store lse takes no
            # lse pointer
            lib.takes_lse = "void* lse, int B" in sources[name]
            if not lib.takes_lse:
                lib.flash_attention_latent_launch.argtypes = \
                    lib.flash_attention_latent_launch.argtypes[:5] + \
                    lib.flash_attention_latent_launch.argtypes[6:]
            libs[name] = lib
        gen = torch.Generator(device=dev).manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        index = dev.index or 0
        pre = [torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, s, h, 512), (b, s, h, 64), (b, s, 512),
                             (b, s, 64))]
        pre_out = torch.empty_like(pre[0])
        dec = _decode_inputs(dev, gen, b, t, h, torch.bfloat16)
        dec_out = torch.empty_like(dec[0])
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ns, per = latent_split_plan(b, h, t, sms,
                                    LATENT_TILE_KEYS[torch.bfloat16])
        part = torch.empty((b, h, ns, 516), dtype=torch.float32, device=dev)

        def prefill(lib):
            lse = (None,) if lib.takes_lse else ()
            err = lib.flash_attention_latent_launch(
                *(a.data_ptr() for a in pre), pre_out.data_ptr(), *lse, b, s,
                s, h, 512, 64, SCALE, 1, index, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        def decode(lib):
            err = lib.decode_attention_latent_launch(
                *(a.data_ptr() for a in dec), part.data_ptr(),
                dec_out.data_ptr(), b, t, h, 512, 64, ns, per, SCALE, 1,
                index, stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")

        runs = {"prefill": (prefill, pre_out, 5, flash_attention_latent_plain(
                    *pre, scale=SCALE)),
                "decode": (decode, dec_out, 50, decode_attention_latent_plain(
                    *dec, scale=SCALE))}
        for kind, (call, out, _, want) in runs.items():
            for name in ["base", *(n for n in libs if n not in VARIANTS)]:
                call(libs[name])
                torch.cuda.synchronize()
                # another source: are its outputs base's, bit for bit?
                same = ("" if name == "base" else
                        f" bits_equal_base={torch.equal(out, base_out)}")
                print(f"{kind} {name} {_diff(out, want)}{same}", flush=True)
                if name == "base":
                    base_out = out.clone()
        for kind, (call, _, n, _) in runs.items():
            times = {name: [] for name in libs}
            for name in [*libs, *reversed(libs)]:
                times[name].append(_device_ms(lambda: call(libs[name]), n))
            # decode: each turn's whole call, its merge launch in brackets
            print(f"{kind} (splits {ns} of {per} slots; merge in brackets) "
                  if kind == "decode" else f"{kind} ", end="")
            print(" ".join(
                f"{name}=" + "/".join(
                    f"{t:.4f}" + (f" ({m:.4f})" if kind == "decode" else "")
                    for t, m in ts)
                for name, ts in times.items()), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_attention_probe: CUDA is not available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=None,
                    help=f"time these of {list(VARIANTS)} beside base (all "
                         f"if none)")
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="with --variants: another mla_attention.cu to "
                         "build, check and time (repeatable)")
    opts = ap.parse_args()
    if opts.variants is not None:
        return time_variants(opts.variants or list(VARIANTS), opts.other)
    t0 = time.time()
    _build.lib()
    print(f"build_s {time.time() - t0:.1f}", flush=True)
    for line in ptxas_lines(_build.BUILD_INFO.get("ptxas", "")):
        print(line, flush=True)
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
                line += f" ms={ms:.3f} tflops={flops / ms / 1e9:.1f}"
            print(line, flush=True)
            del args, got, want
        for b, t, h in DECODE:
            args = _decode_inputs(dev, gen, b, t, h, dtype)
            got = decode_attention_latent(*args, scale=SCALE)
            want = decode_attention_latent_plain(*args, scale=SCALE)
            torch.cuda.synchronize()
            ms = _event_ms(lambda: decode_attention_latent(
                *args, scale=SCALE), 20)
            print(f"decode {dtype} B{b} T{t} H{h} {_diff(got, want)} "
                  f"ms={ms:.4f}", flush=True)
    print("launches", flash_attention_latent.launches,
          flash_attention_latent.instance_launches,
          decode_attention_latent.launches,
          decode_attention_latent.instance_launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the lockstep_peel CUDA kernel goes.

    python3 tools/lockstep_peel_probe.py

Runs the kernel as built (``src/repro_torch/csrc/lockstep_peel.cu``) on
cells built to separate its costs, all at G 1 (one pair: the launch is as
long as its one pair's chain):

* ``no-rounds``: every edge weighs 0, so the loop never starts: the launch,
  the staging and the initial degrees alone;
* ``rounds-only``: edges without pins, weight 1: U - 4 rounds in which no
  edge dies, the round itself;
* ``path``: a random cell like LMBR's (every edge holds 1..4 of the valid
  slots): rounds plus each edge dying once;
* ``path-padded``: the same cell with K padded by empty, weightless rows:
  the same rounds and dying edges, more staging;
* ``-unpacked``: weights whose total passes 2^21, so that the argmin takes
  two reductions instead of one packed key.

Prints the profiler's device us per call, the rounds and the edges that
die, and the card's clocks after the runs.  Then builds a copy of the
source with ``clock64()`` reads patched into the warp class (the source
text is patched in a temporary copy) and prints, per case, the cycles of
the set-up (staging and initial degrees) and of the round loop, split into
the argmin, the dying-edge words and the degree update, as built and with
one part of the round cut out; the patched kernel writes them over the
last trajectory slots, so a case is read only when its rounds stay below
U - 2.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import _device_ms, _peel_inputs  # noqa: E402
from repro_torch import _build  # noqa: E402  (nvcc and its flags)
from repro_torch.kernels.lockstep_peel.ops import (  # noqa: E402
    lockstep_peel, lockstep_peel_plain)

SOURCE = _build.CSRC / "lockstep_peel.cu"
# (old, new) text of the warp-class kernel: clock64() at the start, before
# the round loop, and around the round's argmin and dying-edge words; the
# sums go over trajectory slots U - 1 and U - 2 (as floats)
CLOCKS = [
    ("  extern __shared__ unsigned smem[];\n  const int tid = threadIdx.x;",
     "  extern __shared__ unsigned smem[];\n  const long long c0 = clock64();"
     "\n  long long ca = 0, cd = 0, cu = 0;\n  const int tid = threadIdx.x;"),
    ("  int nal = nv;\n  int r = 0;\n  for (; r < U; ++r) {\n"
     "    if (!(ben > 0.5f && nal > 0)) break;  // uniform: every lane, same "
     "values\n",
     "  int nal = nv;\n  int r = 0;\n  const long long c1 = clock64();\n"
     "  for (; r < U; ++r) {\n    const long long c2 = clock64();\n"
     "    if (!(ben > 0.5f && nal > 0)) break;  // uniform: every lane, same "
     "values\n"),
    ("    // the alive edges that hold j die: every lane walks",
     "    const long long c3 = clock64();\n    ca += c3 - c2;\n"
     "    // the alive edges that hold j die: every lane walks"),
    ("#pragma unroll\n    for (int i = 0; i < NU; ++i) {\n"
     "      deg[i] = (lane + 32 * i == j) ? gone : deg[i] - sub[i];\n"
     "    }\n",
     "    const long long c4 = clock64();\n    cd += c4 - c3;\n"
     "#pragma unroll\n    for (int i = 0; i < NU; ++i) {\n"
     "      deg[i] = (lane + 32 * i == j) ? gone : deg[i] - sub[i];\n"
     "    }\n"),
    ("    ben -= drop;\n    nal -= 1;\n  }\n",
     "    ben -= drop;\n    nal -= 1;\n    cu += clock64() - c4;\n  }\n"
     "  const long long c5 = clock64();\n"),
    ("    cb += __shfl_sync(kFull, sd, 31);\n"
     "    ct += __shfl_sync(kFull, sn, 31);\n  }\n}\n",
     "    cb += __shfl_sync(kFull, sd, 31);\n"
     "    ct += __shfl_sync(kFull, sn, 31);\n  }\n"
     "  if (lane == 0) {\n    tg[U - 1] = (float)(c1 - c0);\n"
     "    bg[U - 1] = (float)(c5 - c1);\n    tg[U - 2] = (float)ca;\n"
     "    bg[U - 2] = (float)cd;\n    pg[U - 2] = (int)cu;\n  }\n}\n"),
]


def _cases(dev):
    rng = np.random.default_rng(0)
    out = {}
    for K, U in ((128, 64), (1024, 64)):
        inc, we, nodew, nv = _peel_inputs(np, torch, rng, 1, K, U, dev)
        out[f"no-rounds.K{K}.U{U}"] = (inc, torch.zeros_like(we), nodew, nv)
        out[f"rounds-only.K{K}.U{U}"] = (torch.zeros_like(inc),
                                         torch.ones_like(we), nodew,
                                         torch.full_like(nv, U - 4))
        out[f"path.K{K}.U{U}"] = (inc, we, nodew, nv)
    # weights of 2^16: the total (2^23) is past the packed argmin's 2^21
    out["rounds-only-unpacked.K128.U64"] = (
        torch.zeros((1, 128, 64), device=dev),
        torch.full((1, 128), 65536.0, device=dev), nodew,
        torch.full_like(nv, 60))
    inc, we, nodew, nv = out["path.K128.U64"]
    out["path-unpacked.K128.U64"] = (inc, we * 16384.0, nodew, nv)
    inc, we, nodew, nv = out["path.K128.U64"]
    pad = torch.zeros((1, 1024, 64), device=dev)
    pad[:, :128] = inc
    wpad = torch.zeros((1, 1024), device=dev)
    wpad[:, :128] = we
    out["path-padded.K1024.U64"] = (pad, wpad, nodew, nv)
    return out


# parts of the round cut out on top of CLOCKS (the trajectory is then wrong:
# only the cycles are read)
CUTS = {
    "as-built": [],
    "no-walk": [("      while (d) {\n        const int b1",
                 "      while (false) {\n        const int b1")],
}


def _clock_lib(tmp: str, cut: str):
    src = SOURCE.read_text()
    for old, new in CLOCKS + CUTS[cut]:
        if old not in src:
            raise SystemExit(f"clock patch: source text not found:\n{old}")
        src = src.replace(old, new)
    cu, so = Path(tmp) / f"{cut}.cu", Path(tmp) / f"{cut}.so"
    cu.write_text(src)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          str(cu), "-o", str(so)], capture_output=True,
                         text=True)
    if res.returncode:
        raise SystemExit(f"clock patch: nvcc failed\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).lockstep_peel_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _clocks(fn, label, args):
    inc, we, nodew, nv = args
    G, K, U = inc.shape
    peel = torch.empty((G, U), dtype=torch.int32, device=inc.device)
    rtot, rben = torch.empty((G, U), device=inc.device), torch.empty(
        (G, U), device=inc.device)
    err = fn(inc.data_ptr(), we.data_ptr(), nodew.data_ptr(), nv.data_ptr(),
             peel.data_ptr(), rtot.data_ptr(), rben.data_ptr(), None, G, K, U,
             inc.device.index or 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{label}: CUDA error {err}")
    torch.cuda.synchronize()
    rounds = int((peel[0, :U - 2] >= 0).sum())
    if rounds >= U - 2:
        print(f"{label}: cycles not read ({rounds} rounds, U {U})")
        return
    setup, loop = float(rtot[0, U - 1]), float(rben[0, U - 1])
    arg, dying, upd = (float(rtot[0, U - 2]), float(rben[0, U - 2]),
                       float(peel[0, U - 2]))
    per = max(rounds, 1)
    print(f"{label}: setup_cycles={setup:.0f} loop_cycles={loop:.0f} "
          f"per_round={loop / per:.1f} (argmin {arg / per:.1f}, dying "
          f"{dying / per:.1f}, update {upd / per:.1f})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("lockstep_peel_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cases = _cases(dev)
    for label, args in cases.items():
        got = lockstep_peel(*args)
        want = lockstep_peel_plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{label}: kernel differs from plain")
        rounds = int((want[0] >= 0).sum())
        inc, we = args[0], args[1]
        dying = int(((inc > 0.5).any(dim=2) & (we != 0)).sum())
        us = 1e3 * _device_ms(torch, lambda: lockstep_peel(*args), 50)
        print(f"{label}: device_us={us:.3f} rounds={rounds} "
              f"dying_edges={dying}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        for cut in CUTS:
            fn = _clock_lib(tmp, cut)
            for label, args in cases.items():
                if "K1024" not in label:
                    _clocks(fn, f"{cut} {label}", args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

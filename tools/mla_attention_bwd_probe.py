#!/usr/bin/env python3
"""Build, check and time the latent (MLA) attention backward's CUDA kernel.

    python3 tools/mla_attention_bwd_probe.py                 # every shape
    python3 tools/mla_attention_bwd_probe.py --shapes small-H,ragged

Builds the package's kernels (``src/repro_torch/csrc``), prints the ptxas
registers and spills of the latent kernels, then runs chip_smoke.py's
kernels rows of the backward (``_latent_bwd_rows`` at ``MLA_BWD``'s
labels: checks against the plain version, lse, wrong variants, bit
identity, autograd route; kernel, per-pass device, plain and SDPA times)
and prints each row as JSON, with the instance that ran (bf16 ``wgmma``,
its passes delta, q_wgmma, kv_wgmma, reduce; f32 ``fma``, delta, q, kv,
reduce).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv: list[str]) -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(r[0] for r in cs.MLA_BWD))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mla_attention_bwd_probe: CUDA is not available",
              file=sys.stderr)
        return 2
    from repro_torch import _build

    _build.build(force=True)
    for e in cs._ptxas_entries(_build.BUILD_INFO["ptxas"]):
        if "mla_" in e["entry"]:
            print(f"  {e['entry'][:70]} registers={e['registers']} "
                  f"spills={e['spill_stores']}/{e['spill_loads']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    for row in cs._latent_bwd_rows(torch, torch.device("cuda"),
                                   args.shapes.split(",")):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

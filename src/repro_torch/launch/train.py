"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 100 --reduced --batch 8 --seq 128 [--device cpu]

The reference's trainer (``repro.launch.train``) with the same CLI plus
``--device`` (default "cuda"; raises without CUDA unless "cpu" is given).
``--reduced`` trains the smoke-sized variant of the architecture in f32;
without it, the published config in its dtype (olmo-1b: 16 layers,
d_model 2048, bf16).  It runs the whole substrate: the placement-aware
input pipeline, the fault-tolerant runner with checkpoint / restart and
straggler avoidance, AdamW at ``--lr``, the MoE identity dispatch.
Weights are random, from the port's ``init_params`` with seed 0.

It prints the reference's lines (``steps=... restarts=...``, ``loss:
first5=... last5=... (improved|NOT improved)``, ``event@<step>: ...``) and
exits 0 when the mean loss of the last five steps is below the first
five's, else 1.  ``--devices`` and ``--mesh`` (a host-device mesh) wait
for the mesh, ROADMAP Queue 1 item 9.6: given, they raise.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-sized config (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--devices", type=int, default=0,
                    help="virtual host devices (needs the mesh)")
    ap.add_argument("--mesh", type=str, default="",
                    help="'DxM' data x model (needs the mesh)")
    ap.add_argument("--ckpt-dir", type=str,
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--num-shards", type=int, default=64)
    ap.add_argument("--num-hosts", type=int, default=8)
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.devices or args.mesh:
        raise NotImplementedError(
            "--devices and --mesh need the port's mesh, ROADMAP Queue 1 "
            "item 9.6")

    import numpy as np
    import torch

    from .. import device as device_mod
    from ..checkpoint import CheckpointManager
    from ..configs import get_config, reduce_config
    from ..data import PlacementAwarePipeline
    from ..models import identity_dispatch, init_params
    from ..optim import make_optimizer
    from ..runtime import FaultTolerantRunner
    from .steps import make_train_step

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg, dtype="float32")

    dispatch = identity_dispatch(cfg.moe.num_experts, 1) if cfg.moe else None
    opt = make_optimizer("adamw", args.lr)
    step_fn, _ = make_train_step(cfg, optimizer=opt, moe_dispatch=dispatch)
    params = init_params(cfg, seed=0, device=dev, moe_dispatch=dispatch)
    opt_state = opt.init(params)

    pipeline = PlacementAwarePipeline(
        num_shards=args.num_shards, num_hosts=args.num_hosts,
        vocab_size=cfg.vocab_size, batch_size=args.batch, seq_len=args.seq,
        device=dev,
    )
    ckpt = CheckpointManager(args.ckpt_dir, keep=2, async_save=True,
                             device=dev)

    metrics_log = []

    def run_step(state, batch):
        p, o = state
        dev_batch = {
            "tokens": torch.from_numpy(batch["tokens"]).to(dev),
            "targets": torch.from_numpy(batch["targets"]).to(dev),
        }
        if cfg.frontend:
            dev_batch["frontend"] = torch.zeros(
                (args.batch, cfg.frontend_len, cfg.d_model),
                dtype=torch.float32, device=dev)
        p, o, metrics = step_fn(p, o, dev_batch)
        metrics_log.append(float(metrics["loss"]))
        return (p, o), metrics

    runner = FaultTolerantRunner(
        run_step, (params, opt_state), pipeline, ckpt,
        ckpt_every=args.ckpt_every,
    )
    del params, opt_state
    if args.inject_failures:
        runner.kill_input_host(0)

    t0 = time.time()
    result = runner.run(args.steps)
    dt = time.time() - t0
    first = np.mean(metrics_log[:5]) if metrics_log else float("nan")
    last = np.mean(metrics_log[-5:]) if metrics_log else float("nan")
    print(f"steps={result['steps']} restarts={result['restarts']} "
          f"avg_input_span={result['avg_input_span']:.2f} "
          f"idle_hosts={pipeline.idle_host_fraction():.2f}")
    print(f"loss: first5={first:.4f} last5={last:.4f} "
          f"({'improved' if last < first else 'NOT improved'}) "
          f"wall={dt:.1f}s")
    for step, ev in result["events"][:10]:
        print(f"  event@{step}: {ev}")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())

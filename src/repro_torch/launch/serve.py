"""Batched serving driver: prefill, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
        --requests 16 --batch 8 --prefill-len 2048 --decode-len 64

``--arch`` takes the ported architectures: hymba-1.5b (hybrid), the
dense-GQA glm4-9b, olmo-1b, h2o-danube-1.8b and nemotron-4-15b, and the
pure-SSM mamba2-2.7b (whose cache holds only the SSM state).  The
reference driver (``repro.launch.serve``) with the same CLI plus
``--device`` (default "cuda"; raises without CUDA unless "cpu" is given):
random prompts from ``numpy.random.default_rng(seed)``, one prefill per
batch of requests into a cache of ``prefill_len + decode_len`` slots,
then ``decode_len`` greedy (argmax) steps; the last logits of every batch
must be finite.  Weights are random, from the port's ``init_params`` with
a seeded generator.  Prints tokens per second with the device's name.
The MoE expert-placement refit of the reference waits with MoE (ROADMAP
Queue 1 item 9.2).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import device as device_mod
from ..configs import get_config, list_configs, reduce_config
from ..models import decode_step, init_params, prefill

__all__ = ["load_model", "serve", "main"]


def load_model(arch: str, *, reduced: bool = False, device=None,
               seed: int = 0, **overrides):
    """(cfg, params) of ``arch``: published widths, or the reference's
    smoke-test reduction in float32 with ``reduced``; ``overrides`` replace
    config fields after that."""
    dev = device_mod.resolve(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduce_config(cfg, dtype="float32", **overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, init_params(cfg, seed=seed, device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg, params, *, requests: int = 16, prefill_len: int = 64,
          decode_len: int = 32, batch: int = 8, seed: int = 0) -> dict:
    """Serve ``requests`` random prompts in batches of ``batch``.  Returns
    the counts and times (prefill and decode seconds, summed over batches)
    and the last batch's final logits and generated tokens."""
    dev = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    max_len = prefill_len + decode_len
    batches = -(-requests // batch)
    prefill_s = decode_s = 0.0
    done_tokens = 0
    logits = generated = None
    for _ in range(batches):
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, prefill_len))).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(cfg, params, {"tokens": tokens},
                                max_len=max_len)
        tok = logits.argmax(-1)[:, None]
        _sync(dev)
        t1 = time.perf_counter()
        out = []
        for t in range(decode_len):
            pos = torch.full((batch, 1), prefill_len + t, dtype=torch.int32,
                             device=dev)
            logits, cache = decode_step(cfg, params, cache, tok, pos)
            tok = logits.argmax(-1)[:, None]
            out.append(tok)
            done_tokens += batch
        _sync(dev)
        t2 = time.perf_counter()
        prefill_s += t1 - t0
        decode_s += t2 - t1
        if not bool(torch.isfinite(logits).all()):
            raise FloatingPointError("non-finite logits while serving")
        generated = torch.cat(out, dim=1) if out else None
    return dict(requests=requests, batches=batches, batch=batch,
                prefill_len=prefill_len, decode_len=decode_len,
                prefill_tokens=batches * batch * prefill_len,
                decode_tokens=done_tokens, prefill_s=prefill_s,
                decode_s=decode_s, logits=logits, generated=generated)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prefill-len", type=int, default=64)
    ap.add_argument("--decode-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg, params = load_model(args.arch, reduced=args.reduced, device=dev)
    res = serve(cfg, params, requests=args.requests,
                prefill_len=args.prefill_len, decode_len=args.decode_len,
                batch=args.batch)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    total = res["prefill_s"] + res["decode_s"]
    print(f"served {args.requests} requests, {res['decode_tokens']} tokens "
          f"in {total:.1f}s ({res['decode_tokens'] / total:.1f} tok/s on "
          f"{name}); prefill {res['prefill_tokens'] / res['prefill_s']:.1f} "
          f"tok/s, decode "
          f"{res['decode_s'] * 1e3 / (res['batches'] * args.decode_len):.2f} "
          "ms/step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Batched serving driver: prefill, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
        --requests 16 --batch 8 --prefill-len 2048 --decode-len 64

``--arch`` takes the ported architectures: hymba-1.5b (hybrid), the
dense-GQA glm4-9b, olmo-1b, h2o-danube-1.8b and nemotron-4-15b, the
pure-SSM mamba2-2.7b (whose cache holds only the SSM state) and the MoE
qwen3-moe-30b-a3b and deepseek-v3-671b (served with the identity expert
dispatch; deepseek-v3's attention is MLA, its cache the latent rows, and
at its published widths only a few layers fit one card:
``load_model("deepseek-v3-671b", num_layers=4)``), the encoder-decoder
seamless-m4t-medium and the VLM internvl2-2b.  The
reference driver (``repro.launch.serve``) with the same CLI plus
``--device`` (default "cuda"; raises without CUDA unless "cpu" is given):
random prompts from ``numpy.random.default_rng(seed)``, one prefill per
batch of requests into a cache of ``prefill_len + decode_len`` slots,
then ``decode_len`` greedy (argmax) steps; the last logits of every batch
must be finite.  Weights are random, from the port's ``init_params`` with
a seeded generator.  Prints tokens per second with the device's name.
A config with a frontend (seamless's audio frames, internvl2's image
patches; stubs in the reference too) gets ``(batch, frontend_len,
d_model)`` f32 embeddings with each batch, drawn standard normal from the
same generator right after the prompt.  The reference CLI feeds zeros
there, which ``serve`` does not copy: zero frames project to zeros, and
every LayerNorm and attention of seamless's encoder then gives zeros, so
the cross-attention would attend over nothing but zero keys and values.
A VLM's prompt must be at least ``frontend_len`` tokens long (its patches
replace the first ones).
After an MoE arch it prints the reference's expert-placement refit: LMBR
fitted to a synthetic routing trace (200 token groups, seed 1) on 4 EP
ranks of ``E // 4 + 2`` slots, its avg span against the contiguous
layout's (``expert_refit``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import device as device_mod
from ..configs import get_config, list_configs, reduce_config
from ..core import (baseline_contiguous_placement, plan_expert_placement,
                    synthetic_routing_trace)
from ..models import decode_step, init_params, prefill

__all__ = ["load_model", "serve", "expert_refit", "refit_line", "main"]

REFIT_RANKS = 4


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
    the counts and times (prefill and decode seconds, summed over batches),
    the last batch's final logits and generated tokens and, for an MoE
    arch (served with the identity expert dispatch), each batch's prefill
    ``drop_frac`` summed over the layers."""
    dev = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    max_len = prefill_len + decode_len
    batches = -(-requests // batch)
    prefill_s = decode_s = 0.0
    done_tokens = 0
    logits = generated = None
    drops = []
    for _ in range(batches):
        inputs = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, prefill_len))).to(dev)}
        if cfg.frontend:
            inputs["frontend"] = torch.from_numpy(rng.standard_normal(
                (batch, cfg.frontend_len, cfg.d_model),
                dtype=np.float32)).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache, aux = prefill(cfg, params, inputs, max_len=max_len,
                                     return_aux=True)
        if "drop_frac" in aux:
            drops.append(aux["drop_frac"])
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
                decode_s=decode_s, logits=logits, generated=generated,
                prefill_drop_frac=[float(t) for t in drops])


def expert_refit(cfg, device=None):
    """The reference serve CLI's serve-time refit of an MoE arch: LMBR on a
    synthetic routing trace (``cfg.moe.num_experts`` experts, 200 token
    groups of ``top_k``, seed 1) over ``REFIT_RANKS`` EP ranks of ``E //
    4 + 2`` slots, fitted on ``device``.  Returns (the contiguous layout's
    avg span, the plan's avg span, the plan)."""
    m = cfg.moe
    trace = synthetic_routing_trace(m.num_experts, 200, top_k=m.top_k,
                                    seed=1)
    slots = m.num_experts // REFIT_RANKS + 2
    plan = plan_expert_placement(trace, m.num_experts, REFIT_RANKS, slots,
                                 algorithm="lmbr", device=device)
    base = baseline_contiguous_placement(m.num_experts, REFIT_RANKS, slots)
    return base.avg_span(trace), plan.avg_span(trace), plan


def refit_line(base_span: float, plan_span: float) -> str:
    return (f"expert placement refit: span {base_span:.2f} -> "
            f"{plan_span:.2f} across {REFIT_RANKS} EP ranks")


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
    if cfg.moe:
        base_span, plan_span, _ = expert_refit(cfg, device=dev)
        print(refit_line(base_span, plan_span))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

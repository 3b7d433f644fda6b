"""GQA attention for forward, prefill and decode, on the hand-written
kernels.

Shapes: q (B, S, H, D); k / v (B, T, K, D) with H = K * G.  The hot paths
go through the kernel wrappers, which run the CUDA kernel on CUDA tensors
and the plain PyTorch version on CPU tensors:

* cache-free forward, and prefill into an empty cache (cursor 0,
  positions 0..S-1): ``flash_attention`` over the fresh k / v.  Attending
  over the whole cache, whose other slots are empty (position -1), is the
  same function;
* one-token decode with a cache: ``decode_attention`` over the cache.

Any other case (a prefill into a non-empty cache, positions other than
0..S-1 without a cache) raises; serving never makes one.  The kernels'
plain versions are the port's model-level oracle; the tests hold them
against the reference's ``chunked_attention``.  MLA is not ported
(ROADMAP Queue 1 item 9.3).
"""

from __future__ import annotations

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .layers import apply_rope, dense_init

__all__ = ["init_gqa", "gqa_qkv", "gqa_attention", "init_gqa_cache"]


# ------------------------------------------------------------------- GQA
def init_gqa(gen, cfg, dtype, device=None) -> dict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": dense_init(gen, (d, h * hd), dtype, device=device),
        "wk": dense_init(gen, (d, kv * hd), dtype, device=device),
        "wv": dense_init(gen, (d, kv * hd), dtype, device=device),
        "wo": dense_init(gen, (h * hd, d), dtype, device=device),
    }


def gqa_qkv(params, cfg, x, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kv, hd)
    v = (x @ params["wv"]).reshape(b, s, kv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _check_fresh_positions(positions: torch.Tensor) -> None:
    b, s = positions.shape
    want = torch.arange(s, dtype=positions.dtype, device=positions.device)
    if not torch.equal(positions, want.expand(b, s)):
        raise NotImplementedError(
            "a multi-token attention call must cover positions 0..S-1 "
            "(cache-free forward or prefill into an empty cache)")


def gqa_attention(params, cfg, x, positions, *, window=None,
                  kv_cache: dict | None = None):
    """Full GQA block.  kv_cache (serving): dict(k, v, pos, cursor) with
    cursor a Python int; the cache tensors are updated IN PLACE (the
    reference returns new arrays; in place saves a copy of the cache per
    layer and step) and the dict is returned with the new cursor."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(params, cfg, x, positions)
    new_cache = None
    if kv_cache is None:
        _check_fresh_positions(positions)
        out = flash_attention(q, k, v, causal=True, window=window)
    else:
        ck, cv, cpos, cursor = (kv_cache["k"], kv_cache["v"], kv_cache["pos"],
                                kv_cache["cursor"])
        t_max = ck.shape[1]
        if s == 1:
            idx = cursor % t_max
            ck[:, idx] = k[:, 0].to(ck.dtype)
            cv[:, idx] = v[:, 0].to(cv.dtype)
            cpos[:, idx] = positions[:, 0].to(cpos.dtype)
            qp = positions[:, 0].to(torch.int32).contiguous()
            out = decode_attention(q[:, 0], ck, cv, cpos, qp,
                                   window=window)[:, None]
        elif cursor == 0 and s <= t_max:
            _check_fresh_positions(positions)
            ck[:, :s] = k.to(ck.dtype)
            cv[:, :s] = v.to(cv.dtype)
            cpos[:, :s] = positions.to(cpos.dtype)
            out = flash_attention(q, k, v, causal=True, window=window)
        else:
            raise NotImplementedError(
                f"prefill of {s} tokens into a cache at cursor {cursor} "
                f"(length {t_max}): only a prefill into an empty cache that "
                "holds it, or one-token decode, is ported")
        new_cache = dict(k=ck, v=cv, pos=cpos, cursor=cursor + s)
    return out.reshape(b, s, -1) @ params["wo"], new_cache


def init_gqa_cache(cfg, batch, max_len, dtype, window=None,
                   device=None) -> dict:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    t = min(max_len, window) if window else max_len
    return dict(
        k=torch.zeros((batch, t, kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, t, kv, hd), dtype=dtype, device=device),
        pos=torch.full((batch, t), -1, dtype=torch.int32, device=device),
        cursor=0,
    )

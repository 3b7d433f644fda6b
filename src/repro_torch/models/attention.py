"""Attention for forward, prefill and decode, on the hand-written kernels:
GQA and multi-head latent attention (MLA).

GQA shapes: q (B, S, H, D); k / v (B, T, K, D) with H = K * G.  The hot
paths go through the kernel wrappers, which run the CUDA kernel on CUDA
tensors and the plain PyTorch version on CPU tensors:

* cache-free forward, and prefill into an empty cache (cursor 0,
  positions 0..S-1): ``flash_attention`` over the fresh k / v, causal
  (``causal=False`` for an encoder layer).  Attending over the whole
  cache, whose other slots are empty (position -1), is the same function;
* one-token decode with a cache: ``decode_attention`` over the cache;
* cross-attention of an encoder-decoder's decoder (``cross_kv``, the
  encoder states' k / v at positions 0..F-1, every one valid): q without
  rope, no cache write, nothing masked (the reference's ``causal=False``).
  Several tokens (forward, prefill) run ``flash_attention(causal=False)``
  at S != T; one token (decode) runs ``decode_attention`` with the query
  at the last encoder position, so that every frame is visible whatever
  the decoder's position.

MLA runs the reference's absorbed formulation (``FLAGS["mla_decomp"]``
off, its default): latent queries ``[q_nope W_kb ; q_rope]`` against the
latent cache ``[c_kv ; k_rope]``, ``c_kv`` as the value, scale
``(qk_nope + qk_rope) ** -0.5``, the weighted latent through ``W_vb`` and
``wo``; its prefill runs ``flash_attention_latent`` over the fresh latent
rows and its one-token decode ``decode_attention_latent`` over the cache,
the same cases as GQA's.  The decompressed formulation that the flag
selects for prefill is not ported (ROADMAP Queue 1).

Any other case (a prefill into a non-empty cache, positions other than
0..S-1 without a cache) raises; serving never makes one.  The kernels'
plain versions are the port's model-level oracle; the tests hold them
against the reference's ``chunked_attention``.
"""

from __future__ import annotations

import torch

from ..kernels.decode_attention.ops import (decode_attention,
                                            decode_attention_latent)
from ..kernels.flash_attention.ops import (flash_attention,
                                           flash_attention_latent)
from .layers import apply_norm, apply_rope, dense_init

__all__ = ["init_gqa", "gqa_qkv", "gqa_attention", "init_gqa_cache",
           "init_mla", "mla_attention", "init_mla_cache"]


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


def _cross_attention(params, cfg, x, cross_kv):
    """Non-causal attention of x's queries (no rope) over the encoder's
    ``cross_kv = (k, v, kv_pos)``; the decoder's positions play no part."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)
    k, v, kv_pos = cross_kv
    if s == 1:
        # the query at the last encoder position sees every frame
        return decode_attention(q[:, 0], k, v, kv_pos,
                                kv_pos.amax(dim=1))[:, None]
    return flash_attention(q, k, v, causal=False)


def gqa_attention(params, cfg, x, positions, *, window=None, causal=True,
                  kv_cache: dict | None = None, cross_kv=None):
    """Full GQA block.  kv_cache (serving): dict(k, v, pos, cursor) with
    cursor a Python int; the cache tensors are updated IN PLACE (the
    reference returns new arrays; in place saves a copy of the cache per
    layer and step) and the dict is returned with the new cursor.
    ``causal`` applies to the cache-free path (False in an encoder layer).
    cross_kv: the encoder's precomputed (k, v, kv_positions) for
    cross-attention, which reads no cache and writes none."""
    b, s, _ = x.shape
    if cross_kv is not None:
        out = _cross_attention(params, cfg, x, cross_kv)
        return out.reshape(b, s, -1) @ params["wo"], None
    q, k, v = gqa_qkv(params, cfg, x, positions)
    new_cache = None
    if kv_cache is None:
        _check_fresh_positions(positions)
        out = flash_attention(q, k, v, causal=causal, window=window)
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


# ------------------------------------------------------------------- MLA
def init_mla(gen, cfg, dtype, device=None) -> dict:
    m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), dtype, device=device),
        "q_norm": {"scale": torch.ones((m.q_lora_rank,), dtype=dtype,
                                       device=device)},
        "wq_b": dense_init(gen, (m.q_lora_rank, h * qk_hd), dtype,
                           device=device),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype, device=device),
        "kv_norm": {"scale": torch.ones((m.kv_lora_rank,), dtype=dtype,
                                        device=device)},
        "wk_b": dense_init(gen, (m.kv_lora_rank, h * m.qk_nope_head_dim),
                           dtype, device=device),
        "wv_b": dense_init(gen, (m.kv_lora_rank, h * m.v_head_dim), dtype,
                           device=device),
        "wo": dense_init(gen, (h * m.v_head_dim, d), dtype, device=device),
    }


def _mla_q(params, cfg, x, positions):
    """(q_nope (B, S, H, qk_nope), q_rope (B, S, H, qk_rope), roped)."""
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    cq = apply_norm("rmsnorm", params["q_norm"], x @ params["wq_a"])
    q = (cq @ params["wq_b"]).reshape(
        b, s, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(params, cfg, x, positions):
    """(c_kv (B, S, R), k_rope (B, S, qk_rope), roped): one latent row a
    position, shared by every head."""
    r = cfg.mla.kv_lora_rank
    kv = x @ params["wkv_a"]
    c_kv = apply_norm("rmsnorm", params["kv_norm"], kv[..., :r])
    k_rope = apply_rope(kv[..., r:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_attention(params, cfg, x, positions, *, kv_cache: dict | None = None):
    """The absorbed MLA block.  kv_cache (serving): dict(c_kv, k_rope, pos,
    cursor) with cursor a Python int; the cache tensors are updated IN
    PLACE, as GQA's, and the dict is returned with the new cursor.  The
    cache holds no ring: a write past its last slot raises (the
    reference's ``dynamic_update_slice`` would clamp it onto the last
    slots)."""
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(params, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(params, cfg, x, positions)
    wkb = params["wk_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wkb).contiguous()
    q_rope = q_rope.contiguous()
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    new_cache = None
    if kv_cache is None:
        _check_fresh_positions(positions)
        lat = flash_attention_latent(q_lat, q_rope, c_kv.contiguous(),
                                     k_rope.contiguous(), scale=scale)
    else:
        cc, cr, cpos, cursor = (kv_cache["c_kv"], kv_cache["k_rope"],
                                kv_cache["pos"], kv_cache["cursor"])
        t_max = cc.shape[1]
        if cursor + s > t_max:
            raise ValueError(
                f"writing {s} tokens at cursor {cursor} overruns the MLA "
                f"cache of {t_max} slots (it holds no ring)")
        if s == 1:
            cc[:, cursor] = c_kv[:, 0].to(cc.dtype)
            cr[:, cursor] = k_rope[:, 0].to(cr.dtype)
            cpos[:, cursor] = positions[:, 0].to(cpos.dtype)
            qp = positions[:, 0].to(torch.int32).contiguous()
            lat = decode_attention_latent(q_lat[:, 0], q_rope[:, 0], cc, cr,
                                          cpos, qp, scale=scale)[:, None]
        elif cursor == 0:
            _check_fresh_positions(positions)
            cc[:, :s] = c_kv.to(cc.dtype)
            cr[:, :s] = k_rope.to(cr.dtype)
            cpos[:, :s] = positions.to(cpos.dtype)
            lat = flash_attention_latent(q_lat, q_rope, c_kv.contiguous(),
                                         k_rope.contiguous(), scale=scale)
        else:
            raise NotImplementedError(
                f"prefill of {s} tokens into an MLA cache at cursor "
                f"{cursor}: only a prefill into an empty cache, or "
                "one-token decode, is ported")
        new_cache = dict(c_kv=cc, k_rope=cr, pos=cpos, cursor=cursor + s)
    wvb = params["wv_b"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", lat, wvb).reshape(b, s, -1)
    return out.to(x.dtype) @ params["wo"], new_cache


def init_mla_cache(cfg, batch, max_len, dtype, device=None) -> dict:
    m = cfg.mla
    return dict(
        c_kv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                           device=device),
        pos=torch.full((batch, max_len), -1, dtype=torch.int32,
                       device=device),
        cursor=0,
    )

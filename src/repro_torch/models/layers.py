"""Shared layer primitives: norms, MLPs, embeddings, RoPE.

Parameters are nested dicts of tensors, as in the reference
(``models/layers.py``); every layer is an (init, apply) pair.  Norm, RoPE
and unembedding math runs in fp32 whatever the activation dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "init_norm", "apply_norm", "init_mlp", "apply_mlp",
           "init_embed", "embed_lookup", "unembed", "apply_rope"]


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    ``scale / sqrt(fan_in)`` (the reference's ``dense_init``)."""
    fan_in = shape[0] if len(shape) > 1 else 1
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (scale / math.sqrt(fan_in))).to(dtype)


# ------------------------------------------------------------------- norms
def init_norm(kind: str, d: int, dtype, device=None) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    raise NotImplementedError(
        f"norm {kind!r}: only rmsnorm is ported (ROADMAP Queue 1 item 12)")


def apply_norm(kind: str, params: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r}: only rmsnorm is ported (ROADMAP Queue 1 item 12)")
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


# -------------------------------------------------------------------- MLPs
def init_mlp(gen, kind: str, d: int, ff: int, dtype, device=None) -> dict:
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp {kind!r}: only swiglu is ported (ROADMAP Queue 1 item 12)")
    return {
        "wi_gate": dense_init(gen, (d, ff), dtype, device=device),
        "wi_up": dense_init(gen, (d, ff), dtype, device=device),
        "wo": dense_init(gen, (ff, d), dtype, device=device),
    }


def apply_mlp(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind != "swiglu":
        raise NotImplementedError(
            f"mlp {kind!r}: only swiglu is ported (ROADMAP Queue 1 item 12)")
    h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    return h @ params["wo"]


# -------------------------------------------------------------- embeddings
def init_embed(gen, vocab: int, d: int, dtype, device=None) -> dict:
    return {"table": dense_init(gen, (vocab, d), dtype, scale=1.0,
                                device=device)}


def embed_lookup(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32."""
    return x.float() @ params["table"].float().T


# -------------------------------------------------------------------- RoPE
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, heads, head_dim); positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[..., None] * freqs             # (B, S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

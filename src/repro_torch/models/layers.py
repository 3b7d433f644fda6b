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
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparametric_ln":
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, params: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    if kind not in ("layernorm", "nonparametric_ln"):
        raise ValueError(kind)
    # layernorm family: centre and scale by the population variance (the
    # reference's jnp.var; torch.var would divide by n - 1)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    # nonparametric_ln (olmo): no affine parameters
    return y.to(x.dtype)


# -------------------------------------------------------------------- MLPs
def init_mlp(gen, kind: str, d: int, ff: int, dtype, device=None) -> dict:
    if kind == "swiglu":
        return {
            "wi_gate": dense_init(gen, (d, ff), dtype, device=device),
            "wi_up": dense_init(gen, (d, ff), dtype, device=device),
            "wo": dense_init(gen, (ff, d), dtype, device=device),
        }
    # non-gated: squared_relu (nemotron) / gelu (seamless)
    return {
        "wi": dense_init(gen, (d, ff), dtype, device=device),
        "wo": dense_init(gen, (ff, d), dtype, device=device),
    }


def apply_mlp(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    else:
        h = x @ params["wi"]
        if kind == "squared_relu":
            h = torch.square(F.relu(h))
        elif kind == "gelu":
            # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(h, approximate="tanh")
        else:
            raise ValueError(kind)
    return h @ params["wo"]


# -------------------------------------------------------------- embeddings
def init_embed(gen, vocab: int, d: int, dtype, device=None) -> dict:
    return {"table": dense_init(gen, (vocab, d), dtype, scale=1.0,
                                device=device)}


def embed_lookup(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]


UNEMBED_ROWS = 16384   # vocabulary rows widened to fp32 at a time


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32: x and the table widened to fp32, as the reference
    does.  The table is widened ``UNEMBED_ROWS`` rows at a time into the
    output's columns, so a call holds at most that many fp32 rows of it
    (a whole fp32 copy is 2.5 GB at glm4-9b's vocabulary and 6.3 GB at
    nemotron-4-15b's)."""
    table = params["table"]
    xf = x.float()
    out = torch.empty(x.shape[:-1] + (table.shape[0],), dtype=torch.float32,
                      device=x.device)
    x2, o2 = xf.reshape(-1, xf.shape[-1]), out.view(-1, table.shape[0])
    for r0 in range(0, table.shape[0], UNEMBED_ROWS):
        rows = table[r0:r0 + UNEMBED_ROWS].float()
        o2[:, r0:r0 + rows.shape[0]] = x2 @ rows.T
    return out


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

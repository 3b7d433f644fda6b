"""Mamba2 block: state-space duality (SSD), on the hand-written scan kernel.

Block structure follows the reference (``models/ssm.py``): fused in_proj
-> (z, x, B, C, dt), short causal conv on (x, B, C), SSD core over heads,
gated RMSNorm, out_proj.  A multi-token call (forward, prefill) runs the
SSD core through ``ssd_scan`` (the CUDA kernel on CUDA tensors, the plain
chunked scan on CPU tensors) from the cache's state; one-token decode runs
the one-step recurrence as torch ops, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_scan
from .layers import apply_norm, dense_init

__all__ = ["init_mamba2", "apply_mamba2", "init_ssm_cache"]


def _ssm_dims(cfg):
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nh = s.num_heads or d_in // s.head_dim
    return s, d_in, nh


def init_mamba2(gen, cfg, dtype, device=None) -> dict:
    s, d_in, nh = _ssm_dims(cfg)
    d_conv = d_in + 2 * s.state_dim   # conv over x, B, C
    f32 = torch.float32
    return {
        # in_proj -> [z (d_in), x (d_in), B (state), C (state), dt (nh)]
        "w_in": dense_init(gen, (cfg.d_model,
                                 2 * d_in + 2 * s.state_dim + nh), dtype,
                           device=device),
        "conv_w": dense_init(gen, (s.conv_width, d_conv), dtype,
                             device=device),
        "conv_b": torch.zeros((d_conv,), dtype=dtype, device=device),
        "a_log": torch.zeros((nh,), dtype=f32, device=device),  # A=-exp(.)
        "dt_bias": torch.full((nh,), -2.0, dtype=f32, device=device),
        "d_skip": torch.ones((nh,), dtype=f32, device=device),
        "gate_norm": {"scale": torch.ones((d_in,), dtype=dtype,
                                          device=device)},
        "w_out": dense_init(gen, (d_in, cfg.d_model), dtype, device=device),
    }


def _causal_conv(x, w, b, state=None):
    """x: (B, S, C); w: (W, C) depthwise; state: (B, W-1, C) carried for
    decode.  Returns (silu(conv + b), new_state)."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                 # (B, W-1+S, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return F.silu(y + b), new_state


def apply_mamba2(params, cfg, x, *, cache: dict | None = None):
    """x: (B, S, d_model); cache (serving): dict(conv, h).  Returns
    (y, new_cache)."""
    s_cfg, d_in, nh = _ssm_dims(cfg)
    b, s, _ = x.shape
    proj = x @ params["w_in"]
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * s_cfg.state_dim]
    dt_raw = proj[..., -nh:]
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   cache["conv"] if cache else None)
    if cache is not None and s > 1:
        # a copy: the slice would keep the whole (B, W-1+S, C) conv input
        # alive in the cache (~176 MB a layer at mamba2's prefill)
        conv_state = conv_state.clone()
    xs = xbc[..., :d_in].reshape(b, s, nh, s_cfg.head_dim)
    bmat = xbc[..., d_in:d_in + s_cfg.state_dim].float()
    cmat = xbc[..., d_in + s_cfg.state_dim:].float()
    # softplus as the reference writes it (logaddexp(x, 0))
    dt = torch.logaddexp(dt_raw.float() + params["dt_bias"],
                         torch.zeros((), device=x.device))
    a = -torch.exp(params["a_log"])
    h0 = cache["h"] if cache else None
    if s == 1 and cache is not None:
        # decode: one recurrence step, no chunking
        adt = torch.exp(a[None, :] * dt[:, 0])                  # (B, H)
        dx = xs[:, 0].float() * dt[:, 0][..., None]             # (B, H, P)
        h_last = (adt[:, :, None, None] * h0
                  + torch.einsum("bhp,bn->bhpn", dx, bmat[:, 0]))
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0], h_last)[:, None]
    else:
        y, h_last = ssd_scan(xs.contiguous(), dt.contiguous(), a,
                             bmat.contiguous(), cmat.contiguous(),
                             chunk=s_cfg.chunk_size, h0=h0)
    y = y + params["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(b, s, d_in).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y) * silu(z)
    y = apply_norm("rmsnorm", params["gate_norm"], y) * F.silu(z)
    out = y @ params["w_out"]
    new_cache = dict(conv=conv_state, h=h_last) if cache is not None else None
    return out, new_cache


def init_ssm_cache(cfg, batch, dtype, device=None) -> dict:
    s, d_in, nh = _ssm_dims(cfg)
    return dict(
        conv=torch.zeros((batch, s.conv_width - 1, d_in + 2 * s.state_dim),
                         dtype=dtype, device=device),
        h=torch.zeros((batch, nh, s.head_dim, s.state_dim),
                      dtype=torch.float32, device=device),
    )

"""Gradient compression for a slow cross-pod reduction (the reference's
``optim/compression.py``): int8 block quantization with per-block fp32
scales, and the error feedback that adds the last step's quantization
residual to this step's gradient.

``compressed_mean``, the all-reduce of the quantized payload over a mesh
axis, needs the mesh and waits for it (ROADMAP Queue 1 item 9.6).
"""

from __future__ import annotations

import torch

from ..tree import tree_map

__all__ = ["BLOCK", "int8_compress", "int8_decompress",
           "apply_error_feedback"]

BLOCK = 256


def int8_compress(x: torch.Tensor):
    """x: any shape, float -> (int8 values (blocks, BLOCK), fp32 scales
    (blocks, 1)): each block scaled by its max |x| / 127, rounded half to
    even."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape, size: int):
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def apply_error_feedback(grads, residuals):
    if residuals is None:
        return grads
    return tree_map(lambda g, r: g + r.to(g.dtype), grads, residuals)

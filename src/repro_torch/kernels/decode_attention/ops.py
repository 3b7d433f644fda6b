"""decode_attention: one-token GQA flash-decode over a KV cache.

Model layout at the wrapper, as the reference's ``ops.py`` takes it:
q (B, H, D) (one token per sequence), k / v (B, T, K, D) the cache,
kv_pos (B, T) int32 the position held in each slot (-1 = empty),
q_pos (B,) int32 the query's position.  A slot is visible when
``kv_pos >= 0``, ``kv_pos <= q_pos`` and, with a window,
``kv_pos > q_pos - window``.  Same fp32 softmax, NEG_INF, -1e4 max clamp
and 1e-30 divisor clamp as ``flash_attention``.  Output (B, H, D) in q's
dtype.

* ``decode_attention_plain`` — the plain PyTorch version.
* ``decode_attention`` — the wrapper: plain version for CPU tensors, the
  CUDA kernel (``csrc/decode_attention.cu``) for CUDA tensors.
  ``decode_attention.launches`` counts wrapper launches (one launch is the
  kernel's split pass and its combine pass).
"""

from __future__ import annotations

import torch

from ... import _build
from .. import check_same_device, launch_args

__all__ = ["decode_attention", "decode_attention_plain"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KEYS_PER_SPLIT = 128      # must equal kKeys in csrc/decode_attention.cu
MAX_GROUP = 8             # must equal kMaxG


def decode_attention_plain(q, k, v, kv_pos, q_pos, *, window=None):
    b, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    kx = k.float().permute(0, 2, 1, 3).repeat_interleave(g, 1)  # (B,H,T,D)
    vx = v.float().permute(0, 2, 1, 3).repeat_interleave(g, 1)
    sc = torch.einsum("bhd,bhtd->bht", q.float(), kx) * (d ** -0.5)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        valid &= kv_pos > q_pos[:, None] - window
    sc = torch.where(valid[:, None, :], sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True).clamp_min(-1e4)
    p = torch.exp(sc - m)
    o = torch.einsum("bht,bhtd->bhd", p, vx)
    return (o / p.sum(dim=-1)[..., None].clamp_min(1e-30)).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_pos: torch.Tensor, q_pos: torch.Tensor, *,
                     window=None) -> torch.Tensor:
    """Attention of q (B, H, D) over the cache k / v (B, T, K, D) with slot
    positions kv_pos (B, T) and query positions q_pos (B,)."""
    dev = check_same_device(q, k, v, kv_pos, q_pos)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, H, D) and k, v (B, T, K, D)")
    b, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k.shape)} (H must be a multiple of K)")
    if kv_pos.shape != (b, t) or q_pos.shape != (b,):
        raise ValueError("kv_pos must be (B, T) and q_pos (B,)")
    if kv_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("decode_attention takes int32 kv_pos and q_pos")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention takes f32 or bf16 q, k, v of one "
                        "dtype")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, kv_pos, q_pos, window=window)
    g = h // kh
    if d % 8 or d > 128 or g > MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes head_dim a multiple of 8 up "
                         f"to 128 and at most {MAX_GROUP} query heads per KV "
                         f"head, got D={d}, G={g}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ns = max(1, -(-t // KEYS_PER_SPLIT))    # blocks along the cache
    part = torch.empty((b, kh, ns, g, d + 2), dtype=torch.float32, device=dev)
    index, stream = launch_args(dev)
    err = _build.lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
        q_pos.data_ptr(), part.data_ptr(), out.data_ptr(),
        b, t, h, kh, d, window or 0, _DTYPES[q.dtype], index, stream,
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

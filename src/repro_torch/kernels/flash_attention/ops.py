"""flash_attention: causal / sliding-window GQA prefill attention.

Model layout at the wrapper, as the reference's ``ops.py`` takes it:
q (B, S, H, D), k / v (B, T, K, D) with H = K * G; query i and key j sit
at positions i and j.  A key is visible to a query when ``j <= i``
(causal) and ``j > i - window`` (window given).  Scores are
``q . k * D**-0.5`` in fp32; masked scores are ``NEG_INF``; the row max is
clamped at -1e4 (so a fully masked row gives zeros, never exp(0)) and the
divisor at 1e-30, as the reference kernel does.  Output (B, S, H, D) in
q's dtype.

The forward's lse, fp32 (B, H, S): ``lse[b, h, i] = max(m, -1e4) +
log(max(l, 1e-30))`` with m the row's clamped max and l the sum of
``exp(s - m)`` (-1e4 + log(1e-30) on a row that sees no key), what the
backward needs to form the softmax weights again.

* ``flash_attention_plain`` — the plain PyTorch version: the same masked,
  clamped softmax, one batch row at a time; ``flash_attention_lse_plain``
  returns (output, lse).
* ``flash_attention`` — the wrapper: plain version for CPU tensors, the
  CUDA kernel (``csrc/flash_attention.cu``) for CUDA tensors.
  ``flash_attention.launches`` counts kernel launches, and
  ``flash_attention.instance_launches`` splits them by the kernel's two
  instances: ``"wgmma"`` (bf16 with head_dim 64, 80 or 128, both
  products on the tensor cores) and ``"fma"`` (f32, and bf16 with
  head_dim 32, on the CUDA cores); ``flash_attention.lse_launches``
  counts the launches that stored lse.  On CUDA tensors the call is a
  ``torch.autograd.Function``: when grad mode is on and an input needs a
  gradient, its forward gives the kernel an lse buffer from
  ``torch.empty`` and saves q, k, v, the output and lse (under
  ``torch.utils.checkpoint`` those of the recomputed forward); otherwise
  (serving) the kernel stores no lse.  Its backward runs
  ``flash_attention_bwd`` on the incoming gradient made contiguous.  On
  CPU tensors autograd differentiates the plain version as it is.
* ``flash_attention_lse`` — (output, lse) of one forward launch that
  stores lse, no gradient; plain version for CPU tensors.

The backward: given q, k, v, the output o, its gradient do and the
forward's lse, dq (B, S, H, D), dk and dv (B, T, K, D) in q's dtype, fp32
inside: the values of autograd through ``flash_attention_plain``
(``delta = rowsum(do * o)``, so with a bf16 output the stored o is what
it reads).

* ``flash_attention_bwd_plain`` — its closed form in PyTorch ops, one
  batch row at a time; it forms the softmax from the scores itself.
* ``flash_attention_bwd`` — the wrapper: plain version for CPU tensors
  (lse, when given, is checked and not needed), the CUDA kernels
  (``csrc/flash_attention_bwd.cu``: delta, then dk / dv, then dq) for
  CUDA tensors, which read lse and raise without it; delta's fp32
  workspace comes from ``torch.empty``.  bf16 at head_dim 64, 80 and 128
  runs dk / dv and dq on the tensor cores (``"wgmma"``: a warpgroup per
  64 keys or 64 query rows, every product on ``wgmma``, P and dS rounded
  once to bf16), f32 and bf16 at head_dim 32 on the CUDA cores
  (``"fma"``); the instance is ``instance(dtype, head_dim)``, as the
  forward's.  ``flash_attention.backward_launches`` counts its calls
  (three kernel launches each), and
  ``flash_attention.backward_instance_launches`` the same calls by
  instance.  What bounds it: at olmo-1b's training shape the five
  products' operations (0.087 ms at the bf16 peak); the ``wgmma``
  passes do seven products, S and dP twice, so that every key and query
  row has one owner and no atomics.

The latent form, for multi-head latent attention's absorbed prefill: query
rows ``[q_lat ; q_rope]`` (B, S, H, R + Dr), one key head shared by every
query head, the latent row ``[c_kv ; k_rope]`` (B, T, R + Dr), whose
first R elements, ``c_kv``, are the value; the scale comes from the caller
(MLA's ``(qk_nope + qk_rope) ** -0.5``, not the key width's).  Causal over
positions 0..S-1 and 0..T-1, the same clamped fp32 softmax, output
(B, S, H, R) in q's dtype: the reference's ``chunked_attention`` on the
concatenated inputs with ``softmax_scale``.

* ``flash_attention_latent_plain`` — its plain PyTorch version;
  ``flash_attention_latent_lse_plain`` returns (output, lse), lse fp32
  (B, S, H) with the same clamps as flash's.
* ``flash_attention_latent`` — the wrapper: plain version for CPU tensors,
  the CUDA kernels (``csrc/mla_attention.cu``, R 512 and Dr 64) for CUDA
  tensors.  ``flash_attention_latent.launches`` counts its launches and
  ``flash_attention_latent.instance_launches`` splits them by kernel
  (``latent_instance``): ``"wgmma"`` for bf16, both products on the
  tensor cores (``mla_attention_wgmma_kernel``: 64 query rows a block in
  two warpgroups, the keys of S and the value columns of O split between
  them, P passed between them in two bf16 halves, 64-key latent tiles
  staged once through a ring of 17 pieces), ``"fma"`` for f32, on the CUDA
  cores (``mla_attention_kernel``).  On CUDA tensors the call is a
  ``torch.autograd.Function``, as flash's: when grad mode is on and an
  input needs a gradient, the kernel stores each row's lse into a buffer
  from ``torch.empty`` (``flash_attention_latent.lse_launches`` counts
  those launches; serving's must be 0) and the Function saves the inputs,
  the output and lse; its backward runs ``flash_attention_latent_bwd``.
  The forward stores lse rather than the backward forming it again,
  because the forward has the row's max and sum at hand (one fp32 store
  a row), where a pass of its own would form every score once more: a
  fifth of the backward's products.  On CPU tensors autograd
  differentiates the plain version as it is.
* ``flash_attention_latent_lse`` — (output, lse) of one forward launch
  that stores lse, no gradient; plain version for CPU tensors.

The latent backward: given the inputs, the output o, its gradient do
(B, S, H, R) and the forward's lse, (dq_lat, dq_rope, dc_kv, dk_rope) in
q_lat's dtype, fp32 inside: with p the softmax weights, delta = rowsum(do
* o) and ds = p (do . c_kv - delta), dq = scale ds [c_kv ; k_rope], and
c_kv, the value and the key's first R columns, takes both parts: dc_kv =
p^T do + scale ds^T q_lat, dk_rope = scale ds^T q_rope, summed over every
(position, head) row.

* ``flash_attention_latent_bwd_plain`` — its closed form in PyTorch ops,
  one batch row at a time; it forms the softmax from the scores itself.
* ``flash_attention_latent_bwd`` — the wrapper: plain version for CPU
  tensors (lse, when given, is checked and not needed), the CUDA kernels
  (``csrc/mla_attention_bwd.cu``: delta, then the query side, then the
  key side's partial sums over chunks of the rows, then their sum) for
  CUDA tensors, which read lse and raise without it.  bf16 runs the
  query and key sides on the tensor cores (``"wgmma"``:
  ``mla_bwd_q_wgmma_kernel``, 64 query rows a block in two warpgroups
  walking 64-key latent tiles, S and dO c_kv^T split over the keys, dS
  passed between the warpgroups, dq's 576 columns split between them;
  ``mla_bwd_kv_wgmma_kernel``, 64 keys a block over a chunk of 8 192
  rows in 64-row tiles, P^T and dS^T passed on, dc_kv and dk_rope in one
  accumulator split by columns; P and dS rounded once to bf16 as A
  operands), f32 on the CUDA cores (``"fma"``: fp32 FMAs, 32 rows or
  keys a block).  Delta's and the partial sums' fp32 workspaces come
  from ``torch.empty``, the latter's size from the C side
  (``flash_attention_latent_bwd_workspace``, 80 MB at B 4, S 1024, H
  128).  ``flash_attention_latent.backward_launches`` counts its calls
  (four kernel launches each) and ``backward_instance_launches`` the
  same calls by instance (``latent_bwd_instance``).
"""

from __future__ import annotations

import torch

from ... import _build
from .. import check_same_device, launch_args

__all__ = ["flash_attention", "flash_attention_plain", "instance",
           "flash_attention_lse", "flash_attention_lse_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_latent", "flash_attention_latent_plain",
           "flash_attention_latent_lse", "flash_attention_latent_lse_plain",
           "flash_attention_latent_bwd", "flash_attention_latent_bwd_plain",
           "latent_instance", "latent_bwd_instance", "LATENT_WIDTHS",
           "NEG_INF"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128)   # the C dispatch's
_TENSOR_CORE_HEAD_DIMS = (64, 80, 128)   # bf16 on the wgmma instance
LATENT_WIDTHS = (512, 64)   # (R, Dr) that csrc/mla_attention.cu takes


def _mask(s: int, t: int, causal: bool, window, device) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _plain(q, k, v, causal, window, with_lse: bool):
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    mask = _mask(s, t, causal, window, q.device)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    for i in range(b):
        qf = q[i].float().transpose(0, 1)                         # (H, S, D)
        kf = k[i].float().transpose(0, 1).repeat_interleave(g, 0)  # (H, T, D)
        vf = v[i].float().transpose(0, 1).repeat_interleave(g, 0)
        sc = torch.matmul(qf, kf.transpose(1, 2)) * (d ** -0.5)
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(dim=-1, keepdim=True).clamp_min(-1e4)
        p = torch.exp(sc - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[i] = (torch.matmul(p, vf) / l).transpose(0, 1).to(q.dtype)
        if with_lse:
            lse[i] = (m + torch.log(l))[..., 0]
    return out, lse


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    return _plain(q, k, v, causal, window, False)[0]


def flash_attention_lse_plain(q, k, v, *, causal: bool = True, window=None):
    return _plain(q, k, v, causal, window, True)


def _check_forward(q, k, v, window) -> torch.device:
    """The forward's checks of q, k, v and window; returns their device."""
    dev = check_same_device(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be (B, S, H, D) and k, v (B, T, K, D)")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (H must be a multiple of K)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes f32 or bf16 q, k, v of one "
                        "dtype")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if dev.type != "cpu" and d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    return dev


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """Attention of q (B, S, H, D) over k / v (B, T, K, D), positions
    0..S-1 and 0..T-1; f32 or bf16, one dtype for all three."""
    if _check_forward(q, k, v, window).type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    # Function.forward runs with grad mode off, and its needs_input_grad
    # does not say whether grad mode was on: decide here
    keep_lse = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, window, keep_lse)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window=None):
    """(output, lse (B, H, S) fp32) of ``flash_attention``'s forward; no
    gradient flows through it."""
    if _check_forward(q, k, v, window).type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal,
                                         window=window)
    lse = _lse_buffer(q)
    return _launch(q, k, v, causal, window, lse), lse


def _lse_buffer(q) -> torch.Tensor:
    b, s, h, _ = q.shape
    return torch.empty((b, h, s), dtype=torch.float32, device=q.device)


def _launch(q, k, v, causal, window, lse=None) -> torch.Tensor:
    """The forward kernel on CUDA tensors that ``_check_forward`` has
    checked; it stores each row's lse into ``lse`` when one is given."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    index, stream = launch_args(q.device)
    err = _build.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, s, t, h, kh, d, int(causal), window or 0, _DTYPES[q.dtype],
        index, stream,
    )
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.instance_launches[instance(q.dtype, d)] += 1
    if lse is not None:
        flash_attention.lse_launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The CUDA route of ``flash_attention``: the forward kernel, and
    ``flash_attention_bwd`` for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, keep_lse):
        lse = _lse_buffer(q) if keep_lse else None
        out = _launch(q, k, v, causal, window, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def instance(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel instance that a launch on these inputs runs (the dispatch
    of ``flash_attention_launch``)."""
    return ("wgmma" if dtype == torch.bfloat16
            and head_dim in _TENSOR_CORE_HEAD_DIMS else "fma")


flash_attention.launches = 0
flash_attention.instance_launches = {"wgmma": 0, "fma": 0}
flash_attention.lse_launches = 0
flash_attention.backward_launches = 0
flash_attention.backward_instance_launches = {"wgmma": 0, "fma": 0}


# --------------------------------------------------------------- backward
def flash_attention_bwd_plain(q, k, v, o, do, *, causal: bool = True,
                              window=None):
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5
    mask = _mask(s, t, causal, window, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for i in range(b):
        qf = q[i].float().transpose(0, 1)                          # (H, S, D)
        kf = k[i].float().transpose(0, 1).repeat_interleave(g, 0)  # (H, T, D)
        vf = v[i].float().transpose(0, 1).repeat_interleave(g, 0)
        of, dof = (x[i].float().transpose(0, 1) for x in (o, do))
        sc = torch.matmul(qf, kf.transpose(1, 2)) * scale
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(dim=-1, keepdim=True).clamp_min(-1e4)
        e = torch.exp(sc - m)
        p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        dp = torch.matmul(dof, vf.transpose(1, 2))
        ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
        dq[i] = (torch.matmul(ds, kf) * scale).transpose(0, 1).to(q.dtype)
        dkh = torch.matmul(ds.transpose(1, 2), qf) * scale         # (H, T, D)
        dvh = torch.matmul(p.transpose(1, 2), dof)
        dk[i] = dkh.view(kh, g, t, d).sum(1).transpose(0, 1).to(k.dtype)
        dv[i] = dvh.view(kh, g, t, d).sum(1).transpose(0, 1).to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor | None = None, *,
                        causal: bool = True, window=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, window) = o`` at
    the output gradient ``do`` (B, S, H, D); all five contiguous, of one
    dtype.  ``lse`` is the forward's (``flash_attention_lse``), fp32 (B, H,
    S); the CUDA kernels need it."""
    dev = check_same_device(q, k, v, o, do,
                            *(() if lse is None else (lse,)))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("q, o and do must be (B, S, H, D) and k, v "
                         "(B, T, K, D)")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)} (H must be a multiple of K)")
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype
                                     for x in (k, v, o, do)):
        raise TypeError("flash_attention_bwd takes f32 or bf16 inputs of "
                        "one dtype")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if lse is not None and (lse.shape != (b, h, s)
                            or lse.dtype != torch.float32
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 (B, H, S) = "
                         f"{(b, h, s)} tensor, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         window=window)
    if d not in _HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if lse is None:
        raise ValueError("flash_attention_bwd on CUDA tensors reads the "
                         "forward's lse (flash_attention_lse); it does not "
                         "recompute it")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    index, stream = launch_args(dev)
    err = _build.lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), b, s, t, h, kh, d, int(causal), window or 0,
        _DTYPES[q.dtype], index, stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention.backward_launches += 1
    flash_attention.backward_instance_launches[instance(q.dtype, d)] += 1
    return dq, dk, dv


# ---------------------------------------------------------------- latent
def _latent_scores(q_lat, q_rope, ckv, krope, i, scale, causal=True):
    """Batch row i's masked scores (S, H, T), fp32, from ckv / krope (T, R)
    / (T, Dr) in fp32."""
    s, h, r = q_lat.shape[1:]
    t = ckv.shape[0]
    sc = (q_lat[i].float().reshape(s * h, r) @ ckv.T
          + q_rope[i].float().reshape(s * h, -1) @ krope.T)
    sc = sc.reshape(s, h, t) * scale
    if not causal:
        return sc
    mask = _mask(s, t, True, None, q_lat.device)[:, None, :]   # (S, 1, T)
    return torch.where(mask, sc, torch.full_like(sc, NEG_INF))


def _latent_plain(q_lat, q_rope, c_kv, k_rope, scale, with_lse: bool):
    b, s, h, r = q_lat.shape
    out = torch.empty_like(q_lat)
    lse = (torch.empty((b, s, h), dtype=torch.float32, device=q_lat.device)
           if with_lse else None)
    for i in range(b):
        ckv = c_kv[i].float()                                    # (T, R)
        sc = _latent_scores(q_lat, q_rope, ckv, k_rope[i].float(), i, scale)
        m = sc.amax(dim=-1, keepdim=True).clamp_min(-1e4)
        p = torch.exp(sc - m)
        o = (p.reshape(s * h, -1) @ ckv).reshape(s, h, r)
        den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[i] = (o / den).to(q_lat.dtype)
        if with_lse:
            lse[i] = (m + torch.log(den))[..., 0]
    return out, lse


def flash_attention_latent_plain(q_lat, q_rope, c_kv, k_rope, *,
                                 scale: float):
    return _latent_plain(q_lat, q_rope, c_kv, k_rope, scale, False)[0]


def flash_attention_latent_lse_plain(q_lat, q_rope, c_kv, k_rope, *,
                                     scale: float):
    return _latent_plain(q_lat, q_rope, c_kv, k_rope, scale, True)


def _check_latent(q_lat, q_rope, c_kv, k_rope, qdims: int) -> None:
    """Shapes and dtypes shared by the latent prefill and decode: q_lat
    (..., R) and q_rope (..., Dr) with ``qdims`` leading dims, c_kv
    (B, T, R) and k_rope (B, T, Dr)."""
    if (q_lat.dim() != qdims + 1 or q_rope.shape[:-1] != q_lat.shape[:-1]
            or c_kv.dim() != 3 or k_rope.shape[:-1] != c_kv.shape[:-1]
            or c_kv.shape[0] != q_lat.shape[0]
            or c_kv.shape[2] != q_lat.shape[-1]
            or k_rope.shape[2] != q_rope.shape[-1]):
        raise ValueError(
            f"latent attention takes q_lat / q_rope of {qdims} leading dims "
            "and widths R / Dr, c_kv (B, T, R) and k_rope (B, T, Dr); got "
            f"{tuple(q_lat.shape)}, {tuple(q_rope.shape)}, "
            f"{tuple(c_kv.shape)}, {tuple(k_rope.shape)}")
    if q_lat.dtype not in _DTYPES or any(
            x.dtype != q_lat.dtype for x in (q_rope, c_kv, k_rope)):
        raise TypeError("latent attention takes f32 or bf16 inputs of one "
                        "dtype")


def _check_latent_widths(q_lat, q_rope) -> None:
    widths = (q_lat.shape[-1], q_rope.shape[-1])
    if widths != LATENT_WIDTHS:
        raise ValueError(f"the CUDA kernel takes (R, Dr) = {LATENT_WIDTHS}, "
                         f"got {widths}")


def _check_latent_forward(q_lat, q_rope, c_kv, k_rope) -> torch.device:
    dev = check_same_device(q_lat, q_rope, c_kv, k_rope)
    _check_latent(q_lat, q_rope, c_kv, k_rope, 3)
    if dev.type != "cpu":
        _check_latent_widths(q_lat, q_rope)
    return dev


def flash_attention_latent(q_lat: torch.Tensor, q_rope: torch.Tensor,
                           c_kv: torch.Tensor, k_rope: torch.Tensor, *,
                           scale: float) -> torch.Tensor:
    """Causal latent attention of q_lat (B, S, H, R) / q_rope (B, S, H, Dr)
    over c_kv (B, T, R) / k_rope (B, T, Dr); returns (B, S, H, R)."""
    if _check_latent_forward(q_lat, q_rope, c_kv, k_rope).type == "cpu":
        return flash_attention_latent_plain(q_lat, q_rope, c_kv, k_rope,
                                            scale=scale)
    # Function.forward runs with grad mode off: decide here, as flash's
    keep_lse = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q_lat, q_rope, c_kv, k_rope))
    return _FlashAttentionLatent.apply(q_lat, q_rope, c_kv, k_rope,
                                       float(scale), keep_lse)


def flash_attention_latent_lse(q_lat: torch.Tensor, q_rope: torch.Tensor,
                               c_kv: torch.Tensor, k_rope: torch.Tensor, *,
                               scale: float):
    """(output, lse (B, S, H) fp32) of ``flash_attention_latent``'s
    forward; no gradient flows through it."""
    if _check_latent_forward(q_lat, q_rope, c_kv, k_rope).type == "cpu":
        return flash_attention_latent_lse_plain(q_lat, q_rope, c_kv, k_rope,
                                                scale=scale)
    lse = _latent_lse_buffer(q_lat)
    return _latent_launch(q_lat, q_rope, c_kv, k_rope, scale, lse), lse


def _latent_lse_buffer(q_lat) -> torch.Tensor:
    return torch.empty(q_lat.shape[:3], dtype=torch.float32,
                       device=q_lat.device)


def _latent_launch(q_lat, q_rope, c_kv, k_rope, scale, lse=None):
    """The forward kernel on CUDA tensors that ``_check_latent_forward``
    has checked; it stores each row's lse into ``lse`` when one is
    given."""
    out = torch.empty_like(q_lat)
    if out.numel() == 0:
        return out
    b, s, h, r = q_lat.shape
    index, stream = launch_args(q_lat.device)
    err = _build.lib().flash_attention_latent_launch(
        q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
        k_rope.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, c_kv.shape[1], h, r,
        q_rope.shape[-1], float(scale), _DTYPES[q_lat.dtype], index, stream)
    _build.check(err, "flash_attention_latent")
    flash_attention_latent.launches += 1
    inst = latent_instance(q_lat.dtype)
    flash_attention_latent.instance_launches[inst] += 1
    if lse is not None:
        flash_attention_latent.lse_launches += 1
    return out


class _FlashAttentionLatent(torch.autograd.Function):
    """The CUDA route of ``flash_attention_latent``: the forward kernel,
    and ``flash_attention_latent_bwd`` for the gradient."""

    @staticmethod
    def forward(ctx, q_lat, q_rope, c_kv, k_rope, scale, keep_lse):
        lse = _latent_lse_buffer(q_lat) if keep_lse else None
        out = _latent_launch(q_lat, q_rope, c_kv, k_rope, scale, lse)
        ctx.save_for_backward(q_lat, q_rope, c_kv, k_rope, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q_lat, q_rope, c_kv, k_rope, out, lse = ctx.saved_tensors
        grads = flash_attention_latent_bwd(q_lat, q_rope, c_kv, k_rope, out,
                                           dout.contiguous(), lse,
                                           scale=ctx.scale)
        return (*grads, None, None)


def latent_instance(dtype: torch.dtype) -> str:
    """The kernel that a latent prefill launch on inputs of ``dtype`` runs
    (the dispatch of ``flash_attention_latent_launch``)."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def latent_bwd_instance(dtype: torch.dtype) -> str:
    """The instance of the latent backward's passes that a call on inputs
    of ``dtype`` runs (the dispatch of ``flash_attention_latent_bwd_launch``):
    ``"wgmma"`` for bf16, its query and key sides on the tensor cores;
    ``"fma"`` for f32, on the CUDA cores."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


flash_attention_latent.launches = 0
flash_attention_latent.instance_launches = {"wgmma": 0, "fma": 0}
flash_attention_latent.lse_launches = 0
flash_attention_latent.backward_launches = 0
flash_attention_latent.backward_instance_launches = {"wgmma": 0, "fma": 0}


# --------------------------------------------------------- latent backward
def _latent_bwd(q_lat, q_rope, c_kv, k_rope, o, do, scale, causal=True,
                value_part=True):
    """The closed form; ``causal=False`` drops the mask and
    ``value_part=False`` dc_kv's p^T do term (the card check's wrong
    variants)."""
    b, s, h, r = q_lat.shape
    dr = q_rope.shape[-1]
    dq_lat, dq_rope = torch.empty_like(q_lat), torch.empty_like(q_rope)
    dc_kv, dk_rope = torch.empty_like(c_kv), torch.empty_like(k_rope)
    for i in range(b):
        ckv, krope = c_kv[i].float(), k_rope[i].float()
        sc = _latent_scores(q_lat, q_rope, ckv, krope, i, scale, causal)
        m = sc.amax(dim=-1, keepdim=True).clamp_min(-1e4)
        e = torch.exp(sc - m)
        p = (e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)).reshape(
            s * h, -1)
        del sc, e
        dof = do[i].float().reshape(s * h, r)
        delta = (dof * o[i].float().reshape(s * h, r)).sum(-1, keepdim=True)
        ds = p * (dof @ ckv.T - delta)
        dq_lat[i] = (scale * (ds @ ckv)).reshape(s, h, r).to(q_lat.dtype)
        dq_rope[i] = (scale * (ds @ krope)).reshape(s, h, dr).to(
            q_rope.dtype)
        dck = scale * (ds.T @ q_lat[i].float().reshape(s * h, r))
        if value_part:
            dck = dck + p.T @ dof
        dc_kv[i] = dck.to(c_kv.dtype)
        dk_rope[i] = (scale * (ds.T @ q_rope[i].float().reshape(s * h, dr))
                      ).to(k_rope.dtype)
    return dq_lat, dq_rope, dc_kv, dk_rope


def flash_attention_latent_bwd_plain(q_lat, q_rope, c_kv, k_rope, o, do, *,
                                     scale: float):
    return _latent_bwd(q_lat, q_rope, c_kv, k_rope, o, do, scale)


def flash_attention_latent_bwd(q_lat: torch.Tensor, q_rope: torch.Tensor,
                               c_kv: torch.Tensor, k_rope: torch.Tensor,
                               o: torch.Tensor, do: torch.Tensor,
                               lse: torch.Tensor | None = None, *,
                               scale: float):
    """(dq_lat, dq_rope, dc_kv, dk_rope) of ``flash_attention_latent(q_lat,
    q_rope, c_kv, k_rope, scale) = o`` at the output gradient ``do``
    (B, S, H, R); all six contiguous, of one dtype.  ``lse`` is the
    forward's (``flash_attention_latent_lse``), fp32 (B, S, H); the CUDA
    kernels need it."""
    dev = check_same_device(q_lat, q_rope, c_kv, k_rope, o, do,
                            *(() if lse is None else (lse,)))
    _check_latent(q_lat, q_rope, c_kv, k_rope, 3)
    if o.shape != q_lat.shape or do.shape != q_lat.shape:
        raise ValueError(f"o and do must be (B, S, H, R) = "
                         f"{tuple(q_lat.shape)}, got {tuple(o.shape)} and "
                         f"{tuple(do.shape)}")
    if o.dtype != q_lat.dtype or do.dtype != q_lat.dtype:
        raise TypeError("flash_attention_latent_bwd takes f32 or bf16 "
                        "inputs of one dtype")
    b, s, h, _ = q_lat.shape
    if lse is not None and (lse.shape != (b, s, h)
                            or lse.dtype != torch.float32):
        raise ValueError(f"lse must be a contiguous float32 (B, S, H) = "
                         f"{(b, s, h)} tensor, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if dev.type == "cpu":
        return flash_attention_latent_bwd_plain(q_lat, q_rope, c_kv, k_rope,
                                                o, do, scale=scale)
    _check_latent_widths(q_lat, q_rope)
    if lse is None:
        raise ValueError("flash_attention_latent_bwd on CUDA tensors reads "
                         "the forward's lse (flash_attention_latent_lse); "
                         "it does not recompute it")
    grads = tuple(torch.empty_like(x) for x in (q_lat, q_rope, c_kv, k_rope))
    if q_lat.numel() == 0 or c_kv.numel() == 0:
        return tuple(g.zero_() for g in grads)
    t = c_kv.shape[1]
    lib = _build.lib()
    delta = torch.empty_like(lse)
    part = torch.empty(lib.flash_attention_latent_bwd_workspace(b, s, t, h),
                       dtype=torch.float32, device=dev)
    index, stream = launch_args(dev)
    err = lib.flash_attention_latent_bwd_launch(
        q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
        k_rope.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), part.data_ptr(), *(g.data_ptr() for g in grads), b,
        s, t, h, q_lat.shape[-1], q_rope.shape[-1], float(scale),
        _DTYPES[q_lat.dtype], index, stream)
    _build.check(err, "flash_attention_latent_bwd")
    flash_attention_latent.backward_launches += 1
    flash_attention_latent.backward_instance_launches[
        latent_bwd_instance(q_lat.dtype)] += 1
    return grads

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
  ``decode_attention.launches`` counts kernel launches (one per call: the
  splits and their merge run in one launch).
* ``head_groups`` — how many groups the G query heads of a KV head are
  cut into (at most ``BLOCK_GROUP`` heads a block; two at glm4-9b's G 16);
  ``split_plan`` — how the kernel cuts the cache into splits, one block
  each per (split, head group of a kv head, batch row);
  ``resident_blocks`` — the wave it fills on a card.

The latent form, for multi-head latent attention's absorbed decode: one
token's query rows ``[q_lat ; q_rope]`` (B, H, R + Dr) over the latent
cache ``[c_kv ; k_rope]`` (B, T, R + Dr), one key head shared by every
query head, ``c_kv`` the value, the scale from the caller; decode's
masking (``kv_pos >= 0``, ``kv_pos <= q_pos``) and the same clamped fp32
softmax; output (B, H, R) in q's dtype.

* ``decode_attention_latent_plain`` — its plain PyTorch version.
* ``decode_attention_latent`` — the wrapper: plain version for CPU
  tensors, the CUDA kernel (``csrc/mla_attention.cu``, R 512 and Dr 64)
  for CUDA tensors: bf16 on the tensor-core kernel, f32 on the CUDA-core
  one (``latent_decode_instance``).  ``decode_attention_latent.launches``
  counts its calls (one kernel launch, and a second that merges the
  splits when there is more than one), ``.instance_launches`` the same
  calls by instance.
* ``latent_split_plan`` — how that kernel cuts the cache into splits.
"""

from __future__ import annotations

import functools

import torch

from ... import _build
from .. import check_same_device, launch_args, refuse_grad
from ..flash_attention.ops import _check_latent, _check_latent_widths

__all__ = ["decode_attention", "decode_attention_plain", "head_groups",
           "resident_blocks", "split_plan", "decode_attention_latent",
           "decode_attention_latent_plain", "latent_decode_instance",
           "latent_split_plan"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64                # must equal kChunk in csrc/decode_attention.cu
MAX_CHUNKS = 32           # chunks per split: kMaxSplit / kChunk
MAX_GROUP = 16            # query heads per kv head; must equal kMaxG
BLOCK_GROUP = 8           # query heads per block; must equal kBlockG
# the latent kernels' keys per staged tile (f32 on the CUDA cores, bf16 on
# the tensor cores) and query rows per block; must equal Tile<T>::keys and
# kBlockRows in csrc/mla_attention.cu
LATENT_TILE_KEYS = {torch.float32: 32, torch.bfloat16: 64}
LATENT_BLOCK_ROWS = 64
# (device index, stream) -> the kernel's int32 arrival counters, one per
# (batch row, kv head, head group); each launch leaves them at zero again
_COUNTERS: dict = {}


def head_groups(g: int) -> int:
    """Groups that the G query heads of a KV head are cut into: the fewest
    that divide G with at most ``BLOCK_GROUP`` heads each (the C side's
    ``head_groups``).  Each group is its own blocks, over the same cache."""
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"G must be in 1..{MAX_GROUP}, got {g}")
    n = -(-g // BLOCK_GROUP)
    while g % n:
        n += 1
    return n


def split_plan(b: int, kh: int, t: int, resident: int) -> int:
    """Blocks (splits) per (batch row, kv head) for a cache of ``t`` slots;
    the kernel passes the (kv head, head group) pairs as ``kh``.
    The cache is cut into 64-slot chunks and split s takes chunks s, s + ns,
    s + 2 ns, ..., so a window's visible chunks spread over every split.
    As many splits as one wave of ``resident`` blocks (the card's SMs times
    the blocks per SM that the kernel's launch bounds ask for) holds over
    the ``b * kh`` pairs, at most one per chunk and at least enough that no
    split takes more than 32 chunks."""
    chunks = -(-t // CHUNK)
    want = max(1, resident // (b * kh))
    return max(-(-chunks // MAX_CHUNKS), min(chunks, want))


@functools.lru_cache(maxsize=None)
def resident_blocks(index: int, g: int) -> int:
    """Blocks of the kernel's G instance (``g`` query heads a block) that
    one wave holds on card ``index``, the blocks per SM taken from the
    kernel itself."""
    return (torch.cuda.get_device_properties(index).multi_processor_count
            * _build.lib().decode_attention_blocks_per_sm(g))


def _counters(dev: torch.device, index: int, stream: int,
              n: int) -> torch.Tensor:
    buf = _COUNTERS.get((index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _COUNTERS[(index, stream)] = buf
    return buf


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
    refuse_grad("decode_attention", "decode serves only: training (ROADMAP "
                "Queue 1 item 9.5) runs cache-free forwards, and no item "
                "brings a decode backward", q, k, v)
    g = h // kh
    if d % 8 or d > 128 or g > MAX_GROUP:
        raise ValueError(f"the CUDA kernel takes head_dim a multiple of 8 up "
                         f"to 128 and at most {MAX_GROUP} query heads per KV "
                         f"head, got D={d}, G={g}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    index, stream = launch_args(dev)
    ng = head_groups(g)
    ns = split_plan(b, kh * ng, t, resident_blocks(index, g // ng))
    part = torch.empty((b, kh * ng, ns, g // ng, d + 4), dtype=torch.float32,
                       device=dev)
    count = _counters(dev, index, stream, b * kh * ng)
    err = _build.lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
        q_pos.data_ptr(), part.data_ptr(), count.data_ptr(), out.data_ptr(),
        b, t, h, kh, d, window or 0, ns, _DTYPES[q.dtype], index, stream,
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------- latent
def latent_split_plan(b: int, h: int, t: int, sms: int,
                      tile_keys: int) -> tuple[int, int]:
    """(splits, slots per split) of the latent decode kernel: the cache's
    ``t`` slots in whole tiles of ``tile_keys``, cut into as many runs as
    one block per SM over the ``b * ceil(h / 64)`` (batch row, 64 heads)
    pairs allows, at most one per tile, none empty."""
    tiles = -(-t // tile_keys)
    want = max(1, min(tiles, sms // (b * -(-h // LATENT_BLOCK_ROWS))))
    per = -(-tiles // want)
    return -(-tiles // per), per * tile_keys


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_latent_plain(q_lat, q_rope, c_kv, k_rope, kv_pos, q_pos,
                                  *, scale: float):
    ckv = c_kv.float()
    sc = (torch.einsum("bhr,btr->bht", q_lat.float(), ckv)
          + torch.einsum("bhd,btd->bht", q_rope.float(), k_rope.float()))
    sc = sc * scale
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    sc = torch.where(valid[:, None, :], sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True).clamp_min(-1e4)
    p = torch.exp(sc - m)
    o = torch.einsum("bht,btr->bhr", p, ckv)
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q_lat.dtype)


def decode_attention_latent(q_lat: torch.Tensor, q_rope: torch.Tensor,
                            c_kv: torch.Tensor, k_rope: torch.Tensor,
                            kv_pos: torch.Tensor, q_pos: torch.Tensor, *,
                            scale: float) -> torch.Tensor:
    """Latent attention of one token's q_lat (B, H, R) / q_rope (B, H, Dr)
    over the cache c_kv (B, T, R) / k_rope (B, T, Dr) with slot positions
    kv_pos (B, T) and query positions q_pos (B,); returns (B, H, R)."""
    dev = check_same_device(q_lat, q_rope, c_kv, k_rope, kv_pos, q_pos)
    _check_latent(q_lat, q_rope, c_kv, k_rope, 2)
    b, h, r = q_lat.shape
    t = c_kv.shape[1]
    if kv_pos.shape != (b, t) or q_pos.shape != (b,):
        raise ValueError("kv_pos must be (B, T) and q_pos (B,)")
    if kv_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("decode_attention_latent takes int32 kv_pos and "
                        "q_pos")
    if dev.type == "cpu":
        return decode_attention_latent_plain(q_lat, q_rope, c_kv, k_rope,
                                             kv_pos, q_pos, scale=scale)
    refuse_grad("decode_attention_latent", "decode serves only: training "
                "(ROADMAP Queue 1 item 9.5) runs cache-free forwards, and "
                "no item brings a decode backward", q_lat, q_rope, c_kv,
                k_rope)
    _check_latent_widths(q_lat, q_rope)
    out = torch.empty_like(q_lat)
    if out.numel() == 0:
        return out
    index, stream = launch_args(dev)
    ns, per = latent_split_plan(b, h, t, _sm_count(index),
                                LATENT_TILE_KEYS[q_lat.dtype])
    part = (torch.empty((b, h, ns, r + 4), dtype=torch.float32, device=dev)
            if ns > 1 else None)
    err = _build.lib().decode_attention_latent_launch(
        q_lat.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
        k_rope.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        part.data_ptr() if part is not None else None, out.data_ptr(),
        b, t, h, r, q_rope.shape[-1], ns, per, float(scale),
        _DTYPES[q_lat.dtype], index, stream)
    _build.check(err, "decode_attention_latent")
    decode_attention_latent.launches += 1
    decode_attention_latent.instance_launches[
        latent_decode_instance(q_lat.dtype)] += 1
    return out


def latent_decode_instance(dtype: torch.dtype) -> str:
    """The kernel that a latent decode launch on inputs of ``dtype`` runs
    (the dispatch of ``decode_attention_latent_launch``)."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


decode_attention_latent.launches = 0
decode_attention_latent.instance_launches = {"wgmma": 0, "fma": 0}

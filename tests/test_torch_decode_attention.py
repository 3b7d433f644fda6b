"""decode_attention: the port's plain PyTorch version (what the wrapper runs
on CPU tensors) against the JAX package's Pallas flash-decode kernel in
interpret mode, its pure-jnp oracle and the reference model's
``chunked_attention`` (one query over a cache with empty slots), on the same
seeded inputs, within the reference's kernel tolerances (2e-4 in f32, 2e-2
in bf16)."""

import re

import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention as ref_kernel
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.models.attention import chunked_attention as ref_chunked
from repro_torch import _build
from repro_torch.kernels.decode_attention.ops import (BLOCK_GROUP, CHUNK,
                                                      MAX_CHUNKS, MAX_GROUP,
                                                      decode_attention,
                                                      decode_attention_plain,
                                                      head_groups,
                                                      split_plan)

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"f32": (jnp.float32, torch.float32, TOL32),
          "bf16": (jnp.bfloat16, torch.bfloat16, TOL)}


def _inputs(b, h, kh, t, d, fill, seed):
    """q (B, H, D), cache k / v (B, T, K, D) (model layout), kv_pos (B, T)
    with slots past ``fill`` empty (-1), q_pos (B,) = fill - 1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    k = rng.standard_normal((b, t, kh, d), dtype=np.float32)
    v = rng.standard_normal((b, t, kh, d), dtype=np.float32)
    slot = np.arange(t, dtype=np.int32)[None]
    kv_pos = np.broadcast_to(np.where(slot < fill, slot, -1), (b, t)).copy()
    q_pos = np.full((b,), fill - 1, dtype=np.int32)
    return q, k, v, kv_pos, q_pos


def _port(arrs, tdtype, **kw):
    q, k, v, kv_pos, q_pos = (torch.from_numpy(a) for a in arrs)
    out = decode_attention(q.to(tdtype), k.to(tdtype), v.to(tdtype), kv_pos,
                           q_pos, **kw)
    assert out.dtype == tdtype
    return out.float().numpy()


def _ref_args(arrs, jdtype):
    q, k, v, kv_pos, q_pos = arrs
    return (jnp.asarray(q, jdtype), jnp.asarray(k, jdtype).transpose(0, 2, 1, 3),
            jnp.asarray(v, jdtype).transpose(0, 2, 1, 3), jnp.asarray(kv_pos),
            jnp.asarray(q_pos))


SHAPES = [   # b, h, kh, t, d, window, fill (tests/test_kernels.py + G=5)
    (1, 2, 2, 256, 32, None, 256),
    (2, 4, 1, 512, 64, None, 300),
    (1, 2, 2, 256, 32, 128, 256),
    (2, 10, 2, 256, 64, 100, 200),
    # the dense configs: G 16 at D 128 (glm4-9b) and D 80, G 6 (nemotron)
    (2, 32, 2, 256, 128, None, 200),
    (1, 16, 1, 256, 80, 100, 256),
    (2, 12, 2, 256, 128, 40, 200),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_matches_reference_kernel_and_oracle(shape, dtype):
    b, h, kh, t, d, window, fill = shape
    jdtype, tdtype, tol = DTYPES[dtype]
    arrs = _inputs(b, h, kh, t, d, fill, seed=t + h + fill)
    got = _port(arrs, tdtype, window=window)
    args = _ref_args(arrs, jdtype)
    interp = ref_kernel(*args, window=window, block_kv=128, interpret=True)
    oracle = decode_attention_ref(*args, window=window)
    for want in (interp, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("window", [None, 40])
def test_ragged_cache_and_per_row_positions(window):
    # a cache length that is no multiple of the kernel's split, a ring
    # buffer that wrapped (positions out of slot order) and one q_pos per row
    b, h, kh, t, d = 3, 10, 2, 200, 64
    q, k, v, _, _ = _inputs(b, h, kh, t, d, t, seed=9)
    rng = np.random.default_rng(1)
    kv_pos = np.stack([np.roll(np.arange(t, dtype=np.int32), r)
                       for r in (0, 17, 150)])
    kv_pos[2, :30] = -1
    q_pos = rng.integers(60, t, size=b).astype(np.int32)
    arrs = (q, k, v, kv_pos, q_pos)
    got = _port(arrs, torch.float32, window=window)
    want = decode_attention_ref(*_ref_args(arrs, jnp.float32), window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL32)


@pytest.mark.parametrize("window", [None, 40])
def test_plain_matches_reference_chunked_attention(window):
    # the reference model attends a decode step over the whole cache with
    # chunked_attention; empty slots sit at position -1
    b, h, kh, t, d, fill = 2, 10, 2, 160, 32, 130
    q, k, v, kv_pos, q_pos = _inputs(b, h, kh, t, d, fill, seed=7)
    want = ref_chunked(jnp.asarray(q)[:, None], jnp.asarray(k),
                       jnp.asarray(v), jnp.asarray(q_pos)[:, None],
                       jnp.asarray(kv_pos), causal=True, window=window,
                       chunk=64)[:, 0]
    got = decode_attention_plain(*(torch.from_numpy(a)
                                   for a in (q, k, v, kv_pos, q_pos)),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_empty_cache_gives_zeros():
    # nothing visible: the -1e4 max clamp keeps p == 0, the 1e-30 divisor
    # clamp keeps the output finite (zero), as in the reference kernel
    q, k, v, kv_pos, q_pos = _inputs(1, 4, 2, 64, 32, 64, seed=2)
    kv_pos[:] = -1
    got = _port((q, k, v, kv_pos, q_pos), torch.float32)
    np.testing.assert_array_equal(got, np.zeros_like(got))


def test_cpu_tensors_run_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(2, 4, 2, 50, 32, 40, 0)]
    before = decode_attention.launches
    assert torch.equal(decode_attention(*args, window=8),
                       decode_attention_plain(*args, window=8))
    assert decode_attention.launches == before


def test_wrapper_rejects_bad_inputs():
    q, k, v, kv_pos, q_pos = (torch.from_numpy(a)
                              for a in _inputs(1, 4, 2, 16, 32, 16, 0))
    with pytest.raises(TypeError):
        decode_attention(q, k, v, kv_pos.long(), q_pos)
    with pytest.raises(ValueError):
        decode_attention(q, k, v, kv_pos[:, :8], q_pos)
    with pytest.raises(ValueError):
        decode_attention(q[:, :3], k, v, kv_pos, q_pos)
    with pytest.raises(TypeError):
        decode_attention(q.bfloat16(), k, v, kv_pos, q_pos)


# --------------------------------------------------------------- the splits
# an H100's 132 SMs at the kernel's three resident blocks per SM (G <= 5)
# and two (G > 5)
@pytest.mark.parametrize("args,want", [
    ((8, 5, 2112, 396), 9),       # hymba-1.5b serving: 360 blocks, one wave
    ((1, 5, 2112, 396), 33),      # batch 1: a chunk each
    ((8, 5, 50, 396), 1),         # T smaller than one 64-slot chunk
    ((1, 5, 18, 396), 1),         # serve's warm-up step
    ((2, 2, 1500, 264), 24),      # G 8
    ((64, 8, 32768, 396), 16),    # no split may take more than 32 chunks
], ids=["serve", "batch1", "short", "short-batch1", "G8", "long"])
def test_split_plan_pins_the_kernel_grid(args, want):
    assert split_plan(*args) == want


@pytest.mark.parametrize("b,kh,resident", [(1, 1, 396), (8, 5, 396),
                                           (4, 2, 264), (64, 8, 396)])
def test_split_plan_stays_in_the_kernel_domain(b, kh, resident):
    for t in (1, 63, 64, 65, 1000, 2112, 70_000):
        ns = split_plan(b, kh, t, resident)
        chunks = -(-t // CHUNK)
        assert 1 <= ns <= chunks
        assert -(-chunks // ns) <= MAX_CHUNKS


@pytest.mark.parametrize("name,value", [("kChunk", CHUNK),
                                        ("kMaxSplit", CHUNK * MAX_CHUNKS),
                                        ("kMaxG", MAX_GROUP),
                                        ("kBlockG", BLOCK_GROUP)])
def test_wrapper_constants_match_the_kernel(name, value):
    # the wrapper plans the grid and checks the domain with its own copies
    src = (_build.CSRC / "decode_attention.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None and int(m.group(1)) == value


def _contiguous(t, width):
    return [torch.arange(s, min(s + width, t)) for s in range(0, t, width)]


def _interleaved(t, ns):
    """The kernel's splits: split s takes 64-slot chunks s, s + ns, ..."""
    chunk = torch.arange(t) // CHUNK
    return [torch.nonzero(chunk % ns == s).flatten() for s in range(ns)]


def _split_then_combine(q, k, v, kv_pos, q_pos, window, splits):
    """A torch emulation of the kernel's arithmetic: per split the running
    max (clamped at -1e4), the sum and the unnormalised accumulator in base
    2 (scores times D^-0.5 log2(e)), then the cross-split merge."""
    b, h, d = q.shape
    g = h // k.shape[2]
    kx = k.permute(0, 2, 1, 3).repeat_interleave(g, 1)     # (B, H, T, D)
    vx = v.permute(0, 2, 1, 3).repeat_interleave(g, 1)
    s2 = torch.einsum("bhd,bhtd->bht", q * (d ** -0.5 / np.log(2)), kx)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        valid &= kv_pos > q_pos[:, None] - window
    floor = -1e4 / np.log(2)
    parts = []
    for idx in splits:
        ok = valid[:, None, idx]
        m = torch.where(ok, s2[..., idx], -torch.inf).amax(-1).clamp_min(floor)
        p = torch.where(ok, torch.exp2(s2[..., idx] - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bht,bhtd->bhd", p,
                                                   vx[:, :, idx])))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    tot = sum(torch.exp2(m - mx) * l for m, l, _ in parts)
    acc = sum(torch.exp2(m - mx)[..., None] * a for m, _, a in parts)
    return acc / tot.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("split", ["64", "320", "T", "kernel"])
def test_split_then_combine_matches_plain(split, window):
    # the ring-buffer inputs, one more row with no slot filled and one whose
    # query comes before every position: those rows' splits are all
    # invisible and must give exact zeros
    b, h, kh, t, d = 5, 10, 2, 700, 64
    q, k, v, _, _ = _inputs(b, h, kh, t, d, t, seed=11)
    kv_pos = np.stack([np.roll(np.arange(t, dtype=np.int32), r)
                       for r in (0, 17, 150, 0, 333)])
    kv_pos[2, :30] = -1
    kv_pos[3] = -1
    q_pos = np.random.default_rng(3).integers(60, t, size=b).astype(np.int32)
    q_pos[4] = -1
    args = [torch.from_numpy(a) for a in (q, k, v, kv_pos, q_pos)]
    splits = {"64": _contiguous(t, 64), "320": _contiguous(t, 320),
              "T": _contiguous(t, t),
              "kernel": _interleaved(t, split_plan(b, kh, t, 60))}[split]
    if split == "kernel":
        assert len(splits) == 6 and t % CHUNK
    got = _split_then_combine(*args, window, splits)
    want = decode_attention_plain(*args, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL32)
    assert torch.equal(got[3:], torch.zeros_like(got[3:]))
    assert torch.equal(want[3:], torch.zeros_like(want[3:]))


def test_head_groups_are_the_fewest_that_fit_a_block():
    # G > 8 query heads of a KV head run as head groups of at most 8, each
    # its own blocks; glm4-9b's G 16 is two groups of 8
    assert head_groups(16) == 2 and head_groups(5) == 1
    for g in range(1, MAX_GROUP + 1):
        n = head_groups(g)
        assert g % n == 0 and g // n <= BLOCK_GROUP
        assert all(g % m or g // m > BLOCK_GROUP for m in range(1, n))
    for g in (0, MAX_GROUP + 1):
        with pytest.raises(ValueError):
            head_groups(g)


def test_head_groups_follow_the_kernel_source():
    # the C side's head_groups: start at ceil(G / kBlockG), step up to a
    # divisor of G
    src = (_build.CSRC / "decode_attention.cu").read_text()
    body = re.search(r"constexpr int head_groups\(int g\) \{(.*?)\n\}", src,
                     re.S)
    assert body is not None
    assert "int n = (g + kBlockG - 1) / kBlockG;" in body.group(1)
    assert "while (g % n) ++n;" in body.group(1)

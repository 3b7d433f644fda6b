"""flash_attention: the port's plain PyTorch version (what the wrapper runs
on CPU tensors) against the JAX package's Pallas kernel in interpret mode,
its pure-jnp oracle and its model-level ``chunked_attention``, on the same
seeded inputs.  Tolerances are the reference's own kernel tolerances
(tests/test_kernels.py): 2e-4 in f32, 2e-2 in bf16 (both sides round the
output to bf16, one ulp of which is ~1e-2 at |x| ~ 2)."""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as ref_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models.attention import chunked_attention as ref_chunked
from repro_torch.kernels.flash_attention.ops import (NEG_INF, flash_attention,
                                                     flash_attention_plain,
                                                     instance)

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"f32": (jnp.float32, torch.float32, TOL32),
          "bf16": (jnp.bfloat16, torch.bfloat16, TOL)}


def _inputs(b, h, kh, s, t, d, seed):
    """q (B, S, H, D), k / v (B, T, K, D) in the model layout, f32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, t, kh, d), dtype=np.float32),
            rng.standard_normal((b, t, kh, d), dtype=np.float32))


def _port(arrs, tdtype, **kw):
    out = flash_attention(*(torch.from_numpy(a).to(tdtype) for a in arrs),
                          **kw)
    assert out.dtype == tdtype
    return out.float().numpy()


def _jax_layout(a, jdtype):
    return jnp.asarray(a, jdtype).transpose(0, 2, 1, 3)   # (B, H/K, S, D)


SHAPES = [   # b, h, kh, s, d, causal, window (tests/test_kernels.py + G=5)
    (1, 2, 2, 128, 32, True, None),
    (2, 4, 2, 256, 64, True, None),
    (1, 2, 1, 256, 32, True, 128),
    (1, 2, 2, 128, 32, False, None),
    (2, 10, 2, 128, 64, True, 64),
    # the dense configs' head dims: D 128 at G 16 (glm4-9b), D 80 (danube)
    (1, 16, 1, 128, 128, True, None),
    (1, 32, 2, 128, 128, True, 64),
    (1, 8, 2, 128, 80, True, None),
    (1, 8, 2, 128, 80, True, 64),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_matches_reference_kernel_and_oracle(shape, dtype):
    b, h, kh, s, d, causal, window = shape
    jdtype, tdtype, tol = DTYPES[dtype]
    arrs = _inputs(b, h, kh, s, s, d, seed=s + h + d)
    got = _port(arrs, tdtype, causal=causal, window=window)
    q, k, v = (_jax_layout(a, jdtype) for a in arrs)
    interp = ref_kernel(q, k, v, causal=causal, window=window, block_q=64,
                        block_kv=64, interpret=True)
    oracle = flash_attention_ref(q, k, v, causal=causal, window=window)
    for want in (interp, oracle):
        want = np.asarray(want.transpose(0, 2, 1, 3), np.float32)
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("s,window", [(100, None), (77, 32)])
def test_ragged_lengths_match_oracle(s, window):
    # the CUDA kernel masks ragged tiles itself, so the wrapper takes any S;
    # the plain version is held on lengths the TPU kernel refuses
    arrs = _inputs(2, 10, 2, s, s, 64, seed=s)
    got = _port(arrs, torch.float32, window=window)
    q, k, v = (_jax_layout(a, jnp.float32) for a in arrs)
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(want.transpose(0, 2, 1, 3)),
                               **TOL32)


@pytest.mark.parametrize("window", [None, 24])
def test_plain_matches_reference_chunked_attention(window):
    # the reference model's attention oracle (online softmax over KV chunks)
    b, h, kh, s, d = 2, 10, 2, 96, 32
    q, k, v = _inputs(b, h, kh, s, s, d, seed=3)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    want = ref_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(pos), jnp.asarray(pos), causal=True,
                       window=window, chunk=32)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)


def test_cpu_tensors_run_the_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(1, 4, 2, 40, 40, 32, 0)]
    before = flash_attention.launches
    by_instance = dict(flash_attention.instance_launches)
    assert torch.equal(flash_attention(*args, window=16),
                       flash_attention_plain(*args, window=16))
    assert flash_attention.launches == before
    assert flash_attention.instance_launches == by_instance


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 32, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 32, "fma"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 80, "fma"), (torch.float32, 128, "fma")])
def test_instance_follows_the_kernel_dispatch(dtype, d, want):
    # flash_attention_launch sends bf16 with head_dim 64, 80 or 128 to the
    # tensor-core instance and f32, and bf16 at head_dim 32, to the
    # CUDA-core one
    assert instance(dtype, d) == want
    assert set(flash_attention.instance_launches) == {"wgmma", "fma"}


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 8, 8, 32, 0))
    with pytest.raises(ValueError):        # H not a multiple of K
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 8, 8, 32, 0))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)


# The bf16 CUDA instance at D 64, 80 and 128 runs both products on the
# tensor cores (csrc/flash_attention.cu, flash_attention_wgmma_kernel<D>):
# scores in fp32 from bf16 q and k, an online softmax over 64-key tiles,
# and P V with the fp32 softmax weights split as P = bf16(P) +
# bf16(P - bf16(P)), two bf16 products summed in fp32.  At D 80 it pads
# q, k and v with zero columns to 128 in shared memory and scales by the
# real 80^-0.5.  The card check (chip_smoke.py) holds a bf16
# output to one bf16 ulp of the plain version (rtol 2^-7, atol 1e-5) with
# at most 1% of the elements differing.  This emulates that arithmetic on
# the CPU and shows that the split meets the rule and a single bf16 P does
# not, so the kernel's design is settled before it runs on the card.
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_DIFF_SHARE = 0.01
TILE = 64


def _emulate_tensor_core_kernel(q, k, v, *, window, weights, pad_to=None,
                                scale_dim=None):
    """q (B, S, H, D), k / v (B, T, K, D) bf16 -> bf16, causal, 64-key
    tiles from key 0, with the softmax weights P of the PV product kept in
    fp32 (``weights="fp32"``, the CUDA-core instance), split hi/lo in bf16
    (``"split"``, the tensor-core instance) or rounded once to bf16
    (``"bf16"``).  A tile that the mask removes for a row leaves that row's
    state as it was, so running every tile is the kernel's skipping loop.
    ``pad_to`` zero-pads q, k and v to that many columns, as the kernel's
    shared-memory tiles do at D 80, and drops the pad from the output; the
    scores are scaled by ``scale_dim ** -0.5``, the real D unless given."""
    d_real = q.shape[3]
    scale = (scale_dim or d_real) ** -0.5
    if pad_to is not None:
        q, k, v = (torch.nn.functional.pad(x, (0, pad_to - d_real))
                   for x in (q, k, v))
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                                # (B, H, S, D)
    kf = k.float().transpose(1, 2).repeat_interleave(h // kh, 1)  # (B, H, T, D)
    vf = v.float().transpose(1, 2).repeat_interleave(h // kh, 1)
    qpos = torch.arange(s)[:, None]
    m = torch.full((b, h, s, 1), NEG_INF)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for t0 in range(0, t, TILE):
        kpos = torch.arange(t0, min(t0 + TILE, t))[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        sc = torch.matmul(qf, kf[:, :, t0:t0 + TILE].transpose(2, 3)) * scale
        sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True)).clamp_min(-1e4)
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = vf[:, :, t0:t0 + TILE]
        if weights == "fp32":
            pv = torch.matmul(p, vt)
        else:
            p_hi = p.bfloat16().float()
            pv = torch.matmul(p_hi, vt)
            if weights == "split":
                pv = pv + torch.matmul((p - p_hi).bfloat16().float(), vt)
        acc = acc * corr + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out[..., :d_real].transpose(1, 2).bfloat16()


def _bf16_rule(got, want):
    """(allclose under the card's bf16 tolerance, share of differing
    elements) of two bf16 outputs."""
    close = bool(torch.allclose(got.float(), want.float(), **BF16_TOL))
    return close, float((got != want).float().mean())


@pytest.mark.parametrize("s,window,h,d", [
    pytest.param(512, None, 5, 64, id="512-None"),
    pytest.param(512, 128, 5, 64, id="512-128"),
    pytest.param(2048, None, 5, 64, id="2048-None"),
    pytest.param(2048, 1024, 5, 64, id="2048-1024"),
    # the dense head dims: D 128 at G 16 (glm4-9b's); D 80 (danube's)
    # global, at its serve-dense-check window and under one 64-key tile,
    # each through the kernel's zero pad to 128 columns
    pytest.param(1024, None, 16, 128, id="1024-None-G16-D128"),
    pytest.param(1024, None, 4, 80, id="1024-None-D80"),
    pytest.param(2048, 1024, 4, 80, id="2048-1024-D80"),
    pytest.param(1024, 40, 4, 80, id="1024-40-D80"),
])
def test_split_softmax_weights_meet_the_card_bf16_rule(s, window, h, d):
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(1, h, 1, s, s, d, seed=21))
    want = flash_attention_plain(q, k, v, window=window)
    pad_to = 128 if d == 80 else None
    shares = {}
    for weights in ("fp32", "split", "bf16"):
        got = _emulate_tensor_core_kernel(q, k, v, window=window,
                                          weights=weights, pad_to=pad_to)
        close, shares[weights] = _bf16_rule(got, want)
        if weights != "bf16":
            assert close, (weights, float((got.float() - want.float())
                                          .abs().max()))
            assert shares[weights] <= BF16_DIFF_SHARE, (weights, shares)
    # one bf16 P loses the weights' low bits, which the rule sees
    assert shares["bf16"] > BF16_DIFF_SHARE, shares
    assert shares["bf16"] > 10 * shares["split"], shares
    print(f"S={s} window={window} share of differing bf16 outputs: "
          f"{shares}")


@pytest.mark.parametrize("window", [None, 40])
def test_padded_head_dim_needs_the_real_scale(window):
    # D 80 runs on 128-column tiles: the zero pad leaves every score as it
    # is, so padding meets the card's bf16 rule with the real 80^-0.5, and
    # the rule sees the trap of scaling by the padded 128^-0.5
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(1, 4, 2, 512, 512, 80, seed=22))
    want = flash_attention_plain(q, k, v, window=window)
    padded = _emulate_tensor_core_kernel(q, k, v, window=window,
                                         weights="split", pad_to=128)
    assert padded.shape == want.shape
    close, share = _bf16_rule(padded, want)
    assert close and share <= BF16_DIFF_SHARE, share
    wrong = _emulate_tensor_core_kernel(q, k, v, window=window,
                                        weights="split", pad_to=128,
                                        scale_dim=128)
    close, share = _bf16_rule(wrong, want)
    assert not close and share > BF16_DIFF_SHARE, share

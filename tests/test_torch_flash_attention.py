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
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)

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
    assert torch.equal(flash_attention(*args, window=16),
                       flash_attention_plain(*args, window=16))
    assert flash_attention.launches == before


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

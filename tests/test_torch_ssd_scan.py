"""ssd_scan: the port's plain PyTorch version (what the wrapper runs on CPU
tensors) against the JAX package's Pallas SSD kernel in interpret mode,
its sequential-recurrence oracle and the model-level ``ssd_chunked`` (for
``y`` and ``h_last``, from a nonzero ``h0``), on the same seeded inputs.

Tolerances are the reference's kernel tolerances (tests/test_kernels.py):
2e-4 in f32, 2e-2 where x is stored in bf16 (the reference kernel also
rounds y to bf16 there; the port returns y in f32)."""

import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as ref_kernel
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.models.ssm import ssd_chunked as ref_chunked
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_plain

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL = dict(rtol=2e-2, atol=2e-2)
TOL32 = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"f32": (jnp.float32, torch.float32, TOL32),
          "bf16": (jnp.bfloat16, torch.bfloat16, TOL)}


def _inputs(b, s, h, p, n, seed, h0_scale=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * 0.5
          ).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * h0_scale).astype(np.float32)
    return x, dt, a, bm, cm, h0


def _port(arrs, tdtype, chunk):
    x, dt, a, bm, cm, h0 = (torch.from_numpy(v) for v in arrs)
    y, h_last = ssd_scan(x.to(tdtype), dt, a, bm, cm, chunk=chunk, h0=h0)
    assert y.dtype == torch.float32 and h_last.dtype == torch.float32
    return y.numpy(), h_last.numpy()


SHAPES = [   # b, s, h, p, n, chunk (tests/test_kernels.py)
    (1, 128, 2, 16, 16, 32),
    (2, 256, 4, 32, 64, 64),
    (1, 64, 1, 64, 128, 64),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_plain_matches_reference_kernel_and_oracle(shape, dtype):
    b, s, h, p, n, chunk = shape
    jdtype, tdtype, tol = DTYPES[dtype]
    arrs = _inputs(b, s, h, p, n, seed=s + h + n)
    y, _ = _port(arrs, tdtype, chunk)
    x, dt, a, bm, cm, _ = arrs
    jx = jnp.asarray(x, jdtype)
    interp = ref_kernel(jx, jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
                        jnp.asarray(cm), chunk=chunk, interpret=True)
    oracle = ssd_scan_ref(jx, jnp.asarray(dt), jnp.asarray(a),
                          jnp.asarray(bm), jnp.asarray(cm))
    for want in (interp, oracle):
        np.testing.assert_allclose(y, np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("s,chunk", [(128, 32), (100, 32), (48, 64)])
def test_state_in_and_out_match_ssd_chunked(s, chunk):
    # nonzero h0; S a multiple of the chunk, ragged, and shorter than it
    arrs = _inputs(2, s, 3, 16, 16, seed=s, h0_scale=0.5)
    y, h_last = _port(arrs, torch.float32, chunk)
    want_y, want_h = ref_chunked(*(jnp.asarray(v) for v in arrs[:5]),
                                 chunk=chunk, h0=jnp.asarray(arrs[5]))
    np.testing.assert_allclose(y, np.asarray(want_y), **TOL32)
    np.testing.assert_allclose(h_last, np.asarray(want_h), **TOL32)


def test_padding_leaves_the_state_unchanged():
    # the tail pads with dt = 0: scanning S steps, or S steps and then
    # padding to a whole chunk, ends in the same state
    arrs = _inputs(1, 40, 2, 16, 16, seed=4, h0_scale=0.5)
    t = [torch.from_numpy(v) for v in arrs]
    y32, h32 = ssd_scan(*t[:5], chunk=32, h0=t[5])
    y64, h64 = ssd_scan(*t[:5], chunk=64, h0=t[5])
    np.testing.assert_allclose(h32.numpy(), h64.numpy(), **TOL32)
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), **TOL32)


def test_cpu_tensors_run_the_plain_version():
    t = [torch.from_numpy(v) for v in _inputs(1, 40, 2, 16, 16, 0, 0.5)]
    before = ssd_scan.launches
    got = ssd_scan(*t[:5], chunk=16, h0=t[5])
    want = ssd_scan_plain(*t[:5], chunk=16, h0=t[5])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ssd_scan.launches == before
    # h0 defaults to zeros
    got0 = ssd_scan(*t[:5], chunk=16)
    want0 = ssd_scan_plain(*t[:5], chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got0, want0))


def test_wrapper_rejects_bad_inputs():
    x, dt, a, bm, cm, h0 = (torch.from_numpy(v)
                            for v in _inputs(1, 16, 2, 16, 8, 0))
    with pytest.raises(TypeError):
        ssd_scan(x, dt.double(), a, bm, cm, chunk=8, h0=h0)
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :8], a, bm, cm, chunk=8, h0=h0)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, bm, cm, chunk=0, h0=h0)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, a, bm, cm, chunk=8, h0=h0)

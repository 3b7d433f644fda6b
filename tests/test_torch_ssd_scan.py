"""ssd_scan: the port's plain PyTorch version (what the wrapper runs on CPU
tensors) against the JAX package's Pallas SSD kernel in interpret mode,
its sequential-recurrence oracle and the model-level ``ssd_chunked`` (for
``y`` and ``h_last``, from a nonzero ``h0``), on the same seeded inputs.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
the plain version there); here a plain-PyTorch model of its three passes
(state, chain, output) is held against the same references, its split
tensor-core products are emulated against the card's f32 check, and the
shape domain of the kernel is pinned.

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


# ---------------------------------------------------------------------------
# The CUDA kernel's decomposition (csrc/ssd_scan.cu), in plain PyTorch: a
# state pass per chunk, a chain pass over the chunks, an output pass per
# chunk.  ``mm`` is the output pass's product (C B^T, C h^T, and att . x
# unless ``mm_x`` is given).

def _three_passes(x, dt, a, bm, cm, *, chunk, h0, mm=torch.matmul,
                  mm_x=None):
    b, s, nh, p = x.shape
    n = bm.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    F = torch.nn.functional
    x = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dt = F.pad(dt, (0, 0, 0, pad))
    bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    L = chunk
    xc = x.reshape(b, nc, L, nh, p).permute(0, 3, 1, 2, 4)   # (B,H,c,L,P)
    dtc = dt.reshape(b, nc, L, nh).permute(0, 3, 1, 2)        # (B,H,c,L)
    bc = bm.reshape(b, 1, nc, L, n)
    cc = cm.reshape(b, 1, nc, L, n)
    cum = torch.cumsum(a[None, :, None, None] * dtc, dim=-1)
    # 1. state pass: each chunk's own contribution, and its decay
    w = torch.exp(cum[..., -1:] - cum) * dtc
    states = (xc * w[..., None]).transpose(-1, -2) @ bc        # (B,H,c,P,N)
    decay = torch.exp(cum[..., -1])
    # 2. chain pass: the state entering each chunk, and the last state
    h, h_in = h0, []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, :, c, None, None] * h + states[:, :, c]
    h_in = torch.stack(h_in, dim=2)
    # 3. output pass
    tril = torch.ones((L, L), dtype=torch.bool).tril()
    gate = torch.where(tril, torch.exp(cum[..., :, None] - cum[..., None, :]),
                       torch.zeros(()))
    att = mm(cc, bc.transpose(-1, -2)) * gate * dtc[..., None, :]
    y = (mm_x or mm)(att, xc) + torch.exp(cum)[..., None] * mm(
        cc, h_in.transpose(-1, -2))
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * L, nh, p)[:, :s]
    return y, h


PASS_CASES = {   # b, s, h, p, n, chunk, h0 scale
    "h0": (2, 128, 3, 16, 16, 32, 0.5),
    "ragged": (2, 100, 3, 32, 16, 32, 0.5),
    "shorter-than-chunk": (1, 24, 2, 16, 8, 64, 0.5),
    "one-chunk": (1, 64, 2, 64, 16, 64, 0.5),
    "zero-h0": (1, 128, 2, 64, 16, 64, 0.0),
}


@pytest.mark.parametrize("case", list(PASS_CASES))
def test_three_passes_match_plain_and_reference(case):
    b, s, h, p, n, chunk, h0_scale = PASS_CASES[case]
    arrs = _inputs(b, s, h, p, n, seed=s + p, h0_scale=h0_scale)
    t = [torch.from_numpy(v) for v in arrs]
    y, h_last = _three_passes(*t[:5], chunk=chunk, h0=t[5])
    want_y, want_h = ssd_scan_plain(*t[:5], chunk=chunk, h0=t[5])
    torch.testing.assert_close(y, want_y, **TOL32)
    torch.testing.assert_close(h_last, want_h, **TOL32)
    ref_y, ref_h = ref_chunked(*(jnp.asarray(v) for v in arrs[:5]),
                               chunk=chunk, h0=jnp.asarray(arrs[5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL32)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(ref_h), **TOL32)
    if h0_scale == 0.0 and s % chunk == 0:   # the TPU kernel's own domain
        interp = ref_kernel(*(jnp.asarray(v) for v in arrs[:5]), chunk=chunk,
                            interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(interp), **TOL32)


def _tf32(v):
    """Round to 10 mantissa bits, ties away from zero (the kernel's
    ``split``: add half a TF32 ulp to the bits, clear the low 13)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(v):
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split_mm(a, b):
    """The kernel's product: each operand split into hi = TF32(v) and
    lo = v - hi, three TF32 products (lo.hi, hi.lo, hi.hi; exact in fp32)
    summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _bf16x3_mm(att, x):
    """The kernel's att . x for bf16 x (exact in bf16): att split into
    three bf16 pieces, each the rounding of what the ones before leave,
    three bf16 products (exact in fp32) summed in fp32."""
    pieces, rest = [], att
    for _ in range(3):
        pieces.append(rest.to(torch.bfloat16).float())
        rest = rest - pieces[-1]
    return sum(p @ x for p in reversed(pieces))


def _one_rounding_mm(a, b):
    return _tf32(a) @ _tf32(b)


def _serving_like(seed, s=512, h=2):
    """chip_smoke.py's ssd inputs (hymba's SSM widths, chunk 256)."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    x = randn(1, s, h, 64)
    dt = torch.nn.functional.softplus(randn(1, s, h) - 1.0)
    a = -torch.exp(randn(h, scale=0.3))
    bm, cm = randn(1, s, 16, scale=0.3), randn(1, s, 16, scale=0.3)
    return x, dt, a, bm, cm, randn(1, h, 64, 16, scale=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_tf32_meets_the_card_check(dtype):
    # the card holds the kernel against ssd_scan_plain at TOL32; the split
    # products pass that check here (split TF32 for C B^T and C h^T, and
    # for att . x with f32 x; att in three bf16 pieces for bf16 x), one
    # TF32 rounding does not
    x, dt, a, bm, cm, h0 = _serving_like(18)
    x = x.to(dtype)
    want = ssd_scan_plain(x, dt, a, bm, cm, chunk=256, h0=h0)
    bits = _tf32(torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11]))
    assert bits.tolist() == [1.0 + 2.0 ** -10, 1.0 + 4 * 2.0 ** -11]
    assert torch.equal(x.float().to(torch.bfloat16).float(), x.float()) \
        == (dtype == torch.bfloat16)
    mm_x = _bf16x3_mm if dtype == torch.bfloat16 else _split_mm
    split = _three_passes(x, dt, a, bm, cm, chunk=256, h0=h0, mm=_split_mm,
                          mm_x=mm_x)
    for got, w in zip(split, want):
        torch.testing.assert_close(got, w, **TOL32)
    one = _three_passes(x, dt, a, bm, cm, chunk=256, h0=h0,
                        mm=_one_rounding_mm)
    assert not torch.allclose(one[0], want[0], **TOL32)


def test_kernel_domain_predicate():
    from repro_torch.kernels.ssd_scan.ops import kernel_takes

    # every shape the card checks launch (chip_smoke.py), and the edges;
    # mamba2's N 128 at chunk 256 runs its passes at chunk 128
    for p, n, chunk in [(64, 16, 256), (16, 16, 256), (32, 16, 256),
                        (64, 64, 64), (64, 128, 128), (64, 64, 256),
                        (32, 12, 128), (64, 16, 1), (16, 1, 16),
                        (64, 128, 256), (64, 65, 256), (16, 128, 256),
                        (64, 1, 256), (32, 120, 200)]:
        assert kernel_takes(p, n, chunk), (p, n, chunk)
    # past the domain's edges: refused, not launched
    for p, n, chunk in [(64, 16, 257), (64, 129, 16), (64, 129, 256),
                        (48, 16, 256), (48, 128, 256), (128, 16, 64),
                        (8, 16, 64), (64, 16, 0), (64, 0, 64)]:
        assert not kernel_takes(p, n, chunk), (p, n, chunk)


def test_run_chunk_fits_the_output_pass():
    import re
    from pathlib import Path

    from repro_torch.kernels.ssd_scan.ops import (MAX_CHUNK, MAX_STATE,
                                                  MAX_TILE, run_chunk)

    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "csrc" / "ssd_scan.cu").read_text()
    limits = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                  src).group(1))
              for name in ("kMaxChunk", "kMaxState", "kMaxTile")}
    assert limits == {"kMaxChunk": MAX_CHUNK, "kMaxState": MAX_STATE,
                      "kMaxTile": MAX_TILE}
    # the requested chunk stays while its output pass fits (hymba's N 16,
    # N 64 at 256), else the largest multiple of 16 that fits
    assert [run_chunk(n, c) for n, c in [(16, 256), (64, 256), (128, 128),
                                         (128, 256), (65, 256), (120, 200),
                                         (128, 129)]] == \
        [256, 256, 128, 128, 224, 128, 128]

    def pad(v, m):
        return -(-v // m) * m

    for n in range(1, MAX_STATE + 1):
        for chunk in range(1, MAX_CHUNK + 1):
            r = run_chunk(n, chunk)
            assert pad(r, 16) * pad(n, 8) <= MAX_TILE, (n, chunk)
            assert r == chunk or (r % 16 == 0 and 128 <= r < chunk), \
                (n, chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_passes_at_the_run_chunk_meet_the_card_check(dtype):
    # mamba2's SSM widths (P 64, N 128) at chunk 256: the kernel runs its
    # passes at chunk 128 with its split products; from a nonzero h0 over a
    # ragged last chunk, y and h_last still meet the card's check against
    # the plain version at the requested chunk 256
    from repro_torch.kernels.ssd_scan.ops import run_chunk

    g = torch.Generator().manual_seed(26)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    s, h = 600, 2
    x = randn(1, s, h, 64).to(dtype)
    dt = torch.nn.functional.softplus(randn(1, s, h) - 1.0)
    a = -torch.exp(randn(h, scale=0.3))
    bm, cm = randn(1, s, 128, scale=0.3), randn(1, s, 128, scale=0.3)
    h0 = randn(1, h, 64, 128, scale=0.1)
    assert run_chunk(128, 256) == 128
    want = ssd_scan_plain(x, dt, a, bm, cm, chunk=256, h0=h0)
    mm_x = _bf16x3_mm if dtype == torch.bfloat16 else _split_mm
    got = _three_passes(x, dt, a, bm, cm, chunk=128, h0=h0, mm=_split_mm,
                        mm_x=mm_x)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, **TOL32)
    # the check sees a dropped h0 at these widths (in y: h0 has decayed
    # away by the last state)
    no_h0 = ssd_scan_plain(x, dt, a, bm, cm, chunk=256)
    assert not torch.allclose(no_h0[0], want[0], **TOL32)

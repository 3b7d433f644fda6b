"""ssd_scan's backward on the CPU: ``ssd_scan_bwd_plain`` (the closed form
that the wrapper runs on CPU tensors and that the card check holds the
CUDA kernel to) against ``jax.vjp`` of the reference's ``ssd_chunked``
(what the reference's training differentiates) and against
``torch.autograd.grad`` through ``ssd_scan_plain``, on the same seeded
inputs, each of dx, ddt, da, dB, dC and dh0 within 1e-4 of its largest
|value| in f32.  N 16 at chunk 32, N 128 at chunk 256, a ragged S, an
odd N, a nonzero h0 with and without dh_last.

The CUDA kernel (``csrc/ssd_scan_bwd.cu``) runs only on the card
(``chip_smoke.py`` holds it against the plain version there); here a
plain-PyTorch model of its steps (the chunk states and their chains, the
gradient pass over each batch row's heads, the reduction) at its own
chunk, reading the forward's y, is held against the same references,
as is that model with the card's split products emulated; the CUDA
route's autograd wiring is checked with the launches replaced by the
plain versions, and the entry point's signature is parsed from the
source."""

import inspect
import re

import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as ref_chunked
from repro_torch import _build
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ops import (BWD_CHUNK, ssd_scan,
                                              ssd_scan_bwd,
                                              ssd_scan_bwd_plain,
                                              ssd_scan_plain)

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL = 1e-4
NAMES = ("dx", "ddt", "da", "dB", "dC", "dh0")
# b, s, h, p, n, chunk, h0 scale, dh_last given.  dt is the model's
# softplus(. - 2) at chunk 256: over a whole chunk a larger a dt drives
# exp(cum_t - cum_u) past the f32 range in the masked half of the
# reference's gate, whose gradient is then inf * 0
CASES = {
    "N16.L32": (2, 128, 3, 16, 16, 32, 0.5, True),
    "N128.L256": (1, 512, 2, 16, 128, 256, 0.5, True),
    "ragged": (2, 100, 3, 32, 12, 32, 0.5, True),
    "no-dh_last": (1, 96, 2, 16, 16, 32, 0.5, False),
    "N13.L64": (1, 200, 3, 64, 13, 64, 0.5, True),
}


def _inputs(b, s, h, p, n, chunk, h0_scale, with_dh, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    shift = 2.0 if chunk > 64 else 0.0
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - shift)).astype(
        np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((b, h, p, n)) * h0_scale).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dh = (rng.standard_normal((b, h, p, n)).astype(np.float32) if with_dh
          else None)
    return (x, dt, a, bm, cm, h0), dy, dh


def _case(name):
    b, s, h, p, n, chunk, h0_scale, with_dh = CASES[name]
    arrs, dy, dh = _inputs(b, s, h, p, n, chunk, h0_scale, with_dh,
                           seed=s + n)
    return chunk, arrs, dy, dh


def _torch(arrs):
    return [torch.from_numpy(v) for v in arrs]


def _reference(arrs, dy, dh, chunk):
    """jax.vjp of the reference's ssd_chunked at (dy, dh_last)."""
    def f(x, dt, a, bm, cm, h0):
        return ref_chunked(x, dt, a, bm, cm, chunk, h0)

    _, vjp = jax.vjp(f, *(jnp.asarray(v) for v in arrs))
    dh = np.zeros_like(arrs[5]) if dh is None else dh
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


def _assert_close(got, want, tol=TOL):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{name}: {err:.3g} of its largest |value|"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_reference_vjp(case):
    chunk, arrs, dy, dh = _case(case)
    t = _torch(arrs)
    got = ssd_scan_bwd_plain(*t[:5], torch.from_numpy(dy), chunk=chunk,
                             h0=t[5],
                             dh_last=None if dh is None
                             else torch.from_numpy(dh))
    assert all(g.dtype == torch.float32 for g in got)
    _assert_close([g.numpy() for g in got], _reference(arrs, dy, dh, chunk))


@pytest.mark.parametrize("case", ["N16.L32", "ragged", "no-dh_last"])
def test_plain_backward_matches_autograd(case):
    chunk, arrs, dy, dh = _case(case)
    leaves = [v.requires_grad_(True) for v in _torch(arrs)]
    y, h_last = ssd_scan_plain(*leaves[:5], chunk=chunk, h0=leaves[5])
    loss = (y * torch.from_numpy(dy)).sum()
    if dh is not None:
        loss = loss + (h_last * torch.from_numpy(dh)).sum()
    want = torch.autograd.grad(loss, leaves)
    got = ssd_scan_bwd_plain(*(v.detach() for v in leaves[:5]),
                             torch.from_numpy(dy), chunk=chunk,
                             h0=leaves[5].detach(),
                             dh_last=None if dh is None
                             else torch.from_numpy(dh))
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want])


def test_bf16_x_gets_a_bf16_dx():
    chunk, arrs, dy, dh = _case("N16.L32")
    t = _torch(arrs)
    xb = t[0].to(torch.bfloat16)
    got = ssd_scan_bwd_plain(xb, *t[1:5], torch.from_numpy(dy), chunk=chunk,
                             h0=t[5], dh_last=torch.from_numpy(dh))
    want = ssd_scan_bwd_plain(xb.float(), *t[1:5], torch.from_numpy(dy),
                              chunk=chunk, h0=t[5],
                              dh_last=torch.from_numpy(dh))
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], want[0].to(torch.bfloat16))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


def test_the_cpu_wrapper_differentiates_the_plain_forward():
    chunk, arrs, dy, dh = _case("ragged")
    leaves = [v.requires_grad_(True) for v in _torch(arrs)]
    y, h_last = ssd_scan(*leaves[:5], chunk=chunk, h0=leaves[5])
    assert y.grad_fn is not None
    assert type(y.grad_fn).__name__ != "_SSDScanBackward"
    loss = (y * torch.from_numpy(dy)).sum() + (
        h_last * torch.from_numpy(dh)).sum()
    got = torch.autograd.grad(loss, leaves)
    want = ssd_scan_bwd(*(v.detach() for v in leaves[:5]),
                        torch.from_numpy(dy), chunk=chunk,
                        h0=leaves[5].detach(), dh_last=torch.from_numpy(dh))
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want])


def test_the_wrapper_checks_its_inputs():
    chunk, arrs, dy, dh = _case("no-dh_last")
    t = _torch(arrs)
    dy = torch.from_numpy(dy)
    with pytest.raises(ValueError):
        ssd_scan_bwd(*t[:5], dy[:, :8], chunk=chunk, h0=t[5])
    with pytest.raises(TypeError):
        ssd_scan_bwd(*t[:5], dy.double(), chunk=chunk, h0=t[5])
    with pytest.raises(ValueError):
        ssd_scan_bwd(*t[:5], dy, chunk=chunk, h0=t[5], y=dy[:, 1:])
    # y, when given, is checked and not needed on CPU tensors
    y, _ = ssd_scan_plain(*t[:5], chunk=chunk, h0=t[5])
    with_y = ssd_scan_bwd(*t[:5], dy, chunk=chunk, h0=t[5], y=y)
    without = ssd_scan_bwd(*t[:5], dy, chunk=chunk, h0=t[5])
    assert all(torch.equal(a, b) for a, b in zip(with_y, without))


# ---------------------------------------------------------------------------
# The CUDA kernel's steps (csrc/ssd_scan_bwd.cu), in plain PyTorch at the
# kernel's chunk: the chunk states and their reverse counterparts and the
# chains from h0 and dh_last (one pass on the card, which walks the chunks
# of each head), the gradient pass per (chunk, batch row) over
# its heads (B C^T once, the gated dy x^T summed over the heads into M, the
# rank-P parts of dC and dB summed over the heads, the triangles M B and
# M^T C once, dcum from the forward's y and <g, h> from h_c and B g^T),
# then da over batch and chunks.  ``mm`` takes the products of two f32
# operands, ``mm_x`` those against x, x the second operand (the card's
# split products are emulated by passing them).

def _four_passes(x, dt, a, bm, cm, dy, y, *, h0, dh_last, mm=torch.matmul,
                 mm_x=None):
    mm_x = mm if mm_x is None else mm_x
    b, s, nh, p = x.shape
    n = bm.shape[-1]
    L = BWD_CHUNK
    nc = -(-s // L)
    pad = nc * L - s
    F = torch.nn.functional

    def per_head(t):   # (B, S, H, P) -> (B, H, c, L, P), zeros past S
        t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(b, nc, L, nh, -1).permute(0, 3, 1, 2, 4)

    def shared(t):     # (B, S, N) -> (B, 1, c, L, N)
        return F.pad(t, (0, 0, 0, pad)).reshape(b, 1, nc, L, n)

    def tr(t):
        return t.transpose(-1, -2)

    xc, dyc, yc = per_head(x.float()), per_head(dy), per_head(y)
    dtc = per_head(dt[..., None])[..., 0]
    bc, cc = shared(bm), shared(cm)
    cum = torch.cumsum(a[None, :, None, None] * dtc, dim=-1)
    tail = torch.exp(cum[..., -1:] - cum)
    ecum = torch.exp(cum)
    w = tail * dtc
    # 1. state pass: x^T (w B) against x, dy^T (e C), ...
    s_own = tr(mm_x(tr(w[..., None] * bc), xc))
    s_rev = mm(tr(dyc), ecum[..., None] * cc)
    decay = torch.exp(cum[..., -1])
    # ... and the chains
    h, hs = h0, []
    for c in range(nc):
        hs.append(h)
        h = decay[:, :, c, None, None] * h + s_own[:, :, c]
    g = torch.zeros_like(h0) if dh_last is None else dh_last
    gs = [None] * nc
    for c in reversed(range(nc)):
        gs[c] = g
        g = decay[:, :, c, None, None] * g + s_rev[:, :, c]
    dh0 = g
    hc, gn = (torch.stack(v, dim=2) for v in (hs, gs))
    # 2. gradient pass: B C^T once a batch row; per head
    tril = torch.ones((L, L), dtype=torch.bool).tril()
    gate = torch.where(tril, torch.exp(cum[..., :, None] - cum[..., None, :]),
                       torch.zeros(()))                       # [t][u]
    att_t = mm(bc, tr(cc)) * tr(gate)                         # [u][t]
    mgate = mm_x(dyc, tr(xc)) * gate * dtc[..., None, :]      # [t][u]
    m_sum = mgate.sum(1, keepdim=True)                        # M
    bg = mm(bc, tr(gn))                                       # (B g^T)[u][p]
    dxh = mm(att_t, dyc) + tail[..., None] * bg
    dxc = dxh * dtc[..., None]
    dc_rank = mm(ecum[..., None] * dyc, hc).sum(1)
    db_rank = (w[..., None] * tr(mm_x(tr(gn), tr(xc)))).sum(1)
    dcc = mm(m_sum, bc)[:, 0] + dc_rank
    dbc = mm(tr(m_sum), cc)[:, 0] + db_rank
    rdot = (xc * dxh).sum(-1)
    ghn = decay * (gn * hc).sum((-2, -1)) + (w * (xc * bg).sum(-1)).sum(-1)
    dcum = (dyc * yc).sum(-1) - dtc * rdot
    dcum[..., -1] += ghn
    r = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddtc = rdot + a[None, :, None, None] * r
    # 3. reduction: da over batch and chunks
    da = (dtc * r).sum((0, 2, 3))

    def back(t, *tail_shape):   # (B, H, c, L, ...) -> (B, S, H, ...)
        t = t.permute(0, 2, 3, 1, *range(4, t.dim()))
        return t.reshape(b, nc * L, nh, *tail_shape)[:, :s]

    db = dbc.reshape(b, nc * L, n)[:, :s]
    dc = dcc.reshape(b, nc * L, n)[:, :s]
    return (back(dxc, p).to(x.dtype), back(ddtc), da, db, dc, dh0)


@pytest.mark.parametrize("case", list(CASES))
def test_four_passes_match_plain_and_reference(case):
    chunk, arrs, dy, dh = _case(case)
    t = _torch(arrs)
    dyt = torch.from_numpy(dy)
    dht = None if dh is None else torch.from_numpy(dh)
    # the forward's y at the requested chunk; the passes run at their own
    y, _ = ssd_scan_plain(*t[:5], chunk=chunk, h0=t[5])
    got = _four_passes(*t[:5], dyt, y, h0=t[5], dh_last=dht)
    want = ssd_scan_bwd_plain(*t[:5], dyt, chunk=chunk, h0=t[5],
                              dh_last=dht)
    _assert_close([g.numpy() for g in got], [w.numpy() for w in want])
    _assert_close([g.numpy() for g in got], _reference(arrs, dy, dh, chunk))


def _tf32(v):
    """Round to 10 mantissa bits, ties away from zero (the kernel's
    ``split``: add half a TF32 ulp to the bits, clear the low 13)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(v):
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split_mm(a, b):
    """The kernel's split-TF32 product: each operand split into hi =
    TF32(v) and lo = v - hi, three TF32 products (lo.hi, hi.lo, hi.hi;
    exact in fp32) summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _bf16x3_mm(a, x):
    """The kernel's product against bf16 x (exact in bf16): the other
    operand split into three bf16 pieces, each the rounding of what the
    ones before leave, three bf16 products summed in fp32."""
    pieces, rest = [], a
    for _ in range(3):
        pieces.append(rest.to(torch.bfloat16).float())
        rest = rest - pieces[-1]
    return sum(piece @ x for piece in reversed(pieces))


def _one_rounding_mm(a, b):
    return _tf32(a) @ _tf32(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_products_meet_the_card_check(dtype):
    # chip_smoke.py holds the kernel against ssd_scan_bwd_plain by
    # _ssd_bwd_err; at mamba2's widths (P 64, N 128, the passes at chunk
    # 64) and its kernels rows' input scales, the passes with split-TF32
    # products (and bf16 pieces against bf16 x) pass that check, and with
    # one TF32 rounding of the same products they do not
    cs = _chip_smoke()
    rng = np.random.default_rng(38)
    b, s, h, p, n = 1, 256, 2, 64, 128

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale))

    x = randn(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, s, h) - 2.0)
    a = -torch.exp(randn(h, scale=0.3))
    bm, cm = randn(b, s, n, scale=0.3), randn(b, s, n, scale=0.3)
    h0, dy = randn(b, h, p, n, scale=0.1), randn(b, s, h, p)
    dh = randn(b, h, p, n, scale=0.1)
    y, _ = ssd_scan_plain(x, dt, a, bm, cm, chunk=256, h0=h0)
    want = ssd_scan_bwd_plain(x, dt, a, bm, cm, dy, chunk=256, h0=h0,
                              dh_last=dh)
    mm_x = _bf16x3_mm if dtype == torch.bfloat16 else _split_mm
    split = _four_passes(x, dt, a, bm, cm, dy, y, h0=h0, dh_last=dh,
                         mm=_split_mm, mm_x=mm_x)
    assert cs._ssd_bwd_err(torch, split, want) <= 1.0
    one = _four_passes(x, dt, a, bm, cm, dy, y, h0=h0, dh_last=dh,
                       mm=_one_rounding_mm)
    assert cs._ssd_bwd_err(torch, one, want) > 1.0


def test_the_cuda_route_runs_the_backward_through_the_function(monkeypatch):
    # _SSDScan on CPU tensors, its launches replaced by the plain versions:
    # serving calls (no grad mode, or no input needing one) launch the
    # passes as they are; a call that needs a gradient goes through the
    # Function, whose backward gets the forward's y and a None dh_last
    # when h_last is not used
    calls, seen = [], []

    def launch(x, dt, a, bm, cm, h0, chunk):
        calls.append(torch.is_grad_enabled())
        return ssd_scan_plain(x, dt, a, bm, cm, chunk=chunk, h0=h0)

    def bwd(x, dt, a, bm, cm, dy, *, chunk, h0, dh_last, y):
        seen.append((y, dh_last))
        return ssd_scan_bwd_plain(x, dt, a, bm, cm, dy, chunk=chunk, h0=h0,
                                  dh_last=dh_last)

    monkeypatch.setattr(ssd_ops, "_launch", launch)
    monkeypatch.setattr(ssd_ops, "_check", lambda *_: torch.device("cuda"))
    monkeypatch.setattr(ssd_ops, "ssd_scan_bwd", bwd)
    chunk, arrs, dy, _ = _case("ragged")
    leaves = [v.requires_grad_(True) for v in _torch(arrs)]
    with torch.no_grad():
        out = ssd_ops.ssd_scan(*leaves[:5], chunk=chunk, h0=leaves[5])
    assert out[0].grad_fn is None
    out = ssd_ops.ssd_scan(*(v.detach() for v in leaves[:5]), chunk=chunk,
                           h0=leaves[5].detach())
    assert out[0].grad_fn is None and len(calls) == 2
    y, _ = ssd_ops.ssd_scan(*leaves[:5], chunk=chunk, h0=leaves[5])
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert len(calls) == 3 and len(seen) == 1
    want_y, _ = ssd_scan_plain(*(v.detach() for v in leaves[:5]),
                               chunk=chunk, h0=leaves[5].detach())
    assert torch.equal(seen[0][0], want_y) and seen[0][1] is None
    want = ssd_scan_bwd_plain(*(v.detach() for v in leaves[:5]),
                              torch.from_numpy(dy), chunk=chunk,
                              h0=leaves[5].detach())
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_the_cuda_backward_needs_the_forwards_y():
    # on CUDA tensors the wrapper raises without y before any launch, and
    # nothing falls back to the plain version
    src = inspect.getsource(ssd_scan_bwd)
    cpu = src.index('if dev.type == "cpu":')
    refuse = src.index("if y is None:")
    launch = src.index("_build.lib()")
    assert cpu < refuse < launch
    assert "raise ValueError" in src[refuse:launch]
    assert "ssd_scan_bwd_plain" not in src[refuse:]
    assert "backward_launches += 1" in src[launch:]


def test_the_backward_source_is_built_and_bound():
    assert "ssd_scan_bwd.cu" in _build.SOURCES
    src = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    assert int(re.search(r"constexpr int kBwdChunk = (\d+);", src).group(1)
               ) == BWD_CHUNK
    args, _ = _build._SIGNATURES["ssd_scan_bwd_launch"]
    sig = re.search(r'extern "C" int ssd_scan_bwd_launch\(([^)]*)\)',
                    src).group(1)
    params = [q.strip() for q in sig.split(",")]
    assert len(params) == len(args) == 24
    assert [("*" in q) for q in params] == [t is _build._P for t in args]
    assert params[8] == "const void* dh_last"
    for name in ("ssd_scan_bwd_workspace", "ssd_scan_bwd_grad_smem_bytes"):
        args, _ = _build._SIGNATURES[name]
        sig = re.search(rf'extern "C" \w+(?: \w+)? {name}\(([^)]*)\)',
                        src).group(1)
        assert len([q for q in sig.split(",") if q.strip()]) == len(args)


# ---------------------------------------------------------------------------
# chip_smoke.py's constants for the backward: the kernels rows sit at the
# configs' training shapes, the train-ssm phase trains mamba2-2.7b as
# published, the bound counts each product once.

def _chip_smoke():
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_backward_rows_sit_at_the_training_shapes():
    from repro.configs import get_config as ref_get_config
    from repro_torch.kernels.ssd_scan.ops import kernel_takes

    cs = _chip_smoke()
    rows = {r[0]: r[1:] for r in cs.SSD_BWD}
    for arch in ("mamba2-2.7b", "hymba-1.5b"):
        cfg = ref_get_config(arch)
        s = cfg.ssm
        nh = s.num_heads or cfg.d_model * s.expand // s.head_dim
        assert rows[arch][:7] == (cs.TRAIN["batch"], cs.TRAIN["seq"], nh,
                                  s.head_dim, s.state_dim, s.chunk_size,
                                  ("bf16", "f32"))
    assert rows["mamba2-2.7b"][2:5] == (80, 64, 128)
    assert rows["hymba-1.5b"][2:5] == (50, 64, 16)
    for label, b, s, h, p, n, chunk, tags, _ in cs.SSD_BWD:
        assert kernel_takes(p, n, chunk), label
    # every (x dtype, P) instance of the state and gradient passes runs
    ran = {(dt, r[4]) for r in cs.SSD_BWD for dt in r[7]}
    assert ran == {(dt, p) for _, dt, p in cs.SSD_BWD_INSTANCES
                   if dt is not None}
    assert any(not r[8] for r in cs.SSD_BWD)            # dh_last None
    assert any(r[2] % BWD_CHUNK for r in cs.SSD_BWD)    # a ragged last chunk
    assert any(r[5] % 4 for r in cs.SSD_BWD)            # rows of 4-byte pieces
    assert set(cs.SSD_BWD_PROFILED) == {"mamba2-2.7b", "hymba-1.5b"}


def test_backward_instances_parse_from_ptxas_names():
    cs = _chip_smoke()
    assert len(cs.SSD_BWD_INSTANCES) == 13
    assert cs.SSD_BWD_PASSES == ("state", "grad", "reduce")
    assert cs._ssd_bwd_instance(
        "_ZN12_GLOBAL__N_119ssd_bwd_grad_kernelI13__nv_bfloat16Li64EEEvPKT_"
    ) == ("grad", "bf16", 64)
    assert cs._ssd_bwd_instance(
        "_ZN12_GLOBAL__N_120ssd_bwd_state_kernelIfLi16EEEvPKT_PKfS5_") == (
        "state", "f32", 16)
    assert cs._ssd_bwd_instance(
        "_ZN12_GLOBAL__N_121ssd_bwd_reduce_kernelEPKfPfiii") == (
        "reduce", None, None)
    # the chains run inside the state pass: no chain pass is built
    assert cs._ssd_bwd_instance(
        "_ZN12_GLOBAL__N_120ssd_bwd_chain_kernelEPKfS1_PfS2_S1_S2_xii") \
        is None
    # the forward's names are not the backward's, nor the reverse
    assert cs._ssd_bwd_instance(
        "_ZN12_GLOBAL__N_121ssd_scan_state_kernelIfLi16EEEvPKT_") is None
    assert cs._ssd_instance(
        "_ZN12_GLOBAL__N_119ssd_bwd_grad_kernelIfLi64EEEvPKT_") is None


def test_backward_bound_and_tolerance():
    cs = _chip_smoke()
    B, S, H, P, N = 8, 1024, 80, 64, 128
    L = BWD_CHUNK
    chunks = B * (S // L)
    nch = chunks * H
    tri = L * (L + 1) / 2
    # each split product is three products on the tensor cores.  Against
    # bf16 x, x^T (w B), x g and the gated dy x^T are bf16; split TF32 are,
    # per head, dy^T (e C), dy h_c and dxh (a triangle and a rank-N
    # product), and per batch row, as B and C are shared by the heads, C
    # B^T and the dC and dB triangles; the chains on the CUDA cores
    vs_x = 6 * nch * (2 * L * P * N + tri * P)
    tf32 = 6 * (nch * (2 * L * P * N + tri * P + L * N * P)
                + chunks * 3 * tri * N)
    chain = 4 * nch * P * N
    work = cs._ssd_bwd_work(True, B, S, H, P, N, L)
    assert [peak for _, peak in work] == [
        cs.TF32_OPS_PER_S, cs.BF16_OPS_PER_S, cs.FP32_OPS_PER_S]
    assert [ops for ops, _ in work] == pytest.approx([tf32, vs_x, chain])
    # f32 x: every product split TF32
    work32 = cs._ssd_bwd_work(False, B, S, H, P, N, L)
    assert [ops for ops, _ in work32] == pytest.approx(
        [tf32 + vs_x, 0.0, chain])
    # the shared products are counted once a batch row, not once a head
    assert sum(o for o, _ in cs._ssd_bwd_work(True, B, S, 2 * H, P, N, L)) \
        < 2 * sum(o for o, _ in work)
    # ~105 GFLOP of TF32 and ~73 of bf16: 0.29 ms at the tensor-core
    # peaks (0.36 for f32 x), above the bytes' time
    assert tf32 == pytest.approx(105.4e9, rel=0.01)
    assert vs_x == pytest.approx(72.6e9, rel=0.01)
    ms, by = cs._bound_ms_by_type(0.5e9, work)
    assert by == "operations" and ms == pytest.approx(0.29, abs=0.01)
    ms, by = cs._bound_ms_by_type(0.5e9, work32)
    assert by == "operations" and ms == pytest.approx(0.36, abs=0.01)
    assert cs.SSD_BWD_TOL32 == 1e-4
    assert cs.SSD_BWD_TOL_BF16 == (2.0 ** -7, 1e-4)
    want = torch.tensor([1.0, -0.5, 0.0])
    off = want + torch.tensor([0.0, 0.0, 1e-4])
    assert cs._ssd_bwd_err(torch, [off], [want]) == pytest.approx(1.0)
    bf = torch.tensor([1.0, 0.5], dtype=torch.bfloat16)
    wide = torch.tensor([1.0 / (1.0 + 2.0 ** -7 + 1e-4), 0.5])
    assert cs._ssd_bwd_err(torch, [bf], [wide]) == pytest.approx(1.0,
                                                                 rel=1e-3)
    assert set(cs.SSD_BWD_WRONG) == {"no_h0", "no_dh_last"}


def test_train_ssm_phase_is_mamba2_at_full_width_and_depth():
    import dataclasses

    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    cs = _chip_smoke()
    cfg = get_config(cs.TRAIN_SSM_ARCH)
    assert cs.TRAIN_SSM_ARCH == "mamba2-2.7b"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_get_config("mamba2-2.7b"))
    assert (cfg.num_layers, cfg.d_model, cfg.ssm.state_dim,
            cfg.ssm.head_dim, cfg.ssm.chunk_size, cfg.dtype) == (
        64, 2560, 128, 64, 256, "bfloat16")
    # a remat step runs each block's scan twice and its backward once
    assert cs.train_launches(cfg, 1) == dict(forward=128, backward=64)
    check = cs.TRAIN_SSM_CHECK
    assert check["archs"] == ("mamba2-2.7b", "hymba-1.5b")
    assert (check["layers"], check["batch"], check["seq"]) == (2, 4, 1024)
    phases = cs.PHASES
    assert phases.index("train-check") + 1 == phases.index("train-ssm") \
        == phases.index("train-ssm-check") - 1
    # ssd_scan no longer refuses a gradient on the card
    import inspect
    assert "ssd_scan" not in inspect.getsource(cs._refusals)

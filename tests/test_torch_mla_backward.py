"""flash_attention_latent's backward on the CPU.

``flash_attention_latent_bwd_plain`` (the closed form that the wrapper
runs on CPU tensors and that the card check holds the CUDA kernel to)
against ``jax.vjp`` of the reference's ``chunked_attention`` called as its
``mla_attention`` calls it (``[q_lat ; q_rope]`` over the one key head
``[c_kv ; k_rope]``, value ``c_kv``, ``softmax_scale``), on the same seeded
inputs: every gradient within 1e-4 of its largest |value| in f32, at the
reduced ranks (R 32, Dr 16) and the published ones (R 512, Dr 64), with S
and H off the kernel's 32-row grid and S != T; in bf16 by the card's bf16
rule.  The autograd gradient of the port's ``mla_attention`` (every weight
and x) against ``jax.vjp`` of the reference's at the published ranks, on
the CPU route and through ``_FlashAttentionLatent`` (the CUDA route, with
its launches replaced by the plain versions).

The CUDA kernel (``csrc/mla_attention_bwd.cu``) runs only on the card
(``chip_smoke.py`` holds it against the plain version there); here
plain-PyTorch models of its passes are held against the plain version,
with a key side that starts one position late as the negative control.
The f32 instance's (``_kernel_passes``: delta; the query side by 32-row
blocks walking 32-key tiles; the key side by 32-key blocks walking the
32-row tiles from position t0 on; p from the forward's lse in base 2)
holds its values exactly in fp32 on the CUDA cores.  The bf16 tensor-core
instance's (``_wgmma_passes``: 64-row query tiles walking 64-key tiles;
64-key blocks over chunks of rows in 64-row tiles; dS, P^T and scale dS^T
rounded once to bf16 as the kernel rounds its A operands; fp32 sums, the
chunks summed in chunk order) at ``CASES`` and at chip_smoke.py's bf16
``MLA_BWD`` rows cut in B and H but at their full S: within 1e-5 of the
plain version without the rounding, and by the card's bf16 rule with it,
which the wrong variants miss.  The wrapper's checks, its ctypes binding
parsed from the source, and chip_smoke.py's rows, bound and phases for
the latent backward."""

import dataclasses
import inspect
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.models import attention as ref_attention
from repro_torch import _build
from repro_torch.configs import MLAConfig, get_config, reduce_config
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

sys.path.remove(str(ROOT))

jax = pytest.importorskip("jax")
jnp = jax.numpy

ARCH = "deepseek-v3-671b"
TOL = 1e-4                       # f32: of each gradient's largest |value|
NAMES = ("dq_lat", "dq_rope", "dc_kv", "dk_rope")
# b, s, t, h, r, dr
CASES = {
    "reduced": (2, 70, 70, 3, 32, 16),
    "reduced.S-ne-T": (1, 20, 33, 2, 32, 16),
    "reduced.S-gt-T": (1, 33, 20, 5, 32, 16),
    "published": (1, 40, 40, 2, 512, 64),
    "published.H3": (1, 45, 45, 3, 512, 64),
}
SCALE = 192 ** -0.5
PUBLISHED = dict(d_model=256, num_heads=4, mla=MLAConfig())


def _inputs(b, s, t, h, r, dr, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, s, h, r), (b, s, h, dr), (b, t, r), (b, t, dr))]
    do = rng.standard_normal((b, s, h, r), dtype=np.float32)
    return arrs, do


def _reference(arrs, do, scale):
    """(out, grads) of the reference's chunked_attention as mla_attention
    calls it, by jax.vjp."""
    b, s = arrs[0].shape[:2]
    t = arrs[2].shape[1]
    qpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    kpos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))

    def lat(q_lat, q_rope, c_kv, k_rope):
        qq = jnp.concatenate([q_lat, q_rope], axis=-1)
        kk = jnp.concatenate([c_kv, k_rope], axis=-1)[:, :, None, :]
        return ref_attention.chunked_attention(
            qq, kk, c_kv[:, :, None, :], qpos, kpos, causal=True, chunk=16,
            softmax_scale=scale)

    out, vjp = jax.vjp(lat, *(jnp.asarray(a) for a in arrs))
    return out, vjp(jnp.asarray(do, dtype=out.dtype))


def _ratio(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_reference_vjp(case):
    arrs, do = _inputs(*CASES[case], seed=len(case))
    out, want = _reference(arrs, do, SCALE)
    t = [torch.from_numpy(a) for a in arrs]
    o = ops.flash_attention_latent_plain(*t, scale=SCALE)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    got = ops.flash_attention_latent_bwd_plain(*t, o, torch.from_numpy(do),
                                               scale=SCALE)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _ratio(g.numpy(), w) <= TOL, name


@pytest.mark.parametrize("case", ["reduced", "published"])
def test_plain_backward_matches_autograd(case):
    arrs, do = _inputs(*CASES[case], seed=7)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out = ops.flash_attention_latent_plain(*leaves, scale=SCALE)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    got = ops.flash_attention_latent_bwd_plain(
        *(x.detach() for x in leaves), out.detach(), torch.from_numpy(do),
        scale=SCALE)
    for name, g, w in zip(NAMES, got, want):
        assert _ratio(g.numpy(), w.numpy()) <= 1e-5, name


# bf16: the reference differentiates in fp32 from the bf16 inputs and
# rounds each gradient to bf16 once, as the plain version does; the two
# sum in other orders, so an element may round the other way: the card's
# bf16 rule, 2^-6 of each element plus 2^-8 of the largest |value|
def test_bf16_plain_backward_matches_reference_vjp():
    arrs, do = _inputs(*CASES["published.H3"], seed=3)
    bf = [torch.from_numpy(a).bfloat16() for a in arrs]
    dob = torch.from_numpy(do).bfloat16()
    jarrs = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in bf]
    b, s = arrs[0].shape[:2]
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

    def lat(q_lat, q_rope, c_kv, k_rope):
        qq = jnp.concatenate([q_lat, q_rope], axis=-1)
        kk = jnp.concatenate([c_kv, k_rope], axis=-1)[:, :, None, :]
        return ref_attention.chunked_attention(
            qq, kk, c_kv[:, :, None, :], pos, pos, causal=True, chunk=16,
            softmax_scale=SCALE)

    out, vjp = jax.vjp(lat, *jarrs)
    want = vjp(jnp.asarray(dob.float().numpy()).astype(jnp.bfloat16))
    o = ops.flash_attention_latent_plain(*bf, scale=SCALE)
    assert o.dtype == torch.bfloat16
    got = ops.flash_attention_latent_bwd_plain(*bf, o, dob, scale=SCALE)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert chip_smoke._latent_bwd_err(torch, [g], [w.bfloat16()]) <= 1.0, \
            name


# ---------------------------------------------------------------- the block
def _block_case(seed=0):
    ref_cfg = ref_reduce_config(ref_get_config(ARCH), dtype="float32",
                                **PUBLISHED)
    cfg = reduce_config(get_config(ARCH), dtype="float32", **PUBLISHED)
    ref_p = ref_attention.init_mla(jax.random.PRNGKey(seed), ref_cfg,
                                   jnp.float32)
    return ref_cfg, cfg, ref_p


def _fake_cuda_route(monkeypatch, lse_seen):
    """Send ``flash_attention_latent`` on CPU tensors down its CUDA route,
    ``_FlashAttentionLatent``, with the launch replaced by the plain
    version (storing lse when given a buffer); the backward then runs
    ``flash_attention_latent_bwd``, which on CPU tensors is the plain
    closed form."""
    bwd = ops.flash_attention_latent_bwd

    def launch(q_lat, q_rope, c_kv, k_rope, scale, lse=None):
        out, plain_lse = ops.flash_attention_latent_lse_plain(
            q_lat, q_rope, c_kv, k_rope, scale=scale)
        if lse is not None:
            lse.copy_(plain_lse)
        return out

    def seen_bwd(*args, **kw):
        lse_seen.append(args[6])
        return bwd(*args, **kw)

    monkeypatch.setattr(ops, "_latent_launch", launch)
    monkeypatch.setattr(ops, "_check_latent_forward",
                        lambda *_: torch.device("cuda"))
    monkeypatch.setattr(ops, "flash_attention_latent_bwd", seen_bwd)


@pytest.mark.parametrize("route", ["cpu", "function"])
def test_mla_attention_gradient_matches_reference(route, monkeypatch):
    ref_cfg, cfg, ref_p = _block_case()
    rng = np.random.default_rng(5)
    b, s = 2, 40
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    dy = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()

    def ref_loss(p, xx):
        y, _ = ref_attention.mla_attention(p, ref_cfg, xx, jnp.asarray(pos),
                                           chunk=16)
        return jnp.sum(y * jnp.asarray(dy))

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(ref_p,
                                                        jnp.asarray(x))
    lse_seen = []
    if route == "function":
        _fake_cuda_route(monkeypatch, lse_seen)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              if not isinstance(v, dict) else
              {kk: torch.from_numpy(np.array(vv)).requires_grad_(True)
               for kk, vv in v.items()} for k, v in ref_p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = attention.mla_attention(params, cfg, xt, torch.from_numpy(pos))
    loss = (y * torch.from_numpy(dy)).sum()
    loss.backward()
    if route == "function":
        # one backward call, fed the lse its forward stored
        assert len(lse_seen) == 1 and lse_seen[0] is not None
        assert lse_seen[0].shape == (b, s, cfg.num_heads)
    assert _ratio(xt.grad.numpy(), want_x) <= TOL
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                assert _ratio(vv.grad.numpy(), want_p[k][kk]) <= TOL, (k, kk)
        else:
            assert _ratio(v.grad.numpy(), want_p[k]) <= TOL, k


def test_the_cuda_route_keeps_lse_for_a_gradient_only(monkeypatch):
    lse_seen = []
    _fake_cuda_route(monkeypatch, lse_seen)
    stored = []
    launch = ops._latent_launch

    def counting(*args, **kw):
        stored.append(args[5] if len(args) > 5 else kw.get("lse"))
        return launch(*args, **kw)

    monkeypatch.setattr(ops, "_latent_launch", counting)
    arrs, do = _inputs(*CASES["reduced"], seed=11)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    with torch.no_grad():
        out = ops.flash_attention_latent(*leaves, scale=SCALE)
    assert out.grad_fn is None and stored[-1] is None
    out = ops.flash_attention_latent(*(x.detach() for x in leaves),
                                     scale=SCALE)
    assert out.grad_fn is None and stored[-1] is None
    out = ops.flash_attention_latent(*leaves, scale=SCALE)
    assert type(out.grad_fn).__name__ == "_FlashAttentionLatentBackward"
    assert stored[-1] is not None and stored[-1].dtype == torch.float32
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert len(lse_seen) == 1
    assert lse_seen[0].data_ptr() == stored[-1].data_ptr()
    want = ops.flash_attention_latent_bwd_plain(
        *(x.detach() for x in leaves), out.detach(), torch.from_numpy(do),
        scale=SCALE)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The CUDA kernel's passes (csrc/mla_attention_bwd.cu) in plain PyTorch:
# delta; the query side, a block per 32 rows r = i H + h (positions r // H,
# so a block may span positions) walking 32-key tiles up to its last row's
# position; the key side, a block per 32 keys and chunk of the rows from
# row t0 H (the first row at position t0), kChunkRows at a time, walking
# its 32-row tiles into a partial sum; then the partial sums added in
# chunk order; p = exp2(s scale log2(e) - lse log2(e)) from the forward's
# lse, zero where hidden.

KERNEL_TILE = 32
KERNEL_CHUNK_ROWS = 8192
LOG2E = 1.4426950408889634


@pytest.fixture
def one_thread():
    """The pass models issue thousands of small products; on one intra-op
    thread each, so that the workers of a parallel test run do not
    oversubscribe the cores (a product's thread team waits on threads the
    other workers keep descheduled: one case took 473 s under ``-n 6``
    against 1-2 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_passes(q_lat, q_rope, c_kv, k_rope, o, do, lse, scale,
                   late_start=0, chunk_rows=KERNEL_CHUNK_ROWS):
    b, s, h, r = q_lat.shape
    t = c_kv.shape[1]
    rows = s * h
    f = torch.float32
    ql = q_lat.to(f).reshape(b, rows, r)
    qr = q_rope.to(f).reshape(b, rows, -1)
    dof = do.to(f).reshape(b, rows, r)
    kk = torch.cat([c_kv.to(f), k_rope.to(f)], -1)           # (B, T, 576)
    qq = torch.cat([ql, qr], -1)
    l2 = lse.reshape(b, rows) * LOG2E
    delta = (dof * o.to(f).reshape(b, rows, r)).sum(-1)       # pass 1
    pos = torch.arange(rows) // h
    dq = torch.zeros_like(qq)
    dk = torch.zeros_like(kk)

    def p_ds(bi, rr, tt):
        sc = qq[bi, rr] @ kk[bi, tt].T
        vis = tt[None, :] <= pos[rr][:, None]
        p = torch.where(vis, torch.exp2(sc * scale * LOG2E
                                        - l2[bi, rr][:, None]), 0.0)
        return p, p * (dof[bi, rr] @ kk[bi, tt, :r].T
                       - delta[bi, rr][:, None])

    for bi in range(b):
        # pass 2: the query side
        for r0 in range(0, rows, KERNEL_TILE):
            rr = torch.arange(r0, min(r0 + KERNEL_TILE, rows))
            t_end = min(t, int(rr[-1]) // h + 1)
            for t0 in range(0, t_end, KERNEL_TILE):
                tt = torch.arange(t0, min(t0 + KERNEL_TILE, t_end))
                _, ds = p_ds(bi, rr, tt)
                dq[bi, rr] += ds @ kk[bi, tt]
        # pass 3: the key side's partial sums, a chunk of rows each; pass
        # 4: their sum in chunk order
        for t0 in range(0, t, KERNEL_TILE):
            tt = torch.arange(t0, min(t0 + KERNEL_TILE, t))
            first = (t0 + late_start) * h
            parts = []
            for c0 in range(first, max(rows, first + 1), chunk_rows):
                part = torch.zeros((len(tt), kk.shape[-1]))
                for rr0 in range(c0, min(rows, c0 + chunk_rows), KERNEL_TILE):
                    rr = torch.arange(rr0, min(rr0 + KERNEL_TILE, rows,
                                               c0 + chunk_rows))
                    p, ds = p_ds(bi, rr, tt)
                    part[:, :r] += p.T @ dof[bi, rr] + scale * (
                        ds.T @ ql[bi, rr])
                    part[:, r:] += scale * (ds.T @ qr[bi, rr])
                parts.append(part)
            for part in parts:
                dk[bi, tt] += part
    dq = (dq * scale).reshape(b, s, h, -1)
    return (dq[..., :r].to(q_lat.dtype), dq[..., r:].to(q_rope.dtype),
            dk[..., :r].to(c_kv.dtype), dk[..., r:].to(k_rope.dtype))


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("chunk_rows", [KERNEL_CHUNK_ROWS, 64])
def test_kernel_passes_match_plain(case, chunk_rows):
    # the kernel's chunk of 8 192 rows, and 64, at which these shapes' key
    # tiles split their rows over several chunks
    arrs, do = _inputs(*CASES[case], seed=len(case) + 1)
    t = [torch.from_numpy(a) for a in arrs]
    o, lse = ops.flash_attention_latent_lse_plain(*t, scale=SCALE)
    want = ops.flash_attention_latent_bwd_plain(*t, o, torch.from_numpy(do),
                                                scale=SCALE)
    got = _kernel_passes(*t, o, torch.from_numpy(do), lse, SCALE,
                         chunk_rows=chunk_rows)
    for name, g, w in zip(NAMES, got, want):
        assert _ratio(g.numpy(), w.numpy()) <= 1e-5, name
    assert chip_smoke._latent_bwd_err(torch, got, want) <= 1.0
    # the negative control: a key side that starts one position late
    late = _kernel_passes(*t, o, torch.from_numpy(do), lse, SCALE,
                          late_start=1)
    assert chip_smoke._latent_bwd_err(torch, late, want) > 1.0


# ---------------------------------------------------------------------------
# The bf16 instance's tensor-core passes (mla_bwd_q_wgmma_kernel,
# mla_bwd_kv_wgmma_kernel) in plain PyTorch: the query side by 64-row
# blocks walking the 64-key tiles up to its last row's position; the key
# side by 64-key blocks and chunks of the rows from row t0 H, walking
# 64-row tiles into a partial sum; the chunks summed in chunk order.  The
# products of bf16 inputs are exact in fp32 and every sum is fp32; with
# ``rounded`` the A operands go to bf16 where the kernel rounds them: dS
# on the query side (scaled at the end), P^T and scale dS^T on the key
# side.

WGMMA_TILE = 64


def _bf16(x):
    return x.bfloat16().float()


def _wgmma_passes(q_lat, q_rope, c_kv, k_rope, o, do, lse, scale,
                  rounded=True, late_start=0, chunk_rows=KERNEL_CHUNK_ROWS):
    b, s, h, r = q_lat.shape
    t = c_kv.shape[1]
    rows = s * h
    f = torch.float32
    rnd = _bf16 if rounded else (lambda x: x)
    ql = q_lat.to(f).reshape(b, rows, r)
    dof = do.to(f).reshape(b, rows, r)
    kk = torch.cat([c_kv.to(f), k_rope.to(f)], -1)           # (B, T, R + Dr)
    qq = torch.cat([ql, q_rope.to(f).reshape(b, rows, -1)], -1)
    l2 = lse.reshape(b, rows) * LOG2E
    delta = (dof * o.to(f).reshape(b, rows, r)).sum(-1)
    pos = torch.arange(rows) // h
    sc2 = scale * LOG2E
    dq = torch.zeros_like(qq)
    dk = torch.zeros_like(kk)
    for bi in range(b):
        # the query side
        for r0 in range(0, rows, WGMMA_TILE):
            rr = torch.arange(r0, min(r0 + WGMMA_TILE, rows))
            t_end = min(t, int(rr[-1]) // h + 1)
            for t0 in range(0, t_end, WGMMA_TILE):
                tt = torch.arange(t0, min(t0 + WGMMA_TILE, t_end))
                vis = tt[None, :] <= pos[rr][:, None]
                p = torch.where(vis, torch.exp2(
                    (qq[bi, rr] @ kk[bi, tt].T) * sc2
                    - l2[bi, rr][:, None]), 0.0)
                ds = p * (dof[bi, rr] @ kk[bi, tt, :r].T
                          - delta[bi, rr][:, None])
                dq[bi, rr] += rnd(ds) @ kk[bi, tt]
        # the key side's partial sums, a chunk of rows each, then their sum
        # in chunk order
        for t0 in range(0, t, WGMMA_TILE):
            tt = torch.arange(t0, min(t0 + WGMMA_TILE, t))
            first = (t0 + late_start) * h
            parts = []
            for c0 in range(first, max(rows, first + 1), chunk_rows):
                part = torch.zeros((len(tt), kk.shape[-1]))
                end = min(rows, c0 + chunk_rows)
                for rr0 in range(c0, end, WGMMA_TILE):
                    rr = torch.arange(rr0, min(rr0 + WGMMA_TILE, end))
                    vis = tt[:, None] <= pos[rr][None, :]
                    pt = torch.where(vis, torch.exp2(
                        (kk[bi, tt] @ qq[bi, rr].T) * sc2
                        - l2[bi, rr][None, :]), 0.0)
                    dst = pt * (kk[bi, tt, :r] @ dof[bi, rr].T
                                - delta[bi, rr][None, :])
                    pb, db = rnd(pt), rnd(scale * dst)
                    part[:, :r] += pb @ dof[bi, rr] + db @ ql[bi, rr]
                    part[:, r:] += db @ qq[bi, rr, r:]
                parts.append(part)
            for part in parts:
                dk[bi, tt] += part
    dq = (dq * scale).reshape(b, s, h, -1)
    return (dq[..., :r].to(q_lat.dtype), dq[..., r:].to(q_rope.dtype),
            dk[..., :r].to(c_kv.dtype), dk[..., r:].to(k_rope.dtype))


def _wgmma_cases():
    """CASES, and chip_smoke.py's bf16 MLA_BWD rows cut to B 1 and H 2 at
    their full S (a small H, such as the small-H row's 3, kept; 64-row
    tiles then span positions), one case a shape."""
    cases = dict(CASES)
    for label, _, s, h, tags in chip_smoke.MLA_BWD:
        cut = (1, s, s, h if h < 8 else 2, chip_smoke.MLA_RANK,
               chip_smoke.MLA_ROPE)
        if "bf16" in tags and cut not in cases.values():
            cases[f"MLA_BWD.{label}"] = cut
    return cases


WGMMA_CASES = _wgmma_cases()


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", list(WGMMA_CASES))
@pytest.mark.parametrize("chunk_rows", [KERNEL_CHUNK_ROWS, 64])
def test_wgmma_passes_match_plain(case, chunk_rows):
    # f32 inputs, no operand rounding: the tiles, chunks and mask are the
    # plain version's function
    arrs, do = _inputs(*WGMMA_CASES[case], seed=len(case) + 2)
    t = [torch.from_numpy(a) for a in arrs]
    dot = torch.from_numpy(do)
    o, lse = ops.flash_attention_latent_lse_plain(*t, scale=SCALE)
    want = ops.flash_attention_latent_bwd_plain(*t, o, dot, scale=SCALE)
    got = _wgmma_passes(*t, o, dot, lse, SCALE, rounded=False,
                        chunk_rows=chunk_rows)
    for name, g, w in zip(NAMES, got, want):
        assert _ratio(g.numpy(), w.numpy()) <= 1e-5, name
    late = _wgmma_passes(*t, o, dot, lse, SCALE, rounded=False,
                         late_start=1, chunk_rows=chunk_rows)
    assert chip_smoke._latent_bwd_err(torch, late, want) > 1.0


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_bf16_wgmma_passes_meet_the_card_rule(case):
    # bf16 inputs, dS, P^T and scale dS^T rounded once to bf16, several
    # chunks a key tile: inside the card's bf16 rule, which the wrong
    # variants and a key side that starts one position late miss
    arrs, do = _inputs(*WGMMA_CASES[case], seed=len(case) + 3)
    t = [torch.from_numpy(a).bfloat16() for a in arrs]
    dob = torch.from_numpy(do).bfloat16()
    o, lse = ops.flash_attention_latent_lse_plain(*t, scale=SCALE)
    want = ops.flash_attention_latent_bwd_plain(*t, o, dob, scale=SCALE)
    got = _wgmma_passes(*t, o, dob, lse, SCALE, chunk_rows=64)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert chip_smoke._latent_bwd_err(torch, got, want) <= 1.0
    for kw in (dict(value_part=False), dict(causal=False)):
        wrong = ops._latent_bwd(*t, o, dob, SCALE, **kw)
        assert chip_smoke._latent_bwd_err(torch, wrong, want) > 1.0, kw
    late = _wgmma_passes(*t, o, dob, lse, SCALE, late_start=1, chunk_rows=64)
    assert chip_smoke._latent_bwd_err(torch, late, want) > 1.0


@pytest.mark.usefixtures("one_thread")
def test_bf16_kernel_passes_meet_the_card_rule():
    # bf16 inputs are exact in fp32, every sum is fp32 and each gradient is
    # rounded once: the card's bf16 rule holds against the plain version,
    # and misses the wrong variants it must reject
    arrs, do = _inputs(*CASES["published.H3"], seed=21)
    t = [torch.from_numpy(a).bfloat16() for a in arrs]
    dob = torch.from_numpy(do).bfloat16()
    o, lse = ops.flash_attention_latent_lse_plain(*t, scale=SCALE)
    want = ops.flash_attention_latent_bwd_plain(*t, o, dob, scale=SCALE)
    got = _kernel_passes(*t, o, dob, lse, SCALE)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert chip_smoke._latent_bwd_err(torch, got, want) <= 1.0
    for kw in (dict(value_part=False), dict(causal=False)):
        wrong = ops._latent_bwd(*t, o, dob, SCALE, **kw)
        assert chip_smoke._latent_bwd_err(torch, wrong, want) > 1.0, kw


# ------------------------------------------------------------- the wrapper
def test_the_wrapper_runs_the_plain_backward_on_cpu_tensors():
    arrs, do = _inputs(*CASES["reduced"], seed=4)
    t = [torch.from_numpy(a) for a in arrs]
    dot = torch.from_numpy(do)
    o, lse = ops.flash_attention_latent_lse(*t, scale=SCALE)
    got = ops.flash_attention_latent_bwd(*t, o, dot, lse, scale=SCALE)
    without = ops.flash_attention_latent_bwd(*t, o, dot, scale=SCALE)
    want = ops.flash_attention_latent_bwd_plain(*t, o, dot, scale=SCALE)
    for g, n, w in zip(got, without, want):
        assert torch.equal(g, w) and torch.equal(n, w)


def test_the_wrapper_checks_its_inputs():
    arrs, do = _inputs(*CASES["reduced"], seed=4)
    t = [torch.from_numpy(a) for a in arrs]
    dot = torch.from_numpy(do)
    o = ops.flash_attention_latent_plain(*t, scale=SCALE)
    with pytest.raises(ValueError, match="o and do"):
        ops.flash_attention_latent_bwd(*t, o, dot[:, 1:].contiguous(),
                                       scale=SCALE)
    with pytest.raises(TypeError):
        ops.flash_attention_latent_bwd(*t, o, dot.double(), scale=SCALE)
    with pytest.raises(TypeError):
        ops.flash_attention_latent_bwd(t[0].bfloat16(), *t[1:], o, dot,
                                       scale=SCALE)
    with pytest.raises(ValueError, match="latent attention takes"):
        ops.flash_attention_latent_bwd(t[0], t[1][..., :8].contiguous(),
                                       *t[2:], o, dot, scale=SCALE)
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_latent_bwd(*t, o, dot, torch.zeros(2, 70, 4),
                                       scale=SCALE)
    with pytest.raises(ValueError, match="lse must be"):
        ops.flash_attention_latent_bwd(*t, o, dot, torch.zeros(
            2, 70, 3, dtype=torch.float64), scale=SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_latent_bwd(*t, o, dot.transpose(1, 2), scale=SCALE)


def test_the_cuda_backward_needs_the_forwards_lse():
    # on CUDA tensors the wrapper checks the widths and raises without lse
    # before any launch, and nothing falls back to the plain version
    src = inspect.getsource(ops.flash_attention_latent_bwd)
    cpu = src.index('if dev.type == "cpu":')
    widths = src.index("_check_latent_widths(")
    refuse = src.index("if lse is None:")
    launch = src.index("_build.lib()")
    assert cpu < widths < refuse < launch
    assert "raise ValueError" in src[refuse:launch]
    assert "plain" not in src[refuse:]
    assert "backward_launches += 1" in src[launch:]
    # the forward's CUDA route is the Function, and nothing refuses a
    # gradient
    src = inspect.getsource(ops.flash_attention_latent)
    assert "_FlashAttentionLatent.apply" in src and "refuse_grad" not in src
    assert "refuse_grad" not in inspect.getsource(ops)


def _c_params(src: str, name: str) -> list:
    sig = re.search(rf'extern "C" int {name}\((.*?)\)\s*{{', src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def test_the_backward_source_is_built_and_bound():
    import ctypes

    assert "mla_attention_bwd.cu" in _build.SOURCES
    src = (_build.CSRC / "mla_attention_bwd.cu").read_text()
    kinds = {ctypes.c_void_p: "*", ctypes.c_int: "int ",
             ctypes.c_float: "float "}
    kinds[ctypes.c_longlong] = "int "
    for name in ("flash_attention_latent_bwd_launch",
                 "flash_attention_latent_bwd_smem_bytes"):
        params = _c_params(src, name)
        args, res = _build._SIGNATURES[name]
        assert res is ctypes.c_int and len(args) == len(params)
        for a, p in zip(args, params):
            assert kinds[a] in p, (name, p)
    params = _c_params(src, "flash_attention_latent_bwd_launch")
    assert params[6:9] == ["const void* lse", "void* delta", "void* part"]
    sig = re.search(r'extern "C" long long flash_attention_latent_bwd_'
                    r'workspace\(([^)]*)\)', src).group(1)
    args, res = _build._SIGNATURES["flash_attention_latent_bwd_workspace"]
    assert res is ctypes.c_longlong
    assert [q.strip() for q in sig.split(",")] == [
        "int B", "int S", "int Tk", "int H"] and len(args) == 4
    # the widths are the forward's, the shared memory fits a block
    assert "constexpr int kR = 512;" in src and "constexpr int kDr = 64;" in src
    assert ops.LATENT_WIDTHS == (512, 64)

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+)", text).group(1))

    tile, tc_tile = const("kTile"), const("kTcTile")
    assert (tile, tc_tile) == (KERNEL_TILE, WGMMA_TILE)
    chunk = const("kChunkRows")
    assert chunk == KERNEL_CHUNK_ROWS and chunk % tc_tile == chunk % tile == 0
    q_smem = (tile * 576 + tile * 512 + tile * 580) * 4
    kv_smem = (2 * tile * 580 + tile * 516) * 4
    # the tensor-core passes: the latent tiles of wgmma.cuh (9 pieces of
    # 64 x 64 bf16), 1 KB of alignment; the query side's Q, dO and a key
    # tile and dS's exchange (8 words a thread); the key side's keys, a Q
    # tile, a dO tile, the exchange of P^T and dS^T and 64 lse and delta
    cuh = (_build.CSRC / "wgmma.cuh").read_text()
    assert "constexpr int kPiece = 64 * 128;" in cuh
    piece, pieces = 64 * 128, const("kPieces", cuh)
    assert (pieces, const("kXWords")) == (9, 8)
    q_tc = 1024 + (3 * pieces - 1) * piece + 2 * 8 * 128 * 4
    kv_tc = 1024 + (3 * pieces - 1) * piece + 2 * 2 * 8 * 128 * 4 + 2 * 64 * 4
    assert (q_tc, kv_tc) == (222208, 230912)
    assert max(q_smem, kv_smem, q_tc, kv_tc) <= 232448
    assert "atomic" not in src.split("#include")[-1]
    # bf16 reaches the tensor-core query and key sides, f32 the CUDA-core
    # ones, and no bf16 instance of the CUDA-core ones is built
    body = src.split("#include")[-1]
    for k in ("q", "kv"):
        assert f"mla_bwd_{k}_wgmma_kernel<<<" in body
        assert f"mla_bwd_{k}_kernel<float><<<" in body
        assert f"mla_bwd_{k}_kernel<__nv_bfloat16>" not in body
    # the forward and the backward share wgmma.cuh's m64n32 product, latent
    # staging and fragment exchange
    fwd_src = (_build.CSRC / "mla_attention.cu").read_text()
    for helper in ("wgmma_ss_n32", "stage_latent_piece", "stage_latent_rows",
                   "exchange"):
        assert f"void {helper}(" in cuh, helper
        assert f"void {helper}(" not in fwd_src + src, helper
        assert helper in fwd_src and helper in src, helper
    # the forward's launch takes the lse buffer
    fwd = _c_params((_build.CSRC / "mla_attention.cu").read_text(),
                    "flash_attention_latent_launch")
    assert fwd[5] == "void* lse"


def test_backward_instances_and_counters():
    cs = chip_smoke
    assert ops.latent_bwd_instance(torch.bfloat16) == "wgmma"
    assert ops.latent_bwd_instance(torch.float32) == "fma"
    fal = ops.flash_attention_latent
    assert set(fal.backward_instance_launches) == {"wgmma", "fma"}
    assert hasattr(fal, "lse_launches") and hasattr(fal, "backward_launches")
    ns = "_ZN53_GLOBAL__N__7c351eb7_20_mla_attention_bwd_cu_be7d3096"
    assert cs._latent_bwd_instance(
        ns + "22mla_bwd_q_wgmma_kernelENS_7BwdArgsE") == ("q_wgmma", "bf16")
    assert cs._latent_bwd_instance(
        ns + "23mla_bwd_kv_wgmma_kernelENS_7BwdArgsE") == ("kv_wgmma", "bf16")
    assert cs._latent_bwd_instance(
        ns + "16mla_bwd_q_kernelIfEEvNS_7BwdArgsE") == ("q", "f32")
    assert cs._latent_bwd_instance(
        ns + "20mla_bwd_delta_kernelIfEEvPKT_S3_Pfx") == ("delta", "f32")
    assert cs._latent_bwd_instance("mla_attention_kernel") is None
    assert cs._latent_bwd_instance(
        ns + "21mla_bwd_reduce_kernelI13__nv_bfloat16EEvNS_7BwdArgsE") == (
            "reduce", "bf16")
    # a CUDA-core bf16 query side is no instance the build may make
    bf16_q = cs._latent_bwd_instance(
        ns + "16mla_bwd_q_kernelI13__nv_bfloat16EEvNS_7BwdArgsE")
    assert bf16_q == ("q", "bf16") and bf16_q not in cs.MLA_BWD_INSTANCES
    assert cs.MLA_BWD_PASSES == {
        "wgmma": ("delta", "q_wgmma", "kv_wgmma", "reduce"),
        "fma": ("delta", "q", "kv", "reduce")}
    assert cs.MLA_BWD_DTYPES == {
        ops.latent_bwd_instance(torch.bfloat16): "bf16",
        ops.latent_bwd_instance(torch.float32): "f32"}
    assert set(cs.MLA_BWD_INSTANCES) == {
        *((p, "bf16") for p in ("delta", "q_wgmma", "kv_wgmma", "reduce")),
        *((p, "f32") for p in ("delta", "q", "kv", "reduce"))}
    assert cs.MLA_BWD_NO_SPILL == (("q_wgmma", "bf16"), ("kv_wgmma", "bf16"))
    # flash_attention_latent_bwd_smem_bytes's passes, in the source's order
    src = (_build.CSRC / "mla_attention_bwd.cu").read_text()
    assert "{kQSmem, kKvSmem, kQTcSmem, kKvTcSmem}" in src
    assert cs.MLA_BWD_SMEM_PASSES == ("q", "kv", "q_wgmma", "kv_wgmma")


# --------------------------------------------------------- chip_smoke.py
def test_backward_rows_sit_at_the_training_shape():
    cs = chip_smoke
    rows = {r[0]: r[1:] for r in cs.MLA_BWD}
    cfg = ref_get_config(ARCH)
    # the train-mla phase's shape, and TRAIN's batch in bf16
    assert rows["train"] == (cs.TRAIN_MLA["batch"], cs.TRAIN_MLA["seq"],
                             cfg.num_heads, ("bf16", "f32"))
    assert rows["B8"] == (cs.TRAIN["batch"], cs.TRAIN["seq"], cfg.num_heads,
                          ("bf16",))
    assert rows["ragged"][:2] == (2, 1528) and rows["ragged"][1] % 32
    assert rows["small-H"][2] == 3
    assert cs.MLA_BWD_PROFILED == ("train", "B8")
    assert (cs.MLA_RANK, cs.MLA_ROPE) == (cfg.mla.kv_lora_rank,
                                          cfg.mla.qk_rope_head_dim)
    assert set(cs.MLA_BWD_PASSES) == set(cs.MLA_BWD_DTYPES) == {"wgmma",
                                                                "fma"}


def test_backward_bound_and_tolerance():
    cs = chip_smoke
    # five products of (576, 512, 512, 576, 576) columns over the visible
    # pairs: 2.96e12 flops at the training shape, ~2.99 ms in bf16
    bound, by = cs._latent_bwd_bound(8, 1024, 128, 2, cs.BF16_OPS_PER_S)
    assert by == "operations" and bound == pytest.approx(2.99, rel=0.01)
    bound, by = cs._latent_bwd_bound(8, 1024, 128, 4, cs.FP32_OPS_PER_S)
    assert bound == pytest.approx(44.2, rel=0.01)
    w = torch.tensor([1.0, -2.0])
    assert cs._latent_bwd_err(torch, [w * (1 + 0.9e-4)], [w]) == \
        pytest.approx(0.9, rel=1e-3)
    assert cs._latent_bwd_err(torch, [w + 3e-4], [w]) > 1.0
    bf = torch.tensor([1.0, 0.5], dtype=torch.bfloat16)
    assert cs._latent_bwd_err(torch, [bf], [bf]) == 0.0
    assert set(cs.MLA_BWD_WRONG) == {"no_value_part", "no_causal"}


def test_train_mla_phases_train_deepseek_at_published_widths():
    cs = chip_smoke
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get_config(ARCH))
    spec = cs.TRAIN_MLA
    assert spec["arch"] == ARCH
    cut = dataclasses.replace(cfg, num_layers=spec["layers"])
    # the three dense layers, no MoE layer, and the MTP group
    assert spec["layers"] == cfg.moe.first_k_dense == 3
    assert cut.mtp_depth == 1 and cut.d_model == 7168
    # TRAIN's sequence; the batch cut from TRAIN's 8 to 4, since B 8 runs
    # out of the card's memory
    assert (spec["batch"], spec["seq"]) == (4, cs.TRAIN["seq"])
    assert cs.TRAIN["batch"] == 8
    # a remat step runs each layer's latent forward twice and the MTP
    # block's once (train_loss applies it without checkpoint); one backward
    # call each
    assert cs.train_launches(cut, 1) == dict(forward=7, backward=4)
    assert cs.train_launches(get_config("olmo-1b"), 2) == dict(
        forward=64, backward=32)
    assert "checkpoint(" not in inspect.getsource(
        __import__("repro_torch.models.model", fromlist=["x"]).train_loss)
    check = cs.TRAIN_MLA_CHECK
    assert check["layers"] == 2 and check["seq"] == 1024
    phases = cs.PHASES
    assert phases.index("train-ssm-check") + 1 == phases.index("train-mla") \
        == phases.index("train-mla-check") - 1
    # only the decode kernels still refuse a gradient on the card
    src = inspect.getsource(cs._refusals)
    assert "flash_attention_latent" not in src
    assert "decode_attention_latent" in src and "decode_attention(" in src

"""flash_attention's backward on the CPU: ``flash_attention_bwd_plain``
(the closed form that the wrapper runs on CPU tensors and that the card
check holds the CUDA kernel to) against ``torch.autograd.grad`` through
``flash_attention_plain``, and both against ``jax.vjp`` of the
reference's ``chunked_attention`` (what the reference's training
differentiates), on the same seeded inputs, within 1e-5 of each tensor's
largest |value| in f32.  Causal, a window, and non-causal at S != T; G 1
and 4; D 32, 64, 80 and 128.  The forward's plain lse against the
log-sum-exp of the reference's masked, scaled scores; the tensor-core
backward's rounding (bf16 P and dS) emulated against the card's bf16 rule
at the bf16 ``FLASH_BWD`` rows of ``chip_smoke.py``; the CUDA route's
autograd wiring (lse kept only for a gradient, and handed to the
backward) with the launch replaced by the plain version.  The kernels
themselves are held on the card by ``chip_smoke.py`` (the ``kernels`` and
``train`` phases)."""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.models.attention import NEG_INF as REF_NEG_INF
from repro.models.attention import chunked_attention as ref_chunked
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import (_mask, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_lse,
                                                     flash_attention_lse_plain,
                                                     flash_attention_plain,
                                                     instance)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

sys.path.remove(str(ROOT))

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL = 1e-5
# mode: (S, T, causal, window); the window sits inside S so that it bites
MODES = {"causal": (48, 48, True, None), "window": (48, 48, True, 13),
         "noncausal": (40, 56, False, None)}


def _inputs(b, s, t, h, kh, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for shape in
            ((b, s, h, d), (b, t, kh, d), (b, t, kh, d), (b, s, h, d))]


def _close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0,
                                   atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("d", [32, 64, 80, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_backward_matches_autograd_and_reference(mode, g, d):
    s, t, causal, window = MODES[mode]
    kh = 2
    q, k, v, do = _inputs(2, s, t, kh * g, kh, d, seed=d + 7 * g + s)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    dot = torch.from_numpy(do)
    auto = torch.autograd.grad(out, (qt, kt, vt), dot)
    plain = flash_attention_bwd_plain(qt.detach(), kt.detach(), vt.detach(),
                                      out.detach(), dot, causal=causal,
                                      window=window)
    _close([x.numpy() for x in plain], [x.numpy() for x in auto])

    def ref(qj, kj, vj):
        qpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (2, s))
        kpos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (2, t))
        return ref_chunked(qj, kj, vj, qpos, kpos, causal=causal,
                           window=window, chunk=16)

    ref_out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
    _close([out.detach().numpy()], [ref_out])
    _close([x.numpy() for x in plain], vjp(jnp.asarray(do)))


def test_fully_masked_rows_get_zero_gradient():
    # S > T under a window: query rows i >= T + window - 1 = 13 see no key
    q, k, v, do = _inputs(1, 24, 10, 4, 2, 32, seed=5)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention_plain(*leaves, causal=True, window=4)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    dq, dk, dv = flash_attention_bwd_plain(
        *(x.detach() for x in leaves), out.detach(), torch.from_numpy(do),
        causal=True, window=4)
    assert float(out.detach()[:, 13:].abs().max()) == 0.0
    assert float(dq[:, 13:].abs().max()) == float(
        auto[0][:, 13:].abs().max()) == 0.0
    assert float(dq[:, :13].abs().max()) > 0
    _close([dq.numpy(), dk.numpy(), dv.numpy()], [x.numpy() for x in auto])


def test_bf16_plain_backward_reads_the_stored_output():
    # delta = rowsum(do * o) with o as stored (bf16), every product in fp32
    q, k, v, do = _inputs(1, 32, 32, 4, 4, 64, seed=9)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    out = flash_attention_plain(*args[:3])
    dq, dk, dv = flash_attention_bwd_plain(*args[:3], out, args[3])
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    want = flash_attention_bwd_plain(*(a.float() for a in args[:3]),
                                     out.float(), args[3].float())
    for got, w in zip((dq, dk, dv), want):
        assert torch.equal(got, w.to(torch.bfloat16))


def test_the_wrapper_runs_the_plain_backward_on_cpu_tensors():
    q, k, v, do = _inputs(2, 20, 20, 4, 2, 32, seed=1)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = flash_attention_lse(*args, causal=True, window=None)
    assert torch.equal(out, flash_attention(*args, causal=True, window=None))
    want = flash_attention_bwd_plain(*args, out, torch.from_numpy(do))
    # the forward's lse is checked and not needed on the CPU
    for given in (lse, None):
        got = flash_attention_bwd(*args, out, torch.from_numpy(do), given)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="B, S, H, D"):
        flash_attention_bwd(*args, out[:, :3].contiguous(),
                            torch.from_numpy(do), lse)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention_bwd(*args, out.double(), torch.from_numpy(do), lse)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(*args, out, torch.from_numpy(do),
                            lse.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(*args, out, torch.from_numpy(do), lse.double())


def test_the_cuda_backward_needs_the_forwards_lse():
    # on CUDA tensors the wrapper raises without lse before any launch: it
    # never recomputes lse, and nothing falls back to the plain version
    src = inspect.getsource(flash_attention_bwd)
    cpu = src.index('if dev.type == "cpu":')
    refuse = src.index("if lse is None:")
    launch = src.index("_build.lib()")
    assert cpu < refuse < launch
    assert "raise ValueError" in src[refuse:launch]
    assert "flash_attention_bwd_plain" not in src[refuse:]


def test_the_cuda_route_keeps_lse_for_a_gradient_only(monkeypatch):
    # _FlashAttention on CPU tensors, its launch replaced by the plain
    # version: lse is allocated and stored only when grad mode is on and an
    # input needs a gradient, and the backward reads that lse
    stored, seen = [], []

    def launch(q, k, v, causal, window, lse=None):
        out, want = flash_attention_lse_plain(q, k, v, causal=causal,
                                              window=window)
        if lse is not None:
            lse.copy_(want)
        stored.append(lse is not None)
        return out

    def bwd(q, k, v, o, do, lse=None, *, causal, window):
        seen.append(lse)
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         window=window)

    monkeypatch.setattr(flash_ops, "_launch", launch)
    monkeypatch.setattr(flash_ops, "_check_forward",
                        lambda *_: torch.device("cuda"))
    monkeypatch.setattr(flash_ops, "flash_attention_bwd", bwd)
    q, k, v, do = _inputs(2, 24, 24, 4, 2, 32, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with torch.no_grad():
        flash_ops.flash_attention(*leaves, window=8)
    flash_ops.flash_attention(*(x.detach() for x in leaves), window=8)
    assert stored == [False, False]
    out = flash_ops.flash_attention(*leaves, window=8)
    assert stored == [False, False, True]
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    want_out, want_lse = flash_attention_lse_plain(
        *(x.detach() for x in leaves), window=8)
    assert torch.equal(out.detach(), want_out)
    assert len(seen) == 1 and torch.equal(seen[0], want_lse)
    want = flash_attention_bwd_plain(*(x.detach() for x in leaves),
                                     want_out, torch.from_numpy(do), window=8)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", list(MODES) + ["masked_rows"])
@pytest.mark.parametrize("g", [1, 4])
def test_plain_lse_is_the_log_sum_exp_of_the_reference_scores(mode, g):
    # the reference's scores: q . k * D^-0.5 over its visible set, NEG_INF
    # elsewhere (chunked_attention); rows that see a key get their
    # log-sum-exp, rows that see none the forward's clamps
    if mode == "masked_rows":   # rows i >= T + window - 1 = 13 see no key
        s, t, causal, window = 24, 10, True, 4
    else:
        s, t, causal, window = MODES[mode]
    d, kh = 64, 2
    q, k, v, _ = _inputs(2, s, t, kh * g, kh, d, seed=11 + g + s)
    out, lse = flash_attention_lse_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window)
    assert lse.shape == (2, kh * g, s) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window))
    qj = jnp.asarray(q).reshape(2, s, kh, g, d)
    sc = jnp.einsum("bskgd,btkd->bkgst", qj, jnp.asarray(k)) * d ** -0.5
    vis = jnp.asarray(_mask(s, t, causal, window, "cpu").numpy())
    sc = jnp.where(vis, sc, REF_NEG_INF).reshape(2, kh * g, s, t)
    want = np.asarray(jax.scipy.special.logsumexp(sc, axis=-1))
    seen = vis.any(-1)
    got = lse.numpy()
    np.testing.assert_allclose(got[:, :, np.asarray(seen)],
                               want[:, :, np.asarray(seen)], rtol=1e-6,
                               atol=1e-5)
    clamp = np.float32(-1e4) + np.log(np.float32(1e-30))
    assert (got[:, :, ~np.asarray(seen)] == clamp).all()
    assert (mode == "masked_rows") == (not bool(seen.all()))


# The tensor-core backward (bf16 at D 64, 80, 128) emulated on the CPU:
# bf16 q, k, v, O and dO; exact fp32 products (of bf16 values); P and dS
# rounded to bf16 before their products; every sum fp32.  Its rows are
# chip_smoke's bf16 FLASH_BWD rows on that instance, at their full S and
# T, cut to B 1 and at most 16 query heads in at most 2 kv heads.
WGMMA_BWD_ROWS = [row for row in chip_smoke.FLASH_BWD if "bf16" in row[9]
                  and chip_smoke.BWD_DISPATCH["bf16", row[6]] == "wgmma"]


def _emulate_wgmma_bwd(q, k, v, o, do, lse, *, causal, window):
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
        p = torch.where(mask, torch.exp(sc - lse[i][..., None]),
                        torch.zeros_like(sc))
        dp = torch.matmul(dof, vf.transpose(1, 2))
        ds = p * (dp - (dof * of).sum(-1, keepdim=True))
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
        dq[i] = (torch.matmul(ds, kf) * scale).transpose(0, 1).to(q.dtype)
        dkh = torch.matmul(ds.transpose(1, 2), qf) * scale
        dvh = torch.matmul(p.transpose(1, 2), dof)
        dk[i] = dkh.view(kh, g, t, d).sum(1).transpose(0, 1).to(k.dtype)
        dv[i] = dvh.view(kh, g, t, d).sum(1).transpose(0, 1).to(v.dtype)
    return dq, dk, dv


@pytest.mark.parametrize("row", WGMMA_BWD_ROWS, ids=lambda r: r[0])
def test_bf16_operands_meet_the_card_bwd_rule(row):
    label, _, s, t, h, kh, d, causal, window, _ = row
    g = h // kh
    kh = min(kh, 2)
    h = kh * min(g, 16 // kh)
    rng = np.random.default_rng(35)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .bfloat16() for shape in ((1, s, h, d), (1, t, kh, d),
                                             (1, t, kh, d), (1, s, h, d)))
    kw = dict(causal=causal, window=window)
    o, lse = flash_attention_lse_plain(q, k, v, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, do, **kw)
    got = _emulate_wgmma_bwd(q, k, v, o, do, lse, **kw)
    err = chip_smoke._bwd_err(torch, got, want, torch.bfloat16)
    assert err <= 1.0, (label, err)
    # the wrong variants that the card's check must reject stay outside
    wrongs = [flash_attention_bwd_plain(q, k, v, o, do, causal=not causal,
                                        window=window)]
    if h > kh:
        first = flash_attention_bwd_plain(
            q[:, :, ::h // kh].contiguous(), k, v,
            o[:, :, ::h // kh].contiguous(), do[:, :, ::h // kh].contiguous(),
            **kw)
        wrongs.append((want[0],) + tuple(first[1:]))
    for wrong in wrongs:
        assert chip_smoke._bwd_err(torch, wrong, want, torch.bfloat16) > 1.0
    print(f"{label} S={s} T={t} H={h} K={kh} D={d}: {err:.3f} of the rule")


def test_wgmma_rows_cover_the_tensor_core_head_dims():
    assert sorted({r[6] for r in WGMMA_BWD_ROWS}) == [64, 80, 128]
    assert {r[0] for r in WGMMA_BWD_ROWS} == {
        "olmo-1b", "glm4-9b", "D64.window", "D80.window", "ragged",
        "noncausal"}
    for d in (64, 80, 128):
        assert instance(torch.bfloat16, d) == "wgmma"
        assert instance(torch.float32, d) == "fma"
    assert instance(torch.bfloat16, 32) == "fma"
    assert set(flash_attention.backward_instance_launches) == {"wgmma", "fma"}


def test_refuse_grad_raises_only_when_a_gradient_is_asked_for():
    x = torch.zeros(3, requires_grad=True)
    item = ("decode serves only: training (ROADMAP Queue 1 item 9.5) runs "
            "cache-free forwards, and no item brings a decode backward")
    with pytest.raises(NotImplementedError, match="item 9.5"):
        refuse_grad("decode_attention_latent", item, x)
    with torch.no_grad():
        refuse_grad("decode_attention_latent", item, x)
    refuse_grad("decode_attention_latent", item, x.detach())


def test_every_kernel_without_a_backward_refuses_on_the_card():
    # the CUDA branch of each decode wrapper calls refuse_grad before its
    # launch: decode serves only
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    for fn, item in ((decode_ops.decode_attention, "item 9.5"),
                     (decode_ops.decode_attention_latent, "item 9.5")):
        src = inspect.getsource(fn)
        cpu = src.index('if dev.type == "cpu":')
        refuse = src.index("refuse_grad(")
        launch = src.index("_build.lib()")
        assert cpu < refuse < launch, fn.__name__
        assert item in src[refuse:launch], fn.__name__
    # flash_attention, its latent form and ssd_scan are differentiable:
    # their CUDA routes are the Functions
    src = inspect.getsource(flash_ops.flash_attention)
    assert "_FlashAttention.apply" in src and "refuse_grad" not in src
    src = inspect.getsource(flash_ops.flash_attention_latent)
    assert "_FlashAttentionLatent.apply" in src and "refuse_grad" not in src
    assert "refuse_grad" not in inspect.getsource(flash_ops)
    src = inspect.getsource(ssd_ops.ssd_scan)
    assert "_SSDScan.apply" in src and "refuse_grad" not in src
    assert "refuse_grad" not in inspect.getsource(ssd_ops)

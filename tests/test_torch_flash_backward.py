"""flash_attention's backward on the CPU: ``flash_attention_bwd_plain``
(the closed form that the wrapper runs on CPU tensors and that the card
check holds the CUDA kernel to) against ``torch.autograd.grad`` through
``flash_attention_plain``, and both against ``jax.vjp`` of the
reference's ``chunked_attention`` (what the reference's training
differentiates), on the same seeded inputs, within 1e-5 of each tensor's
largest |value| in f32.  Causal, a window, and non-causal at S != T; G 1
and 4; D 32, 64, 80 and 128.  The CUDA route's autograd wiring is held on
the card by ``chip_smoke.py`` (the ``kernels`` and ``train`` phases)."""

import inspect

import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention as ref_chunked
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain)

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
    out = flash_attention(*args, causal=True, window=None)
    got = flash_attention_bwd(*args, out, torch.from_numpy(do))
    want = flash_attention_bwd_plain(*args, out, torch.from_numpy(do))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="B, S, H, D"):
        flash_attention_bwd(*args, out[:, :3].contiguous(),
                            torch.from_numpy(do))
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention_bwd(*args, out.double(), torch.from_numpy(do))


def test_refuse_grad_raises_only_when_a_gradient_is_asked_for():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 9.7"):
        refuse_grad("ssd_scan", "ROADMAP Queue 1 item 9.7 brings it", x)
    with torch.no_grad():
        refuse_grad("ssd_scan", "ROADMAP Queue 1 item 9.7 brings it", x)
    refuse_grad("ssd_scan", "ROADMAP Queue 1 item 9.7 brings it",
                x.detach())


def test_every_kernel_without_a_backward_refuses_on_the_card():
    # the CUDA branch of each wrapper calls refuse_grad before its launch
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    for fn, item in ((ssd_ops.ssd_scan, "item 9.7"),
                     (flash_ops.flash_attention_latent, "item 9.8"),
                     (decode_ops.decode_attention, "item 9.5"),
                     (decode_ops.decode_attention_latent, "item 9.5")):
        src = inspect.getsource(fn)
        cpu = src.index('if dev.type == "cpu":')
        refuse = src.index("refuse_grad(")
        launch = src.index("_build.lib()")
        assert cpu < refuse < launch, fn.__name__
        assert item in src[refuse:launch], fn.__name__
    # flash_attention is differentiable: its CUDA route is the Function
    src = inspect.getsource(flash_ops.flash_attention)
    assert "_FlashAttention.apply" in src and "refuse_grad" not in src

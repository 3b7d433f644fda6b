"""The serving slice as a whole: the port's hymba-1.5b (reduced: 4 layers —
global, window, window, global — window 16, float32) against the JAX
package on the same parameters (``params_from_jax``) and tokens: the
cache-free forward, prefill's last logits and cache, and 4 decode steps,
within rtol = atol = 1e-3.  On the CPU the port runs its kernels' plain
versions.  Also: the config copy, ``launch.serve`` on the CPU, and that
the default device raises without CUDA."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layer_windows as ref_layer_windows
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_config, list_configs, reduce_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                layer_windows, params_from_jax, prefill)

jax = pytest.importorskip("jax")
jnp = jax.numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-3, atol=1e-3)
B, S, N_PREFILL = 2, 48, 44
REDUCE = dict(dtype="float32", num_layers=4, sliding_window=16)


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_reduce_config(ref_get_config("hymba-1.5b"), **REDUCE)
    cfg = reduce_config(get_config("hymba-1.5b"), **REDUCE)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, tokens


def test_config_is_the_reference_config():
    ref = dataclasses.asdict(ref_get_config("hymba-1.5b"))
    assert dataclasses.asdict(get_config("hymba-1.5b")) == ref
    assert get_config("hymba-1.5b").param_count() == \
        ref_get_config("hymba-1.5b").param_count()
    assert dataclasses.asdict(reduce_config(get_config("hymba-1.5b"),
                                            **REDUCE)) == dataclasses.asdict(
        ref_reduce_config(ref_get_config("hymba-1.5b"), **REDUCE))
    assert "hymba-1.5b" in list_configs()
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_layer_windows_match_and_mix_global_and_window(models):
    ref_cfg, _, cfg, _, _ = models
    assert layer_windows(cfg) == ref_layer_windows(ref_cfg) == \
        [None, 16, 16, None]
    assert layer_windows(get_config("hymba-1.5b")) == ref_layer_windows(
        ref_get_config("hymba-1.5b"))


def test_params_carry_over(models):
    _, ref_params, cfg, params, _ = models
    assert len(params["blocks"]) == cfg.num_layers
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(
            params["blocks"][i]["ssm"]["w_in"].numpy(),
            np.asarray(ref_params["blocks"]["ssm"]["w_in"][i]))
    ported = init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    for i in range(cfg.num_layers):
        got = jax.tree.map(lambda t: tuple(t.shape), ported["blocks"][i])
        want = jax.tree.map(lambda s: s[1:], shapes["blocks"],
                            is_leaf=lambda x: isinstance(x, tuple))
        assert got == want


def test_forward_matches_reference(models):
    ref_cfg, ref_params, cfg, params, tokens = models
    want, *_ = ref_forward(ref_cfg, ref_params, jnp.asarray(tokens), chunk=32)
    got, cache = forward(cfg, params, torch.from_numpy(tokens).long())
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_reference(models):
    ref_cfg, ref_params, cfg, params, tokens = models
    ref_last, ref_cache = ref_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(tokens[:, :N_PREFILL])},
        max_len=S, chunk=32)
    last, cache = prefill(cfg, params,
                          {"tokens": torch.from_numpy(tokens[:, :N_PREFILL])},
                          max_len=S)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    for i, (lc, rc) in enumerate(zip(cache["layers"], ref_cache["layers"])):
        for key in ("k", "v", "pos"):
            np.testing.assert_allclose(lc["attn"][key].numpy(),
                                       np.asarray(rc["attn"][key]), **TOL,
                                       err_msg=f"layer {i} attn {key}")
        assert lc["attn"]["cursor"] == int(rc["attn"]["cursor"]) == N_PREFILL
        for key in ("conv", "h"):
            np.testing.assert_allclose(lc["ssm"][key].numpy(),
                                       np.asarray(rc["ssm"][key]), **TOL,
                                       err_msg=f"layer {i} ssm {key}")
    for t in range(N_PREFILL, S):
        pos = np.full((B, 1), t, np.int32)
        want, ref_cache = ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(tokens[:, t:t + 1]),
            jnp.asarray(pos), chunk=32)
        got, cache = decode_step(cfg, params, cache,
                                 torch.from_numpy(tokens[:, t:t + 1]),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"decode at t={t}")


def test_teacher_forced_decode_matches_forward(models):
    # the port's own cache consistency, past the window (48 > 16)
    _, _, cfg, params, tokens = models
    full, _ = forward(cfg, params, torch.from_numpy(tokens))
    last, cache = prefill(cfg, params,
                          {"tokens": torch.from_numpy(tokens[:, :8])},
                          max_len=S)
    np.testing.assert_allclose(last.numpy(), full[:, 7].numpy(), rtol=2e-3,
                               atol=2e-3)
    for t in range(8, S):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        got, cache = decode_step(cfg, params, cache,
                                 torch.from_numpy(tokens[:, t:t + 1]), pos)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_window_ring_cache_decode_matches_forward(models):
    # window-only caches (ring buffers of 16 slots) wrap; decode token by
    # token from an empty cache and hold every step against the forward
    _, _, cfg, params, tokens = models
    full, _ = forward(cfg, params, torch.from_numpy(tokens))
    cache = init_cache(cfg, B, S, window_only=True, device="cpu")
    assert [c["attn"]["k"].shape[1] for c in cache["layers"]] == \
        [S, 16, 16, S]
    for t in range(S):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        got, cache = decode_step(cfg, params, cache,
                                 torch.from_numpy(tokens[:, t:t + 1]), pos)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_uncovered_attention_cases_raise(models):
    _, _, cfg, params, tokens = models
    tok = torch.from_numpy(tokens)
    with pytest.raises(NotImplementedError):   # prefill into a used cache
        _, cache = prefill(cfg, params, {"tokens": tok[:, :8]}, max_len=S)
        pos = torch.arange(8, 16, dtype=torch.int32).expand(B, 8)
        decode_step(cfg, params, cache, tok[:, 8:16], pos)
    with pytest.raises(NotImplementedError):   # shifted positions, no cache
        forward(cfg, params, tok[:, :8],
                positions=torch.arange(3, 11).expand(B, 8))
    with pytest.raises(ValueError):   # a prompt shorter than its patches
        vlm = get_config("hymba-1.5b").__class__(
            name="s", family="vlm", num_layers=1, d_model=8, num_heads=2,
            num_kv_heads=1, d_ff=8, vocab_size=16,
            frontend="vision_patches", frontend_len=4)
        forward(vlm, init_params(vlm, device="cpu"), tok[:, :3] % 16,
                frontend_embeds=torch.zeros((B, 4, 8)))


def test_serve_runs_on_cpu_and_counts_no_launches():
    cfg, params = serve_mod.load_model("hymba-1.5b", reduced=True,
                                       device="cpu", num_layers=4,
                                       sliding_window=16)
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
    before = [k.launches for k in (flash_attention.flash_attention,
                                   decode_attention.decode_attention,
                                   ssd_scan.ssd_scan)]
    res = serve_mod.serve(cfg, params, requests=3, batch=2, prefill_len=20,
                          decode_len=4)
    assert res["batches"] == 2 and res["decode_tokens"] == 16
    assert res["prefill_tokens"] == 80
    assert res["logits"].shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(res["logits"]).all())
    assert res["generated"].shape == (2, 4)
    after = [k.launches for k in (flash_attention.flash_attention,
                                  decode_attention.decode_attention,
                                  ssd_scan.ssd_scan)]
    assert after == before


def test_serve_cli_on_cpu(capsys):
    assert serve_mod.main(["--arch", "hymba-1.5b", "--reduced", "--requests",
                           "2", "--batch", "2", "--prefill-len", "12",
                           "--decode-len", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "on cpu" in out


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.main(["--arch", "hymba-1.5b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_mod.load_model("hymba-1.5b", reduced=True)
    cfg = reduce_config(get_config("hymba-1.5b"), **REDUCE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)


def test_serving_path_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "from repro_torch.launch.serve import load_model, serve\n"
        "cfg, p = load_model('hymba-1.5b', reduced=True, device='cpu')\n"
        "serve(cfg, p, requests=1, batch=1, prefill_len=8, decode_len=2)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout

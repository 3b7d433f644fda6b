"""The pure-SSM serving slice: mamba2-2.7b.  The config copy against the
JAX package's, and two reduced models (float32, 3 layers) on the same
parameters (``params_from_jax``) and tokens: ``reduce_config``'s default
(state 16, head_dim 16, chunk 32) and one that keeps mamba2's published
SSM widths (state 128, head_dim 64, chunk 256; d_model 128, so 4 heads)
over a prompt of three chunks whose prefill ends in a part chunk.  On
each: the cache-free forward, prefill's last logits, the per-layer
conv / state cache against the reference's layer-stacked cache (slice by
slice) and 4 teacher-forced decode steps, within rtol = atol = 1e-3.  On
the CPU the port runs ssd_scan's plain version.  Also the port's own
decode against its forward, and ``launch.serve`` on the CPU."""

import dataclasses

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
from repro_torch.models.blocks import block_kind

jax = pytest.importorskip("jax")
jnp = jax.numpy

ARCH = "mamba2-2.7b"
TOL = dict(rtol=1e-3, atol=1e-3)
B = 2
# reduction -> (prompt length, prefill length): the default's chunk is 32,
# the published widths' 256, so each prompt spans more than two chunks
# and each prefill ends inside a chunk
LENGTHS = {"default": (48, 44), "published-ssm": (600, 596)}


def _reduce(get, reduce, kind):
    extra = {} if kind == "default" else {"ssm": get(ARCH).ssm}
    return reduce(get(ARCH), dtype="float32", num_layers=3, **extra)


@pytest.fixture(scope="module", params=list(LENGTHS))
def models(request):
    kind = request.param
    ref_cfg = _reduce(ref_get_config, ref_reduce_config, kind)
    cfg = _reduce(get_config, reduce_config, kind)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    s, n_prefill = LENGTHS[kind]
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, tokens, n_prefill


def test_config_is_the_reference_config():
    assert ARCH in list_configs()
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    for kind in LENGTHS:
        assert dataclasses.asdict(_reduce(get_config, reduce_config, kind)) \
            == dataclasses.asdict(_reduce(ref_get_config, ref_reduce_config,
                                          kind))
    # published: 64 layers, 80 SSM heads of 64, d_inner 5 120, no FFN
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (64, 2560, 50280)
    assert cfg.attention == "none" and cfg.d_ff == 0
    s = cfg.ssm
    assert (s.state_dim, s.head_dim, s.expand, s.conv_width,
            s.chunk_size) == (128, 64, 2, 4, 256)
    assert cfg.d_model * s.expand // s.head_dim == 80
    assert block_kind(cfg) == "ssm"


def test_published_ssm_reduction_keeps_the_widths():
    small = _reduce(get_config, reduce_config, "published-ssm")
    assert small.ssm == get_config(ARCH).ssm
    assert small.d_model * small.ssm.expand // small.ssm.head_dim == 4
    assert small.family == "ssm" and small.num_layers == 3


def test_layer_windows_match(models):
    ref_cfg, _, cfg, *_ = models
    assert layer_windows(cfg) == ref_layer_windows(ref_cfg) == [None] * 3
    assert layer_windows(get_config(ARCH)) == [None] * 64


def test_params_carry_over(models):
    _, ref_params, cfg, params, *_ = models
    assert set(params) == set(ref_params) == {"embed", "unembed",
                                              "final_norm", "blocks"}
    assert len(params["blocks"]) == cfg.num_layers
    ported = init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    want = jax.tree.map(lambda s: s[1:], shapes["blocks"],
                        is_leaf=lambda x: isinstance(x, tuple))
    for i in range(cfg.num_layers):
        # no attention, no FFN: the block is ln_ssm and the mamba2 mixer
        assert set(params["blocks"][i]) == {"ln_ssm", "ssm"}
        assert jax.tree.map(lambda t: tuple(t.shape),
                            ported["blocks"][i]) == want
        for key in ("w_in", "conv_w", "w_out"):
            np.testing.assert_array_equal(
                params["blocks"][i]["ssm"][key].numpy(),
                np.asarray(ref_params["blocks"]["ssm"][key][i]))


def test_cache_holds_only_the_ssm_state(models):
    _, _, cfg, *_ = models
    short = init_cache(cfg, B, 8, device="cpu")
    long = init_cache(cfg, B, 4096, device="cpu")
    s = cfg.ssm
    nh = cfg.d_model * s.expand // s.head_dim
    for a, b in zip(short["layers"], long["layers"]):
        assert set(a) == {"ssm"} and set(a["ssm"]) == {"conv", "h"}
        assert a["ssm"]["h"].shape == b["ssm"]["h"].shape == \
            (B, nh, s.head_dim, s.state_dim)
        assert a["ssm"]["conv"].shape == b["ssm"]["conv"].shape == \
            (B, s.conv_width - 1, cfg.d_model * s.expand + 2 * s.state_dim)


def test_prefill_cache_owns_its_conv_window(models):
    # the conv state is a copy of the last W-1 inputs, not a view that
    # keeps the whole prefill's input alive in every layer's cache
    _, _, cfg, params, tokens, n_prefill = models
    _, cache = prefill(cfg, params,
                       {"tokens": torch.from_numpy(tokens[:, :n_prefill])})
    for lc in cache["layers"]:
        conv = lc["ssm"]["conv"]
        assert conv.untyped_storage().nbytes() == \
            conv.numel() * conv.element_size()


def test_forward_matches_reference(models):
    ref_cfg, ref_params, cfg, params, tokens, _ = models
    want, *_ = ref_forward(ref_cfg, ref_params, jnp.asarray(tokens))
    got, cache = forward(cfg, params, torch.from_numpy(tokens).long())
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_cache_and_decode_match_reference(models):
    ref_cfg, ref_params, cfg, params, tokens, n_prefill = models
    s = tokens.shape[1]
    ref_last, ref_cache = ref_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(tokens[:, :n_prefill])},
        max_len=s)
    last, cache = prefill(cfg, params,
                          {"tokens": torch.from_numpy(tokens[:, :n_prefill])},
                          max_len=s)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    # the reference scans the SSM layers over one layer-stacked cache
    stacked = ref_cache["layers"]
    assert set(stacked) == {"ssm"}
    assert len(cache["layers"]) == cfg.num_layers
    for i, lc in enumerate(cache["layers"]):
        assert set(lc) == {"ssm"}
        for key in ("conv", "h"):
            np.testing.assert_allclose(lc["ssm"][key].numpy(),
                                       np.asarray(stacked["ssm"][key][i]),
                                       **TOL, err_msg=f"layer {i} {key}")
    for t in range(n_prefill, s):
        pos = np.full((B, 1), t, np.int32)
        want, ref_cache = ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(tokens[:, t:t + 1]),
            jnp.asarray(pos))
        got, cache = decode_step(cfg, params, cache,
                                 torch.from_numpy(tokens[:, t:t + 1]),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"decode at t={t}")
    for i, lc in enumerate(cache["layers"]):
        np.testing.assert_allclose(lc["ssm"]["h"].numpy(),
                                   np.asarray(ref_cache["layers"]["ssm"]["h"]
                                              [i]), **TOL)


def test_teacher_forced_decode_matches_forward(models):
    # the port's own cache consistency: prefill a few tokens, decode the
    # rest of the first chunk and past it
    _, _, cfg, params, tokens, n_prefill = models
    tok = torch.from_numpy(tokens)
    full, _ = forward(cfg, params, tok)
    start = n_prefill - 8
    last, cache = prefill(cfg, params, {"tokens": tok[:, :start]})
    np.testing.assert_allclose(last.numpy(), full[:, start - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(start, tokens.shape[1]):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        got, cache = decode_step(cfg, params, cache, tok[:, t:t + 1], pos)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"decode at t={t}")


def test_serve_runs_on_cpu_and_counts_no_launches():
    from repro_torch.kernels import decode_attention, flash_attention, ssd_scan
    cfg, params = serve_mod.load_model(ARCH, reduced=True, device="cpu",
                                       num_layers=2)
    kernels = (flash_attention.flash_attention,
               decode_attention.decode_attention, ssd_scan.ssd_scan)
    before = [k.launches for k in kernels]
    res = serve_mod.serve(cfg, params, requests=3, batch=2, prefill_len=40,
                          decode_len=4)
    assert res["batches"] == 2 and res["decode_tokens"] == 16
    assert res["logits"].shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(res["logits"]).all())
    assert [k.launches for k in kernels] == before


def test_serve_cli_on_cpu(capsys):
    assert serve_mod.main(["--arch", ARCH, "--reduced", "--requests", "2",
                           "--batch", "2", "--prefill-len", "40",
                           "--decode-len", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "on cpu" in out

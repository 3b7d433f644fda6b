"""The dense-GQA serving slice: glm4-9b, olmo-1b, h2o-danube-1.8b and
nemotron-4-15b.  For each, the config copy against the JAX package's, and
a reduced model (float32, 3 layers, the published head_dim and query heads
per KV head kept through ``reduce_config`` overrides) on the same
parameters (``params_from_jax``) and tokens: the cache-free forward,
prefill's last logits, the per-layer cache against the reference's
layer-stacked cache (slice by slice) and 4 teacher-forced decode steps,
within rtol = atol = 1e-3.  On the CPU the port runs its kernels' plain
versions.  Also the layer pieces the dense family adds (LayerNorm,
non-parametric LN, the non-gated MLPs), GQA attention at head_dim 80 and
128 with 16 query heads per KV head, and ``launch.serve`` on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.models import attention as ref_attention
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import layer_windows as ref_layer_windows
from repro.models import layers as ref_layers
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_config, list_configs, reduce_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (attention, decode_step, forward, init_cache,
                                init_params, layer_windows, layers,
                                params_from_jax, prefill)

jax = pytest.importorskip("jax")
jnp = jax.numpy

TOL = dict(rtol=1e-3, atol=1e-3)
B, S, N_PREFILL = 2, 48, 44
ARCHS = ("glm4-9b", "olmo-1b", "h2o-danube-1.8b", "nemotron-4-15b")
# the default reduction gives head_dim 32 and its own G (olmo 4, nemotron
# 4); these keep each arch's published head_dim and G = H / K
REDUCE = {
    "glm4-9b": dict(num_heads=16, num_kv_heads=1, head_dim=128),
    "olmo-1b": dict(num_heads=4, num_kv_heads=4, head_dim=128),
    "h2o-danube-1.8b": dict(num_heads=8, num_kv_heads=2, head_dim=80,
                            sliding_window=16),
    "nemotron-4-15b": dict(num_heads=6, num_kv_heads=1, head_dim=128),
}


def _reduce(get, reduce, arch):
    return reduce(get(arch), dtype="float32", num_layers=3, **REDUCE[arch])


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    arch = request.param
    ref_cfg = _reduce(ref_get_config, ref_reduce_config, arch)
    cfg = _reduce(get_config, reduce_config, arch)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    assert arch in list_configs()
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert dataclasses.asdict(_reduce(get_config, reduce_config, arch)) == \
        dataclasses.asdict(_reduce(ref_get_config, ref_reduce_config, arch))


def test_reduced_models_keep_the_published_head_dim_and_group():
    for arch in ARCHS:
        full = get_config(arch)
        small = _reduce(get_config, reduce_config, arch)
        assert small.resolved_head_dim == full.resolved_head_dim, arch
        assert (small.num_heads // small.num_kv_heads
                == full.num_heads // full.num_kv_heads), arch
        assert small.family == "dense" and small.attention == "gqa"


def test_layer_windows_match(models):
    ref_cfg, _, cfg, _, _ = models
    assert layer_windows(cfg) == ref_layer_windows(ref_cfg)
    full = get_config(cfg.name[:-len("-smoke")])
    assert layer_windows(full) == [full.sliding_window] * full.num_layers


def test_params_carry_over(models):
    _, ref_params, cfg, params, _ = models
    assert len(params["blocks"]) == cfg.num_layers
    assert ("unembed" in params) == (not cfg.tie_embeddings)
    ported = init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    for i in range(cfg.num_layers):
        got = jax.tree.map(lambda t: tuple(t.shape), ported["blocks"][i])
        want = jax.tree.map(lambda s: s[1:], shapes["blocks"],
                            is_leaf=lambda x: isinstance(x, tuple))
        assert got == want
        assert set(params["blocks"][i]) == {"ln_attn", "attn", "ln_mlp",
                                            "mlp"}
        np.testing.assert_array_equal(
            params["blocks"][i]["mlp"]["wo"].numpy(),
            np.asarray(ref_params["blocks"]["mlp"]["wo"][i]))
    assert set(ported) == set(ref_params)
    if cfg.norm == "nonparametric_ln":
        assert params["final_norm"] == {} == ported["final_norm"]
        assert params["blocks"][0]["ln_attn"] == {}
    if cfg.norm == "layernorm":
        assert set(params["blocks"][0]["ln_mlp"]) == {"scale", "bias"}


def test_forward_matches_reference(models):
    ref_cfg, ref_params, cfg, params, tokens = models
    want, *_ = ref_forward(ref_cfg, ref_params, jnp.asarray(tokens), chunk=32)
    got, cache = forward(cfg, params, torch.from_numpy(tokens).long())
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_cache_and_decode_match_reference(models):
    ref_cfg, ref_params, cfg, params, tokens = models
    ref_last, ref_cache = ref_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(tokens[:, :N_PREFILL])},
        max_len=S, chunk=32)
    last, cache = prefill(cfg, params,
                          {"tokens": torch.from_numpy(tokens[:, :N_PREFILL])},
                          max_len=S)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    # the reference scans the dense layers over one layer-stacked cache
    stacked = ref_cache["layers"]
    assert set(stacked) == {"attn"}
    assert len(cache["layers"]) == cfg.num_layers
    for i, lc in enumerate(cache["layers"]):
        assert set(lc) == {"attn"}
        for key in ("k", "v", "pos"):
            np.testing.assert_allclose(lc["attn"][key].numpy(),
                                       np.asarray(stacked["attn"][key][i]),
                                       **TOL, err_msg=f"layer {i} {key}")
        assert lc["attn"]["cursor"] == int(stacked["attn"]["cursor"][i]) \
            == N_PREFILL
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
    # the port's own cache consistency; danube's window (16) is passed
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


def test_window_ring_cache_decode_matches_forward():
    # danube's window-only caches (ring buffers of 16 slots) wrap
    cfg = _reduce(get_config, reduce_config, "h2o-danube-1.8b")
    params = init_params(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, 40)))
    full, _ = forward(cfg, params, tokens)
    cache = init_cache(cfg, B, 40, window_only=True, device="cpu")
    assert [c["attn"]["k"].shape[1] for c in cache["layers"]] == [16] * 3
    for t in range(40):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        got, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1], pos)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    assert serve_mod.main(["--arch", arch, "--reduced", "--requests", "2",
                           "--batch", "2", "--prefill-len", "12",
                           "--decode-len", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "on cpu" in out


FRONTEND_FAMILIES = {   # case -> config overrides of the reduced glm4-9b
    "vlm": dict(family="vlm", frontend="vision_patches", frontend_len=8),
    "encoder-decoder": dict(family="encdec", encoder_layers=2,
                            frontend="audio_frames", frontend_len=8),
}


@pytest.mark.parametrize("case", list(FRONTEND_FAMILIES))
def test_unported_families_name_their_roadmap_item(case):
    """The frontend families on a dense config build the reference's
    parameter groups, layer for layer, and run a forward."""
    overrides = FRONTEND_FAMILIES[case]
    cfg = dataclasses.replace(
        reduce_config(get_config("glm4-9b"), dtype="float32"), **overrides)
    ref_cfg = dataclasses.replace(
        ref_reduce_config(ref_get_config("glm4-9b"), dtype="float32"),
        **overrides)
    params = init_params(cfg, device="cpu")
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    assert set(params) == set(ref_params)
    for group in ("blocks", "enc_blocks"):
        if group in ref_params:
            assert set(params[group][0]) == set(ref_params[group])
    assert ("enc_blocks" in params) == (case == "encoder-decoder")
    assert ("cross" in params["blocks"][0]) == (case == "encoder-decoder")
    frames = torch.ones((1, 8, cfg.d_model))
    logits, _ = forward(cfg, params, torch.zeros((1, 9), dtype=torch.long),
                        frontend_embeds=frames)
    assert logits.shape == (1, 9, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_params_from_jax_refuses_unported_groups(models):
    _, ref_params, cfg, _, _ = models
    tree = dict(jax.tree.map(np.asarray, ref_params))
    for group in ("dense_blocks", "enc_blocks", "mtp", "frontend_proj"):
        with pytest.raises(NotImplementedError, match=f"{group} only with"):
            params_from_jax(cfg, dict(tree, **{group: {}}), device="cpu")


# ----------------------------------------------------------- layer pieces
DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-5)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-2, atol=2e-2))}


def _to_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["layernorm", "nonparametric_ln",
                                  "rmsnorm"])
def test_norms_match_reference(kind, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 96)) * 3 + 0.5).astype(np.float32)
    ref_p = ref_layers.init_norm(kind, 96, jdt)
    if kind == "layernorm":
        ref_p = {"scale": jnp.asarray(rng.standard_normal(96), jdt),
                 "bias": jnp.asarray(rng.standard_normal(96), jdt)}
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt)
         for k, v in ref_p.items()}
    assert set(p) == set(layers.init_norm(kind, 96, tdt))
    want = ref_layers.apply_norm(kind, ref_p, jnp.asarray(x, jdt))
    got = layers.apply_norm(kind, p, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_to_np(got), np.asarray(want, np.float32),
                               **tol)


@pytest.mark.parametrize("kind", ["layernorm", "nonparametric_ln"])
def test_norm_uses_the_population_variance_on_short_rows(kind):
    # with 2 or 3 values a row, var / (n - 1) differs from var / n by a
    # factor of 2 or 1.5: the unbiased form would miss by ~20-40%
    x = np.array([[1.0, 3.0], [0.0, 10.0], [2.0, -2.0]], np.float32)
    x3 = np.array([[1.0, 2.0, 6.0], [-4.0, 0.5, 0.0]], np.float32)
    for arr in (x, x3):
        d = arr.shape[-1]
        ref_p = ref_layers.init_norm(kind, d, jnp.float32)
        p = layers.init_norm(kind, d, torch.float32)
        want = np.asarray(ref_layers.apply_norm(kind, ref_p,
                                                jnp.asarray(arr)))
        got = layers.apply_norm(kind, p, torch.from_numpy(arr)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        xt = torch.from_numpy(arr)
        unbiased = ((xt - xt.mean(-1, keepdim=True))
                    * torch.rsqrt(xt.var(-1, keepdim=True) + 1e-6)).numpy()
        assert np.abs(unbiased - want).max() > 0.1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["squared_relu", "gelu", "swiglu"])
def test_mlps_match_reference(kind, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    ref_p = ref_layers.init_mlp(jax.random.PRNGKey(1), kind, 64, 160, jdt)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt)
         for k, v in ref_p.items()}
    ported = layers.init_mlp(torch.Generator().manual_seed(0), kind, 64, 160,
                             tdt)
    assert {k: tuple(v.shape) for k, v in ported.items()} == \
        {k: tuple(v.shape) for k, v in ref_p.items()}
    x = np.random.default_rng(6).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = ref_layers.apply_mlp(kind, ref_p, jnp.asarray(x, jdt))
    got = layers.apply_mlp(kind, p, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_to_np(got), np.asarray(want, np.float32),
                               **tol)


def test_unembed_in_row_pieces_matches_the_whole_product(monkeypatch):
    monkeypatch.setattr(layers, "UNEMBED_ROWS", 100)
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((1031, 32)).astype(
        np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(
        np.float32)).bfloat16()
    got = layers.unembed({"table": table}, x)
    want = ref_layers.unembed({"table": jnp.asarray(table.float().numpy(),
                                                    jnp.bfloat16)},
                              jnp.asarray(x.float().numpy(), jnp.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 1031)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ GQA at D 80 / 128
GQA_CASES = [   # head_dim, H, K, window
    (128, 16, 1, None), (128, 32, 2, 12), (80, 16, 1, None), (80, 16, 1, 12),
]


def _gqa(head_dim, h, kv):
    cfg = dataclasses.replace(
        reduce_config(get_config("glm4-9b"), dtype="float32"),
        num_heads=h, num_kv_heads=kv, head_dim=head_dim)
    ref_cfg = dataclasses.replace(
        ref_reduce_config(ref_get_config("glm4-9b"), dtype="float32"),
        num_heads=h, num_kv_heads=kv, head_dim=head_dim)
    ref_p = ref_attention.init_gqa(jax.random.PRNGKey(2), ref_cfg,
                                   jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    return cfg, ref_cfg, p, ref_p


@pytest.mark.parametrize("case", GQA_CASES,
                         ids=lambda c: "D{}-H{}-K{}-w{}".format(*c))
def test_gqa_attention_matches_reference(case):
    head_dim, h, kv, window = case
    cfg, ref_cfg, p, ref_p = _gqa(head_dim, h, kv)
    assert cfg.num_heads // cfg.num_kv_heads == 16
    s, n_pre = 30, 26
    x = np.random.default_rng(8).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (B, s)).copy()
    # cache-free
    want, _ = ref_attention.gqa_attention(ref_p, ref_cfg, jnp.asarray(x),
                                          jnp.asarray(pos), window=window,
                                          chunk=8)
    got, none = attention.gqa_attention(p, cfg, torch.from_numpy(x),
                                        torch.from_numpy(pos), window=window)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # prefill into an empty cache, then one-token decode steps
    rc = ref_attention.init_gqa_cache(ref_cfg, B, s, jnp.float32)
    c = attention.init_gqa_cache(cfg, B, s, torch.float32, device="cpu")
    want, rc = ref_attention.gqa_attention(
        ref_p, ref_cfg, jnp.asarray(x[:, :n_pre]), jnp.asarray(pos[:, :n_pre]),
        window=window, kv_cache=rc, chunk=8)
    got, c = attention.gqa_attention(
        p, cfg, torch.from_numpy(x[:, :n_pre]),
        torch.from_numpy(pos[:, :n_pre]), window=window, kv_cache=c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(n_pre, s):
        want, rc = ref_attention.gqa_attention(
            ref_p, ref_cfg, jnp.asarray(x[:, t:t + 1]),
            jnp.asarray(pos[:, t:t + 1]), window=window, kv_cache=rc,
            chunk=8)
        got, c = attention.gqa_attention(
            p, cfg, torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(pos[:, t:t + 1]), window=window, kv_cache=c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"decode t={t}")
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(rc[key]), **TOL)

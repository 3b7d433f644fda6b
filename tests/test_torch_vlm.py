"""The VLM serving slice: internvl2-2b.

The config copy against the JAX package's; then the reduced config in f32
(2 layers, d_model 128, 4 heads of 32 over one KV head, 8 patches) on the
reference's parameters (``params_from_jax``) and the same seeded tokens
and patches: ``_embed_inputs`` (the projected patches in place of the
first F token embeddings) within 1e-6, the patch projection in bf16
within one bf16 ulp, the cache-free forward within 1e-4, and prefill with
the patches followed by teacher-forced decode within 2e-3 of the forward.
The refused prompt shorter than the patches, the parameter groups and
``launch.serve`` on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import model as ref_model
from repro_torch.configs import get_config, list_configs, reduce_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (decode_step, forward, init_params, model,
                                params_from_jax, prefill)
from repro_torch.models.blocks import block_kind

jax = pytest.importorskip("jax")
jnp = jax.numpy

ARCH = "internvl2-2b"
TOL = dict(rtol=1e-4, atol=1e-4)          # the model's logits, f32
TF_TOL = dict(rtol=2e-3, atol=2e-3)       # decode against the forward
B, S, N_PREFILL = 2, 16, 10


def _reduced(get, reduce, dtype="float32"):
    return reduce(get(ARCH), dtype=dtype)


@pytest.fixture(scope="module")
def models():
    ref_cfg = _reduced(ref_get_config, ref_reduce_config)
    cfg = _reduced(get_config, reduce_config)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.frontend_len, cfg.d_model),
                                  dtype=np.float32)
    return ref_cfg, ref_params, cfg, params, tokens, patches


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_is_the_reference_config():
    assert ARCH in list_configs()
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert dataclasses.asdict(_reduced(get_config, reduce_config)) == \
        dataclasses.asdict(_reduced(ref_get_config, ref_reduce_config))
    assert block_kind(cfg) == "dense" and not cfg.encoder_layers
    # published: 24 layers, 16 / 8 heads of 128 (G 2), 256 stub patches
    assert (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.frontend_len) == (24, 16, 8, 128, 256)


def test_init_params_builds_the_reference_groups(models):
    _, ref_params, cfg, params, _, _ = models
    own = init_params(cfg, device="cpu")
    assert set(own) == set(ref_params) == set(params) == {
        "embed", "unembed", "final_norm", "blocks", "frontend_proj"}
    assert set(own["blocks"][0]) == set(ref_params["blocks"]) == {
        "ln_attn", "attn", "ln_mlp", "mlp"}
    np.testing.assert_array_equal(params["frontend_proj"].numpy(),
                                  np.asarray(ref_params["frontend_proj"]))
    # no encoder here: its groups are refused, naming encoder_layers
    tree = jax.tree.map(np.asarray, ref_params)
    with pytest.raises(NotImplementedError,
                       match="enc_blocks only with encoder_layers"):
        params_from_jax(cfg, dict(tree, enc_blocks=tree["blocks"]),
                        device="cpu")


def test_embed_inputs_matches_reference(models):
    ref_cfg, ref_params, cfg, params, tokens, patches = models
    want = ref_model._embed_inputs(ref_cfg, ref_params, jnp.asarray(tokens),
                                   jnp.asarray(patches))
    got = model._embed_inputs(cfg, params, _t(tokens).long(), _t(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # past the patches the token embeddings stand as they were
    f = cfg.frontend_len
    np.testing.assert_array_equal(
        got[:, f:].numpy(), params["embed"]["table"][_t(tokens[:, f:]).long()]
        .numpy())


def test_patch_projection_in_bf16_is_the_reference_promotion():
    ref_cfg = _reduced(ref_get_config, ref_reduce_config, "bfloat16")
    cfg = _reduced(get_config, reduce_config, "bfloat16")
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.frontend_len, cfg.d_model),
                                  dtype=np.float32)
    want = np.asarray(ref_model._embed_inputs(
        ref_cfg, ref_params, jnp.asarray(tokens), jnp.asarray(patches)),
        np.float32)
    got = model._embed_inputs(cfg, params, _t(tokens).long(), _t(patches))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-6)


def test_forward_matches_reference(models):
    ref_cfg, ref_params, cfg, params, tokens, patches = models
    want, _, _, _ = ref_forward(ref_cfg, ref_params, jnp.asarray(tokens),
                                frontend_embeds=jnp.asarray(patches),
                                chunk=16)
    got, _ = forward(cfg, params, _t(tokens).long(),
                     frontend_embeds=_t(patches))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the patches decide the first F positions, whatever tokens sit there
    other = tokens.copy()
    other[:, :cfg.frontend_len] = (other[:, :cfg.frontend_len] + 1) % \
        cfg.vocab_size
    again, _ = forward(cfg, params, _t(other).long(),
                       frontend_embeds=_t(patches))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_prefill_then_decode_matches_forward(models):
    _, _, cfg, params, tokens, patches = models
    tok = _t(tokens).long()
    full, _ = forward(cfg, params, tok, frontend_embeds=_t(patches))
    last, cache = prefill(cfg, params, {"tokens": tok[:, :N_PREFILL],
                                        "frontend": _t(patches)},
                          max_len=S)
    assert cache["encoder"] is None
    np.testing.assert_allclose(last.numpy(), full[:, N_PREFILL - 1].numpy(),
                               **TF_TOL)
    for t in range(N_PREFILL, S):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        logits, cache = decode_step(cfg, params, cache, tok[:, t:t + 1], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **TF_TOL)


def test_prompt_shorter_than_the_patches_is_refused(models):
    _, _, cfg, params, tokens, patches = models
    short = _t(tokens[:, :cfg.frontend_len - 1]).long()
    with pytest.raises(ValueError, match="visual tokens"):
        forward(cfg, params, short, frontend_embeds=_t(patches))
    with pytest.raises(ValueError, match="visual tokens"):
        prefill(cfg, params, {"tokens": short, "frontend": _t(patches)})
    # a prompt of exactly F tokens is all patches
    exact, _ = forward(cfg, params, short[:, :1].expand(B, cfg.frontend_len),
                       frontend_embeds=_t(patches))
    assert exact.shape == (B, cfg.frontend_len, cfg.vocab_size)


def test_serve_feeds_patches_and_counts_no_launches():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention

    cfg, params = serve_mod.load_model(ARCH, reduced=True, device="cpu")
    before = (flash_attention.launches, decode_attention.launches)
    res = serve_mod.serve(cfg, params, requests=2, batch=2, prefill_len=12,
                          decode_len=3)
    assert (flash_attention.launches, decode_attention.launches) == before
    assert res["logits"].shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(res["logits"]).all())
    with pytest.raises(ValueError, match="visual tokens"):
        serve_mod.serve(cfg, params, requests=2, batch=2, prefill_len=4,
                        decode_len=1)


def test_serve_cli_on_cpu(capsys):
    assert serve_mod.main(["--arch", ARCH, "--reduced", "--requests", "2",
                           "--batch", "2", "--prefill-len", "12",
                           "--decode-len", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "on cpu" in out

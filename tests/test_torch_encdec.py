"""The encoder-decoder serving slice: seamless-m4t-medium.

The config copy against the JAX package's; then the reduced config in f32
(2 encoder and 2 decoder layers, d_model 128, 4 heads of 32 over one KV
head, 8 frames) on the reference's parameters (``params_from_jax``) and
the same seeded tokens and frames: the encoder stack (``_run_encoder``)
within 1e-5, a decoder layer's cross-attention at S != T (and one token,
the decode path) within 1e-5, the frame projection in bf16 within one
bf16 ulp, the cache-free forward within 1e-4, and prefill followed by
teacher-forced decode within 2e-3 of the forward, once with every decoder
position below the frame count.  The kernels' plain versions in the cases
this slice opens: flash non-causal at S != T against the reference's
Pallas kernel in interpret mode and its oracle, decode with the query past
the last encoder position against ``chunked_attention(causal=False)``.
The refused calls, the parameter groups and ``launch.serve`` on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.kernels.flash_attention.kernel import flash_attention as ref_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import attention as ref_attention
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import model as ref_model
from repro_torch.configs import get_config, list_configs, reduce_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (attention, decode_step, forward, init_params,
                                model, params_from_jax, prefill)
from repro_torch.models.blocks import block_kind

jax = pytest.importorskip("jax")
jnp = jax.numpy

ARCH = "seamless-m4t-medium"
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)   # one module, f32
TOL = dict(rtol=1e-4, atol=1e-4)          # the model's logits, f32
TF_TOL = dict(rtol=2e-3, atol=2e-3)       # decode against the forward
B, S = 2, 16


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
    frames = rng.standard_normal((B, cfg.frontend_len, cfg.d_model),
                                 dtype=np.float32)
    return ref_cfg, ref_params, cfg, params, tokens, frames


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_is_the_reference_config():
    assert ARCH in list_configs()
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert dataclasses.asdict(_reduced(get_config, reduce_config)) == \
        dataclasses.asdict(_reduced(ref_get_config, ref_reduce_config))
    assert block_kind(cfg) == "dense"
    # published: 12 + 12 layers of 16 heads of 64 (G 1), 1024 stub frames
    assert (cfg.encoder_layers, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim, cfg.frontend_len) == \
        (12, 12, 16, 16, 64, 1024)


def test_reduced_config_is_the_small_one(models):
    _, _, cfg, _, _, _ = models
    assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.resolved_head_dim, cfg.frontend_len) == \
        (2, 2, 128, 4, 1, 32, 8)


def test_init_params_builds_the_reference_groups(models):
    ref_cfg, ref_params, cfg, _, _, _ = models
    params = init_params(cfg, device="cpu")
    assert set(params) == set(ref_params) == {
        "embed", "unembed", "final_norm", "blocks", "enc_blocks",
        "enc_final_norm", "frontend_proj"}
    assert len(params["blocks"]) == cfg.num_layers
    assert len(params["enc_blocks"]) == cfg.encoder_layers
    # decoder layers carry the cross group, encoder layers do not
    for got, group in ((params["blocks"][0], "blocks"),
                       (params["enc_blocks"][0], "enc_blocks")):
        ref = ref_params[group]
        assert set(got) == set(ref)
        for name in got:
            for leaf, ref_leaf in ((got[name][k], ref[name][k])
                                   for k in got[name]):
                assert tuple(leaf.shape) == tuple(ref_leaf.shape[1:])
    assert {"ln_cross", "cross"} <= set(params["blocks"][0])
    assert not {"ln_cross", "cross"} & set(params["enc_blocks"][0])
    assert tuple(params["frontend_proj"].shape) == (cfg.d_model,
                                                    cfg.d_model)


def test_params_from_jax_round_trips_the_encoder_groups(models):
    _, ref_params, cfg, params, _, _ = models
    for i in range(cfg.encoder_layers):
        np.testing.assert_array_equal(
            params["enc_blocks"][i]["attn"]["wq"].numpy(),
            np.asarray(ref_params["enc_blocks"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            params["enc_blocks"][i]["ln_mlp"]["bias"].numpy(),
            np.asarray(ref_params["enc_blocks"]["ln_mlp"]["bias"][i]))
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(
            params["blocks"][i]["cross"]["wv"].numpy(),
            np.asarray(ref_params["blocks"]["cross"]["wv"][i]))
    np.testing.assert_array_equal(params["enc_final_norm"]["scale"].numpy(),
                                  np.asarray(ref_params["enc_final_norm"]
                                             ["scale"]))
    np.testing.assert_array_equal(params["frontend_proj"].numpy(),
                                  np.asarray(ref_params["frontend_proj"]))
    # a config without an encoder or a frontend refuses the groups, naming
    # the field that calls for each
    plain = dataclasses.replace(cfg, encoder_layers=0, frontend=None,
                                frontend_len=0)
    tree = jax.tree.map(np.asarray, ref_params)
    groups = {"enc_blocks": "encoder_layers",
              "enc_final_norm": "encoder_layers", "frontend_proj": "frontend"}
    base = {k: v for k, v in tree.items() if k not in groups}
    params_from_jax(plain, base, device="cpu")
    for group, field in groups.items():
        with pytest.raises(NotImplementedError,
                           match=f"{group} only with {field}"):
            params_from_jax(plain, dict(base, **{group: tree[group]}),
                            device="cpu")


def test_run_encoder_matches_reference(models):
    ref_cfg, ref_params, cfg, params, _, frames = models
    want_h, want_pos = ref_model._run_encoder(ref_cfg, ref_params,
                                              jnp.asarray(frames))
    got_h, got_pos = model._run_encoder(cfg, params, _t(frames))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               **MODULE_TOL)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    assert got_pos.is_contiguous() and got_pos.dtype == torch.int32


@pytest.mark.parametrize("s", [12, 5, 1])
def test_cross_attention_matches_reference(models, s):
    # S 12 and 5 run flash non-causal at S != T = 8; S 1 is decode's path,
    # at decoder positions on both sides of the frame count
    ref_cfg, ref_params, cfg, params, _, frames = models
    enc = ref_model._run_encoder(ref_cfg, ref_params, jnp.asarray(frames))
    lp = jax.tree.map(lambda a: a[1], ref_params["blocks"])
    ref_kv = ref_model._cross_kv_from(ref_cfg, lp, enc)
    x = np.random.default_rng(s).standard_normal(
        (B, s, cfg.d_model), dtype=np.float32)
    pos = np.array([[3], [11]] if s == 1 else
                   np.broadcast_to(np.arange(s), (B, s)), np.int32)
    want, _ = ref_attention.gqa_attention(
        lp["cross"], ref_cfg, jnp.asarray(x), jnp.asarray(pos),
        cross_kv=ref_kv)
    kv = model._cross_kv_from(cfg, params["blocks"][1],
                              model._run_encoder(cfg, params, _t(frames)))
    got, cache = attention.gqa_attention(params["blocks"][1]["cross"], cfg,
                                         _t(x), _t(pos), cross_kv=kv)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def test_frame_projection_in_bf16_is_the_reference_promotion():
    # f32 frames times the bf16 weight run in f32 and round once to bf16,
    # as JAX promotes the einsum; rounding the frames to bf16 first would
    # not
    ref_cfg = _reduced(ref_get_config, ref_reduce_config, dtype="bfloat16")
    cfg = _reduced(get_config, reduce_config, dtype="bfloat16")
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    frames = np.random.default_rng(2).standard_normal(
        (B, cfg.frontend_len, cfg.d_model), dtype=np.float32)
    want = np.asarray(jnp.einsum(
        "bfd,de->bfe", jnp.asarray(frames),
        ref_params["frontend_proj"]).astype(jnp.bfloat16), np.float32)
    got = model._project_frontend(params, _t(frames), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-6)
    early = (_t(frames).bfloat16() @ params["frontend_proj"]).float()
    assert not np.allclose(early.numpy(), want, rtol=2.0 ** -7, atol=1e-6)
    # and the encoder's output in bf16 stays near the reference's
    want_h, _ = ref_model._run_encoder(ref_cfg, ref_params,
                                       jnp.asarray(frames))
    got_h, _ = model._run_encoder(cfg, params, _t(frames))
    np.testing.assert_allclose(got_h.float().numpy(),
                               np.asarray(want_h, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_forward_matches_reference(models):
    ref_cfg, ref_params, cfg, params, tokens, frames = models
    want, _, _, _ = ref_forward(ref_cfg, ref_params, jnp.asarray(tokens),
                                frontend_embeds=jnp.asarray(frames),
                                chunk=16)
    got, cache = forward(cfg, params, _t(tokens).long(),
                         frontend_embeds=_t(frames))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_tokens,n_prefill", [(16, 10), (4, 2)])
def test_prefill_then_decode_matches_forward(models, n_tokens, n_prefill,
                                             monkeypatch):
    # (4, 2): a prompt shorter than the 8 frames, so every decode position
    # lies below the frame count (a query at the decoder's position would
    # hide frames there)
    _, _, cfg, params, tokens, frames = models
    tok = _t(tokens[:, :n_tokens]).long()
    full, _ = forward(cfg, params, tok, frontend_embeds=_t(frames))
    last, cache = prefill(cfg, params, {"tokens": tok[:, :n_prefill],
                                        "frontend": _t(frames)},
                          max_len=n_tokens)
    enc_h, enc_pos = cache["encoder"]
    assert tuple(enc_h.shape) == (B, cfg.frontend_len, cfg.d_model)
    np.testing.assert_allclose(last.numpy(), full[:, n_prefill - 1].numpy(),
                               **TF_TOL)

    def no_encoder(*args, **kw):
        raise AssertionError("decode re-ran the encoder")

    monkeypatch.setattr(model, "_run_encoder", no_encoder)
    for t in range(n_prefill, n_tokens):
        assert t < cfg.frontend_len or n_tokens > cfg.frontend_len
        pos = torch.full((B, 1), t, dtype=torch.int32)
        logits, cache = decode_step(cfg, params, cache, tok[:, t:t + 1], pos)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **TF_TOL)
        assert cache["encoder"][0] is enc_h


def test_encoder_decoder_needs_frames_or_a_cache(models):
    _, _, cfg, params, tokens, _ = models
    with pytest.raises(ValueError, match="frontend_embeds or cached"):
        forward(cfg, params, _t(tokens).long())
    with pytest.raises(ValueError, match="frontend_embeds or cached"):
        prefill(cfg, params, {"tokens": _t(tokens).long()})


# ------------------------------------------------- the kernels' new cases
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 4, 4, 128, 64, 64),
                                   (2, 4, 2, 64, 192, 32)],
                         ids=lambda s: "-".join(map(str, s)))
def test_flash_plain_non_causal_at_s_ne_t_matches_reference_kernel(shape,
                                                                   dtype):
    b, h, kh, s, t, d = shape
    jdtype, tdtype, tol = {
        "f32": (jnp.float32, torch.float32, dict(rtol=2e-4, atol=2e-4)),
        "bf16": (jnp.bfloat16, torch.bfloat16,
                 dict(rtol=2e-2, atol=2e-2))}[dtype]
    rng = np.random.default_rng(s + t)
    arrs = (rng.standard_normal((b, s, h, d), dtype=np.float32),
            rng.standard_normal((b, t, kh, d), dtype=np.float32),
            rng.standard_normal((b, t, kh, d), dtype=np.float32))
    got = flash_ops.flash_attention(*(_t(a).to(tdtype) for a in arrs),
                                    causal=False).float().numpy()
    q, k, v = (jnp.asarray(a, jdtype).transpose(0, 2, 1, 3) for a in arrs)
    interp = ref_kernel(q, k, v, causal=False, block_q=64, block_kv=64,
                        interpret=True)
    oracle = flash_attention_ref(q, k, v, causal=False)
    for want in (interp, oracle):
        np.testing.assert_allclose(
            got, np.asarray(want.transpose(0, 2, 1, 3), np.float32), **tol)
    # the causal variant is a different function here
    causal = flash_ops.flash_attention_plain(
        *(_t(a) for a in arrs), causal=True).numpy()
    assert not np.allclose(causal, np.asarray(
        oracle.transpose(0, 2, 1, 3), np.float32), **tol)


def test_decode_plain_past_the_last_encoder_position_is_non_causal():
    b, h, kh, t, d = 3, 4, 1, 40, 32
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    k = rng.standard_normal((b, t, kh, d), dtype=np.float32)
    v = rng.standard_normal((b, t, kh, d), dtype=np.float32)
    kv_pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    want = ref_attention.chunked_attention(
        jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.array([[2], [39], [100]], np.int32)),
        jnp.asarray(kv_pos), causal=False, chunk=16)[:, 0]
    for q_pos in ([t - 1] * b, [t - 1, t, 5000]):
        got = decode_ops.decode_attention(
            _t(q), _t(k), _t(v), _t(kv_pos), _t(np.array(q_pos, np.int32)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODULE_TOL)
    # a query at a decoder position below the frames would hide some
    low = decode_ops.decode_attention_plain(
        _t(q), _t(k), _t(v), _t(kv_pos), _t(np.array([2, 39, 10],
                                                      np.int32)))
    assert not np.allclose(low.numpy(), np.asarray(want), **MODULE_TOL)


# ------------------------------------------------------------- serving
def test_serve_feeds_frames_and_counts_no_launches():
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention

    cfg, params = serve_mod.load_model(ARCH, reduced=True, device="cpu")
    before = (flash_attention.launches, decode_attention.launches)
    res = serve_mod.serve(cfg, params, requests=3, batch=2, prefill_len=5,
                          decode_len=3)
    assert (flash_attention.launches, decode_attention.launches) == before
    assert res["batches"] == 2 and res["decode_tokens"] == 12
    assert res["logits"].shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(res["logits"]).all())
    # the frames come from the seeded generator: a second run serves the
    # same tokens
    again = serve_mod.serve(cfg, params, requests=3, batch=2, prefill_len=5,
                            decode_len=3)
    assert torch.equal(again["generated"], res["generated"])


def test_serve_cli_on_cpu(capsys):
    assert serve_mod.main(["--arch", ARCH, "--reduced", "--requests", "2",
                           "--batch", "2", "--prefill-len", "6",
                           "--decode-len", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "on cpu" in out

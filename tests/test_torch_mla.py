"""The MLA serving slice: deepseek-v3-671b and multi-head latent attention.

The config copy against the JAX package's; ``mla_attention`` (the
absorbed formulation) against the reference's on the same parameters and
inputs, float32, within 1e-4: the cache-free forward, a prefill into an
empty cache (output, and the cache's c_kv, k_rope and pos) and 4 decode
steps, at ``reduce_config``'s MLA ranks and at the published ranks (q_lora
1536, kv_lora 512, nope 128, rope 64, v 128) with d_model 256 and 4 heads.
The two latent kernels' plain versions (and their wrappers, which run
them on CPU tensors) against the reference's ``chunked_attention`` on the
concatenated inputs with ``softmax_scale``, within 1e-5, with empty and
future cache slots.  Reduced deepseek models (3 layers: one dense, two MoE
with a shared expert, and the MTP group) on the reference's parameters
through ``params_from_jax``: the forward, prefill and 4 decode steps
within 1e-3 of the reference, and the port's teacher-forced decode
within 2e-3 of its own forward; the MTP group's shapes and its absence
from serving; the refused cases; ``launch.serve`` on the CPU with the
reference's refit line.  The bf16 latent prefill's and decode's
tensor-core arithmetic (split P, the scale on the fp32 scores; in decode
per-slot visibility, per-split partials in base 2 and their merge)
emulated against the card's bf16 rule, and their dispatch by dtype.  On
the CPU the kernels' plain versions run; the CUDA kernels are checked on
the card by ``chip_smoke.py``."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro import flags as ref_flags
from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.models import attention as ref_attention
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro_torch import _build, flags
from repro_torch.configs import (MLAConfig, get_config, list_configs,
                                 reduce_config)
from repro_torch.configs import deepseek_v3_671b as deepseek_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (attention, decode_step, forward, init_cache,
                                init_params, params_from_jax, prefill)
from repro_torch.models.blocks import block_kind

jax = pytest.importorskip("jax")
jnp = jax.numpy

ARCH = "deepseek-v3-671b"
ROOT = Path(__file__).resolve().parents[1]
ATTN_TOL = dict(rtol=1e-4, atol=1e-4)    # one attention block, f32
PLAIN_TOL = dict(rtol=1e-5, atol=1e-5)   # the plain kernels, f32
TOL = dict(rtol=1e-3, atol=1e-3)         # a model's logits, f32
TF_TOL = dict(rtol=2e-3, atol=2e-3)      # teacher-forced decode vs forward
B, S, N_PREFILL = 2, 40, 36
# deepseek-v3's published latent ranks, at a width the CPU runs quickly
PUBLISHED = dict(d_model=256, num_heads=4, mla=MLAConfig())
RANKS = {"reduced": {}, "published": PUBLISHED}


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _rng_normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------ the config
def test_config_is_the_reference_config():
    assert ARCH in list_configs()
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert "arXiv:2412.19437" in deepseek_config.__doc__
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.vocab_size, cfg.mtp_depth) == (61, 7168, 128, 18432, 129280,
                                               1)
    assert cfg.attention == "mla" and cfg.mla == MLAConfig(
        q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128)
    m = cfg.moe
    assert (m.num_experts, m.top_k, m.d_ff_expert, m.num_shared_experts,
            m.first_k_dense) == (256, 8, 2048, 1, 3)
    assert block_kind(cfg) == "moe"
    small, ref_small = reduce_config(cfg), ref_reduce_config(ref)
    assert dataclasses.asdict(small) == dataclasses.asdict(ref_small)
    assert small.mla.kv_lora_rank == 32 and small.mtp_depth == 1


def test_the_cuda_kernel_widths_are_deepseeks():
    m = get_config(ARCH).mla
    assert flash_ops.LATENT_WIDTHS == (m.kv_lora_rank, m.qk_rope_head_dim)
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5 == 192 ** -0.5


# ------------------------------------------------------- the attention
def _attn_case(ranks, seed=0):
    extra = RANKS[ranks]
    ref_cfg = ref_reduce_config(ref_get_config(ARCH), dtype="float32",
                                **extra)
    cfg = reduce_config(get_config(ARCH), dtype="float32", **extra)
    ref_p = ref_attention.init_mla(jax.random.PRNGKey(seed), ref_cfg,
                                   jnp.float32)
    return ref_cfg, cfg, ref_p, _to_torch(ref_p)


def _positions(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


@pytest.mark.parametrize("ranks", list(RANKS))
def test_mla_forward_matches_reference(ranks):
    ref_cfg, cfg, ref_p, params = _attn_case(ranks)
    x = _rng_normal(np.random.default_rng(1), B, S, cfg.d_model)
    pos = _positions(B, S)
    want, ref_c = ref_attention.mla_attention(
        ref_p, ref_cfg, jnp.asarray(x), jnp.asarray(pos), chunk=16)
    got, cache = attention.mla_attention(
        params, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert ref_c is None and cache is None
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("ranks", list(RANKS))
def test_mla_prefill_cache_and_decode_match_reference(ranks):
    ref_cfg, cfg, ref_p, params = _attn_case(ranks, seed=2)
    rng = np.random.default_rng(3)
    x = _rng_normal(rng, B, N_PREFILL + 4, cfg.d_model)
    ref_cache = ref_attention.init_mla_cache(ref_cfg, B, S, jnp.float32)
    cache = attention.init_mla_cache(cfg, B, S, torch.float32, device="cpu")
    pos = _positions(B, N_PREFILL)
    want, ref_cache = ref_attention.mla_attention(
        ref_p, ref_cfg, jnp.asarray(x[:, :N_PREFILL]), jnp.asarray(pos),
        kv_cache=ref_cache, chunk=16)
    got, cache = attention.mla_attention(
        params, cfg, torch.from_numpy(x[:, :N_PREFILL]),
        torch.from_numpy(pos), kv_cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    assert cache["cursor"] == int(ref_cache["cursor"]) == N_PREFILL
    for key in ("c_kv", "k_rope"):
        assert cache[key].shape == ref_cache[key].shape
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), **ATTN_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
    for t in range(N_PREFILL, N_PREFILL + 4):
        pos = np.full((B, 1), t, np.int32)
        want, ref_cache = ref_attention.mla_attention(
            ref_p, ref_cfg, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos),
            kv_cache=ref_cache, chunk=16)
        got, cache = attention.mla_attention(
            params, cfg, torch.from_numpy(x[:, t:t + 1]),
            torch.from_numpy(pos), kv_cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ATTN_TOL, err_msg=f"decode step {t}")
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(ref_cache["pos"]))
    np.testing.assert_allclose(cache["c_kv"].numpy(),
                               np.asarray(ref_cache["c_kv"]), **ATTN_TOL)


def test_a_write_past_the_cache_raises():
    """The reference's ``dynamic_update_slice`` clamps a write at the
    cursor past the last slot onto the last slots; the port refuses it."""
    _, cfg, _, params = _attn_case("reduced")
    x = torch.from_numpy(_rng_normal(np.random.default_rng(4), B, 5,
                                     cfg.d_model))
    cache = attention.init_mla_cache(cfg, B, 4, torch.float32, device="cpu")
    _, cache = attention.mla_attention(
        params, cfg, x[:, :4], torch.from_numpy(_positions(B, 4)),
        kv_cache=cache)
    with pytest.raises(ValueError, match="overruns the MLA cache"):
        attention.mla_attention(params, cfg, x[:, 4:],
                                torch.full((B, 1), 4, dtype=torch.int32),
                                kv_cache=cache)
    with pytest.raises(ValueError, match="overruns the MLA cache"):
        attention.mla_attention(
            params, cfg, x, torch.from_numpy(_positions(B, 5)),
            kv_cache=attention.init_mla_cache(cfg, B, 4, torch.float32,
                                              device="cpu"))


def test_uncovered_mla_cases_raise():
    _, cfg, _, params = _attn_case("reduced")
    x = torch.from_numpy(_rng_normal(np.random.default_rng(5), B, 8,
                                     cfg.d_model))
    cache = attention.init_mla_cache(cfg, B, 16, torch.float32, device="cpu")
    _, cache = attention.mla_attention(
        params, cfg, x[:, :4], torch.from_numpy(_positions(B, 4)),
        kv_cache=cache)
    with pytest.raises(NotImplementedError):   # prefill into a used cache
        attention.mla_attention(params, cfg, x[:, 4:],
                                torch.from_numpy(_positions(B, 4, 4)),
                                kv_cache=cache)
    with pytest.raises(NotImplementedError):   # shifted positions, no cache
        attention.mla_attention(params, cfg, x,
                                torch.from_numpy(_positions(B, 8, 3)))


# ------------------------------------------------- the latent kernels
def _latent_inputs(seed, b, s, t, h, r, dr):
    rng = np.random.default_rng(seed)
    return (_rng_normal(rng, b, s, h, r), _rng_normal(rng, b, s, h, dr),
            _rng_normal(rng, b, t, r), _rng_normal(rng, b, t, dr))


def _reference_latent(q_lat, q_rope, c_kv, k_rope, q_pos, kv_pos, scale):
    qq = np.concatenate([q_lat, q_rope], axis=-1)
    kk = np.concatenate([c_kv, k_rope], axis=-1)[:, :, None]
    return np.asarray(ref_attention.chunked_attention(
        jnp.asarray(qq), jnp.asarray(kk), jnp.asarray(c_kv[:, :, None]),
        jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=True, chunk=16,
        softmax_scale=scale))


@pytest.mark.parametrize("s,t,h,r,dr", [(37, 37, 4, 32, 16),
                                        (24, 24, 3, 512, 64),
                                        (10, 23, 2, 48, 8)])
def test_latent_prefill_plain_matches_chunked_attention(s, t, h, r, dr):
    q_lat, q_rope, c_kv, k_rope = _latent_inputs(6, 2, s, t, h, r, dr)
    scale = 192 ** -0.5
    want = _reference_latent(q_lat, q_rope, c_kv, k_rope, _positions(2, s),
                             _positions(2, t), scale)
    args = [torch.from_numpy(a) for a in (q_lat, q_rope, c_kv, k_rope)]
    for fn in (flash_ops.flash_attention_latent_plain,
               flash_ops.flash_attention_latent):
        got = fn(*args, scale=scale)
        assert got.shape == (2, s, h, r) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **PLAIN_TOL)


@pytest.mark.parametrize("case", ["filling", "wrapped", "empty-row"])
def test_latent_decode_plain_matches_chunked_attention(case):
    b, t, h, r, dr = 3, 40, 4, 32, 16
    q_lat, q_rope, c_kv, k_rope = _latent_inputs(7, b, 1, t, h, r, dr)
    rng = np.random.default_rng(8)
    slot = np.arange(t, dtype=np.int32)
    if case == "filling":
        # slots 0..fill-1 hold positions 0..fill-1, the rest are empty
        q_pos = np.array([0, 17, 30], np.int32)
        kv_pos = np.where(slot[None] <= q_pos[:, None], slot[None], -1)
    else:
        # a rotated cache: some slots hold positions after the query's
        roll = rng.integers(0, t, b)
        kv_pos = (slot[None] - roll[:, None]) % t
        kv_pos[1, :9] = -1
        q_pos = rng.integers(t // 2, t, b).astype(np.int32)
        if case == "empty-row":
            kv_pos[2] = -1      # nothing visible: the output is zero
    kv_pos = kv_pos.astype(np.int32)
    scale = 0.3
    want = _reference_latent(q_lat, q_rope, c_kv, k_rope, q_pos[:, None],
                             kv_pos, scale)[:, 0]
    if case == "empty-row":
        assert not want[2].any()
    args = [torch.from_numpy(a) for a in (q_lat[:, 0], q_rope[:, 0], c_kv,
                                          k_rope, kv_pos, q_pos)]
    for fn in (decode_ops.decode_attention_latent_plain,
               decode_ops.decode_attention_latent):
        got = fn(*args, scale=scale)
        assert got.shape == (b, h, r)
        np.testing.assert_allclose(got.numpy(), want, **PLAIN_TOL)


def test_latent_wrappers_refuse_bad_inputs():
    q_lat, q_rope, c_kv, k_rope = (torch.from_numpy(a) for a in
                                   _latent_inputs(9, 2, 4, 4, 2, 8, 4))
    with pytest.raises(ValueError, match="latent attention takes"):
        flash_ops.flash_attention_latent(
            q_lat, q_rope[..., :2].contiguous(), c_kv, k_rope, scale=1.0)
    with pytest.raises(TypeError):
        flash_ops.flash_attention_latent(q_lat.double(), q_rope, c_kv,
                                         k_rope, scale=1.0)
    kv_pos = torch.zeros((2, 4), dtype=torch.int32)
    q_pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="latent attention takes"):
        decode_ops.decode_attention_latent(
            q_lat, q_rope[:, 0].contiguous(), c_kv, k_rope, kv_pos, q_pos,
            scale=1.0)
    with pytest.raises(TypeError, match="int32"):
        decode_ops.decode_attention_latent(
            q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(), c_kv,
            k_rope, kv_pos.long(), q_pos, scale=1.0)
    with pytest.raises(ValueError, match="kv_pos must be"):
        decode_ops.decode_attention_latent(
            q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(), c_kv,
            k_rope, kv_pos[:, :3].contiguous(), q_pos, scale=1.0)


@pytest.mark.parametrize("b,h,t,sms,keys", [
    (8, 128, 2112, 132, 64), (8, 128, 2112, 132, 32),
    (2, 128, 1536, 132, 32), (8, 128, 18, 132, 64), (1, 4, 5000, 132, 64),
    (64, 128, 2112, 132, 64), (3, 130, 700, 114, 32)])
def test_latent_split_plan_covers_the_cache(b, h, t, sms, keys):
    ns, per = decode_ops.latent_split_plan(b, h, t, sms, keys)
    # the C side's conditions: whole tiles, no empty split, all slots
    assert per % keys == 0 and (ns - 1) * per < t <= ns * per
    tiles = -(-t // keys)
    pairs = b * -(-h // decode_ops.LATENT_BLOCK_ROWS)
    assert 1 <= ns <= tiles
    assert ns == 1 or ns * pairs <= sms


def _c_params(src: str, name: str) -> list:
    sig = re.search(rf'extern "C" int {name}\((.*?)\)\s*{{', src, re.S)
    return [p.strip() for p in sig.group(1).split(",")]


def test_latent_entry_points_match_their_ctypes_signatures():
    import ctypes

    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "mla_attention.cu").read_text()
    assert "mla_attention.cu" in _build.SOURCES
    kinds = {ctypes.c_void_p: "*", ctypes.c_int: "int ",
             ctypes.c_float: "float "}
    for name in ("flash_attention_latent_launch",
                 "decode_attention_latent_launch"):
        params = _c_params(src, name)
        args, res = _build._SIGNATURES[name]
        assert res is ctypes.c_int and len(args) == len(params)
        for a, p in zip(args, params):
            assert kinds[a] in p, (name, p)
    # the wrappers' tile and block constants are the source's
    assert re.search(r"Tile<float> \{\s*static constexpr int keys = 32;",
                     src)
    assert re.search(r"Tile<__nv_bfloat16> \{\s*static constexpr int keys "
                     r"= 64;", src)
    assert decode_ops.LATENT_TILE_KEYS == {torch.float32: 32,
                                           torch.bfloat16: 64}
    assert "kBlockRows = kWarps * kWarpRows;  // 64" in src
    assert re.search(r"kWarps = 8;.*kWarpRows = 8;", src, re.S)


def test_the_build_hashes_every_included_header():
    # the library's name hashes the sources and HEADERS, so a header that a
    # source includes but HEADERS misses would leave a stale build in use
    csrc = _build.CSRC
    included = {inc for name in _build.SOURCES for inc in re.findall(
        r'#include "([^"]+)"', (csrc / name).read_text())}
    assert included == set(_build.HEADERS) == {
        p.name for p in csrc.glob("*.cuh")}
    for name in ("flash_attention.cu", "mla_attention.cu"):
        assert '#include "wgmma.cuh"' in (csrc / name).read_text()


# The bf16 latent prefill runs both products on the tensor cores
# (csrc/mla_attention.cu, mla_attention_wgmma_kernel): scores in fp32 from
# bf16 [q_lat ; q_rope] and [c_kv ; k_rope] (each product exact in fp32,
# the sums in fp32), times scale * log2(e) on the fp32 accumulator, an
# online softmax in base 2 over 64-key tiles with the reference's clamps,
# and P c_kv with the fp32 weights split as P = bf16(P) + bf16(P -
# bf16(P)), two bf16 products summed in fp32.  The card check
# (chip_smoke.py) holds a bf16 output to rtol 2^-7, atol 1e-5 against the
# plain version with at most 1% of the elements differing.  This emulates
# that arithmetic on the CPU: the split meets the rule, while one bf16 P,
# or q rounded to bf16 after the scale is folded into it, does not.
LATENT_TILE = 64
LOG2E = 1.4426950408889634
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_DIFF_SHARE = 0.01


def _emulate_latent_tensor_core_kernel(q_lat, q_rope, c_kv, k_rope, *,
                                       scale, weights, prescale_q=False):
    """bf16 q_lat (B, S, H, R), q_rope (B, S, H, Dr), c_kv (B, T, R),
    k_rope (B, T, Dr) -> bf16 (B, S, H, R), causal, with the softmax
    weights of the P V product kept in fp32 (``weights="fp32"``, the
    CUDA-core kernel's arithmetic), split hi / lo in bf16 (``"split"``, the
    tensor-core kernel's) or rounded once to bf16 (``"bf16"``).
    ``prescale_q`` folds scale * log2(e) into q and rounds it to bf16
    before the product, instead of scaling the fp32 scores.  Rows are
    (position, head) pairs, r = i H + h, as the kernel orders them."""
    b, s, h, r = q_lat.shape
    t = c_kv.shape[1]
    sc2 = scale * LOG2E
    q = torch.cat([q_lat, q_rope], -1).float().reshape(b, s * h, -1)
    if prescale_q:
        q = (q * sc2).bfloat16().float()
    k = torch.cat([c_kv, k_rope], -1).float()
    v = c_kv.float()
    qpos = (torch.arange(s * h) // h)[:, None]
    state = _softmax_state(b, s * h, r)
    for t0 in range(0, t, LATENT_TILE):
        sc = torch.matmul(q, k[:, t0:t0 + LATENT_TILE].transpose(1, 2))
        if not prescale_q:
            sc = sc * sc2
        kpos = torch.arange(t0, min(t0 + LATENT_TILE, t))[None, :]
        state = _online_tile(state, sc, kpos <= qpos,
                             v[:, t0:t0 + LATENT_TILE], weights)
    m, l, acc = state
    out = acc / l.clamp_min(1e-30)
    return out.reshape(b, s, h, r).bfloat16()


def _softmax_state(b, rows, r):
    """(max, sum, O) of an online softmax in base 2 before any key: the
    max at the reference's clamp, -1e4 in base 2."""
    return (torch.full((b, rows, 1), -1e4 * LOG2E),
            torch.zeros((b, rows, 1)), torch.zeros((b, rows, r)))


def _online_tile(state, sc, visible, vt, weights):
    """One key tile of the online softmax: base-2 scores ``sc`` (B, rows,
    keys), masked to -1e30 where not ``visible``, the weights of the P V
    product in fp32, split hi / lo in bf16 or one bf16 (``weights``)."""
    m, l, acc = state
    sc = torch.where(visible, sc, torch.full_like(sc, -1e30))
    m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
    corr = torch.exp2(m - m_new)
    p = torch.exp2(sc - m_new)
    l = l * corr + p.sum(-1, keepdim=True)
    if weights == "fp32":
        pv = torch.matmul(p, vt)
    else:
        p_hi = p.bfloat16().float()
        pv = torch.matmul(p_hi, vt)
        if weights == "split":
            pv = pv + torch.matmul((p - p_hi).bfloat16().float(), vt)
    return m_new, l, acc * corr + pv


def _bf16_rule(got, want):
    """(allclose under the card's bf16 tolerance, share of differing
    elements) of two bf16 outputs."""
    close = bool(torch.allclose(got.float(), want.float(), **BF16_TOL))
    return close, float((got != want).float().mean())


@pytest.mark.parametrize("s,h", [
    pytest.param(256, 16, id="S256-H16"),
    pytest.param(512, 8, id="S512-H8"),
    # H not a multiple of 64 (a 64-row block spans positions) and S not a
    # multiple of the 64-key tile
    pytest.param(100, 5, id="S100-H5"),
])
def test_split_latent_weights_meet_the_card_bf16_rule(s, h):
    r, dr = flash_ops.LATENT_WIDTHS
    args = [torch.from_numpy(a).bfloat16()
            for a in _latent_inputs(31, 1, s, s, h, r, dr)]
    scale = 192 ** -0.5
    want = flash_ops.flash_attention_latent_plain(*args, scale=scale)
    shares = {}
    for weights in ("fp32", "split", "bf16"):
        got = _emulate_latent_tensor_core_kernel(*args, scale=scale,
                                                 weights=weights)
        assert got.shape == want.shape
        close, shares[weights] = _bf16_rule(got, want)
        if weights != "bf16":
            assert close, (weights, float((got.float() - want.float())
                                          .abs().max()))
            assert shares[weights] <= BF16_DIFF_SHARE, (weights, shares)
    # one bf16 P loses the weights' low bits, which the rule sees
    assert shares["bf16"] > BF16_DIFF_SHARE, shares
    assert shares["bf16"] > 10 * shares["split"], shares
    # the scale belongs on the fp32 scores: folded into q and rounded to
    # bf16, it moves every score by up to half a bf16 ulp of q
    got = _emulate_latent_tensor_core_kernel(*args, scale=scale,
                                             weights="split", prescale_q=True)
    close, shares["prescaled-q"] = _bf16_rule(got, want)
    assert not (close and shares["prescaled-q"] <= BF16_DIFF_SHARE), shares
    assert shares["prescaled-q"] > 10 * shares["split"], shares
    print(f"S={s} H={h} share of differing bf16 outputs: {shares}")


def test_latent_prefill_instances_follow_the_dtype():
    # bf16 prefill on the tensor-core kernel, f32 on the CUDA-core one: the
    # wrapper's count keys, and the C dispatch, which builds no bf16
    # instance of the CUDA-core prefill
    assert flash_ops.latent_instance(torch.bfloat16) == "wgmma"
    assert flash_ops.latent_instance(torch.float32) == "fma"
    assert set(flash_ops.flash_attention_latent.instance_launches) == {
        "wgmma", "fma"}
    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "mla_attention.cu").read_text()
    body = src[src.index('extern "C" int flash_attention_latent_launch'):]
    body = body[:body.index("\n}\n")]
    assert re.findall(r"dtype == (\d)\) return \(int\)prefill_(\w+)\(",
                      body) == [("0", "f32"), ("1", "bf16")]

    def function(name):
        f = src[src.index(f"cudaError_t {name}("):]
        return f[:f.index("\n}\n")]

    assert "mla_attention_wgmma_kernel<false>" in function("prefill_bf16")
    assert "mla_attention_kernel<" not in function("prefill_bf16")
    assert "mla_attention_kernel<float, false>" in function("prefill_f32")
    assert not re.search(r"mla_attention_kernel<(__nv_bfloat16|T), false>",
                         src)
    # CPU tensors take the plain version and launch nothing
    before = dict(flash_ops.flash_attention_latent.instance_launches)
    args = [torch.from_numpy(a).bfloat16()
            for a in _latent_inputs(9, 1, 3, 3, 2, 512, 64)]
    flash_ops.flash_attention_latent(*args, scale=0.1)
    assert flash_ops.flash_attention_latent.instance_launches == before


# The bf16 latent decode runs on the same tensor-core kernel
# (mla_attention_wgmma_kernel<true>): one block per (64 heads, split of the
# cache, batch row), the mask per slot (kv_pos in 0..q_pos), each split's
# unnormalised O, base-2 max and row sum written in fp32 and merged by
# mla_decode_merge_kernel (max from the clamp, each split weighed by
# exp2(its max - the max), the divisor clamped at 1e-30); with one split
# the block divides itself.
def _emulate_latent_tensor_core_decode(q_lat, q_rope, c_kv, k_rope, kv_pos,
                                       q_pos, *, scale, weights):
    """bf16 q_lat (B, H, R), q_rope (B, H, Dr) over the cache c_kv (B, T,
    R), k_rope (B, T, Dr) with slot positions kv_pos (B, T) and query
    positions q_pos (B,) -> bf16 (B, H, R), in the splits of
    ``latent_split_plan`` on 132 SMs; the P V weights as in
    ``_emulate_latent_tensor_core_kernel``."""
    b, h, r = q_lat.shape
    t = c_kv.shape[1]
    ns, per = decode_ops.latent_split_plan(
        b, h, t, 132, decode_ops.LATENT_TILE_KEYS[torch.bfloat16])
    q = torch.cat([q_lat, q_rope], -1).float()
    k = torch.cat([c_kv, k_rope], -1).float()
    v = c_kv.float()
    visible = ((kv_pos >= 0) & (kv_pos <= q_pos[:, None]))[:, None, :]
    parts = []
    for t_begin in range(0, t, per):
        state = _softmax_state(b, h, r)
        for t0 in range(t_begin, min(t, t_begin + per), LATENT_TILE):
            t1 = min(t, t_begin + per, t0 + LATENT_TILE)
            sc = torch.matmul(q, k[:, t0:t1].transpose(1, 2)) * (
                scale * LOG2E)
            state = _online_tile(state, sc, visible[..., t0:t1],
                                 v[:, t0:t1], weights)
        parts.append(state)
    assert len(parts) == ns
    if ns == 1:
        _, l, acc = parts[0]
        return (acc / l.clamp_min(1e-30)).bfloat16()
    mx = torch.full((b, h, 1), -1e4 * LOG2E)
    for m, _, _ in parts:
        mx = torch.maximum(mx, m)
    l_all, acc_all = torch.zeros((b, h, 1)), torch.zeros((b, h, r))
    for m, l, acc in parts:
        c = torch.exp2(m - mx)
        l_all = l_all + l * c
        acc_all = acc_all + acc * c
    return (acc_all / l_all.clamp_min(1e-30)).bfloat16()


def _latent_decode_case(case):
    """(bf16 decode arguments, splits on 132 SMs) of a named case."""
    b, t, h, empty = {"wrapped-ring": (3, 512, 16, 0),
                      "empty-split": (2, 384, 8, 192),
                      "H-not-a-multiple-of-64": (1, 256, 67, 0),
                      "T-not-a-multiple-of-64": (2, 777, 3, 128),
                      "one-split": (1, 18, 128, 0)}[case]
    r, dr = flash_ops.LATENT_WIDTHS
    rng = np.random.default_rng(32)
    q_lat, q_rope, c_kv, k_rope = _latent_inputs(33, b, 1, t, h, r, dr)
    slot = np.arange(t)
    if case == "one-split":
        # serve's warm-up: slots 0..16 filled, q at 16
        kv_pos = np.where(slot <= 16, slot, -1)[None].repeat(b, 0)
        q_pos = np.full(b, 16)
    else:
        # a wrapped ring, per-row q_pos: some slots hold later positions
        roll = rng.integers(0, t, b)
        kv_pos = (slot[None] - roll[:, None]) % t
        kv_pos[b - 1, :empty] = -1
        q_pos = rng.integers(t - 64, t, b)
    args = [torch.from_numpy(a).bfloat16() for a in
            (q_lat[:, 0], q_rope[:, 0], c_kv, k_rope)]
    args += [torch.from_numpy(kv_pos.astype(np.int32)),
             torch.from_numpy(q_pos.astype(np.int32))]
    ns, per = decode_ops.latent_split_plan(
        b, h, t, 132, decode_ops.LATENT_TILE_KEYS[torch.bfloat16])
    return args, ns, per


@pytest.mark.parametrize("case", ["wrapped-ring", "empty-split",
                                  "H-not-a-multiple-of-64",
                                  "T-not-a-multiple-of-64", "one-split"])
def test_latent_tensor_core_decode_meets_the_card_bf16_rule(case):
    args, ns, per = _latent_decode_case(case)
    kv_pos, q_pos = args[4], args[5]
    b, h, _ = args[0].shape
    t = kv_pos.shape[1]
    visible = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    # each case exercises what its name says
    if case == "one-split":
        assert ns == 1
    else:
        assert ns > 1
    if case == "empty-split":
        assert not visible[b - 1, :per].any()
    if case == "H-not-a-multiple-of-64":
        assert h % 64 and h > 64
    if case == "T-not-a-multiple-of-64":
        # a partial last split, splits with no visible slot and a row tile
        # of 3 real heads
        assert t % 64 and (ns - 1) * per < t < ns * per
        assert not visible[b - 1, :2 * per].any() and h < 64
    scale = 192 ** -0.5
    want = decode_ops.decode_attention_latent_plain(*args, scale=scale)
    shares = {}
    for weights in ("fp32", "split", "bf16"):
        got = _emulate_latent_tensor_core_decode(*args, scale=scale,
                                                 weights=weights)
        assert got.shape == want.shape == (b, h, 512)
        close, shares[weights] = _bf16_rule(got, want)
        if weights != "bf16":
            assert close, (weights, float((got.float() - want.float())
                                          .abs().max()))
            assert shares[weights] <= BF16_DIFF_SHARE, (weights, shares)
    # the negative control: one bf16 P loses the weights' low bits
    assert shares["bf16"] > BF16_DIFF_SHARE, shares
    assert shares["bf16"] > 10 * max(shares["split"], 1e-4), shares
    print(f"{case}: {ns} splits of {per}; share of differing bf16 "
          f"outputs: {shares}")


def test_latent_decode_instances_follow_the_dtype():
    # bf16 decode on the tensor-core kernel, f32 on the CUDA-core one: the
    # wrapper's count keys, and the C dispatch, which builds no bf16
    # instance of the CUDA-core decode
    assert decode_ops.latent_decode_instance(torch.bfloat16) == "wgmma"
    assert decode_ops.latent_decode_instance(torch.float32) == "fma"
    assert set(decode_ops.decode_attention_latent.instance_launches) == {
        "wgmma", "fma"}
    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "mla_attention.cu").read_text()
    body = src[src.index('extern "C" int decode_attention_latent_launch'):]
    body = body[:body.index("\n}\n")]
    assert re.findall(r"dtype == (\d)\) return \(int\)decode<([\w:]+)>\(",
                      body) == [("0", "float"), ("1", "__nv_bfloat16")]
    f = src[src.index("cudaError_t decode(const Args& a"):]
    f = f[:f.index("\n}\n")]
    assert re.search(r"if constexpr \(std::is_same_v<T, float>\) \{\s*"
                     r"err = allow_smem<float, true>\(device\);.*?"
                     r"mla_attention_kernel<float, true>.*?\} else \{"
                     r"\s*err = allow_tc_smem<true>\(device\);.*?"
                     r"mla_attention_wgmma_kernel<true><<<", f, re.S)
    assert not re.search(r"mla_attention_kernel<(__nv_bfloat16|T), true>",
                         src)
    assert not re.search(r"allow_smem<(__nv_bfloat16|T), ", src)
    # CPU tensors take the plain version and launch nothing
    before = dict(decode_ops.decode_attention_latent.instance_launches)
    launches = decode_ops.decode_attention_latent.launches
    args, _, _ = _latent_decode_case("one-split")
    for dtype in (torch.bfloat16, torch.float32):
        cast = [a.to(dtype) if a.is_floating_point() else a for a in args]
        got = decode_ops.decode_attention_latent(*cast, scale=0.1)
        assert got.dtype == dtype
        torch.testing.assert_close(
            got, decode_ops.decode_attention_latent_plain(*cast, scale=0.1),
            rtol=0, atol=0)
    assert decode_ops.decode_attention_latent.instance_launches == before
    assert decode_ops.decode_attention_latent.launches == launches


# ------------------------------------------------------------ the model
VARIANTS = {"reduced": dict(), "published-ranks": PUBLISHED}


def _model_cfg(get, reduce, variant):
    return reduce(get(ARCH), dtype="float32", num_layers=3,
                  **VARIANTS[variant])


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    ref_cfg = _model_cfg(ref_get_config, ref_reduce_config, request.param)
    cfg = _model_cfg(get_config, reduce_config, request.param)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, tokens


def test_params_carry_over_with_dense_blocks_and_mtp(models):
    _, ref_params, cfg, params, _ = models
    assert cfg.moe.first_k_dense == 1 and cfg.mtp_depth == 1
    assert set(ref_params) == {"embed", "unembed", "final_norm",
                               "dense_blocks", "blocks", "mtp"}
    ported = init_params(cfg, seed=0, device="cpu")
    assert set(params) == set(ported) == set(ref_params) - {"dense_blocks"}
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    for i in range(cfg.num_layers):
        group = "dense_blocks" if i == 0 else "blocks"
        want = jax.tree.map(lambda s: s[1:], shapes[group],
                            is_leaf=lambda x: isinstance(x, tuple))
        for tree in (params, ported):
            assert jax.tree.map(lambda t: tuple(t.shape),
                                tree["blocks"][i]) == want
        assert set(params["blocks"][i]["attn"]) == {
            "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b",
            "wo"}
        j = i if i == 0 else i - 1
        np.testing.assert_array_equal(
            params["blocks"][i]["attn"]["wk_b"].numpy(),
            np.asarray(ref_params[group]["attn"]["wk_b"][j]))
    # the MTP group: (2d, d) projection, one unstacked dense block, a norm
    for tree in (params, ported):
        assert jax.tree.map(lambda t: tuple(t.shape), tree["mtp"]) == \
            shapes["mtp"]
    assert params["mtp"]["proj"].shape == (2 * cfg.d_model, cfg.d_model)
    assert "mlp" in params["mtp"]["block"] and "moe" not in \
        params["mtp"]["block"]
    np.testing.assert_array_equal(params["mtp"]["proj"].numpy(),
                                  np.asarray(ref_params["mtp"]["proj"]))


def test_params_from_jax_takes_mtp_only_with_mtp_depth(models):
    _, ref_params, cfg, _, _ = models
    tree = jax.tree.map(np.asarray, ref_params)
    no_mtp = dataclasses.replace(cfg, mtp_depth=0)
    with pytest.raises(NotImplementedError, match="mtp only with"):
        params_from_jax(no_mtp, tree, device="cpu")
    for group in ("enc_blocks", "frontend_proj"):
        with pytest.raises(NotImplementedError, match=f"{group} only with"):
            params_from_jax(cfg, dict(tree, **{group: {}}), device="cpu")


def test_forward_matches_reference(models):
    ref_cfg, ref_params, cfg, params, tokens = models
    want, _, want_aux, _ = ref_forward(ref_cfg, ref_params,
                                       jnp.asarray(tokens), chunk=16)
    got, cache, aux = forward(cfg, params, torch.from_numpy(tokens).long(),
                              return_aux=True)
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux["drop_frac"]) == 0.0


def test_prefill_and_decode_match_reference(models):
    ref_cfg, ref_params, cfg, params, tokens = models
    ref_last, ref_cache = ref_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(tokens[:, :N_PREFILL])},
        max_len=S, chunk=16)
    last, cache = prefill(cfg, params,
                          {"tokens": torch.from_numpy(tokens[:, :N_PREFILL])},
                          max_len=S)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    # the reference's layer-stacked latent cache, slice by slice
    stacked = ref_cache["layers"]["attn"]
    for i, lc in enumerate(cache["layers"]):
        assert set(lc["attn"]) == {"c_kv", "k_rope", "pos", "cursor"}
        np.testing.assert_array_equal(lc["attn"]["pos"].numpy(),
                                      np.asarray(stacked["pos"][i]))
        np.testing.assert_allclose(lc["attn"]["c_kv"].numpy(),
                                   np.asarray(stacked["c_kv"][i]), **TOL)
    for t in range(N_PREFILL, S):
        pos = np.full((B, 1), t, np.int32)
        want, ref_cache = ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(tokens[:, t:t + 1]),
            jnp.asarray(pos), chunk=16)
        got, cache = decode_step(cfg, params, cache,
                                 torch.from_numpy(tokens[:, t:t + 1]),
                                 torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"decode step {t}")


def test_teacher_forced_decode_matches_forward(models):
    _, _, cfg, params, tokens = models
    tok = torch.from_numpy(tokens).long()
    full, _ = forward(cfg, params, tok)
    last, cache = prefill(cfg, params, {"tokens": tok[:, :8]}, max_len=S)
    np.testing.assert_allclose(last.numpy(), full[:, 7].numpy(), **TF_TOL)
    for t in range(8, S):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        got, cache = decode_step(cfg, params, cache, tok[:, t:t + 1], pos)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   **TF_TOL)
    layers = init_cache(cfg, B, S, device="cpu")["layers"]
    assert len(layers) == cfg.num_layers
    assert layers[0]["attn"]["c_kv"].shape == (B, S, cfg.mla.kv_lora_rank)


def test_serving_never_reads_the_mtp_group(models):
    _, _, cfg, params, tokens = models
    tok = torch.from_numpy(tokens).long()
    want, _ = forward(cfg, params, tok)
    last, _ = prefill(cfg, params, {"tokens": tok[:, :N_PREFILL]},
                      max_len=S)
    noisy = dict(params, mtp={
        "proj": params["mtp"]["proj"] + 1.0,
        "block": jax.tree.map(lambda t: t * 3.0 + 0.5,
                              params["mtp"]["block"]),
        "norm": {"scale": params["mtp"]["norm"]["scale"] * -2.0}})
    got, _ = forward(cfg, noisy, tok)
    assert torch.equal(got, want)
    got_last, _ = prefill(cfg, noisy, {"tokens": tok[:, :N_PREFILL]},
                          max_len=S)
    assert torch.equal(got_last, last)


# ---------------------------------- families that run since this slice
FORMERLY_UNPORTED = {   # case -> config overrides on the reduced glm4-9b
    "mla": dict(attention="mla", mla=MLAConfig(
        q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16)),
    "mtp": dict(mtp_depth=1),
}


@pytest.mark.parametrize("case", list(FORMERLY_UNPORTED))
def test_mla_and_mtp_families_now_build_and_serve(case):
    base = reduce_config(get_config("glm4-9b"), dtype="float32")
    cfg = dataclasses.replace(base, **FORMERLY_UNPORTED[case])
    assert block_kind(cfg) == "dense"
    params = init_params(cfg, device="cpu")
    assert ("mtp" in params) == (case == "mtp")
    tok = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (B, 12)))
    full, _ = forward(cfg, params, tok)
    last, cache = prefill(cfg, params, {"tokens": tok[:, :10]}, max_len=12)
    np.testing.assert_allclose(last.numpy(), full[:, 9].numpy(), **TF_TOL)
    got, _ = decode_step(cfg, params, cache, tok[:, 10:11],
                         torch.full((B, 1), 10, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), full[:, 10].numpy(), **TF_TOL)
    kind = "c_kv" if case == "mla" else "k"
    assert kind in cache["layers"][0]["attn"]


# ------------------------------------------------------- the serve CLI
def test_serve_cli_prints_the_reference_refit_and_counts_no_launches(
        capsys):
    kernels = (flash_ops.flash_attention_latent,
               decode_ops.decode_attention_latent,
               flash_ops.flash_attention, decode_ops.decode_attention)
    before = [k.launches for k in kernels]
    assert serve_mod.main(["--arch", ARCH, "--reduced", "--requests", "2",
                           "--batch", "2", "--prefill-len", "12",
                           "--decode-len", "3", "--device", "cpu"]) == 0
    assert [k.launches for k in kernels] == before
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "on cpu" in out
    # the reduced config's 8 experts, top-2: 4 ranks of 4 slots
    trace = ref_core.synthetic_routing_trace(8, 200, top_k=2, seed=1)
    plan = ref_core.plan_expert_placement(trace, 8, 4, 4, algorithm="lmbr")
    base = ref_core.baseline_contiguous_placement(8, 4, 4)
    want = (f"expert placement refit: span {base.avg_span(trace):.2f} -> "
            f"{plan.avg_span(trace):.2f} across 4 EP ranks")
    assert out.splitlines()[-1] == want


def test_load_model_cuts_depth_only():
    cfg, params = serve_mod.load_model(ARCH, reduced=True, device="cpu",
                                       num_layers=4)
    assert cfg.num_layers == 4 and cfg.moe.first_k_dense == 1
    kinds = ["moe" in p for p in params["blocks"]]
    assert kinds == [False, True, True, True]
    res = serve_mod.serve(cfg, params, requests=2, batch=2, prefill_len=10,
                          decode_len=2)
    assert res["prefill_drop_frac"] == [0.0]
    assert bool(torch.isfinite(res["logits"]).all())

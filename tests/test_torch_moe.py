"""The MoE serving slice: qwen3-moe-30b-a3b and ``models/moe.py``.

The config copy against the JAX package's; ``apply_moe`` against the
reference's on the same parameters and inputs (float32, the reduced
config's 8 experts, top-2, d_ff 64) at capacity factors 8.0 and 1.0 (where
tokens drop), with and without a shared expert, under the identity
dispatch and a ``dispatch_from_plan`` dispatch with replicas: y within
1e-5 (relative, and of the largest |y| near zero), ``drop_frac`` exact, the top-k sets and kept masks exact; a top-k
tie; ``dispatch_from_plan``'s tables exact; ``init_moe``'s replica gather;
then reduced models (3 layers, qwen3's head_dim 128 and 8 query heads per
KV head) on the reference's parameters (``params_from_jax``): the forward
within 1e-3, prefill and 4 decode steps within 1e-3, and the port's
teacher-forced decode against its own forward within 2e-3, once as
reduced and once with ``first_k_dense=1`` and one shared expert.  Also
``launch.serve`` on the CPU with the reference's refit line."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro import flags as ref_flags
from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.models import decode_step as ref_decode_step
from repro.models import dispatch_from_plan as ref_dispatch_from_plan
from repro.models import forward as ref_forward
from repro.models import identity_dispatch as ref_identity_dispatch
from repro.models import init_params as ref_init_params
from repro.models import moe as ref_moe
from repro.models import prefill as ref_prefill
from repro_torch import core, flags
from repro_torch.configs import get_config, list_configs, reduce_config
from repro_torch.configs import qwen3_moe_30b_a3b as qwen3_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (decode_step, dispatch_from_plan, forward,
                                identity_dispatch, init_cache, init_params,
                                params_from_jax, prefill)
from repro_torch.models import moe
from repro_torch.models.blocks import block_kind

jax = pytest.importorskip("jax")
jnp = jax.numpy

ARCH = "qwen3-moe-30b-a3b"
SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-3, atol=1e-3)
Y_RTOL = 1e-5


def _assert_y_close(got, want):
    """rtol 1e-5, and atol 1e-5 of the largest |y|: an output near zero is
    the sum of k expert outputs of that size, which f32 products summed in
    another order leave ~1e-7 of the terms apart."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=Y_RTOL,
                               atol=Y_RTOL * np.abs(want).max())
B, S, N_PREFILL = 2, 40, 36
# qwen3's head_dim and query heads per KV head, at the reduced width
REDUCE = dict(num_layers=3, num_heads=8, num_kv_heads=1, head_dim=128)


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _reduced(get, reduce, shared=0, first_dense=0, **extra):
    cfg = reduce(get(ARCH), dtype="float32", **extra)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_shared_experts=shared, first_k_dense=first_dense))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _plans(num_experts=8, top_k=2):
    """The serve refit's plan (4 ranks of E // 4 + 2 slots) from the
    reference and from the port, on the same trace."""
    slots = num_experts // 4 + 2
    ref_trace = ref_core.synthetic_routing_trace(num_experts, 200,
                                                 top_k=top_k, seed=1)
    trace = core.synthetic_routing_trace(num_experts, 200, top_k=top_k,
                                         seed=1)
    ref_plan = ref_core.plan_expert_placement(ref_trace, num_experts, 4,
                                              slots, algorithm="lmbr")
    plan = core.plan_expert_placement(trace, num_experts, 4, slots,
                                      algorithm="lmbr", device="cpu")
    return ref_plan, plan


# ------------------------------------------------------------ the config
def test_config_is_the_reference_config():
    assert ARCH in list_configs()
    cfg, ref = get_config(ARCH), ref_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert "hf:Qwen/Qwen3-30B-A3B" in qwen3_config.__doc__
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.vocab_size) == \
        (48, 2048, 32, 4, 128, 151936)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert) == \
        (128, 8, 768)
    assert cfg.sliding_window is None and block_kind(cfg) == "moe"
    small, ref_small = reduce_config(cfg), ref_reduce_config(ref)
    assert dataclasses.asdict(small) == dataclasses.asdict(ref_small)
    assert (small.moe.num_experts, small.moe.top_k, small.moe.d_ff_expert,
            small.moe.capacity_factor) == (8, 2, 64, 8.0)


def test_an_arch_module_imported_first_hides_no_other_arch():
    # the registry loads every arch module even when one was imported
    # on its own before the first lookup
    code = ("from repro_torch.configs import glm4_9b, list_configs; "
            "print(len(list_configs()))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert int(out.stdout) == len(list_configs()) >= 7


def test_capacity_factor_flag_is_the_reference_variant():
    flags.set_variant("cf1.5")
    ref_flags.set_variant("cf1.5")
    assert flags.FLAGS["moe_cf"] == ref_flags.FLAGS["moe_cf"] == 1.5
    flags.reset()
    assert flags.FLAGS["moe_cf"] is None


# ---------------------------------------------------------- the dispatch
def test_dispatch_from_plan_matches_reference():
    ref_plan, plan = _plans()
    np.testing.assert_array_equal(plan.member, ref_plan.member)
    ref_d, d = ref_dispatch_from_plan(ref_plan), dispatch_from_plan(plan)
    assert (d.num_slots, d.num_ranks, d.slots_per_rank) == \
        (ref_d.num_slots, ref_d.num_ranks, ref_d.slots_per_rank) == (16, 4, 4)
    assert d.slot_of.dtype == ref_d.slot_of.dtype == np.int32
    np.testing.assert_array_equal(d.slot_of, ref_d.slot_of)
    np.testing.assert_array_equal(d.slot_to_expert, ref_d.slot_to_expert)
    # replicas: some expert sits in more than one slot
    assert len(set(d.slot_to_expert.tolist())) == 8 < d.num_slots
    ident, ref_ident = identity_dispatch(8, 4), ref_identity_dispatch(8, 4)
    np.testing.assert_array_equal(ident.slot_of, ref_ident.slot_of)
    np.testing.assert_array_equal(ident.slot_to_expert,
                                  ref_ident.slot_to_expert)
    assert identity_dispatch(8, 4) is ident


def test_init_moe_gathers_replicas_from_the_experts():
    cfg = _reduced(get_config, reduce_config, shared=1)
    _, plan = _plans()
    d = dispatch_from_plan(plan)
    per_expert = moe.init_moe(torch.Generator().manual_seed(3), cfg,
                              torch.float32)
    by_slot = moe.init_moe(torch.Generator().manual_seed(3), cfg,
                           torch.float32, d)
    s2e = torch.from_numpy(d.slot_to_expert).long()
    for name in ("we_gate", "we_up", "we_down"):
        assert by_slot[name].shape[0] == d.num_slots
        assert torch.equal(by_slot[name], per_expert[name][s2e])
    for name in ("router",):
        assert torch.equal(by_slot[name], per_expert[name])
        assert by_slot[name].dtype == torch.float32
    assert set(by_slot["shared"]) == {"wi_gate", "wi_up", "wo"}
    assert by_slot["shared"]["wo"].shape == (cfg.moe.d_ff_expert,
                                             cfg.d_model)


# --------------------------------------------------------- apply_moe
def _ref_layout(params, cfg, x, dispatch, cf):
    """The reference's routing and kept mask (``models/moe.py:162-189``,
    step for step), the mask returned in token order."""
    m = cfg.moe
    n = x.shape[0] * x.shape[1]
    xf = jnp.asarray(x).reshape(n, -1)
    probs = jax.nn.softmax(xf @ params["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, m.top_k)
    tokens_per_rank = max(1, n // dispatch.num_ranks)
    src_rank = jnp.minimum(jnp.arange(n) // tokens_per_rank,
                           dispatch.num_ranks - 1)
    top_slot = jnp.asarray(dispatch.slot_of)[top_e, src_rank[:, None]]
    capacity = int(max(8, np.ceil(n * m.top_k / dispatch.num_slots * cf)))
    flat = top_slot.reshape(-1)
    order = jnp.argsort(flat)
    sorted_slot = flat[order]
    seg = jnp.searchsorted(sorted_slot, jnp.arange(dispatch.num_slots))
    keep_sorted = jnp.arange(flat.shape[0]) - seg[sorted_slot] < capacity
    keep = np.zeros(flat.shape[0], bool)
    keep[np.asarray(order)] = np.asarray(keep_sorted)
    return (np.asarray(top_e), np.asarray(top_slot), capacity,
            keep.reshape(n, m.top_k))


def _moe_case(shared, dispatch_kind, seed=0, n_tokens=(2, 64)):
    ref_cfg = _reduced(ref_get_config, ref_reduce_config, shared=shared)
    cfg = _reduced(get_config, reduce_config, shared=shared)
    if dispatch_kind == "plan":
        ref_plan, plan = _plans()
        ref_d, d = ref_dispatch_from_plan(ref_plan), dispatch_from_plan(plan)
    else:
        ref_d, d = ref_identity_dispatch(8), identity_dispatch(8)
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg, jnp.float32,
                             ref_d)
    x = np.random.default_rng(seed).standard_normal(
        n_tokens + (cfg.d_model,)).astype(np.float32)
    return ref_cfg, cfg, ref_d, d, ref_p, x


@pytest.mark.parametrize("dispatch_kind", ["identity", "plan"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_apply_moe_matches_reference(cf, shared, dispatch_kind):
    ref_cfg, cfg, ref_d, d, ref_p, x = _moe_case(shared, dispatch_kind)
    want, want_aux = ref_moe.apply_moe(ref_p, ref_cfg, jnp.asarray(x), ref_d,
                                       capacity_factor=cf)
    params = _to_torch(ref_p)
    got, aux = moe.apply_moe(params, cfg, torch.from_numpy(x), d,
                             capacity_factor=cf)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_y_close(got.numpy(), want)
    assert aux["drop_frac"].dtype == torch.float32
    assert float(aux["drop_frac"]) == float(want_aux["drop_frac"])
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]),
                                   rtol=1e-5)
    # drops happen exactly when the capacity is short of the busiest slot
    assert (float(aux["drop_frac"]) > 0) == (cf == 1.0)
    # the router's choices and the kept assignments, exactly
    top_e, top_slot, capacity, keep = _ref_layout(ref_p, ref_cfg, x, ref_d,
                                                  cf)
    r = moe.route(params, cfg, torch.from_numpy(x), d, capacity_factor=cf)
    assert r["capacity"] == capacity
    np.testing.assert_array_equal(r["top_e"].numpy(), top_e)
    np.testing.assert_array_equal(r["top_slot"].numpy(), top_slot)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)


def test_capacity_factor_comes_from_the_flag_when_not_passed():
    ref_cfg, cfg, ref_d, d, ref_p, x = _moe_case(0, "identity", seed=1)
    params = _to_torch(ref_p)
    flags.set_variant("cf1.0")
    ref_flags.set_variant("cf1.0")
    got, aux = moe.apply_moe(params, cfg, torch.from_numpy(x), d)
    want, want_aux = ref_moe.apply_moe(ref_p, ref_cfg, jnp.asarray(x), ref_d)
    _assert_y_close(got.numpy(), want)
    assert float(aux["drop_frac"]) == float(want_aux["drop_frac"]) > 0
    flags.reset()
    _, full = moe.apply_moe(params, cfg, torch.from_numpy(x), d)
    assert float(full["drop_frac"]) == 0.0        # the config's 8.0


def test_top_k_ties_pick_the_lower_expert_first():
    """Router logits 3.0 for expert 7 and exactly 0 for the others: the
    seven-way tie for the second place goes to expert 0, as in
    ``jax.lax.top_k``; all-zero logits tie all eight, giving (0, 1)."""
    ref_cfg, cfg, ref_d, d, ref_p, x = _moe_case(0, "identity", seed=2,
                                                 n_tokens=(2, 16))
    x[..., 0] = 1.0
    for col7 in (3.0, 0.0):
        router = np.zeros((cfg.d_model, 8), np.float32)
        router[0, 7] = col7
        rp = dict(ref_p, router=jnp.asarray(router))
        params = _to_torch(rp)
        r = moe.route(params, cfg, torch.from_numpy(x), d)
        top_e, _, _, _ = _ref_layout(rp, ref_cfg, x, ref_d, 8.0)
        expect = (7, 0) if col7 else (0, 1)
        assert (top_e == expect).all()
        np.testing.assert_array_equal(r["top_e"].numpy(), top_e)
        want, _ = ref_moe.apply_moe(rp, ref_cfg, jnp.asarray(x), ref_d)
        got, _ = moe.apply_moe(params, cfg, torch.from_numpy(x), d)
        _assert_y_close(got.numpy(), want)


# ------------------------------------------------------------ the model
VARIANTS = {"reduced": dict(), "dense1-shared1": dict(shared=1,
                                                      first_dense=1)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def models(request):
    kw = VARIANTS[request.param]
    ref_cfg = _reduced(ref_get_config, ref_reduce_config, **kw, **REDUCE)
    cfg = _reduced(get_config, reduce_config, **kw, **REDUCE)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ref_cfg, ref_params, cfg, params, tokens


def test_params_carry_over(models):
    _, ref_params, cfg, params, _ = models
    kd = cfg.moe.first_k_dense
    assert len(params["blocks"]) == cfg.num_layers
    assert ("dense_blocks" in ref_params) == (kd > 0)
    ported = init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref_params)
    for i in range(cfg.num_layers):
        group, j = ("dense_blocks", i) if i < kd else ("blocks", i - kd)
        want = jax.tree.map(lambda s: s[1:], shapes[group],
                            is_leaf=lambda x: isinstance(x, tuple))
        assert jax.tree.map(lambda t: tuple(t.shape),
                            ported["blocks"][i]) == want
        assert jax.tree.map(lambda t: tuple(t.shape),
                            params["blocks"][i]) == want
        ffn = "mlp" if i < kd else "moe"
        assert set(params["blocks"][i]) == {"ln_attn", "attn", "ln_mlp", ffn}
        leaf = params["blocks"][i][ffn]
        ref_leaf = ref_params[group][ffn]
        name = "wo" if ffn == "mlp" else "we_down"
        np.testing.assert_array_equal(leaf[name].numpy(),
                                      np.asarray(ref_leaf[name][j]))
    if kd:
        assert params["blocks"][0]["mlp"]["wo"].shape == (cfg.d_ff,
                                                          cfg.d_model)
        assert "shared" in params["blocks"][-1]["moe"]


def test_params_from_jax_takes_dense_blocks_only_with_dense_layers(models):
    _, ref_params, cfg, _, _ = models
    tree = dict(jax.tree.map(np.asarray, ref_params))
    refused = ("enc_blocks", "mtp", "frontend_proj")
    if not cfg.moe.first_k_dense:
        refused += ("dense_blocks",)
    for group in refused:
        with pytest.raises(NotImplementedError, match=f"{group} only with"):
            params_from_jax(cfg, dict(tree, **{group: {}}), device="cpu")


def test_forward_matches_reference(models):
    ref_cfg, ref_params, cfg, params, tokens = models
    want, _, want_aux, _ = ref_forward(ref_cfg, ref_params,
                                       jnp.asarray(tokens), chunk=32)
    got, cache, aux = forward(cfg, params, torch.from_numpy(tokens).long(),
                              return_aux=True)
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]),
                                   rtol=1e-4)
    # the reduction's capacity factor 8.0 drops nothing
    assert float(aux["drop_frac"]) == 0.0


def test_prefill_and_decode_match_reference(models):
    ref_cfg, ref_params, cfg, params, tokens = models
    ref_last, ref_cache = ref_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(tokens[:, :N_PREFILL])},
        max_len=S, chunk=32)
    last, cache = prefill(cfg, params,
                          {"tokens": torch.from_numpy(tokens[:, :N_PREFILL])},
                          max_len=S)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    for t in range(N_PREFILL, S):
        pos = np.full((B, 1), t, np.int32)
        want, ref_cache = ref_decode_step(
            ref_cfg, ref_params, ref_cache, jnp.asarray(tokens[:, t:t + 1]),
            jnp.asarray(pos), chunk=32)
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
    np.testing.assert_allclose(last.numpy(), full[:, 7].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(8, S):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        got, cache = decode_step(cfg, params, cache, tok[:, t:t + 1], pos)
        np.testing.assert_allclose(got.numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)
    assert len(init_cache(cfg, B, S, device="cpu")["layers"]) == \
        cfg.num_layers


def test_replicated_dispatch_serves_the_identity_logits(models):
    """The same per-expert weights gathered to the refit's slots (4 ranks,
    16 slots, replicas) give the identity dispatch's logits."""
    _, _, cfg, params, tokens = models
    _, plan = _plans()
    d = dispatch_from_plan(plan)
    s2e = torch.from_numpy(d.slot_to_expert).long()
    slotted = dict(params, blocks=[
        dict(p, moe={k: (v[s2e] if k.startswith("we_") else v)
                     for k, v in p["moe"].items()}) if "moe" in p else p
        for p in params["blocks"]])
    tok = torch.from_numpy(tokens).long()
    want, _ = forward(cfg, params, tok)
    got, _, aux = forward(cfg, slotted, tok, moe_dispatch=d, return_aux=True)
    assert float(aux["drop_frac"]) == 0.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# --------------------------------------------------------- the driver
def test_serve_cli_prints_the_reference_refit(capsys):
    assert serve_mod.main(["--arch", ARCH, "--reduced", "--requests", "2",
                           "--batch", "2", "--prefill-len", "12",
                           "--decode-len", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "on cpu" in out
    ref_plan, _ = _plans()
    trace = ref_core.synthetic_routing_trace(8, 200, top_k=2, seed=1)
    base = ref_core.baseline_contiguous_placement(8, 4, 4)
    want = (f"expert placement refit: span {base.avg_span(trace):.2f} -> "
            f"{ref_plan.avg_span(trace):.2f} across 4 EP ranks")
    assert want in out.splitlines()


def test_serve_records_the_prefill_drops():
    cfg, params = serve_mod.load_model(ARCH, reduced=True, device="cpu")
    res = serve_mod.serve(cfg, params, requests=4, batch=2, prefill_len=16,
                          decode_len=2)
    assert res["prefill_drop_frac"] == [0.0, 0.0]
    flags.set_variant("cf0.25")
    res = serve_mod.serve(cfg, params, requests=2, batch=2, prefill_len=16,
                          decode_len=2)
    # two MoE layers, each dropping some of its assignments
    assert len(res["prefill_drop_frac"]) == 1
    assert 0.0 < res["prefill_drop_frac"][0] < cfg.num_layers
    assert bool(torch.isfinite(res["logits"]).all())

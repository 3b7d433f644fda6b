"""The port's training path against the JAX package on the CPU: the loss,
its gradients and whole train steps, on the reference's parameters
(``params_from_jax``) and numpy inputs made from a seed.

* ``softmax_xent`` with and without a mask, within 1e-6;
* ``train_loss`` and its gradient (``jax.value_and_grad`` against
  ``torch.autograd.grad``) for reduced f32 olmo-1b (dense), qwen3-moe
  (the MoE aux terms), deepseek-v3 (MLA and the MTP term), mamba2-2.7b
  (pure SSM) and hymba-1.5b (attention beside the SSM): the loss
  within 1e-5 relative, each gradient leaf within 1e-4 of its largest
  |value| (f32 sums taken in another order; attention in the reference is
  an online softmax over KV chunks, the port's plain version a direct
  one);
* three ``make_train_step`` steps of reduced olmo-1b at ``accum_steps`` 1
  and 2 on the same pipeline batches: losses and ``grad_norm`` within
  1e-5 relative, parameters within 1e-5 absolute.  AdamW runs at lr 1e-3
  with eps 1e-6 there: its first steps move a parameter by lr g / (|g| +
  eps), so at the default eps 1e-8 a gradient element within f32 rounding
  noise (~1e-9) of zero moves by up to lr in either direction, on either
  side; eps 1e-6 bounds that to ~1e-6 of a parameter.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import flags as ref_flags
from repro.configs import get_config as ref_get_config
from repro.configs import reduce_config as ref_reduce_config
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.launch.steps import pick_optimizer as ref_pick
from repro.models import init_params as ref_init_params
from repro.models.model import softmax_xent as ref_softmax_xent
from repro.models.model import train_loss as ref_train_loss
from repro.optim import adamw as ref_adamw
from repro_torch import flags
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import PlacementAwarePipeline
from repro_torch.launch.steps import (loss_and_grads, make_train_step,
                                      pick_optimizer, shape_skip_reason)
from repro_torch.models import (forward, init_params, params_from_jax,
                                softmax_xent)
from repro_torch.optim import adamw
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_unflatten)

jax = pytest.importorskip("jax")
jnp = jax.numpy

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 24


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch):
    return (ref_reduce_config(ref_get_config(arch), dtype="float32"),
            reduce_config(get_config(arch), dtype="float32"))


def _batch(vocab, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _assert_grads_close(cfg, got, want_np):
    want = params_from_jax(cfg, want_np, device="cpu")
    got_leaves = tree_flatten_with_path(got)
    want_leaves = dict(tree_flatten_with_path(want))
    assert [p for p, _ in got_leaves] == list(want_leaves)
    for path, g in got_leaves:
        w = want_leaves[path].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=str(path))


# ------------------------------------------------------------ the loss
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    targets = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = ref_softmax_xent(jnp.asarray(logits), jnp.asarray(targets),
                            None if mask is None else jnp.asarray(mask))
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(targets),
                       None if mask is None else torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_softmax_xent_empty_mask_divides_by_one():
    logits = torch.zeros((1, 3, 5))
    targets = torch.zeros((1, 3), dtype=torch.long)
    assert float(softmax_xent(logits, targets, torch.zeros((1, 3)))) == 0.0


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b", "mamba2-2.7b",
                                  "hymba-1.5b"])
def test_train_loss_and_grads_match_reference(arch):
    ref_cfg, cfg = _configs(arch)
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, _np_tree(ref_params), device="cpu")
    batch = _batch(cfg.vocab_size)

    (want, ref_metrics), ref_grads = jax.value_and_grad(
        lambda p: ref_train_loss(ref_cfg, p, {
            k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)(
        ref_params)
    loss, metrics, grads = loss_and_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(want), rel=LOSS_RTOL)
    assert set(metrics) == set(ref_metrics)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(ref_metrics[k]),
                                                  rel=LOSS_RTOL, abs=1e-7)
    if cfg.moe:
        assert float(metrics["lb_loss"]) > 0 and float(metrics["z_loss"]) > 0
    if cfg.mtp_depth:
        assert float(metrics["mtp_loss"]) > 0
    _assert_grads_close(cfg, grads, _np_tree(ref_grads))
    # the caller's parameters are untouched and hold no graph
    assert not any(p.requires_grad for p in tree_leaves(params))


def test_train_loss_remat_changes_no_number():
    # train_loss checkpoints every block; the forward without remat gives
    # the same loss and gradients, bit for bit
    _, cfg = _configs("olmo-1b")
    params = init_params(cfg, seed=1, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab_size,
                                                       seed=1).items()}
    loss, _, with_remat = loss_and_grads(cfg, params, batch)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    logits, _ = forward(cfg, tree, batch["tokens"], remat=False)
    plain_loss = softmax_xent(logits, batch["targets"])
    plain = torch.autograd.grad(plain_loss, leaves)
    assert float(loss) == float(plain_loss.detach())
    for a, b in zip(tree_leaves(with_remat), plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    remat_logits, _ = forward(cfg, params, batch["tokens"], remat=True)
    assert torch.equal(remat_logits, logits.detach())


def test_shape_skip_reason_is_the_references():
    from repro.configs import SHAPE_GRID as REF_GRID
    from repro.launch.steps import shape_skip_reason as ref_skip
    from repro_torch.configs import SHAPE_GRID, list_configs

    assert {k: dataclasses.asdict(v) for k, v in SHAPE_GRID.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_GRID.items()}
    for arch in list_configs():
        for name, shape in SHAPE_GRID.items():
            assert shape_skip_reason(get_config(arch), shape) == ref_skip(
                ref_get_config(arch), REF_GRID[name]), (arch, name)
    assert shape_skip_reason(get_config("glm4-9b"),
                             SHAPE_GRID["long_500k"]) is not None


def test_pick_optimizer_is_the_references():
    for arch in ("olmo-1b", "qwen3-moe-30b-a3b", "deepseek-v3-671b"):
        assert pick_optimizer(get_config(arch)) == ref_pick(
            ref_get_config(arch))
    assert pick_optimizer(get_config("deepseek-v3-671b")) == "adafactor"


# ------------------------------------------------------- the train step
@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_reference(accum):
    ref_cfg, cfg = _configs("olmo-1b")
    if accum > 1:
        flags.set_variant(f"accum{accum}")
        ref_flags.set_variant(f"accum{accum}")
    lr, eps = 1e-3, 1e-6
    ref_step, ref_opt = ref_make_train_step(
        ref_cfg, optimizer=ref_adamw(lr, eps=eps))
    step, opt = make_train_step(cfg, optimizer=adamw(lr, eps=eps))
    ref_params = ref_init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, _np_tree(ref_params), device="cpu")
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    pipe = PlacementAwarePipeline(num_shards=16, num_hosts=4,
                                  vocab_size=cfg.vocab_size, batch_size=4,
                                  seq_len=16, device="cpu")
    ref_jit = jax.jit(ref_step)
    for _ in range(3):
        batch = pipe.next_batch()
        ref_params, ref_state, ref_m = ref_jit(
            ref_params, ref_state, {k: jnp.asarray(batch[k])
                                    for k in ("tokens", "targets")})
        params, state, m = step(params, state, {
            k: torch.from_numpy(batch[k]) for k in ("tokens", "targets")})
        for k in ("loss", "grad_norm"):
            assert float(m[k]) == pytest.approx(float(ref_m[k]),
                                                rel=LOSS_RTOL)
    assert int(state.step) == int(ref_state.step) == 3
    want = params_from_jax(cfg, _np_tree(ref_params), device="cpu")
    for (path, got), w in zip(tree_flatten_with_path(params),
                              tree_leaves(want)):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5, err_msg=str(path))

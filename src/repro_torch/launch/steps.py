"""The train, prefill and serve steps of the trainer and the server (the
reference's ``launch/steps.py``).

* ``make_train_step(cfg, optimizer, moe_dispatch)`` -> (train_step, opt):
  ``train_step(params, opt_state, batch)`` returns (new params, new
  optimizer state, metrics).  The loss is ``train_loss``; its gradient
  comes from ``torch.autograd.grad`` over the parameter leaves, with
  ``FLAGS["accum_steps"]`` microbatches summed in the parameter dtype (the
  reference's FSDP accumulators, bf16 at full width).  The gradient is
  clipped to global norm 1, the optimizer's update (already in the
  parameter dtype) is added as ``(p.f32 + u.f32).to(p.dtype)``: two
  roundings in bf16, as in the reference.  Nothing is updated in place,
  so the old parameters and state stay valid, unless ``donate=True``:
  then, as the reference's ``jax.jit(step, donate_argnums=(0, 1))`` lets
  XLA reuse the buffers of the parameters and optimizer state it is
  given, the step writes the new moments over the old ones
  (``update(..., inplace=True)``, AdamW only; another optimizer is
  refused) and each new parameter over the old one, with the same
  numbers, and returns those tensors; the caller must not read the old
  ones.  At deepseek-v3's three dense layers and MTP
  group (4.3 B parameters) the fp32 moments are 34 GB, and a second copy
  of them would not fit one 80 GB card beside the weights and gradients.
* ``make_prefill_step``, ``make_serve_step``: prefill and one decode step.
* ``pick_optimizer``: Adafactor for the 100B+ class, AdamW otherwise.
* ``shape_skip_reason``: the documented skips of the shape grid.

The reference's ``input_specs``, ``param_struct``, ``opt_struct`` and
``serve_cache_struct`` are ``jax.eval_shape`` structures for the dry run;
they wait for it (ROADMAP Queue 1 item 9.6), and so does the prefill's
``window_only`` cache.  The reference's ``chunk`` (the KV chunk of its jnp
attention) has no counterpart: the port's attention runs the kernels.
"""

from __future__ import annotations

import torch

from ..configs import ModelConfig, ShapeConfig
from ..flags import FLAGS
from ..models import decode_step, prefill, train_loss
from ..optim import clip_by_global_norm, make_optimizer
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "loss_and_grads", "pick_optimizer", "shape_skip_reason"]


def pick_optimizer(cfg: ModelConfig) -> str:
    """Adafactor for the 100B+ class (optimizer-state memory), AdamW
    otherwise."""
    return "adafactor" if cfg.param_count() > 5e10 else "adamw"


def loss_and_grads(cfg, params, batch, *, moe_dispatch=None):
    """(loss, metrics, grads) of ``train_loss`` at ``params``; grads has
    the parameter tree's structure and dtypes.  The caller's tensors are
    not touched (the leaves are detached views that require grad)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = train_loss(cfg, tree_unflatten(params, leaves), batch,
                               moe_dispatch=moe_dispatch)
    # a leaf that the loss does not read (hymba's ln_ssm) gets zeros, as
    # under jax.grad
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(cfg, optimizer=None, moe_dispatch=None, donate=False):
    opt = optimizer or make_optimizer(pick_optimizer(cfg), 3e-4)
    if donate and not opt.inplace:
        raise ValueError("make_train_step(donate=True) needs an optimizer "
                         "whose update writes in place (AdamW)")
    inplace = {"inplace": True} if donate else {}
    accum = int(FLAGS["accum_steps"])

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = loss_and_grads(
                cfg, params, batch, moe_dispatch=moe_dispatch)
        else:
            # microbatched accumulation: the batch's leading dim split
            # into accum slices, gradients summed in the parameter dtype
            gsum = tree_map(torch.zeros_like, params)
            lsum = 0.0
            for i in range(accum):
                micro = {k: x.reshape(accum, x.shape[0] // accum,
                                      *x.shape[1:])[i]
                         for k, x in batch.items()}
                l, _, g = loss_and_grads(cfg, params, micro,
                                         moe_dispatch=moe_dispatch)
                gsum = tree_map(lambda a, gg: a + gg.to(a.dtype), gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / accum, gsum)
            loss = lsum / accum
            metrics = {"loss": loss, "xent": loss}
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        metrics = dict(metrics, grad_norm=gnorm)
        updates, new_opt_state = opt.update(grads, opt_state, params,
                                            **inplace)
        del grads

        def apply(p, u):
            new = (p.to(torch.float32) + u.to(torch.float32)).to(p.dtype)
            return p.copy_(new) if donate else new

        new_params = tree_map(apply, params, updates)
        return new_params, new_opt_state, metrics

    return train_step, opt


def make_prefill_step(cfg, moe_dispatch=None):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch, moe_dispatch=moe_dispatch)

    return prefill_step


def make_serve_step(cfg, moe_dispatch=None):
    def serve_step(params, cache, tokens, positions):
        return decode_step(cfg, params, cache, tokens, positions,
                           moe_dispatch=moe_dispatch)

    return serve_step


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """Documented grid skips (the reference's DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic():
        return ("full-attention arch: 500k dense KV cache is not deployable; "
                "run sub-quadratic archs (ssm/hybrid/swa) instead")
    return None

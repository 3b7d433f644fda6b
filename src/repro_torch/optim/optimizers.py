"""Optimizers as plain functions over the port's parameter tree (nested
dicts and lists of tensors), the reference's ``optim/optimizers.py``:

* ``adamw``: fp32 first and second moments ``m`` / ``v`` of the
  parameter tree's structure, an int32 step counter;
* ``adafactor``: factored second moments (a (..., R, C) weight keeps
  (..., R) row and (..., C) column statistics), no first moment;
* ``cosine_schedule``, ``clip_by_global_norm``, ``make_optimizer``.

As in the reference, ``update(grads, state, params)`` returns the update
in each parameter's dtype (computed in fp32, then cast) and the new state;
the caller adds it.  Nothing is updated in place: the old state stays
valid (a checkpoint being written from it in the background reads it).
AdamW's ``update(..., inplace=True)`` is the exception, for a caller that
donates the state as the reference's ``jax.jit(step, donate_argnums=(0,
1))`` does: the same arithmetic writes the new moments over the old
tensors instead of fresh ones, and the returned state holds those
tensors, so the update needs no second copy of the moments
(``Optimizer.inplace`` says whether ``update`` takes the argument).
The step counter is an int32 0-d tensor on the parameters' device, and
the bias corrections take ``b ** step`` in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["Optimizer", "AdamWState", "AdafactorState", "cosine_schedule",
           "clip_by_global_norm", "adamw", "adafactor", "make_optimizer"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)
    inplace: bool = False  # update also takes inplace=True


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    """lr(step): linear warm-up to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``; an fp32 0-d tensor."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global L2 norm is at most ``max_norm``,
    the norm before scaling).  Squares are summed in fp32, leaf after
    leaf; each scaled leaf keeps its dtype."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    gnorm = torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gnorm


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _pick(new: list, i: int, like):
    """A tree of ``like``'s structure holding item ``i`` of each tuple of
    ``new`` (one tuple a leaf, in leaf order)."""
    it = iter(new)
    return tree_map(lambda _: next(it)[i], like)


# -------------------------------------------------------------------- AdamW
class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(_step0(params), tree_map(zeros, params),
                          tree_map(zeros, params))

    def update(grads, state, params, inplace=False):
        step = state.step + 1
        lr_t = lr_fn(step)
        t = step.to(torch.float32)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        new = []

        def upd(g, m, v, p):
            # the new moments go to m / v themselves when inplace, else to
            # fresh tensors; at most two fp32 temporaries of the leaf's size
            m_new = m if inplace else torch.empty_like(m)
            v_new = v if inplace else torch.empty_like(v)
            g = g.to(torch.float32)
            torch.mul(m, b1, out=m_new).add_(g * (1 - b1))
            torch.mul(v, b2, out=v_new).add_((g * (1 - b2)).mul_(g))
            del g
            denom = (v_new / c2).sqrt_().add_(eps)
            delta = (m_new / c1).div_(denom)
            del denom
            delta.add_(weight_decay * p.to(torch.float32))
            new.append((m_new, v_new))
            return delta.mul_(-lr_t).to(p.dtype)

        updates = tree_map(upd, grads, state.m, state.v, params)
        return updates, AdamWState(step, _pick(new, 0, grads),
                                   _pick(new, 1, grads))

    return Optimizer(init, update, inplace=True)


# ---------------------------------------------------------------- Adafactor
class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: dict   # row stats (last dim reduced)
    vc: dict   # col stats (second-to-last dim reduced)
    v: dict    # full stats for <2D params only


def adafactor(lr, decay=0.8, eps=1e-30, clip_threshold=1.0,
              weight_decay=0.0) -> Optimizer:
    """Factored RMS optimizer (Shazeer & Stern).  For a (..., R, C) weight
    it stores (..., R) + (..., C) statistics; a weight of fewer than two
    dims keeps full statistics (and 0-d placeholders for the factors)."""
    lr_fn = _lr_fn(lr)

    def factored(p):
        return p.dim() >= 2

    def init(params):
        def z(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vr0(p):
            return z(p.shape[:-1], p) if factored(p) else z((), p)

        def vc0(p):
            return (z(p.shape[:-2] + p.shape[-1:], p) if factored(p)
                    else z((), p))

        def v0(p):
            return z((), p) if factored(p) else z(p.shape, p)

        return AdafactorState(_step0(params), tree_map(vr0, params),
                              tree_map(vc0, params), tree_map(v0, params))

    def update(grads, state, params):
        step = state.step + 1
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)
        new = []

        def upd(g, vr, vc, v, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if factored(p):
                vr_new = beta * vr + (1 - beta) * g2.mean(dim=-1)
                vc_new = beta * vc + (1 - beta) * g2.mean(dim=-2)
                r = vr_new / torch.clamp_min(
                    vr_new.mean(dim=-1, keepdim=True), eps)
                pre = g / torch.sqrt(r[..., None] * vc_new[..., None, :]
                                     + eps)
                v_new = v
            else:
                v_new = beta * v + (1 - beta) * g2
                pre = g / torch.sqrt(v_new + eps)
                vr_new, vc_new = vr, vc
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(pre * pre) + 1e-12)
            pre = pre / torch.clamp_min(rms / clip_threshold, 1.0)
            delta = pre + weight_decay * p.to(torch.float32)
            new.append((vr_new, vc_new, v_new))
            return (-lr_t * delta).to(p.dtype)

        updates = tree_map(upd, grads, state.vr, state.vc, state.v, params)
        return updates, AdafactorState(step, *(_pick(new, i, grads)
                                               for i in range(3)))

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise KeyError(name)

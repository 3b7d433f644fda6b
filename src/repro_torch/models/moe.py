"""Mixture-of-Experts block with workload-driven expert placement.

The single-device half of the reference's ``models/moe.py``:

* routing: an f32 top-k softmax router, the top-k weights renormalised
  (plus optional shared experts, deepseek-style);
* dispatch: sort-based ragged dispatch into per-SLOT capacity buffers, no
  (tokens, E, C) one-hot; an assignment past its slot's capacity is
  dropped (``aux["drop_frac"]``);
* the expert FFNs (SwiGLU) by slot, then the combine weighted by the
  router.

THE PAPER'S TECHNIQUE lives in the expert->slot mapping: ``slot_of`` is a
(num_experts, num_ranks) replica-selection table built from an
``ExpertPlacementPlan`` of ``repro_torch.core.expert_placement`` (LMBR /
PRA over a routing trace).  Hot or co-firing experts occupy several
slots; the tokens of each source rank read the replica the table names.
With the identity dispatch (slots == experts, no replicas) this is plain
expert parallelism.

Where the reference scatters (``.at[].add``), the port gathers: a slot's
buffer row c holds the sorted assignment ``seg_start[slot] + c``, and each
token reads its k outputs back at its own (slot, position).  Each buffer
cell and each output has one writer, so the result does not depend on the
order of atomic adds.  Nothing waits for the device: no boolean-mask
indexing, no ``nonzero``, no ``.item()``; the capacity comes from the
shapes alone.

Ties: ``jax.lax.top_k`` puts the lower expert first among equal
probabilities, ``jnp.argsort`` is stable and ``jnp.searchsorted`` is
left-sided; the port's stable sorts and ``torch.searchsorted`` do the same.

The expert products are ``jnp.einsum`` outside any Pallas kernel in the
reference, so here they are ``torch.bmm`` (cuBLAS).

Not ported: ``_apply_moe_shard_map``, the explicit all-to-all EP path,
runs only under a mesh whose model axis is larger than 1.  One card has
none, so it waits with the mesh pieces (ROADMAP Queue 1 item 9.6).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..flags import FLAGS
from .layers import dense_init

__all__ = ["MoEDispatch", "identity_dispatch", "dispatch_from_plan",
           "init_moe", "route", "apply_moe"]


@dataclasses.dataclass(frozen=True)
class MoEDispatch:
    """Expert->slot routing tables (from the placement engine).

    slot_of[e, r]: the slot a token originating on EP rank r uses for
    expert e (replica selection baked into a lookup).  num_slots >=
    num_experts; slot s lives on rank s // slots_per_rank."""

    num_slots: int
    num_ranks: int
    slot_of: np.ndarray          # (num_experts, num_ranks) int32
    slot_to_expert: np.ndarray   # (num_slots,) int32 (for weight gathering)
    _on_device: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def slots_per_rank(self) -> int:
        return self.num_slots // self.num_ranks

    def slot_of_on(self, device) -> torch.Tensor:
        """``slot_of`` as an int64 tensor on ``device``, copied there once."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(
                self.slot_of, dtype=torch.int64, device=device)
        return self._on_device[key]


@functools.lru_cache(maxsize=None)
def identity_dispatch(num_experts: int, num_ranks: int = 1) -> MoEDispatch:
    """Slot e holds expert e; every rank reads it.  Cached, so that the
    default dispatch keeps its device table from call to call."""
    slot_of = np.tile(np.arange(num_experts, dtype=np.int32)[:, None],
                      (1, num_ranks))
    return MoEDispatch(num_experts, num_ranks, slot_of,
                       np.arange(num_experts, dtype=np.int32))


def dispatch_from_plan(plan) -> MoEDispatch:
    """Routing tables from a ``repro_torch.core`` ``ExpertPlacementPlan``."""
    num_slots = plan.num_ranks * plan.slots_per_rank
    slot_to_expert = np.full((num_slots,), 0, dtype=np.int32)
    for r in range(plan.num_ranks):
        for s in range(plan.slots_per_rank):
            e = plan.slot_to_expert[r, s]
            slot_to_expert[r * plan.slots_per_rank + s] = max(int(e), 0)
    slot_of = np.zeros((plan.num_experts, plan.num_ranks), dtype=np.int32)
    for e in range(plan.num_experts):
        ranks = np.flatnonzero(plan.expert_slot_table[e] >= 0)
        for r in range(plan.num_ranks):
            # replica selection: a copy on the token's own rank, else the
            # first (deterministic) replica: the greedy-cover choice for a
            # single-expert read
            src = r if r in set(ranks.tolist()) else int(ranks[0])
            slot_of[e, r] = src * plan.slots_per_rank + int(
                plan.expert_slot_table[e, src])
    return MoEDispatch(num_slots, plan.num_ranks, slot_of, slot_to_expert)


def init_moe(gen, cfg, dtype, dispatch: MoEDispatch | None = None,
             device=None) -> dict:
    """Expert weights are stored SLOT-major: drawn per expert, then
    gathered to the slots through ``slot_to_expert``, so replicas start
    identical.  The router is f32."""
    m = cfg.moe
    d = cfg.d_model
    dispatch = dispatch or identity_dispatch(m.num_experts)
    shape_in, shape_out = (m.num_experts, d, m.d_ff_expert), \
        (m.num_experts, m.d_ff_expert, d)
    params = {
        "we_gate": dense_init(gen, shape_in, dtype, device=device),
        "we_up": dense_init(gen, shape_in, dtype, device=device),
        "we_down": dense_init(gen, shape_out, dtype, device=device),
        "router": dense_init(gen, (d, m.num_experts), torch.float32,
                             device=device),
    }
    if dispatch.num_slots != m.num_experts:
        s2e = torch.as_tensor(dispatch.slot_to_expert, dtype=torch.int64,
                              device=device)
        for name in ("we_gate", "we_up", "we_down"):
            params[name] = params[name][s2e]
    if m.num_shared_experts:
        ff_sh = m.d_ff_expert * m.num_shared_experts
        params["shared"] = {
            "wi_gate": dense_init(gen, (d, ff_sh), dtype, device=device),
            "wi_up": dense_init(gen, (d, ff_sh), dtype, device=device),
            "wo": dense_init(gen, (ff_sh, d), dtype, device=device),
        }
    return params


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, the lower index first on ties (a
    stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(params: dict, cfg, x: torch.Tensor,
          dispatch: MoEDispatch | None = None,
          capacity_factor: float | None = None) -> dict:
    """The router and the slot layout of x (B, S, d), flattened to n = B S
    tokens of k assignments each:

    * ``logits``, ``probs`` (n, E) f32; ``top_w`` (renormalised), ``top_e``
      (n, k);
    * ``top_slot`` (n, k): the slot each assignment reads, by the token's
      source rank (``tokens_per_rank`` consecutive tokens a rank);
    * ``capacity``: assignments a slot takes, from the shapes alone;
    * the sort-based layout: ``token_idx`` (n k,) the token of each
      assignment in slot order (stable), ``seg_start`` / ``seg_end``
      (num_slots,) each slot's run in that order, and per assignment in
      token order its ``pos`` in its slot (n, k) and ``keep`` = pos <
      capacity."""
    m = cfg.moe
    dispatch = dispatch or identity_dispatch(m.num_experts)
    b, s, d = x.shape
    n, k = b * s, m.top_k
    cf = capacity_factor or FLAGS["moe_cf"] or m.capacity_factor
    n_slots = dispatch.num_slots
    dev = x.device

    logits = x.reshape(n, d).float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, k)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # the paper's technique: expert id -> slot id through the replica-
    # selection table, by the token's EP rank (its place among the shards)
    tokens_per_rank = max(1, n // dispatch.num_ranks)
    src_rank = torch.clamp_max(
        torch.arange(n, device=dev) // tokens_per_rank, dispatch.num_ranks - 1)
    top_slot = dispatch.slot_of_on(dev)[top_e, src_rank[:, None]]

    capacity = int(max(8, math.ceil(n * k / n_slots * cf)))
    flat_slot = top_slot.reshape(-1)
    sort_idx = torch.argsort(flat_slot, stable=True)
    sorted_slot = flat_slot[sort_idx]
    slots = torch.arange(n_slots, device=dev)
    seg_start = torch.searchsorted(sorted_slot, slots)
    seg_end = torch.searchsorted(sorted_slot, slots, right=True)
    pos_sorted = torch.arange(n * k, device=dev) - seg_start[sorted_slot]
    pos = torch.empty_like(pos_sorted).scatter_(0, sort_idx, pos_sorted)
    pos = pos.view(n, k)
    return dict(logits=logits, probs=probs, top_w=top_w, top_e=top_e,
                top_slot=top_slot, capacity=capacity,
                token_idx=sort_idx // k, seg_start=seg_start,
                seg_end=seg_end, pos=pos, keep=pos < capacity)


def apply_moe(params: dict, cfg, x: torch.Tensor,
              dispatch: MoEDispatch | None = None,
              capacity_factor: float | None = None):
    """x (B, S, d) -> (y (B, S, d), aux) with aux the load-balancing
    terms ``lb_loss`` and ``z_loss`` and the dropped share ``drop_frac``,
    0-d f32 tensors on x's device.  The capacity factor is
    ``capacity_factor``, else the ``moe_cf`` flag, else the config's."""
    m = cfg.moe
    b, s, d = x.shape
    n, k = b * s, m.top_k
    r = route(params, cfg, x, dispatch, capacity_factor)
    cap = r["capacity"]
    n_slots = r["seg_start"].shape[0]
    xf = x.reshape(n, d)

    # per-slot buffers: cell (slot, c) holds the slot's c-th assignment in
    # sorted order, if it has one (an empty cell reads the zero row n)
    cell = r["seg_start"][:, None] + torch.arange(cap, device=x.device)
    filled = cell < r["seg_end"][:, None]
    src = torch.where(filled, r["token_idx"][cell.clamp_max(n * k - 1)], n)
    buf = torch.cat([xf, xf.new_zeros(1, d)])[src]       # (slots, C, d)
    h = torch.bmm(buf, params["we_gate"])
    u = torch.bmm(buf, params["we_up"])
    obuf = torch.bmm(F.silu(h) * u, params["we_down"])   # (slots, C, d)
    del buf, h, u    # ~1.2 GB at qwen3's prefill, freed before the combine

    # combine: each token reads its k outputs at (slot, pos), the dropped
    # ones as zero, weighted by the router
    keep = r["keep"]
    at = r["top_slot"] * cap + torch.where(keep, r["pos"], 0)
    vals = obuf.reshape(n_slots * cap, d)[at.reshape(-1)].view(n, k, d)
    contrib = torch.where(keep[..., None],
                          vals * r["top_w"].to(vals.dtype)[..., None], 0)
    y = contrib.sum(1).to(x.dtype)

    if m.num_shared_experts:
        sh = params["shared"]
        y = y + (F.silu(xf @ sh["wi_gate"]) * (xf @ sh["wi_up"])) @ sh["wo"]

    # aux: switch-style load-balance loss + router z-loss
    me = r["probs"].mean(0)
    top_e = r["top_e"].reshape(-1)
    ce = torch.zeros(m.num_experts, dtype=torch.float32,
                     device=x.device).index_add_(
        0, top_e, torch.ones_like(top_e, dtype=torch.float32)) / (n * k)
    aux = dict(lb_loss=m.num_experts * (me * ce).sum(),
               z_loss=(torch.logsumexp(r["logits"], -1) ** 2).mean(),
               drop_frac=1.0 - keep.float().mean())
    return y.reshape(b, s, d), aux

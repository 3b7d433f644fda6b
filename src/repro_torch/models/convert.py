"""Parameters from the reference's layout.

``params_from_jax(cfg, tree)`` takes the JAX package's ``init_params``
pytree with every leaf turned into a numpy array (the caller does
``jax.tree.map(np.asarray, params)``; nothing here imports JAX) and
returns the port's parameters: the same nested dicts, with the
layer-stacked ``blocks`` (leading axis = layer) split into a list of
per-layer dicts.  An MoE config with ``first_k_dense`` > 0 also has the
stacked ``dense_blocks`` group of its first layers: those come first in
the list, then the ``num_layers - first_k_dense`` MoE layers of
``blocks`` (``router``, ``we_gate``, ``we_up``, ``we_down``, ``shared``).
A config with ``mtp_depth`` > 0 also has the ``mtp`` group (``proj``,
one unstacked dense ``block``, ``norm``), taken as it is.  An
encoder-decoder config (``encoder_layers`` > 0) has the layer-stacked
``enc_blocks``, split into a list as ``blocks`` is, and ``enc_final_norm``;
a config with a ``frontend`` has ``frontend_proj``.  A group that the
config does not call for is refused, naming the field it needs.  Leaf dtypes
are kept; a bfloat16 leaf (numpy's ``ml_dtypes`` bfloat16) goes through
float32, which holds it exactly.
Empty groups (the non-parametric LayerNorm's ``{}``) stay empty.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod

__all__ = ["params_from_jax"]


def _leaf(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


# each optional group and the config field that calls for it
_NEEDS = {"dense_blocks": "an MoE config's first_k_dense layers",
          "mtp": "mtp_depth", "enc_blocks": "encoder_layers",
          "enc_final_norm": "encoder_layers", "frontend_proj": "frontend"}


def params_from_jax(cfg, tree: dict, device=None) -> dict:
    dev = device_mod.resolve(device)
    kd = cfg.moe.first_k_dense if cfg.moe else 0
    groups = ["blocks", "dense_blocks"] if kd else ["blocks"]
    plain = {"embed", "unembed", "final_norm"}
    if cfg.mtp_depth:
        plain.add("mtp")
    if cfg.encoder_layers:
        groups.append("enc_blocks")
        plain.add("enc_final_norm")
    if cfg.frontend:
        plain.add("frontend_proj")
    extra = set(tree) - plain - set(groups)
    if extra:
        raise NotImplementedError(
            f"parameter groups {sorted(extra)} do not belong to {cfg.name}: "
            + "; ".join(f"{g} only with {_NEEDS.get(g, 'another model')}"
                        for g in sorted(extra)))
    out = {k: _map(v, lambda a: _leaf(a, dev))
           for k, v in tree.items() if k not in groups}
    out["blocks"] = [
        _map(tree[g], lambda a, i=i: _leaf(a[i], dev))
        for g, n in (("dense_blocks", kd), ("blocks", cfg.num_layers - kd))
        for i in range(n)]
    if cfg.encoder_layers:
        out["enc_blocks"] = [_map(tree["enc_blocks"],
                                  lambda a, i=i: _leaf(a[i], dev))
                             for i in range(cfg.encoder_layers)]
    return out

"""Parameters from the reference's layout.

``params_from_jax(cfg, tree)`` takes the JAX package's ``init_params``
pytree with every leaf turned into a numpy array (the caller does
``jax.tree.map(np.asarray, params)``; nothing here imports JAX) and
returns the port's parameters: the same nested dicts, with the
layer-stacked ``blocks`` (leading axis = layer) split into a list of
per-layer dicts.  Leaf dtypes are kept; a bfloat16 leaf (numpy's
``ml_dtypes`` bfloat16) goes through float32, which holds it exactly.
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


def params_from_jax(cfg, tree: dict, device=None) -> dict:
    dev = device_mod.resolve(device)
    extra = set(tree) - {"embed", "unembed", "final_norm", "blocks"}
    if extra:
        raise NotImplementedError(
            f"parameter groups {sorted(extra)} belong to families the port "
            "does not run yet (ROADMAP Queue 1 item 9: MoE's dense_blocks "
            "and mtp in 9.2, the encoder-decoder and VLM frontends' "
            "enc_blocks and frontend_proj in 9.4)")
    out = {k: _map(v, lambda a: _leaf(a, dev))
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_map(tree["blocks"], lambda a, i=i: _leaf(a[i], dev))
                     for i in range(cfg.num_layers)]
    return out

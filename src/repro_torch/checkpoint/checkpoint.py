"""Sharded checkpoint save / restore (the reference's
``checkpoint/checkpoint.py`` format).

One ``.npz`` bundle per logical SHARD (a slice of the flattened parameter
+ optimizer-state tree, leaves dealt to shards by size) plus a JSON
manifest with the leaf keys, the shard of each leaf, each leaf's torch
dtype and the step.  Writes go to ``<dir>.tmp``, which is then renamed
into place, so a checkpoint is whole or absent.

Tensors reach numpy through ``.cpu()``.  bfloat16 has no numpy dtype, so a
bf16 leaf is stored as its raw 16 bits (uint16) and the manifest's dtype
turns it back; every other dtype is stored as itself.  Arrays are saved
whole per shard, never in a device layout.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .. import device as device_mod
from ..tree import tree_flatten_with_path, tree_unflatten

__all__ = ["MANIFEST", "save_checkpoint", "load_checkpoint"]

MANIFEST = "manifest.json"


def _flatten(tree):
    flat = tree_flatten_with_path(tree)
    return (["/".join(str(k) for k in path) for path, _ in flat],
            [leaf for _, leaf in flat])


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    t = torch.as_tensor(leaf).detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, dtype: str, dev) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def save_checkpoint(path: str, tree, step: int, num_shards: int = 8) -> dict:
    """Returns the manifest (incl. the shard -> keys map)."""
    keys, leaves = _flatten(tree)
    arrays = [_to_numpy(leaf) for leaf in leaves]
    order = np.argsort([-np.prod(np.asarray(a.shape, dtype=np.int64))
                        for a, _ in arrays])
    # the largest leaf first, each to the lightest shard: balances bytes
    shard_of = {}
    loads = [0] * num_shards
    for i in order:
        s = int(np.argmin(loads))
        shard_of[int(i)] = s
        loads[s] += int(np.prod(arrays[i][0].shape))
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shard_keys: dict[int, list[int]] = {s: [] for s in range(num_shards)}
    for i, s in shard_of.items():
        shard_keys[s].append(i)
    for s, idxs in shard_keys.items():
        np.savez(os.path.join(tmp, f"shard_{s:05d}.npz"),
                 **{str(i): arrays[i][0] for i in idxs})
    manifest = dict(
        step=step,
        num_shards=num_shards,
        keys=keys,
        shard_of={str(i): s for i, s in shard_of.items()},
        dtypes=[name for _, name in arrays],
    )
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return manifest


def load_checkpoint(path: str, tree_like, shardings=None, device=None):
    """(tree of ``tree_like``'s structure with the saved tensors on
    ``device`` (default "cuda"), saved step).  Raises FileNotFoundError
    when a shard's file is missing and AssertionError when the keys are
    not ``tree_like``'s.  ``shardings`` (placing the leaves over a mesh)
    waits for the mesh, ROADMAP Queue 1 item 9.6."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto shardings needs the mesh (ROADMAP Queue 1 item "
            "9.6); pass a device")
    dev = device_mod.resolve(device)
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    keys, _ = _flatten(tree_like)
    assert keys == manifest["keys"], "checkpoint/model structure mismatch"
    loaded: dict[int, np.ndarray] = {}
    for s in range(manifest["num_shards"]):
        f = os.path.join(path, f"shard_{s:05d}.npz")
        if not os.path.exists(f):
            continue
        with np.load(f) as z:
            for k in z.files:
                loaded[int(k)] = z[k]
    missing = [i for i in range(len(keys)) if i not in loaded]
    if missing:
        raise FileNotFoundError(
            f"checkpoint missing {len(missing)} leaves (lost shards?): "
            f"{[keys[i] for i in missing[:4]]}"
        )
    leaves = [_from_numpy(loaded[i], manifest["dtypes"][i], dev)
              for i in range(len(keys))]
    return tree_unflatten(tree_like, leaves), manifest["step"]

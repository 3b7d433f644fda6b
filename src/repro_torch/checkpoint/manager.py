"""Checkpoint manager: async saves, keep-K retention, restart discovery,
and placement-driven replica distribution of checkpoint shards (the
reference's ``checkpoint/manager.py``).

Shards are items, each host's restore set is a hyperedge, storage nodes
are partitions: the port's ``plan_shard_placement`` (PRA-3W, on
``device``) places RF copies so that RF-1 storage-node failures leave
every shard recoverable and a restarting host reads from few storage
nodes (``restore_span``).  Restored tensors land on ``device``.
"""

from __future__ import annotations

import os
import re
import shutil
import threading

import numpy as np

from .. import device as device_mod
from ..core import plan_shard_placement
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"step_(\d+)$")


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep: int = 3,
        num_shards: int = 8,
        num_storage_nodes: int = 4,
        replication: int = 2,
        async_save: bool = True,
        device=None,
    ):
        self.dir = directory
        self.keep = keep
        self.num_shards = num_shards
        self.async_save = async_save
        self.num_storage_nodes = num_storage_nodes
        self.replication = min(replication, num_storage_nodes)
        self.device = device_mod.resolve(device)
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.replica_plan = None

    # ---------------------------------------------------------------- paths
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.search(d)
            if m and not d.endswith(".tmp"):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, restore_sets=None, blocking=None):
        """``restore_sets``: optional list of shard-id arrays (one per
        restoring host) used to fit the replica placement for this
        checkpoint.  An async save runs on a thread; the next ``save``,
        ``wait`` or restore joins it and raises what it raised."""
        self.wait()

        def _do():
            save_checkpoint(self._path(step), tree, step, self.num_shards)
            self._gc()
            if restore_sets is not None:
                self.replica_plan = plan_shard_placement(
                    restore_sets, self.num_shards, self.num_storage_nodes,
                    capacity=max(
                        2.0,
                        np.ceil(self.num_shards * self.replication
                                / self.num_storage_nodes) + 1,
                    ),
                    algorithm="pra3", rf=self.replication,
                    device=self.device,
                )

        def _run():
            try:
                _do()
            except BaseException as exc:  # re-raised by wait()
                self._error = exc

        if self.async_save if blocking is None else not blocking:
            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _do()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def restore_latest(self, tree_like, shardings=None):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        return load_checkpoint(self._path(step), tree_like, shardings,
                               device=self.device)

    def restore_span(self, host_restore_set) -> int:
        """Storage nodes one host touches to restore (needs a replica
        plan)."""
        if self.replica_plan is None:
            raise RuntimeError(
                "no replica plan fitted (pass restore_sets to save)")
        return self.replica_plan.span(np.asarray(host_restore_set))

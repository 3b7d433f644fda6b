"""Fault-tolerant training runner (the reference's
``runtime/fault_tolerance.py``).

Failure model: data hosts die or slow down (input side), accelerator
workers die (step side), storage nodes die (checkpoint side).  Responses,
in order of cheapness:

  1. input-host failure  -> replica re-cover via the paper's placement
     (the pipeline's ``cover_excluding``), no step disruption;
  2. straggling host     -> the same, proactively (``StragglerDetector``);
  3. worker/step failure -> restart from the ``CheckpointManager``'s
     latest step.

Moving the state onto another mesh (the reference's ``elastic_remesh``)
waits for the mesh, ROADMAP Queue 1 item 9.6.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

from ..checkpoint import CheckpointManager
from ..data import PlacementAwarePipeline
from .straggler import StragglerDetector

__all__ = ["HostHealth", "StepFailure", "FaultTolerantRunner"]


@dataclasses.dataclass
class HostHealth:
    alive: bool = True
    slow: bool = False


class StepFailure(Exception):
    """Raised by the step function when an accelerator worker dies."""


class FaultTolerantRunner:
    def __init__(
        self,
        step_fn: Callable,            # (state, batch) -> (state, metrics)
        state,                        # tree (params, opt_state, ...)
        pipeline: PlacementAwarePipeline,
        ckpt: CheckpointManager,
        ckpt_every: int = 20,
        max_restarts: int = 8,
    ):
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler = StragglerDetector(pipeline.num_hosts)
        self.step = 0
        self.restarts = 0
        self.events: list[tuple[int, str]] = []

    # ------------------------------------------------------------- failures
    def kill_input_host(self, host: int):
        self.pipeline.mark_dead(host)
        self.events.append((self.step, f"input_host_dead:{host}"))

    def report_host_latency(self, host: int, seconds: float):
        if self.straggler.observe(host, seconds):
            self.pipeline.mark_slow(host)
            self.events.append((self.step, f"straggler_avoided:{host}"))

    # ----------------------------------------------------------------- run
    def run(self, num_steps: int) -> dict:
        while self.step < num_steps:
            try:
                batch = self.pipeline.next_batch()
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                dt = time.perf_counter() - t0
                for h in batch["hosts"]:
                    self.report_host_latency(h,
                                             dt / max(len(batch["hosts"]), 1))
                self.step += 1
                if self.step % self.ckpt_every == 0:
                    self.ckpt.save(self.step, self.state)
            except StepFailure as exc:
                self.restarts += 1
                self.events.append((self.step, f"step_failure:{exc}"))
                if self.restarts > self.max_restarts:
                    raise RuntimeError("restart budget exhausted") from exc
                restored, saved_step = self.ckpt.restore_latest(self.state)
                if restored is not None:
                    self.state = restored
                    self.step = saved_step
                else:
                    self.step = 0  # cold restart
        self.ckpt.save(self.step, self.state, blocking=True)
        return dict(
            steps=self.step,
            restarts=self.restarts,
            avg_input_span=self.pipeline.avg_span(),
            events=self.events,
        )

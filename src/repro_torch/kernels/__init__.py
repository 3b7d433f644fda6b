"""Hand-written CUDA kernels of the placement pipeline, each with its plain
PyTorch version and a launch counter:

  span_gain      — gain matrix of one greedy cover round
  cover_rounds   — every greedy round of a word-count bucket
  lockstep_peel  — the dense Algorithm-5 peel of LMBR

A wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors (or raises); it never falls back from one to the other.
"""

from __future__ import annotations

import torch

__all__ = ["check_same_device", "launch_args"]


def check_same_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def launch_args(dev: torch.device) -> tuple[int, int]:
    """(device index, current stream handle) for a C launch entry point."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream

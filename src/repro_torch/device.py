"""Explicit device selection.

Every entry point of the package takes a ``device`` (default ``"cuda"``)
and passes it down.  Nothing falls back to the CPU on its own: asking for a
GPU on a host without one raises, and the CPU runs only when the caller
names it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.  Raises
    RuntimeError when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev

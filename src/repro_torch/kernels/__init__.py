"""Hand-written CUDA kernels, each with its plain PyTorch version and a
launch counter.  The placement pipeline's:

  span_gain         — gain matrix of one greedy cover round
  cover_rounds      — every greedy round of a word-count bucket
  lockstep_peel     — the dense Algorithm-5 peel of LMBR

and the model stack's (the serving paths):

  flash_attention   — causal / sliding-window GQA prefill attention, and
                      its latent form for MLA (flash_attention_latent)
  decode_attention  — one-token GQA flash-decode over a KV cache, and its
                      latent form for MLA (decode_attention_latent)
  ssd_scan          — the Mamba2 SSD chunk scan from a carried state

A wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors (or raises); it never falls back from one to the other.
On CUDA tensors flash_attention, its latent form and ssd_scan are
differentiable (each backward is a kernel too); the two decode kernels
serve only, have no backward and raise rather than return a result cut
from the autograd graph (``refuse_grad``).
"""

from __future__ import annotations

import torch

__all__ = ["check_same_device", "launch_args", "refuse_grad"]


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


def refuse_grad(kernel: str, item: str, *tensors: torch.Tensor) -> None:
    """Raise NotImplementedError when autograd would need a gradient of
    ``kernel``, which has no backward on the card: grad mode is on and an
    input requires grad.  ``item`` says why the kernel has none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward on the card ({item}); run it under "
            "torch.no_grad(), or on CPU tensors, whose plain version "
            "autograd differentiates")

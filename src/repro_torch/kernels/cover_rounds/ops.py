"""cover_rounds: every greedy set-cover round of one word-count bucket.

For each query b, round after round until its pins are covered: popcount
gains ``codes[b] & rem[b]`` per partition, take the first maximum (ties ->
lowest partition id), clear the chosen partition's bits, record it in
``ch[b, r]``.  A query whose best gain is 0 while bits remain is marked
``bad`` and stops (its items are stored nowhere); the caller then runs the
bucket on the host loop, which raises the canonical error.

* ``cover_rounds_plain`` — the plain PyTorch version, one tensor round per
  greedy round.
* ``cover_rounds`` — the wrapper: plain version for CPU tensors, the CUDA
  kernel (``csrc/cover_rounds.cu``) for CUDA tensors.
  ``cover_rounds.launches`` counts kernel launches.
* ``rounds_class`` — the class the kernel runs a bucket's (N, W) in
  (``"register"``, ``"shared"`` or ``"global"``); the C side chooses, this
  mirrors its test.

Both return ``ch`` (B, Rmax) int32, -1 past each query's last round, with
``Rmax = min(N, 64 W)``, and ``bad`` (B,) bool.
"""

from __future__ import annotations

import torch

from ... import _build
from .. import check_same_device, launch_args
from ..span_gain.ops import span_gains_plain

__all__ = ["cover_rounds", "cover_rounds_plain", "max_rounds",
           "rounds_class"]

# the kernel's classes: one warp per query with the rows in registers (W 1,
# N <= 256) or in shared memory (W <= 8, N W <= 2048 words); one block per
# query reading global memory otherwise
REGISTER_MAX_N = 256
SHARED_MAX_W = 8
SHARED_MAX_WORDS = 2048


def max_rounds(N: int, W: int) -> int:
    """Round bound of a bucket: each round covers at least one pin."""
    return min(N, 64 * W)


def rounds_class(N: int, W: int) -> str:
    """The class ``csrc/cover_rounds.cu`` runs an (N, W) bucket in."""
    if W == 1 and 0 <= N <= REGISTER_MAX_N:
        return "register"
    if 1 <= W <= SHARED_MAX_W and 0 <= N and N * W <= SHARED_MAX_WORDS:
        return "shared"
    return "global"


def cover_rounds_plain(codes: torch.Tensor, rem: torch.Tensor):
    B, N, W = codes.shape
    dev = codes.device
    Rmax = max_rounds(N, W)
    ch = torch.full((B, Rmax), -1, dtype=torch.int32, device=dev)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    rem = rem.clone()
    ar = torch.arange(B, device=dev)
    for r in range(Rmax):
        active = (rem != 0).any(dim=1)
        if not bool(active.any()):
            break
        g = span_gains_plain(codes, rem)
        p = g.argmax(dim=1)                      # first maximum
        gmax = g[ar, p]
        newbad = active & (gmax == 0)
        ok = active & ~newbad
        sel = codes[ar, p]                       # (B, W)
        rem = torch.where(ok[:, None], rem & ~sel, rem)
        rem = torch.where(newbad[:, None], torch.zeros_like(rem), rem)
        ch[:, r] = torch.where(ok, p.to(torch.int32),
                               torch.full_like(ch[:, r], -1))
        bad |= newbad
    return ch, bad


def cover_rounds(codes: torch.Tensor, rem: torch.Tensor):
    """(ch (B, Rmax) int32, bad (B,) bool) for one packed bucket: codes
    (B, N, W) and rem (B, W) are int64 views of the uint64 words."""
    dev = check_same_device(codes, rem)
    if codes.dtype != torch.int64 or rem.dtype != torch.int64:
        raise TypeError("cover_rounds takes int64 views of the uint64 words")
    if codes.dim() != 3 or rem.shape != (codes.shape[0], codes.shape[2]):
        raise ValueError(f"shapes codes {tuple(codes.shape)} / rem "
                         f"{tuple(rem.shape)} are not (B, N, W) / (B, W)")
    if dev.type == "cpu":
        return cover_rounds_plain(codes, rem)
    B, N, W = codes.shape
    Rmax = max_rounds(N, W)
    ch = torch.empty((B, Rmax), dtype=torch.int32, device=dev)
    bad = torch.empty(B, dtype=torch.uint8, device=dev)
    if B == 0:
        return ch, bad.bool()
    index, stream = launch_args(dev)
    err = _build.lib().cover_rounds_launch(
        codes.data_ptr(), rem.data_ptr(), ch.data_ptr(), bad.data_ptr(),
        B, N, W, Rmax, index, stream,
    )
    _build.check(err, "cover_rounds")
    cover_rounds.launches += 1
    return ch, bad.bool()


cover_rounds.launches = 0

"""span_gain: the gain matrix of one greedy set-cover round.

``gain[a, n] = sum_w popcount(codes[a, n, w] & rem[a, w])`` — how many
still-uncovered pins of query a partition n stores.  The uint64 words
travel as int64 tensors (``np.ndarray.view(np.int64)``); the kernel reads
them as unsigned.

* ``span_gains_plain`` — the plain PyTorch version: torch has no popcount,
  so the masked words are viewed as bytes and summed through a 256-entry
  table (signed-int64 bit tricks would overflow).
* ``span_gains`` — the wrapper: plain version for CPU tensors, the CUDA
  kernel (``csrc/span_gain.cu``) for CUDA tensors.  ``span_gains.launches``
  counts kernel launches.
"""

from __future__ import annotations

import torch

from ... import _build
from .. import check_same_device, launch_args

__all__ = ["span_gains", "span_gains_plain", "popcount_table"]

_TABLES: dict = {}


def popcount_table(device: torch.device) -> torch.Tensor:
    """(256,) int32 bit count of every byte value, cached per device."""
    t = _TABLES.get(device)
    if t is None:
        t = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int32, device=device)
        _TABLES[device] = t
    return t


def span_gains_plain(codes: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """codes (A, N, W) int64, rem (A, W) int64 -> (A, N) int32."""
    masked = (codes & rem[:, None, :]).contiguous()
    byte = masked.view(torch.uint8).long()          # (A, N, 8 W)
    return popcount_table(codes.device)[byte].sum(dim=2, dtype=torch.int32)


def _check(codes: torch.Tensor, rem: torch.Tensor) -> torch.device:
    dev = check_same_device(codes, rem)
    if codes.dtype != torch.int64 or rem.dtype != torch.int64:
        raise TypeError("span_gains takes int64 views of the uint64 words")
    if codes.dim() != 3 or rem.shape != (codes.shape[0], codes.shape[2]):
        raise ValueError(f"shapes codes {tuple(codes.shape)} / rem "
                         f"{tuple(rem.shape)} are not (A, N, W) / (A, W)")
    return dev


def span_gains(codes: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """Gain matrix (A, N) int32 for one greedy cover round."""
    dev = _check(codes, rem)
    if dev.type == "cpu":
        return span_gains_plain(codes, rem)
    A, N, W = codes.shape
    out = torch.empty((A, N), dtype=torch.int32, device=dev)
    if A * N == 0:
        return out
    index, stream = launch_args(dev)
    err = _build.lib().span_gain_launch(
        codes.data_ptr(), rem.data_ptr(), out.data_ptr(), A, N, W, index,
        stream,
    )
    _build.check(err, "span_gain")
    span_gains.launches += 1
    return out


span_gains.launches = 0

"""lockstep_peel: the dense Algorithm-5 peel of LMBR, one (src, dest) pair
per row of the batch.

Per pair g, over its (K, U) 0/1 incidence cell: while the alive-edge
benefit exceeds 0.5 and items remain, record the pool weight and benefit
at the round head, peel the lowest-degree item (ties -> lowest slot),
retire the edges that lose a pin and subtract their weights from the
degrees of their other items.  Outputs the free-space-independent
trajectory: ``peel`` (G, U) int32 (-1 after the last round), ``rtot`` and
``rben`` (G, U) f32 (0 after the last round).

Exact only on a 0/1 incidence with integer-valued weights whose totals
stay below 2^24 (every quantity is then an integer f32 holds exactly); the
LMBR dispatcher only sends such batches.

* ``lockstep_peel_plain`` — the plain PyTorch version (elementwise
  products and sums, never a matmul, so no TF32 path exists).
* ``lockstep_peel`` — the wrapper: plain version for CPU tensors, the CUDA
  kernel (``csrc/lockstep_peel.cu``) for CUDA tensors.
  ``lockstep_peel.launches`` counts kernel launches and
  ``lockstep_peel.class_launches`` counts them by (K, U).
* ``uses_shared_memory`` — the kernel's size class of a (K, U) cell: bits
  in shared memory with one warp per pair, or in global scratch with one
  block per pair (the same test as ``lockstep_peel_uses_shared_memory`` in
  the source).
"""

from __future__ import annotations

import torch

from ... import _build
from .. import check_same_device, launch_args

__all__ = ["WARP_MAX_K", "WARP_MAX_U", "lockstep_peel", "lockstep_peel_plain",
           "uses_shared_memory"]


def lockstep_peel_plain(inc, we, nodew, nvalid):
    G, K, U = inc.shape
    dev = inc.device
    iota = torch.arange(U, device=dev)[None, :]
    valid = iota < nvalid[:, None]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    cand = torch.where(valid, (inc * we[:, :, None]).sum(dim=1), inf)
    ealive = torch.ones((G, K), dtype=torch.bool, device=dev)
    ben = we.sum(dim=1)
    totw = nodew.sum(dim=1)
    nal = nvalid.clone()
    peel = torch.full((G, U), -1, dtype=torch.int32, device=dev)
    rtot = torch.zeros((G, U), dtype=torch.float32, device=dev)
    rben = torch.zeros((G, U), dtype=torch.float32, device=dev)
    ar = torch.arange(G, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(U):
        act = (ben > 0.5) & (nal > 0)
        if not bool(act.any()):
            break
        rtot[:, r] = torch.where(act, totw, zero)
        rben[:, r] = torch.where(act, ben, zero)
        j = cand.argmin(dim=1)                   # first minimum
        hit = inc[ar, :, j] > 0.5                # (G, K)
        dying = ealive & hit & act[:, None]
        dw = we * dying
        ben = ben - dw.sum(dim=1)
        onehot = (iota == j[:, None]) & act[:, None]
        cand = torch.where(onehot, inf,
                           cand - (inc * dw[:, :, None]).sum(dim=1))
        totw = totw - torch.where(act, nodew[ar, j], zero)
        nal = nal - act.to(nal.dtype)
        ealive &= ~dying
        peel[:, r] = torch.where(act, j.to(torch.int32),
                                 torch.full_like(peel[:, r], -1))
    return peel, rtot, rben


# the warp class: every lane holds the 8 alive-edge words of K 256 and the
# degrees and column words of 8 slots (U 256)
WARP_MAX_K = 256
WARP_MAX_U = 256


def uses_shared_memory(K: int, U: int) -> bool:
    """Whether the kernel keeps a (K, U) cell's bits in shared memory, one
    warp per pair (else in global scratch, one block per pair)."""
    return 0 <= K <= WARP_MAX_K and 0 <= U <= WARP_MAX_U


def lockstep_peel(inc: torch.Tensor, we: torch.Tensor, nodew: torch.Tensor,
                  nvalid: torch.Tensor):
    """Peel trajectories (peel (G, U) int32, rtot / rben (G, U) f32) of
    inc (G, K, U) f32 holding 0 or 1, we (G, K) f32, nodew (G, U) f32,
    nvalid (G,) int32."""
    dev = check_same_device(inc, we, nodew, nvalid)
    if (inc.dtype, we.dtype, nodew.dtype) != (torch.float32,) * 3:
        raise TypeError("lockstep_peel takes float32 inc / we / nodew")
    if nvalid.dtype != torch.int32:
        raise TypeError("lockstep_peel takes int32 nvalid")
    if inc.dim() != 3:
        raise ValueError(f"inc must be (G, K, U), got {tuple(inc.shape)}")
    G, K, U = inc.shape
    if we.shape != (G, K) or nodew.shape != (G, U) or nvalid.shape != (G,):
        raise ValueError("we / nodew / nvalid do not match inc's (G, K, U)")
    if dev.type == "cpu":
        return lockstep_peel_plain(inc, we, nodew, nvalid)
    peel = torch.empty((G, U), dtype=torch.int32, device=dev)
    rtot = torch.empty((G, U), dtype=torch.float32, device=dev)
    rben = torch.empty((G, U), dtype=torch.float32, device=dev)
    if G == 0 or U == 0:
        return peel, rtot, rben
    scratch = None
    if not uses_shared_memory(K, U):
        words = _build.lib().lockstep_peel_scratch_words(K, U)
        scratch = torch.empty(G * words, dtype=torch.int32, device=dev)
    index, stream = launch_args(dev)
    err = _build.lib().lockstep_peel_launch(
        inc.data_ptr(), we.data_ptr(), nodew.data_ptr(), nvalid.data_ptr(),
        peel.data_ptr(), rtot.data_ptr(), rben.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        G, K, U, index, stream,
    )
    _build.check(err, "lockstep_peel")
    lockstep_peel.launches += 1
    lockstep_peel.class_launches[(K, U)] = (
        lockstep_peel.class_launches.get((K, U), 0) + 1)
    return peel, rtot, rben


lockstep_peel.launches = 0
lockstep_peel.class_launches = {}

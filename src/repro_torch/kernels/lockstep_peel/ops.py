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
  products and sums, never a matmul, so no TF32 path exists).  A round
  touches only the pairs still active and the edges that die in it, so a
  whole batch costs O(G K U) rather than O(G K U) a round.
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
    cols = (inc > 0.5).transpose(1, 2).contiguous()     # (G, U, K)
    iota = torch.arange(U, device=dev)[None, :]
    cand = torch.where(iota < nvalid[:, None], (inc * we[:, :, None]).sum(1),
                       torch.tensor(float("inf"), device=dev))
    ealive = torch.ones((G, K), dtype=torch.bool, device=dev)
    ben = we.sum(dim=1)
    peel = torch.full((G, U), -1, dtype=torch.int64, device=dev)
    rben = torch.zeros((G, U), dtype=torch.float32, device=dev)
    for r in range(U):
        # a pair that stops never restarts, so one active at round r has
        # peeled r items
        act = torch.nonzero((ben > 0.5) & (nvalid > r)).flatten()
        if not len(act):
            break
        rben[:, r] = ben
        j = cand[act].argmin(dim=1)              # first minimum
        peel[act, r] = j
        cand[act, j] = float("inf")
        # only the edges that die this round change a degree
        rows, edges = torch.nonzero(ealive[act] & cols[act, j],
                                    as_tuple=True)
        g = act[rows]
        dw = we[g, edges]
        ben.index_add_(0, g, dw, alpha=-1)
        cand.index_add_(0, g, inc[g, edges] * dw[:, None], alpha=-1)
        ealive[g, edges] = False
    done = peel < 0
    # the pool weight at a round's head: the total less what was peeled
    pw = nodew.gather(1, peel.clamp(min=0)).masked_fill(done, 0)
    rtot = nodew.sum(dim=1)[:, None] - (pw.cumsum(dim=1) - pw)
    return (peel.to(torch.int32), rtot.masked_fill(done, 0),
            rben.masked_fill(done, 0))


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

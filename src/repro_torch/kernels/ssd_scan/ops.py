"""ssd_scan: the Mamba2 SSD chunk scan, from a carried state.

    h_t = exp(a * dt_t) h_{t-1} + dt_t * x_t B_t^T        (h: (P, N) per head)
    y_t = C_t . h_t

computed chunk by chunk as the reference's ``ssd_chunked``
(``models/ssm.py``) does: inside a chunk the decay-gated
``(C B^T o gate o dt) x``, across chunks ``exp(cum) C h`` with the state
carried.  x (B, S, H, P) f32 or bf16; dt (B, S, H), a (H,) (negative),
bmat / cmat (B, S, N) shared by every head, h0 (B, H, P, N), all f32.
Returns y (B, S, H, P) f32 and h_last (B, H, P, N) f32.  S need not be a
multiple of the chunk: the tail is padded with dt = 0, which leaves the
state unchanged.  Unlike the reference TPU kernel, which starts from zero
and drops the final state, this scan takes ``h0`` and returns ``h_last``,
which the serving prefill needs.

* ``ssd_scan_plain`` — the plain PyTorch version (the reference's
  ``ssd_chunked``, einsum for einsum).
* ``ssd_scan`` — the wrapper: plain version for CPU tensors, the CUDA
  kernel (``csrc/ssd_scan.cu``: a state pass, a chain pass and an output
  pass, with a workspace of ``B * H * chunks * (P * N + 1)`` floats
  allocated here, chunks counted at the chunk the passes run) for CUDA
  tensors.  ``ssd_scan.launches`` counts calls that launched the three
  passes, ``ssd_scan.chunk_launches`` the same calls by the chunk the
  passes ran at.
* ``kernel_takes`` — the shapes the CUDA kernel launches (P in {16, 32,
  64}, chunk <= 256, N <= 128); the wrapper refuses the rest for CUDA
  tensors before any launch.
* ``run_chunk`` — the chunk the passes run at.  The output pass stages
  the chunk's B and C whole, so it fits a block's 227 KB of shared memory
  only while pad16(chunk) * pad8(N) <= ``MAX_TILE``; past that (mamba2's
  N 128 at chunk 256) the passes run at the largest multiple of 16 that
  fits (128 at N 128).  Any chunking of the scan computes the same
  function; only the f32 rounding moves, and the card holds the result
  to the plain version at the requested chunk.
"""

from __future__ import annotations

import torch

from ... import _build
from .. import check_same_device, launch_args, refuse_grad

__all__ = ["kernel_takes", "run_chunk", "ssd_scan", "ssd_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 256
MAX_STATE = 128
# pad16(chunk) * pad8(N) of the chunk the passes run: the output pass
# stages that chunk's B and C, which with x and the state must fit a
# block's 227 KB of shared memory (the source's kMaxTile)
MAX_TILE = 16384


def _pad(v: int, m: int) -> int:
    return -(-v // m) * m


def kernel_takes(p: int, n: int, chunk: int) -> bool:
    """Whether the CUDA kernel launches at head dim ``p``, state ``n`` and
    ``chunk``."""
    return p in _HEAD_DIMS and 1 <= chunk <= MAX_CHUNK and 1 <= n <= MAX_STATE


def run_chunk(n: int, chunk: int) -> int:
    """The chunk the passes run at for state ``n`` and a requested
    ``chunk`` inside the domain: ``chunk`` itself while pad16(chunk) *
    pad8(n) <= MAX_TILE, else the largest multiple of 16 under that tile
    (at least 128, since pad8(n) <= 128)."""
    width = _pad(n, 8)
    if _pad(chunk, 16) * width <= MAX_TILE:
        return chunk
    return MAX_TILE // width // 16 * 16


def ssd_scan_plain(x, dt, a, bmat, cmat, *, chunk: int, h0=None):
    b, s, nh, p = x.shape
    n = bmat.shape[-1]
    nchunks = max(1, -(-s // chunk))
    pad = nchunks * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bmat = torch.nn.functional.pad(bmat, (0, 0, 0, pad))
        cmat = torch.nn.functional.pad(cmat, (0, 0, 0, pad))
    L = chunk
    xc = x.reshape(b, nchunks, L, nh, p)
    dtc = dt.reshape(b, nchunks, L, nh)
    bc = bmat.reshape(b, nchunks, L, n)
    cc = cmat.reshape(b, nchunks, L, n)
    h = (torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nchunks):
        xci = xc[:, c].float()
        dtci, bci, cci = dtc[:, c], bc[:, c], cc[:, c]
        adt = a[None, None, :] * dtci                       # (B, L, H)
        cum = torch.cumsum(adt, dim=1)
        decay = cum[:, :, None, :] - cum[:, None, :, :]     # (B, L, L, H)
        gate = torch.where(tril[None, :, :, None], torch.exp(decay),
                           torch.zeros((), device=x.device))
        cb = torch.einsum("bln,bmn->blm", cci, bci)
        att = cb[:, :, :, None] * gate
        y_intra = torch.einsum("blmh,bmh,bmhp->blhp", att, dtci, xci)
        y_inter = torch.einsum("bln,bhpn,blh->blhp", cci, h, torch.exp(cum))
        tail = torch.exp(cum[:, -1:, :] - cum)
        dx = xci * (dtci * tail)[..., None]
        h = (torch.exp(cum[:, -1, :])[:, :, None, None] * h
             + torch.einsum("blhp,bln->bhpn", dx, bci))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nchunks * L, nh, p)[:, :s]
    return y, h


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
             h0: torch.Tensor | None = None):
    """(y, h_last) of the SSD scan over x (B, S, H, P) from state h0
    (zeros when None)."""
    if x.dim() != 4 or bmat.dim() != 3:
        raise ValueError("x must be (B, S, H, P) and bmat (B, S, N)")
    b, s, nh, p = x.shape
    n = bmat.shape[-1]
    if h0 is None:
        h0 = torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device)
    dev = check_same_device(x, dt, a, bmat, cmat, h0)
    if (dt.shape != (b, s, nh) or a.shape != (nh,) or bmat.shape != (b, s, n)
            or cmat.shape != bmat.shape or h0.shape != (b, nh, p, n)):
        raise ValueError("dt (B,S,H), a (H,), bmat/cmat (B,S,N) and h0 "
                         "(B,H,P,N) must match x (B,S,H,P)")
    if x.dtype not in _DTYPES:
        raise TypeError("ssd_scan takes f32 or bf16 x")
    if any(t.dtype != torch.float32 for t in (dt, a, bmat, cmat, h0)):
        raise TypeError("ssd_scan takes f32 dt, a, bmat, cmat and h0")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, a, bmat, cmat, chunk=chunk, h0=h0)
    refuse_grad("ssd_scan", "ROADMAP Queue 1 item 9.7 brings it", x, dt, a,
                bmat, cmat, h0)
    if not kernel_takes(p, n, chunk):
        raise ValueError(
            f"the CUDA kernel takes head_dim in {_HEAD_DIMS}, chunk <= "
            f"{MAX_CHUNK} and state <= {MAX_STATE}, got P={p}, "
            f"chunk={chunk}, N={n}")
    y = torch.empty((b, s, nh, p), dtype=torch.float32, device=dev)
    h_last = torch.empty_like(h0)
    if b * nh == 0:
        return y, h_last
    if x.data_ptr() % 16:
        x = x.clone()   # the passes copy x in 16-byte pieces
    # per (b, head, chunk run): the chunk's state, then exp(cum) at its end
    chunk = run_chunk(n, chunk)
    nchunks = -(-s // chunk)
    ws = torch.empty(b * nh * nchunks * (p * n + 1), dtype=torch.float32,
                     device=dev)
    index, stream = launch_args(dev)
    err = _build.lib().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        cmat.data_ptr(), h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        ws.data_ptr(), b, s, nh, p, n, chunk, _DTYPES[x.dtype], index,
        stream,
    )
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    ssd_scan.chunk_launches[chunk] = ssd_scan.chunk_launches.get(chunk, 0) + 1
    return y, h_last


ssd_scan.launches = 0
ssd_scan.chunk_launches = {}   # chunk the passes ran at -> launches

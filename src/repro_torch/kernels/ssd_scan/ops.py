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

On CUDA tensors the call is a ``torch.autograd.Function`` when grad mode
is on and an input needs a gradient: its forward launches the three
passes and saves the inputs and y; its backward runs ``ssd_scan_bwd``,
with a ``None`` gradient of h_last taken as zeros.  Otherwise (serving)
the passes launch as they are.  On CPU tensors autograd differentiates
the plain version as it is.

The backward: given the forward's inputs, the gradient dy (B, S, H, P) of
y and dh_last (B, H, P, N) of h_last (zeros when None), it returns dx in
x's dtype and ddt (B, S, H), da (H,), dbmat / dcmat (B, S, N) and dh0
(B, H, P, N) in f32.  Per chunk, with ``cum`` the in-chunk cumsum of
a dt, ``h_c`` the state entering chunk c and ``g_{c+1}`` the gradient of
the state leaving it (``g_C = dh_last``):

    g_c   = exp(cum_L) g_{c+1} + sum_t exp(cum_t) dy_t C_t^T,  dh0 = g_0
    dxh_u = sum_{t>=u} (C_t.B_u) e^{cum_t-cum_u} dy_t + e^{cum_L-cum_u} g_{c+1} B_u
    dx_u  = dt_u dxh_u
    dC_t  = sum_{u<=t} e^{cum_t-cum_u} dt_u (dy_t.x_u) B_u + e^{cum_t} h_c^T dy_t
    dB_u  = dt_u [sum_{t>=u} e^{cum_t-cum_u} (dy_t.x_u) C_t + e^{cum_L-cum_u} g_{c+1}^T x_u]
    dcum_t = dy_t.y_t - x_t.dx_t (+ <g_{c+1}, h_{c+1}> at the chunk's last step)
    ddt_u = x_u.dxh_u + a r_u,  da = sum dt_u r_u,  r = reverse cumsum of dcum

B and C are shared by every head, so dB and dC also sum over heads.
``dcum`` collects every place cum enters: y's terms give dy.y, the
terms that leave step u give x_u.dx_u, and the state leaving the chunk
gives <g, h> at its last step.  The padded tail (dt = 0) gets zero
gradient and is cut off.

* ``ssd_scan_bwd_plain`` — that closed form in PyTorch ops, one chunk at a
  time (not autograd through ``ssd_scan_plain``).
* ``ssd_scan_bwd`` — the wrapper: plain version for CPU tensors (y, when
  given, is checked and not needed), the CUDA kernels
  (``csrc/ssd_scan_bwd.cu``, run at their own chunk ``BWD_CHUNK``: a state
  pass per (direction, head) that walks the chunks, the chunk states and
  both chains; a gradient pass per (chunk, batch row) that walks the
  heads and writes dB and dC summed over them; a reduction of da; every
  product on the tensor cores) for CUDA tensors, which read the forward's
  y and raise without it; their workspace (the h and g slots and the
  shares of da, B * H * chunks * (2 P N + 1) floats, 0.67 GB at
  mamba2-2.7b's B 8 x S 1024) comes from ``torch.empty``.
  ``ssd_scan.backward_launches`` counts its calls (three kernel launches
  each).
"""

from __future__ import annotations

import torch

from ... import _build
from .. import check_same_device, launch_args

__all__ = ["BWD_CHUNK", "kernel_takes", "run_chunk", "ssd_scan",
           "ssd_scan_bwd", "ssd_scan_bwd_plain", "ssd_scan_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 256
MAX_STATE = 128
# pad16(chunk) * pad8(N) of the chunk the passes run: the output pass
# stages that chunk's B and C, which with x and the state must fit a
# block's 227 KB of shared memory (the source's kMaxTile)
MAX_TILE = 16384
# the chunk the backward's passes run at (the source's kBwdChunk): its
# gradient pass holds a chunk's B and B C^T and two heads' x, dy and
# g_{c+1} and one head's h_c in shared memory, 229 536 bytes at P 64 and
# N 128 for f32 x
BWD_CHUNK = 64


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


def _check(x, dt, a, bmat, cmat, h0, chunk: int) -> torch.device:
    """Shapes, dtypes and devices of ``ssd_scan``'s inputs (h0 given)."""
    if x.dim() != 4 or bmat.dim() != 3:
        raise ValueError("x must be (B, S, H, P) and bmat (B, S, N)")
    b, s, nh, p = x.shape
    n = bmat.shape[-1]
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
    if dev.type == "cuda" and not kernel_takes(p, n, chunk):
        raise ValueError(
            f"the CUDA kernel takes head_dim in {_HEAD_DIMS}, chunk <= "
            f"{MAX_CHUNK} and state <= {MAX_STATE}, got P={p}, "
            f"chunk={chunk}, N={n}")
    return dev


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
             h0: torch.Tensor | None = None):
    """(y, h_last) of the SSD scan over x (B, S, H, P) from state h0
    (zeros when None)."""
    if h0 is None and x.dim() == 4 and bmat.dim() == 3:
        b, _, nh, p = x.shape
        h0 = torch.zeros((b, nh, p, bmat.shape[-1]), dtype=torch.float32,
                         device=x.device)
    if _check(x, dt, a, bmat, cmat, h0, chunk).type == "cpu":
        return ssd_scan_plain(x, dt, a, bmat, cmat, chunk=chunk, h0=h0)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, bmat, cmat, h0)):
        return _SSDScan.apply(x, dt, a, bmat, cmat, h0, chunk)
    return _launch(x, dt, a, bmat, cmat, h0, chunk)


def _launch(x, dt, a, bmat, cmat, h0, chunk: int):
    """The three passes on CUDA tensors that ``_check`` has checked."""
    b, s, nh, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
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


class _SSDScan(torch.autograd.Function):
    """The CUDA route of ``ssd_scan`` under autograd: the three passes, and
    ``ssd_scan_bwd`` for the gradient."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, h0, chunk):
        y, h_last = _launch(x, dt, a, bmat, cmat, h0, chunk)
        ctx.save_for_backward(x, dt, a, bmat, cmat, h0, y)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, a, bmat, cmat, h0, y = ctx.saved_tensors
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        grads = ssd_scan_bwd(
            x, dt, a, bmat, cmat, dy, chunk=ctx.chunk, h0=h0, y=y,
            dh_last=None if dh_last is None else dh_last.contiguous())
        return (*grads, None)


ssd_scan.launches = 0
ssd_scan.chunk_launches = {}   # chunk the passes ran at -> launches
ssd_scan.backward_launches = 0


# --------------------------------------------------------------- backward
def ssd_scan_bwd_plain(x, dt, a, bmat, cmat, dy, *, chunk: int, h0=None,
                       dh_last=None):
    b, s, nh, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    nchunks = max(1, -(-s // chunk))
    pad = nchunks * chunk - s
    xf, dyf = x.float(), dy.float()
    if pad:
        xf, dyf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (xf, dyf))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bmat = torch.nn.functional.pad(bmat, (0, 0, 0, pad))
        cmat = torch.nn.functional.pad(cmat, (0, 0, 0, pad))
    L = chunk
    xc = xf.reshape(b, nchunks, L, nh, p)
    dyc = dyf.reshape(b, nchunks, L, nh, p)
    dtc = dt.reshape(b, nchunks, L, nh)
    bc = bmat.reshape(b, nchunks, L, n)
    cc = cmat.reshape(b, nchunks, L, n)
    tril = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    zero = torch.zeros((), device=dev)
    # the forward sweep: cum and the state entering each chunk, h_last last
    h = (torch.zeros((b, nh, p, n), dtype=torch.float32, device=dev)
         if h0 is None else h0)
    cums, states = [], [h]
    for c in range(nchunks):
        cum = torch.cumsum(a[None, None, :] * dtc[:, c], dim=1)   # (B, L, H)
        tail = torch.exp(cum[:, -1:, :] - cum)
        h = (torch.exp(cum[:, -1, :])[:, :, None, None] * h
             + torch.einsum("blhp,bln->bhpn",
                            xc[:, c] * (dtc[:, c] * tail)[..., None],
                            bc[:, c]))
        cums.append(cum)
        states.append(h)
    g = (torch.zeros((b, nh, p, n), dtype=torch.float32, device=dev)
         if dh_last is None else dh_last)
    dxs, ddts, dbs, dcs = [], [], [], []
    da = torch.zeros((nh,), dtype=torch.float32, device=dev)
    for c in reversed(range(nchunks)):
        xi, dyi, dti, bi, ci = xc[:, c], dyc[:, c], dtc[:, c], bc[:, c], cc[:, c]
        cum, hc, hn = cums[c], states[c], states[c + 1]
        # gate[t, u] = exp(cum_t - cum_u) for u <= t           (B, L, L, H)
        gate = torch.where(tril[None, :, :, None],
                           torch.exp(cum[:, :, None, :] - cum[:, None, :, :]),
                           zero)
        att = torch.einsum("btn,bun->btu", ci, bi)[..., None] * gate
        mg = torch.einsum("bthp,buhp->btuh", dyi, xi) * gate
        tail = torch.exp(cum[:, -1:, :] - cum)                  # (B, L, H)
        ecum = torch.exp(cum)
        dxh = (torch.einsum("btuh,bthp->buhp", att, dyi)
               + tail[..., None] * torch.einsum("bhpn,bun->buhp", g, bi))
        dx = dxh * dti[..., None]
        dcs.append(torch.einsum("btuh,buh,bun->btn", mg, dti, bi)
                   + torch.einsum("bth,bthp,bhpn->btn", ecum, dyi, hc))
        dbs.append(torch.einsum("buh,btuh,btn->bun", dti, mg, ci)
                   + torch.einsum("buh,buhp,bhpn->bun", tail * dti, xi, g))
        y = (torch.einsum("btuh,buh,buhp->bthp", att, dti, xi)
             + torch.einsum("btn,bhpn,bth->bthp", ci, hc, ecum))
        dcum = (dyi * y).sum(-1) - (xi * dx).sum(-1)            # (B, L, H)
        dcum[:, -1] += (g * hn).sum((-2, -1))
        r = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,))
        dxs.append(dx)
        ddts.append((xi * dxh).sum(-1) + a * r)
        da = da + (dti * r).sum((0, 1))
        g = (torch.exp(cum[:, -1, :])[:, :, None, None] * g
             + torch.einsum("bth,bthp,btn->bhpn", ecum, dyi, ci))

    def join(parts, *tail_shape):
        return torch.stack(parts[::-1], dim=1).reshape(
            b, nchunks * L, *tail_shape)[:, :s]

    return (join(dxs, nh, p).to(x.dtype), join(ddts, nh), da,
            join(dbs, n), join(dcs, n), g)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int, h0: torch.Tensor | None = None,
                 dh_last: torch.Tensor | None = None,
                 y: torch.Tensor | None = None):
    """(dx, ddt, da, dbmat, dcmat, dh0) of ``ssd_scan(x, dt, a, bmat, cmat,
    chunk=chunk, h0=h0) = (y, h_last)`` at the gradients dy (B, S, H, P)
    and dh_last (B, H, P, N; zeros when None), f32 and contiguous.  ``y``
    is the forward's output; the CUDA kernels need it."""
    if x.dim() != 4 or bmat.dim() != 3:
        raise ValueError("x must be (B, S, H, P) and bmat (B, S, N)")
    b, s, nh, p = x.shape
    n = bmat.shape[-1]
    if h0 is None:
        h0 = torch.zeros((b, nh, p, n), dtype=torch.float32, device=x.device)
    extra = tuple(t for t in (dh_last, y) if t is not None)
    dev = _check(x, dt, a, bmat, cmat, h0, chunk)
    check_same_device(x, dy, *extra)
    if dy.shape != (b, s, nh, p) or (y is not None and y.shape != dy.shape) \
            or (dh_last is not None and dh_last.shape != h0.shape):
        raise ValueError("dy and y must be (B, S, H, P) and dh_last "
                         "(B, H, P, N), as the forward's y and h_last")
    if any(t.dtype != torch.float32 for t in (dy, *extra)):
        raise TypeError("ssd_scan_bwd takes f32 dy, dh_last and y")
    if dev.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, a, bmat, cmat, dy, chunk=chunk,
                                  h0=h0, dh_last=dh_last)
    if y is None:
        raise ValueError("ssd_scan_bwd on CUDA tensors reads the forward's "
                         "y; it does not recompute it")
    # the passes copy x, dy, y, bmat and cmat in 16-byte pieces
    x, dy, y, bmat, cmat = (t if t.data_ptr() % 16 == 0 else t.clone()
                            for t in (x, dy, y, bmat, cmat))
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    da = torch.empty_like(a)
    dbm, dcm = torch.empty_like(bmat), torch.empty_like(cmat)
    dh0 = torch.empty_like(h0)
    if b * nh == 0:
        return dx, ddt, da.zero_(), dbm.zero_(), dcm.zero_(), dh0
    lib = _build.lib()
    ws = torch.empty(lib.ssd_scan_bwd_workspace(b, s, nh, p, n),
                     dtype=torch.float32, device=dev)
    index, stream = launch_args(dev)
    err = lib.ssd_scan_bwd_launch(
        x.data_ptr(), dy.data_ptr(), y.data_ptr(), dt.data_ptr(),
        a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), h0.data_ptr(),
        None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
        dh0.data_ptr(), ws.data_ptr(), b, s, nh, p, n, _DTYPES[x.dtype],
        index, stream)
    _build.check(err, "ssd_scan_bwd")
    ssd_scan.backward_launches += 1
    return dx, ddt, da, dbm, dcm, dh0

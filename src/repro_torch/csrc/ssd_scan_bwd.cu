// ssd_scan_bwd: the gradient of the Mamba2 SSD chunk scan (ssd_scan.cu).
//
// The reference trains the SSM families by differentiating `ssd_chunked`
// (src/repro/models/ssm.py) through lax.scan; its Pallas kernel
// (src/repro/kernels/ssd_scan/kernel.py) has no backward.  Given the
// forward's inputs x (B, S, H, P) f32 or bf16, dt (B, S, H), a (H,), B / C
// (B, S, N) shared by every head and h0 (B, H, P, N), its output y, and
// the gradients dy of y and dh_last of h_last (null: zeros), it writes dx
// in x's dtype and ddt, da, dB, dC and dh0 in f32.  Per (b, head) and
// chunk c of L steps, cum the in-chunk cumsum of a dt, h_c the state
// entering the chunk and g_{c+1} the gradient of the state leaving it:
//
//   g_c    = exp(cum[L-1]) g_{c+1} + sum_t exp(cum[t]) dy[t] C[t]^T
//   dxh[u] = sum_{t>=u} (C[t].B[u]) e^{cum[t]-cum[u]} dy[t]
//          + e^{cum[L-1]-cum[u]} g_{c+1} B[u],           dx[u] = dt[u] dxh[u]
//   dC[t]  = sum_{u<=t} e^{cum[t]-cum[u]} dt[u] (dy[t].x[u]) B[u]
//          + e^{cum[t]} h_c^T dy[t]
//   dB[u]  = dt[u] (sum_{t>=u} e^{cum[t]-cum[u]} (dy[t].x[u]) C[t]
//          + e^{cum[L-1]-cum[u]} g_{c+1}^T x[u])
//   dcum[t] = dy[t].y[t] - x[t].dx[t] (+ <g_{c+1}, h_{c+1}> at t = L-1)
//   ddt[u] = x[u].dxh[u] + a r[u],  da = sum dt[u] r[u],
//   r[u]   = sum_{t>=u} dcum[t]
//
// with dh0 = g_0 and g_C = dh_last; dB and dC are summed over the heads.
// (dcum gathers every place cum enters: y's own terms give dy.y, the terms
// that leave step u give x[u].dx[u], the state leaving the chunk <g, h>.)
//
// Four launches, run at their own chunk kBwdChunk (any chunking computes
// the same function; the workspace is the wrapper's `torch.empty`):
//
//   1. state pass, one block per (chunk, head, batch): cum by a block scan,
//      then the chunk's own state x^T (w B) and its reverse counterpart
//      dy^T (exp(cum) C), both (P x N), and exp(cum[L-1]).
//   2. chain pass, one thread per state element: h_c over the chunks from
//      h0 (each slot in place becomes the state entering its chunk, one
//      more slot h_last), then g over the chunks from dh_last (each slot
//      becomes g_{c+1}), and dh0; the loads of eight chunks in flight
//      together, as the forward's chain.
//   3. gradient pass, one block per (chunk, head, batch): x, dy, B, C,
//      g_{c+1} and h_c staged in shared memory as f32; C B^T and dy x^T
//      gated into two L x L tiles; then dxh, this head's dC and dB, the
//      row dots for dcum, its reverse scan, ddt and the chunk's share of
//      da.  dC and dB go to per-head slots.
//   4. reduction, one thread per (b, s, n): dB and dC summed over the
//      heads in order, and da over batch and chunks: deterministic.
//
// Every product runs in fp32 on the CUDA cores (`block_mm`: 4 x 4 register
// tiles, rows 4 tm + i and columns tn + W j, W = ceil(cols / 4), so that a
// warp's lanes read consecutive columns and share rows; rows in shared
// memory are padded to an odd stride, so that a column read across rows
// is free of bank conflicts).  Products over the chunk's steps skip the
// zero half of the gated tiles.  What bounds it on an H100 (data-sheet
// peaks) at mamba2-2.7b's training shape (B 8, S 1024, H 80, P 64, N 128):
// ~3.7 M multiply-adds a chunk of one head, 76 GFLOP a call, 1.1 ms at the
// fp32 peak, against ~0.5 GB of inputs and outputs (0.16 ms).
//
// The domain: P in {16, 32, 64}, 1 <= N <= 128 (kernels/ssd_scan/ops.py
// `kernel_takes`); the gradient pass holds 200 256 bytes of shared memory
// at P 64 and N 128 (one block an SM), the state pass 99 904.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBwdChunk = 64;  // the chunk every pass runs at
constexpr int kMaxState = 128;

__host__ __device__ constexpr int odd(int v) { return v | 1; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Inclusive scan of one value per thread over the block.
__device__ float block_scan(float v, float* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  __syncthreads();  // wsum may be reused
  return v;
}

// Sum of one value per thread over the block, in a fixed order; every
// thread gets it.
__device__ float block_sum(float v, float* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += wsum[w];
  __syncthreads();
  return t;
}

// Two products of one M x Nn output shape, M a multiple of 4, over the
// block: p1 = sum_{k in krange(m0)} a1(m, k) b1(k, n) and p2 = sum_{k <
// K2} a2(m, k) b2(k, n), then out(m, n, p1, p2) for n < Nn.  Thread tile
// (tm, tn) holds rows 4 tm .. 4 tm + 3 and columns tn, tn + W, tn + 2 W,
// tn + 3 W.  Returns the row base of the thread's last tile (-1 if none).
template <class KR, class A1, class B1, class A2, class B2, class OUT>
__device__ __forceinline__ int block_mm(int M, int Nn, KR krange, A1 a1,
                                        B1 b1, int K2, A2 a2, B2 b2,
                                        OUT out) {
  const int W = (Nn + 3) >> 2;
  const int tiles = (M >> 2) * W;
  int last = -1;
  for (int tile = threadIdx.x; tile < tiles; tile += kThreads) {
    const int tm = tile / W;
    const int tn = tile - tm * W;
    const int m0 = tm * 4;
    int col[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = tn + W * j < Nn;
      col[j] = ok[j] ? tn + W * j : 0;
    }
    float p1[4][4], p2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p1[i][j] = p2[i][j] = 0.f;
    int k0, k1;
    krange(m0, k0, k1);
    for (int k = k0; k < k1; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a1(m0 + i, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b1(k, col[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p1[i][j] = fmaf(av[i], bv[j], p1[i][j]);
    }
    for (int k = 0; k < K2; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a2(m0 + i, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b2(k, col[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p2[i][j] = fmaf(av[i], bv[j], p2[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j]) out(m0 + i, col[j], p1[i][j], p2[i][j]);
    last = m0;
  }
  return last;
}

// rows u < Lc of a (rows, cols) array (row stride `ld` elements) into
// dst[u][sd] as f32, zeros up to L rows
template <typename T>
__device__ __forceinline__ void stage(float* dst, int sd, const T* src,
                                      long long ld, int Lc, int L,
                                      int cols) {
  for (int e = threadIdx.x; e < L * cols; e += kThreads) {
    const int u = e / cols;
    const int k = e - u * cols;
    dst[u * sd + k] = u < Lc ? to_f32(src[u * ld + k]) : 0.f;
  }
}

// Shared memory of the passes, in bytes, at chunk L
int state_smem(int L, int P, int N) {
  return (2 * L * odd(P + 1) + 2 * L * odd(N) + 2 * L + 16) *
         (int)sizeof(float);
}

int grad_smem(int L, int P, int N) {
  const int SP = odd(P + 1), SN = odd(N), SL = odd(L + 1);
  return (2 * L * SP + 2 * L * SN + 2 * P * SN + 2 * L * SL + 6 * L + 16) *
         (int)sizeof(float);
}

// ---------------------------------------------------------------- pass 1
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_state_kernel(const T* __restrict__ x,
                         const float* __restrict__ dy,
                         const float* __restrict__ dt,
                         const float* __restrict__ a,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         float* __restrict__ hs, float* __restrict__ gs,
                         float* __restrict__ decay, int S, int H, int N) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L = kBwdChunk;
  constexpr int SP = odd(P + 1);
  const int SN = odd(N);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int c0 = c * L;
  const int Lc = min(L, S - c0);

  float* xs = smem;             // L * SP: x[u][p]
  float* dys = xs + L * SP;     // L * SP: dy[t][p]
  float* bs = dys + L * SP;     // L * SN: w[u] B[u][n]
  float* cs = bs + L * SN;      // L * SN: exp(cum[t]) C[t][n]
  float* wu = cs + L * SN;      // L: exp(cum[L-1] - cum[u]) dt[u]
  float* et = wu + L;           // L: exp(cum[t])
  float* wsum = et + L;         // 16

  const long long row0 = (long long)b * S + c0;
  stage(xs, SP, x + row0 * H * P + (long long)h * P, (long long)H * P, Lc,
        L, P);
  stage(dys, SP, dy + row0 * H * P + (long long)h * P, (long long)H * P, Lc,
        L, P);
  stage(bs, SN, bm + row0 * N, N, Lc, L, N);
  stage(cs, SN, cm + row0 * N, N, Lc, L, N);
  const float d = tid < Lc ? dt[(row0 + tid) * H + h] : 0.f;
  const float cu = block_scan(a[h] * d, wsum);
  if (tid == Lc - 1) wsum[8] = cu;
  __syncthreads();
  const float clast = wsum[8];
  if (tid < L) {
    wu[tid] = tid < Lc ? expf(clast - cu) * d : 0.f;
    et[tid] = tid < Lc ? expf(cu) : 0.f;
  }
  if (tid == 0) decay[((long long)b * H + h) * nc + c] = expf(clast);
  __syncthreads();
  for (int e = tid; e < L * N; e += kThreads) {
    const int u = e / N;
    const int n = e - u * N;
    bs[u * SN + n] *= wu[u];
    cs[u * SN + n] *= et[u];
  }
  __syncthreads();

  // s[p][n] = sum_u x[u][p] (w B)[u][n], s'[p][n] = sum_t dy[t][p] (e C)[t][n]
  const long long PN = (long long)P * N;
  float* hout = hs + (((long long)b * H + h) * (nc + 1) + c) * PN;
  float* gout = gs + (((long long)b * H + h) * nc + c) * PN;
  block_mm(
      P, N, [&](int, int& k0, int& k1) { k0 = 0, k1 = Lc; },
      [&](int p, int u) { return xs[u * SP + p]; },
      [&](int u, int n) { return bs[u * SN + n]; }, Lc,
      [&](int p, int t) { return dys[t * SP + p]; },
      [&](int t, int n) { return cs[t * SN + n]; },
      [&](int p, int n, float s1, float s2) {
        hout[p * N + n] = s1;
        gout[p * N + n] = s2;
      });
}

// ---------------------------------------------------------------- pass 2
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chain_kernel(const float* __restrict__ h0,
                         const float* __restrict__ dh_last,
                         float* __restrict__ hs, float* __restrict__ gs,
                         const float* __restrict__ decay,
                         float* __restrict__ dh0, long long total, int PN,
                         int nc) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / PN;
  const int pn = (int)(e - bh * PN);
  float* hp = hs + bh * (nc + 1) * PN + pn;
  float* gp = gs + bh * nc * PN + pn;
  const float* dp = decay + bh * nc;
  constexpr int kAhead = 8;  // chunks whose loads are in flight together
  float hv = h0[e];
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float sv[kAhead], dv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const bool in = c0 + i < nc;
      sv[i] = in ? hp[(long long)(c0 + i) * PN] : 0.f;
      dv[i] = in ? dp[c0 + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        hp[(long long)(c0 + i) * PN] = hv;  // the state entering the chunk
        hv = fmaf(dv[i], hv, sv[i]);
      }
    }
  }
  hp[(long long)nc * PN] = hv;  // h_last
  float gv = dh_last ? dh_last[e] : 0.f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kAhead) {
    float sv[kAhead], dv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const bool in = c1 - i >= 0;
      sv[i] = in ? gp[(long long)(c1 - i) * PN] : 0.f;
      dv[i] = in ? dp[c1 - i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c1 - i >= 0) {
        gp[(long long)(c1 - i) * PN] = gv;  // the gradient leaving it
        gv = fmaf(dv[i], gv, sv[i]);
      }
    }
  }
  dh0[e] = gv;
}

// ---------------------------------------------------------------- pass 3
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_grad_kernel(const T* __restrict__ x,
                        const float* __restrict__ dy,
                        const float* __restrict__ y,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm,
                        const float* __restrict__ hs,
                        const float* __restrict__ gs, T* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ dbp,
                        float* __restrict__ dcp, float* __restrict__ dap,
                        int S, int H, int N) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L = kBwdChunk;
  constexpr int SP = odd(P + 1);
  constexpr int SL = odd(L + 1);
  constexpr int W = P / 4;  // column tiles of an L x P product
  const int SN = odd(N);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c0 = c * L;
  const int Lc = min(L, S - c0);

  float* xs = smem;             // L * SP: x[u][p]
  float* dys = xs + L * SP;     // L * SP: dy[t][p]
  float* bs = dys + L * SP;     // L * SN: B[u][n]
  float* cs = bs + L * SN;      // L * SN: C[t][n]
  float* gsm = cs + L * SN;     // P * SN: g_{c+1}[p][n]
  float* hsm = gsm + P * SN;    // P * SN: h_c[p][n]
  float* att = hsm + P * SN;    // L * SL: (C B^T)[t][u] e^{cum[t]-cum[u]}
  float* mg = att + L * SL;     // L * SL: (dy x^T)[t][u] e^{cum[t]-cum[u]}
  float* cum = mg + L * SL;     // L
  float* dts = cum + L;         // L
  float* tl = dts + L;          // L: exp(cum[L-1] - cum[u])
  float* ex = tl + L;           // L: exp(cum[t])
  float* ydot = ex + L;         // L: dy[t].y[t]
  float* rdot = ydot + L;       // L: x[u].dxh[u]
  float* wsum = rdot + L;       // 16

  const long long row0 = (long long)b * S + c0;
  const long long bh = (long long)b * H + h;
  const long long PN = (long long)P * N;
  const float* hc = hs + (bh * (nc + 1) + c) * PN;
  stage(xs, SP, x + row0 * H * P + (long long)h * P, (long long)H * P, Lc,
        L, P);
  stage(dys, SP, dy + row0 * H * P + (long long)h * P, (long long)H * P, Lc,
        L, P);
  stage(bs, SN, bm + row0 * N, N, Lc, L, N);
  stage(cs, SN, cm + row0 * N, N, Lc, L, N);
  stage(gsm, SN, gs + (bh * nc + c) * PN, N, P, P, N);
  stage(hsm, SN, hc, N, P, P, N);
  const float d = tid < Lc ? dt[(row0 + tid) * H + h] : 0.f;
  const float ah = a[h];
  const float cu = block_scan(ah * d, wsum);
  if (tid == Lc - 1) wsum[8] = cu;
  __syncthreads();
  const float clast = wsum[8];
  if (tid < L) {
    cum[tid] = cu;
    dts[tid] = d;
    tl[tid] = tid < Lc ? expf(clast - cu) : 0.f;
    ex[tid] = tid < Lc ? expf(cu) : 0.f;
  }
  __syncthreads();

  // <g_{c+1}, h_{c+1}>, and dy[t].y[t] (a warp a row)
  const float* hn = hc + PN;
  float part = 0.f;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    part = fmaf(gsm[p * SN + e - p * N], hn[e], part);
  }
  const float ghn = block_sum(part, wsum);
  for (int t = tid >> 5; t < L; t += kWarps) {
    float v = 0.f;
    if (t < Lc) {
      const float* yr = y + ((row0 + t) * H + h) * P;
      for (int p = lane; p < P; p += 32) v = fmaf(dys[t * SP + p], yr[p], v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) ydot[t] = v;
  }

  // the gated tiles: att = C B^T and mg = dy x^T, times e^{cum[t]-cum[u]}
  // for u <= t < Lc, else 0
  block_mm(
      L, L, [&](int, int& k0, int& k1) { k0 = 0, k1 = N; },
      [&](int t, int n) { return cs[t * SN + n]; },
      [&](int n, int u) { return bs[u * SN + n]; }, P,
      [&](int t, int p) { return dys[t * SP + p]; },
      [&](int p, int u) { return xs[u * SP + p]; },
      [&](int t, int u, float cb, float m) {
        const float gate =
            (u <= t && t < Lc) ? expf(cum[t] - cum[u]) : 0.f;
        att[t * SL + u] = cb * gate;
        mg[t * SL + u] = m * gate;
      });
  __syncthreads();

  // dxh[u][p] = sum_{t>=u} att[t][u] dy[t][p] + tl[u] sum_n B[u][n] g[p][n];
  // dx = dt dxh, and the row dots x[u].dxh[u] over each tile row's W lanes
  float rp[4] = {0.f, 0.f, 0.f, 0.f};
  const int r0 = block_mm(
      L, P, [&](int m0, int& k0, int& k1) { k0 = m0, k1 = Lc; },
      [&](int u, int t) { return att[t * SL + u]; },
      [&](int t, int p) { return dys[t * SP + p]; }, N,
      [&](int u, int n) { return bs[u * SN + n]; },
      [&](int n, int p) { return gsm[p * SN + n]; },
      [&](int u, int p, float s1, float s2) {
        const float v = s1 + tl[u] * s2;
        rp[u & 3] = fmaf(xs[u * SP + p], v, rp[u & 3]);
        if (u < Lc) store(dx + ((row0 + u) * H + h) * P + p, dts[u] * v);
      });
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1)
      rp[i] += __shfl_xor_sync(0xffffffffu, rp[i], off);
    if (r0 >= 0 && tid % W == 0) rdot[r0 + i] = rp[i];
  }

  // this head's dC[t][n] = sum_{u<=t} mg[t][u] dt[u] B[u][n]
  //                      + ex[t] sum_p dy[t][p] h_c[p][n]
  float* dcr = dcp + (bh * S + c0) * N;
  block_mm(
      L, N, [&](int m0, int& k0, int& k1) { k0 = 0, k1 = min(m0 + 4, Lc); },
      [&](int t, int u) { return mg[t * SL + u] * dts[u]; },
      [&](int u, int n) { return bs[u * SN + n]; }, P,
      [&](int t, int p) { return dys[t * SP + p]; },
      [&](int p, int n) { return hsm[p * SN + n]; },
      [&](int t, int n, float s1, float s2) {
        if (t < Lc) dcr[t * N + n] = s1 + ex[t] * s2;
      });
  // ... and dB[u][n] = dt[u] (sum_{t>=u} mg[t][u] C[t][n]
  //                  + tl[u] sum_p x[u][p] g[p][n])
  float* dbr = dbp + (bh * S + c0) * N;
  block_mm(
      L, N, [&](int m0, int& k0, int& k1) { k0 = m0, k1 = Lc; },
      [&](int u, int t) { return mg[t * SL + u]; },
      [&](int t, int n) { return cs[t * SN + n]; }, P,
      [&](int u, int p) { return xs[u * SP + p]; },
      [&](int p, int n) { return gsm[p * SN + n]; },
      [&](int u, int n, float s1, float s2) {
        if (u < Lc) dbr[u * N + n] = dts[u] * (s1 + tl[u] * s2);
      });
  __syncthreads();

  // dcum, its reverse cumsum r over the chunk, ddt and the share of da
  const int u = Lc - 1 - tid;  // thread i takes step Lc - 1 - i
  float dc = 0.f;
  if (u >= 0)
    dc = ydot[u] - dts[u] * rdot[u] + (u == Lc - 1 ? ghn : 0.f);
  const float r = block_scan(dc, wsum);
  if (u >= 0) ddt[(row0 + u) * H + h] = rdot[u] + ah * r;
  const float da_part = block_sum(u >= 0 ? dts[u] * r : 0.f, wsum);
  if (tid == 0) dap[bh * nc + c] = da_part;
}

// ---------------------------------------------------------------- pass 4
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_kernel(const float* __restrict__ dbp,
                          const float* __restrict__ dcp,
                          const float* __restrict__ dap,
                          float* __restrict__ db, float* __restrict__ dc,
                          float* __restrict__ da, int B, int S, int H,
                          int N, int nc) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long SN = (long long)S * N;
  if (e < (long long)B * SN) {
    const long long b = e / SN;
    const long long rest = e - b * SN;
    const float* pb = dbp + b * H * SN + rest;
    const float* pc = dcp + b * H * SN + rest;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[h * SN];
      sc += pc[h * SN];
    }
    db[e] = sb;
    dc[e] = sc;
  }
  if (e < H) {
    float s = 0.f;
    for (int b = 0; b < B; ++b)
      for (int c = 0; c < nc; ++c) s += dap[((long long)b * H + e) * nc + c];
    da[e] = s;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the workspace: h slots (B, H, nc + 1, P, N), g slots (B, H, nc, P, N),
// decay and da shares (B, H, nc) each, per-head dB and dC (B, H, S, N)
long long workspace_floats(long long B, long long S, long long H,
                           long long P, long long N) {
  const long long nc = (S + kBwdChunk - 1) / kBwdChunk;
  return B * H * ((2 * nc + 1) * P * N + 2 * nc + 2 * S * N);
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dy, const void* y,
                   const void* dt, const void* a, const void* bm,
                   const void* cm, const void* h0, const void* dh_last,
                   void* dx, void* ddt, void* da, void* db, void* dc,
                   void* dh0, void* ws, int B, int S, int H, int N,
                   cudaStream_t stream) {
  const int L = kBwdChunk;
  const int nc = (S + L - 1) / L;
  const long long PN = (long long)P * N;
  float* hs = (float*)ws;
  float* gs = hs + (long long)B * H * (nc + 1) * PN;
  float* decay = gs + (long long)B * H * nc * PN;
  float* dap = decay + (long long)B * H * nc;
  float* dbp = dap + (long long)B * H * nc;
  float* dcp = dbp + (long long)B * H * S * N;
  const dim3 grid(nc, H, B);

  const int smem1 = state_smem(L, P, N);
  cudaError_t err = allow_smem(ssd_bwd_state_kernel<T, P>, smem1);
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<T, P><<<grid, kThreads, smem1, stream>>>(
      (const T*)x, (const float*)dy, (const float*)dt, (const float*)a,
      (const float*)bm, (const float*)cm, hs, gs, decay, S, H, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long total = (long long)B * H * PN;
  ssd_bwd_chain_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      (const float*)h0, (const float*)dh_last, hs, gs, decay, (float*)dh0,
      total, (int)PN, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int smem3 = grad_smem(L, P, N);
  err = allow_smem(ssd_bwd_grad_kernel<T, P>, smem3);
  if (err != cudaSuccess) return err;
  ssd_bwd_grad_kernel<T, P><<<grid, kThreads, smem3, stream>>>(
      (const T*)x, (const float*)dy, (const float*)y, (const float*)dt,
      (const float*)a, (const float*)bm, (const float*)cm, hs, gs, (T*)dx,
      (float*)ddt, dbp, dcp, dap, S, H, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long outs = (long long)B * S * N > H ? (long long)B * S * N : H;
  ssd_bwd_reduce_kernel<<<(unsigned)((outs + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      dbp, dcp, dap, (float*)db, (float*)dc, (float*)da, B, S, H, N, nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(int P, const void* x, const void* dy, const void* y,
                     const void* dt, const void* a, const void* bm,
                     const void* cm, const void* h0, const void* dh_last,
                     void* dx, void* ddt, void* da, void* db, void* dc,
                     void* dh0, void* ws, int B, int S, int H, int N,
                     cudaStream_t stream) {
  if (P == 16)
    return launch<T, 16>(x, dy, y, dt, a, bm, cm, h0, dh_last, dx, ddt, da,
                         db, dc, dh0, ws, B, S, H, N, stream);
  if (P == 32)
    return launch<T, 32>(x, dy, y, dt, a, bm, cm, h0, dh_last, dx, ddt, da,
                         db, dc, dh0, ws, B, S, H, N, stream);
  if (P == 64)
    return launch<T, 64>(x, dy, y, dt, a, bm, cm, h0, dh_last, dx, ddt, da,
                         db, dc, dh0, ws, B, S, H, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of scratch that ssd_scan_bwd_launch needs.
extern "C" long long ssd_scan_bwd_workspace(int B, int S, int H, int P,
                                            int N) {
  return workspace_floats(B, S, H, P, N);
}

// Dynamic shared memory of the gradient pass at head dim P and state N.
extern "C" int ssd_scan_bwd_grad_smem_bytes(int P, int N) {
  return grad_smem(kBwdChunk, P, N);
}

// dtype (of x and dx): 0 = float32, 1 = bfloat16.  P in {16, 32, 64},
// 1 <= N <= 128.  dy and y (B, S, H, P), dh_last (B, H, P, N) or null
// (zeros), all f32; ws: ssd_scan_bwd_workspace(B, S, H, P, N) floats.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dy,
                                   const void* y, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, const void* h0,
                                   const void* dh_last, void* dx, void* ddt,
                                   void* da, void* db, void* dc, void* dh0,
                                   void* ws, int B, int S, int H, int P,
                                   int N, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxState)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_p<float>(P, x, dy, y, dt, a, bm, cm, h0, dh_last, dx,
                                ddt, da, db, dc, dh0, ws, B, S, H, N, st);
  if (dtype == 1)
    return (int)launch_p<__nv_bfloat16>(P, x, dy, y, dt, a, bm, cm, h0,
                                        dh_last, dx, ddt, da, db, dc, dh0,
                                        ws, B, S, H, N, st);
  return (int)cudaErrorInvalidValue;
}

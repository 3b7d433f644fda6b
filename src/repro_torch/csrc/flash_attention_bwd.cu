// flash_attention_bwd: the backward of flash_attention (flash_attention.cu).
//
// The reference trains through jnp: its model differentiates
// chunked_attention (src/repro/models/attention.py:27) with jax.vjp, and
// the Pallas kernel it stands beside (src/repro/kernels/flash_attention/
// kernel.py, `flash_attention`) has no backward.  The port's forward runs
// the hand-written kernel, so its gradient is hand-written too.  For query
// row i of head h, key j of kv head h / G (positions = indices) and the
// forward's visible set (j <= i when causal, j > i - window with a window):
//
//   s[i, j]  = q[i] . k[j] * D^-0.5
//   lse[i]   = max(m[i], -1e4) + log(max(l[i], 1e-30))   (m the row max,
//              l the sum of exp(s - max(m, -1e4)): the forward's clamps)
//   p[i, j]  = exp(s[i, j] - lse[i]), 0 where j is hidden
//   delta[i] = dO[i] . O[i]
//   dp[i, j] = dO[i] . v[j]
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i])
//   dQ[i] = D^-0.5 sum_j ds[i, j] k[j]
//   dK[j] = D^-0.5 sum_{h in group, i} ds[i, j] q[i]
//   dV[j] = sum_{h in group, i} p[i, j] dO[i]
//
// the closed form of autograd through flash_attention_plain: a fully
// masked row has l = 0, every p 0 and a zero gradient.  Inputs and outputs
// are in the model layout, q / O / dO / dQ (B, S, H, D) and k / v / dK / dV
// (B, T, K, D), read in place; lse is the forward's, fp32 (B, H, S), which
// flash_attention.cu stores when it is given the buffer; fp32 math; dQ, dK
// and dV rounded to nearest in the storage type (f32 or bf16); D 32, 64,
// 80 or 128; any S and T.  Every key and every query row has one owner
// block, so there are no atomics and the results are deterministic.
//
// Three launches:
//
// 1. delta, flash_bwd_delta_kernel<T>: rowsum(dO o O) in fp32 into a
//    (B, H, S) workspace that the wrapper allocates; a row's 16-byte
//    pieces go to neighbouring lanes and xor shuffles sum them.  It reads
//    O and dO once (~67 MB at olmo-1b's training shape): bound by bytes.
// 2. dK / dV, a block per 64 keys of one (kv head, batch), walking the G
//    query heads of its group and, for each, the query rows that can see
//    its keys (from the block's first key when causal, up to its last key
//    + window with a window).
// 3. dQ, a block per 64 query rows of one (head, batch), walking the keys
//    that those rows can see.
//
// Passes 2 and 3 form p and ds again from the scores (seven products where
// the backward needs five): that is the price of no atomics.
//
// Tensor-core instance: bf16 at D 64, 80 and 128, the head dims whose
// forward runs flash_attention_wgmma_kernel.  What bounds it on an H100:
// operations.  At olmo-1b's training shape (B 8, S = T 1024, H = K 16, D
// 128, causal) the five products are ~86 GFLOP (0.087 ms at the bf16
// tensor cores' 989 TFLOP/s) over ~268 MB of q, k, v, O, dO, dQ, dK and dV
// (0.080 ms at 3.35 TB/s).  So every product runs on wgmma, one warpgroup
// (128 threads) a block, with the operand layouts of the forward
// (flash_attention.cu): a tile of 64 rows is D / 64 sub-tiles (D 80 padded
// to 128 by zero-filled copies, cp.async src-size 0) of 64 rows x 128
// bytes in the 128-byte swizzle; only the real columns are stored.
//
// * flash_bwd_kv_wgmma_kernel<D> (pass 2).  The block's K and V tiles are
//   loaded once; the (Q, dO) tiles of its query rows, with their 64 lse
//   and 64 delta values (4-byte copies), go through a two-stage cp.async
//   ring.  Per tile: S^T = K Q^T and dP^T = V dO^T with both operands in
//   shared memory (K-major: a row of K, V, Q or dO is D-contiguous); then,
//   on the fp32 accumulator fragments, P^T = exp(S^T D^-0.5 - lse[query])
//   and dS^T = P^T o (dP^T - delta[query]), each thread reading the 16
//   lse and delta values of its columns from shared memory; then dV += P^T
//   dO and dK += dS^T Q with A from registers (the fragment of S^T has the
//   layout of the A fragment, as the forward's P) and B the same Q and dO
//   tiles read MN-major with the transpose bit.  The dK and dV
//   accumulators stay in registers across the walk (2 NSUB x 32 fp32 a
//   thread).  The element mask runs only on tiles that cross the
//   diagonal, the window edge or the ragged end of the queries or keys.
// * flash_bwd_q_wgmma_kernel<D> (pass 3).  The block's Q and dO tiles are
//   loaded once, the K and V tiles of the visible keys go through a
//   two-stage ring (the forward's walk, heaviest blocks first).  Per tile:
//   S = Q K^T and dP = dO V^T in shared memory; P and dS on the fragment
//   (each thread's two rows hold their lse and delta in registers); dQ +=
//   dS K with B the K tile read MN-major.
//
// Rounding: the products of bf16 inputs are exact in fp32 and every sum is
// fp32; P and dS are rounded once to bf16 as the A operand, dS formed from
// the fp32 P.  A single bf16 P and dS meet the card's bf16 rule (2^-6 of
// each element plus 2^-8 of the tensor's largest |value|) at every
// FLASH_BWD row with room to spare (tests/test_torch_flash_backward.py
// emulates them), so neither is split in two halves as the forward's P is.
// Shared memory: K, V, two stages of Q and dO, and 2 x 2 x 64 lse / delta
// floats, 98 KB at D 80 / 128 (49 KB at D 64) for pass 2; Q, dO and two
// stages of K and V, 97 KB (49 KB) for pass 3; two blocks an SM.
//
// CUDA-core instance: f32 at every D, and bf16 at D 32.  TPR threads per
// owned row (1 at D 32, 2 at D 64, 4 at D 80 and 128: each thread holds D
// / TPR columns of every row vector it owns, 16-byte pieces p TPR + part
// as in the forward's CUDA-core instance, and one xor shuffle per level
// finishes a dot product); the row's own vectors and accumulators stay in
// registers, the other side's rows are staged 32 at a time in shared
// memory as fp32.  Its products run as fp32 FMAs (67 TFLOP/s at most).
//
// Tiles the mask hides for the whole block are never loaded; inside a tile
// the element mask zeroes p.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kRows = 64;   // rows (query or key) a block owns
constexpr int kTile = 32;   // rows of the other side staged per tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ constexpr int threads_per_row(int D) {
  return D <= 32 ? 1 : (D <= 64 ? 2 : 4);
}

__device__ __forceinline__ bool visible(int i, int j, int causal,
                                        int window) {
  return (!causal || j <= i) && (window <= 0 || j > i - window);
}

// Stage `valid` rows of D elements, `stride` elements apart, into dst as
// fp32; rows past `valid` are zero.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage(float (*dst)[D], const T* base,
                                      long long stride, int valid) {
  for (int e = threadIdx.x; e < kTile * D; e += NT) {
    const int r = e / D;
    const int d = e - r * D;
    dst[r][d] = r < valid ? to_f(base[r * stride + d]) : 0.f;
  }
}

// The dot product of a register row (this thread's DT = 4 NP columns)
// with a staged row, summed over the TPR threads of the row.
template <int NP, int TPR>
__device__ __forceinline__ float dot_row(const float* reg, const float* row,
                                         int part) {
  const float4* r = reinterpret_cast<const float4*>(row) + part;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < NP; ++d4) {
    const float4 x = r[d4 * TPR];
    s0 = fmaf(reg[4 * d4 + 0], x.x, s0);
    s1 = fmaf(reg[4 * d4 + 1], x.y, s1);
    s2 = fmaf(reg[4 * d4 + 2], x.z, s2);
    s3 = fmaf(reg[4 * d4 + 3], x.w, s3);
  }
  float dot = (s0 + s1) + (s2 + s3);
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  return dot;
}

// acc += a * (this thread's columns of a staged row)
template <int NP, int TPR>
__device__ __forceinline__ void axpy_row(float* acc, float a,
                                         const float* row, int part) {
  const float4* r = reinterpret_cast<const float4*>(row) + part;
#pragma unroll
  for (int d4 = 0; d4 < NP; ++d4) {
    const float4 x = r[d4 * TPR];
    acc[4 * d4 + 0] = fmaf(a, x.x, acc[4 * d4 + 0]);
    acc[4 * d4 + 1] = fmaf(a, x.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(a, x.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(a, x.w, acc[4 * d4 + 3]);
  }
}

// The element of a row that column c of this thread holds: its piece c / 4
// is piece (c / 4) TPR + part of the row.
template <int TPR>
__device__ __forceinline__ int col(int c, int part) {
  return 4 * ((c >> 2) * TPR + part) + (c & 3);
}

// 8 bf16 or 4 f32 of a 16-byte piece of each of two rows: their dot
// product in fp32
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 y = *reinterpret_cast<const float4*>(b);
  return fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, x.w * y.w)));
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(xs[e]);
    const float2 w = __bfloat1622float2(ys[e]);
    s = fmaf(u.x, w.x, fmaf(u.y, w.y, s));
  }
  return s;
}

// Pass 1: delta[b, h, i] = dO[b, i, h] . O[b, i, h], for every row r =
// (b S + i) H + h of the (B S H, D) views.  `lanes` (a power of two, at
// most 32) neighbouring threads take a row, lane p its 16-byte piece p <
// `pieces` (= D * sizeof(T) / 16).
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int S,
                           int H, int D, int pieces, int lanes) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = t / lanes;
  const int p = (int)(t % lanes);
  constexpr int kPer = 16 / (int)sizeof(T);   // elements of a piece
  float sum = 0.f;
  if (r < rows && p < pieces)
    sum = dot16(o + r * D + p * kPer, dout + r * D + p * kPer);
  for (int off = lanes >> 1; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (r < rows && p == 0) {
    const long long bi = r / H;   // b S + i
    const long long b = bi / S;
    delta[(b * H + r % H) * S + (bi - b * S)] = sum;
  }
}

// CUDA-core pass 2: dK and dV of 64 keys of one (kv head, batch).
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kRows * TPR)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int S, int Tk, int H, int K,
                        int causal, int window, float scale) {
  constexpr int DT = D / TPR;
  constexpr int NP = DT / 4;
  constexpr int NT = kRows * TPR;
  static_assert(D % (4 * TPR) == 0, "a thread holds whole 16-byte pieces");
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float ls[kTile];
  __shared__ float dl[kTile];

  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int k0 = blockIdx.x * kRows;
  const int part = threadIdx.x % TPR;
  const int j = k0 + threadIdx.x / TPR;
  const bool active = j < Tk;

  float kr[DT], vr[DT], dkr[DT], dvr[DT];
  const long long koff = (((long long)b * Tk + (active ? j : 0)) * K + kh) * D;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const int d = col<TPR>(c, part);
    kr[c] = active ? to_f(k[koff + d]) : 0.f;
    vr[c] = active ? to_f(v[koff + d]) : 0.f;
    dkr[c] = 0.f;
    dvr[c] = 0.f;
  }

  // the query rows that see some key of the block
  const int k_last = min(k0 + kRows, Tk) - 1;
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(S, k_last + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int i0 = i_begin; i0 < i_end; i0 += kTile) {
      const int valid = min(kTile, i_end - i0);
      const long long qoff = (((long long)b * S + i0) * H + h) * D;
      __syncthreads();  // every thread is done with the previous tile
      stage<T, D, NT>(qs, q + qoff, (long long)H * D, valid);
      stage<T, D, NT>(dos, dout + qoff, (long long)H * D, valid);
      const int tid = threadIdx.x;
      if (tid < kTile) {
        const long long r = ((long long)b * H + h) * S + i0 + tid;
        ls[tid] = tid < valid ? lse[r] : 0.f;
        dl[tid] = tid < valid ? delta[r] : 0.f;
      }
      __syncthreads();
      for (int ii = 0; ii < kTile; ++ii) {
        const int i = i0 + ii;
        const bool ok = active && ii < valid && visible(i, j, causal, window);
        const float s = dot_row<NP, TPR>(kr, qs[ii], part) * scale;
        const float p = ok ? expf(s - ls[ii]) : 0.f;
        const float dp = dot_row<NP, TPR>(vr, dos[ii], part);
        const float ds = p * (dp - dl[ii]);
        axpy_row<NP, TPR>(dvr, p, dos[ii], part);
        axpy_row<NP, TPR>(dkr, ds, qs[ii], part);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int d = col<TPR>(c, part);
      store_f(dk + koff + d, dkr[c] * scale);
      store_f(dv + koff + d, dvr[c]);
    }
  }
}

// CUDA-core pass 3: dQ of 64 query rows of one (head, batch).
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kRows * TPR)
    flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int S, int Tk, int H, int K, int causal, int window,
                       float scale) {
  constexpr int DT = D / TPR;
  constexpr int NP = DT / 4;
  constexpr int NT = kRows * TPR;
  static_assert(D % (4 * TPR) == 0, "a thread holds whole 16-byte pieces");
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * kRows;
  const int part = threadIdx.x % TPR;
  const int i = q0 + threadIdx.x / TPR;
  const bool active = i < S;

  float qr[DT], dor[DT], dqr[DT];
  const long long off = (((long long)b * S + (active ? i : 0)) * H + h) * D;
#pragma unroll
  for (int c = 0; c < DT; ++c) {
    const int d = col<TPR>(c, part);
    qr[c] = active ? to_f(q[off + d]) : 0.f;
    dor[c] = active ? to_f(dout[off + d]) : 0.f;
    dqr[c] = 0.f;
  }
  const long long r = ((long long)b * H + h) * S + (active ? i : 0);
  const float row_lse = active ? lse[r] : 0.f;
  const float row_delta = active ? delta[r] : 0.f;

  const int q_last = min(q0 + kRows, S) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t0 = kv_begin; t0 < kv_end; t0 += kTile) {
    const int valid = min(kTile, kv_end - t0);
    const long long koff = (((long long)b * Tk + t0) * K + kh) * D;
    __syncthreads();  // every thread is done with the previous tile
    stage<T, D, NT>(ks, k + koff, (long long)K * D, valid);
    stage<T, D, NT>(vs, v + koff, (long long)K * D, valid);
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const int j = t0 + jj;
      const bool ok = active && jj < valid && visible(i, j, causal, window);
      const float s = dot_row<NP, TPR>(qr, ks[jj], part) * scale;
      const float p = ok ? expf(s - row_lse) : 0.f;
      const float dp = dot_row<NP, TPR>(dor, vs[jj], part);
      axpy_row<NP, TPR>(dqr, p * (dp - row_delta), ks[jj], part);
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < DT; ++c)
      store_f(dq + off + col<TPR>(c, part), dqr[c] * scale);
  }
}

// ------------------------- tensor-core instance (bf16, D 64, 80, 128)
constexpr int kTcRows = 64;            // keys (pass 2) or queries (pass 3)
constexpr int kTcThreads = 128;        // one warpgroup
constexpr int kTileBytes = 64 * 64 * 2;   // a sub-tile: 64 rows of 128 bytes

// A row of D columns is stored as NSUB sub-tiles of 64 columns (D 80 is
// padded to 128 with zeros); PIECES of its 16-byte pieces are real.  SMEM
// adds room to align the base to 1024 bytes, the swizzle's period.
template <int D>
struct BwdShape {
  static constexpr int NSUB = D > 64 ? 2 : 1;
  static constexpr int PIECES = D / 8;
  static constexpr int TILE = NSUB * kTileBytes;   // 64 rows of one tensor
  // pass 2: K, V; two stages of Q, dO; two stages of 64 lse, 64 delta
  static constexpr int KV_SMEM = 1024 + 2 * TILE + 2 * 2 * TILE +
                                 2 * 2 * kTcRows * 4;
  // pass 3: Q, dO; two stages of K, V
  static constexpr int Q_SMEM = 1024 + 2 * TILE + 2 * 2 * TILE;
  static_assert(D % 16 == 0 && D <= 128, "whole k16 steps, two sub-tiles");
};

// Stage rows r0 .. r0 + 63 of two (rows, D) bf16 tensors a and b (row
// stride `stride` elements) as tiles at dst and dst + TILE; rows at or
// past `end` and D 80's pad pieces are zero-filled, their source address
// kept inside the tensor.
template <int D>
__device__ __forceinline__ void stage_pair(uint32_t dst,
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* b,
                                           long long stride, int r0,
                                           int end) {
  constexpr int PIECES = BwdShape<D>::PIECES;
  constexpr int ROW_PIECES = 8 * BwdShape<D>::NSUB;
  for (int e = threadIdx.x; e < kTcRows * ROW_PIECES; e += kTcThreads) {
    const int r = e / ROW_PIECES, c = e % ROW_PIECES;
    const bool ok = r0 + r < end && c < PIECES;
    const long long off =
        (r0 + r < end ? r0 + r : 0) * stride + (c < PIECES ? c * 8 : 0);
    const uint32_t at = swizzled(dst + (c >> 3) * kTileBytes, r, c & 7);
    cp_async16(at, a + off, ok);
    cp_async16(at + BwdShape<D>::TILE, b + off, ok);
  }
}

// the two products of a tile that read both operands from shared memory:
// x (+)= A_x B_x^T and y (+)= A_y B_y^T over the D / 16 k16 steps (step kk
// reads sub-tile kk / 4, whose descriptor sits kTileBytes >> 4 further on)
template <int NSUB>
__device__ __forceinline__ void two_products(float (&x)[32], uint64_t ax,
                                             uint64_t bx, float (&y)[32],
                                             uint64_t ay, uint64_t by) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = y[i] = 0.f;
  fence_regs(x);
  fence_regs(y);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NSUB; ++kk) {
    const int step = (kk >> 2) * (kTileBytes >> 4) + 2 * (kk & 3);
    wgmma_ss(x, ax + step, bx + step, kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4 * NSUB; ++kk) {
    const int step = (kk >> 2) * (kTileBytes >> 4) + 2 * (kk & 3);
    wgmma_ss(y, ay + step, by + step, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(x);
  fence_regs(y);
}

// A fragments of the four k16 steps of a 64 x 64 fp32 accumulator, in
// bf16: register 4 kk + r holds row 8 (r & 1) + l / 4, columns 16 kk + 8
// (r >> 1) + 2 (l % 4) + {0, 1}, which are the accumulator's d[4 j + 2 (r
// & 1) + {0, 1}] with j = 2 kk + (r >> 1)
__device__ __forceinline__ void to_a_fragment(const float (&d)[32],
                                              uint32_t (&a)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      a[4 * kk + r] = bf16x2_bits(__floats2bfloat162_rn(d[i], d[i + 1]));
    }
  }
}

// acc[u] += A B over the 64 rows of the k dimension, for each 64-column
// sub-tile u of B (a tile read MN-major: 16 rows = 2048 bytes a k16 step)
template <int NSUB>
__device__ __forceinline__ void product_rs(float (&acc)[NSUB][32],
                                           const uint32_t (&a)[16],
                                           uint64_t b) {
#pragma unroll
  for (int u = 0; u < NSUB; ++u) {
    const uint64_t bu = b + u * (kTileBytes >> 4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc[u], a + 4 * kk, bu + 128 * kk);
  }
}

// Store a 64 x D accumulator (NSUB sub-tiles) times `scale` as bf16 rows
// row0 and row0 + 8 of `base` (row stride `stride`), rows below `end`,
// real columns only.
template <int D, int NSUB>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           long long stride,
                                           const float (&acc)[NSUB][32],
                                           int row0, int end, float scale) {
#pragma unroll
  for (int u = 0; u < NSUB; ++u) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c0 = 64 * u + 8 * j;
      if (c0 >= D) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row < end)
          *reinterpret_cast<__nv_bfloat162*>(base + row * stride + c0) =
              __floats2bfloat162_rn(acc[u][4 * j + 2 * half] * scale,
                                    acc[u][4 * j + 2 * half + 1] * scale);
      }
    }
  }
}

// Pass 2 on the tensor cores: dK and dV of 64 keys of one (kv head,
// batch).  Accumulator fragments (fp32), for thread lt of the warpgroup,
// warp w = lt / 32, lane l: d[4 j + 2 half + c] holds row 16 w + l / 4 + 8
// half, column 8 j + 2 (l % 4) + c; here a row is a key, a column a query.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_kv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int S, int Tk,
                              int H, int K, int causal, int window,
                              float scale) {
  constexpr int NSUB = BwdShape<D>::NSUB;
  constexpr int TILE = BwdShape<D>::TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t skv = base;              // K, then V
  const uint32_t sqd = base + 2 * TILE;   // stage s: Q, then dO
  const uint32_t sst = base + 6 * TILE;   // stage s: 64 lse, then 64 delta
  const float* stats = reinterpret_cast<const float*>(smem_raw + (sst - raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int k0 = blockIdx.x * kTcRows;   // the heaviest key blocks first
  const int k_last = min(k0 + kTcRows, Tk) - 1;
  // the query rows that see some key of the block, in 64-row tiles from
  // the block's first key when causal (k0 is a multiple of 64)
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(S, k_last + window) : S;
  const int per_head =
      i_end > i_begin ? (i_end - i_begin + kTcRows - 1) / kTcRows : 0;
  const int ntiles = G * per_head;

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)K * D;
  const long long kv_off = (long long)b * Tk * kv_stride + kh * D;
  stage_pair<D>(skv, k + kv_off, v + kv_off, kv_stride, k0, Tk);
  // tile n: query head kh G + n / per_head, rows from i_begin + 64 (n %
  // per_head)
  auto load_q = [&](int n) {
    const int g = n / per_head;
    const int h = kh * G + g;
    const int i0 = i_begin + (n - g * per_head) * kTcRows;
    const long long q_off = (long long)b * S * q_stride + h * D;
    stage_pair<D>(sqd + (n & 1) * 2 * TILE, q + q_off, dout + q_off,
                  q_stride, i0, S);
    // 128 threads: lse of row tid, then delta of row tid - 64
    const int r = tid & (kTcRows - 1);
    const bool ok = i0 + r < S;
    const float* src = (tid < kTcRows ? lse : delta) +
                       ((long long)b * H + h) * S + (ok ? i0 + r : 0);
    cp_async4(sst + ((n & 1) * 2 * kTcRows + tid) * 4, src, ok);
  };
  if (ntiles > 0) load_q(0);
  cp_async_commit();

  const int key0 = k0 + warp * 16 + (lane >> 2);   // this thread's keys
  const int col = 2 * (lane & 3);                  // and first column
  const uint64_t k_desc = sw128_desc(skv);
  const uint64_t v_desc = sw128_desc(skv + TILE);
  const float scale_log2 = scale * kLog2e;

  float dka[NSUB][32], dva[NSUB][32];
#pragma unroll
  for (int u = 0; u < NSUB; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[u][i] = dva[u][i] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    // tile n has landed, and the warpgroup is done with tile n - 1, whose
    // stage the next copies overwrite
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (n + 1 < ntiles) load_q(n + 1);
    cp_async_commit();

    const int g = n / per_head;
    const int i0 = i_begin + (n - g * per_head) * kTcRows;
    const bool masked = i0 + kTcRows > S || k0 + kTcRows > Tk ||
                        (causal && i0 < k0 + kTcRows - 1) ||
                        (window > 0 && i0 + kTcRows - 1 - k0 >= window);
    const uint32_t sq = sqd + (n & 1) * 2 * TILE;
    const uint64_t q_desc = sw128_desc(sq);
    const uint64_t do_desc = sw128_desc(sq + TILE);
    const float* ls = stats + (n & 1) * 2 * kTcRows;
    const float* dl = ls + kTcRows;

    // S^T = K Q^T and dP^T = V dO^T
    float st[32], dpt[32];
    two_products<NSUB>(st, k_desc, q_desc, dpt, v_desc, do_desc);

    // P^T and dS^T in place
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = 8 * j + col + c;
        const float l2 = ls[qi] * kLog2e;
        const float dlt = dl[qi];
        const int i = i0 + qi;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& x = st[4 * j + 2 * half + c];
          float& y = dpt[4 * j + 2 * half + c];
          float p = exp2f(fmaf(x, scale_log2, -l2));
          if (masked) {
            const int key = key0 + 8 * half;
            if (!(key < Tk && i < S && (!causal || key <= i) &&
                  (window <= 0 || key > i - window)))
              p = 0.f;
          }
          x = p;
          y = p * (y - dlt);
        }
      }
    }
    uint32_t pa[16], da[16];
    to_a_fragment(st, pa);
    to_a_fragment(dpt, da);

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int u = 0; u < NSUB; ++u) {
      fence_regs(dva[u]);
      fence_regs(dka[u]);
    }
    wgmma_fence();
    product_rs<NSUB>(dva, pa, do_desc);
    product_rs<NSUB>(dka, da, q_desc);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < NSUB; ++u) {
      fence_regs(dva[u]);
      fence_regs(dka[u]);
    }
  }
  cp_async_wait_all();

  const long long out_off = (long long)b * Tk * kv_stride + kh * D + col;
  store_rows<D, NSUB>(dk + out_off, kv_stride, dka, key0, Tk, scale);
  store_rows<D, NSUB>(dv + out_off, kv_stride, dva, key0, Tk, 1.f);
}

// Pass 3 on the tensor cores: dQ of 64 query rows of one (head, batch); a
// fragment's row is a query, its column a key.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
    flash_bwd_q_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int S, int Tk,
                             int H, int K, int causal, int window,
                             float scale) {
  constexpr int NSUB = BwdShape<D>::NSUB;
  constexpr int TILE = BwdShape<D>::TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sqd = base;              // Q, then dO
  const uint32_t skv = base + 2 * TILE;   // stage s: K, then V

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest first
  const int q_last = min(q0 + kTcRows, S) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int kv_begin =
      (window > 0 ? max(0, q0 - window + 1) : 0) & ~(kTcRows - 1);
  const int ntiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kTcRows - 1) / kTcRows : 0;

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)K * D;
  const long long q_off = (long long)b * S * q_stride + h * D;
  const long long kv_off = (long long)b * Tk * kv_stride + kh * D;
  stage_pair<D>(sqd, q + q_off, dout + q_off, q_stride, q0, S);
  auto load_kv = [&](int n) {
    stage_pair<D>(skv + (n & 1) * 2 * TILE, k + kv_off, v + kv_off,
                  kv_stride, kv_begin + n * kTcRows, kv_end);
  };
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + (lane >> 2);   // this thread's rows
  const int col = 2 * (lane & 3);                  // and first column
  float l2[2], dlt[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const long long r = ((long long)b * H + h) * S + (row < S ? row : 0);
    l2[half] = row < S ? lse[r] * kLog2e : 0.f;
    dlt[half] = row < S ? delta[r] : 0.f;
  }
  const uint64_t q_desc = sw128_desc(sqd);
  const uint64_t do_desc = sw128_desc(sqd + TILE);
  const float scale_log2 = scale * kLog2e;

  float dqa[NSUB][32];
#pragma unroll
  for (int u = 0; u < NSUB; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[u][i] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (n + 1 < ntiles) load_kv(n + 1);
    cp_async_commit();

    const int t0 = kv_begin + n * kTcRows;
    const int t1 = t0 + kTcRows - 1;
    const bool masked = t1 >= kv_end || (causal && t1 > q0) ||
                        (window > 0 && t0 <= q_last - window);
    const uint32_t sk = skv + (n & 1) * 2 * TILE;
    const uint64_t k_desc = sw128_desc(sk);
    const uint64_t v_desc = sw128_desc(sk + TILE);

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
    two_products<NSUB>(s, q_desc, k_desc, dp, do_desc, v_desc);

    // dS in place of dP
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = t0 + 8 * j + col + c;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 4 * j + 2 * half + c;
          float p = exp2f(fmaf(s[e], scale_log2, -l2[half]));
          if (masked) {
            const int row = row0 + 8 * half;
            if (!(t < kv_end && (!causal || t <= row) &&
                  (window <= 0 || t > row - window)))
              p = 0.f;
          }
          dp[e] = p * (dp[e] - dlt[half]);
        }
      }
    }
    uint32_t da[16];
    to_a_fragment(dp, da);

    // dQ += dS K
#pragma unroll
    for (int u = 0; u < NSUB; ++u) fence_regs(dqa[u]);
    wgmma_fence();
    product_rs<NSUB>(dqa, da, k_desc);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < NSUB; ++u) fence_regs(dqa[u]);
  }
  cp_async_wait_all();

  store_rows<D, NSUB>(dq + q_off + col, q_stride, dqa, row0, S, scale);
}

template <int D>
cudaError_t set_bwd_wgmma_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BwdShape<D>::KV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_q_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BwdShape<D>::Q_SMEM);
  if (err != cudaSuccess || D == 64) return err;
  // two blocks of ~98 KB an SM at D 80 / 128
  err = cudaFuncSetAttribute(flash_bwd_kv_wgmma_kernel<D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_bwd_q_wgmma_kernel<D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv,
                             const float* lse, const float* delta, int B,
                             int S, int Tk, int H, int K, int causal,
                             int window, cudaStream_t st) {
  cudaError_t err = set_bwd_wgmma_attributes<D>();
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  typedef const __nv_bfloat16* In;
  if (Tk > 0) {
    const dim3 kgrid((Tk + kTcRows - 1) / kTcRows, K, B);
    flash_bwd_kv_wgmma_kernel<D>
        <<<kgrid, kTcThreads, BwdShape<D>::KV_SMEM, st>>>(
            (In)q, (In)k, (In)v, (In)dout, lse, delta, (__nv_bfloat16*)dk,
            (__nv_bfloat16*)dv, S, Tk, H, K, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 qgrid((S + kTcRows - 1) / kTcRows, H, B);
  flash_bwd_q_wgmma_kernel<D><<<qgrid, kTcThreads, BwdShape<D>::Q_SMEM, st>>>(
      (In)q, (In)k, (In)v, (In)dout, lse, delta, (__nv_bfloat16*)dq, S, Tk,
      H, K, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
int bwd_wgmma_blocks_per_sm(int pass) {
  if (set_bwd_wgmma_attributes<D>() != cudaSuccess) return -1;
  int n = 0;
  const cudaError_t err =
      pass == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, flash_bwd_kv_wgmma_kernel<D>, kTcThreads,
                      BwdShape<D>::KV_SMEM)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &n, flash_bwd_q_wgmma_kernel<D>, kTcThreads,
                      BwdShape<D>::Q_SMEM);
  return err == cudaSuccess ? n : -1;
}

// ------------------------------------------------------------- launches
template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta,
                         int B, int S, int H, int D, cudaStream_t st) {
  const int pieces = D * (int)sizeof(T) / 16;
  int lanes = 1;
  while (lanes < pieces) lanes <<= 1;
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows * lanes + 255) / 256;
  flash_bwd_delta_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      (const T*)o, (const T*)dout, delta, rows, S, H, D, pieces, lanes);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_fma(const void* q, const void* k, const void* v,
                           const void* dout, void* dq, void* dk, void* dv,
                           const float* lse, const float* delta, int B,
                           int S, int Tk, int H, int K, int causal,
                           int window, cudaStream_t st) {
  constexpr int TPR = threads_per_row(D);
  const float scale = 1.0f / sqrtf((float)D);
  if (Tk > 0) {
    const dim3 kgrid((Tk + kRows - 1) / kRows, K, B);
    flash_bwd_kv_kernel<T, D, TPR><<<kgrid, kRows * TPR, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, S, Tk, H, K, causal, window, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 qgrid((S + kRows - 1) / kRows, H, B);
  flash_bwd_q_kernel<T, D, TPR><<<qgrid, kRows * TPR, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, Tk, H, K, causal, window, scale);
  return cudaGetLastError();
}

#define REPRO_BWD_ARGS \
  q, k, v, dout, dq, dk, dv, lse, delta, B, S, Tk, H, K, causal, window, st

// passes 2 and 3 of one (dtype, D): bf16 at D 64, 80 and 128 on the
// tensor cores, the rest on the CUDA cores
cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, const void* dout, void* dq, void* dk,
                     void* dv, const float* lse, const float* delta, int B,
                     int S, int Tk, int H, int K, int causal, int window,
                     cudaStream_t st) {
  if (dtype == 0 && D == 32)
    return launch_bwd_fma<float, 32>(REPRO_BWD_ARGS);
  if (dtype == 0 && D == 64)
    return launch_bwd_fma<float, 64>(REPRO_BWD_ARGS);
  if (dtype == 0 && D == 80)
    return launch_bwd_fma<float, 80>(REPRO_BWD_ARGS);
  if (dtype == 0 && D == 128)
    return launch_bwd_fma<float, 128>(REPRO_BWD_ARGS);
  if (dtype == 1 && D == 32)
    return launch_bwd_fma<__nv_bfloat16, 32>(REPRO_BWD_ARGS);
  if (dtype == 1 && D == 64) return launch_bwd_wgmma<64>(REPRO_BWD_ARGS);
  if (dtype == 1 && D == 80) return launch_bwd_wgmma<80>(REPRO_BWD_ARGS);
  if (dtype == 1 && D == 128) return launch_bwd_wgmma<128>(REPRO_BWD_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 32, 64, 80 or 128.  q, o,
// dout and dq are (B, S, H, D), k, v, dk and dv (B, T, K, D), all
// contiguous in q's dtype; lse is the forward's fp32 (B, H, S) (read
// only), delta an fp32 workspace of B H S floats.  Every pointer must be
// 16-byte aligned, else cudaErrorMisalignedAddress.  Three launches on
// `stream` (delta, dk / dv, dq); returns the first CUDA error.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* lse,
    void* delta, int B, int S, int Tk, int H, int K, int D, int causal,
    int window, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || H % K || B <= 0 || S <= 0 || Tk < 0 || dtype < 0 ||
      dtype > 1 || (D != 32 && D != 64 && D != 80 && D != 128))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv |
       (uintptr_t)lse | (uintptr_t)delta) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  err = dtype == 0 ? launch_delta<float>(o, dout, (float*)delta, B, S, H, D,
                                         st)
                   : launch_delta<__nv_bfloat16>(o, dout, (float*)delta, B,
                                                 S, H, D, st);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch(dtype, D, q, k, v, dout, dq, dk, dv,
                       (const float*)lse, (const float*)delta, B, S, Tk, H, K,
                       causal, window, st);
}

// Blocks of the bf16 tensor-core backward at head dim D (64, 80 or 128)
// that one SM of the current device holds at once: pass 0 dK / dV, pass 1
// dQ; -1 for another D or a CUDA error.
extern "C" int flash_attention_bwd_wgmma_blocks_per_sm(int D, int pass) {
  if (D == 64) return bwd_wgmma_blocks_per_sm<64>(pass);
  if (D == 80) return bwd_wgmma_blocks_per_sm<80>(pass);
  if (D == 128) return bwd_wgmma_blocks_per_sm<128>(pass);
  return -1;
}

// Dynamic shared memory bytes of a block of the same kernels; -1 for
// another D.
extern "C" int flash_attention_bwd_wgmma_smem_bytes(int D, int pass) {
  if (D == 64) return pass == 0 ? BwdShape<64>::KV_SMEM : BwdShape<64>::Q_SMEM;
  if (D == 80) return pass == 0 ? BwdShape<80>::KV_SMEM : BwdShape<80>::Q_SMEM;
  if (D == 128)
    return pass == 0 ? BwdShape<128>::KV_SMEM : BwdShape<128>::Q_SMEM;
  return -1;
}

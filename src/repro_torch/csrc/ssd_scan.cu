// ssd_scan: the Mamba2 SSD chunk scan, from a carried state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (`ssd_scan`, body `_ssd_kernel`), with what the serving prefill needs
// from the reference's `ssd_chunked` (src/repro/models/ssm.py): it starts
// from the state h0 and writes the final state h_last (the TPU kernel
// starts from zero and drops it).  Per (b, head), chunk by chunk (L steps):
//
//   cum[t]    = sum_{u<=t} a dt[u]                       (within the chunk)
//   y[t]      = sum_{u<=t} (C[t].B[u]) exp(cum[t]-cum[u]) dt[u] x[u]
//             + exp(cum[t]) C[t] . h                     (h: (P, N))
//   h        <- exp(cum[L-1]) h + sum_u exp(cum[L-1]-cum[u]) dt[u] x[u] B[u]^T
//
// x (B, S, H, P) f32 or bf16; dt (B, S, H), a (H,), B / C (B, S, N) shared
// by every head, h0 (B, H, P, N): f32.  y (B, S, H, P) and h_last f32.
// The ragged last chunk is padded in shared memory with dt = x = B = C = 0,
// which leaves the state unchanged, so any S runs.
//
// What bounds it on an H100: operations, in fp32 on the CUDA cores.  At the
// serving path's shapes (B 8, S 2048, H 50, P 64, N 16, chunk 256) a chunk
// does ~L^2/2 (N + P) FMAs inside it and 2 L P N across it, ~10 GFLOP per
// call against ~0.4 GB of x, y, B, C and dt.  The TPU kernel forms the
// L x L gate (256 KB in fp32 at L = 256, over a block's 227 KB) and
// broadcasts B and C to every head in HBM.  This kernel does neither: one
// block per (b, head) loops over the chunks in order with the (P, N) state
// in shared memory, stages the chunk's x, B, C, dt and cum there (~100 KB
// at L = 256), and builds the gated C B^T a tile of 32 rows at a time
// (32 KB); B and C are read from their (B, S, N) arrays by every head of
// the batch row, so they stay in L2 rather than being copied per head.
// A later PR moves the two products to the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 32;     // rows of the gated C B^T tile
constexpr int kMaxChunk = 256;   // cum is scanned with one thread per step
constexpr int kMaxStatePerThread = 32;  // P * N <= 256 * 32

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

int smem_floats(int L, int P, int N) {
  return L * P + 2 * L * (N + 1) + 3 * L + N * P + kRowTile * L;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ bm,
                    const float* __restrict__ cm, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ h_last, int S,
                    int H, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int NP = N + 1;  // padded row stride: conflict-free column reads

  float* xs = smem;           // L * P
  float* bs = xs + L * P;     // L * NP
  float* cs = bs + L * NP;    // L * NP
  float* cum = cs + L * NP;   // L
  float* dts = cum + L;       // L
  float* wts = dts + L;       // L: exp(cum[L-1] - cum[u]) dt[u]
  float* hT = wts + L;        // N * P: the state, [n][p]
  float* att = hT + N * P;    // kRowTile * L

  const float av = a[h];
  const long long hbase = ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    const int n = e - p * N;
    hT[n * P + p] = h0[hbase + e];
  }

  for (int c0 = 0; c0 < S; c0 += L) {
    const int Lc = min(L, S - c0);
    __syncthreads();  // the previous chunk's reads and state writes are done
    for (int u = tid; u < L; u += kThreads)
      dts[u] = u < Lc ? dt[((long long)b * S + c0 + u) * H + h] : 0.f;
    for (int e = tid; e < L * P; e += kThreads) {
      const int u = e / P;
      const int p = e - u * P;
      xs[e] = u < Lc ? to_f(x[(((long long)b * S + c0 + u) * H + h) * P + p])
                     : 0.f;
    }
    for (int e = tid; e < L * N; e += kThreads) {
      const int u = e / N;
      const int n = e - u * N;
      const bool in = u < Lc;
      const long long off = ((long long)b * S + c0 + u) * N + n;
      bs[u * NP + n] = in ? bm[off] : 0.f;
      cs[u * NP + n] = in ? cm[off] : 0.f;
    }
    __syncthreads();

    // inclusive scan of a dt over the chunk (Hillis-Steele, L <= kThreads)
    if (tid < L) cum[tid] = av * dts[tid];
    __syncthreads();
    for (int off = 1; off < L; off <<= 1) {
      const float add = (tid < L && tid >= off) ? cum[tid - off] : 0.f;
      __syncthreads();
      if (tid < L) cum[tid] += add;
      __syncthreads();
    }
    const float clast = cum[L - 1];
    if (tid < L) wts[tid] = expf(clast - cum[tid]) * dts[tid];

    // y, one tile of kRowTile rows at a time
    constexpr int kCols = P / 8;  // 8 threads per row
    for (int r0 = 0; r0 < Lc; r0 += kRowTile) {
      const int R = min(kRowTile, Lc - r0);
      const int U = r0 + R;  // columns u < U can be visible to the tile
      __syncthreads();       // att is free (and cum / wts are written)
      for (int e = tid; e < R * U; e += kThreads) {
        const int r = e / U;
        const int u = e - r * U;
        const int t = r0 + r;
        float val = 0.f;
        if (u <= t) {
          float cb = 0.f;
          for (int n = 0; n < N; ++n) cb = fmaf(cs[t * NP + n], bs[u * NP + n], cb);
          val = cb * expf(cum[t] - cum[u]) * dts[u];
        }
        att[r * U + u] = val;
      }
      __syncthreads();
      const int r = tid >> 3;
      const int pc = (tid & 7) * kCols;
      if (r < R) {
        const int t = r0 + r;
        float acc[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
        for (int u = 0; u <= t; ++u) {
          const float w = att[r * U + u];
          const float* xr = xs + u * P + pc;
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j] = fmaf(w, xr[j], acc[j]);
        }
        const float et = expf(cum[t]);
        for (int n = 0; n < N; ++n) {
          const float cv = cs[t * NP + n];
          const float* hr = hT + n * P + pc;
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j] = fmaf(cv * hr[j], et, acc[j]);
        }
        float* yr = y + (((long long)b * S + c0 + t) * H + h) * P + pc;
#pragma unroll
        for (int j = 0; j < kCols; ++j) yr[j] = acc[j];
      }
    }
    __syncthreads();

    // state update: read the old state into registers, then write
    const float dec = expf(clast);
    float hn[kMaxStatePerThread];
#pragma unroll
    for (int kk = 0; kk < kMaxStatePerThread; ++kk) {
      const int e = tid + kk * kThreads;
      if (e < P * N) {
        const int n = e / P;
        const int p = e - n * P;
        float s = 0.f;
        for (int u = 0; u < Lc; ++u)
          s = fmaf(xs[u * P + p] * wts[u], bs[u * NP + n], s);
        hn[kk] = fmaf(dec, hT[e], s);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMaxStatePerThread; ++kk) {
      const int e = tid + kk * kThreads;
      if (e < P * N) hT[e] = hn[kk];
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    const int n = e - p * N;
    h_last[hbase + e] = hT[n * P + p];
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, const void* h0, void* y,
                   void* h_last, int B, int S, int H, int N, int L,
                   cudaStream_t stream) {
  const int smem = smem_floats(L, P, N) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, P><<<dim3(H, B), kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)bm,
      (const float*)cm, (const float*)h0, (float*)y, (float*)h_last, S, H, N,
      L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(int P, const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, const void* h0, void* y,
                     void* h_last, int B, int S, int H, int N, int L,
                     cudaStream_t stream) {
  if (P == 16)
    return launch<T, 16>(x, dt, a, bm, cm, h0, y, h_last, B, S, H, N, L,
                         stream);
  if (P == 32)
    return launch<T, 32>(x, dt, a, bm, cm, h0, y, h_last, B, S, H, N, L,
                         stream);
  if (P == 64)
    return launch<T, 64>(x, dt, a, bm, cm, h0, y, h_last, B, S, H, N, L,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x): 0 = float32, 1 = bfloat16.  P in {16, 32, 64},
// chunk <= 256, P * N <= 8192; shared memory must fit a block (227 KB).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm,
                               const void* h0, void* y, void* h_last, int B,
                               int S, int H, int P, int N, int chunk,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || chunk <= 0 ||
      chunk > kMaxChunk || P * N > kThreads * kMaxStatePerThread)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_p<float>(P, x, dt, a, bm, cm, h0, y, h_last, B, S, H,
                                N, chunk, st);
  if (dtype == 1)
    return (int)launch_p<__nv_bfloat16>(P, x, dt, a, bm, cm, h0, y, h_last,
                                        B, S, H, N, chunk, st);
  return (int)cudaErrorInvalidValue;
}

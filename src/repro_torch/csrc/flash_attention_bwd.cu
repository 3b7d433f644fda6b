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
// (B, T, K, D), read in place; fp32 math; dQ, dK and dV rounded to nearest
// in the storage type (f32 or bf16); D 32, 64, 80 or 128; any S and T.
//
// Three launches, each with TPR threads per owned row (1 at D 32, 2 at D
// 64, 4 at D 80 and 128: each thread holds D / TPR columns of every row
// vector it owns, 16-byte pieces p TPR + part as in the forward's CUDA-core
// instance, and one xor shuffle per level finishes a dot product):
//
// 1. stats, one block per (64 query rows, head, batch): the row's scores
//    over the visible keys, staged 32 at a time in shared memory, give m
//    and l by the forward's online recurrence, hence lse; delta from O and
//    dO.  Both go to fp32 workspaces (B, H, S) that the wrapper allocates.
//    The forward keeps no lse, so it is recomputed here.
// 2. dK / dV, one block per (64 keys, kv head, batch): each key's k, v and
//    its dK, dV accumulators stay in registers while the block walks the G
//    query heads of its group and, for each, the query rows that can see
//    its keys (from the block's first key when causal, up to its last key
//    + window with a window), 32 rows of q, dO, lse and delta a shared
//    tile.  Every key has one owner, so no atomics: deterministic.
// 3. dQ, one block per (64 query rows, head, batch): the row's q, dO and dQ
//    in registers, the visible keys' k and v 32 a shared tile.
//
// Tiles the mask hides for the whole block are never loaded; inside a tile
// the element mask zeroes p.
//
// What bounds it on an H100: operations.  At olmo-1b's training shape (B
// 8, S = T 1024, H = K 16, D 128, causal) the five products of the
// backward are ~86 GFLOP over ~268 MB of q, k, v, O, dO, dQ, dK and dV.
// This first version recomputes the scores in all three passes (eight
// products in all) on the CUDA cores in fp32, whose peak (67 TFLOP/s) is
// a fifteenth of the bf16 tensor cores'; its times sit beside that bound
// in PERF.md.  Moving the products onto wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;   // rows (query or key) a block owns
constexpr int kTile = 32;   // rows of the other side staged per tile
constexpr float kNegInf = -1e30f;

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

// Pass 1: lse and delta of 64 query rows of one (head, batch).
template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kRows * TPR)
    flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ o,
                           const T* __restrict__ dout, float* __restrict__ lse,
                           float* __restrict__ delta, int S, int Tk, int H,
                           int K, int causal, int window, float scale) {
  constexpr int DT = D / TPR;
  constexpr int NP = DT / 4;
  constexpr int NT = kRows * TPR;
  static_assert(D % (4 * TPR) == 0, "a thread holds whole 16-byte pieces");
  __shared__ __align__(16) float ks[kTile][D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * kRows;
  const int part = threadIdx.x % TPR;
  const int i = q0 + threadIdx.x / TPR;
  const bool active = i < S;

  float qr[DT];
  float dsum = 0.f;
  {
    const long long off = (((long long)b * S + (active ? i : 0)) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int d = col<TPR>(c, part);
      qr[c] = active ? to_f(q[off + d]) : 0.f;
      dsum = fmaf(active ? to_f(dout[off + d]) : 0.f,
                  active ? to_f(o[off + d]) : 0.f, dsum);
    }
  }
#pragma unroll
  for (int s = 1; s < TPR; s <<= 1)
    dsum += __shfl_xor_sync(0xffffffffu, dsum, s);

  const int q_last = min(q0 + kRows, S) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  float m = kNegInf;
  float l = 0.f;
  for (int t0 = kv_begin; t0 < kv_end; t0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    stage<T, D, NT>(ks, k + (((long long)b * Tk + t0) * K + kh) * D,
                    (long long)K * D, min(kTile, kv_end - t0));
    __syncthreads();
    float s[kTile];
    float mt = m;
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {
      const int j = t0 + jj;
      const bool ok = active && j < kv_end && visible(i, j, causal, window);
      const float dot = dot_row<NP, TPR>(qr, ks[jj], part);
      s[jj] = ok ? dot * scale : kNegInf;
      mt = fmaxf(mt, s[jj]);
    }
    mt = fmaxf(mt, -1e4f);  // masked-tile guard, as the forward
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) psum += expf(s[jj] - mt);
    l = l * expf(m - mt) + psum;
    m = mt;
  }
  if (active && part == 0) {
    const long long r = ((long long)b * H + h) * S + i;
    lse[r] = fmaxf(m, -1e4f) + logf(fmaxf(l, 1e-30f));
    delta[r] = dsum;
  }
}

// Pass 2: dK and dV of 64 keys of one (kv head, batch).
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

// Pass 3: dQ of 64 query rows of one (head, batch).
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

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* delta, int B, int S,
                       int Tk, int H, int K, int causal, int window,
                       cudaStream_t st) {
  constexpr int TPR = threads_per_row(D);
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 qgrid((S + kRows - 1) / kRows, H, B);
  flash_bwd_stats_kernel<T, D, TPR><<<qgrid, kRows * TPR, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)o, (const T*)dout, lse, delta, S,
      Tk, H, K, causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Tk > 0) {
    const dim3 kgrid((Tk + kRows - 1) / kRows, K, B);
    flash_bwd_kv_kernel<T, D, TPR><<<kgrid, kRows * TPR, 0, st>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, S, Tk, H, K, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_q_kernel<T, D, TPR><<<qgrid, kRows * TPR, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, S, Tk, H, K, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, void* dq, void* dk,
                     void* dv, float* lse, float* delta, int B, int S, int Tk,
                     int H, int K, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch_bwd<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
                               S, Tk, H, K, causal, window, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
                               S, Tk, H, K, causal, window, st);
    case 80:
      return launch_bwd<T, 80>(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
                               S, Tk, H, K, causal, window, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B,
                                S, Tk, H, K, causal, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 32, 64, 80 or 128.  q, o,
// dout and dq are (B, S, H, D), k, v, dk and dv (B, T, K, D), all
// contiguous in q's dtype; lse and delta are fp32 workspaces of B H S
// floats.  Every pointer must be 16-byte aligned (the staged rows are read
// as float4 pieces), else cudaErrorMisalignedAddress.  Three launches on
// `stream`; returns the first CUDA error.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int S, int Tk, int H, int K, int D, int causal, int window,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || H % K || B <= 0 || S <= 0 || Tk < 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv |
       (uintptr_t)lse | (uintptr_t)delta) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)dispatch<float>(D, q, k, v, o, dout, dq, dk, dv, (float*)lse,
                                (float*)delta, B, S, Tk, H, K, causal, window,
                                st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(D, q, k, v, o, dout, dq, dk, dv,
                                        (float*)lse, (float*)delta, B, S, Tk,
                                        H, K, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

// flash_attention: causal / sliding-window GQA prefill attention.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention`, body `_flash_kernel`).  For query row i of head h and
// key j of kv head h / G (positions = indices):
//
//   s[i, j] = q[i] . k[j] * D^-0.5            visible iff j <= i (causal)
//                                              and j > i - window (window > 0)
//   out[i]  = sum_j p[i, j] v[j] / max(sum_j p[i, j], 1e-30)
//
// with the online softmax of the reference: masked scores are -1e30 and the
// running max is clamped at -1e4, so a row with nothing visible yet keeps
// p == 0.  Inputs and output are in the model layout, q (B, S, H, D) and
// k / v (B, T, K, D), read in place (no transposes): one query row is D
// contiguous elements, so is one key row.  f32 or bf16 storage, fp32 math.
//
// What bounds it on an H100: operations.  At the serving path's shapes
// (B 8, H 25, S = T 2048, D 64) the visible (i, j) pairs need 4 D flops
// each, ~1e11 flops per call against ~0.1 GB of q, k, v and out.  This
// first kernel runs them on the CUDA cores in fp32 (67 TFLOP/s), not on
// the tensor cores (989 TFLOP/s bf16): a later PR moves the two products
// to wgmma.  What the design does about the operations it has: one thread
// per query row keeps the row's q and its accumulator (2 D floats) in
// registers; a block of 64 rows stages each 32-key tile of K and V in
// shared memory once and every thread reads it as a broadcast, so each
// key costs 2 D register FMAs and D / 2 broadcast 16-byte loads.  KV tiles
// that the causal or window mask removes for the whole block are never
// loaded (the loop runs over [q0 - window + 1, last row] only).  GQA reads
// kv head h / G directly, so K and V are never replicated.  The ragged
// last query tile and the ragged last key tile are masked in the kernel,
// so any S and T run (the TPU kernel needs multiples of its block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;   // query rows per block, one per thread
constexpr int kKeys = 32;   // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int Tk, int H, int K, int causal, int window,
                           float scale) {
  __shared__ __align__(16) float ks[kKeys][D];
  __shared__ __align__(16) float vs[kKeys][D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * kRows;
  const int i = q0 + threadIdx.x;
  const bool active = i < S;

  float qr[D];
  float acc[D];
  float m = kNegInf;
  float l = 0.f;
  {
    const T* qrow = q + (((long long)b * S + (active ? i : 0)) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qr[d] = active ? to_f(qrow[d]) : 0.f;
      acc[d] = 0.f;
    }
  }

  const int q_last = min(q0 + kRows, S) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int t0 = kv_begin; t0 < kv_end; t0 += kKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kKeys * D; e += kRows) {
      const int j = e / D;
      const int d = e - j * D;
      const int t = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (t < kv_end) {
        const long long off = (((long long)b * Tk + t) * K + kh) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (!active) continue;

    float s[kKeys];
    float mt = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int t = t0 + j;
      const bool ok = t < kv_end && (!causal || t <= i) &&
                      (window <= 0 || t > i - window);
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        s0 = fmaf(qr[4 * d4 + 0], kk.x, s0);
        s1 = fmaf(qr[4 * d4 + 1], kk.y, s1);
        s2 = fmaf(qr[4 * d4 + 2], kk.z, s2);
        s3 = fmaf(qr[4 * d4 + 3], kk.w, s3);
      }
      s[j] = ok ? ((s0 + s1) + (s2 + s3)) * scale : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, -1e4f);  // masked-tile guard, as the reference
    const float corr = expf(m - mt);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = expf(s[j] - mt);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
      const float p = s[j];
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    m = mt;
  }

  if (active) {
    T* orow = out + (((long long)b * S + i) * H + h) * D;
    const float inv = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) store_f(orow + d, acc[d] / inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int K, int causal, int window,
                   cudaStream_t stream) {
  dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_kernel<T, D><<<grid, kRows, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Tk, H, K, causal,
      window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 32 or 64 (the wrapper
// checks); anything else returns cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int Tk, int H, int K, int D, int causal,
                                      int window, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || H % K || B <= 0 || S <= 0 || Tk < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && D == 32)
    return (int)launch<float, 32>(q, k, v, out, B, S, Tk, H, K, causal,
                                  window, st);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, out, B, S, Tk, H, K, causal,
                                  window, st);
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(q, k, v, out, B, S, Tk, H, K,
                                          causal, window, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, B, S, Tk, H, K,
                                          causal, window, st);
  return (int)cudaErrorInvalidValue;
}

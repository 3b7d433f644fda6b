// decode_attention: one-token GQA flash-decode over a KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (`decode_attention`, body `_decode_kernel`).  For batch row b, query head
// h = kh * G + g and cache slot t:
//
//   s[t]   = q[b, h] . k[b, t, kh] * D^-0.5
//   visible iff kv_pos[b, t] >= 0, kv_pos[b, t] <= q_pos[b] and
//               kv_pos[b, t] > q_pos[b] - window (window > 0)
//   out    = sum_t p[t] v[b, t, kh] / max(sum_t p[t], 1e-30),
//   p[t]   = exp(s[t] - M),  M = max(-1e4, max of the visible s)
//
// which is what the reference's online softmax (masked scores -1e30,
// running max clamped at -1e4, divisor clamped at 1e-30) computes.  q is
// (B, H, D), the cache k / v (B, T, K, D) in the model layout, read in
// place; f32 or bf16 storage, fp32 math.
//
// What bounds it on an H100: bytes.  Each visible slot's K and V rows are
// read once for the G query heads of its kv head, 4 G D flops against 4 D
// bytes (bf16): about G flops per byte, far under the card's ~20 fp32
// flops per byte.  The TPU walks the cache of one (b, kv head) in order on
// one core; on Hopper 40 such pairs (B 8 x K 5) would fill 40 of 132 SMs.
// So the cache is split: one block per (split of 128 slots, kv head, b),
// each block serves the G query heads of its kv head together (K and V
// are read once, not G times) and writes a partial (max, sum, accumulator)
// per head; a second pass combines the splits (nothing carries between
// blocks on Hopper).  A split whose slots are all invisible (empty slots,
// beyond the query, outside the window) loads no K or V at all, so the
// window layers read only the window.  T need not be a multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kKeys = 128;  // cache slots per split, one per thread
constexpr int kMaxG = 8;    // query heads per kv head
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem =
    (kMaxG * kMaxD + kKeys * kMaxD + kMaxG * kKeys) * (int)sizeof(float);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// part layout: (B, K, ns, G, D + 2): the unnormalised accumulator, then the
// split's max and sum.
template <typename T>
__global__ void __launch_bounds__(kKeys)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ kv_pos,
                        const int* __restrict__ q_pos,
                        float* __restrict__ part, int Tk, int H, int K, int D,
                        int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned char okf[kKeys];
  __shared__ float mls[kMaxG][2];

  const int split = blockIdx.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int ns = gridDim.x;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int t = split * kKeys + tid;

  float* qs = smem;            // G * D
  float* vs = qs + G * D;      // kKeys * D
  float* ps = vs + kKeys * D;  // G * kKeys

  const int qp = q_pos[b];
  const int kp = t < Tk ? kv_pos[(long long)b * Tk + t] : -1;
  const bool ok = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
  okf[tid] = ok;
  float* outp = part + (((long long)b * K + kh) * ns + split) * G * (D + 2);
  if (!__syncthreads_or(ok)) {
    for (int e = tid; e < G * (D + 2); e += kKeys)
      outp[e] = (e % (D + 2)) == D ? -1e4f : 0.f;
    return;
  }

  const T* qb = q + ((long long)b * H + (long long)kh * G) * D;
  for (int e = tid; e < G * D; e += kKeys) qs[e] = to_f(qb[e]);
  for (int e = tid; e < kKeys * D; e += kKeys) {
    const int j = e / D;
    const int d = e - j * D;
    float val = 0.f;
    if (okf[j])
      val = to_f(v[(((long long)b * Tk + split * kKeys + j) * K + kh) * D + d]);
    vs[e] = val;
  }
  __syncthreads();

  // scores: one thread per slot, its K row read straight from the cache
  float sacc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) sacc[g] = 0.f;
  if (ok) {
    const T* krow = k + (((long long)b * Tk + t) * K + kh) * D;
    for (int d = 0; d < D; ++d) {
      const float kd = to_f(krow[d]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) sacc[g] = fmaf(qs[g * D + d], kd, sacc[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) ps[g * kKeys + tid] = ok ? sacc[g] * scale : kNegInf;
  __syncthreads();

  // per head: split max (clamped at -1e4), p = exp(s - max), sum
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int g = warp; g < G; g += kKeys / 32) {
    float mx = kNegInf;
    for (int j = lane; j < kKeys; j += 32) mx = fmaxf(mx, ps[g * kKeys + j]);
    for (int o = 16; o; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mx = fmaxf(mx, -1e4f);
    float sm = 0.f;
    for (int j = lane; j < kKeys; j += 32) {
      const float p = expf(ps[g * kKeys + j] - mx);
      ps[g * kKeys + j] = p;
      sm += p;
    }
    for (int o = 16; o; o >>= 1) sm += __shfl_xor_sync(0xffffffffu, sm, o);
    if (lane == 0) {
      mls[g][0] = mx;
      mls[g][1] = sm;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * D; e += kKeys) {
    const int g = e / D;
    const int d = e - g * D;
    float a = 0.f;
    for (int j = 0; j < kKeys; ++j) a = fmaf(ps[g * kKeys + j], vs[j * D + d], a);
    outp[g * (D + 2) + d] = a;
  }
  for (int g = tid; g < G; g += kKeys) {
    outp[g * (D + 2) + D] = mls[g][0];
    outp[g * (D + 2) + D + 1] = mls[g][1];
  }
}

// one block per (kv head, b), one thread per (g, d)
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ out, int H, int K,
                                      int D, int ns) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / K;
  const int g = threadIdx.x / D;
  const int d = threadIdx.x - g * D;
  if (g >= G) return;
  const float* pb = part + ((long long)b * K + kh) * ns * G * (D + 2);
  float mx = -1e4f;
  for (int s = 0; s < ns; ++s)
    mx = fmaxf(mx, pb[((long long)s * G + g) * (D + 2) + D]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float* ps = pb + ((long long)s * G + g) * (D + 2);
    const float w = expf(ps[D] - mx);
    l = fmaf(ps[D + 1], w, l);
    a = fmaf(ps[d], w, a);
  }
  store_f(out + ((long long)b * H + (long long)kh * G + g) * D + d,
          a / fmaxf(l, 1e-30f));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_pos, const void* q_pos, void* part,
                   void* out, int B, int Tk, int H, int K, int D, int window,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int G = H / K;
  const int ns = (Tk + kKeys - 1) / kKeys;
  const int smem = (G * D + kKeys * D + G * kKeys) * (int)sizeof(float);
  decode_split_kernel<T><<<dim3(ns, K, B), kKeys, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)kv_pos,
      (const int*)q_pos, (float*)part, Tk, H, K, D, window,
      1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(K, B), G * D, 0, stream>>>(
      (const float*)part, (T*)out, H, K, D, ns);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  part is (B, K, ceil(T / 128), G, D + 2)
// f32 scratch from the wrapper.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_pos,
                                       const void* q_pos, void* part,
                                       void* out, int B, int Tk, int H, int K,
                                       int D, int window, int dtype,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || H % K || H / K > kMaxG || D <= 0 || D > kMaxD || D % 8 ||
      B <= 0 || Tk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, kv_pos, q_pos, part, out, B, Tk, H, K,
                              D, window, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, kv_pos, q_pos, part, out, B,
                                      Tk, H, K, D, window, st);
  return (int)cudaErrorInvalidValue;
}

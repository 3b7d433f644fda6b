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
// place; f32 or bf16 storage, fp32 math, output in q's dtype.
//
// What bounds it on an H100: bytes.  Each visible slot's K and V rows are
// read once for the G query heads of their kv head: 4 G D flops against
// 4 D bytes in bf16, 5 flops per byte at hymba's G = 5, where the fp32
// cores could keep up with about 20 per byte at the HBM rate.  So the math
// stays on the CUDA cores (an mma m16n8k16 with the G query heads as its
// rows would leave 11 of 16 rows empty).  The design:
//
// * Row-vector loads.  A K or V row is D * esz bytes (128 in bf16 at D 64,
//   one cache line).  Lanes of a warp are grouped per row: D esz / 16 of
//   them (rounded up to a power of two) each copy one 16-byte piece, so one
//   warp instruction covers 32 / that many whole rows.  The copies go into
//   a ring of two stages per warp (cp.async, kRows rows of K and V per lane
//   and stage, 8 KB per warp): the next stage is in flight while the math
//   runs on this one.  Each lane reads back only the pieces it copied.
// * Registers for the math.  q, times D^-0.5 log2(e), sits in shared memory
//   and is read 16 bytes at a time; a lane keeps G accumulators of its dims
//   in registers.  Scores are partial dot products reduced over the row's
//   lanes with xor shuffles; the online softmax (max clamped at -1e4, in
//   base 2) runs per lane over its rows, kRows at a time, and rescales only
//   when the max moves.  The row groups of a warp, then the warps, merge
//   once at the end.
// * Splits.  The cache is cut into 64-slot chunks and split s of ns takes
//   chunks s, s + ns, ..., so that a window's chunks spread over all
//   splits.  The wrapper chooses ns so that B K ns fills one wave of
//   resident blocks (decode_attention_blocks_per_sm per SM): one block per
//   (split, kv head, b).
//   Slots that are not visible (empty, beyond the query, outside the
//   window) are never read, and a split with none visible loads no K or V.
// * One launch.  Each block writes its split's (accumulator, max, sum) and
//   arrives on a per-(b, kv head, head group) counter; the last block to
//   arrive merges the splits, writes the output and resets the counter to
//   zero (with one split, the block itself).
// * Head groups.  A block takes at most kBlockG = 8 query heads: at G 16
//   (glm4-9b) the G accumulators of a bf16 D 128 lane alone would take
//   128 registers.  A KV head with G > 8 query heads is split into
//   head_groups(G) groups of G / head_groups(G) heads (the fewest groups
//   that divide G), each its own blocks on the grid's y axis, so the
//   instances of G <= 8 serve every G up to kMaxG = 16.  A group reads its
//   KV head's cache once more; the second read mostly hits L2.  The split
//   plan, the partials and the arrival counters are per (b, kv head, head
//   group): the kernel sees the groups as GQA heads of their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;          // cache rows per lane per ring stage
constexpr int kStages = 2;        // ring stages per warp
constexpr int kMaxG = 16;         // query heads per kv head
constexpr int kBlockG = 8;        // query heads per block (a head group)
constexpr int kMaxD = 128;
constexpr int kChunk = 64;       // cache slots per chunk
constexpr int kMaxSplit = 2048;   // slots per split (32 chunks), at most
constexpr int kMergeBatch = 16;   // splits the last block loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
// resident blocks per SM that the launch bounds ask for at G query heads
// per kv head; the wrapper's split plan fills one wave of them
constexpr int blocks_per_sm(int g) { return g <= 5 ? 3 : 2; }
// the running max's clamp, -1e4, in base-2 units (scores are kept scaled
// by log2(e), so that exp(s - m) is exp2 of the scaled difference)
constexpr float kFloor2 = -1e4f * kLog2e;
// per warp: kStages stages of kRows rows' K and V pieces, 16 bytes a lane
constexpr int kWarpRing = kStages * 2 * kRows * 32;  // uint4s
constexpr int kSmem = kWarps * kWarpRing * 16;       // dynamic, bytes

// one 16-byte piece of a row, unpacked to fp32
template <typename T>
struct Piece;
template <>
struct Piece<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* x) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
};
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, zero-filled (nothing read) when bytes is 0
__device__ __forceinline__ void cp_async16(uint4* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// The fewest head groups that divide G with at most kBlockG heads each.
constexpr int head_groups(int g) {
  int n = (g + kBlockG - 1) / kBlockG;
  while (g % n) ++n;
  return n;
}

// G is the heads of one head group, and the grid's y axis runs over the
// K ng (kv head, head group) pairs: pair y reads kv head y / ng, and its
// query heads are y G .. y G + G - 1.  part: (B, K ng, ns, G, D + 4) f32:
// a split's unnormalised accumulator, then its max (base 2) and sum (rows
// padded to 16 bytes).  count: (B, K ng) int32 arrival counters, zero
// between launches.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(G))
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ kv_pos,
                            const int* __restrict__ q_pos,
                            float* __restrict__ part, int* __restrict__ count,
                            T* __restrict__ out, int Tk, int K, int ng,
                            int D, int window, float scale) {
  constexpr int VEC = Piece<T>::n;
  constexpr int kScan = kMaxSplit / kThreads;  // positions per thread
  constexpr int kQ = (G * kMaxD + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) uint4 ring[];
  __shared__ unsigned char vis[kMaxSplit];
  __shared__ __align__(16) float qs[G][kMaxD];
  __shared__ int last;

  const int split = blockIdx.x;
  const int pair = blockIdx.y;     // (kv head, head group)
  const int kh = pair / ng;
  const int b = blockIdx.z;
  const int ns = gridDim.x;
  const int KG = gridDim.y;        // K ng
  const int H = KG * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // split s takes chunks s, s + ns, s + 2 ns, ... of the cache: its local
  // slot j is cache slot at(j); n local slots (the last chunk may be short)
  const int nchunk = (Tk + kChunk - 1) / kChunk;
  const int n = (nchunk - split + ns - 1) / ns * kChunk;
  auto at = [&](unsigned j) {
    return (int)(((j / kChunk) * ns + split) * kChunk + j % kChunk);
  };
  const int qp = q_pos[b];
  const int P = D + 4;  // floats per row of part
  // q is stored times scale * log2(e): scores come out in base-2 units
  const float sc2 = scale * kLog2e;

  // q of the G heads, in fp32, and which of the split's slots are visible;
  // every load of both is in flight before the first is used
  const T* qb = q + ((long long)b * H + pair * G) * D;
  T qv[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) qv[i] = qb[e];
  }
  int pv[kScan];
#pragma unroll
  for (int i = 0; i < kScan; ++i) {
    const int j = tid + i * kThreads;
    const int t = at(j);
    pv[i] = j < n && t < Tk ? kv_pos[(long long)b * Tk + t] : -1;
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * D) qs[e / D][e % D] = to_f(qv[i]) * sc2;
  }
  bool any = false;
#pragma unroll
  for (int i = 0; i < kScan; ++i) {
    const int j = tid + i * kThreads;
    const int p = pv[i];
    const bool ok = p >= 0 && p <= qp && (window <= 0 || p > qp - window);
    if (j < n) vis[j] = ok;
    any |= ok;
  }
  any = __syncthreads_or(any);

  // the lanes of a row: rl of them hold its 16-byte pieces, lpr (rl rounded
  // up to a power of two) are given to it
  const int rl = D / VEC;
  const int lpr = rl <= 1 ? 1 : 1 << (32 - __clz(rl - 1));
  const int sub = lane & (lpr - 1);
  const int grp = lane / lpr;
  const int rpl = 32 / lpr;  // rows one warp load covers
  const bool live = sub < rl;
  const int dq = live ? sub * VEC : 0;
  uint4* wring = ring + warp * kWarpRing;

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kFloor2;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  if (any) {
    const long long rs = (long long)K * D;  // elements from slot to slot
    const long long off0 =
        (long long)b * Tk * rs + (long long)kh * D + sub * VEC;
    const T* kb = k + off0;
    const T* vb = v + off0;
    const int step = kWarps * rpl * kRows;  // rows of the block per stage
    const int first = warp * rpl * kRows;
    const int nsteps = first < n ? (n - first + step - 1) / step : 0;

    // this lane's K and V pieces of the stage's rows into its ring slot;
    // invisible rows are zero-filled and read nothing
    auto fetch = [&](int i) {
      uint4* slot = wring + (i % kStages) * 2 * kRows * 32 + lane;
      const int base = first + i * step;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int j = base + u * rpl + grp;
        const int jj = j < n ? j : 0;
        const bool ok = live && j < n && vis[jj];
        const long long o = ok ? (long long)at(jj) * rs : 0;
        cp_async16(slot + u * 32, kb + o, ok ? 16 : 0);
        cp_async16(slot + (kRows + u) * 32, vb + o, ok ? 16 : 0);
      }
    };
    // scores, online softmax and the PV product of a stage's rows
    auto math = [&](int i) {
      const uint4* slot = wring + (i % kStages) * 2 * kRows * 32 + lane;
      const int base = first + i * step;
      bool ok[kRows];
      bool some = false;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int j = base + u * rpl + grp;
        ok[u] = j < n && vis[j < n ? j : 0];
        some |= ok[u];
      }
      if (!__any_sync(kFull, some)) return;
      float kx[kRows][VEC];
#pragma unroll
      for (int u = 0; u < kRows; ++u) Piece<T>::unpack(slot[u * 32], kx[u]);
      float s[kRows][G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float qv4[VEC];
#pragma unroll
        for (int i4 = 0; i4 < VEC; i4 += 4) {
          const float4 t = *reinterpret_cast<const float4*>(&qs[g][dq + i4]);
          qv4[i4] = t.x;
          qv4[i4 + 1] = t.y;
          qv4[i4 + 2] = t.z;
          qv4[i4 + 3] = t.w;
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) a = fmaf(qv4[e], kx[u][e], a);
          s[u][g] = a;
        }
      }
#pragma unroll 1
      for (int o = lpr >> 1; o >= 1; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[u][g] += __shfl_xor_sync(kFull, s[u][g], o);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (ok[u]) mx = fmaxf(mx, s[u][g]);
        if (mx > m[g]) {  // rescale only when the max moved
          const float c = exp2_(m[g] - mx);
          l[g] *= c;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] *= c;
          m[g] = mx;
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          s[u][g] = ok[u] ? exp2_(s[u][g] - mx) : 0.f;
          l[g] += s[u][g];
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        float vx[VEC];
        Piece<T>::unpack(slot[(kRows + u) * 32], vx);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][e] = fmaf(s[u][g], vx[e], acc[g][e]);
      }
    };

    // a ring of kStages stages per warp; each lane reads back only the
    // pieces it copied itself, so no barrier is needed between lanes
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < nsteps) fetch(i);
      cp_async_commit();
    }
    for (int i = 0; i < nsteps; ++i) {
      cp_async_wait<kStages - 1>();
      math(i);
      if (i + kStages < nsteps) fetch(i + kStages);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }

  // merge the warp's row groups (lanes with the same piece of a row)
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], o);
      const float lo = __shfl_xor_sync(kFull, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = exp2_(m[g] - mx);
      const float c = exp2_(mo - mx);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mx;
    }
  }
  // each warp's (accumulator, max, sum) goes to its own ring, once every
  // lane of the warp is done reading it
  float* red = reinterpret_cast<float*>(wring);  // (G, D + 2)
  __syncwarp();
  if (lane < lpr && live) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[g * (D + 2) + dq + e] = acc[g][e];
      if (lane == 0) {
        red[g * (D + 2) + D] = m[g];
        red[g * (D + 2) + D + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps: the split's (accumulator, max, sum) per (g, d)
  float* pb = part + (((long long)b * KG + pair) * ns + split) * G * P;
  T* ob = out + ((long long)b * H + pair * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    const int d = e - g * D;
    float mx = kFloor2;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rw = reinterpret_cast<const float*>(ring + w * kWarpRing);
      mx = fmaxf(mx, rw[g * (D + 2) + D]);
    }
    float sm = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rw = reinterpret_cast<const float*>(ring + w * kWarpRing);
      const float c = exp2_(rw[g * (D + 2) + D] - mx);
      sm = fmaf(rw[g * (D + 2) + D + 1], c, sm);
      a = fmaf(rw[g * (D + 2) + d], c, a);
    }
    pb[g * P + d] = a;
    if (d == 0) {
      pb[g * P + D] = mx;
      pb[g * P + D + 1] = sm;
    }
  }

  // arrive; the last block of this (b, pair) merges the splits.  The
  // barrier orders the block's partial stores before thread 0's release
  // fence and counter update; the last block's acquire fence and barrier
  // order its reads of the others' partials after their arrivals.
  __syncthreads();
  if (tid == 0) {
    fence_acq_rel();
    last = atomicAdd(count + b * KG + pair, 1) == ns - 1;
    if (last) fence_acq_rel();
  }
  __syncthreads();
  if (!last) return;
  // four dims a thread; the splits' (max, sum, accumulator) are loaded
  // kMergeBatch at a time, each batch's loads in flight together
  const float* pk = part + ((long long)b * KG + pair) * ns * G * P;
  for (int e = tid; e < G * D / 4; e += kThreads) {
    const int g = 4 * e / D;
    const int d = 4 * e - g * D;
    float mx = kFloor2, sm = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ns; s0 += kMergeBatch) {
      float ms[kMergeBatch], ls[kMergeBatch];
      float4 xs[kMergeBatch];
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        ms[i] = kFloor2;
        ls[i] = 0.f;
        xs[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s0 + i < ns) {
          const float* ps = pk + ((long long)(s0 + i) * G + g) * P;
          ms[i] = __ldcg(ps + D);
          ls[i] = __ldcg(ps + D + 1);
          xs[i] = __ldcg(reinterpret_cast<const float4*>(ps + d));
        }
      }
#pragma unroll
      for (int i = 0; i < kMergeBatch; ++i) {
        const float mn = fmaxf(mx, ms[i]);
        const float c0 = exp2_(mx - mn);
        const float c1 = exp2_(ms[i] - mn);
        sm = sm * c0 + ls[i] * c1;
        a.x = a.x * c0 + xs[i].x * c1;
        a.y = a.y * c0 + xs[i].y * c1;
        a.z = a.z * c0 + xs[i].z * c1;
        a.w = a.w * c0 + xs[i].w * c1;
        mx = mn;
      }
    }
    sm = fmaxf(sm, 1e-30f);
    T* o = ob + g * D + d;
    store_f(o, a.x / sm);
    store_f(o + 1, a.y / sm);
    store_f(o + 2, a.z / sm);
    store_f(o + 3, a.w / sm);
  }
  if (tid == 0) count[b * KG + pair] = 0;
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const void* kv_pos, const void* q_pos, void* part,
                     void* count, void* out, int B, int Tk, int K, int ng,
                     int D, int window, int ns, int device,
                     cudaStream_t stream) {
  // the dynamic shared memory limit is set once per device
  static unsigned long long attr_set = 0;
  if (device >= 64 || !(attr_set >> device & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    if (device < 64) attr_set |= 1ull << device;
  }
  decode_attention_kernel<T, G>
      <<<dim3(ns, K * ng, B), kThreads, kSmem, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)kv_pos,
          (const int*)q_pos, (float*)part, (int*)count, (T*)out, Tk, K, ng,
          D, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_pos, const void* q_pos, void* part,
                   void* count, void* out, int B, int Tk, int G, int K,
                   int D, int window, int ns, int device,
                   cudaStream_t st) {
  const int ng = head_groups(G);
  switch (G / ng) {
#define REPRO_DECODE_G(g)                                                  \
  case g:                                                                  \
    return launch_g<T, g>(q, k, v, kv_pos, q_pos, part, count, out, B, Tk, \
                          K, ng, D, window, ns, device, st);
    REPRO_DECODE_G(1)
    REPRO_DECODE_G(2)
    REPRO_DECODE_G(3)
    REPRO_DECODE_G(4)
    REPRO_DECODE_G(5)
    REPRO_DECODE_G(6)
    REPRO_DECODE_G(7)
    REPRO_DECODE_G(8)
#undef REPRO_DECODE_G
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  G = H / K <= 16 query heads per kv
// head run as ng = head_groups(G) groups of G / ng.  splits: blocks per
// (b, kv head, head group), each taking every splits-th 64-slot chunk of
// the cache and at most 32 chunks; part is (B, K ng, splits, G / ng,
// D + 4) f32 scratch and count (B, K ng) int32 counters that are zero, both
// from the wrapper; the launch leaves count zero again.  k and v must be 16-byte aligned (their rows
// are copied in 16-byte pieces); q is read element by element.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kv_pos,
                                       const void* q_pos, void* part,
                                       void* count, void* out, int B, int Tk,
                                       int H, int K, int D, int window,
                                       int splits, int dtype, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || H % K || H / K > kMaxG || H <= 0 ||
      K * head_groups(H / K) > 65535 || D <= 0 ||
      D > kMaxD || D % 8 || B <= 0 || B > 65535 || Tk <= 0 || splits <= 0 ||
      splits > (Tk + kChunk - 1) / kChunk ||
      ((Tk + kChunk - 1) / kChunk + splits - 1) / splits * kChunk > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, kv_pos, q_pos, part, count, out, B,
                              Tk, H / K, K, D, window, splits, device, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, kv_pos, q_pos, part, count,
                                      out, B, Tk, H / K, K, D, window, splits,
                                      device, st);
  return (int)cudaErrorInvalidValue;
}

// g: query heads of one block (a head group)
extern "C" int decode_attention_blocks_per_sm(int g) {
  return blocks_per_sm(g);
}

extern "C" int decode_attention_head_groups(int g) {
  return g >= 1 && g <= kMaxG ? head_groups(g) : 0;
}

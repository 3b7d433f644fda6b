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
// contiguous elements, so is one key row.  fp32 math, output rounded to
// nearest in the storage type.  When the caller passes an fp32 (B, H, S)
// buffer lse (training: flash_attention_bwd reads it), each row also
// stores lse[b, h, i] = max(m, -1e4) + log(max(l, 1e-30)), m the clamped
// row max and l the sum of exp(s - m); a null lse (serving) stores
// nothing and leaves every other instruction as it was.  Two instances:
//
// * bf16 with D = 64 (every launch of the hymba serving path), 80
//   (h2o-danube-1.8b) or 128 (glm4-9b, olmo-1b, nemotron-4-15b):
//   flash_attention_wgmma_kernel<D>, both products on the tensor cores;
// * f32 (D 32, 64, 80, 128) and bf16 with D = 32: flash_attention_kernel,
//   both products as fp32 FMAs on the CUDA cores.
//
// What bounds it on an H100: operations.  At the serving path's shapes
// (B 8, H 25, S = T 2048, D 64) the visible (i, j) pairs need 4 D flops
// each, ~1e11 flops per call against ~0.1 GB of q, k, v and out, far above
// the card's ~295 bf16 flops per byte of device memory; at glm4-9b's
// prefill (H 32, D 128) ~2.7e11 flops against ~0.15 GB.  On the CUDA cores
// the floor is the fp32 peak (67 TFLOP/s, 4.1 ms at glm4-9b); only the
// tensor cores reach the bf16 one (0.28 ms there), so every bf16 head dim
// of a served config runs the tensor-core instance.  Its P V product is
// done twice (P split in two bf16 halves, below), so the tensor cores do
// 1.5x the counted work.
//
// Tensor-core instance.  One block of two warpgroups takes 128 query rows
// of one (batch, head); each warpgroup owns 64 rows, the M of one
// wgmma.m64n64k16.  Blocks walk the query tiles heaviest first (the last
// causal tiles see the most keys).  A tile of 64 rows is stored as D / 64
// sub-tiles (D 80 is padded to 128) of 64 rows x 128 bytes, each in the
// 128-byte swizzle that the wgmma shared-memory descriptors read.  The Q
// tile is loaded once; K and V tiles of 64 keys go through a two-stage
// ring filled by 16-byte cp.async copies while the previous tile is
// computed.  Ragged rows and D 80's pad columns (pieces 10..15 of a row)
// are zero-filled (cp.async src-size 0), so the pad adds zeros to every
// score; the scale is the real D^-0.5, the global strides the real H D and
// K D, and only the real columns are stored.  S = Q K^T is D / 16 k16
// steps with both operands in shared memory (a key row is D-contiguous, so
// K is K-major for B); step kk reads sub-tile kk / 4.  The products of
// bf16 inputs are exact in fp32.  The online softmax runs on the fp32
// accumulator fragment: each row's 64 values sit in one quad of threads,
// so a row max is two xor shuffles; the accurate expf is used, as in the
// reference.  O += P V takes A from registers: for 16-bit inputs the fp32
// accumulator fragment of S has the layout of the A fragment.  P is split
// as P = bf16(P) + bf16(P - bf16(P)) and both halves go through the
// tensor cores (eight k16 steps per tile and V sub-tile): a single bf16 P
// changes about 38% of the bf16 outputs against the fp32-P reference, the
// split about 0.2% at D 64, 80 and 128 (tests/test_torch_flash_attention.py
// emulates both).  V is D-contiguous, i.e. MN-major for B, and is read
// with the B-transpose bit; at D 80 / 128 O is two 64-column accumulators,
// one m64n64k16 chain per V sub-tile.  The block loads the key tiles over
// [q0 - window + 1, last row], the first one starting at the multiple of
// 64 at or below q0 - window + 1, so tile edges meet the warpgroups'
// 64-row edges; a tile that the causal or window mask removes for a whole
// warpgroup is skipped by it, and the element mask runs only on tiles that
// cross the diagonal, the window edge or the end of the keys.  GQA reads
// kv head h / G in place; the G query heads that share it hit L2.
// Shared memory: 49 KB a block at D 64, 97 KB at D 80 / 128, two blocks
// an SM either way.
//
// CUDA-core instance.  TPR threads per query row (1 at D 32 and 64, 2 at
// D 80 and 128) keep the row's q and its accumulator (2 D / TPR floats a
// thread) in registers: at D 128 one thread a row would hold ~290 values
// with the 32 scores, over the 255-register limit.  Thread p of a row owns
// the 16-byte pieces p, p + TPR, p + 2 TPR, ... of it, so the TPR threads
// of a row read neighbouring pieces of a key (no bank conflict) and one
// xor shuffle per key finishes its score.  A block of 64 rows stages each
// 32-key tile of K and V in shared memory once and every thread reads it
// as a broadcast, so each key costs 2 D / TPR register FMAs a thread.  KV
// tiles that the causal or window mask removes for the whole block are
// never loaded (the loop runs over [q0 - window + 1, last row] only).  The
// ragged last query tile and the ragged last key tile are masked in the
// kernel, so any S and T run (the TPU kernel needs multiples of its
// block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

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

template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kRows * TPR)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int S, int Tk, int H,
                           int K, int causal, int window, float scale) {
  static_assert(D % (4 * TPR) == 0, "a thread holds whole 16-byte pieces");
  constexpr int DT = D / TPR;     // dims of a row that one thread holds
  constexpr int NP = DT / 4;      // its 16-byte pieces
  constexpr int kThreads = kRows * TPR;
  __shared__ __align__(16) float ks[kKeys][D];
  __shared__ __align__(16) float vs[kKeys][D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = blockIdx.x * kRows;
  const int part = threadIdx.x % TPR;
  const int i = q0 + threadIdx.x / TPR;
  const bool active = i < S;
  // the row's element of this thread's dim c: piece c / 4 of the thread is
  // piece (c / 4) TPR + part of the row
  auto dim = [&](int c) { return 4 * ((c >> 2) * TPR + part) + (c & 3); };

  float qr[DT];
  float acc[DT];
  float m = kNegInf;
  float l = 0.f;
  {
    const T* qrow = q + (((long long)b * S + (active ? i : 0)) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      qr[c] = active ? to_f(qrow[dim(c)]) : 0.f;
      acc[c] = 0.f;
    }
  }

  const int q_last = min(q0 + kRows, S) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int t0 = kv_begin; t0 < kv_end; t0 += kKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < kKeys * D; e += kThreads) {
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
    // the threads of a row shuffle together, so with TPR > 1 an inactive
    // row runs the tile with every key masked
    if (TPR == 1 && !active) continue;

    float s[kKeys];
    float mt = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int t = t0 + j;
      const bool ok = active && t < kv_end && (!causal || t <= i) &&
                      (window <= 0 || t > i - window);
      const float4* kr = reinterpret_cast<const float4*>(ks[j]) + part;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < NP; ++d4) {
        const float4 kk = kr[d4 * TPR];
        s0 = fmaf(qr[4 * d4 + 0], kk.x, s0);
        s1 = fmaf(qr[4 * d4 + 1], kk.y, s1);
        s2 = fmaf(qr[4 * d4 + 2], kk.z, s2);
        s3 = fmaf(qr[4 * d4 + 3], kk.w, s3);
      }
      float dot = (s0 + s1) + (s2 + s3);
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[j] = ok ? dot * scale : kNegInf;
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
    for (int c = 0; c < DT; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(vs[j]) + part;
      const float p = s[j];
#pragma unroll
      for (int d4 = 0; d4 < NP; ++d4) {
        const float4 vv = vr[d4 * TPR];
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
    for (int c = 0; c < DT; ++c) store_f(orow + dim(c), acc[c] / inv);
    // the TPR threads of a row hold the same m and l
    if (lse != nullptr && part == 0)
      lse[((long long)b * H + h) * S + i] =
          fmaxf(m, -1e4f) + logf(fmaxf(l, 1e-30f));
  }
}

// TPR threads per query row: 2 at D 80 and 128, whose q and accumulator
// would not fit one thread's registers beside the scores
template <typename T, int D, int TPR = (D > 64 ? 2 : 1)>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int Tk, int H, int K, int causal,
                   int window, cudaStream_t stream) {
  dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_attention_kernel<T, D, TPR><<<grid, kRows * TPR, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, S, Tk, H, K,
      causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// ------------------------------ tensor-core instance (bf16, D 64, 80, 128)
constexpr int kTcRows = 128;           // query rows per block, 64 per warpgroup
constexpr int kTcKeys = 64;            // keys per K / V tile
constexpr int kTcThreads = 256;        // two warpgroups
constexpr int kTileBytes = 64 * 64 * 2;   // a sub-tile: 64 rows of 128 bytes
// blocks per SM that the D 80 / 128 instances are built for (their O
// fragment alone is 64 registers a thread)
constexpr int kTcWideBlocks = 2;

// A row of D columns is stored as NSUB sub-tiles of 64 columns (D 80 is
// padded to 128 with zeros); PIECES of its 16-byte pieces are real.  SMEM:
// Q (two warpgroup tiles) + two stages of K and V, and room to align the
// base to 1024 bytes, the period of the 128-byte swizzle.
template <int D>
struct TcShape {
  static constexpr int NSUB = D > 64 ? 2 : 1;
  static constexpr int PIECES = D / 8;
  static constexpr int TILE = NSUB * kTileBytes;   // 64 rows of Q, K or V
  static constexpr int SMEM = 1024 + 2 * TILE + 2 * 2 * TILE;
  static constexpr int MIN_BLOCKS = D > 64 ? kTcWideBlocks : 2;
  static_assert(D % 16 == 0 && D <= 128, "whole k16 steps, two sub-tiles");
};

// Accumulator fragment of a 64 x 64 wgmma tile (fp32), for thread lt of
// the warpgroup, warp w = lt / 32, lane l: d[4 j + 2 half + c] holds row
// 16 w + l / 4 + 8 half, column 8 j + 2 (l % 4) + c.  At D 64 two blocks
// per SM (128 registers a thread, no spills), so that one warpgroup's
// softmax overlaps another's products: on an H100 SXM at 700 W, 0.66 ms
// against 0.87 ms with one block per SM (168 registers) at the serving
// shape.  At D 80 / 128 a thread holds O as two such fragments, one per
// 64-column sub-tile of V, and still fits 128 registers with no spill;
// kTcWideBlocks says how many blocks an SM.  Two: at glm4-9b's prefill
// (B 8, H 32, K 2, S = T 2048) 1.067 ms against 1.366-1.380 with one
// block an SM (168 registers), on an H100 SXM at 700 W
// (tools/flash_attention_probe.py, base and one-block in one run).
template <int D>
__global__ void __launch_bounds__(kTcThreads, TcShape<D>::MIN_BLOCKS)
    flash_attention_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ lse, int S, int Tk,
                                 int H, int K, int causal, int window,
                                 float scale) {
  constexpr int NSUB = TcShape<D>::NSUB;
  constexpr int PIECES = TcShape<D>::PIECES;
  constexpr int TILE = TcShape<D>::TILE;
  constexpr int ROW_PIECES = 8 * NSUB;   // 16-byte pieces of a stored row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                // warpgroup w's Q at sq + w TILE
  const uint32_t skv = base + 2 * TILE;    // stage s: K, then V

  const int tid = threadIdx.x;
  // At D 80 / 128 the warpgroup is broadcast from lane 0, so that the
  // compiler knows it is the same across the warp: the Q descriptors
  // derived from it then sit in uniform registers, which wgmma reads.  In
  // the thread's own registers they made O, S and P spill 24-80 bytes at
  // the 128 that two blocks an SM allow.
  const int wg = NSUB > 1 ? __shfl_sync(0xffffffffu, tid >> 7, 0) : tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest first
  const int q_last = min(q0 + kTcRows, S) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int kv_begin =
      (window > 0 ? max(0, q0 - window + 1) : 0) & ~(kTcKeys - 1);
  const int ntiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kTcKeys - 1) / kTcKeys : 0;

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)K * D;
  const __nv_bfloat16* qb = q + (long long)b * S * q_stride + h * D;
  const __nv_bfloat16* kb = k + (long long)b * Tk * kv_stride + kh * D;
  const __nv_bfloat16* vb = v + (long long)b * Tk * kv_stride + kh * D;

  // piece c of row r lands in chunk c % 8 of sub-tile c / 8; the ragged
  // rows and the pieces past the real D (D 80's columns 80..127) are
  // zero-filled, the pad's source address kept inside the row
  for (int e = tid; e < kTcRows * ROW_PIECES; e += kTcThreads) {
    const int r = e / ROW_PIECES, c = e % ROW_PIECES;
    const bool ok = q0 + r < S;
    cp_async16(swizzled(sq + (r >> 6) * TILE + (c >> 3) * kTileBytes, r & 63,
                        c & 7),
               qb + (ok ? q0 + r : 0) * q_stride + (c < PIECES ? c * 8 : 0),
               ok && c < PIECES);
  }
  auto load_kv = [&](int n) {
    const int t0 = kv_begin + n * kTcKeys;
    const uint32_t sk = skv + (n & 1) * 2 * TILE;
    for (int e = tid; e < kTcKeys * ROW_PIECES; e += kTcThreads) {
      const int r = e / ROW_PIECES, c = e % ROW_PIECES;
      const bool ok = t0 + r < kv_end;
      const long long off =
          (ok ? t0 + r : 0) * kv_stride + (c < PIECES ? c * 8 : 0);
      const uint32_t dst = swizzled(sk + (c >> 3) * kTileBytes, r, c & 7);
      cp_async16(dst, kb + off, ok && c < PIECES);
      cp_async16(dst + TILE, vb + off, ok && c < PIECES);
    }
  };
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  // this warpgroup's rows, and this thread's two rows and first column
  const int r_lo = q0 + wg * 64;
  const int r_hi = r_lo + 63;
  const bool live = r_lo < S;
  const int row0 = r_lo + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int col = 2 * (lane & 3);
  const uint64_t q_desc = sw128_desc(sq + wg * TILE);

  float o[NSUB][32];
#pragma unroll
  for (int u = 0; u < NSUB; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[u][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    // tile n has landed, and every warpgroup is done with tile n - 1,
    // whose stage the next copies overwrite
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (n + 1 < ntiles) load_kv(n + 1);
    cp_async_commit();

    const int t0 = kv_begin + n * kTcKeys;
    const int t1 = t0 + kTcKeys - 1;
    if (!live || (causal && t0 > r_hi) ||
        (window > 0 && t1 <= r_lo - window))
      continue;  // the mask removes the whole tile for these 64 rows
    const bool masked = t1 >= kv_end || (causal && t1 > r_lo) ||
                        (window > 0 && t0 <= r_hi - window);
    const uint32_t sk = skv + (n & 1) * 2 * TILE;
    const uint64_t k_desc = sw128_desc(sk);
    const uint64_t v_desc = sw128_desc(sk + TILE);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    // 16 elements = 32 bytes a step; step kk reads sub-tile kk / 4, whose
    // descriptor sits kTileBytes >> 4 further on
#pragma unroll
    for (int kk = 0; kk < 4 * NSUB; ++kk) {
      const int step = (kk >> 2) * (kTileBytes >> 4) + 2 * (kk & 3);
      wgmma_ss(s, q_desc + step, k_desc + step, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& a0 = s[4 * j + c];
        float& a1 = s[4 * j + 2 + c];
        a0 *= scale;
        a1 *= scale;
        if (masked) {
          const int t = t0 + 8 * j + col + c;
          const bool in = t < kv_end;
          if (!(in && (!causal || t <= row0) &&
                (window <= 0 || t > row0 - window)))
            a0 = kNegInf;
          if (!(in && (!causal || t <= row1) &&
                (window <= 0 || t > row1 - window)))
            a1 = kNegInf;
        }
        mx0 = fmaxf(mx0, a0);
        mx1 = fmaxf(mx1, a1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    mx0 = fmaxf(mx0, -1e4f);  // masked-tile guard, as the reference
    mx1 = fmaxf(mx1, -1e4f);
    const float corr0 = expf(m0 - mx0);
    const float corr1 = expf(m1 - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[4 * j + c] = expf(s[4 * j + c] - mx0);
        s[4 * j + 2 + c] = expf(s[4 * j + 2 + c] - mx1);
        sum0 += s[4 * j + c];
        sum1 += s[4 * j + 2 + c];
#pragma unroll
        for (int u = 0; u < NSUB; ++u) {
          o[u][4 * j + c] *= corr0;
          o[u][4 * j + 2 + c] *= corr1;
        }
      }
    }
    l0 = l0 * corr0 + sum0;  // this thread's 16 columns; the quad sums later
    l1 = l1 * corr1 + sum1;
    m0 = mx0;
    m1 = mx1;

    // A fragment of k step kk: register r holds row 8 (r & 1) + l / 4,
    // columns 16 kk + 8 (r >> 1) + 2 (l % 4) + {0, 1}, which are the
    // accumulator's d[4 j + 2 (r & 1) + {0, 1}] with j = 2 kk + (r >> 1)
    uint32_t p_hi[16], p_lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[i], s[i + 1]);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[4 * kk + r] = bf16x2_bits(hi);
        p_lo[4 * kk + r] =
            bf16x2_bits(__floats2bfloat162_rn(s[i] - hf.x, s[i + 1] - hf.y));
      }
    }
#pragma unroll
    for (int u = 0; u < NSUB; ++u) fence_regs(o[u]);
    wgmma_fence();
    // 16 keys = 2048 bytes of a V sub-tile a step; sub-tile u holds O's
    // columns 64 u .. 64 u + 63
#pragma unroll
    for (int u = 0; u < NSUB; ++u) {
      const uint64_t vu = v_desc + u * (kTileBytes >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[u], p_hi + 4 * kk, vu + 128 * kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[u], p_lo + 4 * kk, vu + 128 * kk);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < NSUB; ++u) fence_regs(o[u]);
  }
  cp_async_wait_all();
  if (!live) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = fmaxf(l0, 1e-30f);
  const float inv1 = fmaxf(l1, 1e-30f);
  // a row's m and l are the same in the four threads of its quad
  if (lse != nullptr && (lane & 3) == 0) {
    float* lrow = lse + ((long long)b * H + h) * S;
    if (row0 < S) lrow[row0] = fmaxf(m0, -1e4f) + logf(inv0);
    if (row1 < S) lrow[row1] = fmaxf(m1, -1e4f) + logf(inv1);
  }
  __nv_bfloat16* ob = out + (long long)b * S * q_stride + h * D + col;
#pragma unroll
  for (int u = 0; u < NSUB; ++u) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c0 = 64 * u + 8 * j;   // only the real columns are stored
      if (c0 >= D) continue;
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_stride + c0) =
            __floats2bfloat162_rn(o[u][4 * j] / inv0, o[u][4 * j + 1] / inv0);
      if (row1 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + row1 * q_stride + c0) =
            __floats2bfloat162_rn(o[u][4 * j + 2] / inv1,
                                  o[u][4 * j + 3] / inv1);
    }
  }
}

template <int D>
cudaError_t set_wgmma_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, TcShape<D>::SMEM);
  if (err != cudaSuccess || D == 64) return err;
  // the wide instances' two blocks need ~194 KB of an SM's shared memory
  return cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int S, int Tk, int H,
                         int K, int causal, int window, cudaStream_t stream) {
  // 16-byte copies and 4-byte stores (a row of D 80 is 160 bytes)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return cudaErrorMisalignedAddress;
  cudaError_t err = set_wgmma_attributes<D>();
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTcRows - 1) / kTcRows, H, B);
  flash_attention_wgmma_kernel<D>
      <<<grid, kTcThreads, TcShape<D>::SMEM, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (__nv_bfloat16*)out, lse, S, Tk, H, K,
          causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
int wgmma_blocks_per_sm() {
  if (set_wgmma_attributes<D>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, flash_attention_wgmma_kernel<D>, kTcThreads,
          TcShape<D>::SMEM) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 32, 64, 80 or 128 (the
// wrapper checks); anything else returns cudaErrorInvalidValue.  bf16 with
// D 64, 80 or 128 runs the tensor-core instance, which needs 16-byte
// aligned pointers; f32, and bf16 with D 32, run the CUDA-core instance.
// lse: null, or an fp32 (B, H, S) buffer that receives each row's lse.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse_p,
                                      int B, int S, int Tk, int H, int K,
                                      int D, int causal, int window,
                                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || H % K || B <= 0 || S <= 0 || Tk < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* lse = (float*)lse_p;
  if (dtype == 0 && D == 32)
    return (int)launch<float, 32>(q, k, v, out, lse, B, S, Tk, H, K, causal,
                                  window, st);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, out, lse, B, S, Tk, H, K, causal,
                                  window, st);
  if (dtype == 0 && D == 80)
    return (int)launch<float, 80>(q, k, v, out, lse, B, S, Tk, H, K, causal,
                                  window, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, out, lse, B, S, Tk, H, K, causal,
                                   window, st);
  if (dtype == 1 && D == 32)
    return (int)launch<__nv_bfloat16, 32>(q, k, v, out, lse, B, S, Tk, H, K,
                                          causal, window, st);
  if (dtype == 1 && D == 64)
    return (int)launch_wgmma<64>(q, k, v, out, lse, B, S, Tk, H, K, causal,
                                 window, st);
  if (dtype == 1 && D == 80)
    return (int)launch_wgmma<80>(q, k, v, out, lse, B, S, Tk, H, K, causal,
                                 window, st);
  if (dtype == 1 && D == 128)
    return (int)launch_wgmma<128>(q, k, v, out, lse, B, S, Tk, H, K, causal,
                                  window, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the bf16 tensor-core instance at head dim D (64, 80 or 128)
// that one SM of the current device holds at once; -1 for another D or a
// CUDA error.
extern "C" int flash_attention_wgmma_blocks_per_sm(int D) {
  if (D == 64) return wgmma_blocks_per_sm<64>();
  if (D == 80) return wgmma_blocks_per_sm<80>();
  if (D == 128) return wgmma_blocks_per_sm<128>();
  return -1;
}

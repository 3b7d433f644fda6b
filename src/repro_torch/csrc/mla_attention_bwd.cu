// mla_attention_bwd: the backward of flash_attention_latent, the latent
// (absorbed) prefill of multi-head latent attention (mla_attention.cu).
//
// Replaces no Pallas kernel of its own: the reference trains MLA through
// `mla_attention` (src/repro/models/attention.py:218-286), whose absorbed
// form runs `chunked_attention` (:27) in jnp on [q_lat ; q_rope] over one
// shared key head [c_kv ; k_rope] with the value head c_kv, and its
// train_loss differentiates that with jax.vjp.  The port's forward runs
// the hand-written latent kernel, so its gradient is hand-written too.
// For batch row b, query row r = (position i, head h) = i H + h and key t
// (positions = indices), visible iff t <= i:
//
//   s[r, t]   = scale (q_lat[r] . c_kv[t] + q_rope[r] . k_rope[t])
//   p[r, t]   = exp(s[r, t] - lse[r]), 0 where t is hidden; lse the
//               forward's (max clamped at -1e4, sum at 1e-30)
//   delta[r]  = dO[r] . O[r]
//   ds[r, t]  = p[r, t] (dO[r] . c_kv[t] - delta[r])
//   dq_lat[r] = scale sum_t ds[r, t] c_kv[t]
//   dq_rope[r]= scale sum_t ds[r, t] k_rope[t]
//   dc_kv[t]  = sum_r p[r, t] dO[r] + scale sum_r ds[r, t] q_lat[r]
//   dk_rope[t]= scale sum_r ds[r, t] q_rope[r]
//
// c_kv is both the value and the key's first R columns, so dc_kv takes
// both parts, and every head shares the one latent row, so the sums over
// r run over every (position, head) row that sees key t.  R = 512 and Dr =
// 64.  q_lat / dO / O / dq_lat (B, S, H, R), q_rope / dq_rope (B, S, H,
// Dr), c_kv / dc_kv (B, T, R), k_rope / dk_rope (B, T, Dr), read and
// written in place; lse fp32 (B, S, H) from the forward; f32 or bf16
// storage, fp32 math, outputs rounded to nearest in the storage type.
// Every query row and every key has one owner block and its sums run in a
// fixed order: no atomics, and two calls give the same bits.
//
// What bounds it on an H100: operations.  The five products (s, dO . c_kv,
// the two sums of the key side and the query side's) are 2 (576 + 512 +
// 512 + 576 + 576) flops a visible (row, key) pair: 2.96e12 at deepseek-v3's
// training shape (B 8, S = T 1024, H 128), 3.0 ms at the bf16 tensor-core
// peak and 44 ms at the fp32 CUDA-core one.  This first kernel runs every
// product as fp32 FMAs on the CUDA cores, in both storage types, and forms
// s and dO . c_kv twice (once on each side, so that no sum needs an
// atomic): 7 680 flops a pair, 1.40x the five.  Four launches:
//
// 1. delta, mla_bwd_delta_kernel<T>: dO . O, one warp a row, into an fp32
//    (B, S, H) workspace from the wrapper.  Bound by bytes.
// 2. the query side, mla_bwd_q_kernel<T>: a block of 8 warps owns 32 query
//    rows (warp w rows 4 w .. 4 w + 3, in the model layout's order, so at H
//    128 a quarter of one position's heads, and at an H that is not a
//    multiple of 32 rows of two positions: the mask is per row), their
//    [q_lat ; q_rope] and dO staged in shared memory as fp32 for the whole
//    walk.  It walks the visible keys in tiles of 32 latent rows staged as
//    fp32 (rows padded to 580 floats, so lanes reading 32 rows at one
//    column hit different banks): lane j takes key j for the warp's 4 rows,
//    s and dO . c_kv from one key load and 4 + 4 broadcast loads per 4
//    columns; then for each key the 4 rows' ds come from its lane by
//    shuffle and each lane adds ds times its 18 columns of the key row (16
//    of c_kv, 4 lane + 128 u, and 2 of k_rope) to 72 accumulators.  Blocks
//    run heaviest first (the last positions see the most keys).
// 3. the key side, mla_bwd_kv_kernel<T>: a block owns 32 keys (warp w keys
//    4 w .. 4 w + 3), staged once, and walks a chunk of the rows that see
//    them (every row from position t0 on: t0 H .. S H) in tiles of 32 rows
//    whose [q_lat ; q_rope], dO, lse and delta are staged; lane j takes
//    row j for the warp's 4 keys, and then for each row the 4 keys' p and
//    scale ds come by shuffle and each lane adds p dO + scale ds q_lat to
//    its 16 c_kv columns and scale ds q_rope to its 2 k_rope columns of
//    each key.  Key tile 0 is seen by every row (131 072 at B 8, S 1024, H
//    128) and the last by 32 H, so one block a key tile would leave the
//    card to its heaviest blocks (B T / 32 = 128 blocks at B 4, one wave,
//    each as long as tile 0's): a key tile's rows are cut into chunks of
//    kChunkRows (8 192, 64 positions at H 128), a block each (grid: chunk,
//    key tile, batch row; 1 088 blocks of at most 256 row tiles at B 4),
//    and each block writes its keys' fp32 partial sums to a workspace
//    from the wrapper (156 MB at B 4).
// 4. the sum, mla_bwd_reduce_kernel<T>: a block per (key tile, batch row)
//    adds its chunks' partial sums in chunk order and writes dc_kv and
//    dk_rope rounded to the storage type.  Bound by bytes.
//
// Shared memory: 213 504 bytes (q side) and 214 528 (key side), one block
// of 256 threads an SM.  What may bind next: shared-memory bandwidth (one
// load for every 2-3 FMAs in the score loops) and the 8 warps an SM
// hiding the FMA latency; the products belong on the tensor cores (wgmma,
// as the forward's), a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 512;                 // latent rank: value width
constexpr int kDr = 64;                 // shared rope key width
constexpr int kDk = kR + kDr;           // key width, 576
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;               // own rows or keys a block, and
                                        // the other side's rows a tile
constexpr int kPer = kTile / kWarps;    // own rows or keys a warp: 4
constexpr int kKStride = kDk + 4;       // a staged row read by 32 lanes
constexpr int kOStride = kR + 4;        // a staged dO row read by 32 lanes
constexpr int kLaneCols = kR / 32 + kDr / 32;  // 18 columns a lane owns
constexpr int kChunkRows = 8192;        // rows a key-side block walks
constexpr int kPartFloats = kTile * kDk;  // a key-side block's partial sums
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// dynamic shared memory of the two row-walking passes
constexpr int kQSmem = (kTile * kDk + kTile * kR + kTile * kKStride) * 4;
constexpr int kKvSmem = (2 * kTile * kKStride + kTile * kOStride) * 4;

// four consecutive elements (16-byte aligned for f32, 8 for bf16) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// fp32 values to consecutive outputs, rounded to nearest
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float4 ld4s(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

struct BwdArgs {
  const void* q_lat;    // (B, rows, R)
  const void* q_rope;   // (B, rows, Dr)
  const void* c_kv;     // (B, Tk, R)
  const void* k_rope;   // (B, Tk, Dr)
  const void* dout;     // (B, rows, R)
  const float* lse;     // (B, rows), the forward's
  const float* delta;   // (B, rows), pass 1's
  float* part;          // the key side's partial sums (workspace)
  void* dq_lat;         // like q_lat
  void* dq_rope;        // like q_rope
  void* dc_kv;          // like c_kv
  void* dk_rope;        // like k_rope
  int B;
  int rows;             // S H
  int H;
  int Tk;
  float scale;
  float sc2;            // scale * log2(e): p = exp2(sc2 s' - lse log2(e))
};

// The key side's row chunks of key tile `tile`: the rows from its first
// position on, kChunkRows at a time (one chunk of none when no row sees
// it, so that its sum is written as zero).
__host__ __device__ __forceinline__ int kv_chunks(int rows, int tile, int H) {
  const long long first = (long long)tile * kTile * H;
  return first >= rows ? 1 : (int)((rows - first + kChunkRows - 1) /
                                   kChunkRows);
}
// the chunks of a batch row's key tiles before `tile`
__host__ __device__ __forceinline__ long long kv_chunks_before(int rows,
                                                               int tile,
                                                               int H) {
  long long n = 0;
  for (int j = 0; j < tile; ++j) n += kv_chunks(rows, j, H);
  return n;
}

// Stage `n` rows (from row `first`, zero past n) of a [x ; y] pair of
// (rows, R) and (rows, Dr) tensors into dst as fp32, `stride` floats a
// row; with y null only the R columns.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int stride,
                                           const T* x, const T* y,
                                           long long first, int n) {
  constexpr int kGroups = kDk / 4;
  const int groups = y != nullptr ? kGroups : kR / 4;
  for (int e = threadIdx.x; e < kTile * groups; e += kThreads) {
    const int i = e / groups;
    const int c = (e - i * groups) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) {
      const long long r = first + i;
      v = c < kR ? load4(x + r * kR + c) : load4(y + r * kDr + (c - kR));
    }
    *reinterpret_cast<float4*>(dst + i * stride + c) = v;
  }
}

// Pass 1: delta[r] = dO[r] . O[r] for every row r of the (B S H, R) views,
// one warp a row, lane l its columns 4 l + 128 u.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mla_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                         float* __restrict__ delta, long long rows) {
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;   // the whole warp
  const T* o = out + r * kR + 4 * lane;
  const T* d = dout + r * kR + 4 * lane;
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) s = dot4(load4(o + 128 * u), load4(d + 128 * u), s);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) delta[r] = s;
}

// Pass 2: dq_lat and dq_rope of 32 query rows of one batch row.  grid: B x
// row tiles, one dimension, heaviest first.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mla_bwd_q_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kTile][kDk] own rows' [q_lat ; q_rope]
  float* dos = qs + kTile * kDk;      // [kTile][kR]  own rows' dO
  float* ks = dos + kTile * kR;       // [kTile][kKStride] a key tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = a.rows, H = a.H, Tk = a.Tk;
  const int ntiles = (rows + kTile - 1) / kTile;
  const int b = blockIdx.x % a.B;
  const int r0 = (ntiles - 1 - (int)(blockIdx.x / a.B)) * kTile;
  const long long rb = (long long)b * rows;
  const T* ck = static_cast<const T*>(a.c_kv) + (long long)b * Tk * kR;
  const T* kr = static_cast<const T*>(a.k_rope) + (long long)b * Tk * kDr;

  const int nr = min(kTile, rows - r0);
  stage_rows<T>(qs, kDk, static_cast<const T*>(a.q_lat) + rb * kR,
                static_cast<const T*>(a.q_rope) + rb * kDr, r0, nr);
  stage_rows<T>(dos, kR, static_cast<const T*>(a.dout) + rb * kR,
                static_cast<const T*>(nullptr), r0, nr);

  // the warp's rows: position (-1 past the last row: sees no key), lse in
  // base 2 and delta
  const int wr0 = r0 + warp * kPer;
  int pos[kPer];
  float l2[kPer], dl[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = wr0 + i;
    const bool ok = r < rows;
    pos[i] = ok ? r / H : -1;
    l2[i] = ok ? a.lse[rb + r] * kLog2e : 0.f;
    dl[i] = ok ? a.delta[rb + r] : 0.f;
  }
  // the keys up to the block's last row's position
  const int t_end = min(Tk, (r0 + nr - 1) / H + 1);

  float acc[kPer][kLaneCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[i][c] = 0.f;
  const float* qw = qs + warp * kPer * kDk;
  const float* dw = dos + warp * kPer * kR;
  const float* kl = ks + lane * kKStride;

  for (int t0 = 0; t0 < t_end; t0 += kTile) {
    const int nk = min(kTile, t_end - t0);
    __syncthreads();   // own rows staged; every warp done with the last tile
    stage_rows<T>(ks, kKStride, ck, kr, t0, nk);
    __syncthreads();

    // s and dO . c_kv of the warp's rows against key t0 + lane
    float s[kPer], dp[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kR; d += 4) {
      const float4 k4 = ld4s(kl + d);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s[i] = dot4(ld4s(qw + i * kDk + d), k4, s[i]);
        dp[i] = dot4(ld4s(dw + i * kR + d), k4, dp[i]);
      }
    }
#pragma unroll 4
    for (int d = kR; d < kDk; d += 4) {
      const float4 k4 = ld4s(kl + d);
#pragma unroll
      for (int i = 0; i < kPer; ++i) s[i] = dot4(ld4s(qw + i * kDk + d), k4, s[i]);
    }
    const int t = t0 + lane;
    float ds[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float p = lane < nk && t <= pos[i]
                          ? exp2f(fmaf(s[i], a.sc2, -l2[i])) : 0.f;
      ds[i] = p * (dp[i] - dl[i]);
    }
    // dq += ds . key row, key by key: its ds from its lane
    for (int j = 0; j < nk; ++j) {
      float g[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) g[i] = __shfl_sync(kFull, ds[i], j);
      const float* kj = ks + j * kKStride;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 k4 = ld4s(kj + 4 * lane + 128 * u);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          acc[i][4 * u + 0] = fmaf(g[i], k4.x, acc[i][4 * u + 0]);
          acc[i][4 * u + 1] = fmaf(g[i], k4.y, acc[i][4 * u + 1]);
          acc[i][4 * u + 2] = fmaf(g[i], k4.z, acc[i][4 * u + 2]);
          acc[i][4 * u + 3] = fmaf(g[i], k4.w, acc[i][4 * u + 3]);
        }
      }
      const float2 k2 = *reinterpret_cast<const float2*>(kj + kR + 2 * lane);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        acc[i][16] = fmaf(g[i], k2.x, acc[i][16]);
        acc[i][17] = fmaf(g[i], k2.y, acc[i][17]);
      }
    }
  }

  const float sc = a.scale;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = wr0 + i;
    if (r >= rows) continue;
    T* dql = static_cast<T*>(a.dq_lat) + (rb + r) * kR + 4 * lane;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      store4(dql + 128 * u, acc[i][4 * u] * sc, acc[i][4 * u + 1] * sc,
             acc[i][4 * u + 2] * sc, acc[i][4 * u + 3] * sc);
    store2(static_cast<T*>(a.dq_rope) + (rb + r) * kDr + 2 * lane,
           acc[i][16] * sc, acc[i][17] * sc);
  }
}

// Pass 3: the partial sums of dc_kv and dk_rope of 32 keys of one batch
// row over one chunk of the rows that see them.  grid: (chunks of key tile
// 0, key tiles, B); a block past its tile's chunks returns at once.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    mla_bwd_kv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                     // [kTile][kKStride] own keys
  float* qs = ks + kTile * kKStride;    // [kTile][kKStride] a row tile
  float* dos = qs + kTile * kKStride;   // [kTile][kOStride] its dO
  __shared__ float l2s[kTile], dls[kTile];
  __shared__ int poss[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = a.rows, H = a.H, Tk = a.Tk;
  const int b = blockIdx.z;
  const int tile = blockIdx.y;
  const int chunk = blockIdx.x;
  const int nchunks = kv_chunks(rows, tile, H);
  if (chunk >= nchunks) return;   // the whole block
  const int t0 = tile * kTile;
  const int nk = min(kTile, Tk - t0);
  const long long rb = (long long)b * rows;
  // this chunk's rows: from position t0 on, kChunkRows at a time
  const long long r_begin = (long long)t0 * H + (long long)chunk * kChunkRows;
  const long long r_end =
      r_begin + kChunkRows < rows ? r_begin + kChunkRows : rows;
  const T* ql = static_cast<const T*>(a.q_lat) + rb * kR;
  const T* qr = static_cast<const T*>(a.q_rope) + rb * kDr;
  const T* dO = static_cast<const T*>(a.dout) + rb * kR;

  stage_rows<T>(ks, kKStride,
                static_cast<const T*>(a.c_kv) + (long long)b * Tk * kR,
                static_cast<const T*>(a.k_rope) + (long long)b * Tk * kDr,
                t0, nk);

  const int wk0 = warp * kPer;   // the warp's keys: t0 + wk0 + k
  float acc[kPer][kLaneCols];
#pragma unroll
  for (int k = 0; k < kPer; ++k)
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) acc[k][c] = 0.f;
  const float* qj0 = qs + lane * kKStride;
  const float* oj0 = dos + lane * kOStride;
  const float* kw = ks + wk0 * kKStride;

  // the chunk's rows, all at positions t0 and on: the only ones that see
  // a key here
  for (long long rr = r_begin; rr < r_end; rr += kTile) {
    const int nr = r_end - rr < kTile ? (int)(r_end - rr) : kTile;
    __syncthreads();   // own keys staged; every warp done with the last tile
    stage_rows<T>(qs, kKStride, ql, qr, rr, nr);
    stage_rows<T>(dos, kOStride, dO, static_cast<const T*>(nullptr), rr, nr);
    if (tid < kTile) {
      const bool ok = tid < nr;
      poss[tid] = ok ? (int)((rr + tid) / H) : -1;
      l2s[tid] = ok ? a.lse[rb + rr + tid] * kLog2e : 0.f;
      dls[tid] = ok ? a.delta[rb + rr + tid] : 0.f;
    }
    __syncthreads();

    // s and dO . c_kv of row rr + lane against the warp's 4 keys
    float s[kPer], dp[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) s[k] = dp[k] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kR; d += 4) {
      const float4 q4 = ld4s(qj0 + d);
      const float4 o4 = ld4s(oj0 + d);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float4 k4 = ld4s(kw + k * kKStride + d);
        s[k] = dot4(q4, k4, s[k]);
        dp[k] = dot4(o4, k4, dp[k]);
      }
    }
#pragma unroll 4
    for (int d = kR; d < kDk; d += 4) {
      const float4 q4 = ld4s(qj0 + d);
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        s[k] = dot4(q4, ld4s(kw + k * kKStride + d), s[k]);
    }
    const int pj = poss[lane];
    const float l2 = l2s[lane], dlt = dls[lane];
    float p[kPer], g[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const bool vis = wk0 + k < nk && t0 + wk0 + k <= pj;
      const float pk = vis ? exp2f(fmaf(s[k], a.sc2, -l2)) : 0.f;
      p[k] = pk;
      g[k] = pk * (dp[k] - dlt) * a.scale;
    }
    // row by row: p dO + scale ds q_lat into the c_kv columns, scale ds
    // q_rope into the k_rope ones
    for (int j = 0; j < nr; ++j) {
      float pr[kPer], gj[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        pr[k] = __shfl_sync(kFull, p[k], j);
        gj[k] = __shfl_sync(kFull, g[k], j);
      }
      const float* qj = qs + j * kKStride;
      const float* oj = dos + j * kOStride;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 o4 = ld4s(oj + 4 * lane + 128 * u);
        const float4 q4 = ld4s(qj + 4 * lane + 128 * u);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          acc[k][4 * u + 0] =
              fmaf(gj[k], q4.x, fmaf(pr[k], o4.x, acc[k][4 * u + 0]));
          acc[k][4 * u + 1] =
              fmaf(gj[k], q4.y, fmaf(pr[k], o4.y, acc[k][4 * u + 1]));
          acc[k][4 * u + 2] =
              fmaf(gj[k], q4.z, fmaf(pr[k], o4.z, acc[k][4 * u + 2]));
          acc[k][4 * u + 3] =
              fmaf(gj[k], q4.w, fmaf(pr[k], o4.w, acc[k][4 * u + 3]));
        }
      }
      const float2 q2 = *reinterpret_cast<const float2*>(qj + kR + 2 * lane);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        acc[k][16] = fmaf(gj[k], q2.x, acc[k][16]);
        acc[k][17] = fmaf(gj[k], q2.y, acc[k][17]);
      }
    }
  }

  // the partial sums of every key of the tile (zero past the last key),
  // at the block's slot: its batch row's chunks, then its tile's
  float* part = a.part +
                ((long long)b * kv_chunks_before(rows, (Tk + kTile - 1) / kTile,
                                                 H) +
                 kv_chunks_before(rows, tile, H) + chunk) *
                    kPartFloats;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    float* pk = part + (wk0 + k) * kDk;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float4*>(pk + 4 * lane + 128 * u) =
          make_float4(acc[k][4 * u], acc[k][4 * u + 1], acc[k][4 * u + 2],
                      acc[k][4 * u + 3]);
    *reinterpret_cast<float2*>(pk + kR + 2 * lane) =
        make_float2(acc[k][16], acc[k][17]);
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Pass 4: dc_kv and dk_rope of a key tile of one batch row, its chunks'
// partial sums added in chunk order.  grid: (key tiles, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mla_bwd_reduce_kernel(const BwdArgs a) {
  const int rows = a.rows, H = a.H, Tk = a.Tk;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = tile * kTile;
  const int nk = min(kTile, Tk - t0);
  const int nchunks = kv_chunks(rows, tile, H);
  const float* part =
      a.part + ((long long)b * kv_chunks_before(rows, gridDim.x, H) +
                kv_chunks_before(rows, tile, H)) *
                   kPartFloats;
  for (int e = threadIdx.x; e < nk * kDk; e += kThreads) {
    float sum = 0.f;
    for (int c = 0; c < nchunks; ++c) sum += part[(long long)c * kPartFloats + e];
    const int j = e / kDk, col = e - j * kDk;
    const long long t = (long long)b * Tk + t0 + j;
    if (col < kR)
      store1(static_cast<T*>(a.dc_kv) + t * kR + col, sum);
    else
      store1(static_cast<T*>(a.dk_rope) + t * kDr + (col - kR), sum);
  }
}

// the dynamic shared memory limits of one dtype's passes, set once per
// device
template <typename T>
cudaError_t allow_smem(int device) {
  static unsigned long long done = 0;
  if (device < 64 && (done >> device & 1)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      mla_bwd_q_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kQSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mla_bwd_kv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kKvSmem);
  if (err == cudaSuccess && device < 64) done |= 1ull << device;
  return err;
}

template <typename T>
cudaError_t launch(const BwdArgs& a, const void* out, float* delta,
                   int device, cudaStream_t st) {
  cudaError_t err = allow_smem<T>(device);
  if (err != cudaSuccess) return err;
  const long long all_rows = (long long)a.B * a.rows;
  mla_bwd_delta_kernel<T><<<(unsigned)((all_rows + kWarps - 1) / kWarps),
                            kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(a.dout), delta,
      all_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long q_blocks = (long long)a.B * ((a.rows + kTile - 1) / kTile);
  mla_bwd_q_kernel<T><<<(unsigned)q_blocks, kThreads, kQSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ktiles = (a.Tk + kTile - 1) / kTile;
  const dim3 kv_grid(kv_chunks(a.rows, 0, a.H), ktiles, a.B);
  mla_bwd_kv_kernel<T><<<kv_grid, kThreads, kKvSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_bwd_reduce_kernel<T><<<dim3(ktiles, a.B), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

long long part_floats(int B, int rows, int Tk, int H) {
  return (long long)B * kv_chunks_before(rows, (Tk + kTile - 1) / kTile, H) *
         kPartFloats;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the CUDA-core passes in both).  q_lat,
// out, dout, dq_lat (B, S, H, R); q_rope, dq_rope (B, S, H, Dr); c_kv,
// dc_kv (B, Tk, R); k_rope, dk_rope (B, Tk, Dr): contiguous, of one dtype,
// 16-byte aligned; R must be 512 and Dr 64.  lse is the forward's fp32 (B,
// S, H) (read only), delta an fp32 workspace of B S H floats, part one of
// flash_attention_latent_bwd_workspace(B, S, Tk, H) floats (16-byte
// aligned).  Causal over positions 0..S-1 and 0..Tk-1, as the forward.
// Four launches on `stream` (delta, the query side, the key side's
// partial sums, their sum); returns the first CUDA error.
extern "C" int flash_attention_latent_bwd_launch(
    const void* q_lat, const void* q_rope, const void* c_kv,
    const void* k_rope, const void* out, const void* dout, const void* lse,
    void* delta, void* part, void* dq_lat, void* dq_rope, void* dc_kv,
    void* dk_rope, int B, int S, int Tk, int H, int R, int Dr, float scale,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // grids: q side B x row tiles in x; key side (chunks, key tiles, B);
  // the sum (key tiles, B)
  if (R != kR || Dr != kDr || B <= 0 || B > 65535 || S <= 0 || Tk <= 0 ||
      H <= 0 || (long long)S * H > (1ll << 30) ||
      (Tk + kTile - 1) / kTile > 65535 ||
      (long long)B * (((long long)S * H + kTile - 1) / kTile) > 0x7fffffffll ||
      lse == nullptr || delta == nullptr || part == nullptr)
    return (int)cudaErrorInvalidValue;
  if (misaligned(q_lat) || misaligned(q_rope) || misaligned(c_kv) ||
      misaligned(k_rope) || misaligned(out) || misaligned(dout) ||
      misaligned(dq_lat) || misaligned(dq_rope) || misaligned(dc_kv) ||
      misaligned(dk_rope) || misaligned(part) || (uintptr_t)lse % 4 ||
      (uintptr_t)delta % 4)
    return (int)cudaErrorMisalignedAddress;
  const BwdArgs a{q_lat,  q_rope,  c_kv,  k_rope, dout,  (const float*)lse,
                  (const float*)delta, (float*)part, dq_lat, dq_rope, dc_kv,
                  dk_rope, B, S * H, H, Tk, scale, scale * kLog2e};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(a, out, (float*)delta, device, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(a, out, (float*)delta, device, st);
  return (int)cudaErrorInvalidValue;
}

// Floats of the key side's partial sums at these shapes (the workspace
// `part` of flash_attention_latent_bwd_launch).
extern "C" long long flash_attention_latent_bwd_workspace(int B, int S,
                                                          int Tk, int H) {
  return part_floats(B, S * H, Tk, H);
}

// Dynamic shared memory bytes of a block of the query side (pass 0) or the
// key side (pass 1).
extern "C" int flash_attention_latent_bwd_smem_bytes(int pass) {
  return pass == 0 ? kQSmem : kKvSmem;
}

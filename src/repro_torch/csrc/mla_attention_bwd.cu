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
// 512 + 576 + 576) = 5 504 flops a visible (row, key) pair: 1.48e12 at
// deepseek-v3's training shape (B 4, S = T 1024, H 128; 2.69e8 visible
// pairs), 1.50 ms at the bf16 tensor-core peak and 22 ms at the fp32
// CUDA-core one.  Both sides form s and dO . c_kv (so that no sum needs an
// atomic): 7 680 flops a pair, 1.40x the five, 2.06e12 at that shape, 2.09
// ms at the bf16 peak.  Four launches:
//
// 1. delta, mla_bwd_delta_kernel<T>: dO . O, one warp a row, into an fp32
//    (B, S, H) workspace from the wrapper.  Bound by bytes.
// 2. the query side: dq_lat and dq_rope of 64 (bf16) or 32 (f32) query
//    rows a block, in the model layout's order (so at H 128 a block is
//    64 or 32 heads of one position, and at an H that is not a multiple
//    of the block's rows it spans positions: the mask is per row), walking
//    the visible keys.  Blocks run heaviest first (the last positions see
//    the most keys).
// 3. the key side: a block owns 64 (bf16) or 32 (f32) keys and walks a
//    chunk of the rows that see them (every row from position t0 on: t0 H
//    .. S H).  Key tile 0 is seen by every row (131 072 a batch row at S
//    1024, H 128) and the last by a few thousand, so one block a key tile
//    would leave the card to its heaviest blocks: a key tile's rows are cut
//    into chunks of kChunkRows (8 192, 64 positions at H 128), a block
//    each (grid: chunk, key tile, batch row; 544 blocks of at most 128
//    row tiles at B 4 in bf16, 1 088 of 256 in f32), and each block writes
//    its keys' fp32 partial sums to a workspace from the wrapper (80 MB at
//    B 4 in either dtype).
// 4. the sum, mla_bwd_reduce_kernel<T>: a block per (key tile, batch row)
//    adds its chunks' partial sums in chunk order and writes dc_kv and
//    dk_rope rounded to the storage type.  Bound by bytes.
//
// bf16: the query and key sides on the tensor cores (wgmma), with the
// operand layouts of the forward's mla_attention_wgmma_kernel
// (mla_attention.cu): a 64-row tile is wgmma.cuh's 9 pieces of 64 x 64
// bf16 in the 128-byte swizzle (piece 0 the rope part, 1..8 the latent's
// 64-column pieces), staged by 16-byte cp.async; both operands of an
// S-like product in shared memory, K-major; the sums with A (P or dS)
// from registers and B a staged tile read MN-major (the transpose bit).
// Two warpgroups a block split every product, so none runs twice:
//
// * mla_bwd_q_wgmma_kernel: one block per 64 query rows.  The rows'
//   [q_rope ; q_lat] (72 KB) and dO (64 KB) are staged once; the block
//   walks the visible 64-key tiles [k_rope ; c_kv] (72 KB).  Per tile, S =
//   Q K^T (K 576, 36 k16 steps) and dP = dO c_kv^T (K 512, 32 steps), warp-
//   group w taking keys 32 w .. 32 w + 31 (m64n32); then p = exp2(s scale
//   log2 e - lse log2 e), zero where hidden, and dS = p (dP - delta) on
//   the fp32 fragment (each thread's two rows hold their lse and delta in
//   registers; the mask runs only on a tile that crosses the diagonal or
//   the keys' end, at H 128 the block's last); dS goes to bf16 as the A
//   fragment, and the warpgroups pass each other their halves through
//   shared memory (8 KB, wgmma.cuh's exchange, as the forward passes P);
//   then dQ += dS [k_rope ; c_kv] over the 64 keys.  dQ is 64 x 576 fp32,
//   288 registers a thread for one warpgroup, so its columns are split:
//   warpgroup 0 takes c_kv's columns 0..255 and the k_rope piece (5 chains
//   of m64n64, 160 registers), warpgroup 1 c_kv's 256..511 (4, 128); a
//   piece cannot be halved under the 128-byte swizzle.  dQ is scaled on
//   the fp32 accumulator at the end.
// * mla_bwd_kv_wgmma_kernel: one block per 64 keys and chunk of rows.  The
//   keys' 9 pieces (72 KB) are staged once; per 64-row tile of [q_rope ;
//   q_lat] (72 KB) and dO (64 KB), with its 64 lse and 64 delta values
//   (4-byte copies): S^T = K Q^T and dP^T = c_kv dO^T, warpgroup w taking
//   rows 32 w .. 32 w + 31 (n32); P^T and dS^T on the fragment, each
//   thread reading its columns' lse and delta from shared memory; both go
//   to bf16 (dS^T times scale) and are exchanged (16 KB); then dC +=
//   P^T dO + scale dS^T q_lat into one accumulator and dk_rope += scale
//   dS^T q_rope, B the same row tiles read MN-major.  The accumulator is
//   split over the warpgroups by columns as dQ's.  The element mask runs
//   only where a row tile crosses the diagonal (at H 128, chunk 0 of a key
//   tile) or the rows' or keys' end.
//
// Shared memory leaves room for one stage only: the query side holds Q,
// dO, one key tile and the exchange (222 208 bytes with the 1 KB that
// aligns the base to the swizzle's period), the key side its keys, one Q
// tile, one dO tile, the exchange and the 128 lse / delta values (230 912
// of the 232 448 a block may have).  So the copies of the next tile
// overlap only the end of this one: once both warpgroups are past the
// exchange's barrier, every S-like product is done, and each warpgroup,
// as soon as its own sums are done, stages the next tile's pieces that
// its sums read (the query side: key pieces 0..4 or 5..8; the key side: Q
// pieces 0..4 and dO 0..3, or Q 5..8, dO 4..7 and lse / delta) while the
// other finishes its own.  One block of 256 threads an SM.
//
// Rounding: the products of bf16 inputs are exact in fp32 and every sum is
// fp32; P^T, dS and scale dS^T are rounded once to bf16 as A operands, dS
// formed from the fp32 p, as flash's backward (flash_attention_bwd.cu).
// One rounding meets the card's bf16 rule at every bf16 MLA_BWD row
// (tests/test_torch_mla_backward.py emulates it: at most ~0.5 of the
// allowance), so nothing is split in two halves as the forward's P is.
//
// f32: the query and key sides as fp32 FMAs on the CUDA cores,
// mla_bwd_q_kernel<float> and mla_bwd_kv_kernel<float>: a block of 8
// warps owns 32 query rows (warp w rows 4 w .. 4 w + 3), their [q_lat ;
// q_rope] and dO staged in shared memory as fp32 for the whole walk.  It
// walks the visible keys in tiles of 32 latent rows staged as fp32 (rows
// padded to 580 floats, so lanes reading 32 rows at one column hit
// different banks): lane j takes key j for the warp's 4 rows, s and dO .
// c_kv from one key load and 4 + 4 broadcast loads per 4 columns; then for
// each key the 4 rows' ds come from its lane by shuffle and each lane adds
// ds times its 18 columns of the key row (16 of c_kv, 4 lane + 128 u, and
// 2 of k_rope) to 72 accumulators.  The key side's block owns 32 keys
// (warp w keys 4 w .. 4 w + 3), staged once, and walks its chunk in tiles
// of 32 rows whose [q_lat ; q_rope], dO, lse and delta are staged; lane j
// takes row j for the warp's 4 keys, and then for each row the 4 keys' p
// and scale ds come by shuffle and each lane adds p dO + scale ds q_lat
// to its 16 c_kv columns and scale ds q_rope to its 2 k_rope columns of
// each key.  213 504 bytes (q side) and 214 528 (key side) of shared
// memory, one block an SM; the f32 peak bounds them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kR = 512;                 // latent rank: value width
constexpr int kDr = 64;                 // shared rope key width
constexpr int kDk = kR + kDr;           // key width, 576
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;               // f32: own rows or keys a block, and
                                        // the other side's rows a tile
constexpr int kPer = kTile / kWarps;    // own rows or keys a warp: 4
constexpr int kKStride = kDk + 4;       // a staged row read by 32 lanes
constexpr int kOStride = kR + 4;        // a staged dO row read by 32 lanes
constexpr int kLaneCols = kR / 32 + kDr / 32;  // 18 columns a lane owns
constexpr int kChunkRows = 8192;        // rows a key-side block walks
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// the f32 passes' dynamic shared memory
constexpr int kQSmem = (kTile * kDk + kTile * kR + kTile * kKStride) * 4;
constexpr int kKvSmem = (2 * kTile * kKStride + kTile * kOStride) * 4;

// bf16, the tensor-core passes: two warpgroups, 64 own rows or keys a
// block and 64 of the other side a tile; A-fragment words a thread passes
// on for one m64n32 product (its two k16 steps)
constexpr int kTcThreads = 256;
constexpr int kTcTile = 64;
constexpr int kXWords = 8;
// dynamic shared memory: 1 KB to align the base to the swizzle's period;
// the query side's Q (9 pieces), dO (8) and a key tile (9), then dS's
// exchange; the key side's keys (9), a Q tile (9) and a dO tile (8), then
// P^T's and dS^T's exchange and the tile's 64 lse and 64 delta values
constexpr int kQTcSmem =
    1024 + (3 * kPieces - 1) * kPiece + 2 * kXWords * 128 * 4;
constexpr int kKvTcSmem = 1024 + (3 * kPieces - 1) * kPiece +
                          2 * 2 * kXWords * 128 * 4 + 2 * kTcTile * 4;

// keys a key-side block owns, by storage type
template <typename T>
__host__ __device__ constexpr int key_tile() {
  return std::is_same_v<T, float> ? kTile : kTcTile;
}
// floats of a key-side block's partial sums
template <typename T>
__host__ __device__ constexpr int part_floats() {
  return key_tile<T>() * kDk;
}

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
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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

// The key side's row chunks of key tile `tile` (of `keys` keys): the rows
// from its first position on, kChunkRows at a time (one chunk of none
// when no row sees it, so that its sum is written as zero).
__host__ __device__ __forceinline__ int kv_chunks(int rows, int tile, int H,
                                                  int keys) {
  const long long first = (long long)tile * keys * H;
  return first >= rows ? 1 : (int)((rows - first + kChunkRows - 1) /
                                   kChunkRows);
}
// the chunks of a batch row's key tiles before `tile`
__host__ __device__ __forceinline__ long long kv_chunks_before(int rows,
                                                               int tile,
                                                               int H,
                                                               int keys) {
  long long n = 0;
  for (int j = 0; j < tile; ++j) n += kv_chunks(rows, j, H, keys);
  return n;
}
// the partial sums of block (batch row b, key tile `tile`, chunk): its
// batch row's chunks, then its tile's
__host__ __device__ __forceinline__ long long part_slot(int rows, int Tk,
                                                        int H, int keys,
                                                        int b, int tile,
                                                        int chunk) {
  return (long long)b * kv_chunks_before(rows, (Tk + keys - 1) / keys, H,
                                         keys) +
         kv_chunks_before(rows, tile, H, keys) + chunk;
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

// Pass 2 in f32: dq_lat and dq_rope of 32 query rows of one batch row.
// grid: B x row tiles, one dimension, heaviest first.
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

// Pass 3 in f32: the partial sums of dc_kv and dk_rope of 32 keys of one
// batch row over one chunk of the rows that see them.  grid: (chunks of
// key tile 0, key tiles, B); a block past its tile's chunks returns at
// once.
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
  const int nchunks = kv_chunks(rows, tile, H, kTile);
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
  float* part =
      a.part + part_slot(rows, Tk, H, kTile, b, tile, chunk) * kTile * kDk;
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

// ----------------------------------------- tensor-core passes (bf16)
// Accumulator fragments (fp32), for thread lt of a warpgroup, warp w = lt /
// 32, lane l: d[4 j + 2 half + c] holds row 16 w + l / 4 + 8 half, column
// 8 j + 2 (l % 4) + c.

// the A fragments of an m64n32 accumulator's two k16 steps, times `scale`,
// in bf16: word 4 kk + r holds row 8 (r & 1) + l / 4 (+ 16 w), columns
// 16 kk + 8 (r >> 1) + 2 (l % 4) + {0, 1}, the accumulator's d[4 j + 2
// (r & 1) + {0, 1}] with j = 2 kk + (r >> 1)
__device__ __forceinline__ void a_fragment_n32(const float (&d)[16],
                                               float scale, uint32_t* a) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      a[4 * kk + r] = bf16x2_bits(
          __floats2bfloat162_rn(d[i] * scale, d[i + 1] * scale));
    }
  }
}

// The two S-like products of a tile, both operands K-major in shared
// memory: x = A_x B_x^T over the 9 pieces (K 576) and y = A_y B_y^T over
// 8 (K 512), A 64 rows (pieces from ax, ay on), B the 32 rows from b_row
// of the pieces from bx, by on; a piece is 4 k16 steps of 32 bytes
__device__ __forceinline__ void products_n32(float (&x)[16], uint64_t ax,
                                             uint32_t bx, float (&y)[16],
                                             uint64_t ay, uint32_t by,
                                             int b_row) {
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = y[i] = 0.f;
  fence_regs(x);
  fence_regs(y);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const uint64_t bd = sw128_desc(bx + j * kPiece + b_row * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n32(x, ax + j * (kPiece >> 4) + 2 * kk, bd + 2 * kk,
                   j + kk > 0);
  }
#pragma unroll
  for (int j = 0; j < kPieces - 1; ++j) {
    const uint64_t bd = sw128_desc(by + j * kPiece + b_row * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n32(y, ay + j * (kPiece >> 4) + 2 * kk, bd + 2 * kk,
                   j + kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(x);
  fence_regs(y);
}

// acc += A B for one 64-column piece of B (at b_piece, a 64-row tile read
// MN-major: 16 rows = 2048 bytes, 128 descriptor units, a k16 step), A
// the 64 keys or rows of the tile: k16 steps 0, 1 from warpgroup 0's
// fragments, 2, 3 from warpgroup 1's
__device__ __forceinline__ void product_rs(float (&acc)[32],
                                           const uint32_t* own,
                                           const uint32_t* other,
                                           uint32_t b_piece, int wg) {
  const uint64_t bd = sw128_desc(b_piece);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    wgmma_rs(acc, own + 4 * kk, bd + 128 * (2 * wg + kk));
    wgmma_rs(acc, other + 4 * kk, bd + 128 * (2 * (wg ^ 1) + kk));
  }
}

// The 64 x 576 accumulator of a block, split by columns: warpgroup wg's
// chain u < 4 is the latent's piece 4 wg + u (tile piece 1 + 4 wg + u,
// columns 256 wg + 64 u ..), and warpgroup 0's chain 4 the rope piece
// (tile piece 0, columns kR ..).  Warpgroup 1 has no chain 4.
__device__ __forceinline__ int chains(int wg) { return wg == 0 ? 5 : 4; }
__device__ __forceinline__ int chain_piece(int wg, int u) {
  return u < 4 ? 1 + 4 * wg + u : 0;
}

// Pass 2 in bf16: dq_lat and dq_rope of 64 query rows of one batch row.
// grid: B x row tiles, one dimension, heaviest first.
__global__ void __launch_bounds__(kTcThreads, 1)
    mla_bwd_q_wgmma_kernel(const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base;                           // Q: 9 pieces
  const uint32_t sdo = sq + kPieces * kPiece;         // dO: 8
  const uint32_t sk = sdo + (kPieces - 1) * kPiece;   // a key tile: 9
  auto xw = reinterpret_cast<uint32_t(*)[kXWords][128]>(
      smem_raw + (sk + kPieces * kPiece - raw));       // dS, [wg][word][lt]

  const int tid = threadIdx.x;
  // warp-uniform, so that descriptors derived from it stay uniform
  const int wg = __shfl_sync(kFull, tid >> 7, 0);
  const int lt = tid & 127;
  const int warp = lt >> 5;
  const int lane = tid & 31;
  const int rows = a.rows, H = a.H, Tk = a.Tk;
  const int b = blockIdx.x % a.B;
  const int r0 = ((rows + kTcTile - 1) / kTcTile - 1 - blockIdx.x / a.B) *
                 kTcTile;
  const int r_last = min(r0 + kTcTile, rows) - 1;
  const int p_first = r0 / H;
  const int t_end = min(Tk, r_last / H + 1);   // keys up to the last row's
  const int ntiles = (t_end + kTcTile - 1) / kTcTile;
  const long long rb = (long long)b * rows;
  const __nv_bfloat16* ck =
      static_cast<const __nv_bfloat16*>(a.c_kv) + (long long)b * Tk * kR;
  const __nv_bfloat16* kr =
      static_cast<const __nv_bfloat16*>(a.k_rope) + (long long)b * Tk * kDr;

  // the rows' Q and dO, and key tile 0; rows and keys past the end are
  // zero-filled
  stage_latent_rows<kTcThreads>(
      sq, static_cast<const __nv_bfloat16*>(a.q_rope) + rb * kDr,
      static_cast<const __nv_bfloat16*>(a.q_lat) + rb * kR, r0, rows, tid);
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(a.dout) + rb * kR;
  for (int p = 0; p < kPieces - 1; ++p)
    stage_latent_piece<kTcThreads>(sdo + p * kPiece, nullptr, dO, r0, rows,
                                   p + 1, tid);
  stage_latent_rows<kTcThreads>(sk, kr, ck, 0, t_end, tid);
  cp_async_commit();

  // this thread's two rows: block-local index, position (a row past the
  // last takes the last row's: computed, never stored), lse in base 2 and
  // delta
  const int row0 = warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  int pos[2];
  float l2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + row0 + 8 * half;
    const bool ok = r < rows;
    pos[half] = min(r, r_last) / H;
    l2[half] = ok ? a.lse[rb + r] * kLog2e : 0.f;
    dl[half] = ok ? a.delta[rb + r] : 0.f;
  }
  const uint64_t q_desc = sw128_desc(sq);
  const uint64_t do_desc = sw128_desc(sdo);
  const int nch = chains(wg);

  float acc[5][32];
#pragma unroll
  for (int u = 0; u < 5; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    // key tile n has landed (every thread's copies)
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();

    // S and dP of the rows against keys 32 wg .. 32 wg + 31 of the tile
    float s[16], dp[16];
    products_n32(s, q_desc, sk, dp, do_desc, sk + kPiece, 32 * wg);

    // p and dS in place of dP; key t is visible to a row at position p iff
    // t <= p and t < Tk
    const int t0 = n * kTcTile;
    const bool masked = t0 + kTcTile - 1 > p_first || t0 + kTcTile > Tk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = t0 + 32 * wg + 8 * j + col + c;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 4 * j + 2 * half + c;
          float p = exp2f(fmaf(s[e], a.sc2, -l2[half]));
          if (masked && (t > pos[half] || t >= Tk)) p = 0.f;
          dp[e] = p * (dp[e] - dl[half]);
        }
      }
    }
    uint32_t own[kXWords], other[kXWords];
    a_fragment_n32(dp, 1.f, own);
    exchange(xw, own, other, wg, lt);

    // dQ += dS [k_rope ; c_kv], this warpgroup's column pieces
#pragma unroll
    for (int u = 0; u < 5; ++u) fence_regs(acc[u]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 5; ++u)
      if (u < nch)
        product_rs(acc[u], own, other, sk + chain_piece(wg, u) * kPiece, wg);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < 5; ++u) fence_regs(acc[u]);

    // both warpgroups' S and dP are done with every piece of the tile (the
    // exchange's barrier) and this one's sums with its pieces: stage the
    // next tile's
    if (n + 1 < ntiles)
      for (int u = 0; u < nch; ++u) {
        const int j = chain_piece(wg, u);
        stage_latent_piece<128>(sk + j * kPiece, kr, ck, t0 + kTcTile, t_end,
                                j, lt);
      }
    cp_async_commit();
  }
  cp_async_wait_all();

  // dq = scale dS [k_rope ; c_kv], rounded to bf16
  const float sc = a.scale;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + row0 + 8 * half;
    if (r >= rows) continue;
    __nv_bfloat16* dql =
        static_cast<__nv_bfloat16*>(a.dq_lat) + (rb + r) * kR + 256 * wg + col;
    __nv_bfloat16* dqr =
        static_cast<__nv_bfloat16*>(a.dq_rope) + (rb + r) * kDr + col;
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      if (u >= nch) continue;
      __nv_bfloat16* dst = u < 4 ? dql + 64 * u : dqr;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[u][4 * j + 2 * half] * sc,
                                  acc[u][4 * j + 2 * half + 1] * sc);
    }
  }
}

// Pass 3 in bf16: the partial sums of dc_kv and dk_rope of 64 keys of one
// batch row over one chunk of the rows that see them.  grid: (chunks of
// key tile 0, key tiles, B); a block past its tile's chunks returns at
// once.  A fragment's row is a key, its column a query row of the tile.
__global__ void __launch_bounds__(kTcThreads, 1)
    mla_bwd_kv_wgmma_kernel(const BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sk = base;                           // own keys: 9 pieces
  const uint32_t sq = sk + kPieces * kPiece;          // a Q tile: 9
  const uint32_t sdo = sq + kPieces * kPiece;         // its dO: 8
  const uint32_t sx = sdo + (kPieces - 1) * kPiece;
  auto xw = reinterpret_cast<uint32_t(*)[2 * kXWords][128]>(
      smem_raw + (sx - raw));   // P^T then scale dS^T, [wg][word][lt]
  const uint32_t sst = sx + 2 * 2 * kXWords * 128 * 4;   // 64 lse, 64 delta
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sst - raw));
  const float* dl_s = lse_s + kTcTile;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(kFull, tid >> 7, 0);
  const int lt = tid & 127;
  const int warp = lt >> 5;
  const int lane = tid & 31;
  const int rows = a.rows, H = a.H, Tk = a.Tk;
  const int b = blockIdx.z;
  const int tile = blockIdx.y;
  const int chunk = blockIdx.x;
  if (chunk >= kv_chunks(rows, tile, H, kTcTile)) return;   // the whole block
  const int t0 = tile * kTcTile;
  const long long rb = (long long)b * rows;
  // this chunk's rows: from position t0 on, kChunkRows at a time (none
  // when no row sees the keys; rows fit an int: S H <= 2^30)
  const long long first = (long long)t0 * H + (long long)chunk * kChunkRows;
  const int r_begin = first < rows ? (int)first : rows;
  const int r_end = min(r_begin + kChunkRows, rows);
  const int ntiles = (r_end - r_begin + kTcTile - 1) / kTcTile;
  const __nv_bfloat16* ql =
      static_cast<const __nv_bfloat16*>(a.q_lat) + rb * kR;
  const __nv_bfloat16* qr =
      static_cast<const __nv_bfloat16*>(a.q_rope) + rb * kDr;
  const __nv_bfloat16* dO = static_cast<const __nv_bfloat16*>(a.dout) + rb * kR;

  stage_latent_rows<kTcThreads>(
      sk, static_cast<const __nv_bfloat16*>(a.k_rope) + (long long)b * Tk * kDr,
      static_cast<const __nv_bfloat16*>(a.c_kv) + (long long)b * Tk * kR, t0,
      Tk, tid);
  const int nch = chains(wg);
  // this warpgroup's part of row tile n: the Q and dO pieces its sums
  // read (warpgroup 0: Q pieces 0..4, dO 0..3; 1: Q 5..8, dO 4..7, and the
  // tile's lse and delta)
  auto load_tile = [&](int n) {
    const int rr = r_begin + n * kTcTile;
    for (int u = 0; u < nch; ++u) {
      const int j = chain_piece(wg, u);
      stage_latent_piece<128>(sq + j * kPiece, qr, ql, rr, r_end, j, lt);
      if (u < 4)
        stage_latent_piece<128>(sdo + (j - 1) * kPiece, nullptr, dO, rr,
                                r_end, j, lt);
    }
    if (wg == 1) {
      const int i = lt & (kTcTile - 1);
      const bool ok = rr + i < r_end;
      const float* src =
          (lt < kTcTile ? a.lse : a.delta) + rb + (ok ? rr + i : 0);
      cp_async4(sst + lt * 4, src, ok);
    }
  };
  if (ntiles > 0) load_tile(0);
  cp_async_commit();

  const int key0 = warp * 16 + (lane >> 2);   // this thread's keys (of 64)
  const int col = 2 * (lane & 3);             // and first column
  const uint64_t k_desc = sw128_desc(sk);
  const float sc = a.scale;

  float acc[5][32];
#pragma unroll
  for (int u = 0; u < 5; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();

    // S^T and dP^T of the keys against rows 32 wg .. 32 wg + 31 of the tile
    float st[16], dpt[16];
    products_n32(st, k_desc, sq, dpt, k_desc + (kPiece >> 4), sdo, 32 * wg);

    // P^T in place of S^T, dS^T of dP^T.  Key t is visible to row r iff
    // t <= r / H, t < Tk and r < r_end: only a tile that crosses the
    // diagonal or either end is masked
    const int rr = r_begin + n * kTcTile;
    const bool masked = rr / H < t0 + kTcTile - 1 || t0 + kTcTile > Tk ||
                        rr + kTcTile > r_end;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = 32 * wg + 8 * j + col + c;   // the row of the tile
        const float l2 = lse_s[qi] * kLog2e;
        const float dlt = dl_s[qi];
        // the row's position; -1 past the chunk's end
        const int rpos = !masked ? 0 : rr + qi < r_end ? (rr + qi) / H : -1;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 4 * j + 2 * half + c;
          const int t = t0 + key0 + 8 * half;
          float p = exp2f(fmaf(st[e], a.sc2, -l2));
          if (masked && (t > rpos || t >= Tk)) p = 0.f;
          st[e] = p;
          dpt[e] = p * (dpt[e] - dlt);
        }
      }
    }
    uint32_t own[2 * kXWords], other[2 * kXWords];
    a_fragment_n32(st, 1.f, own);
    a_fragment_n32(dpt, sc, own + kXWords);
    exchange(xw, own, other, wg, lt);

    // dC += P^T dO + scale dS^T q_lat, dk_rope += scale dS^T q_rope: this
    // warpgroup's column pieces
#pragma unroll
    for (int u = 0; u < 5; ++u) fence_regs(acc[u]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      if (u >= nch) continue;
      const int j = chain_piece(wg, u);
      if (u < 4) product_rs(acc[u], own, other, sdo + (j - 1) * kPiece, wg);
      product_rs(acc[u], own + kXWords, other + kXWords, sq + j * kPiece, wg);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < 5; ++u) fence_regs(acc[u]);

    // every S-like product is done with the tile (the exchange's barrier),
    // and this warpgroup's sums with its pieces: stage the next tile's
    if (n + 1 < ntiles) load_tile(n + 1);
    cp_async_commit();
  }
  cp_async_wait_all();

  // the keys' partial sums (zero past the last key: masked) at the
  // block's slot; key row k, columns 0..511 c_kv's, 512..575 k_rope's
  float* part = a.part + part_slot(rows, Tk, H, kTcTile, b, tile, chunk) *
                             part_floats<__nv_bfloat16>();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* pk = part + (key0 + 8 * half) * kDk + col;
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      if (u >= nch) continue;
      float* dst = pk + (u < 4 ? 256 * wg + 64 * u : kR);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[u][4 * j + 2 * half], acc[u][4 * j + 2 * half + 1]);
    }
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
  constexpr int KT = key_tile<T>();
  constexpr int PF = part_floats<T>();
  const int rows = a.rows, H = a.H, Tk = a.Tk;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int t0 = tile * KT;
  const int nk = min(KT, Tk - t0);
  const int nchunks = kv_chunks(rows, tile, H, KT);
  const float* part = a.part + part_slot(rows, Tk, H, KT, b, tile, 0) * PF;
  for (int e = threadIdx.x; e < nk * kDk; e += kThreads) {
    float sum = 0.f;
    for (int c = 0; c < nchunks; ++c) sum += part[(long long)c * PF + e];
    const int j = e / kDk, col = e - j * kDk;
    const long long t = (long long)b * Tk + t0 + j;
    if (col < kR)
      store1(static_cast<T*>(a.dc_kv) + t * kR + col, sum);
    else
      store1(static_cast<T*>(a.dk_rope) + t * kDr + (col - kR), sum);
  }
}

// the dynamic shared memory limits of one dtype's passes, set once per
// device: f32's CUDA-core passes, bf16's tensor-core ones (one block an SM)
template <typename T>
cudaError_t allow_smem(int device) {
  static unsigned long long done = 0;
  if (device < 64 && (done >> device & 1)) return cudaSuccess;
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    err = cudaFuncSetAttribute(mla_bwd_q_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kQSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mla_bwd_kv_kernel<float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kKvSmem);
  } else {
    err = cudaFuncSetAttribute(mla_bwd_q_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kQTcSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mla_bwd_kv_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kKvTcSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mla_bwd_q_wgmma_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mla_bwd_kv_wgmma_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && device < 64) done |= 1ull << device;
  return err;
}

// f32 runs the CUDA-core query and key sides, bf16 the tensor-core ones
template <typename T>
cudaError_t launch(const BwdArgs& a, const void* out, float* delta,
                   int device, cudaStream_t st) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  constexpr int KT = key_tile<T>();
  constexpr int QT = kF32 ? kTile : kTcTile;   // query rows a block
  cudaError_t err = allow_smem<T>(device);
  if (err != cudaSuccess) return err;
  const long long all_rows = (long long)a.B * a.rows;
  mla_bwd_delta_kernel<T><<<(unsigned)((all_rows + kWarps - 1) / kWarps),
                            kThreads, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(a.dout), delta,
      all_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned q_blocks =
      (unsigned)((long long)a.B * ((a.rows + QT - 1) / QT));
  const int ktiles = (a.Tk + KT - 1) / KT;
  const dim3 kv_grid(kv_chunks(a.rows, 0, a.H, KT), ktiles, a.B);
  if constexpr (kF32) {
    mla_bwd_q_kernel<float><<<q_blocks, kThreads, kQSmem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mla_bwd_kv_kernel<float><<<kv_grid, kThreads, kKvSmem, st>>>(a);
  } else {
    mla_bwd_q_wgmma_kernel<<<q_blocks, kTcThreads, kQTcSmem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mla_bwd_kv_wgmma_kernel<<<kv_grid, kTcThreads, kKvTcSmem, st>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_bwd_reduce_kernel<T><<<dim3(ktiles, a.B), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

// the workspace of one dtype's key side: every block's partial sums
template <typename T>
long long workspace_floats(int B, int rows, int Tk, int H) {
  constexpr int KT = key_tile<T>();
  return (long long)B * kv_chunks_before(rows, (Tk + KT - 1) / KT, H, KT) *
         part_floats<T>();
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core passes), 1 = bfloat16 (the tensor-core
// query and key sides).  q_lat,
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

// Floats of the key side's partial sums at these shapes, in either dtype
// (the workspace `part` of flash_attention_latent_bwd_launch): the larger
// of the f32 passes' 32-key and the bf16 passes' 64-key blocks.
extern "C" long long flash_attention_latent_bwd_workspace(int B, int S,
                                                          int Tk, int H) {
  const long long f32 = workspace_floats<float>(B, S * H, Tk, H);
  const long long bf16 = workspace_floats<__nv_bfloat16>(B, S * H, Tk, H);
  return f32 > bf16 ? f32 : bf16;
}

// Shared memory bytes of a block (all dynamic) of the f32 query side (pass
// 0) and key side (1), the bf16 tensor-core query side (2) and key side
// (3); -1 for any other pass.
extern "C" int flash_attention_latent_bwd_smem_bytes(int pass) {
  const int bytes[] = {kQSmem, kKvSmem, kQTcSmem, kKvTcSmem};
  return pass >= 0 && pass < 4 ? bytes[pass] : -1;
}

// mla_attention: the latent (absorbed) form of multi-head latent attention,
// for prefill and for one-token decode.
//
// Replaces no Pallas kernel of its own: the reference runs MLA's attention
// in jnp, `chunked_attention` (src/repro/models/attention.py:27) called by
// `mla_attention` (:273-286) with the concatenated latent query
// [q_lat ; q_rope], one shared key head [c_kv ; k_rope] and the value head
// c_kv, while its Pallas kernels (src/repro/kernels/flash_attention/
// kernel.py:94 `flash_attention`, src/repro/kernels/decode_attention/
// kernel.py:77 `decode_attention`) fix the key width to the value width
// and the scale to D^-0.5.  These are the latent forms of those two: the
// same function as `chunked_attention` at MLA's shapes.  For batch row b,
// query row (position i, head h) and key t (positions = indices in
// prefill; the cache's kv_pos in decode):
//
//   s[t]  = (q_lat[b, i, h] . c_kv[b, t] + q_rope[b, i, h] . k_rope[b, t])
//           * scale                        (scale from the caller)
//   prefill: visible iff t <= i
//   decode:  visible iff kv_pos[b, t] >= 0 and kv_pos[b, t] <= q_pos[b]
//   out   = sum_t p[t] c_kv[b, t] / max(sum_t p[t], 1e-30),
//   p[t]  = exp(s[t] - M),  M = max(-1e4, max of the visible s)
//
// which is the reference's online softmax (masked scores -1e30, running
// max clamped at -1e4, divisor clamped at 1e-30).  Given an lse buffer,
// prefill also stores each row's lse = max(M, -1e4) + log(max(sum_t p[t],
// 1e-30)) in fp32 (B, S, H), which the backward (mla_attention_bwd.cu)
// reads to form p again; serving passes none.  R = 512 (kv_lora_rank)
// and Dr = 64 (qk_rope_head_dim), deepseek-v3's widths.  q_lat (B, S, H, R)
// and q_rope (B, S, H, Dr), or (B, H, R) and (B, H, Dr) in decode; c_kv
// (B, T, R) and k_rope (B, T, Dr); out like q_lat.  f32 or bf16 storage,
// fp32 math, output rounded to nearest in the storage type.
//
// What bounds it on an H100: operations.  All H heads share one key and
// value row, so a latent row (576 elements, 1152 bytes in bf16) feeds
// 2 (576 + 512) H flops, as key and as value for each head: 242 flops a
// byte at H 128.  At deepseek-v3's prefill (B 8, S = T 2048, H 128) that
// is 4.68e12 flops, 4.7 ms at the bf16 tensor-core peak and 70 ms at the
// fp32 CUDA-core one; its decode (B 8, T 2112) reads 19.5 MB of cache for
// 4.7e9 flops, 5.8 us of bytes.  Two kernels:
//
// * bf16, prefill and decode: mla_attention_wgmma_kernel<decode>, both
//   products on the tensor cores (below);
// * f32, prefill and decode: mla_attention_kernel<float, decode>, both
//   products as fp32 FMAs on the CUDA cores.
//
// Tensor-core prefill.  Its floor is the bf16 peak: the P V product runs
// twice (P split in two bf16 halves, below), so the tensor cores do
// (576 + 2 x 512) / (576 + 512) = 1.47x the counted work, ~6.95 ms at
// deepseek-v3's prefill.
//
// * One block of two warpgroups takes 64 query rows, the M of one wgmma:
//   rows r = i H + h in the model layout's order, as in the CUDA-core
//   kernel (at H 128 a block is 64 heads of one position; at an H that is
//   not a multiple of 64 it spans positions, so the causal mask is per
//   row).  Blocks walk the row tiles heaviest first across the batch
//   (block x: batch row x % B, row tile counted from the last).  The rows'
//   [q_rope ; q_lat] sit in shared memory for the whole block as 9 pieces
//   of 64 rows x 64 columns (8 KB each, 128-byte swizzle): 72 KB.
// * Keys come in tiles of 64 latent rows [k_rope ; c_kv], staged once as 9
//   pieces (piece 0 k_rope, 1..8 c_kv's 64-column pieces) and used as key
//   (all 9) and as value (pieces 1..8): no per-head K or V.  Keys at or
//   past the block's last position are zero-filled (cp.async src-size 0).
// * S = Q K^T is 36 k16 steps (4 a piece) with both operands in shared
//   memory, split over the keys: warpgroup w computes keys 32 w .. 32 w +
//   31 of the tile (m64n32k16), so no product runs twice.  The scale
//   (times log2 e; the softmax runs in base 2) multiplies the fp32
//   accumulator: rounding q * scale to bf16 changes 44-49% of the bf16
//   outputs against the plain version (tests/test_torch_mla.py emulates
//   it), far past the card's 1%.
// * The online softmax runs on the accumulator fragment with the
//   reference's clamps.  Each row's max over the tile needs both halves:
//   each warpgroup reduces its 32 keys in the row's quad of threads,
//   writes the row max to shared memory, and after a barrier takes the
//   other's; max is exact, so both warpgroups hold the same max, the same
//   rescale factor and the same p.  Each keeps its own part of the row
//   sum; the parts meet once, at the end.
// * O += P V on wgmma with A (P) from registers: for 16-bit inputs the fp32
//   accumulator fragment of S has the layout of A's fragment.  O is 64 x
//   512 in fp32, 256 registers a thread for one warpgroup, so the value
//   columns are split: warpgroup w owns columns 256 w .. 256 w + 255
//   (pieces 1 + 4 w .. 4 + 4 w), four m64n64k16 chains of 32 registers
//   each, 128 a thread.  Each needs p of all 64 keys: a warpgroup writes its
//   32 keys' A fragments to shared memory in fragment order (16 words a
//   thread, thread t's word k at [k][t], no bank conflict), and after a
//   barrier thread t of the other warpgroup reads them, because the
//   fragment of keys 32..63 that thread t needs is the one that thread t
//   of the other warpgroup holds for keys 0..31.  Exchanging p keeps the
//   products single: recomputing S in both warpgroups would add 36 k16
//   steps a tile, 36% more tensor work.  P is split as P = bf16(P) +
//   bf16(P - bf16(P)) and both halves go through the tensor cores: one
//   bf16 P changes 28-30% of the bf16 outputs, the split 0.13-0.16% (the
//   same emulation).  V is row-major in shared memory, MN-major for B,
//   read with the transpose bit.
// * Shared memory decides the ring.  Q is 72 KB and a tile 72 KB, so two
//   full stages and the P exchange (16 KB) pass the 227 KB a block may
//   have.  The ring is of 17 piece slots instead (139 KB; 214 KB dynamic
//   and 17 KB static in all, one block an SM): piece j of tile n sits in
//   slot (9 n + j) % 17.  At the top of tile n, once every warpgroup is
//   done with tile n - 1, pieces 0..7 of tile n + 1 are issued into the
//   slots of tile n - 1's pieces 1..8; after S of tile n (the row-max
//   barrier), piece 8 of tile n + 1 goes into the slot of tile n's k_rope
//   piece, which P V does not read.  So tile n + 1 loads while tile n is
//   computed, in 16-byte cp.async copies by all 256 threads.
// * Registers: 128 of O, 16 of S, 32 of P's two halves a thread; no spill
//   (chip_smoke.py's build phase prints the count).
//
// What may bind next: every 64-row block stages its keys from L2, about
// 40 GB a call at B 8, S = T 2048, H 128, several ms at L2 rates.  A block
// that served 128 rows from one staged tile would halve that; TMA with a
// producer warp would take the copies off the compute warps.
//
// Tensor-core decode: the same body (kDecode), the same tile, ring, split
// P and clamps.  At H 128 one token's decode is two 64-row GEMMs against
// the cache, one per 64 heads, so the prefill's tile serves it unchanged
// with the cache split over blocks:
//
// * One block per (64 heads, split, batch row): rows r = h, heads past H
//   zero-filled in Q and never stored.  Split s takes slots [s split_len,
//   min(Tk, (s + 1) split_len)), whole 64-slot tiles; slots past its end
//   are zero-filled and masked.  latent_split_plan (the wrapper) fills
//   the SMs once, one block each: 7 splits of 5 tiles at B 8, T 2112,
//   H 128, 112 blocks.
// * The mask is per slot, the same for the 64 rows: visible iff kv_pos in
//   0..q_pos.  A tile's 64 kv_pos come in its pieces' cp.async group
//   (4-byte copies) into one of two buffers, so they are in shared memory
//   at the barrier at the top of their tile.
// * With more than one split a block writes its rows' unnormalised O, the
//   base-2 max and the whole row sum (both warpgroups' parts) to `part`,
//   as the CUDA-core kernel does, and mla_decode_merge_kernel merges them;
//   a split with no visible slot leaves O 0, sum 0 and max kFloor2, which
//   the merge weighs 0.  With one split (serve's warm-up) the block writes
//   the output.
// * Its floor is bytes: the cache's 19.5 MB at B 8, T 2112 in 5.8 us
//   (6.4 us with q, out and the positions).  A block stages Q (72 KB) and
//   five 72 KB tiles through its SM's cp.async path; the merge is a second
//   launch that reads and writes the part rows (14.8 MB).
//
// CUDA-core kernel (f32 prefill and decode):
//
// * One block of 8 warps takes 64 query rows: rows are (position, head)
//   pairs in the model layout's order, row r = i H + h (so a row's q and
//   out are contiguous, and at H 128 a block holds half the heads of one
//   position).  Warp w owns rows 8 w .. 8 w + 7.  The rows' q, times
//   scale * log2(e), sits in shared memory in fp32 (147 KB); each lane
//   holds the rows' accumulators for 16 of the 512 value dims (dims
//   4 lane + 128 c, c < 4): 128 registers.
// * Keys come in tiles of NK = 32 latent rows (72 KB), staged in shared
//   memory once and used by all 64 rows: a latent row is read once for
//   its key and its value, and never as a per-head K / V.  Rows are
//   padded to 580 elements, so the lanes' reads of different rows at one
//   column hit different banks.
// * Scores: lane j takes key j of the tile for the warp's 8 rows: per 4
//   dims, one key load and 8 broadcast q loads feed 32 FMAs.  The tile's
//   masked scores are -1e30; each row's max is a warp reduction, the
//   online softmax runs in base 2 and each lane keeps its own partial sum
//   of p.
// * Values: for each key the lane takes the 8 rows' p from the key's
//   lane by shuffle, loads its 16 dims of the value row and does 128
//   FMAs.
// * Prefill walks the blocks heaviest first (the last positions see the
//   most keys) and loads only the keys up to its last row's position.
//   Decode cuts the cache into `splits` runs of whole tiles, one block
//   each per (split, 64 heads, batch row), as many as fill the card's SMs
//   once (one block an SM; 8 splits at B 8, H 128, T 2112).  Each split
//   writes its unnormalised accumulator, max and sum; a second launch
//   merges them with the same clamps (with one split the block writes
//   the output itself).  A tile with no visible slot is not loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kR = 512;               // latent rank: value width
constexpr int kDr = 64;               // shared rope key width
constexpr int kDk = kR + kDr;         // key width, 576
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 8;          // query rows per warp
constexpr int kBlockRows = kWarps * kWarpRows;  // 64
constexpr int kStride = kDk + 4;      // a staged key row, in elements
constexpr int kLaneDims = kR / 32;    // accumulator dims per row and lane
constexpr int kPart = kR + 4;         // floats per split row of `part`
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kFloor2 = -1e4f * kLog2e;  // the max clamp, base 2
constexpr float kNegInf = -1e30f;

// keys per staged tile: the CUDA-core kernel's 32 x 580 f32 (74 240
// bytes); the tensor-core kernel's 64 (9 pieces of 64 x 64 bf16).  A
// decode split is whole tiles of its type.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int keys = 32;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int keys = 64;
};

// dynamic shared memory: the rows' q in fp32, then the key tile
template <typename T>
constexpr int smem_bytes() {
  return kBlockRows * kDk * 4 + Tile<T>::keys * kStride * (int)sizeof(T);
}

__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// four consecutive f32 elements
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// an 8-byte piece as fp32: 2 f32 elements (the CUDA-core kernel runs f32
// only; bf16 runs on the tensor cores)
template <typename T>
struct Piece;
template <>
struct Piece<float> {
  static constexpr int n = 2;
  __device__ __forceinline__ static void unpack(uint2 u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
  }
};

// four fp32 values to four consecutive outputs, rounded to nearest
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b,
                                    float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

struct Args {
  const void* q_lat;   // (B, rows, R)
  const void* q_rope;  // (B, rows, Dr)
  const void* c_kv;    // (B, Tk, R)
  const void* k_rope;  // (B, Tk, Dr)
  const int* kv_pos;   // (B, Tk), decode
  const int* q_pos;    // (B,), decode
  void* out;           // (B, rows, R)
  float* part;         // (B, rows, splits, kPart), decode with splits > 1
  int rows;            // query rows per batch row: S H, or H in decode
  int H;
  int Tk;
  int split_len;       // keys per split (decode), whole tiles
  float sc2;           // scale * log2(e)
  float* lse;          // (B, rows) fp32, prefill when training; else null
};

// grid: prefill (row tiles, 1, B), walked heaviest first; decode (row
// tiles, splits, B)
template <typename T, bool kDecode>
__global__ void __launch_bounds__(kThreads, 1)
    mla_attention_kernel(const Args a) {
  constexpr int NK = Tile<T>::keys;
  constexpr int KPL = NK / 32;                  // keys per lane
  constexpr int PE = Piece<T>::n;               // elements per 8 bytes
  constexpr int QP = kDk / PE;                  // 8-byte pieces of a row
  constexpr int RP = kR / PE;                   // ... of its latent part
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [kBlockRows][kDk]
  T* ks = reinterpret_cast<T*>(smem + kBlockRows * kDk * 4);  // [NK][kStride]
  __shared__ int vis[NK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int tile = kDecode ? blockIdx.x : gridDim.x - 1 - blockIdx.x;
  const int r0 = tile * kBlockRows;
  const int split = blockIdx.y;
  const int rows = a.rows;
  const int H = a.H;
  const int Tk = a.Tk;
  const T* ql = static_cast<const T*>(a.q_lat) + (long long)b * rows * kR;
  const T* qr = static_cast<const T*>(a.q_rope) + (long long)b * rows * kDr;
  const T* ck = static_cast<const T*>(a.c_kv) + (long long)b * Tk * kR;
  const T* kr = static_cast<const T*>(a.k_rope) + (long long)b * Tk * kDr;
  const int qp = kDecode ? a.q_pos[b] : 0;

  // the block's rows of q, scaled, in fp32; zero past the last row
  for (int e = tid; e < kBlockRows * QP; e += kThreads) {
    const int i = e / QP;
    const int d = (e - i * QP) * PE;
    const int r = r0 + i;
    float x[PE];
    if (r < rows) {
      const T* src = d < kR ? ql + (long long)r * kR + d
                            : qr + (long long)r * kDr + (d - kR);
      Piece<T>::unpack(*reinterpret_cast<const uint2*>(src), x);
    } else {
#pragma unroll
      for (int u = 0; u < PE; ++u) x[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < PE; ++u) qs[i * kDk + d + u] = x[u] * a.sc2;
  }

  // this warp's rows: how many are real, and the last one's position
  const int wr0 = r0 + warp * kWarpRows;
  const int wrows = max(0, min(kWarpRows, rows - wr0));
  const int wlast = (wr0 + wrows - 1) / H;
  // the block's keys
  int t_begin = 0, t_end;
  if (kDecode) {
    t_begin = split * a.split_len;
    t_end = min(Tk, t_begin + a.split_len);
  } else {
    t_end = min(Tk, (min(r0 + kBlockRows, rows) - 1) / H + 1);
  }

  float m[kWarpRows], l[kWarpRows], o[kWarpRows][kLaneDims];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    m[i] = kFloor2;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kLaneDims; ++e) o[i][e] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += NK) {
    const int nk = min(NK, t_end - t0);
    __syncthreads();  // every warp is done with the previous tile (and q)
    if (kDecode) {
      int ok = 0;
      if (tid < NK) {
        const int p = tid < nk ? a.kv_pos[(long long)b * Tk + t0 + tid] : -1;
        ok = p >= 0 && p <= qp;
        vis[tid] = ok;
      }
      if (!__syncthreads_or(ok)) continue;  // nothing visible: not loaded
    }
    // stage the tile's latent rows [c_kv ; k_rope], zero past the end
    for (int e = tid; e < NK * QP; e += kThreads) {
      const int j = e / QP;
      const int p = e - j * QP;
      uint2 u = make_uint2(0u, 0u);
      if (j < nk) {
        const long long t = t0 + j;
        u = p < RP ? *reinterpret_cast<const uint2*>(ck + t * kR + p * PE)
                   : *reinterpret_cast<const uint2*>(kr + t * kDr +
                                                     (p - RP) * PE);
      }
      *reinterpret_cast<uint2*>(ks + j * kStride + p * PE) = u;
    }
    __syncthreads();
    // every key masked for the warp (decode's slots hold any position)
    if (wrows == 0 || (!kDecode && t0 > wlast)) continue;

    // scores of the warp's rows against keys lane + 32 kk, base 2
    float s[KPL][kWarpRows];
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk)
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) s[kk][i] = 0.f;
    const float* qw = qs + warp * kWarpRows * kDk;
#pragma unroll 2
    for (int d = 0; d < kDk; d += 4) {
      float4 kv[KPL];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk)
        kv[kk] = ld4(ks + (lane + 32 * kk) * kStride + d);
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(qw + i * kDk + d);
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          float acc = s[kk][i];
          acc = fmaf(q4.x, kv[kk].x, acc);
          acc = fmaf(q4.y, kv[kk].y, acc);
          acc = fmaf(q4.z, kv[kk].z, acc);
          acc = fmaf(q4.w, kv[kk].w, acc);
          s[kk][i] = acc;
        }
      }
    }
    // mask, then the online softmax per row
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int j = lane + 32 * kk;
      const bool key_ok = j < nk && (!kDecode || vis[j]);
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const bool ok = key_ok && i < wrows &&
                        (kDecode || t0 + j <= (wr0 + i) / H);
        if (!ok) s[kk][i] = kNegInf;
      }
    }
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      float mx = s[0][i];
#pragma unroll
      for (int kk = 1; kk < KPL; ++kk) mx = fmaxf(mx, s[kk][i]);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float mn = fmaxf(m[i], mx);  // m[i] >= the clamp already
      const float c = exp2_(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        s[kk][i] = exp2_(s[kk][i] - mn);
        ps += s[kk][i];
      }
      l[i] = l[i] * c + ps;
#pragma unroll
      for (int e = 0; e < kLaneDims; ++e) o[i][e] *= c;
    }
    // P V: key j's p from lane j % 32, the lane's 16 dims of its value row
    const T* vlane = ks + 4 * lane;
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
#pragma unroll 2
      for (int src = 0; src < 32; ++src) {
        const int j = 32 * kk + src;
        if (j >= nk) break;
        float p[kWarpRows];
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i)
          p[i] = __shfl_sync(kFull, s[kk][i], src);
        const T* vr = vlane + j * kStride;
#pragma unroll
        for (int c = 0; c < kLaneDims / 4; ++c) {
          const float4 v4 = ld4(vr + 128 * c);
#pragma unroll
          for (int i = 0; i < kWarpRows; ++i) {
            o[i][4 * c + 0] = fmaf(p[i], v4.x, o[i][4 * c + 0]);
            o[i][4 * c + 1] = fmaf(p[i], v4.y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(p[i], v4.z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(p[i], v4.w, o[i][4 * c + 3]);
          }
        }
      }
    }
  }

  // each row's sum over the lanes, then the output (or the split's part)
  const bool split_out = kDecode && gridDim.y > 1;
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (i >= wrows) continue;
    const long long r = (long long)b * rows + wr0 + i;
    if (split_out) {
      float* pr = a.part + (r * gridDim.y + split) * kPart;
#pragma unroll
      for (int c = 0; c < kLaneDims / 4; ++c)
        st4(pr + 128 * c + 4 * lane, o[i][4 * c], o[i][4 * c + 1],
            o[i][4 * c + 2], o[i][4 * c + 3]);
      if (lane == 0) {
        pr[kR] = m[i];
        pr[kR + 1] = sum;
      }
    } else {
      const float den = fmaxf(sum, 1e-30f);
      // m is the base-2 max, clamped: lse = max(M, -1e4) + log(den)
      if (!kDecode && a.lse != nullptr && lane == 0)
        a.lse[r] = m[i] * kLn2 + logf(den);
      T* orow = static_cast<T*>(a.out) + r * kR + 4 * lane;
#pragma unroll
      for (int c = 0; c < kLaneDims / 4; ++c)
        st4(orow + 128 * c, o[i][4 * c] / den, o[i][4 * c + 1] / den,
            o[i][4 * c + 2] / den, o[i][4 * c + 3] / den);
    }
  }
}

// decode's merge of the splits of one query row: 128 threads of 4 dims
template <typename T>
__global__ void __launch_bounds__(kR / 4)
    mla_decode_merge_kernel(const float* __restrict__ part,
                            T* __restrict__ out, int splits) {
  const long long r = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const float* pr = part + r * splits * kPart;
  const int d = 4 * threadIdx.x;
  float mx = kFloor2;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, pr[s * kPart + kR]);
  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float* ps = pr + s * kPart;
    const float c = exp2_(ps[kR] - mx);
    const float4 x = *reinterpret_cast<const float4*>(ps + d);
    sum = fmaf(ps[kR + 1], c, sum);
    acc.x = fmaf(x.x, c, acc.x);
    acc.y = fmaf(x.y, c, acc.y);
    acc.z = fmaf(x.z, c, acc.z);
    acc.w = fmaf(x.w, c, acc.w);
  }
  const float den = fmaxf(sum, 1e-30f);
  st4(out + r * kR + d, acc.x / den, acc.y / den, acc.z / den, acc.w / den);
}

// ------------------------------------ tensor-core prefill, decode (bf16)
constexpr int kTcThreads = 256;              // two warpgroups
// a tile is wgmma.cuh's kPieces (9) pieces of kPiece bytes: k_rope, then
// c_kv 0..7
constexpr int kSlots = 2 * kPieces - 1;      // the ring's piece slots
constexpr int kXWords = 16;                  // p words a thread passes on
// dynamic shared memory: room to align the base to 1024 bytes (the
// swizzle's period), Q's 9 pieces, the ring's 17 slots: 214 016 bytes
constexpr int kTcSmem = 1024 + kPieces * kPiece + kSlots * kPiece;

// the ring slot of piece j of key tile n
__device__ __forceinline__ int ring_slot(int n, int j) {
  return (kPieces * n + j) % kSlots;
}

// Accumulator fragments (fp32), for thread lt of a warpgroup, warp
// w = lt / 32, lane l: d[4 j + 2 half + c] holds row 16 w + l / 4 + 8 half,
// column 8 j + 2 (l % 4) + c.  grid: prefill B x row tiles, one
// dimension; decode (row tiles, splits, B).
template <bool kDecode>
__global__ void __launch_bounds__(kTcThreads, 1)
    mla_attention_wgmma_kernel(const Args a, int B) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint32_t xw[2][kXWords][128];   // p fragments, [wg][word][lt]
  __shared__ float red[2][64];               // row max over a half tile
  __shared__ float lsum[2][64];              // row sums, at the end
  __shared__ int kvs[kDecode ? 2 : 1][64];   // decode: tile n's kv_pos at n & 1
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                  // Q piece j at sq + j kPiece
  const uint32_t ring = base + kPieces * kPiece;

  const int tid = threadIdx.x;
  // broadcast from lane 0, so that the compiler knows it is warp-uniform
  // and keeps the descriptors derived from it in uniform registers
  const int wg = __shfl_sync(kFull, tid >> 7, 0);
  const int lt = tid & 127;
  const int warp = lt >> 5;
  const int lane = tid & 31;
  const int rows = a.rows, H = a.H, Tk = a.Tk;
  // the block's batch row, first query row and keys [t_begin, t_end)
  int b, r0, t_begin, t_end;
  if constexpr (kDecode) {
    b = blockIdx.z;
    r0 = blockIdx.x * 64;
    t_begin = blockIdx.y * a.split_len;
    t_end = min(Tk, t_begin + a.split_len);
  } else {
    b = blockIdx.x % B;
    r0 = ((rows + 63) / 64 - 1 - blockIdx.x / B) * 64;  // heaviest first
    t_begin = 0;
    // the last row's position: keys past it are zero-filled
    t_end = min(Tk, (min(r0 + 64, rows) - 1) / H + 1);
  }
  const int r_last = min(r0 + 64, rows) - 1;
  const int p_first = r0 / H;
  const int ntiles = (t_end - t_begin + 63) / 64;
  const __nv_bfloat16* ql =
      static_cast<const __nv_bfloat16*>(a.q_lat) + (long long)b * rows * kR;
  const __nv_bfloat16* qr =
      static_cast<const __nv_bfloat16*>(a.q_rope) + (long long)b * rows * kDr;
  const __nv_bfloat16* ck =
      static_cast<const __nv_bfloat16*>(a.c_kv) + (long long)b * Tk * kR;
  const __nv_bfloat16* kr =
      static_cast<const __nv_bfloat16*>(a.k_rope) + (long long)b * Tk * kDr;

  // Q: piece 0 q_rope's, pieces 1..8 q_lat's; rows past the last are
  // zero-filled
  stage_latent_rows<kTcThreads>(sq, qr, ql, r0, rows, tid);
  // piece j of key tile n: 64 keys x 8 chunks, 2 copies a thread
  auto load_piece = [&](int n, int j) {
    stage_latent_piece<kTcThreads>(ring + ring_slot(n, j) * kPiece, kr, ck,
                                   t_begin + n * 64, t_end, j, tid);
  };
  // decode: key tile n's 64 slot positions, in the cp.async group of its
  // pieces 0..7 (so they have landed by the barrier at the top of tile n);
  // buffer n & 1 was tile n - 2's, done with by then
  const int* kvp = kDecode ? a.kv_pos + (long long)b * Tk : nullptr;
  const int qp = kDecode ? a.q_pos[b] : 0;
  auto load_pos = [&](int n) {
    if constexpr (kDecode) {
      if (tid < 64) {
        const bool ok = t_begin + n * 64 + tid < t_end;
        cp_async4(smem_addr(&kvs[n & 1][tid]),
                  kvp + (ok ? t_begin + n * 64 + tid : 0), ok);
      }
    }
  };
  for (int j = 0; j < kPieces; ++j) load_piece(0, j);
  load_pos(0);
  cp_async_commit();

  // this thread's two rows (block-local) and their positions; a row past
  // the last takes the last row's position (computed, never stored)
  const int row0 = warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int pos0 = min(r0 + row0, r_last) / H;
  const int pos1 = min(r0 + row1, r_last) / H;
  const int col = 2 * (lane & 3);
  const uint64_t q_desc = sw128_desc(sq);

  float o[4][32];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[u][i] = 0.f;
  float m0 = kFloor2, m1 = kFloor2, l0 = 0.f, l1 = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    // tile n has landed, and both warpgroups are done with tile n - 1,
    // whose pieces 1..8 hold the slots of tile n + 1's pieces 0..7
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (n + 1 < ntiles) {
      for (int j = 0; j < kPieces - 1; ++j) load_piece(n + 1, j);
      load_pos(n + 1);
    }
    cp_async_commit();

    // S for this warpgroup's keys 32 wg .. 32 wg + 31 of the tile: 4 k16
    // steps (32 bytes each) a piece, its rows 32 wg .. at 4096 bytes
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPieces; ++j) {
      const uint64_t kd =
          sw128_desc(ring + ring_slot(n, j) * kPiece + wg * 32 * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n32(s, q_desc + j * (kPiece >> 4) + 2 * kk, kd + 2 * kk,
                     j + kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale (base 2) on the fp32 accumulator, then the mask.  Prefill:
    // key t is visible to a row at position p iff t <= p (and t < Tk).
    // Decode: slot t is visible to every row iff t < t_end and its
    // position is in 0..q_pos
    const int t0 = t_begin + n * 64;
    const bool masked = t0 + 63 > p_first || t0 + 63 >= Tk;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& a0 = s[4 * j + c];
        float& a1 = s[4 * j + 2 + c];
        a0 *= a.sc2;
        a1 *= a.sc2;
        const int k = 32 * wg + 8 * j + col + c;  // the key of the tile
        if constexpr (kDecode) {
          const int p = kvs[n & 1][k];
          if (t0 + k >= t_end || p < 0 || p > qp) {
            a0 = kNegInf;
            a1 = kNegInf;
          }
        } else if (masked) {
          if (t0 + k > pos0 || t0 + k >= Tk) a0 = kNegInf;
          if (t0 + k > pos1 || t0 + k >= Tk) a1 = kNegInf;
        }
        mx0 = fmaxf(mx0, a0);
        mx1 = fmaxf(mx1, a1);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    if ((lane & 3) == 0) {
      red[wg][row0] = mx0;
      red[wg][row1] = mx1;
    }
    // both halves' maxima are written, and both warpgroups' S is done:
    // tile n's k_rope piece takes tile n + 1's last piece
    __syncthreads();
    if (n + 1 < ntiles) load_piece(n + 1, kPieces - 1);
    cp_async_commit();
    // m >= the clamp already, so the new max is too
    mx0 = fmaxf(fmaxf(m0, mx0), red[wg ^ 1][row0]);
    mx1 = fmaxf(fmaxf(m1, mx1), red[wg ^ 1][row1]);
    const float c0 = exp2_(m0 - mx0);
    const float c1 = exp2_(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[4 * j + c] = exp2_(s[4 * j + c] - mx0);
        s[4 * j + 2 + c] = exp2_(s[4 * j + 2 + c] - mx1);
        sum0 += s[4 * j + c];
        sum1 += s[4 * j + 2 + c];
      }
    }
    l0 = l0 * c0 + sum0;  // this thread's 8 keys of each row
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[u][4 * j] *= c0;
        o[u][4 * j + 1] *= c0;
        o[u][4 * j + 2] *= c1;
        o[u][4 * j + 3] *= c1;
      }

    // A fragment of this warpgroup's k step kk (keys 32 wg + 16 kk ..):
    // register r holds row 8 (r & 1) + l / 4 (+ 16 w), keys 16 kk +
    // 8 (r >> 1) + 2 (l % 4) + {0, 1}, the accumulator's d[4 j + 2 (r & 1)
    // + {0, 1}] with j = 2 kk + (r >> 1).  Word 4 kk + r is the hi half,
    // word 8 + 4 kk + r the lo half.
    uint32_t own[kXWords], other[kXWords];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[i], s[i + 1]);
        const float2 hf = __bfloat1622float2(hi);
        own[4 * kk + r] = bf16x2_bits(hi);
        own[8 + 4 * kk + r] =
            bf16x2_bits(__floats2bfloat162_rn(s[i] - hf.x, s[i + 1] - hf.y));
      }
    }
    exchange(xw, own, other, wg, lt);

    // O's columns 256 wg + 64 u .. from value piece 1 + 4 wg + u; 16 keys
    // are 2048 bytes of a piece, 128 descriptor units
#pragma unroll
    for (int u = 0; u < 4; ++u) fence_regs(o[u]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint64_t vd =
          sw128_desc(ring + ring_slot(n, 1 + 4 * wg + u) * kPiece);
      const uint64_t v_own = vd + 128 * 2 * wg;
      const uint64_t v_other = vd + 128 * 2 * (wg ^ 1);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wgmma_rs(o[u], own + 4 * kk, v_own + 128 * kk);
        wgmma_rs(o[u], own + 8 + 4 * kk, v_own + 128 * kk);
        wgmma_rs(o[u], other + 4 * kk, v_other + 128 * kk);
        wgmma_rs(o[u], other + 8 + 4 * kk, v_other + 128 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int u = 0; u < 4; ++u) fence_regs(o[u]);
  }
  cp_async_wait_all();

  // each row's sum: the quad's, then the other warpgroup's half
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  if ((lane & 3) == 0) {
    lsum[wg][row0] = l0;
    lsum[wg][row1] = l1;
  }
  __syncthreads();
  l0 += lsum[wg ^ 1][row0];
  l1 += lsum[wg ^ 1][row1];
  const bool ok0 = r0 + row0 < rows, ok1 = r0 + row1 < rows;
  if (kDecode && gridDim.y > 1) {
    // this split's unnormalised O, base-2 max and row sum, in the layout
    // of the CUDA-core kernel's, for mla_decode_merge_kernel.  A split
    // with no visible slot leaves O 0, sum 0 and max kFloor2: weight 0.
    const long long pr = ((long long)b * rows + r0) * gridDim.y + blockIdx.y;
    float* p0 = a.part + (pr + (long long)row0 * gridDim.y) * kPart;
    float* p1 = a.part + (pr + (long long)row1 * gridDim.y) * kPart;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 256 * wg + 64 * u + 8 * j + col;
        if (ok0)
          *reinterpret_cast<float2*>(p0 + c) =
              make_float2(o[u][4 * j], o[u][4 * j + 1]);
        if (ok1)
          *reinterpret_cast<float2*>(p1 + c) =
              make_float2(o[u][4 * j + 2], o[u][4 * j + 3]);
      }
    }
    if (wg == 0 && (lane & 3) == 0) {
      if (ok0) {
        p0[kR] = m0;
        p0[kR + 1] = l0;
      }
      if (ok1) {
        p1[kR] = m1;
        p1[kR + 1] = l1;
      }
    }
    return;
  }
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  // both warpgroups hold the whole sums and the same base-2 maxima
  if (!kDecode && a.lse != nullptr && wg == 0 && (lane & 3) == 0) {
    float* lr = a.lse + (long long)b * rows + r0;
    if (ok0) lr[row0] = m0 * kLn2 + logf(den0);
    if (ok1) lr[row1] = m1 * kLn2 + logf(den1);
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) +
                      ((long long)b * rows + r0) * kR + 256 * wg + col;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * u + 8 * j;
      if (ok0)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * kR + c) =
            __floats2bfloat162_rn(o[u][4 * j] / den0, o[u][4 * j + 1] / den0);
      if (ok1)
        *reinterpret_cast<__nv_bfloat162*>(ob + row1 * kR + c) =
            __floats2bfloat162_rn(o[u][4 * j + 2] / den1,
                                  o[u][4 * j + 3] / den1);
    }
  }
}

// the dynamic shared memory limit, set once per (instance, device)
template <typename T, bool kDecode>
cudaError_t allow_smem(int device) {
  static unsigned long long done = 0;
  if (device < 64 && (done >> device & 1)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      mla_attention_kernel<T, kDecode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err == cudaSuccess && device < 64) done |= 1ull << device;
  return err;
}

// f32 prefill: the CUDA-core kernel
cudaError_t prefill_f32(const Args& a, int B, int device, cudaStream_t st) {
  cudaError_t err = allow_smem<float, false>(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.rows + kBlockRows - 1) / kBlockRows, 1, B);
  mla_attention_kernel<float, false>
      <<<grid, kThreads, smem_bytes<float>(), st>>>(a);
  return cudaGetLastError();
}

// the tensor-core kernel's shared memory, set once per (instance,
// device): one block an SM (231 680 bytes with the static arrays in
// prefill, 231 936 in decode)
template <bool kDecode>
cudaError_t allow_tc_smem(int device) {
  static unsigned long long done = 0;
  if (device < 64 && (done >> device & 1)) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      mla_attention_wgmma_kernel<kDecode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mla_attention_wgmma_kernel<kDecode>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && device < 64) done |= 1ull << device;
  return err;
}

// bf16 prefill: the tensor-core kernel
cudaError_t prefill_bf16(const Args& a, int B, int device, cudaStream_t st) {
  const cudaError_t err = allow_tc_smem<false>(device);
  if (err != cudaSuccess) return err;
  // one grid dimension: B x row tiles blocks (below 2^31 for any q that
  // fits a card: 2^31 tiles of q would be 158 TB)
  const long long blocks = (long long)B * ((a.rows + 63) / 64);
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  mla_attention_wgmma_kernel<false>
      <<<(unsigned)blocks, kTcThreads, kTcSmem, st>>>(a, B);
  return cudaGetLastError();
}

// decode: bf16 on the tensor-core kernel, f32 on the CUDA-core one, one
// block per (64 heads, split, batch row); with more than one split a
// second launch merges them
template <typename T>
cudaError_t decode(const Args& a, int B, int splits, int device,
                   cudaStream_t st) {
  const dim3 grid((a.rows + kBlockRows - 1) / kBlockRows, splits, B);
  cudaError_t err;
  if constexpr (std::is_same_v<T, float>) {
    err = allow_smem<float, true>(device);
    if (err != cudaSuccess) return err;
    mla_attention_kernel<float, true>
        <<<grid, kThreads, smem_bytes<float>(), st>>>(a);
  } else {
    err = allow_tc_smem<true>(device);
    if (err != cudaSuccess) return err;
    mla_attention_wgmma_kernel<true><<<grid, kTcThreads, kTcSmem, st>>>(a, B);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  mla_decode_merge_kernel<T><<<dim3(a.rows, B), kR / 4, 0, st>>>(
      a.part, static_cast<T*>(a.out), splits);
  return cudaGetLastError();
}

bool bad_widths(int R, int Dr) { return R != kR || Dr != kDr; }

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the
// tensor-core kernel).  q_lat (B, S, H, R), q_rope (B, S, H, Dr), c_kv
// (B, Tk, R), k_rope (B, Tk, Dr), out (B, S, H, R), all contiguous and
// 16-byte aligned; R must be 512 and Dr 64.  Causal over positions
// 0..S-1 and 0..Tk-1.  lse: null, or fp32 (B, S, H), each row's lse.
extern "C" int flash_attention_latent_launch(
    const void* q_lat, const void* q_rope, const void* c_kv,
    const void* k_rope, void* out, void* lse, int B, int S, int Tk, int H,
    int R, int Dr, float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_widths(R, Dr) || B <= 0 || B > 65535 || S <= 0 || Tk <= 0 ||
      H <= 0 || (long long)S * H > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  if (misaligned(q_lat) || misaligned(q_rope) || misaligned(c_kv) ||
      misaligned(k_rope) || misaligned(out))
    return (int)cudaErrorMisalignedAddress;
  Args a{q_lat, q_rope, c_kv, k_rope, nullptr, nullptr, out, nullptr,
         S * H, H, Tk, 0, scale * kLog2e, static_cast<float*>(lse)};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)prefill_f32(a, B, device, st);
  if (dtype == 1) return (int)prefill_bf16(a, B, device, st);
  return (int)cudaErrorInvalidValue;
}

// One token a batch row: q_lat (B, H, R), q_rope (B, H, Dr) over the cache
// c_kv (B, Tk, R), k_rope (B, Tk, Dr) with slot positions kv_pos (B, Tk)
// and query positions q_pos (B,), int32.  dtype as in prefill: bf16 on the
// tensor-core kernel, f32 on the CUDA-core one.  The cache is cut into
// `splits` runs of split_len slots (whole tiles of Tile<T>::keys slots,
// none empty); with more than one split, part is (B, H, splits, R + 4) f32
// scratch from the wrapper and a second launch merges the splits.
extern "C" int decode_attention_latent_launch(
    const void* q_lat, const void* q_rope, const void* c_kv,
    const void* k_rope, const void* kv_pos, const void* q_pos, void* part,
    void* out, int B, int Tk, int H, int R, int Dr, int splits,
    int split_len, float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nk = dtype == 0 ? Tile<float>::keys : Tile<__nv_bfloat16>::keys;
  if (bad_widths(R, Dr) || B <= 0 || B > 65535 || Tk <= 0 || H <= 0 ||
      splits <= 0 || splits > 65535 || split_len <= 0 || split_len % nk ||
      (long long)(splits - 1) * split_len >= Tk ||
      (long long)splits * split_len < Tk || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (misaligned(q_lat) || misaligned(q_rope) || misaligned(c_kv) ||
      misaligned(k_rope) || misaligned(out) ||
      (splits > 1 && misaligned(part)))
    return (int)cudaErrorMisalignedAddress;
  Args a{q_lat, q_rope, c_kv, k_rope, (const int*)kv_pos, (const int*)q_pos,
         out, (float*)part, H, H, Tk, split_len, scale * kLog2e};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)decode<float>(a, B, splits, device, st);
  if (dtype == 1) return (int)decode<__nv_bfloat16>(a, B, splits, device, st);
  return (int)cudaErrorInvalidValue;
}

// lockstep_peel: the dense Algorithm-5 peel of LMBR, one warp per
// (src, dest) pair over a bit-packed incidence cell.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lockstep_peel/kernel.py
// (`lockstep_peel`, body `_peel_kernel`).  Per pair g, over its (K, U) 0/1
// incidence cell, edge weights we[K], item weights nodew[U] and nvalid
// valid item slots:
//
//   cand[u] = sum_k we[k] inc[k, u] for u < nvalid, +inf otherwise
//   while benefit > 0.5 and items remain (the reference's `act`):
//     record rtot[r] = pool weight, rben[r] = alive benefit (round head)
//     j = first argmin of cand                   (ties -> lowest slot)
//     edges k alive with inc[k, j] die; benefit -= their weights;
//     cand[u] -= sum of the dying we[k] inc[k, u]; cand[j] = +inf
//     pool weight -= nodew[j]; peel[r] = j
//
// Outputs: peel (G, U) int32 (-1 after the last round), rtot / rben (G, U)
// f32 (0 after the last round).  The cell is a 0/1 incidence: a value
// above 0.5 is a pin.
//
// Exactness: the dispatcher only sends integer-valued weights whose totals
// stay below 2^24.  Every degree, benefit and pool weight is then an integer
// that f32 holds exactly, so every sum is exact in any order: the kernel
// may take the benefit drop as the peeled slot's degree (the weight of the
// alive edges that hold it, which are the edges that die) and rebuild
// rtot / rben as prefix sums over the rounds.  No tensor core and no TF32
// is used.  The values that decide the loop are computed alike in every
// thread of a pair, so control flow stays uniform whatever the inputs.
//
// What bounds it on an H100: the chain of rounds.  A peel is sequential:
// round r + 1 needs round r's degrees.  On LMBR's path the cells are small
// ((K, U) at most (256, 64) in fit-stress and (128, 256) in fit-paper,
// most often (128, 64)), few pairs share a
// launch, and the longest pair runs 29-49 rounds, so the bytes (the cell,
// read once) are no floor: the time is rounds x the latency of one round,
// which one warp runs alone.  The design keeps a round to warp instructions
// on registers:
//
// * Staging, once per launch: every warp of the block reads 32 rows x 32
//   slots of an f32 cell in coalesced loads (the next piece in flight while
//   one is packed); lane l packs slot 32 w + l's pins over the 32 rows into
//   a column word, kept in shared memory (cols[u][t], an odd stride apart,
//   so lanes reading their own slots' words do not share a bank).  A
//   (128, 64) cell is 1 KB of bits instead of 32 KB of f32.
// * Warp class (K <= 256, U <= 256): after the one block barrier, one warp
//   per pair.  Lane l holds slots l + 32 i: their degrees and column words
//   in registers; every lane holds the alive-edge words.  A round: the
//   argmin is one __reduce_min_sync over a key that packs the integer
//   degree above the 9-bit slot (the mantissa of deg + 2^23) when every
//   weight is a non-negative integer and the total is below 2^21, else two
//   (an order-preserving integer key of the f32 degree, then the slot);
//   ties go to the lowest slot either way.  The dying edges are the alive
//   bits of slot j's column words (one broadcast shared load per word);
//   every lane walks them, two a step, and subtracts each weight from its
//   own slots whose column word holds the edge.  Each edge dies once, so a
//   pair's walks total at most K edges.  The round's slot and benefit drop
//   stay in the lane that owns the round and are written, with the prefix
//   sums, after the loop: no global access inside it.
// * Global class (any other cell the dispatcher admits, u2 k2 <= 2^22,
//   e.g. K 8192 with U 512): one block of 8 warps per pair; row words
//   (rows[w][k], by ballot) and column words, degrees, alive words and the
//   dying-edge list in global scratch the wrapper allocates (they stay in
//   the 50 MB L2), three block barriers per round.  LMBR's fit-stress path
//   does not reach it.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxK = 256;  // 8 alive words in every lane
constexpr int kWarpMaxU = 256;  // 8 slots per lane: 8 x 8 column words
constexpr int kSmemCap = 48 * 1024;  // a block's shared memory, no opt-in
constexpr int kMaxDevices = 64;
constexpr float kPackedMax = 2097152.0f;  // 2^21: degree << 9 | slot fits

__host__ __device__ inline int words(int n) { return (n + 31) >> 5; }

// Words between two slots' column words: odd, so that lanes reading
// consecutive slots' words hit distinct banks.
__host__ __device__ inline int col_stride(int K) { return words(K) | 1; }

// 32-bit words of column words: col_stride(K) per slot.
__host__ __device__ inline long long col_words(int K, int U) {
  return (long long)U * col_stride(K);
}

// Shared-memory words of one pair in the warp class: we, nodew, the column
// words.
__host__ __device__ inline long long warp_pair_words(int K, int U) {
  return (long long)K + U + col_words(K, U);
}

// An integer that orders like the f32 value (-0 as +0, since the float
// comparison ties them), so that a min over keys is the float min ...
__device__ __forceinline__ int order_key(float v) {
  int b = __float_as_int(v);
  if (v == 0.0f) b = 0;
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// ... and back.
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

__device__ __forceinline__ float warp_sum_uniform(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return __shfl_sync(kFull, x, 0);  // one value for every lane
}

// Rows 32 t .. 32 t + 31, slots 32 w .. 32 w + 31 of a cell: lane l reads
// slot 32 w + l of each row (coalesced); outside the cell reads as 0.
__device__ __forceinline__ void load_piece(float (&v)[32],
                                           const float* __restrict__ cell,
                                           int t, int w, int K, int U,
                                           int lane) {
  const int u = 32 * w + lane;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int k = 32 * t + i;
    v[i] = (k < K && u < U) ? __ldg(cell + (size_t)k * U + u) : 0.0f;
  }
}

// Pack one loaded piece into column words cols[u][t] and, with kRows, row
// words rows[w][k] (a ballot per row).
template <bool kRows>
__device__ __forceinline__ void pack_piece(const float (&v)[32],
                                           unsigned* rows, unsigned* cols,
                                           int t, int w, int K, int U,
                                           int lane) {
  unsigned col = 0u, mine = 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool pin = v[i] > 0.5f;
    if (kRows) {
      const unsigned row = __ballot_sync(kFull, pin);
      if (lane == i) mine = row;
    }
    col |= (unsigned)pin << i;
  }
  const int k = 32 * t + lane;
  if (kRows && k < K) rows[(size_t)w * K + k] = mine;
  const int u = 32 * w + lane;
  if (u < U) cols[(size_t)u * col_stride(K) + t] = col;
}

// Piece x of a batch of cells is (pair p, row group t, slot word w).
__device__ __forceinline__ void piece_of(int x, int K, int U, int& p, int& t,
                                         int& w) {
  const int nw = words(U);
  const int per = words(K) * nw;
  p = x / per;
  const int r = x - p * per;
  t = r / nw;
  w = r - t * nw;
}

// Load piece ``first`` (if < count) into ``cur``: the first loads go out
// before the caller's other set-up.
template <typename CellOf>
__device__ __forceinline__ void stage_begin(float (&cur)[32], int first,
                                            int count, int K, int U, int lane,
                                            CellOf cell_of) {
  if (first < count) {
    int p, t, w;
    piece_of(first, K, U, p, t, w);
    load_piece(cur, cell_of(p), t, w, K, U, lane);
  }
}

// Pack pieces first, first + stride, ... < count (``cur`` holds the first),
// the next piece in flight while one is packed.  ``cell_of`` / ``bits_of``
// give a pair's f32 cell and its (rows, cols) words.
template <bool kRows, typename CellOf, typename BitsOf>
__device__ __forceinline__ void stage_rest(float (&cur)[32], int first,
                                           int stride, int count, int K,
                                           int U, int lane, CellOf cell_of,
                                           BitsOf bits_of) {
  for (int x = first; x < count; x += stride) {
    float nxt[32];
    int p, t, w;
    if (x + stride < count) {
      piece_of(x + stride, K, U, p, t, w);
      load_piece(nxt, cell_of(p), t, w, K, U, lane);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) nxt[i] = 0.0f;
    }
    piece_of(x, K, U, p, t, w);
    unsigned *rows, *cols;
    bits_of(p, rows, cols);
    pack_piece<kRows>(cur, rows, cols, t, w, K, U, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) cur[i] = nxt[i];
  }
}

// Warp class: P pairs per block, every warp stages, warp p then peels pair
// blockIdx.x * P + p.  Lane l owns slots l + 32 i (i < NU >= words(U)) and
// holds their degrees and column words in registers, and every lane holds
// the NK >= words(K) alive words.  A pair's shared words: we[K], nodew[U],
// cols[U][col_stride(K)].
template <int NU, int NK>
__global__ void __launch_bounds__(kThreads)
lockstep_peel_warp_kernel(const float* __restrict__ inc,
                          const float* __restrict__ we,
                          const float* __restrict__ nodew,
                          const int* __restrict__ nvalid,
                          int* __restrict__ peel, float* __restrict__ rtot,
                          float* __restrict__ rben, int G, int K, int U,
                          int P) {
  extern __shared__ unsigned smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nk = words(K);
  const int nw = words(U);
  const int ks = col_stride(K);
  const int S = (int)warp_pair_words(K, U);
  const int o_nodew = K, o_cols = K + U;
  const int g0 = blockIdx.x * P;
  const int np = min(P, G - g0);
  const int units = np * nk * nw;
  auto cell_of = [&](int p) { return inc + ((size_t)g0 + p) * K * U; };

  float cur[32];
  stage_begin(cur, warp, units, K, U, lane, cell_of);
  const int nv = warp < np ? nvalid[g0 + warp] : 0;
  for (int p = 0; p < np; ++p) {
    unsigned* base = smem + p * S;
    const size_t g = (size_t)g0 + p;
    for (int k = tid; k < K; k += kThreads)
      base[k] = __float_as_uint(we[g * K + k]);
    for (int u = tid; u < U; u += kThreads)
      base[o_nodew + u] = __float_as_uint(nodew[g * U + u]);
  }
  stage_rest<false>(cur, warp, kWarps, units, K, U, lane, cell_of,
                    [&](int p, unsigned*& rows, unsigned*& cols) {
                      rows = nullptr;
                      cols = smem + p * S + o_cols;
                    });
  __syncthreads();  // the only block barrier: staging done
  if (warp >= np) return;

  // this pair's words: smem[B + ...]
  const int B = warp * S;
  auto wt = [&](int k) { return __uint_as_float(smem[B + k]); };
  const size_t g = (size_t)g0 + warp;
  int* pg = peel + g * U;
  float* tg = rtot + g * U;
  float* bg = rben + g * U;

  // lane l's slots l + 32 i: column words (zero for a slot beyond nvalid,
  // which no dying edge may touch) and initial degrees
  unsigned mine[NU][NK], alive[NK];
  float deg[NU];
#pragma unroll
  for (int t = 0; t < NK; ++t) alive[t] = kFull;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int u = lane + 32 * i;
    const bool valid = u < U && u < nv;
    float c = 0.0f;
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      mine[i][t] = (valid && t < nk) ? smem[B + o_cols + u * ks + t] : 0u;
      unsigned cw = mine[i][t];
      while (cw) {
        c += wt(32 * t + __ffs(cw) - 1);
        cw &= cw - 1;
      }
    }
    deg[i] = valid ? c : INFINITY;
  }
  float b = 0.0f, tw = 0.0f;
  bool whole = true;  // every weight a non-negative integer
  for (int k = lane; k < K; k += 32) {
    const float w = wt(k);
    b += w;
    whole &= w >= 0.0f && w == truncf(w);
  }
  for (int u = lane; u < U; u += 32) tw += wt(o_nodew + u);
  const float ben0 = warp_sum_uniform(b);
  const float totw0 = warp_sum_uniform(tw);
  // Then every degree is an integer in [0, ben0]: below 2^21 it packs with
  // its 9-bit slot into one key (its bits are the mantissa of deg + 2^23),
  // and one min gives the first argmin.  A peeled or invalid slot then
  // holds 2^21, which packs above every degree.
  const bool packed = __all_sync(kFull, whole) && ben0 < kPackedMax;
  const float gone = packed ? kPackedMax : INFINITY;
#pragma unroll
  for (int i = 0; i < NU; ++i) deg[i] = deg[i] == INFINITY ? gone : deg[i];

  // round r = l + 32 i is kept in lane l: the slot it peels and the weight
  // of the edges that die in it
  int hj[NU];
  float hd[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    hj[i] = -1;
    hd[i] = 0.0f;
  }
  float ben = ben0;
  int nal = nv;
  int r = 0;
  for (; r < U; ++r) {
    if (!(ben > 0.5f && nal > 0)) break;  // uniform: every lane, same values

    // first argmin (ties -> lowest slot) and its degree, which is the
    // weight of the alive edges that hold j: the edges that die now
    int j;
    float drop;
    if (packed) {
      int key = INT_MAX;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const int ki = (int)((__float_as_uint(deg[i] + 8388608.0f) << 9) |
                             (unsigned)(lane + 32 * i));
        key = min(key, ki);
      }
      const int m = __reduce_min_sync(kFull, key);
      j = m & 511;
      drop = __int_as_float(0x4b000000 | (m >> 9)) - 8388608.0f;
    } else {
      float bv = deg[0];
      int bi = lane;
#pragma unroll
      for (int i = 1; i < NU; ++i) {
        if (deg[i] < bv) {
          bv = deg[i];
          bi = lane + 32 * i;
        }
      }
      const int key = order_key(bv);
      const int mkey = __reduce_min_sync(kFull, key);
      j = __reduce_min_sync(kFull, key == mkey ? bi : INT_MAX);
      drop = key_value(mkey);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {  // selects, not a branch
      const bool here = (r >> 5) == i && lane == (r & 31);
      hj[i] = here ? j : hj[i];
      hd[i] = here ? drop : hd[i];
    }

    // the alive edges that hold j die: every lane walks the same dying
    // edges (two a step) and subtracts each one's weight from its own
    // slots that the edge holds
    unsigned cj[NK];
#pragma unroll
    for (int t = 0; t < NK; ++t)
      cj[t] = t < nk ? smem[B + o_cols + j * ks + t] : 0u;
    float sub[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) sub[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < NK; ++t) {
      unsigned d = alive[t] & cj[t];
      alive[t] &= ~cj[t];
      while (d) {
        const int b1 = __ffs(d) - 1;
        d &= d - 1;
        const bool two = d != 0u;
        const int b2 = two ? __ffs(d) - 1 : b1;
        d &= d - 1;
        const float w1 = wt(32 * t + b1);
        const float w2 = two ? wt(32 * t + b2) : 0.0f;
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          if ((mine[i][t] >> b1) & 1u) sub[i] += w1;
          if (two && ((mine[i][t] >> b2) & 1u)) sub[i] += w2;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      deg[i] = (lane + 32 * i == j) ? gone : deg[i] - sub[i];
    }
    ben -= drop;
    nal -= 1;
  }

  // trajectories: rben[r] = ben0 - (drops of rounds < r), rtot[r] = totw0 -
  // (nodew of the slots peeled before r), by warp scans over the rounds
  float cb = 0.0f, ct = 0.0f;  // the sums over the 32-round chunks before
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int q = lane + 32 * i;
    const float xd = hd[i];
    const float xn = hj[i] >= 0 ? wt(o_nodew + hj[i]) : 0.0f;
    float sd = xd, sn = xn;  // inclusive scans
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float yd = __shfl_up_sync(kFull, sd, off);
      const float yn = __shfl_up_sync(kFull, sn, off);
      if (lane >= off) {
        sd += yd;
        sn += yn;
      }
    }
    if (q < U) {
      const bool ran = q < r;
      pg[q] = ran ? hj[i] : -1;
      tg[q] = ran ? totw0 - (ct + (sn - xn)) : 0.0f;
      bg[q] = ran ? ben0 - (cb + (sd - xd)) : 0.0f;
    }
    cb += __shfl_sync(kFull, sd, 31);
    ct += __shfl_sync(kFull, sn, 31);
  }
}

// Global-scratch words of one pair: cand[U], alive[nk], the dying list
// [K], then the bits.
__host__ __device__ inline long long global_pair_words(int K, int U) {
  return (long long)U + words(K) + K + (long long)words(U) * K +
         col_words(K, U);
}

// Global class: one block per pair; thread i owns slots i, i + 256, ... and
// alive words i, i + 256, ...
__global__ void __launch_bounds__(kThreads)
lockstep_peel_global_kernel(const float* __restrict__ inc,
                            const float* __restrict__ we,
                            const float* __restrict__ nodew,
                            const int* __restrict__ nvalid,
                            int* __restrict__ peel, float* __restrict__ rtot,
                            float* __restrict__ rben,
                            unsigned* scratch, int K, int U) {
  __shared__ int s_key[kWarps];
  __shared__ int s_slot[kWarps];
  __shared__ int s_cnt[kWarps];
  __shared__ float s_ben[kWarps];
  __shared__ float s_totw[kWarps];

  const size_t g = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nk = words(K);
  const int nw = words(U);
  const int ks = col_stride(K);
  unsigned* base = scratch + g * (size_t)global_pair_words(K, U);
  float* cand = (float*)base;
  unsigned* alive = base + U;
  int* dlist = (int*)(alive + nk);
  unsigned* rows = (unsigned*)(dlist + K);
  unsigned* cols = rows + (size_t)nw * K;
  const float* cell = inc + g * K * U;
  const float* wg = we + g * K;
  const float* ng = nodew + g * U;
  int* pg = peel + g * U;
  float* tg = rtot + g * U;
  float* bg = rben + g * U;
  const int nv = nvalid[g];

  auto cell_of = [&](int) { return cell; };
  float cur[32];
  stage_begin(cur, warp, nk * nw, K, U, lane, cell_of);
  stage_rest<true>(cur, warp, kWarps, nk * nw, K, U, lane, cell_of,
                   [&](int, unsigned*& r, unsigned*& c) {
                     r = rows;
                     c = cols;
                   });
  for (int t = tid; t < nk; t += kThreads) alive[t] = kFull;
  float b = 0.0f, tw = 0.0f;
  for (int k = tid; k < K; k += kThreads) b += wg[k];
  for (int u = tid; u < U; u += kThreads) tw += ng[u];
  b = warp_sum_uniform(b);
  tw = warp_sum_uniform(tw);
  if (lane == 0) {
    s_ben[warp] = b;
    s_totw[warp] = tw;
  }
  __syncthreads();  // bits, alive words and the partial sums are in place
  float ben = 0.0f, totw = 0.0f;
  for (int w = 0; w < kWarps; ++w) {  // same order in every thread
    ben += s_ben[w];
    totw += s_totw[w];
  }
  for (int u = tid; u < U; u += kThreads) {
    float c = 0.0f;
    for (int t = 0; t < nk; ++t) {
      unsigned cw = cols[(size_t)u * ks + t];
      while (cw) {
        c += wg[32 * t + __ffs(cw) - 1];
        cw &= cw - 1;
      }
    }
    cand[u] = u < nv ? c : INFINITY;
  }

  int nal = nv;
  int r = 0;
  for (; r < U; ++r) {
    if (!(ben > 0.5f && nal > 0)) break;  // uniform: every thread, same values

    // first argmin over the thread's own slots, then the warp, then the
    // block (ties -> lowest slot)
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int u = tid; u < U; u += kThreads) {
      const float c = cand[u];
      if (bi == INT_MAX || c < bv) {
        bv = c;
        bi = u;
      }
    }
    const int key = order_key(bv);
    const int mkey = __reduce_min_sync(kFull, key);
    const int mslot = __reduce_min_sync(kFull, key == mkey ? bi : INT_MAX);
    if (lane == 0) {
      s_key[warp] = mkey;
      s_slot[warp] = mslot;
    }
    __syncthreads();
    int jk = s_key[0], j = s_slot[0];
    for (int w = 1; w < kWarps; ++w) {
      if (s_key[w] < jk || (s_key[w] == jk && s_slot[w] < j)) {
        jk = s_key[w];
        j = s_slot[w];
      }
    }
    if (tid == 0) {
      pg[r] = j;
      tg[r] = totw;
      bg[r] = ben;
    }

    // dying edges: count, scan over the block, list them
    const unsigned* cj = cols + (size_t)j * ks;
    int cnt = 0;
    for (int t = tid; t < nk; t += kThreads) cnt += __popc(cj[t] & alive[t]);
    int incl = cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_cnt[warp] = incl;
    __syncthreads();
    int pos = incl - cnt, nd = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) pos += s_cnt[w];
      nd += s_cnt[w];
    }
    for (int t = tid; t < nk; t += kThreads) {
      unsigned d = cj[t] & alive[t];
      alive[t] &= ~d;
      while (d) {
        dlist[pos++] = 32 * t + __ffs(d) - 1;
        d &= d - 1;
      }
    }
    __syncthreads();

    float drop = 0.0f;
    for (int q = 0; q < nd; ++q) drop += wg[dlist[q]];  // same order everywhere
    for (int u = tid; u < U; u += kThreads) {
      const unsigned* ru = rows + (size_t)(u >> 5) * K;
      float s = 0.0f;
      for (int q = 0; q < nd; ++q) {
        const int k = dlist[q];
        if ((ru[k] >> (u & 31)) & 1u) s += wg[k];
      }
      cand[u] = u == j ? INFINITY : cand[u] - s;
    }
    ben -= drop;
    totw -= ng[j];
    nal -= 1;
  }
  for (int q = r + tid; q < U; q += kThreads) {
    pg[q] = -1;
    tg[q] = 0.0f;
    bg[q] = 0.0f;
  }
}

int sm_count(int device) {
  static int cached[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

template <int NU, int NK>
void launch_warp(const void* inc, const void* we, const void* nodew,
                 const void* nvalid, void* peel, void* rtot, void* rben, int G,
                 int K, int U, int P, size_t bytes, cudaStream_t s) {
  const int blocks = (G + P - 1) / P;
  lockstep_peel_warp_kernel<NU, NK><<<blocks, kThreads, bytes, s>>>(
      (const float*)inc, (const float*)we, (const float*)nodew,
      (const int*)nvalid, (int*)peel, (float*)rtot, (float*)rben, G, K, U, P);
}

template <int NU>
void launch_warp_nk(const void* inc, const void* we, const void* nodew,
                    const void* nvalid, void* peel, void* rtot, void* rben,
                    int G, int K, int U, int P, size_t bytes, cudaStream_t s) {
  const int nk = words(K);
  if (nk <= 2)
    launch_warp<NU, 2>(inc, we, nodew, nvalid, peel, rtot, rben, G, K, U, P,
                       bytes, s);
  else if (nk <= 4)
    launch_warp<NU, 4>(inc, we, nodew, nvalid, peel, rtot, rben, G, K, U, P,
                       bytes, s);
  else
    launch_warp<NU, 8>(inc, we, nodew, nvalid, peel, rtot, rben, G, K, U, P,
                       bytes, s);
}

}  // namespace

// Whether a (K, U) cell runs in the warp class (bits in shared memory);
// kernels/lockstep_peel/ops.py `uses_shared_memory` is the same test.
extern "C" int lockstep_peel_uses_shared_memory(int K, int U) {
  return K >= 0 && U >= 0 && K <= kWarpMaxK && U <= kWarpMaxU;
}

// 32-bit words of global scratch per pair that the global class needs.
extern "C" long long lockstep_peel_scratch_words(int K, int U) {
  return global_pair_words(K, U);
}

extern "C" int lockstep_peel_launch(const void* inc, const void* we,
                                    const void* nodew, const void* nvalid,
                                    void* peel, void* rtot, void* rben,
                                    void* scratch, int G, int K, int U,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || U <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (lockstep_peel_uses_shared_memory(K, U)) {
    // pairs per block: spread small batches over the SMs (every warp of a
    // block stages), at most one pair per warp and 48 KB per block
    const size_t pair_bytes = 4 * (size_t)warp_pair_words(K, U);
    const int sms = sm_count(device);
    int P = (G + sms - 1) / sms;
    P = P < 1 ? 1 : (P > kWarps ? kWarps : P);
    while (P > 1 && P * pair_bytes > (size_t)kSmemCap) --P;
    const size_t bytes = P * pair_bytes;
    const int nw = words(U);
    if (nw <= 1)
      launch_warp_nk<1>(inc, we, nodew, nvalid, peel, rtot, rben, G, K, U, P,
                        bytes, s);
    else if (nw <= 2)
      launch_warp_nk<2>(inc, we, nodew, nvalid, peel, rtot, rben, G, K, U, P,
                        bytes, s);
    else if (nw <= 4)
      launch_warp_nk<4>(inc, we, nodew, nvalid, peel, rtot, rben, G, K, U, P,
                        bytes, s);
    else
      launch_warp_nk<8>(inc, we, nodew, nvalid, peel, rtot, rben, G, K, U, P,
                        bytes, s);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    lockstep_peel_global_kernel<<<G, kThreads, 0, s>>>(
        (const float*)inc, (const float*)we, (const float*)nodew,
        (const int*)nvalid, (int*)peel, (float*)rtot, (float*)rben,
        (unsigned*)scratch, K, U);
  }
  return (int)cudaGetLastError();
}

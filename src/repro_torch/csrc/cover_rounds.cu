// cover_rounds: every greedy set-cover round of one word-count bucket, one
// warp per query.
//
// Replaces the jitted lax.while_loop `_round_loop_fn` that
// `_device_cover_rounds` runs in src/repro/core/setcover.py:338 (not a
// Pallas kernel, but the third device path of the placement pipeline).  For
// each query b of the bucket, round after round until its pins are covered:
//
//   gain[n] = sum_w popcount(codes[b, n, w] & rem[b, w])
//   p       = first argmax of gain          (ties -> lowest partition id)
//   if gain[p] == 0 while bits remain: bad[b] = 1, stop (uncoverable)
//   rem[b] &= ~codes[b, p];  ch[b, r] = p
//
// ch (B, Rmax) int32 is -1 past the query's last round; Rmax = min(N, 64 W)
// bounds the rounds because every round covers at least one pin.  A bad
// query keeps the choices of its earlier rounds.
//
// What bounds it on an H100: the latency of a chain of rounds per query.
// The bytes are B (N W 8 + W 8 + Rmax 4 + 1): at the fig9 path's (14 027,
// 35, 1) that is 6.02 MB, 0.0018 ms at 3.35 TB/s.  But a query's round
// needs the round before it, so what a query costs is one dependent load
// of its codes and then a few rounds, each as long as its own latency;
// enough queries must be in flight to hide both.  The design keeps a round
// to a few warp instructions on registers, with no block barrier anywhere:
//
// * One warp per query, 8 queries per block.  Nothing waits on another
//   query; a warp leaves as soon as its query is covered.
// * Register class (W 1, N <= 256): lane l holds rows n = l + 32 j of its
//   query in registers (RPL = 1, 2, 4 or 8 rows a lane, a template so the
//   array stays in registers), loaded with coalesced 8-byte loads (a
//   query's base, b N words, is not 16-byte aligned for odd N).  rem is one
//   warp-uniform register.  A round: each lane packs its rows' keys
//   (gain << 16) | (0xFFFF - n) and keeps the largest; one
//   __reduce_max_sync gives the winner, the lowest id among equal gains
//   (the key of a lower n is larger).  The owning lane p & 31 broadcasts
//   the chosen row with one __shfl_sync and every lane clears its bits.
//   The loop condition is warp-uniform, so no vote is needed.  Lane l
//   keeps the choice of rounds l and l + 32 (Rmax <= 64) in registers, and
//   the warp writes its query's ch row once, coalesced, after the loop.
// * Shared class (1 <= W <= 8, N W <= 2048 words, not the register class):
//   the same round over the warp's slice of dynamic shared memory, stored
//   word-major (word w of row n at w N + n) so lanes reading their rows'
//   word w read consecutive words.  rem is W warp-uniform registers (a
//   template on W); the chosen row is one broadcast read per word.  A
//   block holds as many queries (at most 8) as fit in 48 KB, so no launch
//   needs the large-shared-memory attribute.  Lane 0 stores ch[b, r] each
//   round (a store that nothing waits on); the tail is filled after.
// * Global class (any other (N, W): W > 8 or N W > 2048 words, e.g. the
//   kernel check's (256, 32)): one block per query, rows read from global
//   memory (L2) each round, rem in shared memory, block-wide reductions.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // queries per block, warp classes
constexpr int kRegMaxN = 256;        // register class: W 1, N <= 256
constexpr int kSmemMaxW = 8;         // shared class: W <= 8 ...
constexpr int kSmemMaxWords = 2048;  // ... and N W <= 2048 words (16 KB)
constexpr int kSmemCap = 48 * 1024;  // shared memory per block, warp class

// the round's key: larger gain first, then lower partition id
__device__ __forceinline__ unsigned round_key(unsigned g, int n) {
  return (g << 16) | (0xFFFFu - (unsigned)n);
}

__device__ __forceinline__ int key_partition(unsigned key) {
  return (int)(0xFFFFu - (key & 0xFFFFu));
}

template <int RPL>
__global__ void __launch_bounds__(kWarps * 32)
    cover_rounds_register_kernel(const unsigned long long* __restrict__ codes,
                                 const unsigned long long* __restrict__ rem0,
                                 int* __restrict__ ch,
                                 unsigned char* __restrict__ bad, int B,
                                 int N, int Rmax) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const unsigned long long* q = codes + b * N;
  unsigned long long c[RPL];
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int n = lane + 32 * j;
    c[j] = n < N ? q[n] : 0ULL;
  }
  unsigned long long rem = rem0[b];
  int mine0 = -1, mine1 = -1;  // this lane's rounds: lane and lane + 32
  int r = 0;
  int is_bad = 0;
  for (; r < Rmax && rem != 0ULL; ++r) {
    unsigned key = 0;
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const unsigned k = round_key(__popcll(c[j] & rem), lane + 32 * j);
      key = k > key ? k : key;
    }
    key = __reduce_max_sync(kFull, key);
    if ((key >> 16) == 0) {
      is_bad = 1;
      break;
    }
    const int p = key_partition(key);
    unsigned long long row = 0;
#pragma unroll
    for (int j = 0; j < RPL; ++j) row = (j == (p >> 5)) ? c[j] : row;
    rem &= ~__shfl_sync(kFull, row, p & 31);
    if (lane == (r & 31)) {
      if (r < 32) mine0 = p;
      else mine1 = p;
    }
  }
  int* chb = ch + b * Rmax;
  if (lane < Rmax) chb[lane] = mine0;
  if (lane + 32 < Rmax) chb[lane + 32] = mine1;
  if (lane == 0) bad[b] = (unsigned char)is_bad;
}

template <int W>
__global__ void __launch_bounds__(kWarps * 32)
    cover_rounds_shared_kernel(const unsigned long long* __restrict__ codes,
                               const unsigned long long* __restrict__ rem0,
                               int* __restrict__ ch,
                               unsigned char* __restrict__ bad, int B, int N,
                               int Rmax, int P) {
  extern __shared__ unsigned long long smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * P + warp;
  if (b >= B) return;  // the whole warp leaves together
  unsigned long long* cs = smem + (size_t)warp * N * W;  // word-major
  const unsigned long long* q = codes + b * N * W;
  for (int i = lane; i < N * W; i += 32) {
    const int n = i / W;
    cs[(i - n * W) * N + n] = q[i];
  }
  unsigned long long rem[W];
#pragma unroll
  for (int w = 0; w < W; ++w) rem[w] = rem0[b * W + w];
  __syncwarp();

  int* chb = ch + b * Rmax;
  int r = 0;
  int is_bad = 0;
  for (; r < Rmax; ++r) {
    unsigned long long any = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) any |= rem[w];
    if (any == 0ULL) break;
    unsigned key = 0;
    for (int n = lane; n < N; n += 32) {
      unsigned g = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) g += __popcll(cs[w * N + n] & rem[w]);
      const unsigned k = round_key(g, n);
      key = k > key ? k : key;
    }
    key = __reduce_max_sync(kFull, key);
    if ((key >> 16) == 0) {
      is_bad = 1;
      break;
    }
    const int p = key_partition(key);
#pragma unroll
    for (int w = 0; w < W; ++w) rem[w] &= ~cs[w * N + p];
    if (lane == 0) chb[r] = p;
  }
  for (int i = r + lane; i < Rmax; i += 32) chb[i] = -1;
  if (lane == 0) bad[b] = (unsigned char)is_bad;
}

__global__ void cover_rounds_global_kernel(
    const unsigned long long* __restrict__ codes,
    const unsigned long long* __restrict__ rem0, int* __restrict__ ch,
    unsigned char* __restrict__ bad, int N, int W, int Rmax) {
  extern __shared__ unsigned long long rem[];  // W words
  __shared__ int red_g[32];
  __shared__ int red_n[32];
  __shared__ int s_p;
  __shared__ int s_g;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;

  const unsigned long long* cd = codes + (long long)b * N * W;
  for (int w = tid; w < W; w += blockDim.x) rem[w] = rem0[(long long)b * W + w];
  __syncthreads();

  int* chb = ch + (long long)b * Rmax;
  int r = 0;
  int is_bad = 0;
  for (; r < Rmax; ++r) {
    int any = 0;
    for (int w = tid; w < W; w += blockDim.x) any |= (rem[w] != 0ULL);
    if (!__syncthreads_or(any)) break;

    // per-thread best over its partitions, ascending n: strict > keeps
    // the lowest id among equal gains
    int best_g = -1;
    int best_n = INT_MAX;
    for (int n = tid; n < N; n += blockDim.x) {
      const unsigned long long* row = cd + (long long)n * W;
      int g = 0;
      for (int w = 0; w < W; ++w) g += __popcll(row[w] & rem[w]);
      if (g > best_g) {
        best_g = g;
        best_n = n;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      int og = __shfl_down_sync(kFull, best_g, off);
      int on = __shfl_down_sync(kFull, best_n, off);
      if (og > best_g || (og == best_g && on < best_n)) {
        best_g = og;
        best_n = on;
      }
    }
    if (lane == 0) {
      red_g[warp] = best_g;
      red_n[warp] = best_n;
    }
    __syncthreads();
    if (tid == 0) {
      int g = red_g[0], n = red_n[0];
      for (int i = 1; i < nwarps; ++i) {
        if (red_g[i] > g || (red_g[i] == g && red_n[i] < n)) {
          g = red_g[i];
          n = red_n[i];
        }
      }
      s_g = g;
      s_p = n;
    }
    __syncthreads();
    const int p = s_p;
    if (s_g <= 0) {
      is_bad = 1;
      break;
    }
    const unsigned long long* sel = cd + (long long)p * W;
    for (int w = tid; w < W; w += blockDim.x) rem[w] &= ~sel[w];
    if (tid == 0) chb[r] = p;
    // the next round's __syncthreads_or orders these writes before reads
  }
  for (int i = r + tid; i < Rmax; i += blockDim.x) chb[i] = -1;
  if (tid == 0) bad[b] = (unsigned char)is_bad;
}

typedef const unsigned long long* Words;

template <int RPL>
void launch_register(Words codes, Words rem, int* ch, unsigned char* bad,
                     int B, int N, int Rmax, cudaStream_t s) {
  const int blocks = (B + kWarps - 1) / kWarps;
  cover_rounds_register_kernel<RPL><<<blocks, kWarps * 32, 0, s>>>(
      codes, rem, ch, bad, B, N, Rmax);
}

template <int W>
void launch_shared(Words codes, Words rem, int* ch, unsigned char* bad, int B,
                   int N, int Rmax, cudaStream_t s) {
  const size_t slice = (size_t)N * W * sizeof(unsigned long long);
  int P = slice ? (int)(kSmemCap / slice) : kWarps;
  P = P < 1 ? 1 : (P > kWarps ? kWarps : P);
  const int blocks = (B + P - 1) / P;
  cover_rounds_shared_kernel<W><<<blocks, P * 32, P * slice, s>>>(
      codes, rem, ch, bad, B, N, Rmax, P);
}

}  // namespace

// The class a bucket's (N, W) runs in: 0 register, 1 shared, 2 global.
// kernels/cover_rounds/ops.py `rounds_class` is the same test.
extern "C" int cover_rounds_class(int N, int W) {
  if (W == 1 && N >= 0 && N <= kRegMaxN) return 0;
  if (W >= 1 && W <= kSmemMaxW && N >= 0 &&
      (long long)N * W <= kSmemMaxWords)
    return 1;
  return 2;
}

extern "C" int cover_rounds_launch(const void* codes, const void* rem, void* ch,
                                   void* bad, int B, int N, int W, int Rmax,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  Words c = (Words)codes;
  Words r = (Words)rem;
  int* o = (int*)ch;
  unsigned char* f = (unsigned char*)bad;
  switch (cover_rounds_class(N, W)) {
    case 0:
      if (N <= 32) launch_register<1>(c, r, o, f, B, N, Rmax, s);
      else if (N <= 64) launch_register<2>(c, r, o, f, B, N, Rmax, s);
      else if (N <= 128) launch_register<4>(c, r, o, f, B, N, Rmax, s);
      else launch_register<8>(c, r, o, f, B, N, Rmax, s);
      break;
    case 1:
      switch (W) {
        case 1: launch_shared<1>(c, r, o, f, B, N, Rmax, s); break;
        case 2: launch_shared<2>(c, r, o, f, B, N, Rmax, s); break;
        case 3: launch_shared<3>(c, r, o, f, B, N, Rmax, s); break;
        case 4: launch_shared<4>(c, r, o, f, B, N, Rmax, s); break;
        case 5: launch_shared<5>(c, r, o, f, B, N, Rmax, s); break;
        case 6: launch_shared<6>(c, r, o, f, B, N, Rmax, s); break;
        case 7: launch_shared<7>(c, r, o, f, B, N, Rmax, s); break;
        default: launch_shared<8>(c, r, o, f, B, N, Rmax, s); break;
      }
      break;
    default: {
      int threads = ((N + 31) / 32) * 32;
      if (threads < 32) threads = 32;
      if (threads > 256) threads = 256;
      cover_rounds_global_kernel<<<B, threads,
                                   W * sizeof(unsigned long long), s>>>(
          c, r, o, f, N, W, Rmax);
    }
  }
  return (int)cudaGetLastError();
}

// cover_rounds: every greedy set-cover round of one word-count bucket.
//
// Replaces the jitted lax.while_loop `_round_loop_fn` that
// `_device_cover_rounds` runs in src/repro/core/setcover.py (not a Pallas
// kernel, but the third device path of the placement pipeline).  For each
// query b of the bucket, round after round until its pins are covered:
//
//   gain[n] = sum_w popcount(codes[b, n, w] & rem[b, w])
//   p       = first argmax of gain          (ties -> lowest partition id)
//   if gain[p] == 0 while bits remain: bad[b] = 1, stop (uncoverable)
//   rem[b] &= ~codes[b, p];  ch[b, r] = p
//
// ch (B, Rmax) int32 is -1 past the query's last round; Rmax = min(N, 64 W)
// bounds the rounds because every round covers at least one pin.
//
// What bounds it on an H100: bytes.  The codes are B*N*W*8 bytes and must be
// read once; ch is Rmax*B*4 bytes written.  The design keeps every round's
// re-reads out of HBM: one block per query loads the query's (N, W) codes
// into shared memory once (at most 256*8*8 = 16 KB at the pipeline's
// shapes), keeps rem in shared memory, and loops all rounds inside the
// block, so the only device-memory traffic after the load is one int32 per
// round.  Queries whose codes do not fit in the 48 KB of static-launch
// shared memory form their own size class that reads codes from global
// memory (L2) each round instead.  Rounds are data dependent (the query's
// span), so a query's block ends when its pins are covered.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kSmemCap = 48 * 1024;

template <bool kSmem>
__global__ void cover_rounds_kernel(const unsigned long long* __restrict__ codes,
                                    const unsigned long long* __restrict__ rem0,
                                    int* __restrict__ ch,
                                    unsigned char* __restrict__ bad, int N,
                                    int W, int Rmax) {
  extern __shared__ unsigned long long smem[];
  __shared__ int red_g[32];
  __shared__ int red_n[32];
  __shared__ int s_p;
  __shared__ int s_g;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;

  unsigned long long* rem = smem;  // W words
  const unsigned long long* gcodes = codes + (long long)b * N * W;
  const unsigned long long* cd;
  if (kSmem) {
    unsigned long long* sc = smem + W;
    for (int i = tid; i < N * W; i += blockDim.x) sc[i] = gcodes[i];
    cd = sc;
  } else {
    cd = gcodes;
  }
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
      int og = __shfl_down_sync(0xffffffffu, best_g, off);
      int on = __shfl_down_sync(0xffffffffu, best_n, off);
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

}  // namespace

extern "C" int cover_rounds_launch(const void* codes, const void* rem, void* ch,
                                   void* bad, int B, int N, int W, int Rmax,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    int threads = ((N + 31) / 32) * 32;
    if (threads < 32) threads = 32;
    if (threads > 256) threads = 256;
    size_t words = (size_t)W + (size_t)N * W;
    size_t bytes = words * sizeof(unsigned long long);
    cudaStream_t s = (cudaStream_t)stream;
    if (bytes <= (size_t)kSmemCap) {
      cover_rounds_kernel<true><<<B, threads, bytes, s>>>(
          (const unsigned long long*)codes, (const unsigned long long*)rem,
          (int*)ch, (unsigned char*)bad, N, W, Rmax);
    } else {
      cover_rounds_kernel<false><<<B, threads, W * sizeof(unsigned long long),
                                   s>>>(
          (const unsigned long long*)codes, (const unsigned long long*)rem,
          (int*)ch, (unsigned char*)bad, N, W, Rmax);
    }
  }
  return (int)cudaGetLastError();
}

// lockstep_peel: the dense Algorithm-5 peel of LMBR, one (src, dest) pair
// per block.
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
//     edges k alive with inc[k, j] die; benefit -= we[k] for each;
//     cand[u] -= we[k] inc[k, u] for each dying k; cand[j] = +inf
//     pool weight -= nodew[j]; peel[r] = j
//
// Outputs: peel (G, U) int32 (-1 after the last round), rtot / rben (G, U)
// f32 (0 after the last round).
//
// Exactness: the dispatcher only sends integer-valued weights whose totals
// stay below 2^24.  Every degree, benefit and pool weight is then an integer
// that f32 holds exactly, so the sums are exact in any order: the atomic
// append order of the dying-edge list, the thread split of each sum and
// the compiler's choice of fused multiply-adds cannot change a bit.  No
// tensor core and no TF32 is used.
//
// What bounds it on an H100: bytes.  The cell is up to 2^22 f32 (16 MB),
// far over the 227 KB of shared memory a block can hold, so `inc` stays in
// global memory and must be read at least once: G*K*U*4 bytes.  The design
// reads it about that often: one coalesced pass over all rows for the
// initial degrees, then one row per dying edge (each edge dies once, so
// the updates read the cell once more in total), plus one strided column
// read of inc[:, j] per round to find the dying edges.  The per-round
// state (cand[U], the alive-edge mask and the dying-edge list, 4U + 8K
// bytes) sits in shared memory when it fits in 48 KB and in global scratch
// the wrapper allocates otherwise: two size classes of one kernel.  Work of
// this design: rounds * (U + K) for the argmins and column scans, plus
// 2 K U for the degree build and updates.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kSmemCap = 48 * 1024;
constexpr int kThreads = 256;

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
lockstep_peel_kernel(const float* __restrict__ inc, const float* __restrict__ we,
                     const float* __restrict__ nodew,
                     const int* __restrict__ nvalid, int* __restrict__ peel,
                     float* __restrict__ rtot, float* __restrict__ rben,
                     float* __restrict__ scratch, int K, int U) {
  extern __shared__ float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ float s_ben;
  __shared__ float s_totw;
  __shared__ int s_j;
  __shared__ int s_nd;

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;

  float* base = kSmem ? smem : scratch + (size_t)g * ((size_t)U + 2 * (size_t)K);
  float* cand = base;
  int* ealive = (int*)(base + U);
  int* dlist = ealive + K;

  const float* I = inc + (size_t)g * K * U;
  const float* wg = we + (size_t)g * K;
  const float* nw = nodew + (size_t)g * U;
  int* pg = peel + (size_t)g * U;
  float* tg = rtot + (size_t)g * U;
  float* bg = rben + (size_t)g * U;
  const int nv = nvalid[g];

  for (int u = tid; u < U; u += kThreads) {
    float c = 0.0f;
    for (int k = 0; k < K; ++k) c += wg[k] * I[(size_t)k * U + u];
    cand[u] = u < nv ? c : INFINITY;
    pg[u] = -1;
    tg[u] = 0.0f;
    bg[u] = 0.0f;
  }
  for (int k = tid; k < K; k += kThreads) ealive[k] = 1;
  if (tid == 0) {
    float b = 0.0f, t = 0.0f;
    for (int k = 0; k < K; ++k) b += wg[k];
    for (int u = 0; u < U; ++u) t += nw[u];
    s_ben = b;
    s_totw = t;
  }
  __syncthreads();

  int nal = nv;
  for (int r = 0; r < U; ++r) {
    const float ben = s_ben;
    if (!(ben > 0.5f && nal > 0)) break;  // uniform: shared + same counter

    // first argmin over cand, ties -> lowest slot
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int u = tid; u < U; u += kThreads) {
      float c = cand[u];
      if (c < bv || (c == bv && u < bi)) {
        bv = c;
        bi = u;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, bv, off);
      int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      float v = red_v[0];
      int i = red_i[0];
      for (int w = 1; w < nwarps; ++w) {
        if (red_v[w] < v || (red_v[w] == v && red_i[w] < i)) {
          v = red_v[w];
          i = red_i[w];
        }
      }
      s_j = i;
      s_nd = 0;
      tg[r] = s_totw;
      bg[r] = ben;
      pg[r] = i;
      s_totw = s_totw - nw[i];
    }
    __syncthreads();
    const int j = s_j;

    // edges losing their pin j die this round
    for (int k = tid; k < K; k += kThreads) {
      if (ealive[k] && I[(size_t)k * U + j] > 0.5f) {
        ealive[k] = 0;
        dlist[atomicAdd(&s_nd, 1)] = k;
      }
    }
    __syncthreads();
    const int nd = s_nd;
    for (int u = tid; u < U; u += kThreads) {
      float c = cand[u];
      if (u == j) {
        c = INFINITY;
      } else {
        for (int d = 0; d < nd; ++d) {
          const int k = dlist[d];
          c -= wg[k] * I[(size_t)k * U + u];
        }
      }
      cand[u] = c;
    }
    if (tid == 0) {
      float b = ben;
      for (int d = 0; d < nd; ++d) b -= wg[dlist[d]];
      s_ben = b;
    }
    nal -= 1;
    __syncthreads();
  }
}

}  // namespace

// Bytes of per-pair state: cand[U] f32, ealive[K] and dlist[K] int32.
extern "C" long long lockstep_peel_state_bytes(int K, int U) {
  return 4LL * U + 8LL * K;
}

extern "C" int lockstep_peel_smem_cap() { return kSmemCap; }

extern "C" int lockstep_peel_launch(const void* inc, const void* we,
                                    const void* nodew, const void* nvalid,
                                    void* peel, void* rtot, void* rben,
                                    void* scratch, int G, int K, int U,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G > 0 && U > 0) {
    long long bytes = lockstep_peel_state_bytes(K, U);
    cudaStream_t s = (cudaStream_t)stream;
    if (bytes <= kSmemCap) {
      lockstep_peel_kernel<true><<<G, kThreads, (size_t)bytes, s>>>(
          (const float*)inc, (const float*)we, (const float*)nodew,
          (const int*)nvalid, (int*)peel, (float*)rtot, (float*)rben, nullptr,
          K, U);
    } else {
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      lockstep_peel_kernel<false><<<G, kThreads, 0, s>>>(
          (const float*)inc, (const float*)we, (const float*)nodew,
          (const int*)nvalid, (int*)peel, (float*)rtot, (float*)rben,
          (float*)scratch, K, U);
    }
  }
  return (int)cudaGetLastError();
}

// ssd_scan_bwd: the gradient of the Mamba2 SSD chunk scan (ssd_scan.cu).
//
// The reference trains the SSM families by differentiating `ssd_chunked`
// (src/repro/models/ssm.py) through lax.scan; its Pallas kernel
// (src/repro/kernels/ssd_scan/kernel.py) has no backward.  Given the
// forward's inputs x (B, S, H, P) f32 or bf16, dt (B, S, H), a (H,), B / C
// (B, S, N) shared by every head and h0 (B, H, P, N), its output y, and
// the gradients dy of y and dh_last of h_last (null: zeros), it writes dx
// in x's dtype and ddt, da, dB, dC and dh0 in f32.  Per (b, head) and
// chunk c of L steps, cum the in-chunk cumsum of a dt, h_c the state
// entering the chunk and g_{c+1} the gradient of the state leaving it:
//
//   g_c    = exp(cum[L-1]) g_{c+1} + sum_t exp(cum[t]) dy[t] C[t]^T
//   dxh[u] = sum_{t>=u} (C[t].B[u]) e^{cum[t]-cum[u]} dy[t]
//          + e^{cum[L-1]-cum[u]} g_{c+1} B[u],           dx[u] = dt[u] dxh[u]
//   dC[t]  = sum_{u<=t} M[t][u] B[u] + sum_h e^{cum[t]} h_c^T dy[t]
//   dB[u]  = sum_{t>=u} M[t][u] C[t]
//          + sum_h dt[u] e^{cum[L-1]-cum[u]} g_{c+1}^T x[u]
//   M[t][u] = sum_h e^{cum[t]-cum[u]} dt[u] (dy[t].x[u])      (u <= t)
//   dcum[t] = dy[t].y[t] - x[t].dx[t] (+ <g_{c+1}, h_{c+1}> at t = L-1)
//   ddt[u] = x[u].dxh[u] + a r[u],  da = sum dt[u] r[u],
//   r[u]   = sum_{t>=u} dcum[t]
//
// with dh0 = g_0 and g_C = dh_last.  B and C are shared by the heads, so
// dB and dC sum over them, and their triangles are taken once on the
// head-summed gated tile M.  (dcum gathers every place cum enters: y's
// own terms give dy.y, the terms that leave step u give x[u].dx[u], the
// state leaving the chunk <g, h>.  With h_{c+1} = e^{cum[L-1]} h_c + s_c
// and s_c = sum_u w[u] x[u] B[u]^T, w = dt e^{cum[L-1]-cum}, that last
// term is e^{cum[L-1]} <g, h_c> + sum_u w[u] x[u].(B g^T)[u], from what
// the gradient pass already holds.)
//
// Three launches, run at their own chunk kBwdChunk (any chunking computes
// the same function; the workspace is the wrapper's `torch.empty`):
//
//   1. state pass, one block per (direction, head, batch), which walks the
//      head's chunks: forward from h0, the chunk's own state x^T (w B) and
//      h_{c+1} = e^{cum[L-1]} h_c + s_c, each h_c into its slot; backward
//      from dh_last, dy^T (exp(cum) C) and g_c likewise, each g_{c+1} into
//      its slot, and dh0 = g_0.  The state stays in registers.
//   2. gradient pass, one block of 16 warps per (chunk, batch row), which
//      walks all its heads: B C^T once; per head the gated dy x^T summed into M
//      (registers), dxh and dx, the rank-P parts of dC and dB summed over
//      the heads in registers, the row dots for dcum, its reverse scan,
//      ddt and the chunk's share of da; after the last head the two
//      triangles M B and M^T C, and dB and dC written once.
//   3. reduction, one thread per head: da over batch and chunks.
//   No atomics: every sum is taken in a fixed order.
//
// Every product of the state and gradient passes runs on the tensor cores
// with fp32 sums (mma.sync), its f32 operands split so that no product
// loses more than ~2^-21 (one TF32 rounding does not meet the f32 check):
// split TF32 (each operand hi + lo, three m16n8k8 products) where both
// operands are f32, and, against bf16 x (exact in bf16), the other
// operand in three bf16 pieces and three m16n8k16 products (x^T (w B),
// dy x^T, x g).  The state-dependent gates are built per 16 x 8 piece
// from the accumulators.  Chunk data is staged with cp.async, the next
// chunk's (state pass) or head's (gradient pass) while the block works on
// this one; in the gradient pass x, dy and g_{c+1} have two buffers and
// h_c one, loaded once this head's dC part is done; B stays resident, C
// is staged for B C^T and again for M^T C.  Shared-memory rows are padded
// (B, C, g, h to pad8(N) + 4 or + 8 floats, x and dy to P + 8 elements) so
// that the fragment loads are free of bank conflicts.
//
// What bounds it on an H100 (data-sheet peaks) at mamba2-2.7b's training
// shape (B 8, S 1024, H 80, P 64, N 128, bf16 x): the split products are
// ~105 GFLOP of TF32 and ~73 of bf16, 0.29 ms at the tensor-core peaks,
// above ~0.5 GB of inputs and outputs (0.16 ms).  The gradient pass is one
// block an SM (229 536 bytes of shared memory at P 64, N 128 for f32 x,
// 211 104 for bf16 x), 128 blocks at B 8 x 16 chunks: one wave on 132
// SMs, 16 warps each (at most 128 registers a thread) to hide the latency
// of its dependent split products; the state pass two blocks of 8 warps
// an SM (107 072 bytes), 1 280 blocks.
//
// The domain: P in {16, 32, 64}, 1 <= N <= 128 (kernels/ssd_scan/ops.py
// `kernel_takes`); x, dy, y, B and C 16-byte aligned (the wrapper copies
// a tensor that is not).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the state and reduce passes
constexpr int kWarps = kThreads / 32;
constexpr int kGradThreads = 512;  // the gradient pass
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kBwdChunk = 64;  // the chunk every pass runs at
constexpr int kMaxState = 128;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad8(int v) { return (v + 7) & ~7; }

// ------------------------------------------------------------ helpers
// (the forward's, copied: ssd_scan.cu keeps its own)

// asynchronous copies into shared memory; cp_commit() closes a group,
// cp_wait<n>() waits until at most n of this thread's groups are pending
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away), lo = v - hi
// is exact in fp32 and the tensor cores read its top 19 bits, so
// |v - hi - lo| < 2^-21 |v|
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b for a 16 x 8 (rows) . 8 x 8 (columns) TF32 tile, fp32 sums.
// Fragments (g = lane / 4, q = lane % 4): a0 (g, q), a1 (g + 8, q),
// a2 (g, q + 4), a3 (g + 8, q + 4); b0 (k q, n g), b1 (k q + 4, n g);
// d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1).  Any
// permutation of k applied to both operands gives the same product: the
// "permuted" loads below take k slot q <-> k0 + 2q, slot q + 4 <-> k0 +
// 2q + 1, so that a lane reads two neighbours.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// split-TF32 product: d += a b with a and b given hi and lo
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// the four A values of a split-TF32 product, split
__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) split(v[r], hi[r], lo[r]);
}

// b = (v0, v1) split, then d += a b
__device__ __forceinline__ void mma3b(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float v0,
                                      float v1) {
  uint32_t bh[2], bl[2];
  split(v0, bh[0], bl[0]);
  split(v1, bh[1], bl[1]);
  mma3(d, ah, al, bh, bl);
}

// (lo, hi) rounded to bf16 and packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// (v0, v1) = p0 + p1 + p2, three packed bf16 pairs, each the rounding of
// what the ones before leave; |v - p0 - p1 - p2| <= 2^-26 |v|
__device__ __forceinline__ void split3(float v0, float v1,
                                       uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pack_bf16(v0, v1);
    v0 -= __uint_as_float(p[i] << 16);
    v1 -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

// d += a b for a 16 x 16 (rows) . 16 x 8 (columns) bf16 tile, fp32 sums.
// Fragments (pairs of consecutive k, low half first): a0 (g, 2q), a1
// (g + 8, 2q), a2 (g, 2q + 8), a3 (g + 8, 2q + 8); b0 (k 2q, n g), b1
// (k 2q + 8, n g); d as for the TF32 product.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with a exact in bf16 and b given as its three pieces (b0 and b1
// fragments each), the smallest first
__device__ __forceinline__ void mma_bf16x3(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b0)[3],
                                           const uint32_t (&b1)[3]) {
#pragma unroll
  for (int k = 2; k >= 0; --k) mma_bf16(d, a, b0[k], b1[k]);
}

// four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8, and gets of matrix m the pair
// (rows 2q, 2q + 1; column g) in r[m]
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// two neighbouring elements (16-bit or 32-bit aligned pair) as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(t << 16),
                     __uint_as_float(t & 0xffff0000u));
}
__device__ __forceinline__ uint32_t bits2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0,
                                       float v1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}

// f(r, k) for every row r < rows and piece k < pv (pv <= NT, the block's
// threads): thread t takes piece t % pv of rows t / pv, t / pv + NT / pv,
// ... (one division, not one per piece; threads past (NT / pv) pv idle)
template <int NT, typename F>
__device__ __forceinline__ void for_pieces(int rows, int pv, F f) {
  const int step = NT / pv;
  if ((int)threadIdx.x >= step * pv) return;
  const int k = threadIdx.x % pv;
  for (int r = threadIdx.x / pv; r < rows; r += step) f(r, k);
}

// rows r < rows_in of a row-major array of T (row stride ld elements,
// cols * sizeof(T) a multiple of 16, 16-byte aligned rows) into
// dst[r][sd], zero rows up to `rows`
template <int NT, typename T>
__device__ __forceinline__ void stage16(T* dst, int sd, const T* src,
                                        long long ld, int rows_in, int rows,
                                        int cols) {
  constexpr int E = 16 / (int)sizeof(T);  // elements per piece
  for_pieces<NT>(rows, cols / E, [&](int r, int k) {
    if (r < rows_in)
      cp16(dst + r * sd + k * E, src + r * ld + k * E);
    else
      *reinterpret_cast<uint4*>(dst + r * sd + k * E) =
          make_uint4(0, 0, 0, 0);
  });
}

// rows r < rows_in, columns n < N of a (rows, N) f32 array (row stride
// ld) into dst[r][sd], zeros elsewhere up to (rows, Np); 16-byte pieces
// when N and ld are multiples of 4 (the source then 16-byte aligned)
template <int NT>
__device__ __forceinline__ void stage_f32(float* dst, int sd,
                                          const float* src, long long ld,
                                          int rows_in, int rows, int N,
                                          int Np) {
  if ((N & 3) == 0 && (ld & 3) == 0) {
    for_pieces<NT>(rows, Np / 4, [&](int r, int k) {
      if (r < rows_in && 4 * k < N)
        cp16(dst + r * sd + 4 * k, src + r * ld + 4 * k);
      else
        *reinterpret_cast<float4*>(dst + r * sd + 4 * k) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    });
  } else {
    for_pieces<NT>(rows, Np, [&](int r, int k) {
      if (r < rows_in && k < N)
        cp4(dst + r * sd + k, src + r * ld + k);
      else
        dst[r * sd + k] = 0.f;
    });
  }
}

// (v0, v1) into columns n and n + 1 (those below N) of row r of out (rows
// of N), as one store when N is even
__device__ __forceinline__ void store_pair(float* out, int N, int r, int n,
                                           float v0, float v1) {
  if ((N & 1) == 0) {
    if (n < N) store2(out + r * N + n, v0, v1);
  } else {
    if (n < N) out[r * N + n] = v0;
    if (n + 1 < N) out[r * N + n + 1] = v1;
  }
}

// cum over the chunk's steps in warp 0: lane l holds steps 2l and 2l + 1
// (a dt, zero past Lc) and gets their cum; returns cum[Lc - 1] to every
// lane
__device__ __forceinline__ float chunk_cum(float v0, float v1, float& c0,
                                           float& c1, int Lc) {
  const int lane = threadIdx.x & 31;
  float s = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) s += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) excl = 0.f;
  c0 = excl + v0;
  c1 = c0 + v1;
  return __shfl_sync(0xffffffffu, ((Lc - 1) & 1) ? c1 : c0, (Lc - 1) >> 1);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// --------------------------------------------------------- shared memory
// Row strides: x and dy P + 8 elements; B, C, g and h pad8(N) + 4 floats
// in the gradient pass; in the state pass w B pad8(N) + 4 (bf16 x) or + 8
// (f32 x) and exp(cum) C pad8(N) + 8, for their fragment loads.

template <typename T>
__host__ __device__ constexpr int x_floats(int L, int P) {
  return L * (P + 8) * (int)sizeof(T) / 4;
}

// a chunk's buffer of the state pass: x or dy rows, then B or C rows
__host__ __device__ inline int state_buffer_floats(int P, int N) {
  const int L = kBwdChunk;
  return L * (P + 8) + L * (pad8(N) + 8);
}

int state_smem(int P, int N) {
  return (2 * state_buffer_floats(P, N) + 2 * (kBwdChunk + 8)) *
         (int)sizeof(float);
}

// the per-head buffer of the gradient pass: x, dy and g_{c+1}
template <typename T>
__host__ __device__ inline int head_floats(int P, int N) {
  const int L = kBwdChunk, SG = pad8(N) + 4;
  return x_floats<T>(L, P) + L * (P + 8) + P * SG;
}

template <typename T>
int grad_smem(int P, int N) {
  const int L = kBwdChunk, SG = pad8(N) + 4;
  return (L * SG + L * (L + 4) + 2 * head_floats<T>(P, N) + P * SG +
          12 * L + 2 * kGradWarps + 8) *
         (int)sizeof(float);
}

// ---------------------------------------------------------------- pass 1
// The chunk states and the chains, one block per (direction, head, batch)
// walking the chunks in order: forward from h0, s_c = x^T (w B) and
// h_{c+1} = e^{cum[L-1]} h_c + s_c, writing h_c to its slot; backward from
// dh_last, s'_c = dy^T (e C) and g_c = e^{cum[L-1]} g_{c+1} + s'_c,
// writing g_{c+1} to its slot, and dh0 = g_0.  The state stays in
// registers as the product's accumulators (each chunk's product starts
// from e^{cum[L-1]} times the state): warp w takes
// the 16-row tile w % (P / 16) and every (8 / (P / 16))-th 8-column tile
// from w / (P / 16) on.  The next chunk's rows load while the block works
// on this one (two buffers).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_state_kernel(const T* __restrict__ x,
                         const float* __restrict__ dy,
                         const float* __restrict__ dt,
                         const float* __restrict__ a,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         const float* __restrict__ h0,
                         const float* __restrict__ dh_last,
                         float* __restrict__ hs, float* __restrict__ gs,
                         float* __restrict__ dh0, int S, int H, int N) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int L = kBwdChunk;
  constexpr int SX = P + 8, SD = P + 8;
  constexpr int MT = P / 16;      // 16-row tiles of the state
  constexpr int NI = 2 * MT;      // 8-column tiles a warp takes, at most
  const bool rev = blockIdx.x == 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + L - 1) / L;
  const int Np = pad8(N), NTN = Np / 8;
  const int SW = Np + (kBf16 && !rev ? 4 : 8);
  const int BF = state_buffer_floats(P, N);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long bh = (long long)b * H + h;
  const long long PN = (long long)P * N;
  const float ah = a[h];

  // buffer k: x (as T) or dy rows, then B or C rows; then per buffer the
  // chunk's weights (w forward, exp(cum) backward) and its decay
  auto arows = [&](int k) { return smem + k * BF; };
  auto wrows = [&](int k) { return smem + k * BF + L * (P + 8); };
  auto wts = [&](int k) { return smem + 2 * BF + k * (L + 8); };
  auto chunk_of = [&](int i) { return rev ? nc - 1 - i : i; };
  auto stage = [&](int i, int k) {
    const int c0 = chunk_of(i) * L, Lc = min(L, S - c0);
    const long long row0 = (long long)b * S + c0;
    const long long off = row0 * H * P + (long long)h * P;
    if (rev) {
      stage16<kThreads>(arows(k), SD, dy + off, (long long)H * P, Lc, L, P);
      stage_f32<kThreads>(wrows(k), SW, cm + row0 * N, N, Lc, L, N, Np);
    } else {
      stage16<kThreads>(reinterpret_cast<T*>(arows(k)), SX, x + off,
                        (long long)H * P, Lc, L, P);
      stage_f32<kThreads>(wrows(k), SW, bm + row0 * N, N, Lc, L, N, Np);
    }
  };
  auto load_dt = [&](int i, float& d0, float& d1) {
    const int c0 = chunk_of(i) * L, Lc = min(L, S - c0);
    const long long row0 = (long long)b * S + c0;
    d0 = 2 * lane < Lc ? dt[(row0 + 2 * lane) * H + h] : 0.f;
    d1 = 2 * lane + 1 < Lc ? dt[(row0 + 2 * lane + 1) * H + h] : 0.f;
  };
  // warp 0: chunk i's weights from its dt (d0, d1) into wts(k)
  auto setup = [&](int i, int k, float d0, float d1) {
    const int Lc = min(L, S - chunk_of(i) * L);
    const int t0 = 2 * lane, t1 = t0 + 1;
    float cu0, cu1;
    const float cl = chunk_cum(ah * d0, ah * d1, cu0, cu1, Lc);
    float* w = wts(k);
    w[t0] = t0 < Lc ? (rev ? expf(cu0) : expf(cl - cu0) * d0) : 0.f;
    w[t1] = t1 < Lc ? (rev ? expf(cu1) : expf(cl - cu1) * d1) : 0.f;
    if (lane == 0) w[L] = expf(cl);
  };

  stage(0, 0);
  cp_commit();
  if (nc > 1) stage(1, 1);
  cp_commit();
  float dn0 = 0.f, dn1 = 0.f;  // warp 0: dt of the next chunk
  if (warp == 0) {
    float d0, d1;
    load_dt(0, d0, d1);
    setup(0, 0, d0, d1);
    if (nc > 1) load_dt(1, dn0, dn1);
  }

  const int mt = warp % MT;
  const int p0 = 16 * mt;
  const int nt0 = warp / MT, nstep = kWarps / MT;
  // the state entering the walk: h0, or dh_last (zeros when null)
  float st[NI][4];
  {
    const float* init = rev ? dh_last : h0;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int nt = nt0 + nstep * i;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + g + 8 * (r >> 1), n = nt * 8 + 2 * q + (r & 1);
        st[i][r] = init && nt < NTN && n < N ? init[bh * PN + p * N + n]
                                             : 0.f;
      }
    }
  }
  cp_wait<1>();
  __syncthreads();

  // chunk i's slot takes the state entering (forward) or leaving
  // (backward) it, stored as soon as it is known: the stores drain while
  // the block waits for the next chunk
  float* slots = (rev ? gs : hs) + bh * nc * PN;
  auto store_state = [&](int i) {
    float* slot = slots + (long long)chunk_of(i) * PN;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int nt = nt0 + nstep * j;
      if (nt < NTN) {
        store_pair(slot, N, p0 + g, nt * 8 + 2 * q, st[j][0], st[j][1]);
        store_pair(slot, N, p0 + g + 8, nt * 8 + 2 * q, st[j][2], st[j][3]);
      }
    }
  };
  store_state(0);
  for (int i = 0; i < nc; ++i) {
    const int k = i & 1;
    const float* w = wts(k);
    // the state steps over the chunk
    const float decay = w[L];
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[j][r] *= decay;
    float (&acc)[NI][4] = st;
    if (!rev) {
      // s = x^T (w B): rows p, k = u; w applied as B is read
      const float* ws = wrows(k);
      if constexpr (kBf16) {
        // x^T by ldmatrix (exact in bf16), w B in three bf16 pieces
        const T* xs = reinterpret_cast<const T*>(arows(k));
        const int m = lane >> 3;
        for (int u0 = 0; u0 < L; u0 += 16) {
          uint32_t ax[4];
          ldsm_x4_t(ax, xs + (u0 + (m >> 1) * 8 + (lane & 7)) * SX + p0 +
                            (m & 1) * 8);
          const float2 wa = load2(w + u0 + 2 * q);
          const float2 wb = load2(w + u0 + 2 * q + 8);
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            const int nt = nt0 + nstep * j;
            if (nt < NTN) {
              const float* wc = ws + (u0 + 2 * q) * SW + nt * 8 + g;
              uint32_t b0[3], b1[3];
              split3(wa.x * wc[0], wa.y * wc[SW], b0);
              split3(wb.x * wc[8 * SW], wb.y * wc[9 * SW], b1);
              mma_bf16x3(acc[j], ax, b0, b1);
            }
          }
        }
      } else {
        const float* xs = arows(k);
        for (int u0 = 0; u0 < L; u0 += 8) {
          const float* xr = xs + (u0 + q) * SX + p0 + g;
          const float v[4] = {xr[0], xr[8], xr[4 * SX], xr[4 * SX + 8]};
          uint32_t ah4[4], al4[4];
          split4(v, ah4, al4);
          const float wa = w[u0 + q], wb = w[u0 + q + 4];
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            const int nt = nt0 + nstep * j;
            if (nt < NTN) {
              const float* wc = ws + (u0 + q) * SW + nt * 8 + g;
              mma3b(acc[j], ah4, al4, wa * wc[0], wb * wc[4 * SW]);
            }
          }
        }
      }
    } else {
      // s' = dy^T (e C): rows p, k = t, split TF32; e applied as C is read
      const float* dys = arows(k);
      const float* es = wrows(k);
      for (int t0 = 0; t0 < L; t0 += 8) {
        const float* dr = dys + (t0 + q) * SD + p0 + g;
        const float v[4] = {dr[0], dr[8], dr[4 * SD], dr[4 * SD + 8]};
        uint32_t ah4[4], al4[4];
        split4(v, ah4, al4);
        const float ea = w[t0 + q], eb = w[t0 + q + 4];
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int nt = nt0 + nstep * j;
          if (nt < NTN) {
            const float* ec = es + (t0 + q) * SW + nt * 8 + g;
            mma3b(acc[j], ah4, al4, ea * ec[0], eb * ec[4 * SW]);
          }
        }
      }
    }
    if (i + 1 < nc) store_state(i + 1);
    if (warp == 0 && i + 1 < nc) {
      setup(i + 1, k ^ 1, dn0, dn1);
      if (i + 2 < nc) load_dt(i + 2, dn0, dn1);
    }
    __syncthreads();  // buffer k is read: it takes chunk i + 2
    if (i + 2 < nc) stage(i + 2, k);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
  }
  if (rev) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int nt = nt0 + nstep * j;
      if (nt < NTN) {
        store_pair(dh0 + bh * PN, N, p0 + g, nt * 8 + 2 * q, st[j][0],
                   st[j][1]);
        store_pair(dh0 + bh * PN, N, p0 + g + 8, nt * 8 + 2 * q, st[j][2],
                   st[j][3]);
      }
    }
  }
}

// ---------------------------------------------------------------- pass 2
// One block of 16 warps per (chunk, batch row); it walks the row's heads.
// Warp w takes, per head:
//   dy x^T: two 8-column tiles of one 16-row tile i of the lower
//     triangle (warps 0-3 row 3, 4-6 row 2, 7-8 row 1, 9 row 0), kept
//     summed over the heads as M (the block holds M's 20 tiles);
//   dxh (u, p): two 8-column tiles of the 16-row tile 3 - w / (P / 16)
//     (warps 0-3, with the longest dy x^T rows, get the shortest
//     triangle);
//   the dC and dB rank-P parts (t or u, n) and, at the end, the triangles:
//     the 16-row tile w % 4 and every fourth 8-column tile from w / 4 on.
template <typename T, int P>
__global__ void __launch_bounds__(kGradThreads, 1)
    ssd_bwd_grad_kernel(const T* __restrict__ x,
                        const float* __restrict__ dy,
                        const float* __restrict__ y,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm,
                        const float* __restrict__ hs,
                        const float* __restrict__ gs, T* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ db,
                        float* __restrict__ dc, float* __restrict__ dap,
                        int S, int H, int N) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int L = kBwdChunk;
  constexpr int SX = P + 8, SD = P + 8, SC = L + 4, SM = SC;
  constexpr int NH2 = P / 16;  // warps on one 16-row tile of dxh
  const int Np = pad8(N), NTN = Np / 8, SG = Np + 4;
  const int c = blockIdx.x, b = blockIdx.y;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = c * L;
  const int Lc = min(L, S - c0);
  const long long row0 = (long long)b * S + c0;
  const long long PN = (long long)P * N;
  const int HF = head_floats<T>(P, N);

  float* bs = smem;                 // L * SG: B[u][n]
  float* bct = bs + L * SG;         // L * SC: (B C^T)[u][t]
  float* bufs = bct + L * SC;       // 2 * HF: x, dy, g of a head, twice
  float* hsm = bufs + 2 * HF;       // P * SG: h_c[p][n]
  float* c2 = hsm + P * SG;         // L: cum log2(e)
  float* dts = c2 + L;              // L: dt
  float* tl = dts + L;              // L: exp(cum[L-1] - cum[u])
  float* ex = tl + L;               // L: exp(cum[t])
  float* rdp = ex + L;              // 4 L: x[u].dxh[u], per column pair
  float* ydp = rdp + 4 * L;         // 4 L: dy[t].y[t], per column pair
  float* ghp = ydp + 4 * L;         // 16: sum_u w x.(B g^T), per warp
  float* ghq = ghp + kGradWarps;    // 16: <g, h_c>, per warp
  float* misc = ghq + kGradWarps;   // exp(cum[Lc-1]), a

  auto xs_of = [&](int k) { return reinterpret_cast<T*>(bufs + k * HF); };
  auto dys_of = [&](int k) { return bufs + k * HF + x_floats<T>(L, P); };
  auto gsm_of = [&](int k) { return dys_of(k) + L * SD; };
  auto hslot = [&](int hh) {
    return hs + (((long long)b * H + hh) * nc + c) * PN;
  };
  auto gslot = [&](int hh) {
    return gs + (((long long)b * H + hh) * nc + c) * PN;
  };
  // x, dy and g_{c+1} of head hh into buffer k
  auto stage_head = [&](int hh, int k) {
    const long long off = row0 * H * P + (long long)hh * P;
    stage16<kGradThreads>(xs_of(k), SX, x + off, (long long)H * P, Lc, L,
                          P);
    stage16<kGradThreads>(dys_of(k), SD, dy + off, (long long)H * P, Lc, L,
                          P);
    stage_f32<kGradThreads>(gsm_of(k), SG, gslot(hh), N, P, P, N, Np);
  };
  // warp 0: cum and its exponentials for head hh, from its dt (d0, d1)
  auto setup = [&](int hh, float d0, float d1) {
    const int t0 = 2 * lane, t1 = t0 + 1;
    const float ah = a[hh];
    float cu0, cu1;
    const float cl = chunk_cum(ah * d0, ah * d1, cu0, cu1, Lc);
    c2[t0] = cu0 * kLog2e;
    c2[t1] = cu1 * kLog2e;
    dts[t0] = d0;
    dts[t1] = d1;
    tl[t0] = t0 < Lc ? expf(cl - cu0) : 0.f;
    tl[t1] = t1 < Lc ? expf(cl - cu1) : 0.f;
    ex[t0] = t0 < Lc ? expf(cu0) : 0.f;
    ex[t1] = t1 < Lc ? expf(cu1) : 0.f;
    if (lane == 0) {
      misc[0] = expf(cl);
      misc[1] = ah;
    }
  };
  // y of head hh (read in the dxh epilogue) into L2, 128-byte lines
  auto prefetch_y = [&](int hh) {
    constexpr int LPR = P >= 32 ? P / 32 : 1;  // lines a row
    if (tid < Lc * LPR) {
      const float* r = y + ((row0 + tid / LPR) * H + hh) * P + 32 * (tid % LPR);
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(r));
    }
  };
  auto load_dt = [&](int hh, float& d0, float& d1) {
    const int t0 = 2 * lane, t1 = t0 + 1;
    d0 = t0 < Lc ? dt[(row0 + t0) * H + hh] : 0.f;
    d1 = t1 < Lc ? dt[(row0 + t1) * H + hh] : 0.f;
  };

  // prologue: B, and C where the heads' buffers go until B C^T is taken
  float* cs = bufs;
  stage_f32<kGradThreads>(bs, SG, bm + row0 * N, N, Lc, L, N, Np);
  stage_f32<kGradThreads>(cs, SG, cm + row0 * N, N, Lc, L, N, Np);
  cp_commit();
  float dn0 = 0.f, dn1 = 0.f;  // warp 0: dt of the next head
  if (warp == 0) {
    float d0, d1;
    load_dt(0, d0, d1);
    setup(0, d0, d1);
    if (H > 1) load_dt(1, dn0, dn1);
  }
  cp_wait<0>();
  __syncthreads();

  // B C^T: warp w the 16-row tile w / 4, 8-column tiles 2 (w % 4), + 1
  {
    const int u0 = 16 * (warp >> 2), j0 = 2 * (warp & 3);
    float acc[2][4] = {};
    for (int k0 = 0; k0 < Np; k0 += 8) {
      const float* br = bs + (u0 + g) * SG + k0 + q;
      const float v[4] = {br[0], br[8 * SG], br[4], br[8 * SG + 4]};
      uint32_t ah[4], al[4];
      split4(v, ah, al);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* cr = cs + ((j0 + j) * 8 + g) * SG + k0 + q;
        mma3b(acc[j], ah, al, cr[0], cr[4]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = bct + (u0 + g) * SC + (j0 + j) * 8 + 2 * q;
      store2(o, acc[j][0], acc[j][1]);
      store2(o + 8 * SC, acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();  // C is read: the buffers take heads 0 and 1
  stage_head(0, 0);
  stage_f32<kGradThreads>(hsm, SG, hslot(0), N, P, P, N, Np);
  cp_commit();
  if (H > 1) stage_head(1, 1);
  cp_commit();
  prefetch_y(0);
  cp_wait<1>();
  __syncthreads();

  // the warp's tiles: M (dy x^T summed over heads; row mi, or none), dC
  // and dB
  const int mi = warp < 4 ? 3 : warp < 7 ? 2 : warp < 9 ? 1 : warp < 10 ? 0
                                                                         : -1;
  const int mj0 = 2 * (warp - (warp < 4 ? 0 : warp < 7 ? 4 : warp < 9 ? 7 : 9));
  float macc[2][4] = {};
  const int rt0 = 16 * (warp & 3), nt0 = warp >> 2;
  float dcacc[4][4] = {}, dbacc[4][4] = {};

  for (int hh = 0; hh < H; ++hh) {
    const int k = hh & 1;
    const T* xs = xs_of(k);
    const float* dys = dys_of(k);
    const float* gsm = gsm_of(k);

    // ---- dy x^T on the lower triangle, gated, times dt[u], into M
    if (mi >= 0) {
      const int t0 = 16 * mi;
      float mg[2][4] = {};
      if constexpr (kBf16) {
        for (int p0 = 0; p0 < P; p0 += 16) {
          const float* dr = dys + (t0 + g) * SD + p0 + 2 * q;
          const float2 va = load2(dr), vb = load2(dr + 8 * SD);
          const float2 vc = load2(dr + 8), vd = load2(dr + 8 * SD + 8);
          uint32_t pa[4][3];
          split3(va.x, va.y, pa[0]);
          split3(vb.x, vb.y, pa[1]);
          split3(vc.x, vc.y, pa[2]);
          split3(vd.x, vd.y, pa[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const T* xr = xs + ((mj0 + j) * 8 + g) * SX + p0 + 2 * q;
            const uint32_t b0 = bits2(xr), b1 = bits2(xr + 8);
#pragma unroll
            for (int kk = 2; kk >= 0; --kk) {
              const uint32_t ap[4] = {pa[0][kk], pa[1][kk], pa[2][kk],
                                      pa[3][kk]};
              mma_bf16(mg[j], ap, b0, b1);
            }
          }
        }
      } else {
        for (int p0 = 0; p0 < P; p0 += 8) {
          const float* dr = dys + (t0 + g) * SD + p0 + 2 * q;
          const float2 va = load2(dr), vb = load2(dr + 8 * SD);
          const float v[4] = {va.x, vb.x, va.y, vb.y};
          uint32_t ah[4], al[4];
          split4(v, ah, al);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float2 xv = load2(xs + ((mj0 + j) * 8 + g) * SX + p0 +
                                    2 * q);
            mma3b(mg[j], ah, al, xv.x, xv.y);
          }
        }
      }
      const float cta = c2[t0 + g], ctb = c2[t0 + g + 8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ua = (mj0 + j) * 8 + 2 * q, ub = ua + 1;
        const int ta = t0 + g, tb = ta + 8;
        const float2 cu = load2(c2 + ua), du = load2(dts + ua);
        macc[j][0] += ua <= ta ? mg[j][0] * ex2(cta - cu.x) * du.x : 0.f;
        macc[j][1] += ub <= ta ? mg[j][1] * ex2(cta - cu.y) * du.y : 0.f;
        macc[j][2] += ua <= tb ? mg[j][2] * ex2(ctb - cu.x) * du.x : 0.f;
        macc[j][3] += ub <= tb ? mg[j][3] * ex2(ctb - cu.y) * du.y : 0.f;
      }
    }

    // ---- dxh[u][p] = sum_{t>=u} att[t][u] dy[t][p] + tl[u] (B g^T)[u][p]
    float gw = 0.f;
    if (warp < 4 * NH2) {
      const int jp = warp % NH2;  // the column pair
      const int u0 = 16 * (3 - warp / NH2), pc0 = 16 * jp;
      const int ua = u0 + g, ub = ua + 8;
      float2 ya[2], yb[2];  // y for dy.y, loaded ahead
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = pc0 + j * 8 + 2 * q;
        ya[j] = ua < Lc ? *reinterpret_cast<const float2*>(
                              y + ((row0 + ua) * H + hh) * P + p)
                        : make_float2(0.f, 0.f);
        yb[j] = ub < Lc ? *reinterpret_cast<const float2*>(
                              y + ((row0 + ub) * H + hh) * P + p)
                        : make_float2(0.f, 0.f);
      }
      float aa[2][4] = {}, ag[2][4] = {};
      const float cua = c2[ua], cub = c2[ub];
      for (int t0 = u0; t0 < L; t0 += 8) {
        // A (u, t) = (B C^T)[u][t] e^{cum[t]-cum[u]} for t >= u
        const int ta = t0 + q, tb = ta + 4;
        const float cta = c2[ta], ctb = c2[tb];
        const float v[4] = {
            ta >= ua ? bct[ua * SC + ta] * ex2(cta - cua) : 0.f,
            ta >= ub ? bct[ub * SC + ta] * ex2(cta - cub) : 0.f,
            tb >= ua ? bct[ua * SC + tb] * ex2(ctb - cua) : 0.f,
            tb >= ub ? bct[ub * SC + tb] * ex2(ctb - cub) : 0.f};
        uint32_t ah[4], al[4];
        split4(v, ah, al);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* dr = dys + ta * SD + pc0 + j * 8 + g;
          mma3b(aa[j], ah, al, dr[0], dr[4 * SD]);
        }
      }
      for (int k0 = 0; k0 < Np; k0 += 8) {
        const float* br = bs + ua * SG + k0 + q;
        const float v[4] = {br[0], br[8 * SG], br[4], br[8 * SG + 4]};
        uint32_t ah[4], al[4];
        split4(v, ah, al);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* gr = gsm + (pc0 + j * 8 + g) * SG + k0 + q;
          mma3b(ag[j], ah, al, gr[0], gr[4]);
        }
      }
      // dx, and the row dots x.dxh, dy.y and w x.(B g^T)
      const float tla = tl[ua], tlb = tl[ub], dta = dts[ua], dtb = dts[ub];
      float rda = 0.f, rdb = 0.f, yda = 0.f, ydb = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = pc0 + j * 8 + 2 * q;
        const float2 xa = load2(xs + ua * SX + p), xb = load2(xs + ub * SX + p);
        const float2 da = load2(dys + ua * SD + p), dbv = load2(dys + ub * SD + p);
        const float h0v = aa[j][0] + tla * ag[j][0];
        const float h1v = aa[j][1] + tla * ag[j][1];
        const float h2v = aa[j][2] + tlb * ag[j][2];
        const float h3v = aa[j][3] + tlb * ag[j][3];
        if (ua < Lc)
          store2(dx + ((row0 + ua) * H + hh) * P + p, dta * h0v, dta * h1v);
        if (ub < Lc)
          store2(dx + ((row0 + ub) * H + hh) * P + p, dtb * h2v, dtb * h3v);
        rda += xa.x * h0v + xa.y * h1v;
        rdb += xb.x * h2v + xb.y * h3v;
        yda += da.x * ya[j].x + da.y * ya[j].y;
        ydb += dbv.x * yb[j].x + dbv.y * yb[j].y;
        gw += dta * tla * (xa.x * ag[j][0] + xa.y * ag[j][1]) +
              dtb * tlb * (xb.x * ag[j][2] + xb.y * ag[j][3]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rda += __shfl_xor_sync(0xffffffffu, rda, off);
        rdb += __shfl_xor_sync(0xffffffffu, rdb, off);
        yda += __shfl_xor_sync(0xffffffffu, yda, off);
        ydb += __shfl_xor_sync(0xffffffffu, ydb, off);
      }
      if (q == 0) {
        rdp[jp * L + ua] = rda;
        rdp[jp * L + ub] = rdb;
        ydp[jp * L + ua] = yda;
        ydp[jp * L + ub] = ydb;
      }
    }
    gw = warp_sum(gw);
    if (lane == 0) ghp[warp] = gw;

    cp_wait<1>();  // h_c of this head
    __syncthreads();

    // ---- dC rank part: (e^{cum[t]} dy[t]) . h_c, summed over the heads
    {
      for (int p0 = 0; p0 < P; p0 += 8) {
        const float* dr = dys + (rt0 + g) * SD + p0 + 2 * q;
        const float ea = ex[rt0 + g], eb = ex[rt0 + g + 8];
        const float2 va = load2(dr), vb = load2(dr + 8 * SD);
        const float v[4] = {ea * va.x, eb * vb.x, ea * va.y, eb * vb.y};
        uint32_t ah[4], al[4];
        split4(v, ah, al);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nt = nt0 + 4 * i;
          if (nt < NTN) {
            const float* hr = hsm + (p0 + 2 * q) * SG + nt * 8 + g;
            mma3b(dcacc[i], ah, al, hr[0], hr[SG]);
          }
        }
      }
      float part = 0.f;
      for (int p = warp; p < P; p += kGradWarps)
        for (int n = lane; n < Np; n += 32)
          part = fmaf(gsm[p * SG + n], hsm[p * SG + n], part);
      part = warp_sum(part);
      if (lane == 0) ghq[warp] = part;
    }
    __syncthreads();  // h_c is read: its buffer takes the next head's
    if (hh + 1 < H)
      stage_f32<kGradThreads>(hsm, SG, hslot(hh + 1), N, P, P, N, Np);
    cp_commit();

    // ---- dB rank part: dt[u] tl[u] (x g)[u], summed over the heads
    {
      float tmp[4][4] = {};
      if constexpr (kBf16) {
        for (int p0 = 0; p0 < P; p0 += 16) {
          const T* xr = xs + (rt0 + g) * SX + p0 + 2 * q;
          const uint32_t ax[4] = {bits2(xr), bits2(xr + 8 * SX),
                                  bits2(xr + 8), bits2(xr + 8 * SX + 8)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int nt = nt0 + 4 * i;
            if (nt < NTN) {
              const float* gr = gsm + (p0 + 2 * q) * SG + nt * 8 + g;
              uint32_t b0[3], b1[3];
              split3(gr[0], gr[SG], b0);
              split3(gr[8 * SG], gr[9 * SG], b1);
              mma_bf16x3(tmp[i], ax, b0, b1);
            }
          }
        }
      } else {
        for (int p0 = 0; p0 < P; p0 += 8) {
          const T* xr = xs + (rt0 + g) * SX + p0 + 2 * q;
          const float2 xa = load2(xr), xb = load2(xr + 8 * SX);
          const float v[4] = {xa.x, xb.x, xa.y, xb.y};
          uint32_t ah[4], al[4];
          split4(v, ah, al);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int nt = nt0 + 4 * i;
            if (nt < NTN) {
              const float* gr = gsm + (p0 + 2 * q) * SG + nt * 8 + g;
              mma3b(tmp[i], ah, al, gr[0], gr[SG]);
            }
          }
        }
      }
      const float wa = dts[rt0 + g] * tl[rt0 + g];
      const float wb = dts[rt0 + g + 8] * tl[rt0 + g + 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dbacc[i][0] = fmaf(wa, tmp[i][0], dbacc[i][0]);
        dbacc[i][1] = fmaf(wa, tmp[i][1], dbacc[i][1]);
        dbacc[i][2] = fmaf(wb, tmp[i][2], dbacc[i][2]);
        dbacc[i][3] = fmaf(wb, tmp[i][3], dbacc[i][3]);
      }
    }

    // ---- warp 0: dcum, its reverse cumsum r, ddt and the share of da
    if (warp == 0) {
      const int u0 = 2 * lane, u1 = u0 + 1;
      float gh = 0.f, gq = 0.f;
      for (int w = 0; w < kGradWarps; ++w) {
        gh += ghp[w];
        gq += ghq[w];
      }
      const float ghn = misc[0] * gq + gh;  // <g_{c+1}, h_{c+1}>
      float rd0 = 0.f, rd1 = 0.f, yd0 = 0.f, yd1 = 0.f;
#pragma unroll
      for (int jp = 0; jp < NH2; ++jp) {
        rd0 += rdp[jp * L + u0];
        rd1 += rdp[jp * L + u1];
        yd0 += ydp[jp * L + u0];
        yd1 += ydp[jp * L + u1];
      }
      const float d0 = dts[u0], d1 = dts[u1];
      float dc0 = u0 < Lc ? yd0 - d0 * rd0 : 0.f;
      float dc1 = u1 < Lc ? yd1 - d1 * rd1 : 0.f;
      if (u0 == Lc - 1) dc0 += ghn;
      if (u1 == Lc - 1) dc1 += ghn;
      // r[u] = sum_{t>=u} dcum[t]: a suffix scan of the lanes' pairs
      float s = dc0 + dc1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, s, off);
        if (lane + off < 32) s += o;
      }
      float after = __shfl_down_sync(0xffffffffu, s, 1);
      if (lane == 31) after = 0.f;
      const float r1 = after + dc1, r0 = r1 + dc0;
      const float ah = misc[1];
      if (u0 < Lc) ddt[(row0 + u0) * H + hh] = rd0 + ah * r0;
      if (u1 < Lc) ddt[(row0 + u1) * H + hh] = rd1 + ah * r1;
      const float share = warp_sum(d0 * r0 + d1 * r1);
      if (lane == 0) dap[((long long)b * H + hh) * nc + c] = share;
    }
    __syncthreads();  // this head's buffer and arrays are free
    if (hh + 2 < H) stage_head(hh + 2, k);
    cp_commit();
    if (hh + 1 < H) prefetch_y(hh + 1);
    if (warp == 0 && hh + 1 < H) {
      setup(hh + 1, dn0, dn1);
      if (hh + 2 < H) load_dt(hh + 2, dn0, dn1);
    }
    cp_wait<2>();  // x, dy and g of the next head
    __syncthreads();
  }

  // ---- the triangles, once for all heads: dC += M B, dB += M^T C
  float* cs2 = bufs;  // C[t][n]
  float* ms = bct;    // M[t][u]
  stage_f32<kGradThreads>(cs2, SG, cm + row0 * N, N, Lc, L, N, Np);
  cp_commit();
  for (int e = tid; e < L * SM; e += kGradThreads) ms[e] = 0.f;
  __syncthreads();
  if (mi >= 0) {
    const int t0 = 16 * mi;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = ms + (t0 + g) * SM + (mj0 + j) * 8 + 2 * q;
      store2(o, macc[j][0], macc[j][1]);
      store2(o + 8 * SM, macc[j][2], macc[j][3]);
    }
  }
  cp_wait<0>();
  __syncthreads();
  for (int k0 = 0; k0 < rt0 + 16; k0 += 8) {  // k = u <= t
    const float* mr = ms + (rt0 + g) * SM + k0 + 2 * q;
    const float2 va = load2(mr), vb = load2(mr + 8 * SM);
    const float v[4] = {va.x, vb.x, va.y, vb.y};
    uint32_t ah[4], al[4];
    split4(v, ah, al);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nt = nt0 + 4 * i;
      if (nt < NTN) {
        const float* br = bs + (k0 + 2 * q) * SG + nt * 8 + g;
        mma3b(dcacc[i], ah, al, br[0], br[SG]);
      }
    }
  }
  for (int k0 = rt0; k0 < L; k0 += 8) {  // k = t >= u
    const float* mr = ms + (k0 + 2 * q) * SM + rt0 + g;
    const float v[4] = {mr[0], mr[8], mr[SM], mr[SM + 8]};
    uint32_t ah[4], al[4];
    split4(v, ah, al);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int nt = nt0 + 4 * i;
      if (nt < NTN) {
        const float* cr = cs2 + (k0 + 2 * q) * SG + nt * 8 + g;
        mma3b(dbacc[i], ah, al, cr[0], cr[SG]);
      }
    }
  }
  float* dcr = dc + row0 * N;
  float* dbr = db + row0 * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int nt = nt0 + 4 * i, n = nt * 8 + 2 * q;
    if (nt < NTN) {
#pragma unroll
      for (int r = 0; r < 4; r += 2) {
        const int t = rt0 + g + 4 * r;
        if (t < Lc) {
          store_pair(dcr, N, t, n, dcacc[i][r], dcacc[i][r + 1]);
          store_pair(dbr, N, t, n, dbacc[i][r], dbacc[i][r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- pass 3
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_kernel(const float* __restrict__ dap,
                          float* __restrict__ da, int B, int H, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= H) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) s += dap[((long long)b * H + e) * nc + c];
  da[e] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the workspace: h slots and g slots (B, H, nc, P, N) each, da shares
// (B, H, nc)
long long workspace_floats(long long B, long long S, long long H,
                           long long P, long long N) {
  const long long nc = (S + kBwdChunk - 1) / kBwdChunk;
  return B * H * nc * (2 * P * N + 1);
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dy, const void* y,
                   const void* dt, const void* a, const void* bm,
                   const void* cm, const void* h0, const void* dh_last,
                   void* dx, void* ddt, void* da, void* db, void* dc,
                   void* dh0, void* ws, int B, int S, int H, int N,
                   cudaStream_t stream) {
  const int L = kBwdChunk;
  const int nc = (S + L - 1) / L;
  const long long PN = (long long)P * N;
  float* hs = (float*)ws;
  float* gs = hs + (long long)B * H * nc * PN;
  float* dap = gs + (long long)B * H * nc * PN;

  const int smem1 = state_smem(P, N);
  cudaError_t err = allow_smem(ssd_bwd_state_kernel<T, P>, smem1);
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<T, P><<<dim3(2, H, B), kThreads, smem1, stream>>>(
      (const T*)x, (const float*)dy, (const float*)dt, (const float*)a,
      (const float*)bm, (const float*)cm, (const float*)h0,
      (const float*)dh_last, hs, gs, (float*)dh0, S, H, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int smem3 = grad_smem<T>(P, N);
  err = allow_smem(ssd_bwd_grad_kernel<T, P>, smem3);
  if (err != cudaSuccess) return err;
  ssd_bwd_grad_kernel<T, P><<<dim3(nc, B), kGradThreads, smem3, stream>>>(
      (const T*)x, (const float*)dy, (const float*)y, (const float*)dt,
      (const float*)a, (const float*)bm, (const float*)cm, hs, gs, (T*)dx,
      (float*)ddt, (float*)db, (float*)dc, dap, S, H, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_bwd_reduce_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(dap, (float*)da, B, H, nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(int P, const void* x, const void* dy, const void* y,
                     const void* dt, const void* a, const void* bm,
                     const void* cm, const void* h0, const void* dh_last,
                     void* dx, void* ddt, void* da, void* db, void* dc,
                     void* dh0, void* ws, int B, int S, int H, int N,
                     cudaStream_t stream) {
  if (P == 16)
    return launch<T, 16>(x, dy, y, dt, a, bm, cm, h0, dh_last, dx, ddt, da,
                         db, dc, dh0, ws, B, S, H, N, stream);
  if (P == 32)
    return launch<T, 32>(x, dy, y, dt, a, bm, cm, h0, dh_last, dx, ddt, da,
                         db, dc, dh0, ws, B, S, H, N, stream);
  if (P == 64)
    return launch<T, 64>(x, dy, y, dt, a, bm, cm, h0, dh_last, dx, ddt, da,
                         db, dc, dh0, ws, B, S, H, N, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of scratch that ssd_scan_bwd_launch needs.
extern "C" long long ssd_scan_bwd_workspace(int B, int S, int H, int P,
                                            int N) {
  return workspace_floats(B, S, H, P, N);
}

// Dynamic shared memory of the gradient pass at head dim P and state N,
// for f32 x (bf16 x needs less).
extern "C" int ssd_scan_bwd_grad_smem_bytes(int P, int N) {
  return grad_smem<float>(P, N);
}

// dtype (of x and dx): 0 = float32, 1 = bfloat16.  P in {16, 32, 64},
// 1 <= N <= 128.  dy and y (B, S, H, P), dh_last (B, H, P, N) or null
// (zeros), all f32; x, dy, y, bm and cm 16-byte aligned; ws:
// ssd_scan_bwd_workspace(B, S, H, P, N) floats.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dy,
                                   const void* y, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, const void* h0,
                                   const void* dh_last, void* dx, void* ddt,
                                   void* da, void* db, void* dc, void* dh0,
                                   void* ws, int B, int S, int H, int P,
                                   int N, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxState)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_p<float>(P, x, dy, y, dt, a, bm, cm, h0, dh_last, dx,
                                ddt, da, db, dc, dh0, ws, B, S, H, N, st);
  if (dtype == 1)
    return (int)launch_p<__nv_bfloat16>(P, x, dy, y, dt, a, bm, cm, h0,
                                        dh_last, dx, ddt, da, db, dc, dh0,
                                        ws, B, S, H, N, st);
  return (int)cudaErrorInvalidValue;
}

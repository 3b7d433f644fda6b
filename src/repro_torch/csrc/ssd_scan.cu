// ssd_scan: the Mamba2 SSD chunk scan, from a carried state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (`ssd_scan`, body `_ssd_kernel`), with what the serving prefill needs
// from the reference's `ssd_chunked` (src/repro/models/ssm.py): it starts
// from the state h0 and writes the final state h_last (the TPU kernel
// starts from zero and drops it).  Per (b, head) and chunk c of L steps:
//
//   cum[t]  = sum_{u<=t} a dt[u]                         (within the chunk)
//   s_c     = sum_u exp(cum[L-1]-cum[u]) dt[u] x[u] B[u]^T     (P x N)
//   h_c     = exp(cum[L-1]) h_{c-1} + s_c                (h_{-1} = h0)
//   y[t]    = sum_{u<=t} (C[t].B[u]) exp(cum[t]-cum[u]) dt[u] x[u]
//           + exp(cum[t]) C[t] . h_{c-1}
//
// x (B, S, H, P) f32 or bf16; dt (B, S, H), a (H,), B / C (B, S, N) shared
// by every head, h0 (B, H, P, N): f32.  y (B, S, H, P) and h_last f32.
// The ragged last chunk is padded in shared memory with dt = x = B = C = 0,
// which leaves the state unchanged, so any S runs.
//
// What bounds it on an H100 (data-sheet peaks, 700 W): at hymba's serving
// shape (B 8, S 2048, H 50, P 64, N 16, chunk 256) the products are ~10 G
// multiply-adds per call against ~0.3 GB of x, y, B, C and dt, so
// operations, each at its type's peak (0.10 ms: the state pass in fp32,
// the output pass's split products on the tensor cores), and bytes
// (0.10 ms) are both below what a sequential walk over the chunks
// reaches.  The TPU kernel walks the
// chunks in order with the state in VMEM; here the walk is cut into three
// passes, so that all but one are parallel over (chunk, head, batch):
//
//   1. state pass, one block per (chunk, head, batch): cum by a block
//      scan, then s_c = x^T (w B) in fp32 on the CUDA cores (register
//      tiles of 4 x 4 outputs, the chunk split among thread groups and
//      summed in shared memory).  It writes s_c and exp(cum[L-1]) to a
//      workspace the wrapper allocates, (B, H, chunks, P, N) and
//      (B, H, chunks).
//   2. chain pass, one thread per state element: the only sequential
//      part, h_c = exp(cum[L-1]) h_{c-1} + s_c over the chunks, written
//      back in place as the state entering each chunk; then h_last.
//   3. output pass, one block per (chunk, head, batch): each warp owns
//      16-row tiles of y (the heaviest paired with the lightest) and
//      keeps them in registers.  The products run on the tensor cores
//      with fp32 sums, their f32 operands split so that no product loses
//      more than ~2^-21 (one TF32 or bf16 rounding does not meet the f32
//      check):
//      - C B^T and the inter-chunk C h^T as mma.sync m16n8k8 TF32, each
//        operand v = hi + lo with hi = TF32(v), three products (lo.hi,
//        hi.lo, hi.hi);
//      - att . x for bf16 x (exact in bf16) as m16n8k16 bf16 products,
//        att = p0 + p1 + p2 in three bf16 pieces, x fragments by
//        ldmatrix.trans; for f32 x as split TF32, with the k order
//        permuted (slot q <-> u0 + 2q, slot q + 4 <-> u0 + 2q + 1).
//      Either way the accumulator of C B^T is already att's A fragment,
//      so the L x L gate is built one 16 x 16 piece at a time in
//      registers, never whole.
//
// Shared memory rows of the output pass are padded (B, C, h to N8 + 4
// floats, x to P + 16 bytes) so that every fragment load is free of bank
// conflicts.  Chunk data is staged with cp.async (x in 16-byte pieces: the
// wrapper hands over a 16-byte-aligned x).  The domain: P in {16, 32, 64},
// chunk <= 256 and N <= 128 (kernels/ssd_scan/ops.py `kernel_takes`
// refuses the rest first).  The passes run at the chunk L they are given,
// which must have pad16(L) * pad8(N) <= 16384 to keep each pass under a
// block's 227 KB of shared memory.  Where the requested chunk does not
// (mamba2's N 128 at chunk 256: 343 104 bytes of output pass for bf16 x),
// the wrapper passes the largest multiple of 16 that does (`run_chunk`:
// 128 at N 128, 188 480 bytes for bf16 x, 204 864 for f32).  Any chunking
// of the scan computes the same function; only the f32 rounding moves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;  // cum is scanned with one thread per step
constexpr int kMaxState = 128;
constexpr int kMaxTile = 16384;  // pad16(L) * pad8(N) of the chunk run
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int v) { return (v + 15) & ~15; }
__host__ __device__ constexpr int pad8(int v) { return (v + 7) & ~7; }

// 4 consecutive elements as floats (8 or 16 bytes, aligned)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// asynchronous copies into shared memory, all in flight until cp_wait()
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
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// x rows u < Lc of the chunk into xs[u][SX] (16-byte pieces; zero rows up
// to Lp), x 16-byte aligned and P * sizeof(T) a multiple of 16
template <typename T, int P, int SX>
__device__ __forceinline__ void stage_x(T* xs, const T* x, long long row0,
                                        int H, int h, int Lc, int Lp) {
  constexpr int E = 16 / (int)sizeof(T);  // elements per piece
  constexpr int PV = P / E;               // pieces per row
  for (int e = threadIdx.x; e < Lp * PV; e += kThreads) {
    const int u = e / PV;
    const int p = (e - u * PV) * E;
    if (u < Lc)
      cp16(xs + u * SX + p, x + ((row0 + u) * H + h) * P + p);
    else
      *reinterpret_cast<uint4*>(xs + u * SX + p) = make_uint4(0, 0, 0, 0);
  }
}

// rows u < Lc, columns n < N of a (rows, N) f32 array into dst[u][SN],
// zeros elsewhere up to (Lp, Np); thread t keeps column t % Np (one
// division, not one per element)
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int Lc, int Lp, int N, int Np,
                                           int SN) {
  const int step = kThreads / Np;
  const int n = threadIdx.x % Np;
  if (threadIdx.x >= step * Np) return;
  for (int u = threadIdx.x / Np; u < Lp; u += step) {
    if (u < Lc && n < N)
      cp4(dst + u * SN + n, src + (long long)u * N + n);
    else
      dst[u * SN + n] = 0.f;
  }
}

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away, in integer
// ops: cvt.rna.tf32 issues at a quarter of their rate), lo = v - hi is exact
// in fp32 and the tensor cores read its top 19 bits (truncation), so
// |v - hi - lo| < 2^-21 |v|
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b for a 16 x 8 (rows) . 8 x 8 (columns) TF32 tile, fp32 sums.
// Fragments (g = lane / 4, q = lane % 4): a0 (g, q), a1 (g + 8, q),
// a2 (g, q + 4), a3 (g + 8, q + 4); b0 (k q, n g), b1 (k q + 4, n g);
// d0 (g, 2q), d1 (g, 2q + 1), d2 (g + 8, 2q), d3 (g + 8, 2q + 1).
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

// Inclusive scan of one value per thread over the block.
__device__ float block_scan(float v, float* wsum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  return v;
}

// Shared memory of each pass, in bytes; Lm = pad16(min(chunk, S)).  The
// state pass reads rows whole (no padding; its partial tiles reuse x's
// space); the output pass pads x rows by 16 bytes (SX elements) and B, C
// and h rows to SN floats for its fragment loads.
template <typename T>
int state_x_bytes(int Lm, int P) {
  const int xb = Lm * P * (int)sizeof(T);
  const int rb = kThreads * 16 * (int)sizeof(float);
  return xb > rb ? xb : rb;
}

template <typename T>
int state_smem(int Lm, int P, int N) {
  return (Lm * pad8(N) + 2 * Lm + 16) * (int)sizeof(float) +
         state_x_bytes<T>(Lm, P);
}

template <typename T>
int output_smem(int Lm, int P, int N) {
  const int SN = pad8(N) + 4;
  const int SX = P + 16 / (int)sizeof(T);
  return (2 * Lm * SN + P * SN + 2 * Lm + 16) * (int)sizeof(float) +
         Lm * SX * (int)sizeof(T);
}

// ---------------------------------------------------------------- pass 1
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 4)
    ssd_scan_state_kernel(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bm,
                          float* __restrict__ states,
                          float* __restrict__ decay, int S, int H, int N,
                          int L) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int c0 = c * L;
  const int Lc = min(L, S - c0);
  const int Lp = pad16(Lc);
  const int Lm = pad16(min(L, S));
  const int Np = pad8(N);

  float* bs = smem;                    // Lm * Np: w[u] B[u][n]
  float* cum = bs + Lm * Np;           // Lm
  float* wts = cum + Lm;               // Lm: exp(cum[L-1] - cum[u]) dt[u]
  float* wsum = wts + Lm;              // kWarps (16 floats kept)
  T* xs = reinterpret_cast<T*>(wsum + 16);  // Lm * P: x[u][p]
  float* red = wsum + 16;              // partial tiles, once x is read

  const long long row0 = (long long)b * S + c0;
  stage_x<T, P, P>(xs, x, row0, H, h, Lc, Lp);
  stage_rows(bs, bm + row0 * N, Lc, Lp, N, Np, Np);
  const float d = tid < Lc ? dt[(row0 + tid) * H + h] : 0.f;
  const float cu = block_scan(a[h] * d, wsum);
  if (tid < Lp) cum[tid] = cu;
  __syncthreads();
  const float clast = cum[Lc - 1];
  if (tid < Lp) wts[tid] = expf(clast - cu) * d;
  if (tid == 0) decay[((long long)b * H + h) * nc + c] = expf(clast);
  cp_wait();
  __syncthreads();
  if (tid < (kThreads / Np) * Np)
    for (int u = tid / Np; u < Lp; u += kThreads / Np)
      bs[u * Np + tid % Np] *= wts[u];
  __syncthreads();

  // s[p][n] = sum_u x[u][p] (w B)[u][n] in 4 x 4 tiles; with fewer tiles
  // than threads the chunk is split among `groups` thread groups, whose
  // partial tiles are summed in shared memory
  const int tn = Np / 4;
  const int tiles = (P / 4) * tn;
  const int groups = tiles >= kThreads ? 1 : kThreads / tiles;
  const int span = (Lp + groups - 1) / groups;
  const long long sbase = (((long long)b * H + h) * nc + c) * P * N;
  auto tile_sum = [&](int job, float (&acc)[4][4]) {
    const int grp = job / tiles;
    const int tile = job - grp * tiles;
    const int p0 = (tile / tn) * 4;
    const int n0 = (tile - (tile / tn) * tn) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const int u1 = min(Lp, (grp + 1) * span);
    for (int u = grp * span; u < u1; ++u) {
      float xa[4], ba[4];
      load4(xs + u * P + p0, xa);
      load4(bs + u * Np + n0, ba);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ba[j], acc[i][j]);
    }
  };
  float acc[4][4];
  if (groups == 1) {
    for (int tile = tid; tile < tiles; tile += kThreads) {
      tile_sum(tile, acc);
      const int p0 = (tile / tn) * 4;
      const int n0 = (tile - (tile / tn) * tn) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + j < N) states[sbase + (p0 + i) * N + n0 + j] = acc[i][j];
    }
    return;
  }
  const bool has_job = tid < groups * tiles;
  if (has_job) tile_sum(tid, acc);
  __syncthreads();  // every thread is done with x: red reuses its space
  if (has_job) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[tid * 16 + i * 4 + j] = acc[i][j];
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N;
    const int n = e - p * N;
    const int k = ((p >> 2) * tn + (n >> 2)) * 16 + (p & 3) * 4 + (n & 3);
    float sum = 0.f;
    for (int grp = 0; grp < groups; ++grp) sum += red[grp * tiles * 16 + k];
    states[sbase + e] = sum;
  }
}

// ---------------------------------------------------------------- pass 2
__global__ void __launch_bounds__(kThreads)
    ssd_scan_chain_kernel(const float* __restrict__ h0,
                          float* __restrict__ states,
                          const float* __restrict__ decay,
                          float* __restrict__ h_last, long long total, int PN,
                          int nc) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / PN;
  const int pn = (int)(e - bh * PN);
  float* sp = states + bh * nc * PN + pn;
  const float* dp = decay + bh * nc;
  float hv = h0[e];
  constexpr int kAhead = 8;  // chunks whose loads are in flight together
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float sv[kAhead], dv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const bool in = c0 + i < nc;
      sv[i] = in ? sp[(long long)(c0 + i) * PN] : 0.f;
      dv[i] = in ? dp[c0 + i] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        sp[(long long)(c0 + i) * PN] = hv;  // the state entering the chunk
        hv = fmaf(dv[i], hv, sv[i]);
      }
    }
  }
  h_last[e] = hv;
}

// ---------------------------------------------------------------- pass 3
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_output_kernel(const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const float* __restrict__ bm,
                           const float* __restrict__ cm,
                           const float* __restrict__ hin,
                           float* __restrict__ y, int S, int H, int N,
                           int L) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int SX = P + 16 / (int)sizeof(T);
  constexpr int NT = P / 8;  // 8-column tiles of y
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = c * L;
  const int Lc = min(L, S - c0);
  const int Lp = pad16(Lc);
  const int Lm = pad16(min(L, S));
  const int Np = pad8(N), SN = Np + 4;

  float* bs = smem;                 // Lm * SN: B[u][n]
  float* cs = bs + Lm * SN;         // Lm * SN: C[t][n]
  float* hs = cs + Lm * SN;         // P * SN: h entering the chunk, [p][n]
  float* cum = hs + P * SN;         // Lm: cum log2(e)
  float* dts = cum + Lm;            // Lm
  float* wsum = dts + Lm;           // kWarps (16 floats kept)
  T* xs = reinterpret_cast<T*>(wsum + 16);  // Lm * SX: x[u][p]

  const long long row0 = (long long)b * S + c0;
  stage_x<T, P, SX>(xs, x, row0, H, h, Lc, Lp);
  stage_rows(bs, bm + row0 * N, Lc, Lp, N, Np, SN);
  stage_rows(cs, cm + row0 * N, Lc, Lp, N, Np, SN);
  stage_rows(hs, hin + (((long long)b * H + h) * nc + c) * P * N, P, P, N,
             Np, SN);
  const float d = tid < Lc ? dt[(row0 + tid) * H + h] : 0.f;
  const float cu = block_scan(a[h] * d, wsum);
  if (tid < Lp) {
    cum[tid] = cu * kLog2e;  // the gates are taken as powers of 2
    dts[tid] = d;
  }
  cp_wait();
  __syncthreads();

  // 16-row tiles: warp w takes w, then 15 - w of the next eight, ...
  const int mtiles = Lp / 16;
  for (int k = 0; k * kWarps < mtiles; ++k) {
    const int mt = k * kWarps + ((k & 1) ? kWarps - 1 - warp : warp);
    if (mt >= mtiles) continue;
    const int ta = mt * 16 + g, tb = ta + 8;
    const float* ca = cs + ta * SN;
    const float* cb_row = cs + tb * SN;

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    // inter-chunk: acc = C h^T, then rows scaled by exp(cum[t])
    for (int k0 = 0; k0 < Np; k0 += 8) {
      uint32_t ah[4], al[4];
      split(ca[k0 + q], ah[0], al[0]);
      split(cb_row[k0 + q], ah[1], al[1]);
      split(ca[k0 + q + 4], ah[2], al[2]);
      split(cb_row[k0 + q + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* hr = hs + (j * 8 + g) * SN + k0;
        uint32_t bh[2], bl[2];
        split(hr[q], bh[0], bl[0]);
        split(hr[q + 4], bh[1], bl[1]);
        mma3(acc[j], ah, al, bh, bl);
      }
    }
    const float cta = cum[ta], ctb = cum[tb];
    const float ea = ex2(cta), eb = ex2(ctb);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= ea;
      acc[j][1] *= ea;
      acc[j][2] *= eb;
      acc[j][3] *= eb;
    }

    // intra-chunk, 16 columns u (two 8-column tiles) at a time up to the
    // tile's last row
    for (int u0 = 0; u0 < mt * 16 + 16; u0 += 16) {
      float cbt[2][4] = {};  // (C B^T)[t][u0 + 8i + 2q (+1)]
      for (int k0 = 0; k0 < Np; k0 += 8) {
        uint32_t ah[4], al[4];
        split(ca[k0 + q], ah[0], al[0]);
        split(cb_row[k0 + q], ah[1], al[1]);
        split(ca[k0 + q + 4], ah[2], al[2]);
        split(cb_row[k0 + q + 4], ah[3], al[3]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* brow = bs + (u0 + 8 * i + g) * SN + k0;
          uint32_t bh[2], bl[2];
          split(brow[q], bh[0], bl[0]);
          split(brow[q + 4], bh[1], bl[1]);
          mma3(cbt[i], ah, al, bh, bl);
        }
      }
      // the gated att = C B^T o exp(cum[t] - cum[u]) o dt[u], u <= t
      float att[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ua = u0 + 8 * i + 2 * q, ub = ua + 1;
        const float2 cuv = *reinterpret_cast<const float2*>(cum + ua);
        const float2 duv = *reinterpret_cast<const float2*>(dts + ua);
        const float* cv = cbt[i];
        att[i][0] = ua <= ta ? cv[0] * ex2(cta - cuv.x) * duv.x : 0.f;
        att[i][1] = ub <= ta ? cv[1] * ex2(cta - cuv.y) * duv.y : 0.f;
        att[i][2] = ua <= tb ? cv[2] * ex2(ctb - cuv.x) * duv.x : 0.f;
        att[i][3] = ub <= tb ? cv[3] * ex2(ctb - cuv.y) * duv.y : 0.f;
      }
      if constexpr (kBf16) {
        // bf16 x: att as three bf16 pieces (A fragments of the 16 columns
        // as they lie in C B^T's accumulators), x by ldmatrix, m16n8k16
        // bf16 products
        uint32_t pa[4][3];
        split3(att[0][0], att[0][1], pa[0]);
        split3(att[0][2], att[0][3], pa[1]);
        split3(att[1][0], att[1][1], pa[2]);
        split3(att[1][2], att[1][3], pa[3]);
        uint32_t ap[3][4];
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) ap[k][r] = pa[r][k];
        const T* xrow = xs + (u0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SX +
                        (lane >> 4) * 8;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bx[4];  // n-tiles j and j + 1
          ldsm_x4_t(bx, xrow + j * 8);
#pragma unroll
          for (int k = 2; k >= 0; --k) {
            mma_bf16(acc[j], ap[k], bx[0], bx[1]);
            mma_bf16(acc[j + 1], ap[k], bx[2], bx[3]);
          }
        }
      } else {
        // f32 x: TF32 products, 8 columns at a time, with the k order
        // permuted (slot q <-> column ua, slot q + 4 <-> ub)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int ua = u0 + 8 * i + 2 * q;
          uint32_t ph[4], pl[4];
          split(att[i][0], ph[0], pl[0]);
          split(att[i][2], ph[1], pl[1]);
          split(att[i][1], ph[2], pl[2]);
          split(att[i][3], ph[3], pl[3]);
          const T* xa = xs + ua * SX + g;
          const T* xb = xa + SX;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t bh[2], bl[2];
            split(xa[j * 8], bh[0], bl[0]);
            split(xb[j * 8], bh[1], bl[1]);
            mma3(acc[j], ph, pl, bh, bl);
          }
        }
      }
    }

    float* ya = y + ((row0 + ta) * H + h) * P + 2 * q;
    float* yb = y + ((row0 + tb) * H + h) * P + 2 * q;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (ta < Lc)
        *reinterpret_cast<float2*>(ya + j * 8) =
            make_float2(acc[j][0], acc[j][1]);
      if (tb < Lc)
        *reinterpret_cast<float2*>(yb + j * 8) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, const void* h0, void* y,
                   void* h_last, void* ws, int B, int S, int H, int N, int L,
                   cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  const int Lm = pad16(min(L, S));
  float* states = (float*)ws;  // (B, H, nc, P, N)
  float* decay = states + (long long)B * H * nc * P * N;  // (B, H, nc)
  const dim3 grid(nc, H, B);

  const int smem1 = state_smem<T>(Lm, P, N);
  cudaError_t err = allow_smem(ssd_scan_state_kernel<T, P>, smem1);
  if (err != cudaSuccess) return err;
  ssd_scan_state_kernel<T, P><<<grid, kThreads, smem1, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)bm,
      states, decay, S, H, N, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long total = (long long)B * H * P * N;
  ssd_scan_chain_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                          kThreads, 0, stream>>>(
      (const float*)h0, states, decay, (float*)h_last, total, P * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int smem3 = output_smem<T>(Lm, P, N);
  err = allow_smem(ssd_scan_output_kernel<T, P>, smem3);
  if (err != cudaSuccess) return err;
  ssd_scan_output_kernel<T, P><<<grid, kThreads, smem3, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)bm,
      (const float*)cm, states, (float*)y, S, H, N, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(int P, const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, const void* h0, void* y,
                     void* h_last, void* ws, int B, int S, int H, int N,
                     int L, cudaStream_t stream) {
  if (P == 16)
    return launch<T, 16>(x, dt, a, bm, cm, h0, y, h_last, ws, B, S, H, N, L,
                         stream);
  if (P == 32)
    return launch<T, 32>(x, dt, a, bm, cm, h0, y, h_last, ws, B, S, H, N, L,
                         stream);
  if (P == 64)
    return launch<T, 64>(x, dt, a, bm, cm, h0, y, h_last, ws, B, S, H, N, L,
                         stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x): 0 = float32, 1 = bfloat16.  P in {16, 32, 64},
// 1 <= N <= 128; chunk is the chunk the passes run at (the wrapper's
// `run_chunk`): 1 <= chunk <= 256 and pad16(chunk) * pad8(N) <= 16384.
// ws: B * H * ceil(S / chunk) * (P * N + 1) floats of scratch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm,
                               const void* h0, void* y, void* h_last,
                               void* ws, int B, int S, int H, int P, int N,
                               int chunk, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || S <= 0 || H <= 0 || N <= 0 || N > kMaxState || chunk <= 0 ||
      chunk > kMaxChunk || pad16(chunk) * pad8(N) > kMaxTile)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_p<float>(P, x, dt, a, bm, cm, h0, y, h_last, ws, B, S,
                                H, N, chunk, st);
  if (dtype == 1)
    return (int)launch_p<__nv_bfloat16>(P, x, dt, a, bm, cm, h0, y, h_last,
                                        ws, B, S, H, N, chunk, st);
  return (int)cudaErrorInvalidValue;
}

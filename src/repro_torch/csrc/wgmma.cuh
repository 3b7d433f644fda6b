// wgmma.cuh: the pieces of Hopper's warpgroup matrix multiply and of the
// cp.async staging that the tensor-core attention kernels share
// (flash_attention.cu's flash_attention_wgmma_kernel, flash_attention_bwd.cu's
// flash_bwd_kv_wgmma_kernel and flash_bwd_q_wgmma_kernel, mla_attention.cu's
// mla_attention_wgmma_kernel, mla_attention_bwd.cu's mla_bwd_q_wgmma_kernel
// and mla_bwd_kv_wgmma_kernel).  Tiles in shared memory are 64 rows of 128
// bytes (64 bf16) in the 128-byte swizzle, from a 1024-aligned base.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte chunk c (0..7) of row r of a tile of 128-byte rows whose base is
// 1024-aligned, in the 128-byte swizzle
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int r, int c) {
  return tile + r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes, zero-filled when !valid (the source address is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// make this thread's cp.async writes visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the
// 128-byte swizzle: start address >> 4, leading offset 1 (unused when one
// swizzle row spans the operand's 64 elements), stride 1024 bytes between
// groups of 8 rows, layout type 1 (128-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WGMMA_D32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define WGMMA_D32_OPERANDS(d)                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, fp32) (+)= A (64 x 16, K-major in shared memory) .
// B (16 x 64, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32_OPERANDS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragment in registers) .
// B (16 x 64, MN-major in shared memory: the transpose bit is set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define WGMMA_D16                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32, fp32) (+)= A (64 x 16, K-major in shared memory) .
// B (16 x 32, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two warpgroups that split a product's keys (or rows) pass each other
// the A fragments of their halves: W words a thread, thread lt's word w at
// xw[wg][w][lt] (no bank conflict); after the barrier thread lt of the
// other warpgroup reads them, since the fragment it needs for the other
// half is the one thread lt holds for its own.
template <int W>
__device__ __forceinline__ void exchange(uint32_t (*xw)[W][128],
                                         const uint32_t (&own)[W],
                                         uint32_t (&other)[W], int wg,
                                         int lt) {
#pragma unroll
  for (int w = 0; w < W; ++w) xw[wg][w][lt] = own[w];
  __syncthreads();
#pragma unroll
  for (int w = 0; w < W; ++w) other[w] = xw[wg ^ 1][w][lt];
}

// ---- the latent (MLA) kernels' tiles: 64 rows of [rope ; latent], a
// rope part of 64 bf16 and a latent part of 512, as 9 pieces of 64 x 64
// bf16 (8 KB each): piece 0 the rope part, pieces 1..8 the latent's
// 64-column pieces
constexpr int kPiece = 64 * 128;
constexpr int kPieces = 9;

// Piece j of rows first .. first + 63 of a latent pair (rows of 64 bf16 at
// `rope`, of 512 at `lat`) into the piece at dst, 16-byte copies by the NT
// threads t = 0 .. NT - 1 of a group; rows at or past `end` are
// zero-filled (their source address kept at row 0).  Pieces 1..8 read
// only `lat`.
template <int NT>
__device__ __forceinline__ void stage_latent_piece(
    uint32_t dst, const __nv_bfloat16* rope, const __nv_bfloat16* lat,
    int first, int end, int j, int t) {
  for (int e = t; e < 64 * 8; e += NT) {
    const int k = e >> 3, c = e & 7;
    const bool ok = first + k < end;
    const long long r = ok ? first + k : 0;
    const __nv_bfloat16* src =
        j == 0 ? rope + r * 64 + 8 * c : lat + r * 512 + 64 * (j - 1) + 8 * c;
    cp_async16(swizzled(dst, k, c), src, ok);
  }
}

// All 9 pieces of rows first .. first + 63 of a latent pair into the
// pieces from dst on (piece j at dst + j kPiece), as stage_latent_piece
template <int NT>
__device__ __forceinline__ void stage_latent_rows(
    uint32_t dst, const __nv_bfloat16* rope, const __nv_bfloat16* lat,
    int first, int end, int t) {
  for (int e = t; e < 64 * kPieces * 8; e += NT) {
    const int i = e / (kPieces * 8), c = e - i * (kPieces * 8);
    const bool ok = first + i < end;
    const long long r = ok ? first + i : 0;
    const __nv_bfloat16* src =
        c < 8 ? rope + r * 64 + 8 * c : lat + r * 512 + 8 * (c - 8);
    cp_async16(swizzled(dst + (c >> 3) * kPiece, i, c & 7), src, ok);
  }
}

}  // namespace

// span_gain: the gain matrix of one greedy set-cover round.
//
// Replaces the Pallas TPU kernel src/repro/kernels/span_gain/kernel.py
// (`span_gain`, body `_span_gain_kernel`).  For every still-active query a
// and partition n it counts the query's uncovered pins that n stores:
//
//     gain[a, n] = sum_w popcount(codes[a, n, w] & rem[a, w])
//
// codes (A, N, W) and rem (A, W) are the engine's uint64 words, handed over
// as int64 tensors and read here as unsigned long long; gain is int32.
//
// What bounds it on an H100: bytes.  Each word is read once and takes three
// integer operations (and, popcount, add), so the kernel moves
// A*N*W*8 + A*W*8 + A*N*4 bytes at the HBM rate and is far below the
// ALU rate.  The design does what keeps the traffic at that minimum: one
// thread per (a, n) output, consecutive threads on consecutive (a, n) so
// the codes rows are read coalesced, rem rows hit L1/L2 (N threads share
// one), and no masked intermediate is ever written.  The TPU's uint32 lane
// split and its (A, 2W, N) transpose were there for the TPU's vector
// layout and are not carried over.

#include <cuda_runtime.h>

namespace {

__global__ void span_gain_kernel(const unsigned long long* __restrict__ codes,
                                 const unsigned long long* __restrict__ rem,
                                 int* __restrict__ out, long long total,
                                 int N, int W) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long a = i / N;
  const unsigned long long* c = codes + i * W;
  const unsigned long long* r = rem + a * W;
  int g = 0;
  for (int w = 0; w < W; ++w) g += __popcll(c[w] & r[w]);
  out[i] = g;
}

}  // namespace

extern "C" const char* repro_torch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int span_gain_launch(const void* codes, const void* rem, void* out,
                                long long A, int N, int W, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long total = A * (long long)N;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    span_gain_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(
        (const unsigned long long*)codes, (const unsigned long long*)rem,
        (int*)out, total, N, W);
  }
  return (int)cudaGetLastError();
}

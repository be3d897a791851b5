// Per-device moments of a stacked fp32 gradient, K-block by K-block:
// sumsq[k] = sum_j g[k,j]^2 and sums[k] = sum_j g[k,j] for g of shape [K, N]
// (row-major, contiguous), with the devices tiled into K-blocks of k_block.
//
// Replaces the TPU kernel repro/kernels/grad_norm.py::streaming_blocked_moments
// (body _stream_moments_kernel).  There the (K-block, N-block) grid runs in
// order on one core and the [k_block] output tile is revisited once per
// N-block as an fp32 accumulator; its caller zero-pads the stack to
// [K, rows, 1024] by concatenation.  On Hopper no block carries a sum over
// to another, so each device row is reduced to the end by the threads that
// own it, and the stack is read in place.
//
// Bound on an H100: bytes.  The function reads K*N*4 bytes once and writes
// 2*K*4; 3 flops per element are far under the fp32 rate.  At the K-scale
// shape (K = 100,000, N = 2,048) that is 819 MB, ~245 us at 3.35 TB/s.
//
// Design, for many short rows (the K-scale shape):
//  * A CTA of 256 threads (8 warps) owns 8 / wpr device rows of one K-block;
//    wpr warps (1, 2, 4 or 8, from N alone) walk each row in N order: a
//    scalar head up to the row's first 16-byte boundary, a float4 body and a
//    scalar tail (rows misalign when N % 4 != 0).  At N = 2,048 one warp owns
//    a row, and the K-scale grid is 12,500 CTAs; a long row (N = 55,050)
//    gets all 8 warps so that a small K still keeps loads in flight.
//  * Each warp reduces with shuffles, and the first thread of a row adds its
//    warps' sums in warp order, then writes the row's finished sums: no
//    partial buffer, no second launch, no atomics.  The order depends on N
//    only, so neither K nor k_block changes any device's result.
//  * k_block tiles the grid: CTA b works in K-block b / ctas_per_block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
}

__global__ void __launch_bounds__(kThreads)
stream_moments_kernel(const float* __restrict__ g, long long n,
                      long long k_block, int wpr, long long ctas_per_block,
                      float* __restrict__ sumsq, float* __restrict__ sums) {
  const int rows_per_cta = kWarps / wpr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = warp / wpr;      // which of this CTA's rows
  const int sub = warp % wpr;       // which warp of that row
  const long long kblk = blockIdx.x / ctas_per_block;
  const long long local =
      (blockIdx.x % ctas_per_block) * rows_per_cta + slot;
  const bool live = local < k_block;
  const long long k = kblk * k_block + local;

  float sq = 0.f, s = 0.f;
  if (live) {
    const float* row = g + k * n;
    long long head = (long long)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2);
    if (head > n) head = n;
    const long long nvec = (n - head) >> 2;
    const float4* body = reinterpret_cast<const float4*>(row + head);
    const int t = sub * 32 + lane;
    const int stride = wpr * 32;
    if (t < head) {
      const float x = __ldg(row + t);
      sq += x * x;
      s += x;
    }
#pragma unroll 4
    for (long long v = t; v < nvec; v += stride) {
      const float4 x = __ldg(body + v);
      sq += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
      s += x.x + x.y + x.z + x.w;
    }
    for (long long i = head + 4 * nvec + t; i < n; i += stride) {
      const float x = __ldg(row + i);
      sq += x * x;
      s += x;
    }
  }
  warp_sum2(sq, s);

  __shared__ float w_sq[kWarps];
  __shared__ float w_s[kWarps];
  if (lane == 0) {
    w_sq[warp] = sq;
    w_s[warp] = s;
  }
  __syncthreads();
  if (live && sub == 0 && lane == 0) {
    float a = w_sq[warp], b = w_s[warp];
    for (int w = 1; w < wpr; ++w) {  // fixed warp order
      a += w_sq[warp + w];
      b += w_s[warp + w];
    }
    sumsq[k] = a;
    sums[k] = b;
  }
}

// Warps per row, from N alone: one warp for rows up to 4,096 elements, up to
// all 8 for rows of 32,768 or more.
int warps_per_row(long long n) {
  int wpr = 1;
  while (wpr < kWarps && (long long)wpr * 4096 < n) wpr <<= 1;
  return wpr;
}

}  // namespace

extern "C" {

// k_block must divide k (the wrapper checks).  Launches on `stream`;
// returns cudaGetLastError().
int stream_moments_launch(const float* g, long long k, long long n,
                          long long k_block, float* sumsq, float* sums,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wpr = warps_per_row(n);
  const int rows_per_cta = kWarps / wpr;
  const long long ctas_per_block = (k_block + rows_per_cta - 1) / rows_per_cta;
  const long long blocks = (k / k_block) * ctas_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stream_moments_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      g, n, k_block, wpr, ctas_per_block, sumsq, sums);
  return (int)cudaGetLastError();
}

const char* stream_moments_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Per-device moments of a stacked fp32 gradient, K-block by K-block:
// sumsq[k] = sum_j g[k,j]^2 and sums[k] = sum_j g[k,j] for g of shape [K, N]
// (row-major, contiguous), with the devices tiled into K-blocks of k_block.
//
// Replaces the TPU kernel repro/kernels/grad_norm.py::streaming_blocked_moments
// (body _stream_moments_kernel).  There the (K-block, N-block) grid runs in
// order on one core and the [k_block] output tile is revisited once per
// N-block as an fp32 accumulator; its caller zero-pads the stack to
// [K, rows, 1024] by concatenation.  On Hopper no block carries a sum over
// to another, and k_block only tiles the grid: the function is K1's
// (csrc/moments.cu), and no device's sums depend on K or k_block.
//
// Bound on an H100: bytes.  The function reads K*N*4 bytes once and writes
// 2*K*4; 3 flops per element are far under the fp32 rate.  At the K-scale
// shape (K = 100,000, N = 2,048) that is 819 MB, ~245 us at 3.35 TB/s.
//
// Design.  The rows are split by N alone
// (repro_torch/kernels/grad_norm.py::stream_moments_chunks):
//  * Long rows (N > 4,096) are split into fixed chunks of 4,096 elements,
//    partials [K, chunks] and a second pass that adds each device's
//    partials in chunk order: K1's device x N-chunk kernels, which the
//    wrapper launches from K1's library rather than from a copy here.  One
//    CTA a row would give 20 CTAs at the FL round's K = 20 and 7 at
//    K = 7, N = 1,000,003, each walking its row alone.
//  * Short rows (N <= 4,096, the K-scale shape) are this file's kernel: one
//    warp owns one row and reduces it alone, so there is no shared-memory
//    stage, no __syncthreads and no second pass.  Each lane walks the row's
//    float4 body with kUnroll independent 16-byte loads in flight, after a
//    scalar head up to the row's first 16-byte boundary (rows misalign when
//    N % 4 != 0) and before a scalar tail; the warp then adds its lanes'
//    sums with shuffles, and lane 0 writes the row's two sums.  A CTA of 4
//    warps holds 4 rows: 250 CTAs at K = 1,000, 25,000 at the K-scale
//    shape.
//  * No 64-bit division or modulo in the kernel: nvcc compiles one to a
//    called subroutine, with a stack frame and spills around the call.
//  * The order of each row's sum depends on N and on the row's 16-byte
//    alignment only.  No atomics: the result is the same from launch to
//    launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // float4 loads in flight per lane
constexpr int kRowMax = 4096;  // the longest row one warp reads alone

__device__ __forceinline__ void add4(const float4 x, float& sq, float& s) {
  sq += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
  s += x.x + x.y + x.z + x.w;
}

__global__ void __launch_bounds__(kThreads)
row_moments_kernel(const float* __restrict__ g, long long k, int n,
                   float* __restrict__ sumsq, float* __restrict__ sums) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= k) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const float* p = g + row * n;
  int head = (int)(((16u - ((uintptr_t)p & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const int nvec = (n - head) >> 2;
  const float4* body = reinterpret_cast<const float4*>(p + head);

  float sq = 0.f, s = 0.f;
  if (lane < head) {
    const float x = __ldg(p + lane);
    sq += x * x;
    s += x;
  }
  int v = lane;
  for (; v + 32 * (kUnroll - 1) < nvec; v += 32 * kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(body + v + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add4(x[u], sq, s);
  }
  for (; v < nvec; v += 32) add4(__ldg(body + v), sq, s);
  for (int i = head + 4 * nvec + lane; i < n; i += 32) {
    const float x = __ldg(p + i);
    sq += x * x;
    s += x;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sq += __shfl_down_sync(0xffffffffu, sq, off);
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    sumsq[row] = sq;
    sums[row] = s;
  }
}

}  // namespace

extern "C" {

// Rows of 1 <= n <= 4,096 elements (longer rows take K1's split).
// Launches on `stream`; returns cudaGetLastError().
int stream_moments_launch(const float* g, long long k, long long n,
                          float* sumsq, float* sums, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kRowMax) return (int)cudaErrorInvalidValue;
  const long long blocks = (k + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  row_moments_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(g, k, (int)n,
                                                            sumsq, sums);
  return (int)cudaGetLastError();
}

const char* stream_moments_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

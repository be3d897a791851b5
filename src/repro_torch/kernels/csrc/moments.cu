// Per-device moments of a stacked fp32 gradient: sumsq[k] = sum_j g[k,j]^2
// and sums[k] = sum_j g[k,j] for g of shape [K, N] (row-major, contiguous).
//
// Replaces the TPU kernel repro/kernels/grad_norm.py::batched_blocked_moments
// (body _moments_kernel), whose caller zero-pads the stack to
// [K, rows, 1024] by concatenation (repro/kernels/ops.py::_pack_flat_batched)
// -- a full copy made for the TPU's (8, 128) tiling.
//
// Bound on an H100: bytes.  The function reads K*N*4 bytes once and writes
// 2*K*4; it does 3 flops per element, far under the fp32 rate.  At the FL
// round's shape (K = 20, N = 55,050) that is 4.40 MB, 1.31 us at 3.35 TB/s,
// so launch overhead dominates there; at K = 1000 it is 220 MB, ~66 us.
//
// Design:
//  * The stack is read in place: no padding copy.  Each row is split into a
//    scalar head up to the first 16-byte boundary, a float4 body, and a
//    scalar tail, so 16-byte loads are used wherever the row allows: when
//    N % 4 != 0 (N = 55,050 on the FL round) consecutive rows start at
//    different alignments, and the ragged tail runs on every launch.
//  * One block would give only K blocks (20 on 132 SMs), so the grid is
//    device x N-chunk, flattened to 1-D: block b handles device b / nchunks,
//    float4 chunk b % nchunks.
//  * Each block reduces with warp shuffles, then across its warps in a fixed
//    order, into fp32 partials [K, nchunks].  A second small kernel sums each
//    device's partials in chunk order.  No atomics: the result is the same
//    from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr long long kChunkVec = (long long)kThreads * kVecPerThread;  // float4s per chunk

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
}

__global__ void __launch_bounds__(kThreads)
moments_partial_kernel(const float* __restrict__ g, long long n, int nchunks,
                       float* __restrict__ part_sq, float* __restrict__ part_s) {
  const long long k = blockIdx.x / nchunks;
  const int j = blockIdx.x % nchunks;
  const float* row = g + k * n;

  // elements before the row's first 16-byte boundary
  long long head = (long long)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  const float4* body = reinterpret_cast<const float4*>(row + head);

  float sq = 0.f, s = 0.f;
  const long long v0 = (long long)j * kChunkVec;
  long long v1 = v0 + kChunkVec;
  if (v1 > nvec) v1 = nvec;
#pragma unroll 4
  for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
    const float4 x = __ldg(body + v);
    sq += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
    s += x.x + x.y + x.z + x.w;
  }
  if (j == 0 && threadIdx.x < head) {
    const float x = __ldg(row + threadIdx.x);
    sq += x * x;
    s += x;
  }
  if (j == nchunks - 1) {
    for (long long i = head + 4 * nvec + threadIdx.x; i < n; i += kThreads) {
      const float x = __ldg(row + i);
      sq += x * x;
      s += x;
    }
  }

  __shared__ float w_sq[kThreads / 32];
  __shared__ float w_s[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_sum2(sq, s);
  if (lane == 0) {
    w_sq[warp] = sq;
    w_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    sq = lane < kThreads / 32 ? w_sq[lane] : 0.f;
    s = lane < kThreads / 32 ? w_s[lane] : 0.f;
    warp_sum2(sq, s);
    if (lane == 0) {
      part_sq[k * nchunks + j] = sq;
      part_s[k * nchunks + j] = s;
    }
  }
}

__global__ void moments_finish_kernel(const float* __restrict__ part_sq,
                                      const float* __restrict__ part_s,
                                      long long k, int nchunks,
                                      float* __restrict__ sumsq,
                                      float* __restrict__ sums) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  float a = 0.f, b = 0.f;
  for (int c = 0; c < nchunks; ++c) {  // fixed chunk order
    a += part_sq[i * nchunks + c];
    b += part_s[i * nchunks + c];
  }
  sumsq[i] = a;
  sums[i] = b;
}

}  // namespace

extern "C" {

// Number of N-chunks per device: the wrapper sizes the [2, K, nchunks]
// partials scratch with it.
int moments_num_chunks(long long n) {
  const long long nvec_max = (n + 3) / 4;
  const long long c = (nvec_max + kChunkVec - 1) / kChunkVec;
  return c < 1 ? 1 : (int)c;
}

// Launches both passes on `stream`; returns cudaGetLastError().
int moments_launch(const float* g, long long k, long long n, int nchunks,
                   float* part_sq, float* part_s, float* sumsq, float* sums,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = k * nchunks;
  moments_partial_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      g, n, nchunks, part_sq, part_s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fin_threads = 128;
  const long long fin_blocks = (k + fin_threads - 1) / fin_threads;
  moments_finish_kernel<<<(unsigned)fin_blocks, fin_threads, 0, st>>>(
      part_sq, part_s, k, nchunks, sumsq, sums);
  return (int)cudaGetLastError();
}

const char* moments_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

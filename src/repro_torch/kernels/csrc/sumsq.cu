// Sum of squares of one contiguous fp32 vector of any length:
//   out[0] = sum_i x[i]^2
// (ops.grad_norm takes the square root).
//
// Replaces the TPU kernel repro/kernels/grad_norm.py::blocked_sumsq (body
// _sumsq_kernel), which writes one partial per [block_rows, 1024] block of a
// copy of the vector zero-padded to [rows, 1024]; its wrapper
// (repro/kernels/ops.py::grad_norm) sums the partials and takes the root.
//
// Bound on an H100: bytes.  The function reads n*4 bytes and writes 4; 2
// flops per element are far under the fp32 rate.  For the K-scale gradient
// stack flattened (204.8 M elements, 819 MB) that is ~245 us at 3.35 TB/s.
//
// Design:
//  * The vector is read in place: a scalar head up to the first 16-byte
//    boundary, a float4 body, a scalar tail (CTA 0 takes head and tail).
//  * Pass 1: grid-stride CTAs over the float4 body, at most kMaxCtas of
//    them (a number that depends on n only, not on the card), each reduced
//    with warp shuffles and then across its warps in a fixed order into one
//    partial.
//  * Pass 2: one warp folds the partials in a fixed order (lane l takes
//    partials l, l + 32, ... in turn, then a shuffle tree).  No atomics: the
//    result is the same from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 8;
constexpr long long kMaxCtas = 1056;  // 8 per SM on a 132-SM H100

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a += __shfl_down_sync(0xffffffffu, a, off);
  return a;
}

__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const float* __restrict__ x, long long n,
                     float* __restrict__ part) {
  long long head = (long long)(((16u - ((uintptr_t)x & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  const float4* body = reinterpret_cast<const float4*>(x + head);

  float sq = 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
#pragma unroll 4
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
       v < nvec; v += stride) {
    const float4 u = __ldg(body + v);
    sq += u.x * u.x + u.y * u.y + u.z * u.z + u.w * u.w;
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) {
      const float u = __ldg(x + threadIdx.x);
      sq += u * u;
    }
    const long long i = head + 4 * nvec + threadIdx.x;
    if (i < n) {  // at most 3 tail elements
      const float u = __ldg(x + i);
      sq += u * u;
    }
  }

  __shared__ float w_sq[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  sq = warp_sum(sq);
  if (lane == 0) w_sq[warp] = sq;
  __syncthreads();
  if (warp == 0) {
    sq = lane < kThreads / 32 ? w_sq[lane] : 0.f;
    sq = warp_sum(sq);
    if (lane == 0) part[blockIdx.x] = sq;
  }
}

__global__ void sumsq_finish_kernel(const float* __restrict__ part,
                                    int nparts, float* __restrict__ out) {
  float a = 0.f;
  for (int i = threadIdx.x; i < nparts; i += 32) a += part[i];
  a = warp_sum(a);
  if (threadIdx.x == 0) out[0] = a;
}

}  // namespace

extern "C" {

// Number of pass-1 CTAs (= partials) for a vector of n elements: the
// wrapper sizes the partials scratch with it.
int sumsq_num_partials(long long n) {
  const long long nvec = (n + 3) / 4;
  long long c = (nvec + (long long)kThreads * kVecPerThread - 1) /
                ((long long)kThreads * kVecPerThread);
  if (c < 1) c = 1;
  if (c > kMaxCtas) c = kMaxCtas;
  return (int)c;
}

// Launches both passes on `stream`; returns cudaGetLastError().
int sumsq_launch(const float* x, long long n, int nparts, float* part,
                 float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sumsq_partial_kernel<<<(unsigned)nparts, kThreads, 0, st>>>(x, n, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sumsq_finish_kernel<<<1, 32, 0, st>>>(part, nparts, out);
  return (int)cudaGetLastError();
}

const char* sumsq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

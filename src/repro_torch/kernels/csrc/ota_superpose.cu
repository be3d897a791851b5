// Fused over-the-air superposition, the paper's eq. 10 in one pass:
//   y[j] = a * ( sum_k scale[k] * pre(g[k, j]) + z[j] ),  pre in {identity, sign}
// for g of shape [K, N] fp32 (row-major, contiguous), scale [K], z [N].
//
// Replaces the TPU kernel repro/kernels/ota_aggregate.py::ota_aggregate_blocked
// (body _ota_kernel), whose caller zero-pads g and the noise to a multiple of
// the block by concatenation (repro/kernels/ops.py::ota_superpose).
//
// Bound on an H100: bytes.  The function reads K*N*4 + N*4 + K*4 bytes and
// writes N*4; it does 2*K*N flops, far under the fp32 rate.  At the FL
// round's shape (K = 20, N = 55,050) that is 4.84 MB, 1.45 us at 3.35 TB/s.
//
// Design:
//  * Each thread owns one column j and walks k = 0..K-1 in order, so a warp's
//    loads of one row are 32 neighbouring floats (coalesced) and the K-way sum
//    has one fixed order: deterministic, no atomics.  The k loop is unrolled
//    so several rows' loads are in flight per thread.
//  * No padding copy: the grid covers ceil(N / 256) blocks and the ragged
//    last block is masked.
//  * scale[k] is read through the read-only cache (one address per warp, a
//    broadcast); a is a host float.
//  * sign follows jnp.sign: sign(0) = 0 and NaN stays NaN.  copysignf is not
//    used, since it returns +-1 at zero.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sign_of(float x) {
  const float s = (float)((x > 0.f) - (x < 0.f));
  return x != x ? x : s;
}

template <bool kSign>
__global__ void __launch_bounds__(kThreads)
ota_superpose_kernel(const float* __restrict__ g,
                     const float* __restrict__ scale,
                     const float* __restrict__ noise, float a, long long k,
                     long long n, float* __restrict__ y) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n;
       j += stride) {
    const float* col = g + j;
    float acc = 0.f;
#pragma unroll 8
    for (long long i = 0; i < k; ++i) {
      float x = __ldg(col + i * n);
      if (kSign) x = sign_of(x);
      acc += __ldg(scale + i) * x;
    }
    y[j] = a * (acc + __ldg(noise + j));
  }
}

}  // namespace

extern "C" {

// pre: 0 = identity, 1 = sign.  Launches on `stream`; returns
// cudaGetLastError().
int ota_superpose_launch(const float* g, const float* scale,
                         const float* noise, float a, long long k,
                         long long n, int pre, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride covers the rest
  if (pre == 1) {
    ota_superpose_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        g, scale, noise, a, k, n, y);
  } else {
    ota_superpose_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        g, scale, noise, a, k, n, y);
  }
  return (int)cudaGetLastError();
}

const char* ota_superpose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Streamed over-the-air superposition, the paper's eq. 10 with the K-way sum
// folded K-block by K-block, in order:
//   p_b[j] = sum_{k in block b} scale[k] * pre(g[k, j])
//   y[j]   = a * ( ((p_0[j] + p_1[j]) + p_2[j]) + ... + z[j] )
// for g of shape [K, N] fp32 (row-major, contiguous), scale [K], z [N],
// pre in {identity, sign}, and K-blocks of k_block devices.
//
// Replaces the TPU kernel repro/kernels/ota_aggregate.py::ota_aggregate_streaming
// (body _ota_stream_kernel).  There an (N-block, K-block) grid runs in order
// on one core, the [N-block] output tile is the fp32 accumulator revisited
// once per K-block, and noise and gain are applied at the last K-block; its
// caller zero-pads g and the noise by concatenation.
//
// Bound on an H100: bytes.  The function reads K*N*4 + N*4 + K*4 bytes and
// writes N*4; 2*K*N flops are far under the fp32 rate.  At the K-scale shape
// (K = 100,000, N = 2,048) that is 819 MB, ~245 us at 3.35 TB/s.
//
// Design: a split over K-blocks with a fixed-order second pass.
//  * Pass 1: CTA (N-tile, K-block) has one thread per column of its
//    256-column tile; each thread walks the block's k_block rows in order
//    and writes its partial p_b[j] to a [nb, N] buffer (the wrapper
//    allocates it; 819 KB at the K-scale shape).  A warp's loads of one row
//    are 32 neighbouring floats.  At the K-scale shape that is 8 x 100 = 800
//    CTAs, where one thread per column over all of K (as the dense kernel
//    does) would start only 2,048 threads, each walking 100,000 rows.
//  * Pass 2: one thread per column folds p_0, p_1, ... in block order and
//    applies a * (acc + z[j]).  No atomics: the result is the same from run
//    to run, and the association is the reference's.
//  * No padding copy: the ragged last N-tile is masked.
//  * sign follows jnp.sign: sign(0) = 0 and NaN stays NaN.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sign_of(float x) {
  const float s = (float)((x > 0.f) - (x < 0.f));
  return x != x ? x : s;
}

template <bool kSign>
__global__ void __launch_bounds__(kThreads)
stream_partial_kernel(const float* __restrict__ g,
                      const float* __restrict__ scale, long long n,
                      long long k_block, long long tiles,
                      float* __restrict__ part) {
  const long long b = blockIdx.x / tiles;          // K-block
  const long long j = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (j >= n) return;
  const long long k0 = b * k_block;
  const float* col = g + k0 * n + j;
  const float* s = scale + k0;
  float acc = 0.f;
#pragma unroll 8
  for (long long i = 0; i < k_block; ++i) {
    float x = __ldg(col + i * n);
    if (kSign) x = sign_of(x);
    acc += __ldg(s + i) * x;
  }
  part[b * n + j] = acc;
}

__global__ void __launch_bounds__(kThreads)
stream_finish_kernel(const float* __restrict__ part,
                     const float* __restrict__ noise, float a, long long n,
                     long long nb, float* __restrict__ y) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  float acc = part[j];
  for (long long b = 1; b < nb; ++b) acc += part[b * n + j];  // block order
  y[j] = a * (acc + __ldg(noise + j));
}

}  // namespace

extern "C" {

// k_block must divide k (the wrapper checks); part is [k / k_block, n].
// pre: 0 = identity, 1 = sign.  Launches both passes on `stream`; returns
// cudaGetLastError().
int ota_superpose_stream_launch(const float* g, const float* scale,
                                const float* noise, float a, long long k,
                                long long n, long long k_block, int pre,
                                float* part, float* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nb = k / k_block;
  const long long tiles = (n + kThreads - 1) / kThreads;
  const long long blocks = nb * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (pre == 1) {
    stream_partial_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        g, scale, n, k_block, tiles, part);
  } else {
    stream_partial_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        g, scale, n, k_block, tiles, part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stream_finish_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      part, noise, a, n, nb, y);
  return (int)cudaGetLastError();
}

const char* ota_superpose_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

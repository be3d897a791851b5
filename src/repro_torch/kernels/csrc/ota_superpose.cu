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
// round's shape (K = 20, N = 55,050) that is 4.84 MB, 1.45 us at 3.35 TB/s;
// at the streaming round's tile (K = 1,000, N = 2,048) 8.2 MB, 2.45 us.
//
// Design (split K, fold in a fixed order):
//  * A thread owns one column j of one K-chunk and walks the chunk's rows in
//    order, so a warp's loads of one row are 32 neighbouring floats
//    (coalesced).  The k loop is unrolled so that several rows' loads are in
//    flight per thread.  The loads stay scalar: 2 or 4 columns a thread
//    (float2 or float4, where the rows allow) moved the wide shape by under
//    2 % and slowed N = 2,048, whose grid they shrink.  The j loop keeps its
//    grid-stride form: the same body behind an early return was slower.
//  * The K rows are split into S chunks of equal length (the last may be
//    shorter); the grid is (N-tiles, S).  One column a thread gives only
//    ceil(N / 256) tiles -- 8 CTAs on 132 SMs at N = 2,048, each thread
//    walking 1,000 rows -- so S is chosen on the host from (K, N) alone
//    (repro_torch/kernels/ota_aggregate.py::superpose_split): as many chunks
//    as one wave of resident CTAs holds (8 of 256 threads an SM), with at
//    least 32 rows a chunk so that the partials stay a small share of the
//    bytes and the fold short.  A grid past one wave leaves a tail: at
//    K = 1,000, N = 55,050, S = 5 (1,080 CTAs) is slower than S = 4 (864).
//  * S = 1 (small K, as the FL round's K = 20, or a grid that fills a wave
//    already): one launch, y written directly, the association of the
//    unsplit sum.  S > 1: pass 1 writes each chunk's column sums to
//    partials [S, N]; pass 2, one thread a column, adds p_0, p_1, ... in
//    chunk order and applies the gain and the noise.  No atomics: the
//    result depends on (K, N) and the data only, the same from launch to
//    launch.
//  * No padding copy: the ragged last tile is masked.  scale[k] is read
//    through the read-only cache (one address per warp, a broadcast); a is
//    a host float.
//  * sign follows jnp.sign: sign(0) = 0 and NaN stays NaN.  copysignf is not
//    used, since it returns +-1 at zero.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFoldThreads = 128;

__device__ __forceinline__ float sign_of(float x) {
  const float s = (float)((x > 0.f) - (x < 0.f));
  return x != x ? x : s;
}

// Column sums of rows [i0, i1): with kSplit, chunk blockIdx.y's rows
// [chunk * rows, min(K, (chunk + 1) * rows)), written to out[chunk * N + j];
// without, all K rows, and out[j] = y[j] = a (acc + z[j]).
template <bool kSign, bool kSplit>
__global__ void __launch_bounds__(kThreads)
superpose_chunk_kernel(const float* __restrict__ g,
                       const float* __restrict__ scale,
                       const float* __restrict__ noise, float a, long long k,
                       long long n, long long rows, float* __restrict__ out) {
  const long long i0 = kSplit ? (long long)blockIdx.y * rows : 0;
  const long long i1 = !kSplit ? k : i0 + rows < k ? i0 + rows : k;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n;
       j += stride) {
    const float* col = g + j;
    float acc = 0.f;
#pragma unroll 8
    for (long long i = i0; i < i1; ++i) {
      float x = __ldg(col + i * n);
      if (kSign) x = sign_of(x);
      acc += __ldg(scale + i) * x;
    }
    if (kSplit) {
      out[(long long)blockIdx.y * n + j] = acc;
    } else {
      out[j] = a * (acc + __ldg(noise + j));
    }
  }
}

template <bool kSign>
void launch_chunks(dim3 grid, cudaStream_t st, const float* g,
                   const float* scale, const float* noise, float a,
                   long long k, long long n, long long rows, float* out) {
  if (grid.y == 1) {
    superpose_chunk_kernel<kSign, false><<<grid, kThreads, 0, st>>>(
        g, scale, noise, a, k, n, rows, out);
  } else {
    superpose_chunk_kernel<kSign, true><<<grid, kThreads, 0, st>>>(
        g, scale, noise, a, k, n, rows, out);
  }
}

// y[j] = a (p_0[j] + p_1[j] + ... + p_{S-1}[j] + z[j]), in chunk order.
__global__ void __launch_bounds__(kFoldThreads)
superpose_fold_kernel(const float* __restrict__ part,
                      const float* __restrict__ noise, float a, int s,
                      long long n, float* __restrict__ y) {
  const long long j = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (j >= n) return;
  float acc = __ldg(part + j);
#pragma unroll 8
  for (int c = 1; c < s; ++c) acc += __ldg(part + (long long)c * n + j);
  y[j] = a * (acc + __ldg(noise + j));
}

}  // namespace

extern "C" {

// pre: 0 = identity, 1 = sign.  s: the number of K-chunks, each of
// ceil(K / s) rows; it must leave no chunk empty (the wrapper's
// superpose_split gives such an s).  part: [s, N] fp32 scratch when s > 1
// (unused when s == 1).  Launches on `stream`; returns cudaGetLastError().
int ota_superpose_launch(const float* g, const float* scale,
                         const float* noise, float a, long long k,
                         long long n, int s, int pre, float* part, float* y,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || s > 65535) return (int)cudaErrorInvalidValue;
  const long long rows = (k + s - 1) / s;
  if ((k + rows - 1) / rows != s) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kThreads - 1) / kThreads;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)s);
  float* out = s == 1 ? y : part;
  if (pre == 1) {
    launch_chunks<true>(grid, st, g, scale, noise, a, k, n, rows, out);
  } else {
    launch_chunks<false>(grid, st, g, scale, noise, a, k, n, rows, out);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || s == 1) return (int)err;
  const long long fold = (n + kFoldThreads - 1) / kFoldThreads;
  superpose_fold_kernel<<<(unsigned)fold, kFoldThreads, 0, st>>>(
      part, noise, a, s, n, y);
  return (int)cudaGetLastError();
}

const char* ota_superpose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

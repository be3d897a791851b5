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
//    through the read-only cache (one address per warp, a broadcast).  So
//    is the gain a, a 0-d fp32 tensor in device memory, where a column is
//    written: a CUDA graph that replays the launch then reads each round's
//    gain (the FL round's a_eff changes every round under partial
//    participation).  The product with a comes last, y = a * (acc + z), so
//    no fma can absorb it, and the bits are those of the same gain passed
//    by value.
//  * sign follows jnp.sign: sign(0) = 0 and NaN stays NaN.  copysignf is not
//    used, since it returns +-1 at zero.
//
// The streamed superposition (K4) is the same sum folded K-block by K-block
// in block order, the reference's association:
//   p_b[j] = sum_{k in block b} scale[k] * pre(g[k, j])
//   y[j]   = a * ( ((p_0[j] + p_1[j]) + p_2[j]) + ... + z[j] )
// It replaces the TPU kernel repro/kernels/ota_aggregate.py::
// ota_aggregate_streaming (body _ota_stream_kernel), whose (N-block,
// K-block) grid runs in order on one core and revisits the output tile as
// its accumulator.  Bound: the same bytes as above (819 MB, ~245 us at the
// K-scale shape K = 100,000, N = 2,048).  superpose_blocks_kernel is the
// chunk kernel with the block structure kept explicit:
//  * S = 1 (the host's stream_split, from (K, N, k_block) alone): each
//    thread walks the blocks in order, sums one block into a register from
//    0, adds it to its running fold (the first block starts it) and writes
//    y once: no partials and no second launch.  One fma chain across a
//    block edge would round differently from fold + p_b.
//  * S > 1: chunk c holds whole K-blocks; each thread writes each of its
//    blocks' partials to part [nb, N], and superpose_fold_kernel adds the
//    nb partials in block order.  S stays within one wave of CTAs.
//  * Rows are loaded 8 at a time across block edges, so a short block
//    (k_block 1 at K = 7) still has 8 loads in flight a thread; a
//    countdown closes each block.
//  * 128 columns a CTA, held to 32 registers (16 CTAs an SM): at 48, 5
//    CTAs of 256 fit an SM and the K-scale shape's 800 ran in two waves;
//    1,600 CTAs of 128 spread over 132 SMs more evenly than 800 of 256.
//  * K2 keeps superpose_chunk_kernel.  Run on this kernel instead (one
//    block a chunk, a short last chunk closed at the chunk's end) it gave
//    K2's bits but was slower at four of K2's five shapes on an H100
//    (tools/kernel_sweep.py --only k2 against the chunk kernel): 3.65
//    against 3.11 us at [20, 55050], 8.87 against 6.62 at [1000, 2048],
//    84.2 against 77.4 at [1000, 55050], 285.8 against 269.8 at
//    [100000, 2048] (its split body spilled 24 bytes at 32 registers);
//    faster only at [7, 1000003], 10.5 against 12.5.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStreamThreads = 128;  // K4: columns a CTA
constexpr int kStreamCtasPerSm = 2048 / kStreamThreads;  // 32 registers
constexpr int kRowsInFlight = 8;    // K4: rows loaded at once a thread
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
                       const float* __restrict__ noise,
                       const float* __restrict__ gain, long long k,
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
      out[j] = __ldg(gain) * (acc + __ldg(noise + j));
    }
  }
}

template <bool kSign>
void launch_chunks(dim3 grid, cudaStream_t st, const float* g,
                   const float* scale, const float* noise, const float* a,
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
                      const float* __restrict__ noise,
                      const float* __restrict__ gain, int s, long long n,
                      float* __restrict__ y) {
  const long long j = (long long)blockIdx.x * kFoldThreads + threadIdx.x;
  if (j >= n) return;
  float acc = __ldg(part + j);
#pragma unroll 8
  for (int c = 1; c < s; ++c) acc += __ldg(part + (long long)c * n + j);
  y[j] = __ldg(gain) * (acc + __ldg(noise + j));
}

// K4: rows [i0, i1) of chunk blockIdx.y (all K rows without kSplit), in
// K-blocks of kb rows (kb divides the chunk's rows).  With kSplit each
// block's column sums go to out[b * N + j], b the block's index; without,
// out[j] = y[j] = a (fold + z[j]), fold the blocks' sums in block order.
template <bool kSign, bool kSplit>
__global__ void __launch_bounds__(kStreamThreads, kStreamCtasPerSm)
superpose_blocks_kernel(const float* __restrict__ g,
                        const float* __restrict__ scale,
                        const float* __restrict__ noise,
                        const float* __restrict__ gain, int k, long long n,
                        int kb, int rows, float* __restrict__ out) {
  const int i0 = kSplit ? (int)blockIdx.y * rows : 0;
  const int i1 = kSplit ? min(k, i0 + rows) : k;
  const long long stride = (long long)gridDim.x * kStreamThreads;
  for (long long j = (long long)blockIdx.x * kStreamThreads + threadIdx.x;
       j < n; j += stride) {
    const float* col = g + (long long)i0 * n + j;
    float* part = out + (long long)(i0 / kb) * n + j;
    float acc = 0.f, fold = 0.f;
    bool first = true;
    int left = kb;
    for (int i = i0; i < i1; i += kRowsInFlight) {
      float x[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u, col += n)
        if (i + u < i1) x[u] = __ldg(col);
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        if (i + u < i1) {
          acc += __ldg(scale + i + u) * (kSign ? sign_of(x[u]) : x[u]);
          if (--left == 0) {  // the block ends: its sum is p_b
            if (kSplit) {
              *part = acc;
              part += n;
            } else {
              fold = first ? acc : fold + acc;
              first = false;
            }
            acc = 0.f;
            left = kb;
          }
        }
      }
    }
    if (!kSplit) out[j] = __ldg(gain) * (fold + __ldg(noise + j));
  }
}

template <bool kSign>
void launch_blocks(dim3 grid, cudaStream_t st, const float* g,
                   const float* scale, const float* noise, const float* a,
                   int k, long long n, int kb, int rows, float* out) {
  if (grid.y == 1) {
    superpose_blocks_kernel<kSign, false><<<grid, kStreamThreads, 0, st>>>(
        g, scale, noise, a, k, n, kb, rows, out);
  } else {
    superpose_blocks_kernel<kSign, true><<<grid, kStreamThreads, 0, st>>>(
        g, scale, noise, a, k, n, kb, rows, out);
  }
}

}  // namespace

extern "C" {

// a: the gain, one fp32 in device memory.
// pre: 0 = identity, 1 = sign.  s: the number of K-chunks, each of
// ceil(K / s) rows; it must leave no chunk empty (the wrapper's
// superpose_split gives such an s).  part: [s, N] fp32 scratch when s > 1
// (unused when s == 1).  Launches on `stream`; returns cudaGetLastError().
int ota_superpose_launch(const float* g, const float* scale,
                         const float* noise, const float* a, long long k,
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

// K4: y = a (((p_0 + p_1) + ...) + z) over K-blocks of k_block rows
// (k_block divides k), summed in s chunks of ceil(nb / s) whole blocks
// (nb = k / k_block); s must leave no chunk empty (the wrapper's
// stream_split gives such an s).  part: [nb, N] fp32 scratch when s > 1
// (unused when s == 1).  Launches on `stream`; returns cudaGetLastError().
int ota_superpose_stream_launch(const float* g, const float* scale,
                                const float* noise, const float* a,
                                long long k, long long n, long long k_block,
                                int s,
                                int pre, float* part, float* y,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || n < 1 || k > 0x7fffffffLL || k_block < 1 || k % k_block)
    return (int)cudaErrorInvalidValue;
  const long long nb = k / k_block;
  if (s < 1 || s > 65535 || s > nb) return (int)cudaErrorInvalidValue;
  const long long per = (nb + s - 1) / s;
  if ((nb + per - 1) / per != s) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kStreamThreads - 1) / kStreamThreads;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)s);
  float* out = s == 1 ? y : part;
  const int kb = (int)k_block, rows = (int)(per * k_block);
  if (pre == 1) {
    launch_blocks<true>(grid, st, g, scale, noise, a, (int)k, n, kb, rows,
                        out);
  } else {
    launch_blocks<false>(grid, st, g, scale, noise, a, (int)k, n, kb, rows,
                         out);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || s == 1) return (int)err;
  const long long fold = (n + kFoldThreads - 1) / kFoldThreads;
  superpose_fold_kernel<<<(unsigned)fold, kFoldThreads, 0, st>>>(
      part, noise, a, (int)nb, n, y);
  return (int)cudaGetLastError();
}

const char* ota_superpose_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

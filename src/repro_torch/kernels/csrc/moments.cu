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
// so launch overhead dominates there; ragged (K = 7, N = 1,000,003) 28 MB,
// 8.36 us; at K = 1000 220 MB, ~66 us.
//
// What held the first design back (4.77 us at the round's shape, 19.0 us
// ragged, where vector_norm(g, dim=1) takes 14.76): chunks fixed at 4,096
// elements whatever (K, N), so the ragged stack ran 1,715 CTAs (1.6 waves)
// of four 16-byte loads a thread, and a second kernel folded the partials
// after a launch gap that costs as much as the round's whole read.
//
// Design:
//  * The stack is read in place: no padding copy.  Each row is split into a
//    scalar head up to the first 16-byte boundary, a float4 body, and a
//    scalar tail, so 16-byte loads are used wherever the row allows: when
//    N % 4 != 0 (N = 55,050 on the FL round) consecutive rows start at
//    different alignments, and the ragged tail runs on every launch.
//  * The grid is device x chunk, flattened to 1-D, with `nchunks` chunks a
//    row from the host (kernels/grad_norm.py): `moments_split(k, n)` for
//    K1, at most one wave of CTAs with at least 8 float4s a thread; and
//    for K3's long rows `stream_moments_chunks(n)`, from N alone, so that a
//    device's sums do not depend on K.  A chunk is ceil(body / nchunks)
//    float4s of the row.  Each thread keeps kUnroll 16-byte loads in
//    flight; each block reduces with warp shuffles, then across its warps
//    in a fixed order.
//  * The fold runs in the same launch.  Each block writes its row's
//    partial, then adds one to the row's arrival counter with an
//    acquire-release atomic; the block that arrives last sums the row's
//    partials in a fixed order (thread t the chunks t, t + 256, ... in
//    turn, then the block's tree) and sets the counter back to 0, so the
//    next launch, or a replayed CUDA graph, starts clean.  The atomic
//    counts arrivals only: no value is summed by an atomic, so the bits
//    are the same from run to run.  Against a second kernel as a
//    programmatic dependent launch, a cluster folding through distributed
//    shared memory, and __threadfence before a plain atomicAdd, this was
//    the one that kept pace at all three of the round's, the wide and the
//    ragged shapes (tools/kernel_sweep.py --only k1; PERF.md).
//  * The counters belong to the caller: K unsigned ints, 0 before the
//    launch and 0 again after it.  The wrapper (kernels/grad_norm.py)
//    keeps one zeroed array for each stream, so launches that may overlap
//    (two streams, or two branches of a CUDA graph) never share one, and
//    launches that share one are ordered by their stream.
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;               // float4 loads in flight a thread
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
}

// The block's sums, in thread 0 (warps in order: a fixed tree).
__device__ __forceinline__ void block_sum2(float& sq, float& s) {
  __shared__ float w_sq[kWarps];
  __shared__ float w_s[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_sum2(sq, s);
  if (lane == 0) {
    w_sq[warp] = sq;
    w_s[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    sq = lane < kWarps ? w_sq[lane] : 0.f;
    s = lane < kWarps ? w_s[lane] : 0.f;
    warp_sum2(sq, s);
  }
}

__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ g, long long n, int nchunks,
               float* __restrict__ part_sq, float* __restrict__ part_s,
               float* __restrict__ sumsq, float* __restrict__ sums,
               unsigned int* __restrict__ arrivals) {
  const long long k = blockIdx.x / nchunks;
  const int j = blockIdx.x % nchunks;
  const float* row = g + k * n;

  // elements before the row's first 16-byte boundary
  long long head = (long long)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  const float4* body = reinterpret_cast<const float4*>(row + head);
  const long long per = (nvec + nchunks - 1) / nchunks;
  const long long v0 = (long long)j * per;
  const long long v1 = v0 + per < nvec ? v0 + per : nvec;

  float sq = 0.f, s = 0.f;
  for (long long v = v0 + threadIdx.x; v < v1;
       v += (long long)kThreads * kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const long long i = v + (long long)q * kThreads;
      x[q] = i < v1 ? __ldg(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      sq += x[q].x * x[q].x + x[q].y * x[q].y + x[q].z * x[q].z +
            x[q].w * x[q].w;
      s += x[q].x + x[q].y + x[q].z + x[q].w;
    }
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

  block_sum2(sq, s);
  if (nchunks == 1) {
    if (threadIdx.x == 0) {
      sumsq[k] = sq;
      sums[k] = s;
    }
    return;
  }
  __shared__ bool last;
  if (threadIdx.x == 0) {
    part_sq[k * nchunks + j] = sq;
    part_s[k * nchunks + j] = s;
    // release: the partial before the arrival; acquire: the others'
    // partials after it, for the block that arrives last
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> arrived(
        arrivals[k]);
    last = arrived.fetch_add(1u, cuda::memory_order_acq_rel) ==
           (unsigned)nchunks - 1;
  }
  __syncthreads();
  if (!last) return;
  // the row's last block: its partials, thread t the chunks t, t + 256, ...
  // in turn, then the same fixed tree
  sq = 0.f;
  s = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += kThreads) {
    sq += __ldcg(part_sq + k * nchunks + c);
    s += __ldcg(part_s + k * nchunks + c);
  }
  block_sum2(sq, s);
  if (threadIdx.x == 0) {
    sumsq[k] = sq;
    sums[k] = s;
    arrivals[k] = 0;                     // clean for the next launch
  }
}

}  // namespace

extern "C" {

// sumsq, sums [K] = the moments of g [K, N], each row in `nchunks` chunks
// (>= 1); part_sq, part_s [K, nchunks] scratch; with nchunks > 1,
// arrivals [K] counters that are 0 and that no overlapping launch uses
// (left at 0).  Launched on `stream`; returns cudaGetLastError().
int moments_launch(const float* g, long long k, long long n, int nchunks,
                   float* part_sq, float* part_s, float* sumsq, float* sums,
                   unsigned int* arrivals, void* stream) {
  if (k < 1 || n < 1 || nchunks < 1 || k * nchunks > 0x7fffffffLL ||
      (nchunks > 1 && arrivals == nullptr))
    return (int)cudaErrorInvalidValue;
  moments_kernel<<<(unsigned)(k * nchunks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      g, n, nchunks, part_sq, part_s, sumsq, sums, arrivals);
  return (int)cudaGetLastError();
}

const char* moments_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

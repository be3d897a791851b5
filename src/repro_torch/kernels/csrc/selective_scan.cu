// Mamba (S6) selective scan over [B, S, D] channels with N states each,
// fp32 inside:
//   h_t = exp(dt_t a) h_{t-1} + (dt_t u_t) B_t,   h_0 = 0,
//   y_t = <h_t, C_t>
// u [B, S, D] bf16 or fp32, dt [B, S, D] fp32, a [D, N] fp32, B and C
// [B, S, N] of u's type; y [B, S, D] fp32 and, when asked, the final state
// h_S [B, D, N] fp32 (the prefill -> decode handoff's ssm state).
//
// Replaces the TPU kernel repro/kernels/selective_scan.py::
// selective_scan_blocked (body _selective_scan_kernel): a (B, D/bd, S/cs)
// grid whose seq-chunk axis runs in order and carries h [bd, N] in VMEM
// scratch; it requires D and S to be multiples of its blocks.
//
// Bound on an H100: operations, the exponentials.  Every (b, t, d, n)
// takes one exp (B S D N of them: 4.29e9 at the serving shape
// [4, 8192, 8192, 16]), about 1.0 ms at the SFU's 16 a clock per SM
// (132 SMs, 1.98 GHz), against 0.80 ms to move u (bf16), dt and y (fp32)
// once at 3.35 TB/s and 0.38 ms for the ~6 other flops a state at the fp32
// rate.  This first port uses the accurate expf (a few instructions on the
// fp32 pipes around one SFU op), which keeps its gap to the plain version
// at rounding level; a faster exponential is later work.
//
// Design:
//  * Nothing carries over between CTAs, so the TPU's sequential seq-chunk
//    axis becomes a loop over t inside the CTA, and the state h lives in
//    fp32 registers for the whole sequence.  One CTA owns 32 channels of
//    one batch row.
//  * A thread owns one channel and a slice of 4 of its states (4 lanes a
//    channel, N up to kMaxN = 16); y_t is the sum of the 4 lanes' partial
//    dot products by two xor-shuffles, in a fixed order (no atomics: the
//    result is deterministic).  The simpler one-thread-a-channel design
//    gives 256 CTAs of 128 threads at the serving shape and 64 at B = 1,
//    under one CTA an SM; the slice gives 1,024 and 256, so every SM holds
//    several CTAs to hide the latency of the serial recurrence.
//  * A tile of kT time steps is staged in shared memory: u and dt [kT][32]
//    read coalesced along D (32 consecutive channels a row), and B_t, C_t
//    [kT][kMaxN], which every channel of the batch row shares.  y goes back
//    through a [kT][32] tile so its stores are coalesced along D too.
//  * Ragged S and D: rows past S are not staged or computed; channels past
//    D (and states past N) run on zeros (dt = 0, B = C = 0 keep h = 0) and
//    are not written.  No shape needs to divide anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;            // channels per CTA
constexpr int kLanes = 4;                // threads per channel
constexpr int kMaxN = 16;                // states per channel, at most
constexpr int kPer = kMaxN / kLanes;     // states per thread
constexpr int kThreads = kChannels * kLanes;
constexpr int kT = 64;                   // time steps per staged tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ bm,
                      const T* __restrict__ cm, float* __restrict__ y,
                      float* __restrict__ h_out, int S, int D, int N) {
  __shared__ float u_s[kT][kChannels];
  __shared__ float dt_s[kT][kChannels];
  __shared__ float y_s[kT][kChannels];
  __shared__ __align__(16) float b_s[kT][kMaxN];
  __shared__ __align__(16) float c_s[kT][kMaxN];

  const int tid = threadIdx.x;
  const int ch = tid / kLanes;           // channel within the CTA
  const int sub = tid % kLanes;          // which slice of the states
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * S;   // first (b, t) row

  float av[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = sub * kPer + j;
    av[j] = (d < D && n < N) ? a[(long long)d * N + n] : 0.f;
    h[j] = 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int rows = min(kT, S - t0);
    __syncthreads();  // the last tile's staged reads and y stores are done
    for (int e = tid; e < kT * kChannels; e += kThreads) {
      const int r = e / kChannels;
      const int c = e % kChannels;
      float uv = 0.f, dv = 0.f;
      if (r < rows && d0 + c < D) {
        const long long off = (row0 + t0 + r) * D + d0 + c;
        uv = to_f(u[off]);
        dv = dt[off];
      }
      u_s[r][c] = uv;
      dt_s[r][c] = dv;
    }
    for (int e = tid; e < kT * kMaxN; e += kThreads) {
      const int r = e / kMaxN;
      const int n = e % kMaxN;
      float bv = 0.f, cv = 0.f;
      if (r < rows && n < N) {
        const long long off = (row0 + t0 + r) * N + n;
        bv = to_f(bm[off]);
        cv = to_f(cm[off]);
      }
      b_s[r][n] = bv;
      c_s[r][n] = cv;
    }
    __syncthreads();

    for (int r = 0; r < rows; ++r) {
      const float dv = dt_s[r][ch];
      const float dbu = dv * u_s[r][ch];
      const float4 bq = *reinterpret_cast<const float4*>(&b_s[r][sub * kPer]);
      const float4 cq = *reinterpret_cast<const float4*>(&c_s[r][sub * kPer]);
      const float bb[kPer] = {bq.x, bq.y, bq.z, bq.w};
      const float cc[kPer] = {cq.x, cq.y, cq.z, cq.w};
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        h[j] = expf(dv * av[j]) * h[j] + dbu * bb[j];
        part += h[j] * cc[j];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (sub == 0) y_s[r][ch] = part;
    }
    __syncthreads();
    for (int e = tid; e < rows * kChannels; e += kThreads) {
      const int r = e / kChannels;
      const int c = e % kChannels;
      if (d0 + c < D) y[(row0 + t0 + r) * D + d0 + c] = y_s[r][c];
    }
  }

  if (h_out != nullptr && d < D) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = sub * kPer + j;
      if (n < N) h_out[((long long)b * D + d) * N + n] = h[j];
    }
  }
}

static_assert(kPer == 4, "the B/C reads are one float4 a thread");

template <typename T>
int launch(const void* u, const float* dt, const float* a, const void* bm,
           const void* cm, float* y, float* h_out, int B, int S, int D,
           int N, cudaStream_t st) {
  const dim3 grid((unsigned)((D + kChannels - 1) / kChannels), (unsigned)B);
  selective_scan_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(u), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, h_out, S, D, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (and h_out, unless it is null) = selective_scan(u, dt, a, B, C) on
// `stream`.  u [B, S, D] and bm, cm [B, S, N] of one type (bf16 when
// is_bf16, else fp32); dt [B, S, D], a [D, N], y [B, S, D], h_out [B, D, N]
// fp32; all contiguous; 1 <= N <= 16.  The wrapper checks all of that.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does
// not take).
int selective_scan_launch(const void* u, const void* dt, const void* a,
                          const void* bm, const void* cm, void* y,
                          void* h_out, int B, int S, int D, int N,
                          int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || N < 1 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  if (is_bf16)
    return launch<__nv_bfloat16>(u, dtf, af, bm, cm, yf, hf, B, S, D, N, st);
  return launch<float>(u, dtf, af, bm, cm, yf, hf, B, S, D, N, st);
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

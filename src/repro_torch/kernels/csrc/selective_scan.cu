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
// [4, 8192, 8192, 16]), 1.03 ms at the SFU's 16 a clock per SM (132 SMs,
// 1.98 GHz), against 0.80 ms to move u (bf16), dt and y (fp32) once at
// 3.35 TB/s.  Besides its exponential a state costs four fp32
// instructions (dt a, dt u B, the multiply-add of h, the product with C),
// and a step about 30 more (its loads, y's sum and store), so the
// schedulers' instruction slots are nearly as busy as the SFU: in this
// kernel's measurements the time follows the instruction slots plus the
// SFU's cycles, and the accurate expf (about ten instructions around its
// SFU op) costs half again.
//
// What held the first design back (4.72 ms, 22 % of the bound): that expf;
// 1,024 CTAs of 4 warps with 32 KB of static shared memory each, 1.3 waves
// at B = 4, so the second wave ran a whole sequence on a third of the card;
// plain loads of the next tile between two barriers, with nothing in
// flight while the recurrence ran.
//
// Design (each choice held against the others by tools/kernel_sweep.py
// --only k7; PERF.md):
//  * The exponential is one ex2.approx.ftz.f32 of dt (a log2 e), with
//    a log2 e formed once a thread.  Rounding that product adds about
//    |dt a| 2^-24 of relative error to the exponential, and ex2.approx's own
//    is about 2^-22: both far under the rule's SCAN_RTOL = 1e-4 of the
//    plain scan of the absolute terms (chip_smoke.py).  An input under
//    2^-126 is flushed (exp = 1) and an output under 2^-126 is 0.
//  * kLanes = 2 lanes a channel, each with 8 of the 16 states in
//    registers; y_t is the two lanes' partial dot products summed by one
//    xor-shuffle.  Two lanes beat one at every shape measured, the Jamba
//    prefill's B = 4 included (1,024 warps at one lane), and four (the
//    first design's) lost to two: more lanes repeat a step's loads and
//    sums.
//  * A CTA owns 32 channels of one batch row (64 threads), so the grid
//    has CTAs small enough to spread over all 132 SMs in one wave.
//  * A tile of kT = 32 time steps is staged in shared memory, fp32: u
//    and dt [kT][32] read coalesced along D, B_t and C_t [kT][16], which
//    every channel of the batch row shares.  The loads of tile i+1 are
//    started into registers before tile i is computed and stored to the
//    other of two buffers after it: one barrier a tile, and a tile's
//    worth of loads always in flight.
//  * Inside a full tile the step loop is unrolled by 4, so the next
//    steps' exponentials and dt u B products, which do not depend on h, go
//    out while the current step's multiply-adds wait; a thread sums its
//    share of y_t's products in one chain (the unrolled steps overlap its
//    latency).
//  * One launch scans the whole sequence.  A split of the sequence into
//    chunks (the TPU kernel's seq-chunk axis: chunks from zero, then again
//    from their carries folded in chunk order) was built and timed: it
//    lost at the Jamba prefill's B = 4 and B = 1, where the grid alone
//    fills the card, and paid only at small grids that no caller sends
//    (PERF.md), so it is not kept.
//  * Ragged S and D: rows past S are not staged or computed; channels past
//    D (and states past N) run on zeros (dt = 0, B = C = 0 keep h = 0) and
//    are not written.  No shape needs to divide anything.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;            // channels per CTA
constexpr int kMaxN = 16;                // states per channel, at most
constexpr int kLanes = 2;                // threads a channel
constexpr int kTileBase = 16;            // steps a tile a lane
constexpr int kUnroll = 4;               // steps unrolled in a full tile
constexpr int kAcc = 1;                  // chains summing a thread's share
                                         // of y_t
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// exp2(x): one SFU op
__device__ __forceinline__ float exp2_sfu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// L lanes a channel, each with 16 / L of its states
template <int L>
struct Shape {
  static constexpr int kThreads = kChannels * L;
  static constexpr int kPer = kMaxN / L;       // states a thread
  static constexpr int kT = kTileBase * L;     // steps a tile
  static constexpr int kElems = kTileBase;     // a thread's share of one
                                               // staged array a tile
  // floats of one buffer: u, dt [kT][32] and B | C [kT][32]
  static constexpr int kU = 0;
  static constexpr int kDt = kT * kChannels;
  static constexpr int kBC = 2 * kT * kChannels;
  static constexpr int kBufFloats = 3 * kT * kChannels;
  static constexpr int kSmemBytes = 2 * kBufFloats * 4;
};

template <typename T, int L>
__global__ void __launch_bounds__(Shape<L>::kThreads)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ bm,
                      const T* __restrict__ cm, float* __restrict__ y,
                      float* __restrict__ h_out, int S, int D, int N) {
  using Sh = Shape<L>;
  constexpr int kT = Sh::kT;
  constexpr int kPer = Sh::kPer;
  constexpr int kThreads = Sh::kThreads;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int ch = tid / L;                // channel within the CTA
  const int sub = tid % L;               // which slice of the states
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + ch;
  const int b = blockIdx.y;
  const long long row0 = (long long)b * S;           // first (b, t) row

  float a2[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = sub * kPer + j;
    a2[j] = (d < D && n < N) ? a[(long long)d * N + n] * kLog2e : 0.f;
    h[j] = 0.f;
  }

  // the next tile, held in registers from its loads to its stores
  T ru[Sh::kElems], rbc[Sh::kElems];
  float rdt[Sh::kElems];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < Sh::kElems; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kChannels;
      const int col = e % kChannels;
      const bool in_t = t0 + r < S;
      const bool ok = in_t && d0 + col < D;
      const long long off = (row0 + t0 + r) * D + d0 + col;
      ru[i] = ok ? u[off] : T(0.f);
      rdt[i] = ok ? dt[off] : 0.f;
      const int n = col % kMaxN;         // columns 0..15 B, 16..31 C
      const T* src = col < kMaxN ? bm : cm;
      rbc[i] = (in_t && n < N) ? src[(row0 + t0 + r) * N + n] : T(0.f);
    }
  };
  auto store = [&](int base) {
#pragma unroll
    for (int i = 0; i < Sh::kElems; ++i) {
      const int e = tid + i * kThreads;
      smem[base + Sh::kU + e] = to_f(ru[i]);
      smem[base + Sh::kDt + e] = rdt[i];
      smem[base + Sh::kBC + e] = to_f(rbc[i]);
    }
  };

  auto step = [&](int base, int r, long long t) {
    const float uv = smem[base + Sh::kU + r * kChannels + ch];
    const float dv = smem[base + Sh::kDt + r * kChannels + ch];
    const float* bc = smem + base + Sh::kBC + r * kChannels;
    const float dbu = dv * uv;
    float bb[kPer], cc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; j += 4) {
      const float4 bq = *reinterpret_cast<const float4*>(bc + sub * kPer + j);
      const float4 cq =
          *reinterpret_cast<const float4*>(bc + kMaxN + sub * kPer + j);
      bb[j] = bq.x; bb[j + 1] = bq.y; bb[j + 2] = bq.z; bb[j + 3] = bq.w;
      cc[j] = cq.x; cc[j + 1] = cq.y; cc[j + 2] = cq.z; cc[j + 3] = cq.w;
    }
    float p[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) p[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      h[j] = fmaf(exp2_sfu(dv * a2[j]), h[j], dbu * bb[j]);
      p[j % kAcc] = fmaf(h[j], cc[j], p[j % kAcc]);
    }
    float part = p[0];
#pragma unroll
    for (int i = 1; i < kAcc; ++i) part += p[i];
#pragma unroll
    for (int off = 1; off < L; off <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (sub == 0 && d < D) y[(row0 + t) * D + d] = part;
  };

  int parity = 0;
  // S >= 1 always; without this test ptxas gave every instantiation 255
  // registers and spills, 20 % slower (tools/kernel_sweep.py, PERF.md)
  if (S > 0) load(0);
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int base = parity * Sh::kBufFloats;
    store(base);
    __syncthreads();
    if (t0 + kT < S) load(t0 + kT);
    const int rows = min(kT, S - t0);
    if (rows == kT) {
#pragma unroll (kUnroll)
      for (int r = 0; r < kT; ++r) step(base, r, t0 + r);
    } else {
      for (int r = 0; r < rows; ++r) step(base, r, t0 + r);
    }
    parity ^= 1;
  }

  if (d >= D || h_out == nullptr) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {        // the state after step S - 1
    const int n = sub * kPer + j;
    if (n < N) h_out[((long long)b * D + d) * N + n] = h[j];
  }
}

static_assert(kMaxN % 16 == 0, "a thread reads B and C as float4s");

template <typename T, int L>
int launch(const void* u, const float* dt, const float* a, const void* bm,
           const void* cm, float* y, float* h_out, int B, int S, int D,
           int N, cudaStream_t st) {
  using Sh = Shape<L>;
  auto kernel = selective_scan_kernel<T, L>;
  if (Sh::kSmemBytes > 48 * 1024) {      // above 48 KB only on request
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
  }
  const dim3 grid((unsigned)((D + kChannels - 1) / kChannels), (unsigned)B);
  kernel<<<grid, Sh::kThreads, Sh::kSmemBytes, st>>>(
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
// Returns cudaGetLastError() (cudaErrorInvalidValue for a shape it does not
// take).
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
    return launch<__nv_bfloat16, kLanes>(u, dtf, af, bm, cm, yf, hf, B, S, D,
                                         N, st);
  return launch<float, kLanes>(u, dtf, af, bm, cm, yf, hf, B, S, D, N, st);
}

const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// The OTA train step's channel noise and receiver gain, fused into one pass
// over a leaf piece of the folded update y (fp32, contiguous):
//   out[j] = a * ( y[j] + sigma * n(key, w(j)) )
// where w(j) is the piece element's flat index in the WHOLE leaf and
// n(key, w) a standard normal that is a pure function of the leaf's key and
// w.  So a rank's piece is bitwise the whole leaf's draw sliced, for any
// cut, any rank and any launch shape, and nothing but y is read or written:
// the noise is drawn in registers.  out may be y (in place).
//
// No TPU counterpart: the reference draws its noise inside the jitted step
// with jax.random (src/repro/distribution/ota_collectives.py:175-178,
// schemes.add_channel_noise after the psum), and XLA fuses the draw.  The
// port's stream is its own (repro_torch/kernels/channel_noise.py has why):
//   h  = mix64(key + (w + 1) * 0x9E3779B97F4A7C15)    splitmix64, mod 2^64
//   u1 = ((h >> 40) + 1) * 2^-24                      in (0, 1], exact fp32
//   u2 = ((h >> 16) & 0xFFFFFF) * 2^-24               in [0, 1), exact fp32
//   n  = sqrt(-2 ln u1) * cos(2 pi u2)                Box-Muller, one normal
// with ln and cos as short polynomials of correctly rounded fp32 operations
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn: no contraction into FMAs),
// in the order repro_torch/kernels/ref.py::noise_normals_ref takes them, so
// the plain version gives the same bits on the CPU and on the card.
//
// The map w(j): the host collapses the piece's dims (a dim whose inner
// neighbour is whole merges into it) to at most kMaxDims, and passes the
// piece's shape, the start of its region in each dim and the whole leaf's
// strides.  A halves leaf (in_proj's [u | z]) holds two regions of the last
// dim side by side: piece columns [0, split) start at start[last], columns
// [split, P) at start2.
//
// Bound on an H100: bytes.  The function reads and writes y once, N * 8
// bytes (granite-moe-1b-a400m's N = 1,384,963,072: 11.1 GB, 3.31 ms at
// 3.35 TB/s); it does ~45 fp32 operations an element (0.93 ms at 67 TFLOP/s)
// and ~100 integer ones, most of them the 64-bit division and remainder of
// each of the map's dims.  This is the simple kernel: a grid-stride loop,
// one element a thread and step, the map unravelled with 64-bit divisions.
// y is not __restrict__: out may be y (each element read, then written,
// by one thread).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kSms = 132;
constexpr int kMaxDims = 8;

constexpr uint64_t kGamma = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMix1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kMix2 = 0x94D049BB133111EBull;
constexpr float kTwoM24 = 5.9604644775390625e-08f;   // 2^-24

// the fp32 constants of repro_torch/kernels/channel_noise.py (NOISE_CONSTS),
// printed to 9 significant digits (each the same float)
constexpr float kSqrt2 = 1.41421354f;
constexpr float kLn2 = 0.693147182f;
constexpr float kTwoPi = 6.28318548f;
constexpr float kL3 = 0.333333343f;
constexpr float kL5 = 0.200000003f;
constexpr float kL7 = 0.142857149f;
constexpr float kL9 = 0.111111112f;
constexpr float kL11 = 0.0909090936f;
constexpr float kC2 = -0.5f;
constexpr float kC4 = 0.0416666679f;
constexpr float kC6 = -0.00138888892f;
constexpr float kC8 = 2.48015876e-05f;
constexpr float kS3 = -0.166666672f;
constexpr float kS5 = 0.00833333377f;
constexpr float kS7 = -0.000198412701f;
constexpr float kS9 = 2.75573188e-06f;

// the dims right-aligned: dim kMaxDims - 1 is the last (innermost), the
// first kMaxDims - nd unused, so that every index below is a constant
// after unrolling and the struct stays in the kernel's parameter space
struct PieceMap {
  int nd;
  long long pshape[kMaxDims];   // the piece's (collapsed) shape
  long long start[kMaxDims];    // its region's start in each whole dim
  long long wstride[kMaxDims];  // the whole leaf's strides (elements)
  long long split;              // last dim: columns of the first region
  long long start2;             // last dim: the second region's start
};

__device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * kMix1;
  z = (z ^ (z >> 27)) * kMix2;
  return z ^ (z >> 31);
}

// the whole leaf's flat index of piece element j
__device__ __forceinline__ long long whole_index(long long j,
                                                 const PieceMap& m) {
  long long rest = j, w = 0;
#pragma unroll
  for (int d = kMaxDims - 1; d >= 0; --d) {
    if (d < kMaxDims - m.nd) break;
    const long long p = rest % m.pshape[d];
    rest /= m.pshape[d];
    const long long wd = (d == kMaxDims - 1 && p >= m.split)
                             ? m.start2 + (p - m.split) : m.start[d] + p;
    w += wd * m.wstride[d];
  }
  return w;
}

__device__ __forceinline__ void uniforms(uint64_t key, long long w,
                                         float& u1, float& u2) {
  const uint64_t h = mix64(key + (uint64_t)(w + 1) * kGamma);
  u1 = __fmul_rn(__uint2float_rn((unsigned)(h >> 40) + 1u), kTwoM24);
  u2 = __fmul_rn(__uint2float_rn((unsigned)((h >> 16) & 0xFFFFFFull)),
                 kTwoM24);
}

__device__ __forceinline__ float horner(float x2, float c0, float c1,
                                        float c2, float c3, float c4) {
  // (((c0 x2 + c1) x2 + c2) x2 + c3) x2 + c4, each step rounded
  float p = __fadd_rn(__fmul_rn(c0, x2), c1);
  p = __fadd_rn(__fmul_rn(p, x2), c2);
  p = __fadd_rn(__fmul_rn(p, x2), c3);
  return __fadd_rn(__fmul_rn(p, x2), c4);
}

__device__ __forceinline__ float normal(float u1, float u2) {
  // ln u1 = e ln 2 + ln m, m in [sqrt(1/2), sqrt(2)), ln m = 2 atanh(s)
  const int bits = __float_as_int(u1);
  int e = (bits >> 23) - 127;
  float m = __int_as_float((bits & 0x7FFFFF) | 0x3F800000);
  if (m > kSqrt2) {
    m = __fmul_rn(m, 0.5f);
    e += 1;
  }
  const float s = __fdiv_rn(__fsub_rn(m, 1.0f), __fadd_rn(m, 1.0f));
  const float s2 = __fmul_rn(s, s);
  const float p = horner(s2, kL11, kL9, kL7, kL5, kL3);
  const float lnm = __fmul_rn(__fadd_rn(s, __fmul_rn(s, __fmul_rn(s2, p))),
                              2.0f);
  const float lnu = __fadd_rn(__fmul_rn(__int2float_rn(e), kLn2), lnm);
  const float r = __fsqrt_rn(__fmul_rn(lnu, -2.0f));
  // cos(2 pi u2) by symmetry from [0, pi/4]: w = min(u2, 1 - u2) in
  // [0, 1/2]; past 1/4 the sign flips (q = 1/2 - w); past 1/8 it is the
  // sine of 1/4 - q.  Every subtraction here is exact.
  const float w = fminf(u2, __fsub_rn(1.0f, u2));
  const bool neg = w > 0.25f;
  const float q = neg ? __fsub_rn(0.5f, w) : w;
  const bool use_sin = q > 0.125f;
  const float t = use_sin ? __fsub_rn(0.25f, q) : q;
  const float x = __fmul_rn(t, kTwoPi);
  const float x2 = __fmul_rn(x, x);
  float trig;
  if (use_sin) {
    const float sp = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(
        __fadd_rn(__fmul_rn(kS9, x2), kS7), x2), kS5), x2), kS3);
    trig = __fadd_rn(x, __fmul_rn(x, __fmul_rn(x2, sp)));
  } else {
    trig = horner(x2, kC8, kC6, kC4, kC2, 1.0f);
  }
  return __fmul_rn(r, neg ? -trig : trig);
}

__global__ void __launch_bounds__(kThreads)
channel_noise_kernel(const float* y, float* out, long long n,
                     PieceMap map, uint64_t key, float sigma,
                     const float* __restrict__ gain) {
  const float a = __ldg(gain);
  const long long step = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n;
       j += step) {
    float u1, u2;
    uniforms(key, whole_index(j, map), u1, u2);
    const float z = __fmul_rn(normal(u1, u2), sigma);
    out[j] = __fmul_rn(__fadd_rn(y[j], z), a);
  }
}

// the uniforms alone, out [n, 2] (u1, u2): the check's view of the stream
__global__ void __launch_bounds__(kThreads)
noise_uniforms_kernel(float* out, long long n, PieceMap map, uint64_t key) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x; j < n;
       j += step) {
    float u1, u2;
    uniforms(key, whole_index(j, map), u1, u2);
    out[2 * j] = u1;
    out[2 * j + 1] = u2;
  }
}

int make_map(int nd, const long long* pshape, const long long* start,
             const long long* wstride, long long split, long long start2,
             PieceMap* m) {
  if (nd < 1 || nd > kMaxDims) return (int)cudaErrorInvalidValue;
  m->nd = nd;
  const int pad = kMaxDims - nd;
  for (int d = 0; d < kMaxDims; ++d) {
    const bool used = d >= pad;
    m->pshape[d] = used ? pshape[d - pad] : 1;
    m->start[d] = used ? start[d - pad] : 0;
    m->wstride[d] = used ? wstride[d - pad] : 0;
    if (used && pshape[d - pad] < 1) return (int)cudaErrorInvalidValue;
  }
  m->split = split;
  m->start2 = start2;
  return 0;
}

unsigned grid_for(long long n) {
  const long long ctas = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)kSms * kCtasPerSm;
  return (unsigned)(ctas < cap ? ctas : cap);
}

}  // namespace

extern "C" {

// out[j] = gain[0] * (y[j] + sigma * n(key, w(j))) for the n elements of a
// contiguous fp32 piece (out may be y); the piece map as PieceMap's fields
// (host arrays of nd entries).  Launched on `stream`; returns
// cudaGetLastError().
int channel_noise_launch(const float* y, float* out, long long n, int nd,
                         const long long* pshape, const long long* start,
                         const long long* wstride, long long split,
                         long long start2, unsigned long long key,
                         float sigma, const float* gain, void* stream) {
  PieceMap map;
  if (n < 1 || y == nullptr || out == nullptr || gain == nullptr)
    return (int)cudaErrorInvalidValue;
  if (int err = make_map(nd, pshape, start, wstride, split, start2, &map))
    return err;
  channel_noise_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      y, out, n, map, (uint64_t)key, sigma, gain);
  return (int)cudaGetLastError();
}

// out [n, 2] = the (u1, u2) of each piece element, as channel_noise_launch
// draws them.  Launched on `stream`; returns cudaGetLastError().
int noise_uniforms_launch(float* out, long long n, int nd,
                          const long long* pshape, const long long* start,
                          const long long* wstride, long long split,
                          long long start2, unsigned long long key,
                          void* stream) {
  PieceMap map;
  if (n < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
  if (int err = make_map(nd, pshape, start, wstride, split, start2, &map))
    return err;
  noise_uniforms_kernel<<<grid_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      out, n, map, (uint64_t)key);
  return (int)cudaGetLastError();
}

const char* channel_noise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

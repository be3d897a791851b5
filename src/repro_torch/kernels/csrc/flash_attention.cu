// Flash attention (online softmax) on the fp32 cores: the fp32 body of K6.
// Over [B, H, S, d], fp32 in and out:
//   o[b,h,i] = sum_j softmax_j(s_ij) v[b,hk,j],
//   s_ij = <q[b,h,i], k[b,hk,j]> / sqrt(d)
// with hk = h / (H / Hkv) (grouped-query attention: k and v are read with
// their own Hkv heads, never expanded), and the masks of the TPU kernel:
// a key j is out of the domain when j >= Skv, and a score is set to -1e30
// (not dropped) when causal and j > i, or when a window W is set and
// i - j >= W.  The finish divides by max(l, 1e-30).
// flash_attention_wgmma.cu computes the same function for bf16 on the
// tensor cores; the wrapper (kernels/flash_attention.py) sends fp32 here.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_blocked (body _flash_kernel): a (B, H, S/bq, S/bk) grid
// whose kv axis runs in order and carries the running max, denominator and
// accumulator in VMEM scratch; it requires S to be a multiple of its blocks
// and kv already expanded to H heads.
//
// Bound on an H100: operations.  The work is 4 d flops per (query, key)
// pair inside the causal/window band (two products of d multiply-adds), at
// the 67 TFLOP/s fp32 rate: the tensor cores have no fp32 product, and
// TF32's ~11 bits would not meet the fp32 rule (1e-5 + 1e-5 |o|).  At
// danube's layer (B 4, H 32 over Hkv 8, S 8192, W 4096, d 80) that is
// 15.4 ms, against 0.26 ms to move q, k, v and o once at 3.35 TB/s.
//
// Design:
//  * Nothing carries over between CTAs on this card, so the TPU's
//    sequential kv grid axis becomes a loop inside one CTA: one CTA per
//    (q tile of 64 rows, head, batch), 128 threads.  Thread (ty, tx) owns
//    rows 4ty..4ty+3 of the tile, score columns tx + 8j (j < 8) and output
//    columns tx + 8j (j < d/8): the online-softmax state (m, l) and the
//    output accumulator live in fp32 registers; the 8 lanes of a row
//    reduce their row max and sum with shuffles.
//  * Q (once) and each 64-key K and V tile are staged in shared memory:
//    Q and K transposed (so a thread's operands are contiguous or
//    broadcast across the warp), with strides 68 (float4 reads) and 65
//    (conflict-free transposing stores).  The probabilities go through a
//    transposed shared tile to the P V product.
//  * Ragged S: rows past Sq are computed on zeros and not written; keys
//    past Skv score -inf, so they carry no weight even in a row whose every
//    real key is masked (there the TPU kernel's uniform average over the
//    Skv keys is kept).
//  * KV tiles wholly outside the causal/window band are skipped: O(S W)
//    work for a windowed prefill instead of O(S^2).  That changes no value
//    while every row has a key inside the band (Sq <= Skv, W >= 1; the
//    wrapper passes skip = 0 otherwise): before a row's first valid key a
//    masked score gives p = exp(0) = 1 against m = -1e30, and the first
//    real maximum multiplies that sum by exp(-1e30 - m) = 0 exactly.
//  * q tiles are issued last-first, so the long causal rows start early.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 128;    // 16 row groups x 8 column lanes
constexpr int kMaxD = 128;
constexpr int kMaxDJ = kMaxD / 8;  // output columns per thread at d = 128
constexpr int kQS = kBQ + 4;     // row stride of the transposed Q and P tiles
constexpr int kKS = kBK + 1;     // row stride of the transposed K tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ void load8(const float* p, float x[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int H, int Hkv, int Sq, int Skv, int d, int causal,
                       int window, int skip, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [d][kQS]
  float* Kt = Qt + d * kQS;                     // [d][kKS]
  float* Vs = Kt + d * kKS;                     // [kBK][d]
  float* Pt = Vs + kBK * d;                     // [kBK][kQS]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int cpr = d >> 3;              // 8-element chunks per row
  const int nchunk = kBQ * cpr;        // chunks per tile (kBQ == kBK)
  const int ndj = cpr;                 // output columns per thread

  const float* qb = q + ((long long)b * H + h) * Sq * d;
  const float* kb = k + ((long long)b * Hkv + hk) * Skv * d;
  const float* vb = v + ((long long)b * Hkv + hk) * Skv * d;
  float* ob = o + ((long long)b * H + h) * Sq * d;

  for (int c = tid; c < nchunk; c += kThreads) {
    const int r = c / cpr;
    const int kd = (c - r * cpr) * 8;
    float x[8];
    if (q0 + r < Sq) {
      load8(qb + (long long)(q0 + r) * d + kd, x);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) Qt[(kd + u) * kQS + r] = x[u];
  }

  int k_lo = 0, k_hi = Skv;
  if (skip) {
    if (causal) k_hi = min(Skv, q0 + kBQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  float m[4], l[4], acc[4][kMaxDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's Kt, Vs, Pt reads are done
    for (int c = tid; c < nchunk; c += kThreads) {
      const int r = c / cpr;
      const int kd = (c - r * cpr) * 8;
      float xk[8], xv[8];
      if (k0 + r < Skv) {
        load8(kb + (long long)(k0 + r) * d + kd, xk);
        load8(vb + (long long)(k0 + r) * d + kd, xv);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) xk[u] = xv[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        Kt[(kd + u) * kKS + r] = xk[u];
        Vs[r * d + kd + u] = xv[u];
      }
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int kd = 0; kd < d; ++kd) {
      const float4 qa =
          *reinterpret_cast<const float4*>(Qt + kd * kQS + ty * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Kt[kd * kKS + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float p[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (kp >= Skv) {
          x = -INFINITY;
        } else if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) {
          x = kMasked;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rs += p[i][j];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxDJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(Pt + (tx + 8 * j) * kQS + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa =
          *reinterpret_cast<const float4*>(Pt + kk * kQS + ty * 4);
      const float* vr = Vs + kk * d + tx;
#pragma unroll
      for (int j = 0; j < kMaxDJ; ++j) {
        if (j < ndj) {
          const float vv = vr[8 * j];
          acc[0][j] = fmaf(pa.x, vv, acc[0][j]);
          acc[1][j] = fmaf(pa.y, vv, acc[1][j]);
          acc[2][j] = fmaf(pa.z, vv, acc[2][j]);
          acc[3][j] = fmaf(pa.w, vv, acc[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = ob + (long long)qp * d + tx;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j)
      if (j < ndj) orow[8 * j] = acc[i][j] / denom;
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)d * kQS + (size_t)d * kKS +
                          (size_t)kBK * d + (size_t)kBK * kQS);
}

int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int Hkv, int Sq, int Skv, int d, int causal, int window,
           int skip, float scale, cudaStream_t st) {
  // Above 48 KB of shared memory the kernel must be allowed it, once per
  // device, for the largest head dim: after the first launch on a device
  // no call but the launch itself is made, so launches can be captured in a
  // CUDA graph.
  static unsigned long long configured = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(flash_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(kMaxD));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured |= 1ull << dev;
  }
  const size_t smem = smem_bytes(d);
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<<<grid, kThreads, smem, st>>>(
      q, k, v, o, H, Hkv, Sq, Skv, d, causal, window, skip, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream`.  q, o: [B, H, Sq, d]; k, v:
// [B, Hkv, Skv, d]; all contiguous fp32 starting on 16-byte boundaries; d a
// multiple of 8 up to 128; Hkv divides H; window 0 for none.  The wrapper
// checks all of that.  Returns cudaGetLastError() (cudaErrorInvalidValue
// for a shape it does not take).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int Hkv, int Sq, int Skv,
                           int d, int causal, int window, int skip,
                           float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 || d < 8 ||
      d > kMaxD || d % 8 || window < 0)
    return (int)cudaErrorInvalidValue;
  return launch(static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<float*>(o), B, H,
                Hkv, Sq, Skv, d, causal, window, skip, scale,
                static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a launch at head dim d.
long long flash_attention_smem_bytes(int d) {
  return (long long)smem_bytes(d);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Flash attention (online softmax) on Hopper's tensor cores in 3xTF32: the
// fp32 body of K6.  Over [B, H, S, d], fp32 in and out:
//   o[b,h,i] = sum_j softmax_j(s_ij) v[b,hk,j],
//   s_ij = <q[b,h,i], k[b,hk,j]> / sqrt(d)
// with hk = h / (H / Hkv) (grouped-query attention: k and v are read with
// their own Hkv heads, never expanded), and the masks of the TPU kernel:
// a key j is out of the domain when j >= Skv (score -inf), and a score is
// set to -1e30 (not dropped) when causal and j > i, or when a window W is
// set and i - j >= W.  The finish divides by max(l, 1e-30).  Scores, the
// running max and denominator and the output accumulator are fp32.
// flash_attention_wgmma.cu computes the same function for bf16; the wrapper
// (kernels/flash_attention.py) sends fp32 here.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_blocked (body _flash_kernel) for fp32: a (B, H, S/bq,
// S/bk) grid whose kv axis runs in order and carries the running max,
// denominator and accumulator in VMEM scratch.
//
// Bound on an H100: operations.  4 d flops per (query, key) pair inside the
// causal/window band.  The tensor cores have no fp32 product, and one TF32
// product (an 11-bit significand) misses the fp32 rule (1e-5 + 1e-5 |o|), so
// each product runs as three TF32 products (3xTF32):
//   a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi,  a_hi = tf32(a), a_lo = a - a_hi
// whose dropped term a_lo b_lo is ~2^-20 |a b|.  At 495 TFLOP/s TF32 that is
// 6.25 ms for danube's layer (B 4, H 32 over Hkv 8, S 8192, W 4096, d 80)
// and 13.33 ms for Jamba's (d 128, causal), against 15.39 / 32.83 ms for one
// product on the fp32 cores (67 TFLOP/s) and 0.26 / 0.40 ms to move q, k, v
// and o once at 3.35 TB/s.
//
// Design (mma.sync.m16n8k8 in TF32; any sm_80 or later):
//  * One CTA per (q tile of kBQ rows, head, batch); each warp owns 16 query
//    rows.  q tiles are issued last-first, so the long causal rows start
//    early.  Nothing carries over between CTAs: the TPU's sequential kv
//    grid axis is a loop inside the CTA.
//  * Q (once), and each kv tile's K and V, are copied to shared memory with
//    cp.async, raw fp32 in rows of DP + 4 floats: that stride makes every
//    fragment read below conflict-free.  K and V have one buffer each, and
//    their copies overlap the other half of the tile's work: K of tile t+1
//    loads during the softmax and P V of tile t, V of tile t+1 during
//    Q K^T of tile t+1.  cp.async's zero fill (source size 0) pads the head
//    dim to DP, a multiple of 16, and the ragged S tails.
//  * Each operand is split where its fragment is read: hi = x with the low
//    13 bits cleared (a TF32 value, so the hardware reads it exactly),
//    lo = x - hi (exact in fp32; the hardware keeps its top 11 bits).  The
//    lo operand is thus the complement of the hi that is multiplied.  The
//    two small products go into the accumulator first, then hi hi.
//  * S = Q K^T: per 8-deep slice of d, Q's A fragment and, per 8 keys, K's
//    B fragment (K-major: B(k, n) = K[key n][dim k]).
//  * Softmax in fp32 registers in the log2 domain (x = s log2(e) / sqrt(d),
//    p = exp2(x - m)); the four lanes of a row reduce with shuffles.  The
//    masks are applied only on tiles that reach past Skv, cross the
//    diagonal or the window's edge for the warp's rows.
//  * O += P V: P's accumulator fragment becomes the A fragment in registers
//    with the keys of each 8-key slice taken in the order 0, 2, 4, 6, 1, 3,
//    5, 7 (the accumulator holds keys 2t and 2t + 1 in lane t of a quad,
//    the A fragment k-indices t and t + 4), and V's B fragment is read in
//    the same order: the sum over keys is the same sum.
//  * The tensor cores round their fp32 sums toward zero.  A row's P V over
//    thousands of keys summed on them in one accumulator shrank O by ~1e-4
//    of itself (1.03 of the rule at danube's layer, 0.86 at Jamba's), so
//    each tile's P V is summed from zero (24 products) and added to O with
//    an fp32 fused multiply-add, O corr + PV, half of d at a time above
//    d = 64 (registers).
//  * KV tiles wholly outside the causal/window band are skipped when
//    skip = 1 (the wrapper sets it only for Sq <= Skv, where every row has
//    a key inside the band): before a row's first valid key a masked score
//    gives p = 1 against m = -1e30, and the first real maximum multiplies
//    that sum by exp2(-1e30 - m) = 0 exactly.
//  * No split-KV and no atomics: every sum runs in one fixed order, so two
//    launches give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                // query rows per CTA
constexpr int kBK = 64;                 // keys per kv tile
constexpr int kWarps = kBQ / 16;        // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = kWarps > 4 ? 1 : 2;  // CTAs an SM holds at d 128
constexpr int kMaxD = 128;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !full (no read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the most recent group of this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x = hi + lo: hi a TF32 value (low 13 bits cleared), lo = x - hi exactly.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// D += A B: m16n8k8, TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += a b in 3xTF32, the small products first.  The B fragment is the two
// fp32 values (k = t and t + 4 of column g), split here.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DP>
struct Tiles {
  static constexpr int kStride = DP + 4;  // floats a shared row
  static constexpr size_t kSmemBytes =
      sizeof(float) * (size_t)(kBQ + 2 * kBK) * kStride;
};

// Rows [row0, row0 + rows) of a [S, d] fp32 matrix into shared rows of
// DP + 4 floats, zeros past S and past d; cp.async, not committed.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int S, int d, int rows) {
  constexpr int kChunks = DP / 4;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 4;
    const bool in = row0 + r < S && col < d;
    const float* p = in ? src + (long long)(row0 + r) * d + col : src;
    cp_async16(smem_u32(dst + r * Tiles<DP>::kStride + col), p, in);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_attention_tf32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, int H, int Hkv, int Sq,
                            int Skv, int d, int causal, int window, int skip,
                            float scale_log2) {
  constexpr int kS = Tiles<DP>::kStride;
  constexpr int kND = DP / 8;   // 8-column slices of d
  constexpr int kNK = kBK / 8;  // 8-key slices of a kv tile
  constexpr int kPV = kND > 8 ? kND / 2 : kND;  // O slices a P V pass
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [kBQ][kS]
  float* sK = sQ + kBQ * kS;                    // [kBK][kS]
  float* sV = sK + kBK * kS;                    // [kBK][kS]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment rows g and g + 8, column g of B
  const int t = lane % 4;  // fragment columns 2t, 2t + 1 (C); t, t + 4 (A)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const float* qb = q + ((long long)b * H + h) * Sq * d;
  const float* kb = k + ((long long)b * Hkv + hk) * Skv * d;
  const float* vb = v + ((long long)b * Hkv + hk) * Skv * d;

  int k_lo = 0, k_hi = Skv;
  if (skip) {
    if (causal) k_hi = min(Skv, q0 + kBQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  // groups: {Q, K of t_lo}, {V of t_lo}
  load_tile<DP>(sQ, qb, q0, Sq, d, kBQ);
  load_tile<DP>(sK, kb, t_lo * kBK, Skv, d, kBK);
  cp_async_commit();
  load_tile<DP>(sV, vb, t_lo * kBK, Skv, d, kBK);
  cp_async_commit();

  const int w0 = q0 + 16 * warp;  // the warp's first row
  const int row_a = w0 + g;
  const int row_b = row_a + 8;
  const float* qf = sQ + (16 * warp + g) * kS + t;

  float acc[kND][4];
#pragma unroll
  for (int j = 0; j < kND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;

  for (int tt = t_lo; tt < t_hi; ++tt) {
    const int k0 = tt * kBK;
    cp_async_wait_prior();  // Q and this tile's K
    __syncthreads();

    // S = Q K^T over DP / 8 slices of 8 dims
    float s[kNK][4];
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kND; ++kk) {
      uint32_t ah[4], al[4];
      split(qf[8 * kk], ah[0], al[0]);               // (g, t)
      split(qf[8 * kS + 8 * kk], ah[1], al[1]);      // (g + 8, t)
      split(qf[8 * kk + 4], ah[2], al[2]);           // (g, t + 4)
      split(qf[8 * kS + 8 * kk + 4], ah[3], al[3]);  // (g + 8, t + 4)
      const float* kf = sK + g * kS + 8 * kk + t;
#pragma unroll
      for (int n = 0; n < kNK; ++n)
        mma3(s[n], ah, al, kf[8 * n * kS], kf[8 * n * kS + 4]);
    }
    __syncthreads();  // every warp has read this tile's K
    if (tt + 1 < t_hi) load_tile<DP>(sK, kb, k0 + kBK, Skv, d, kBK);
    cp_async_commit();

    // scores in the log2 domain; the masks only where the tile meets an
    // edge (accumulator value e of slice n: key k0 + 8n + 2t + (e & 1), row
    // row_a or row_b)
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > w0) ||
                      (window > 0 && w0 + 15 - k0 >= window);
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * n + 2 * t + (e & 1);
          const int row = (e & 2) ? row_b : row_a;
          if (key >= Skv) {
            x = -INFINITY;
          } else if ((causal && key > row) ||
                     (window > 0 && row - key >= window)) {
            x = kMasked;
          }
        }
        s[n][e] = x;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = exp2f(m_a - mn_a);
    const float corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
      s[n][0] = exp2f(s[n][0] - mn_a);
      s[n][1] = exp2f(s[n][1] - mn_a);
      s[n][2] = exp2f(s[n][2] - mn_b);
      s[n][3] = exp2f(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * corr_a + quad_sum(sum_a);
    l_b = l_b * corr_b + quad_sum(sum_b);

    cp_async_wait_prior();  // this tile's V
    __syncthreads();
    // O = O corr + P V, kPV output slices at a time: the tile's P V is
    // summed on the tensor cores from zero over its 8 slices of 8 keys (A
    // fragment k-index t is key 2t of the slice, t + 4 key 2t + 1) and
    // added to O in fp32
#pragma unroll
    for (int j0 = 0; j0 < kND; j0 += kPV) {
      float pv[kPV][4];
#pragma unroll
      for (int j = 0; j < kPV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
      for (int n = 0; n < kNK; ++n) {
        uint32_t ah[4], al[4];
        split(s[n][0], ah[0], al[0]);  // (g, key 2t)
        split(s[n][2], ah[1], al[1]);  // (g + 8, key 2t)
        split(s[n][1], ah[2], al[2]);  // (g, key 2t + 1)
        split(s[n][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
        const float* vf = sV + (8 * n + 2 * t) * kS + 8 * j0 + g;
#pragma unroll
        for (int j = 0; j < kPV; ++j)
          mma3(pv[j], ah, al, vf[8 * j], vf[kS + 8 * j]);
      }
#pragma unroll
      for (int j = 0; j < kPV; ++j) {
        acc[j0 + j][0] = acc[j0 + j][0] * corr_a + pv[j][0];
        acc[j0 + j][1] = acc[j0 + j][1] * corr_a + pv[j][1];
        acc[j0 + j][2] = acc[j0 + j][2] * corr_b + pv[j][2];
        acc[j0 + j][3] = acc[j0 + j][3] * corr_b + pv[j][3];
      }
    }
    __syncthreads();  // every warp has read this tile's V
    if (tt + 1 < t_hi) load_tile<DP>(sV, vb, k0 + kBK, Skv, d, kBK);
    cp_async_commit();
  }

  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);
  float* ob = o + ((long long)b * H + h) * Sq * d;
#pragma unroll
  for (int j = 0; j < kND; ++j) {
    if (8 * j >= d) continue;  // DP's padding
    const int col = 8 * j + 2 * t;
    if (row_a < Sq)
      *reinterpret_cast<float2*>(ob + (long long)row_a * d + col) =
          make_float2(acc[j][0] / den_a, acc[j][1] / den_a);
    if (row_b < Sq)
      *reinterpret_cast<float2*>(ob + (long long)row_b * d + col) =
          make_float2(acc[j][2] / den_b, acc[j][3] / den_b);
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int Hkv, int Sq, int Skv, int d, int causal, int window,
           int skip, float scale, cudaStream_t st) {
  // The shared-memory allowance is set once per device and head dim: after
  // the first launch on a device no call but the launch itself is made, so
  // launches can be captured in a CUDA graph.
  static unsigned long long configured = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(flash_attention_tf32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tiles<DP>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured |= 1ull << dev;
  }
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_attention_tf32_kernel<DP><<<grid, kThreads, Tiles<DP>::kSmemBytes,
                                    st>>>(q, k, v, o, H, Hkv, Sq, Skv, d,
                                          causal, window, skip,
                                          scale * kLog2e);
  return (int)cudaGetLastError();
}

size_t smem_bytes(int d) {
  switch ((d + 15) / 16 * 16) {
    case 16: return Tiles<16>::kSmemBytes;
    case 32: return Tiles<32>::kSmemBytes;
    case 48: return Tiles<48>::kSmemBytes;
    case 64: return Tiles<64>::kSmemBytes;
    case 80: return Tiles<80>::kSmemBytes;
    case 96: return Tiles<96>::kSmemBytes;
    case 112: return Tiles<112>::kSmemBytes;
    default: return Tiles<128>::kSmemBytes;
  }
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
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: return launch<16>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 32: return launch<32>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 48: return launch<48>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 64: return launch<64>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 80: return launch<80>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 96: return launch<96>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 112: return launch<112>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, d,
                                 causal, window, skip, scale, st);
    default: return launch<128>(qf, kf, vf, of, B, H, Hkv, Sq, Skv, d, causal,
                                window, skip, scale, st);
  }
}

// Dynamic shared memory of a launch at head dim d.
long long flash_attention_smem_bytes(int d) {
  return (long long)smem_bytes(d);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

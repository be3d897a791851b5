// Flash attention (online softmax) on Hopper's tensor cores: the bf16 body
// of K6.  Over [B, H, S, d], bf16 in and out, fp32 inside:
//   o[b,h,i] = sum_j softmax_j(s_ij) v[b,hk,j],
//   s_ij = <q[b,h,i], k[b,hk,j]> / sqrt(d)
// with hk = h / (H / Hkv) (grouped-query attention: k and v are read with
// their own Hkv heads, never expanded), and the masks of the TPU kernel:
// a key j is out of the domain when j >= Skv (score -inf), and a score is
// set to -1e30 (not dropped) when causal and j > i, or when a window W is
// set and i - j >= W, so a row whose every real key is masked gives the
// uniform average over the Skv keys.  The finish divides by max(l, 1e-30).
// flash_attention.cu computes the same function for fp32 in 3xTF32;
// the wrapper (kernels/flash_attention.py) sends bf16 here, fp32 there.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_blocked (body _flash_kernel) for bf16: a (B, H, S/bq,
// S/bk) grid whose kv axis runs in order and carries the running max,
// denominator and accumulator in VMEM scratch.
//
// Bound on an H100: operations.  4 d flops per (query, key) pair inside the
// causal/window band at the 989 TFLOP/s bf16 tensor-core rate: 1.04 ms for
// danube's layer (B 4, H 32 over Hkv 8, S 8192, W 4096, d 80) and 2.22 ms
// for Jamba's (d 128, causal, no window), against 0.13 / 0.20 ms to move q,
// k, v and o once at 3.35 TB/s.  This body does 6 d flops a pair (P V twice,
// below), so its own floor is 1.5x the bound.
//
// Design (sm_90a: wgmma and setmaxnreg exist only there):
//  * One CTA per (q tile of 128 rows, head, batch), three warpgroups.
//    Warpgroup 0 is the producer: it gives its registers up (setmaxnreg
//    24) and one thread issues every TMA copy.  Warpgroups 1 and 2 are the
//    consumers, 64 query rows each (setmaxnreg 240).  q tiles are issued
//    last-first, so the long causal rows start early.
//  * TMA copies Q once and the K and V tiles of 128 keys into a ring of two
//    stages.  Each stage has a K-full and a V-full mbarrier (the producer's
//    expect_tx, TMA's complete_tx) and an empty mbarrier on which the eight
//    consumer warps arrive when their products have read the stage.
//  * Shared tiles are 128-byte-swizzled atoms of 64 columns (TMA's
//    SWIZZLE_128B, the layout wgmma reads): one atom for d <= 64, two
//    above.  The head dim is padded to DP, a multiple of 16 (wgmma's
//    depth), by TMA's zero fill past the tensor's edge; the fill also
//    zeroes the ragged S tails.  At d = 80 the products run 80 deep and 80
//    wide; the zero columns of the second atom cost shared memory only.
//  * S = Q K^T: DP/16 wgmma m64n128k16 per tile, Q and K from shared
//    memory (K-major), fp32 accumulator in registers.
//  * Softmax in fp32 registers in the log2 domain: x = s log2(e) / sqrt(d),
//    p = exp2(x - m), a running max m and denominator l per row; the four
//    lanes of a row reduce with shuffles.  The masks are applied only on
//    tiles that reach past Skv, cross the diagonal or the window's edge.
//  * O += P V: wgmma m64nDPk16 with P as the A operand from registers and V
//    from shared memory (MN-major, i.e. transposed).  P is split as
//    P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both are multiplied, so
//    P keeps ~16 bits: one bf16 rounding of P alone would put an error of
//    ~2^-8 |p| on every weight, more than the bf16 rule (2^-8 |o| + 1e-5)
//    leaves beside the output's own rounding.
//  * KV tiles wholly outside the causal/window band are skipped when
//    skip = 1 (the wrapper sets it only for Sq <= Skv, where every row has
//    a key inside the band): before a row's first valid key a masked score
//    gives p = 1 against m = -1e30, and the first real maximum multiplies
//    that sum by exp2(-1e30 - m) = 0 exactly.
//  * No split-KV and no atomics: every sum runs in one fixed order, so two
//    launches give the same bits.
#include <cuda.h>  // CUtensorMap and its enums (types only: nothing linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // query rows per CTA
constexpr int kBK = 128;          // keys per kv tile
constexpr int kStages = 2;        // kv tiles in flight
constexpr int kAtomCols = 64;     // bf16 columns per 128-byte swizzle atom
constexpr int kRowBytes = 128;    // one row of an atom
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kMaxD = 128;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that lasts
// 2^35 clocks (~19 s) is a fault in the pipeline: trap, and the launch fails
// with an error, rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

// One TMA copy of a box of the 3-D tensor map into shared memory at `dst`,
// completing on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
// K-major (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride offset); the leading offset is unused.  MN-major (V): the leading
// offset steps from one 64-column atom to the next, the stride offset from
// one group of 8 keys to the next.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S (+)= Q K^T for one 16-deep slice: m64n128k16, A (Q) and B (K) from
// shared memory, both K-major; `accumulate` 0 overwrites S.
__device__ __forceinline__ void mma_qk(float (&d)[64], uint64_t desc_q,
                                       uint64_t desc_k, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_q), "l"(desc_k), "r"(accumulate));
}

// O += P V for one 16-key slice: m64nNk16, A (P, bf16) from registers,
// B (V) from shared memory, MN-major (transposed: d is V's contiguous dim).
template <int N>
struct MmaPV;

template <>
struct MmaPV<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
  }
};

template <>
struct MmaPV<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
  }
};

template <>
struct MmaPV<48> {
  static __device__ __forceinline__ void run(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
  }
};

template <>
struct MmaPV<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
  }
};

template <>
struct MmaPV<80> {
  static __device__ __forceinline__ void run(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
  }
};

template <>
struct MmaPV<96> {
  static __device__ __forceinline__ void run(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
  }
};

template <>
struct MmaPV<112> {
  static __device__ __forceinline__ void run(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
  }
};

template <>
struct MmaPV<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_v) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_v), "r"(1));
  }
};


template <int DP>
struct Tiles {
  static constexpr int kAtoms = (DP + kAtomCols - 1) / kAtomCols;
  static constexpr uint32_t kQBytes = kAtoms * kBQ * kRowBytes;
  static constexpr uint32_t kKVBytes = kAtoms * kBK * kRowBytes;  // K or V
  // Q, the K stages, the V stages, then the mbarriers: q_full, k_full[s],
  // v_full[s], empty[s]; 1024 bytes of slack to align the atoms
  static constexpr uint32_t kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmemBytes = kBarOffset + 8 * (1 + 3 * kStages)
                                       + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o, int H, int Hkv,
                             int Sq, int Skv, int d, int causal, int window,
                             int skip, float scale_log2) {
  using T = Tiles<DP>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms must start on a 1024-byte boundary
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + T::kQBytes;
  const uint32_t sv = sk + kStages * T::kKVBytes;
  const uint32_t q_full = sq + T::kBarOffset;
  const uint32_t k_full = q_full + 8;               // + 8 s
  const uint32_t v_full = k_full + 8 * kStages;     // + 8 s
  const uint32_t empty = v_full + 8 * kStages;      // + 8 s

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  int k_lo = 0, k_hi = Skv;
  if (skip) {
    if (causal) k_hi = min(Skv, q0 + kBQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every copy --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int a = 0; a < T::kAtoms; ++a)
        tma_load(sq + a * kBQ * kRowBytes, &tm_q, q_full, a * kAtomCols, q0,
                 b * H + h);
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int s = i % kStages;
        const uint32_t phase = (i / kStages) & 1;
        // the consumers have released this stage's previous tile (the
        // first pass through the ring finds the stages free)
        mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_expect_tx(k_full + 8 * s, T::kKVBytes);
        for (int a = 0; a < T::kAtoms; ++a)
          tma_load(sk + s * T::kKVBytes + a * kBK * kRowBytes, &tm_k,
                   k_full + 8 * s, a * kAtomCols, t * kBK, b * Hkv + hk);
        mbar_expect_tx(v_full + 8 * s, T::kKVBytes);
        for (int a = 0; a < T::kAtoms; ++a)
          tma_load(sv + s * T::kKVBytes + a * kBK * kRowBytes, &tm_v,
                   v_full + 8 * s, a * kAtomCols, t * kBK, b * Hkv + hk);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows per warpgroup -----------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = tid / 128 - 1;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane / 4;          // accumulator rows g and g + 8 of the warp
  const int tq = lane % 4;         // accumulator columns 2 tq, 2 tq + 1 of 8
  const int r0 = q0 + 64 * cw;     // the warpgroup's first row
  const int row_a = r0 + 16 * warp + g;
  const int row_b = row_a + 8;
  const uint32_t q_rows = sq + 64 * cw * kRowBytes;

  float acc[DP / 2];               // O, m64nDP: 4 values per 8 columns
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_full, 0);
  for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = t * kBK;
    const uint32_t k_tile = sk + s * T::kKVBytes;
    const uint32_t v_tile = sv + s * T::kKVBytes;

    // S = Q K^T over DP / 16 slices of 16 columns
    float sc[64];
    mbar_wait(k_full + 8 * s, phase);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const uint32_t col = (j / 4) * kBQ * kRowBytes + (j % 4) * 32;
      const uint32_t kcol = (j / 4) * kBK * kRowBytes + (j % 4) * 32;
      mma_qk(sc, smem_desc(q_rows + col, 16, 1024),
             smem_desc(k_tile + kcol, 16, 1024), j > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(sc);

    // scores in the log2 domain; the masks only where the tile meets an edge
    // (accumulator value e: column 8 (e / 4) + 2 tq + (e & 1), row g or g + 8)
    const bool edge = k0 + kBK > Skv || (causal && k0 + kBK - 1 > r0) ||
                      (window > 0 && r0 + 63 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int key = k0 + 8 * (e / 4) + 2 * tq + (e & 1);
        const int row = (e & 2) ? row_b : row_a;
        float x = sc[e] * scale_log2;
        if (key >= Skv) {
          x = -INFINITY;
        } else if ((causal && key > row) ||
                   (window > 0 && row - key >= window)) {
          x = kMasked;
        }
        sc[e] = x;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e) sc[e] *= scale_log2;
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      if (e & 2) mx_b = fmaxf(mx_b, sc[e]);
      else mx_a = fmaxf(mx_a, sc[e]);
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float corr_a = exp2f(m_a - mn_a);
    const float corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // P = P_hi + P_lo as wgmma's A fragments: slice kk of 16 keys holds
    // values 8 kk .. 8 kk + 7, two to a register
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const float mn = (e & 2) ? mn_b : mn_a;
      const float p0 = exp2f(sc[e] - mn);
      const float p1 = exp2f(sc[e + 1] - mn);
      if (e & 2) sum_b += p0 + p1;
      else sum_a += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          p0 - __low2float(hi), p1 - __high2float(hi));
      p_hi[e / 8][(e / 2) % 4] = bf16x2_bits(hi);
      p_lo[e / 8][(e / 2) % 4] = bf16x2_bits(lo);
    }
    l_a = l_a * corr_a + quad_sum(sum_a);
    l_b = l_b * corr_b + quad_sum(sum_b);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= corr_a;
      acc[4 * j + 1] *= corr_a;
      acc[4 * j + 2] *= corr_b;
      acc[4 * j + 3] *= corr_b;
    }

    // O += P_hi V + P_lo V over 8 slices of 16 keys
    mbar_wait(v_full + 8 * s, phase);
    reg_fence(acc);
    reg_fence(p_hi);
    reg_fence(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t desc_v = smem_desc(v_tile + kk * 16 * kRowBytes,
                                        kBK * kRowBytes, 1024);
      MmaPV<DP>::run(acc, p_hi[kk], desc_v);
      MmaPV<DP>::run(acc, p_lo[kk], desc_v);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* ob = o + ((long long)b * H + h) * Sq * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    if (8 * j >= d) continue;      // DP's padding (d = DP - 8)
    const int col = 8 * j + 2 * tq;
    if (row_a < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_a * d + col) =
          __floats2bfloat162_rn(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
    if (row_b < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_b * d + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] / den_b,
                                acc[4 * j + 3] / den_b);
  }
}

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime's entry-point query so that the library links nothing but cudart.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one of q, k, v: [BH, S, d] bf16, boxes of 64 columns by
// `rows` rows of one head, 128-byte swizzle, zeros past every edge.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
              int S, int BH, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kAtomCols, (cuuint32_t)rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Skv, int d, int causal, int window,
           int skip, float scale, cudaStream_t st) {
  // The shared-memory allowance is set once per device and head dim, and
  // the tensor maps are encoded on the host: after the first launch on a
  // device no call but the launch itself reaches the device, so launches
  // can be captured in a CUDA graph.
  static unsigned long long configured = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tiles<DP>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) configured |= 1ull << dev;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, d, Sq, B * H, kBQ) ||
      !make_map(encode, &tm_k, k, d, Skv, B * Hkv, kBK) ||
      !make_map(encode, &tm_v, v, d, Skv, B * Hkv, kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_attention_wgmma_kernel<DP><<<grid, kThreads, Tiles<DP>::kSmemBytes,
                                     st>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), H, Hkv, Sq, Skv, d,
      causal, window, skip, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) on `stream`.  q, o: [B, H, Sq, d]; k, v:
// [B, Hkv, Skv, d]; all contiguous bf16 starting on 16-byte boundaries; d a
// multiple of 8 up to 128; Hkv divides H; window 0 for none.  The wrapper
// checks all of that.  Returns cudaGetLastError() (cudaErrorInvalidValue
// for a shape it does not take, cudaErrorNotSupported without the driver's
// tensor-map encoder).
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Hkv, int Sq,
                                 int Skv, int d, int causal, int window,
                                 int skip, float scale, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Skv < 1 || d < 8 ||
      d > kMaxD || d % 8 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: return launch<16>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 32: return launch<32>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 48: return launch<48>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 64: return launch<64>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 80: return launch<80>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 96: return launch<96>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                               window, skip, scale, st);
    case 112: return launch<112>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                                 window, skip, scale, st);
    default: return launch<128>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                                window, skip, scale, st);
  }
}

// Dynamic shared memory of a launch at head dim d (one swizzle atom of
// columns up to d = 64, two above).
long long flash_attention_wgmma_smem_bytes(int d) {
  return (long long)(d <= kAtomCols ? Tiles<kAtomCols>::kSmemBytes
                                    : Tiles<kMaxD>::kSmemBytes);
}

const char* flash_attention_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

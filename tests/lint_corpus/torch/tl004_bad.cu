// TL004: half/bf16 accumulators and atomics that sum floats.
#include <cuda_bf16.h>
#include <cuda_fp16.h>

__global__ void sum_bf16(const float* __restrict__ x, float* out, int n) {
  __nv_bfloat16 acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += x[i];
  atomicAdd(out, __bfloat162float(acc));
}

__device__ __half dot_half(const __half* a, const __half* b, int n) {
  __half acc = __float2half(0.f);
  for (int i = 0; i < n; ++i) acc = __hfma(a[i], b[i], acc);
  return acc;
}

__global__ void partials(const float* x, float* total, int n) {
  cuda::atomic_ref<float, cuda::thread_scope_device> t(*total);
  t.fetch_add(x[threadIdx.x]);
}

// TL004: fp32 accumulators, partials folded in a fixed order, and an
// integer arrival counter.
#include <cuda/atomic>

__device__ __forceinline__ void warp_sum(float& a) {
  for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(~0u, a, off);
}

__global__ void sum_fp32(const float* __restrict__ x, float* part,
                         unsigned int* arrivals, int n) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += x[i];
  warp_sum(acc);
  const float* row = x;
  row += n;
  if (threadIdx.x == 0) {
    part[blockIdx.x] = acc;
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> arrived(
        arrivals[0]);
    arrived.fetch_add(1u, cuda::memory_order_acq_rel);
    atomicAdd(arrivals + 1, 1u);
  }
}

__global__ void fma_chain(const float* a, const float* b, float* y, int n) {
  float p = 0.f;
  for (int i = 0; i < n; ++i) p = fmaf(a[i], b[i], p);
  y[threadIdx.x] = p;
}

// Every finding here carries a reasoned suppression.
#include <cuda_fp16.h>

__global__ void half_sum(const __half* x, __half* out, int n) {
  __half acc = __float2half(0.f);
  for (int i = 0; i < n; ++i) {
    // tracelint: disable=TL004 fixture: a deliberate half accumulator
    acc += x[i];
  }
  out[0] = acc;
}

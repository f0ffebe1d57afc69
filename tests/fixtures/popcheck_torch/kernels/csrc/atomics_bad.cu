// Known-bad fixture: float atomics, which sum in block arrival order.
#include <cuda_fp16.h>

__global__ void fold_bad(const float* __restrict__ wide, const int* ids,
                         float* __restrict__ out, __half* hout, int d) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  atomicAdd(&out[ids[c]], wide[c]);               // BAD: float sum
  atomicAdd(hout + ids[c], __float2half(wide[c]));  // BAD: half sum
  // atomicAdd(out, 1.0f) in a comment is not code
  float old = atomicExch((float*)out, 0.0f);      // BAD: float exchange
  (void)old;
}

// Fused dense PDHG half-steps for Hopper (sm_90a), bound to PyTorch through
// ctypes by kernels/fused_pdhg_step.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/fused_pdhg_step.py:
//   fused_forward_step   (_fused_forward_kernel, pallas_call at :100)
//     x_new = clip(x - tau*(c + kty), l, u);   kx  = A x_new
//   fused_backward_step  (_fused_backward_kernel, pallas_call at :128)
//     y_new = y + sigma*(2 kx_new - kx_prev - q), >= 0 on ineq_mask rows;
//     kty = A^T y_new, with A^T never formed
// over a stack of k lanes, A [k, M, N] f32 or bf16, tau/sigma [k].
//
// What bounds them on this card: bytes, A once per half-step (dense_pdhg.cuh
// holds the product kernels and their design).  The tails read and write a
// few vectors of the lane, under 1% of A's bytes at the densified main-path
// stack.
//
// Design:
//  * Forward: a tail launch stores x_new for every lane, then the row
//    product reads it (2 launches).  The TPU kernel recomputes the tail at
//    every row block and keeps x_new in VMEM; here a row block would need the
//    whole of x_new (24.6 KB at N = 6,145), recomputed from five vectors by
//    each of the 4,104 blocks, about 500 MB of L2 reads per call.  The tail
//    launch costs the vectors once; chip_smoke.py measures it as the gap
//    between this step and bmatvec at the same shape.
//  * Backward: each block of the column product computes the dual tail for
//    its own chunk of rows into shared memory (its rows only, so the
//    recomputation costs (N / 256) x the dual vectors, about 1.7% of A's
//    bytes), and the blocks of the first column tile store y_new.  No
//    separate tail launch: 1 launch, or 2 when M is cut into chunks.
//  * The tails (pdhg_tails.cuh) round every operation to nearest and
//    contract nothing into an FMA, so y_new and x_new are bit-equal to the
//    plain PyTorch version's.

#include "dense_pdhg.cuh"
#include "pdhg_tails.cuh"

using pdhg::DualTail;
using pdhg::PrimalTail;

namespace {

template <class T>
int forward(const T* A, const PrimalTail& tail, float* x_new, float* kx, int k,
            int m, int n, cudaStream_t stream) {
  if (k <= 0) return cudaSuccess;
  if (n > 0) {
    dense::dense_tail_kernel<PrimalTail>
        <<<dim3(dense::blocks_for(n), k), dense::kThreads, 0, stream>>>(
            tail, n, x_new);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return dense::rows_product<T, PrimalTail>(A, x_new, kx, k, m, n, stream);
}

}  // namespace

extern "C" {

// (x_new [k, n], kx [k, m]); coef: 0 f32, 1 bf16.
int fused_forward_step(int coef, const void* A, const float* x,
                       const float* c, const float* l, const float* u,
                       const float* kty, const float* tau, float* x_new,
                       float* kx, int k, int m, int n, void* stream) {
  const PrimalTail tail{x, c, l, u, kty, tau, 0.0f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (coef) {
    case dense::kF32:
      return forward(static_cast<const float*>(A), tail, x_new, kx, k, m, n,
                     s);
    case dense::kBF16:
      return forward(static_cast<const __nv_bfloat16*>(A), tail, x_new, kx, k,
                     m, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// (y_new [k, m], kty [k, n]); part [k, n_chunks, n] f32 scratch (unused with
// one chunk); M is cut into n_chunks chunks of chunk_rows rows.
int fused_backward_step(int coef, const void* A, const float* y,
                        const float* q, const uint8_t* ineq_mask,
                        const float* kx_new, const float* kx_prev,
                        const float* sigma, float* part, float* y_new,
                        float* kty, int k, int m, int n, int chunk_rows,
                        int n_chunks, void* stream) {
  const DualTail tail{y, q, ineq_mask, kx_new, kx_prev, sigma, 0.0f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (coef) {
    case dense::kF32:
      return dense::cols_product<float, DualTail, DualTail>(
          static_cast<const float*>(A), tail, y_new, part, kty, k, m, n,
          chunk_rows, n_chunks, s);
    case dense::kBF16:
      return dense::cols_product<__nv_bfloat16, DualTail, DualTail>(
          static_cast<const __nv_bfloat16*>(A), tail, y_new, part, kty, k, m,
          n, chunk_rows, n_chunks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* fused_pdhg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

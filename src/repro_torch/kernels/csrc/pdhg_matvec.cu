// Batched dense matvecs for Hopper (sm_90a), bound to PyTorch through ctypes
// by kernels/pdhg_matvec.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pdhg_matvec.py:
//   bmatvec    (_bmatvec_kernel, pallas_call at :75)
//     y[k, M] = A[k, M, N] x[k, N]
//   bmatvec_t  (_bmatvec_t_kernel, pallas_call at :97)
//     x[k, N] = A^T y, from the untransposed layout
// with A f32 or bf16 and f32 accumulation.  The fused engine uses them for
// K and K^T outside the PDHG loop (power iteration, equilibration probes,
// the final KKT report).
//
// What bounds them on this card: bytes (A once, 2 flops per element; see
// dense_pdhg.cuh, which holds the kernels and the design).  The TPU kernels
// walk a (k, M/256, N/256) grid in order and carry a VMEM accumulator across
// the reduction axis; on Hopper blocks run in no order, so bmatvec gives each
// row its own warp and bmatvec_t splits M into chunks whose partial sums a
// second pass adds in order.  Launches per call: bmatvec 1, bmatvec_t 1, or
// 2 when M is cut into chunks.

#include "dense_pdhg.cuh"

using dense::PlainVec;

extern "C" {

// y [k, m] = A [k, m, n] x [k, n]; coef: 0 f32, 1 bf16.
int bmatvec(int coef, const void* A, const float* x, float* y, int k, int m,
            int n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (coef) {
    case dense::kF32:
      return dense::rows_product<float, PlainVec>(
          static_cast<const float*>(A), x, y, k, m, n, s);
    case dense::kBF16:
      return dense::rows_product<__nv_bfloat16, PlainVec>(
          static_cast<const __nv_bfloat16*>(A), x, y, k, m, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// x [k, n] = A^T y [k, m]; part [k, n_chunks, n] f32 scratch (unused with
// one chunk); M is cut into n_chunks chunks of chunk_rows rows.
int bmatvec_t(int coef, const void* A, const float* y, float* part, float* x,
              int k, int m, int n, int chunk_rows, int n_chunks,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PlainVec w{y};
  switch (coef) {
    case dense::kF32:
      return dense::cols_product<float, PlainVec, PlainVec>(
          static_cast<const float*>(A), w, nullptr, part, x, k, m, n,
          chunk_rows, n_chunks, s);
    case dense::kBF16:
      return dense::cols_product<__nv_bfloat16, PlainVec, PlainVec>(
          static_cast<const __nv_bfloat16*>(A), w, nullptr, part, x, k, m, n,
          chunk_rows, n_chunks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* pdhg_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

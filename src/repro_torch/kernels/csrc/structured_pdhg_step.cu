// Structured PDHG half-steps for Hopper (sm_90a), bound to PyTorch through
// ctypes by kernels/structured_pdhg_step.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/structured_pdhg_step.py:
//   structured_forward_step   (_forward_kernel, pallas_call at :120)
//     x_new = clip(x - tau*(c + kty), l, u)
//     kx    = sum_w row_val * x_new[row_idx]  +  fold(wrow_ids, wide rows)
//   structured_backward_step  (_backward_kernel, pallas_call at :150)
//     y_new = y + sigma*(2 kx_new - kx_prev - q), >= 0 on ineq_mask rows
//     kty   = sum_w col_val * y_new[col_idx]  +  fold(wcol_ids, wide cols)
// over a stack of k lanes; the ELL arrays are nnz-major [k, W, S] (S
// segments: M rows forward, N columns backward), padding entries are
// (idx 0, val 0.0).
//
// What bounds it on this card: bytes.  Each half-step reads the ELL payload
// once (8 B per stored entry) plus five lane vectors and writes two; the
// arithmetic is 2 flops per stored entry, ~1/4 flop per byte, far below the
// H100's ~20 flop/byte f32 balance point.  At the main path's shape (k=8,
// 2,048 jobs per lane) a half-step's nonzeros and vectors come to 2-3 MB,
// under a microsecond at 3.35 TB/s: less than the fixed cost of one launch,
// so launch latency, not bandwidth, sets the pace (chip_smoke.py prints the
// bound beside the measured times).
//
// Design:
//  * The TPU kernel runs grid=(k,) with a whole lane resident in VMEM.  Here
//    each lane's S outputs are tiled across 256-thread blocks (grid
//    (ceil(max(S, V)/256), k)), one thread per output segment, so k=8 lanes
//    still fill the SMs.  Consecutive threads read consecutive addresses of
//    each nnz-major row of the payload (coalesced); the gathered vector
//    entries come from L2 (a lane's vectors are ~25 KB).
//  * x_new (resp. y_new) is gathered at arbitrary indices of its lane while
//    blocks run in no order, so the narrow pass RECOMPUTES the tail at each
//    gathered index (5 gathers instead of 1, all L2 hits) instead of reading
//    values another block may not have written yet.  This keeps a
//    half-step at two launches.  The tails (pdhg_tails.cuh) use
//    round-to-nearest intrinsics (no FMA contraction), so the recomputed
//    value is bit-equal to the one stored, and to the plain PyTorch
//    version's.
//  * The wide bucket (segments wider than max(16, 4x median): Gavel's worker
//    rows and epigraph column, each as wide as the lane has jobs) is reduced
//    by one 256-thread block per bucket column in a SECOND launch, which
//    reads the x_new (y_new) the first launch stored, and adds its sum onto
//    its segment with one atomicAdd.  Bucket ids are distinct except padded
//    columns (id 0, value 0.0), and a wide segment's narrow entries are all
//    padding, so the add is exact and the result deterministic; running it
//    after the narrow pass orders it behind the narrow store to the same
//    segment.  Launches per half-step: 2.
//  * No shared-memory staging, no wgmma, no TMA: right and simple first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pdhg_tails.cuh"

namespace {

using pdhg::DualTail;
using pdhg::PrimalTail;

constexpr int kNarrowThreads = 256;
constexpr int kWideThreads = 256;

// Launch 1: the tail for every vector entry (stored to v_new) and the
// narrow ELL reduce for every output segment (stored to out).
template <class Tail>
__global__ void __launch_bounds__(kNarrowThreads)
narrow_tail_kernel(const int32_t* __restrict__ idx,
                   const float* __restrict__ val, int w_len, int s_len,
                   int v_len, Tail tail, float* __restrict__ v_new,
                   float* __restrict__ out) {
  const int b = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Tail t = tail.lane(b, v_len);
  if (i < v_len) v_new[(int64_t)b * v_len + i] = t(i);
  if (i < s_len) {
    const int64_t base = (int64_t)b * w_len * s_len + i;
    float acc = 0.0f;
    for (int w = 0; w < w_len; ++w) {
      const int64_t e = base + (int64_t)w * s_len;
      acc = fmaf(val[e], t(idx[e]), acc);
    }
    out[(int64_t)b * s_len + i] = acc;
  }
}

// Launch 2: one block per (wide bucket column d, lane b) reduces the column
// against the stored v_new and adds the sum onto segment wids[b, d].  (Tail
// only names the instance, so a profile tells the two half-steps apart.)
template <class Tail>
__global__ void __launch_bounds__(kWideThreads)
wide_fold_kernel(const int32_t* __restrict__ widx,
                 const float* __restrict__ wval,
                 const int32_t* __restrict__ wids, int w_len, int d_len,
                 const float* __restrict__ v_new, int v_len,
                 float* __restrict__ out, int s_len) {
  const int d = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t base = (int64_t)b * w_len * d_len + d;
  const float* v = v_new + (int64_t)b * v_len;
  float acc = 0.0f;
  for (int w = threadIdx.x; w < w_len; w += kWideThreads) {
    const int64_t e = base + (int64_t)w * d_len;
    acc = fmaf(wval[e], v[widx[e]], acc);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ float part[kWideThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kWideThreads / 32 ? part[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (threadIdx.x == 0)
      atomicAdd(out + (int64_t)b * s_len + wids[(int64_t)b * d_len + d], acc);
  }
}

template <class Tail>
int half_step(const int32_t* idx, const float* val, const int32_t* widx,
              const float* wval, const int32_t* wids, Tail tail,
              float* v_new, float* out, int k, int v_len, int s_len, int w_len,
              int ww_len, int d_len, cudaStream_t stream) {
  if (k <= 0 || (v_len <= 0 && s_len <= 0)) return cudaSuccess;
  const int span = v_len > s_len ? v_len : s_len;
  const dim3 grid((span + kNarrowThreads - 1) / kNarrowThreads, k);
  narrow_tail_kernel<Tail><<<grid, kNarrowThreads, 0, stream>>>(
      idx, val, w_len, s_len, v_len, tail, v_new, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || d_len <= 0 || s_len <= 0) return err;
  wide_fold_kernel<Tail><<<dim3(d_len, k), kWideThreads, 0, stream>>>(
      widx, wval, wids, ww_len, d_len, v_new, v_len, out, s_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (x_new [k, n], kx [k, m]); row side [k, wr, m] / [k, ww, dr] / [k, dr].
int structured_forward_step(const int32_t* row_idx, const float* row_val,
                            const int32_t* wrow_idx, const float* wrow_val,
                            const int32_t* wrow_ids, const float* x,
                            const float* c, const float* l, const float* u,
                            const float* kty, const float* tau, float* x_new,
                            float* kx, int k, int n, int m, int wr, int ww,
                            int dr, void* stream) {
  const PrimalTail tail{x, c, l, u, kty, tau, 0.0f};
  return half_step(row_idx, row_val, wrow_idx, wrow_val, wrow_ids, tail,
                   x_new, kx, k, n, m, wr, ww, dr,
                   static_cast<cudaStream_t>(stream));
}

// (y_new [k, m], kty [k, n]); column side [k, wc, n] / [k, wv, dc] / [k, dc].
int structured_backward_step(const int32_t* col_idx, const float* col_val,
                             const int32_t* wcol_idx, const float* wcol_val,
                             const int32_t* wcol_ids, const float* y,
                             const float* q, const uint8_t* ineq_mask,
                             const float* kx_new, const float* kx_prev,
                             const float* sigma, float* y_new, float* kty,
                             int k, int m, int n, int wc, int wv, int dc,
                             void* stream) {
  const DualTail tail{y, q, ineq_mask, kx_new, kx_prev, sigma, 0.0f};
  return half_step(col_idx, col_val, wcol_idx, wcol_val, wcol_ids, tail,
                   y_new, kty, k, m, n, wc, wv, dc,
                   static_cast<cudaStream_t>(stream));
}

const char* structured_pdhg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

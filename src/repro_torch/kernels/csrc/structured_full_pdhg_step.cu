// Streaming full-problem PDHG half-steps for Hopper (sm_90a), bound to
// PyTorch through ctypes by kernels/structured_full_pdhg_step.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/structured_pdhg_step.py:
//   structured_full_forward_step   (:312; body _full_forward_kernel :182,
//                                   launcher _full_call :256)
//     x_new = clip(x - tau*(c + kty), l, u)
//     kx    = sum_w deq(row_val) * x_new[row_idx]  +  pad(wide, 1)[row_fold]
//     wide[d] = sum_{w < wb(d)} deq(wrow_val) * x_new[wrow_idx]
//   structured_full_backward_step  (:334; body _full_backward_kernel :218)
//     y_new = y + sigma*(2 kx_new - kx_prev - q), >= 0 on ineq_mask rows
//     kty   = the same on the column side, folded through col_fold
// for ONE lane (the unpartitioned k=1 problem).  The ELL arrays are
// nnz-major: narrow [W, S] (S segments: M rows forward, N columns backward),
// wide bucket [Ww, D] with its columns sorted by descending width; padding
// entries are (idx 0, val 0).  fold[s] names the bucket column of a wide
// segment, or D (the zero slot) for a narrow one.  Coefficients are f32, bf16
// or int8 (with one f32 dequant scale per bucket): each stored value is
// converted to f32, multiplied by its scale, then by the gathered value, and
// summed in f32, as the plain version does.
//
// What bounds it on this card: bytes.  A half-step reads each stored nonzero
// once (4 B index + 4/2/1 B coefficient) and the lane vectors, and does 2
// flops per nonzero: ~1/4 flop per byte, far below the H100's f32 balance
// point.  At the traffic-engineering shape of 20,000 demands (forward: 1.75 M
// nonzeros, N = 80,000, M = 23,580) that is ~16 MB, ~5 us at 3.35 TB/s.
//
// Design:
//  * Ordering: a tail pass first.  Both reduces gather x_new (y_new) at
//    arbitrary indices while their blocks run in no order, so launch 1
//    stores the tail for every vector entry (320 KB at N = 80,000) and the
//    two reduces gather the stored value.  Recomputing the tail at each
//    gathered index instead (as the lane kernels do) costs five scattered
//    L2 reads per stored entry in place of one; at 20,000 demands that made
//    the two reduces of a forward call take 0.065 ms of device time on an
//    NVIDIA H100 80GB HBM3 at 700 W, most of it L2 traffic.  The tail uses
//    round-to-nearest intrinsics (pdhg_tails.cuh), so it is bit-equal to the
//    plain version's.
//    Launches per half-step: 3 (tail, wide partials, narrow + fold).
//  * The wide pass is ragged and lopsided: at 20,000 demands the 2,687 bucket
//    columns run from 8,040 entries deep down to 48, and the Gavel full LP's
//    row bucket has 3 columns 16,384 deep.  So the bucket is cut into tiles of
//    TC consecutive columns by CHUNK rows, TC a power of two up to 32 chosen
//    from the plan's block width: the TC threads of a row group read
//    consecutive addresses of one nnz-major row (coalesced), and the 256/TC
//    row groups of a block split the chunk's rows.  A tile stops at its plan
//    block's width wb, never at the stored depth (at 20,000 demands the plan
//    covers 2.38 M of the 21.6 M stored elements).  The plan arrives as a
//    small device int32 [n_blocks, 3] array of (c0, c1, wb); each block of
//    the two reduces copies it to shared memory before scanning it.
//  * Deterministic, no atomics.  A tile's row groups are summed in a fixed
//    order in shared memory and the tile writes its partial to
//    partial[chunk, d]; the narrow pass then adds a wide segment's partials in
//    chunk order through the fold map.  Every partial it reads was written:
//    the chunks of column d are exactly those below its block's wb.
//  * Narrow pass: one thread per output segment, looping over W with
//    coalesced reads of each nnz-major row.
//  * No shared-memory staging of the payload, no TMA: right and simple first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pdhg_tails.cuh"

namespace {

using pdhg::DualTail;
using pdhg::PrimalTail;

constexpr int kThreads = 256;
// rows each thread reduces in one wide tile: CHUNK = (256 / TC) * kWideIters
constexpr int kWideIters = 16;
// plan rows the reduces copy to shared memory: 12 B a row, within the 48 KB
// a launch may ask for without opting in, less wide_partial_kernel's static
// 1 KB of row-group sums: (49,152 - 1,024) / 12
constexpr int kMaxPlanBlocks = 4010;
static_assert(3 * sizeof(int32_t) * kMaxPlanBlocks + sizeof(float) * kThreads
                  <= 48 * 1024,
              "the largest plan and the row-group sums exceed 48 KB");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// Launch 1: the tail for every vector entry, stored to v_new.
template <class Tail>
__global__ void __launch_bounds__(kThreads)
full_tail_kernel(Tail tail, int v_len, float* __restrict__ v_new) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < v_len) v_new[i] = tail.lane(0, v_len)(i);
}

// The plan's rows, copied to shared memory by the whole block.
__device__ __forceinline__ void load_plan(const int32_t* __restrict__ plan,
                                          int n_blocks, int32_t* splan) {
  for (int k = threadIdx.x; k < 3 * n_blocks; k += blockDim.x)
    splan[k] = plan[k];
  __syncthreads();
}

// Launch 2: one block per tile of the wide bucket: TC consecutive columns of
// one plan block by one chunk of rows below the block's width.  Tiles are
// numbered block by block, so no block is launched for the padding a
// rectangular grid over the ragged plan would hold.  Each tile stores one
// partial sum per column.  (Tail only names the instance, so a profile
// tells the two half-steps apart.)
template <class T, class Tail>
__global__ void __launch_bounds__(kThreads)
wide_partial_kernel(const int32_t* __restrict__ widx,
                    const T* __restrict__ wval,
                    const float* __restrict__ wscale, int d_len,
                    const int32_t* __restrict__ plan, int n_blocks, int tc,
                    const float* __restrict__ v_new,
                    float* __restrict__ partial) {
  extern __shared__ int32_t splan[];
  load_plan(plan, n_blocks, splan);
  const int groups = kThreads / tc;
  const int chunk_rows = groups * kWideIters;
  int tile = blockIdx.x;
  int c0 = 0, c1 = 0, wb = 0, n_sub = 1, b = 0;
  for (; b < n_blocks; ++b) {
    c0 = splan[3 * b];
    c1 = splan[3 * b + 1];
    wb = splan[3 * b + 2];
    n_sub = (c1 - c0 + tc - 1) / tc;
    const int n_tiles = n_sub * ((wb + chunk_rows - 1) / chunk_rows);
    if (tile < n_tiles) break;
    tile -= n_tiles;
  }
  if (b == n_blocks) return;  // the same for the whole block
  const int j = tile / n_sub;
  const int tx = threadIdx.x % tc;
  const int ty = threadIdx.x / tc;
  const int d = c0 + (tile % n_sub) * tc + tx;
  const int w0 = j * chunk_rows;
  const int w1 = min(wb, w0 + chunk_rows);
  const float s = wscale != nullptr ? *wscale : 1.0f;
  float acc = 0.0f;
  if (d < c1) {
#pragma unroll 4
    for (int w = w0 + ty; w < w1; w += groups) {
      const int64_t e = (int64_t)w * d_len + d;
      acc = fmaf(__fmul_rn(to_f32(wval[e]), s), v_new[widx[e]], acc);
    }
  }
  __shared__ float part[kThreads];
  part[threadIdx.x] = acc;
  __syncthreads();
  if (ty == 0 && d < c1) {
    float sum = 0.0f;
    for (int g = 0; g < groups; ++g) sum = __fadd_rn(sum, part[g * tc + tx]);
    partial[(int64_t)j * d_len + d] = sum;
  }
}

// Launch 3: for every output segment, the narrow reduce plus its wide
// partials through the fold map (stored to out).  (Tail names the instance.)
template <class T, class Tail>
__global__ void __launch_bounds__(kThreads)
full_narrow_kernel(const int32_t* __restrict__ idx, const T* __restrict__ val,
                   const float* __restrict__ scale, int w_len, int s_len,
                   const int32_t* __restrict__ fold,
                   const float* __restrict__ partial, int d_len,
                   const int32_t* __restrict__ plan, int n_blocks,
                   int chunk_rows, const float* __restrict__ v_new,
                   float* __restrict__ out) {
  extern __shared__ int32_t splan[];
  load_plan(plan, n_blocks, splan);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s_len) return;
  const float s = scale != nullptr ? *scale : 1.0f;
  float acc = 0.0f;
#pragma unroll 4
  for (int w = 0; w < w_len; ++w) {
    const int64_t e = (int64_t)w * s_len + i;
    acc = fmaf(__fmul_rn(to_f32(val[e]), s), v_new[idx[e]], acc);
  }
  const int d = fold[i];
  if (d < d_len) {
    int n_chunks = 0;
    for (int b = 0; b < n_blocks; ++b) {
      if (d >= splan[3 * b] && d < splan[3 * b + 1]) {
        n_chunks = (splan[3 * b + 2] + chunk_rows - 1) / chunk_rows;
        break;
      }
    }
    float wide = 0.0f;
#pragma unroll 8
    for (int j = 0; j < n_chunks; ++j)
      wide = __fadd_rn(wide, partial[(int64_t)j * d_len + d]);
    acc = __fadd_rn(acc, wide);
  }
  out[i] = acc;
}

template <class T, class Tail>
int half_step(const int32_t* idx, const T* val, const float* scale,
              const int32_t* widx, const T* wval, const float* wscale,
              const int32_t* fold, const int32_t* plan, Tail tail,
              float* partial, float* v_new, float* out, int v_len, int s_len,
              int w_len, int d_len, int n_blocks, int tc, int n_tiles,
              cudaStream_t stream) {
  if (tc < 1 || tc > 32 || kThreads % tc != 0 || n_blocks < 0 ||
      n_blocks > kMaxPlanBlocks)
    return cudaErrorInvalidValue;
  const size_t plan_bytes = 3 * sizeof(int32_t) * n_blocks;
  if (v_len > 0) {
    full_tail_kernel<Tail>
        <<<(v_len + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
            tail, v_len, v_new);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_tiles > 0) {
    wide_partial_kernel<T, Tail><<<n_tiles, kThreads, plan_bytes, stream>>>(
        widx, wval, wscale, d_len, plan, n_blocks, tc, v_new, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (s_len <= 0) return cudaSuccess;
  const int chunk_rows = (kThreads / tc) * kWideIters;
  full_narrow_kernel<T, Tail>
      <<<(s_len + kThreads - 1) / kThreads, kThreads, plan_bytes, stream>>>(
          idx, val, scale, w_len, s_len, fold, partial, d_len, plan,
          n_blocks, chunk_rows, v_new, out);
  return cudaGetLastError();
}

// coefficient storage codes the wrapper passes (kernels/structured_full_pdhg_step.py)
enum CoefType { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <class Tail>
int dispatch(int coef, const int32_t* idx, const void* val, const float* scale,
             const int32_t* widx, const void* wval, const float* wscale,
             const int32_t* fold, const int32_t* plan, Tail tail,
             float* partial, float* v_new, float* out, int v_len, int s_len,
             int w_len, int d_len, int n_blocks, int tc, int n_tiles,
             cudaStream_t stream) {
  switch (coef) {
    case kF32:
      return half_step(idx, static_cast<const float*>(val), scale, widx,
                       static_cast<const float*>(wval), wscale, fold, plan,
                       tail, partial, v_new, out, v_len, s_len, w_len, d_len,
                       n_blocks, tc, n_tiles, stream);
    case kBF16:
      return half_step(idx, static_cast<const __nv_bfloat16*>(val), scale,
                       widx, static_cast<const __nv_bfloat16*>(wval), wscale,
                       fold, plan, tail, partial, v_new, out, v_len, s_len,
                       w_len, d_len, n_blocks, tc, n_tiles, stream);
    case kI8:
      return half_step(idx, static_cast<const int8_t*>(val), scale, widx,
                       static_cast<const int8_t*>(wval), wscale, fold, plan,
                       tail, partial, v_new, out, v_len, s_len, w_len, d_len,
                       n_blocks, tc, n_tiles, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// (x_new [n], kx [m]); row side [wr, m] / [ww, dr] / fold [m]; scales are
// one float on the device or null; plan [n_blocks, 3] int32 on the device;
// tc the wide tile's column count (a power of two up to 32), n_tiles the
// tiles the plan holds; partial [max chunks over the plan, dr] f32 scratch.
int structured_full_forward_step(
    int coef, const int32_t* row_idx, const void* row_val,
    const float* row_scale, const int32_t* wrow_idx, const void* wrow_val,
    const float* wrow_scale, const int32_t* row_fold, const int32_t* plan,
    const float* x, const float* c, const float* l, const float* u,
    const float* kty, const float* tau, float* partial, float* x_new,
    float* kx, int n, int m, int wr, int dr, int n_blocks, int tc,
    int n_tiles, void* stream) {
  const PrimalTail tail{x, c, l, u, kty, tau, 0.0f};
  return dispatch(coef, row_idx, row_val, row_scale, wrow_idx, wrow_val,
                  wrow_scale, row_fold, plan, tail, partial, x_new, kx, n, m,
                  wr, dr, n_blocks, tc, n_tiles,
                  static_cast<cudaStream_t>(stream));
}

// (y_new [m], kty [n]); column side [wc, n] / [wv, dc] / fold [n].
int structured_full_backward_step(
    int coef, const int32_t* col_idx, const void* col_val,
    const float* col_scale, const int32_t* wcol_idx, const void* wcol_val,
    const float* wcol_scale, const int32_t* col_fold, const int32_t* plan,
    const float* y, const float* q, const uint8_t* ineq_mask,
    const float* kx_new, const float* kx_prev, const float* sigma,
    float* partial, float* y_new, float* kty, int m, int n, int wc, int dc,
    int n_blocks, int tc, int n_tiles, void* stream) {
  const DualTail tail{y, q, ineq_mask, kx_new, kx_prev, sigma, 0.0f};
  return dispatch(coef, col_idx, col_val, col_scale, wcol_idx, wcol_val,
                  wcol_scale, col_fold, plan, tail, partial, y_new, kty, m, n,
                  wc, dc, n_blocks, tc, n_tiles,
                  static_cast<cudaStream_t>(stream));
}

const char* structured_full_pdhg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

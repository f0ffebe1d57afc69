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
// The wrapper checks an operator side and its ragged plan once and hands
// them over as one FullSide struct; the C functions write the number of
// CUDA launches they made into it.
//
// Shared by both directions:
//  * The wide pass is ragged and lopsided: at 20,000 demands the 2,687 bucket
//    columns run from 8,040 entries deep down to 48, and the Gavel full LP's
//    row bucket has 3 columns 16,384 deep.  So the bucket is cut into tiles of
//    TC consecutive columns by CHUNK rows, TC a power of two up to 32 chosen
//    from the plan's block width: the TC threads of a row group read
//    consecutive addresses of one nnz-major row (coalesced), and the 256/TC
//    row groups of a block split the chunk's rows.  A tile stops at its plan
//    block's width wb, never at the stored depth (at 20,000 demands the plan
//    covers 2.38 M of the 21.6 M stored elements).  The plan arrives as a
//    small device int32 array of (c0, c1, wb[, first tile]) rows, copied to
//    shared memory.
//  * Deterministic, no atomics.  A tile's row groups are summed in a fixed
//    order in shared memory and the tile writes its partial to
//    partial[chunk, d]; a wide segment then adds its partials in chunk order
//    through the fold map.  Every partial it reads was written: the chunks
//    of column d are exactly those below its block's wb.
//
// Forward (full_forward_coop_kernel): a persistent cooperative kernel
// (cudaLaunchCooperativeKernel, at most the blocks that fit on the card at
// once), its phases separated by grid.sync():
//  1. the primal tail for all N into x_new (grid-stride).  The reduces
//     gather x_new at arbitrary indices, so it is stored once and gathered
//     (recomputing it at each gathered index costs five L2 reads per stored
//     entry in place of one);
//  2. one work list: the plan's wide tiles, then the narrow rows in items of
//     128; blocks take items round-robin.  A wide tile loads all 16 rows of
//     each thread's chunk ahead of their gathers of x_new.  A narrow item
//     splits each row's W entries over the block's 8 warps (warp g takes
//     w = g, g+8, ...; each lane 4 consecutive rows, read with 16-byte
//     loads where the layout is aligned) and adds the 8 warp sums in warp
//     order: 8x the threads of one-per-row;
//  3. each wide segment (fold < D) adds its partials in chunk order onto the
//     narrow sum phase 2 stored.
//  Variant 1 runs all three phases in one launch; variant 2 launches the
//  tail kernel, then the cooperative kernel from phase 2 (one grid.sync
//  less).  Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 at
//  700 W (PERF.md): staging the wide tiles' indices through a cp.async ring
//  in shared memory took 0.033 ms a call against 0.021 ms loading them into
//  registers (the ring's 16 KB a block took L1 from the gathers of x_new),
//  so there is no ring.  Variant 2 ran up to 1.2 us faster on the device
//  but costs the host one launch more, and the host sets the pace of the
//  solve loop, so the wrapper takes variant 1.
//
// Backward (three launches, the first design): full_tail_kernel stores the
// tail, wide_partial_kernel one block per wide tile, full_narrow_kernel one
// thread per output segment plus the fold-map add-back.
//  * No TMA, no wgmma: the bytes are gathered, not tiled.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pdhg_tails.cuh"

namespace cg = cooperative_groups;

// one side of the single-lane operator and its plan, packed by the wrapper
// once per operator (kernels/structured_full_pdhg_step.py: FullSide, the
// same layout)
struct FullSide {
  const int32_t* idx;    // [w, s_len]
  const void* val;       // [w, s_len], f32 / bf16 / int8
  const float* scale;    // [1] (int8) or null
  const int32_t* widx;   // [ww, d]
  const void* wval;      // [ww, d]
  const float* wscale;   // [1] (int8) or null
  const int32_t* fold;   // [s_len]
  const int32_t* plan;   // [n_blocks, 3] (backward) or [n_blocks, 4]
  int32_t coef, w, s_len, d, n_blocks, tc, n_tiles, n_chunks;
  int32_t vec;       // idx/val rows may be read 4 segments at a time
  int32_t launches;  // written by the C functions: CUDA launches made
};

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


// ----------------------------------------------------------------------
// The forward half-step as one persistent cooperative launch
// ----------------------------------------------------------------------

// narrow items: 8 warps split a row's W entries, each lane 4 rows
constexpr int kNarrowWarps = kThreads / 32;
constexpr int kRowsPerLane = 4;
constexpr int kNarrowRows = 32 * kRowsPerLane;
// a wide segment's partials loaded ahead of their in-order sum
constexpr int kFoldBatch = 16;
// the cooperative kernel's dynamic shared memory: the plan with its first
// tiles (16 B a row), beside its static 4 KB of sums
constexpr int kCoopSmemMax = 4 * sizeof(int32_t) * kMaxPlanBlocks;
// blocks of the cooperative kernel an SM should hold (caps its registers)
constexpr int kCoopBlocksPerSM = 6;
static_assert(kCoopSmemMax + sizeof(float) * kNarrowWarps * kNarrowRows
                  <= 227 * 1024,
              "the cooperative kernel's shared memory exceeds 227 KB");

// four consecutive coefficients as f32 (16/8/4-byte loads; aligned)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const int8_t* p, float* v) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// the plan block holding ``key`` in column ``col`` of the [n, 4] rows
// (ascending): the last row whose entry is <= key
__device__ __forceinline__ int plan_row(const int32_t* splan, int n, int col,
                                        int key) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (splan[4 * mid + col] <= key) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// one wide tile (as wide_partial_kernel's): its partial sum of each of its
// columns over its chunk of rows
template <class T>
__device__ __forceinline__ void coop_wide_tile(
    const FullSide& s, int item, const int32_t* splan, float* sred,
    const float* x_new, float* partial) {
  const T* wval = static_cast<const T*>(s.wval);
  const int b = plan_row(splan, s.n_blocks, 3, item);
  const int c0 = splan[4 * b], c1 = splan[4 * b + 1], wb = splan[4 * b + 2];
  const int tile = item - splan[4 * b + 3];
  const int tc = s.tc;
  const int groups = kThreads / tc;
  const int chunk_rows = groups * kWideIters;
  const int n_sub = (c1 - c0 + tc - 1) / tc;
  const int j = tile / n_sub;
  const int tx = threadIdx.x % tc;
  const int ty = threadIdx.x / tc;
  const int d = c0 + (tile % n_sub) * tc + tx;
  const int w0 = j * chunk_rows + ty;
  const int w1 = min(wb, j * chunk_rows + chunk_rows);
  const bool live = d < c1;
  // every row of the thread's chunk loaded ahead of its gather
  const float sc = s.wscale != nullptr ? *s.wscale : 1.0f;
  int32_t id[kWideIters];
  float v[kWideIters];
#pragma unroll
  for (int g = 0; g < kWideIters; ++g) {
    const int w = w0 + g * groups;
    const bool in = live && w < w1;
    const int64_t e = (int64_t)w * s.d + d;
    id[g] = in ? s.widx[e] : 0;
    v[g] = in ? to_f32(wval[e]) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int g = 0; g < kWideIters; ++g) {
    if (live && w0 + g * groups < w1)
      acc = fmaf(__fmul_rn(v[g], sc), x_new[id[g]], acc);
  }
  sred[threadIdx.x] = acc;
  __syncthreads();
  if (ty == 0 && live) {
    float sum = 0.0f;
    for (int g = 0; g < groups; ++g) sum = __fadd_rn(sum, sred[g * tc + tx]);
    partial[(int64_t)j * s.d + d] = sum;
  }
  __syncthreads();
}

// one narrow item: rows [128 item, 128 item + 128), their sums stored to out
template <class T>
__device__ __forceinline__ void coop_narrow_item(
    const FullSide& s, int item, float* sred, const float* x_new,
    float* out) {
  const T* val = static_cast<const T*>(s.val);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = s.s_len;
  const int i0 = item * kNarrowRows + lane * kRowsPerLane;
  const float sc = s.scale != nullptr ? *s.scale : 1.0f;
  float acc[kRowsPerLane] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool vec = s.vec && i0 + kRowsPerLane <= S;
#pragma unroll 4
  for (int w = warp; w < s.w; w += kNarrowWarps) {
    const int64_t e = (int64_t)w * S + i0;
    int32_t id[kRowsPerLane];
    float v[kRowsPerLane];
    if (vec) {
      const int4 q = *reinterpret_cast<const int4*>(s.idx + e);
      id[0] = q.x; id[1] = q.y; id[2] = q.z; id[3] = q.w;
      load4(val + e, v);
    } else {
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const bool in = i0 + r < S;
        id[r] = in ? s.idx[e + r] : 0;
        v[r] = in ? to_f32(val[e + r]) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerLane; ++r)
      acc[r] = fmaf(__fmul_rn(v[r], sc), x_new[id[r]], acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r)
    sred[warp * kNarrowRows + lane * kRowsPerLane + r] = acc[r];
  __syncthreads();
  if (threadIdx.x < kNarrowRows) {
    const int i = item * kNarrowRows + threadIdx.x;
    if (i < S) {
      float sum = 0.0f;
#pragma unroll
      for (int g = 0; g < kNarrowWarps; ++g)
        sum = __fadd_rn(sum, sred[g * kNarrowRows + threadIdx.x]);
      out[i] = sum;
    }
  }
  __syncthreads();
}

// x_new, out and partial are written and read inside the launch, so they
// are plain (never read-only-cache) pointers.  (Tail names the instance.)
template <class T, class Tail>
__global__ void __launch_bounds__(kThreads, kCoopBlocksPerSM)
full_forward_coop_kernel(FullSide s, Tail tail, int v_len, int do_tail,
                         float* x_new, float* out, float* partial) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int32_t csmem[];
  int32_t* splan = csmem;  // [n_blocks, 4]
  __shared__ float sred[kNarrowWarps * kNarrowRows];
  for (int k = threadIdx.x; k < 4 * s.n_blocks; k += kThreads)
    splan[k] = s.plan[k];
  __syncthreads();
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kThreads;

  // 1. the tail
  if (do_tail) {
    const Tail t = tail.lane(0, v_len);
    for (int64_t i = gtid; i < v_len; i += gstride) x_new[i] = t(i);
    grid.sync();
  }

  // 2. the wide tiles, then the narrow items
  const int n_items = s.n_tiles + (s.s_len + kNarrowRows - 1) / kNarrowRows;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    if (item < s.n_tiles)
      coop_wide_tile<T>(s, item, splan, sred, x_new, partial);
    else
      coop_narrow_item<T>(s, item - s.n_tiles, sred, x_new, out);
  }
  if (s.d <= 0 || s.n_tiles <= 0) return;
  grid.sync();

  // 3. each wide segment adds its partials in chunk order
  const int chunk_rows = (kThreads / s.tc) * kWideIters;
  for (int64_t i = gtid; i < s.s_len; i += gstride) {
    const int d = s.fold[i];
    if (d < s.d) {
      const int b = plan_row(splan, s.n_blocks, 0, d);
      const int n_chunks = (splan[4 * b + 2] + chunk_rows - 1) / chunk_rows;
      float wide = 0.0f;
      for (int j0 = 0; j0 < n_chunks; j0 += kFoldBatch) {
        float pv[kFoldBatch];
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u)
          pv[u] = j0 + u < n_chunks ? partial[(int64_t)(j0 + u) * s.d + d]
                                    : 0.0f;
#pragma unroll
        for (int u = 0; u < kFoldBatch; ++u)
          if (j0 + u < n_chunks) wide = __fadd_rn(wide, pv[u]);
      }
      out[i] = __fadd_rn(out[i], wide);
    }
  }
}

// the cooperative grid: the co-resident blocks, found once per device and
// shared-memory size (and the shared-memory opt-in, once per device)
template <class T>
cudaError_t coop_grid(size_t smem, int* grid) {
  struct Entry { int dev; size_t smem; int blocks; };
  static Entry cache[16];
  static int n_cached = 0;
  static uint64_t opted = 0;
  auto kernel = full_forward_coop_kernel<T, PrimalTail>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int e = 0; e < n_cached; ++e) {
    if (cache[e].dev == dev && cache[e].smem == smem) {
      *grid = cache[e].blocks;
      return cudaSuccess;
    }
  }
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(opted & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCoopSmemMax);
    if (err != cudaSuccess) return err;
    opted |= bit;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  if (n_cached < 16) cache[n_cached++] = Entry{dev, smem, *grid};
  return cudaSuccess;
}

// variant 1: one cooperative launch; variant 2: the tail kernel, then the
// cooperative kernel from phase 2
template <class T>
int forward_coop(FullSide* s, PrimalTail tail, float* partial, float* x_new,
                 float* out, int v_len, int variant, cudaStream_t stream) {
  s->launches = 0;
  if (s->tc < 1 || s->tc > 32 || kThreads % s->tc != 0 || s->n_blocks < 1 ||
      s->n_blocks > kMaxPlanBlocks || (variant != 1 && variant != 2))
    return cudaErrorInvalidValue;
  const size_t smem = 4 * sizeof(int32_t) * s->n_blocks;
  int grid = 0;
  cudaError_t err = coop_grid<T>(smem, &grid);
  if (err != cudaSuccess) return err;
  // no more blocks than the largest phase has work for
  const int64_t per = kThreads;
  int64_t work = s->n_tiles + (s->s_len + kNarrowRows - 1) / kNarrowRows;
  work = work > (s->s_len + per - 1) / per ? work : (s->s_len + per - 1) / per;
  if (variant == 1)
    work = work > (v_len + per - 1) / per ? work : (v_len + per - 1) / per;
  if (work < 1) work = 1;
  if (grid > work) grid = static_cast<int>(work);
  int do_tail = variant == 1;
  if (variant == 2 && v_len > 0) {
    full_tail_kernel<PrimalTail>
        <<<(v_len + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
            tail, v_len, x_new);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    s->launches = 1;
  }
  FullSide sv = *s;
  void* args[] = {&sv, &tail, &v_len, &do_tail, &x_new, &out, &partial};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(full_forward_coop_kernel<T, PrimalTail>),
      dim3(grid), dim3(kThreads), args, smem, stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  if (err != cudaSuccess) return err;
  if (last == cudaSuccess) s->launches += 1;
  return last;
}

template <class T, class Tail>
int half_step(FullSide* s, Tail tail, float* partial, float* v_new,
              float* out, int v_len, cudaStream_t stream) {
  const T* val = static_cast<const T*>(s->val);
  const T* wval = static_cast<const T*>(s->wval);
  const int tc = s->tc, n_blocks = s->n_blocks, d_len = s->d;
  if (tc < 1 || tc > 32 || kThreads % tc != 0 || n_blocks < 0 ||
      n_blocks > kMaxPlanBlocks)
    return cudaErrorInvalidValue;
  const size_t plan_bytes = 3 * sizeof(int32_t) * n_blocks;
  int launches = 0;
  if (v_len > 0) {
    full_tail_kernel<Tail>
        <<<(v_len + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
            tail, v_len, v_new);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++launches;
  }
  if (s->n_tiles > 0) {
    wide_partial_kernel<T, Tail><<<s->n_tiles, kThreads, plan_bytes, stream>>>(
        s->widx, wval, s->wscale, d_len, s->plan, n_blocks, tc, v_new,
        partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++launches;
  }
  if (s->s_len > 0) {
    const int chunk_rows = (kThreads / tc) * kWideIters;
    full_narrow_kernel<T, Tail>
        <<<(s->s_len + kThreads - 1) / kThreads, kThreads, plan_bytes,
           stream>>>(s->idx, val, s->scale, s->w, s->s_len, s->fold, partial,
                     d_len, s->plan, n_blocks, chunk_rows, v_new, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++launches;
  }
  s->launches = launches;
  return cudaSuccess;
}

// coefficient storage codes the wrapper passes (kernels/structured_full_pdhg_step.py)
enum CoefType { kF32 = 0, kBF16 = 1, kI8 = 2 };

}  // namespace

extern "C" {

// (x_new [n], kx [m]) for the row side ``side`` (plan rows of 4) in one
// cooperative launch (``variant`` 1) or the tail launch and the
// cooperative launch (2); partial [side->n_chunks, side->d] f32 scratch.
int structured_full_forward_step(FullSide* side, const float* x,
                                 const float* c, const float* l,
                                 const float* u, const float* kty,
                                 const float* tau, float* partial,
                                 float* x_new, float* kx, int n, int variant,
                                 void* stream) {
  side->launches = 0;
  const PrimalTail tail{x, c, l, u, kty, tau, 0.0f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (side->coef) {
    case kF32:
      return forward_coop<float>(side, tail, partial, x_new, kx, n, variant,
                                 st);
    case kBF16:
      return forward_coop<__nv_bfloat16>(side, tail, partial, x_new, kx, n,
                                         variant, st);
    case kI8:
      return forward_coop<int8_t>(side, tail, partial, x_new, kx, n, variant,
                                  st);
    default:
      return cudaErrorInvalidValue;
  }
}

// (y_new [m], kty [n]) for the column side ``side`` (plan rows of 3) in
// three launches; partial [side->n_chunks, side->d] f32 scratch.
int structured_full_backward_step(FullSide* side, const float* y,
                                  const float* q, const uint8_t* ineq_mask,
                                  const float* kx_new, const float* kx_prev,
                                  const float* sigma, float* partial,
                                  float* y_new, float* kty, int m,
                                  void* stream) {
  side->launches = 0;
  const DualTail tail{y, q, ineq_mask, kx_new, kx_prev, sigma, 0.0f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (side->coef) {
    case kF32:
      return half_step<float>(side, tail, partial, y_new, kty, m, st);
    case kBF16:
      return half_step<__nv_bfloat16>(side, tail, partial, y_new, kty, m, st);
    case kI8:
      return half_step<int8_t>(side, tail, partial, y_new, kty, m, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* structured_full_pdhg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

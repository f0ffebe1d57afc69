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
// Both half-steps are one persistent cooperative kernel each
// (cudaLaunchCooperativeKernel, at most the blocks that fit on the card at
// once; full_forward_coop_kernel and full_backward_coop_kernel, one body),
// their phases separated by grid.sync():
//  1. the tail for every vector entry into v_new (grid-stride).  The
//     reduces gather v_new at arbitrary indices, so it is stored once and
//     gathered (recomputing it at each gathered index costs five L2 reads
//     per stored entry in place of one);
//  2. one work list: the plan's wide tiles, then the narrow segments in
//     items of 128; blocks take items round-robin.
//     * The wide pass is ragged and lopsided: at 20,000 demands the 2,687
//       row-bucket columns run from 8,040 entries deep down to 48, and the
//       Gavel full LP's row bucket has 3 columns 16,384 deep.  So the bucket
//       is cut into tiles of TC consecutive columns by CHUNK rows, TC a power
//       of two up to 32 chosen from the plan's block width: the TC threads
//       of a row group read consecutive addresses of one nnz-major row
//       (coalesced), and the 256/TC row groups of a block split the chunk's
//       rows, each thread loading all 16 rows of its share ahead of their
//       gathers.  A tile stops at its plan block's width wb, never at the
//       stored depth (at 20,000 demands the row plan covers 2.38 M of the
//       21.6 M stored elements).  The plan arrives as a small device int32
//       array of (c0, c1, wb, first tile) rows, copied to shared memory.  A
//       bucket that no segment folds onto (the TE column side's [8, 1])
//       launches no tile: the wrapper sets n_tiles to 0.
//     * A narrow item splits each segment's W entries over the block's 8
//       warps (warp g takes w = g, g+8, ...; each lane 4 consecutive
//       segments, read with 16-byte loads where the layout is aligned) and
//       adds the 8 warp sums in warp order: 8x the threads of
//       one-per-segment.  The backward kernel's lanes stop at their group's
//       stored width (gw, below) instead of W;
//  3. each wide segment (fold < D) adds its tiles' partial sums in chunk
//     order onto the narrow sum phase 2 stored; skipped, with its
//     grid.sync, when there is no tile.
//  Deterministic, no atomics: a tile's row groups and an item's warps are
//  summed in a fixed order in shared memory.
//
// Stored width (backward).  The column side at 20,000 demands is [56,
// 80,000] with 1.75 M stored entries in 4.48 M slots (39%): column widths
// run from 1 to 49 and W rounds up to 56.  The wrapper computes gw[g], the
// largest stored width of segments [4g, 4g + 4) (the position of the last
// nonzero coefficient, plus one), once per operator, and a lane's loop over
// w ends there: the group covers 43% of the slots, so the item reads ~15.5
// MB of the ~35.8 MB every padded slot would cost.  Every slot past a
// segment's count is padding (the packer front-packs), and a stored 0
// coefficient left out adds exactly 0 for a finite y_new (a NaN at y_new[0]
// no longer reaches the segments whose padding is skipped; the plain
// version computes 0*NaN; ROADMAP section 3).  The forward kernel still
// reads every W.
//
//  Forward variants: 1 runs all three phases in one launch; 2 launches the
//  tail kernel, then the cooperative kernel from phase 2 (one grid.sync
//  less).  Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 at
//  700 W (PERF.md): staging the wide tiles' indices through a cp.async ring
//  in shared memory took 0.033 ms a call against 0.021 ms loading them into
//  registers (the ring's 16 KB a block took L1 from the gathers of x_new),
//  so there is no ring.  Variant 2 ran up to 1.2 us faster on the device
//  but costs the host one launch more, and the host sets the pace of the
//  solve loop, so the wrapper takes variant 1.
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
  const int32_t* plan;   // [n_blocks, 4]
  const int32_t* gw;     // [ceil(s_len / 4)]: each 4-segment group's width
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
// most plan rows the kernels copy to shared memory
constexpr int kMaxPlanBlocks = 4010;
// narrow items: 8 warps split a segment's W entries, each lane 4 segments
constexpr int kNarrowWarps = kThreads / 32;
constexpr int kRowsPerLane = 4;
constexpr int kNarrowRows = 32 * kRowsPerLane;
// a wide segment's partials loaded ahead of their in-order sum
constexpr int kFoldBatch = 16;
// the cooperative kernels' dynamic shared memory: the plan with its first
// tiles (16 B a row), beside their static 4 KB of sums
constexpr int kCoopSmemMax = 4 * sizeof(int32_t) * kMaxPlanBlocks;
// blocks of a cooperative kernel an SM should hold (caps its registers:
// 40 forward; the backward kernel spilled at 40, and 5 blocks an SM still
// hold every narrow item of the traffic shape's column side at once; 4 ran
// slower, 6 no faster, PERF.md)
constexpr int kCoopBlocksPerSM = 6;
constexpr int kCoopBackwardBlocksPerSM = 5;
static_assert(kCoopSmemMax + sizeof(float) * kNarrowWarps * kNarrowRows
                  <= 227 * 1024,
              "the cooperative kernels' shared memory exceeds 227 KB");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// The forward variant 2's first launch: the tail for every vector entry,
// stored to v_new.
template <class Tail>
__global__ void __launch_bounds__(kThreads)
full_tail_kernel(Tail tail, int v_len, float* __restrict__ v_new) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < v_len) v_new[i] = tail.lane(0, v_len)(i);
}

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

// one wide tile: TC consecutive columns of one plan block by one chunk of
// rows below the block's width; its partial sum of each column
template <class T>
__device__ __forceinline__ void coop_wide_tile(
    const FullSide& s, int item, const int32_t* splan, float* sred,
    const float* v_new, float* partial) {
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
      acc = fmaf(__fmul_rn(v[g], sc), v_new[id[g]], acc);
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

// one narrow item: segments [128 item, 128 item + 128), their sums stored
// to out; with kGroupWidth each lane stops at its 4 segments' stored width
template <class T, bool kGroupWidth>
__device__ __forceinline__ void coop_narrow_item(
    const FullSide& s, int item, float* sred, const float* v_new,
    float* out) {
  const T* val = static_cast<const T*>(s.val);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = s.s_len;
  const int i0 = item * kNarrowRows + lane * kRowsPerLane;
  const float sc = s.scale != nullptr ? *s.scale : 1.0f;
  float acc[kRowsPerLane] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool vec = s.vec && i0 + kRowsPerLane <= S;
  const int w_end = !kGroupWidth ? s.w
                    : i0 < S ? s.gw[i0 / kRowsPerLane] : 0;
#pragma unroll 4
  for (int w = warp; w < w_end; w += kNarrowWarps) {
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
      acc[r] = fmaf(__fmul_rn(v[r], sc), v_new[id[r]], acc[r]);
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

// The three phases of either half-step (see the note at the top).  v_new,
// out and partial are written and read inside the launch, so they are
// plain (never read-only-cache) pointers.
template <class T, class Tail, bool kGroupWidth>
__device__ __forceinline__ void coop_half_step(
    const FullSide& s, const Tail& tail, int v_len, int do_tail,
    float* v_new, float* out, float* partial, int32_t* splan, float* sred) {
  cg::grid_group grid = cg::this_grid();
  for (int k = threadIdx.x; k < 4 * s.n_blocks; k += kThreads)
    splan[k] = s.plan[k];
  __syncthreads();
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kThreads;

  // 1. the tail
  if (do_tail) {
    const Tail t = tail.lane(0, v_len);
    for (int64_t i = gtid; i < v_len; i += gstride) v_new[i] = t(i);
    grid.sync();
  }

  // 2. the wide tiles, then the narrow items
  const int n_items = s.n_tiles + (s.s_len + kNarrowRows - 1) / kNarrowRows;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    if (item < s.n_tiles)
      coop_wide_tile<T>(s, item, splan, sred, v_new, partial);
    else
      coop_narrow_item<T, kGroupWidth>(s, item - s.n_tiles, sred, v_new,
                                       out);
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

// (Tail names the instance, so a profile tells the two half-steps apart.)
template <class T, class Tail>
__global__ void __launch_bounds__(kThreads, kCoopBlocksPerSM)
full_forward_coop_kernel(FullSide s, Tail tail, int v_len, int do_tail,
                         float* x_new, float* out, float* partial) {
  extern __shared__ int32_t csmem[];  // the plan, [n_blocks, 4]
  __shared__ float sred[kNarrowWarps * kNarrowRows];
  coop_half_step<T, Tail, false>(s, tail, v_len, do_tail, x_new, out,
                                 partial, csmem, sred);
}

template <class T, class Tail>
__global__ void __launch_bounds__(kThreads, kCoopBackwardBlocksPerSM)
full_backward_coop_kernel(FullSide s, Tail tail, int v_len, int do_tail,
                          float* y_new, float* out, float* partial) {
  extern __shared__ int32_t csmem[];  // the plan, [n_blocks, 4]
  __shared__ float sred[kNarrowWarps * kNarrowRows];
  coop_half_step<T, Tail, true>(s, tail, v_len, do_tail, y_new, out,
                                partial, csmem, sred);
}

// the cooperative grid of ``kernel``: its co-resident blocks at ``smem``
// bytes of dynamic shared memory, found (and the kernel opted into
// kCoopSmemMax) once per device, kernel and size.  Each kernel has its own
// registers, so its own entry.
cudaError_t coop_grid(const void* kernel, size_t smem, int* grid) {
  struct Entry { const void* kernel; int dev; size_t smem; int blocks; };
  static Entry cache[32];
  static int n_cached = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int e = 0; e < n_cached; ++e) {
    if (cache[e].kernel == kernel && cache[e].dev == dev &&
        cache[e].smem == smem) {
      *grid = cache[e].blocks;
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kCoopSmemMax);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = per_sm * sms;
  if (n_cached < 32) cache[n_cached++] = Entry{kernel, dev, smem, *grid};
  return cudaSuccess;
}

// one cooperative launch of ``kernel`` (phase 1 only with ``do_tail``),
// its launches added to s->launches
template <class Tail>
int coop_launch(const void* kernel, FullSide* s, Tail tail, float* partial,
                float* v_new, float* out, int v_len, int do_tail,
                cudaStream_t stream) {
  const size_t smem = 4 * sizeof(int32_t) * s->n_blocks;
  int grid = 0;
  cudaError_t err = coop_grid(kernel, smem, &grid);
  if (err != cudaSuccess) return err;
  // no more blocks than the largest phase has work for
  const int64_t per = kThreads;
  int64_t work = s->n_tiles + (s->s_len + kNarrowRows - 1) / kNarrowRows;
  work = work > (s->s_len + per - 1) / per ? work : (s->s_len + per - 1) / per;
  if (do_tail)
    work = work > (v_len + per - 1) / per ? work : (v_len + per - 1) / per;
  if (work < 1) work = 1;
  if (grid > work) grid = static_cast<int>(work);
  FullSide sv = *s;
  void* args[] = {&sv, &tail, &v_len, &do_tail, &v_new, &out, &partial};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                    smem, stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  if (err != cudaSuccess) return err;
  if (last == cudaSuccess) s->launches += 1;
  return last;
}

bool side_ok(const FullSide* s) {
  return s->tc >= 1 && s->tc <= 32 && kThreads % s->tc == 0 &&
         s->n_blocks >= 1 && s->n_blocks <= kMaxPlanBlocks;
}

// variant 1: one cooperative launch; variant 2: the tail kernel, then the
// cooperative kernel from phase 2
template <class T>
int forward_coop(FullSide* s, PrimalTail tail, float* partial, float* x_new,
                 float* out, int v_len, int variant, cudaStream_t stream) {
  s->launches = 0;
  if (!side_ok(s) || (variant != 1 && variant != 2))
    return cudaErrorInvalidValue;
  if (variant == 2 && v_len > 0) {
    full_tail_kernel<PrimalTail>
        <<<(v_len + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
            tail, v_len, x_new);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    s->launches = 1;
  }
  return coop_launch(
      reinterpret_cast<const void*>(full_forward_coop_kernel<T, PrimalTail>),
      s, tail, partial, x_new, out, v_len, variant == 1, stream);
}

template <class T>
int backward_coop(FullSide* s, DualTail tail, float* partial, float* y_new,
                  float* out, int v_len, cudaStream_t stream) {
  s->launches = 0;
  if (!side_ok(s) || (s->s_len > 0 && s->gw == nullptr))
    return cudaErrorInvalidValue;
  return coop_launch(
      reinterpret_cast<const void*>(full_backward_coop_kernel<T, DualTail>),
      s, tail, partial, y_new, out, v_len, 1, stream);
}

// coefficient storage codes the wrapper passes (kernels/structured_full_pdhg_step.py)
enum CoefType { kF32 = 0, kBF16 = 1, kI8 = 2 };

}  // namespace

extern "C" {

// (x_new [n], kx [m]) for the row side ``side`` in one cooperative launch
// (``variant`` 1) or the tail launch and the cooperative launch (2);
// partial [side->n_chunks, side->d] f32 scratch.
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

// (y_new [m], kty [n]) for the column side ``side`` (its group widths set)
// in one cooperative launch; partial [side->n_chunks, side->d] f32 scratch.
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
      return backward_coop<float>(side, tail, partial, y_new, kty, m, st);
    case kBF16:
      return backward_coop<__nv_bfloat16>(side, tail, partial, y_new, kty, m,
                                          st);
    case kI8:
      return backward_coop<int8_t>(side, tail, partial, y_new, kty, m, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* structured_full_pdhg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

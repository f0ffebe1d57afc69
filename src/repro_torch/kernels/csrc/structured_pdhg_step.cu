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
// so launches and their latency, not bandwidth, set the pace (chip_smoke.py
// prints the bound beside the measured times).
//
// The wrapper checks an operator side once and hands its pointers and
// sizes over as one LaneSide struct; the C functions write the number of
// CUDA launches they made into it.
//
// Each half-step is one launch of one body (lane_step) over the side's
// V-entry vector and its S segments: primal_lane_kernel (forward, V = N
// columns of x_new, S = M rows of kx) and dual_lane_kernel (backward, V =
// M rows of y_new, S = N columns of kty).  C blocks per lane, grid (C, k):
//  0. Each thread first loads what needs no tail: the first batch of its
//     first segment's narrow entries and the first rows of its block's
//     first wide column, so their latency hides behind the tail.
//  1. The tail.  A lane whose V entries fit a block's shared memory (every
//     lane of the main path and the traffic sessions; kLocal): each block
//     computes the lane's whole tail into its shared memory (24.6 KB
//     forward, 16.4 KB backward at the main path; the five vectors are
//     read from L2, once per block) and stores its 1/C share to v_new; the
//     blocks never wait for each other.  Forward, a thread reads four
//     entries of each vector in one 16-byte load where the lane's five
//     vectors are aligned alike (PrimalTail::quad; the 0-3 entries before
//     the first aligned one and the 0-3 after the last quad one at a
//     time).  A larger lane: the C blocks form a thread-block cluster
//     (cluster (C, 1, 1), launched with cudaLaunchKernelEx), each computes
//     the tail of its share once and stores it to v_new, and one
//     cluster.sync (its release/acquire) makes the stores visible to the
//     cluster's blocks.
//  2. Each block reduces its 1/C of the lane's S segments over the narrow
//     ELL, gathering v_new[idx] from its shared memory (or, in a cluster,
//     the stored v_new: one read per stored entry in place of the five a
//     recomputed tail costs), a batch of entries loaded ahead of its
//     gathers, summed over w in order; the sum goes to out.
//  3. The same block reduces every wide bucket column whose segment it
//     owns, whole, over all the column's rows (the wrapper sorts each
//     lane's real bucket columns by segment once per operator, so a
//     block's columns are one range, found by binary search), and adds
//     the sums onto the segment's narrow sum, in column order, once per
//     segment (columns that share a segment are added by one thread).
//     Padded bucket columns (id 0, value 0) are left out.
//  No atomics, sums in a fixed order: the result is deterministic.
//  Measured on an NVIDIA H100 80GB HBM3 at 700 W at the main-path shape
//  (PERF.md): one cluster per lane took 6.6 us a call backward whether it
//  gathered the tail from its owners' shared memory through distributed
//  shared memory (three cluster barriers) or gathered the stored y_new
//  (one barrier); the shared-memory instance, with no barrier between
//  blocks, took less.  Hence that instance for the lanes that fit, the
//  cluster for those that do not.  Forward, the block's tail of N = 6,145
//  columns sets the pace: one 4-byte load a vector and entry took 11.0 us
//  a call, 16-byte loads with the bucket rows loaded ahead 6.8 (loading
//  2 or 3 quads before storing any, or 768 or 1,024 threads a block, did
//  not help).
//  * No wgmma, no TMA: the work is a few MB of gathers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pdhg_tails.cuh"

namespace cg = cooperative_groups;

// one ELL side of the stacked operator, packed by the wrapper once per
// operator (kernels/structured_pdhg_step.py: LaneSide, the same layout)
struct LaneSide {
  const int32_t* idx;   // [k, w, s_len]
  const float* val;     // [k, w, s_len]
  const int32_t* widx;  // [k, ww, d]
  const float* wval;    // [k, ww, d]
  const int32_t* wids;   // [k, d]
  const int32_t* wsort;  // [k, d]: bucket columns by segment, padding last
  const int32_t* nreal;  // [k]: bucket columns that are not padding
  int32_t k, v_len, s_len, w, ww, d;
  int32_t launches;  // written by the C functions: CUDA launches made
};

namespace {

using pdhg::DualTail;
using pdhg::PrimalTail;

constexpr int kClusterThreads = 512;
// narrow entries of a segment loaded ahead of their gathers
constexpr int kGatherBatch = 8;
// rows of a block's first wide column a thread loads ahead of the tail
// (forward: 16, so the main path's tile of 3 bucket rows, 2,048 deep, is
// loaded whole before the tail)
template <class Tail>
constexpr int kWideAhead = 4;
template <>
constexpr int kWideAhead<PrimalTail> = 16;
// dynamic shared memory a block may hold: a lane's whole tail, beside the
// static row-group sums, within the 227 KB of an SM
constexpr int kLaneSmemBytes = 227 * 1024 - 4 * kClusterThreads;
constexpr int kMaxCluster = 16;

// One half-step of one block: see the note at the top.  v_new is read
// after other blocks of the cluster wrote it, so it is a plain (never
// read-only-cache) pointer; sv is the lane's tail in shared memory
// (kLocal), sred the row-group sums.
template <bool kLocal, class Tail>
__device__ __forceinline__ void lane_step(const LaneSide& s, const Tail& tail,
                                          float* v_new, float* out,
                                          float* sv, float* sred) {
  const int C = gridDim.x;  // the blocks of a lane (a cluster if !kLocal)
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int V = s.v_len, S = s.s_len, D = s.d;
  const int SC = (S + C - 1) / C;
  const int s0 = r * SC;
  const int s1 = min(S, s0 + SC);
  const int64_t nbase = (int64_t)b * s.w * S;

  // the wide bucket columns whose segment lies in [s0, s1): the range
  // [first, last) of the lane's columns sorted by segment
  const int32_t* ws = s.wsort + (int64_t)b * D;
  const int32_t* wid = s.wids + (int64_t)b * D;
  int first = 0, last = 0;
  if (D > 0) {
    const int nreal = s.nreal[b];
    int lo = 0, hi = nreal;  // the first column whose segment is >= s0
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (wid[ws[mid]] < s0) lo = mid + 1; else hi = mid;
    }
    first = lo;
    hi = nreal;  // the first column whose segment is >= s1
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (wid[ws[mid]] < s1) lo = mid + 1; else hi = mid;
    }
    last = lo;
  }
  int tc = 1;  // columns a wide tile: the block's count up to a power of 2
  while (tc < last - first && tc < 32) tc <<= 1;
  const int groups = kClusterThreads / tc;
  const int tx = threadIdx.x % tc;
  const int ty = threadIdx.x / tc;
  const int64_t wbase = (int64_t)b * s.ww * D;

  // 0. the loads that need no tail, issued ahead of it: the first batch of
  // this thread's first segment and the first rows of its first column
  auto load_batch = [&](int i, int w0, int32_t* j, float* v) {
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      const bool in = i < s1 && w0 + u < s.w;
      const int64_t e = nbase + (int64_t)(w0 + u) * S + i;
      j[u] = in ? __ldg(s.idx + e) : 0;
      v[u] = in ? __ldg(s.val + e) : 0.0f;
    }
  };
  int32_t pj[kGatherBatch];
  float pv[kGatherBatch];
  load_batch(s0 + threadIdx.x, 0, pj, pv);
  const bool wlive = first + tx < last;
  const int d_first = wlive ? ws[first + tx] : 0;
  int32_t qj[kWideAhead<Tail>];
  float qv[kWideAhead<Tail>];
#pragma unroll
  for (int u = 0; u < kWideAhead<Tail>; ++u) {
    const int w = ty + u * groups;
    const bool in = wlive && w < s.ww;
    const int64_t e = wbase + (int64_t)w * D + d_first;
    qj[u] = in ? __ldg(s.widx + e) : 0;
    qv[u] = in ? __ldg(s.wval + e) : 0.0f;
  }

  // 1. the tail: this block's share of the entries stored to v_new; with
  // kLocal every entry into shared memory too, else a cluster barrier
  const Tail t = tail.lane(b, V);
  float* vl = v_new + (int64_t)b * V;
  const int R = (V + C - 1) / C;
  const int r0 = r * R;
  const int r1 = min(V, r0 + R);
  if (kLocal) {
    // the forward tail: entries [h, h + 4 nq) four at a time from 16-byte
    // loads, the at most 3 + 3 around them one at a time
    int h = 0, nq = 0;
    if constexpr (std::is_same<Tail, PrimalTail>::value) {
      h = t.quad_start();
      nq = h < 0 || h > V ? 0 : (V - h) >> 2;
      h = nq > 0 ? h : 0;
      for (int q = threadIdx.x; q < nq; q += kClusterThreads) {
        const int i = h + 4 * q;
        float v[4];
        t.quad(i, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sv[i + e] = v[e];
          if (i + e >= r0 && i + e < r1) vl[i + e] = v[e];
        }
      }
    }
#pragma unroll 4
    for (int j = threadIdx.x; j < V - 4 * nq; j += kClusterThreads) {
      const int i = j < h ? j : j + 4 * nq;
      const float v = t(i);
      sv[i] = v;
      if (i >= r0 && i < r1) vl[i] = v;
    }
    __syncthreads();
  } else {
    for (int i = r0 + threadIdx.x; i < r1; i += kClusterThreads) vl[i] = t(i);
    cg::this_cluster().sync();
  }
  auto g = [&](int j) -> float { return kLocal ? sv[j] : vl[j]; };

  // 2. the narrow reduce of segments [s0, s1), summed over w in order,
  // each batch of entries loaded ahead of its gathers
  float* ol = out + (int64_t)b * S;
  for (int i = s0 + threadIdx.x; i < s1; i += kClusterThreads) {
    float acc = 0.0f;
    for (int w0 = 0; w0 < s.w; w0 += kGatherBatch) {
      int32_t j[kGatherBatch];
      float v[kGatherBatch], x[kGatherBatch];
      if (i == s0 + threadIdx.x && w0 == 0) {
#pragma unroll
        for (int u = 0; u < kGatherBatch; ++u) {
          j[u] = pj[u];
          v[u] = pv[u];
        }
      } else {
        load_batch(i, w0, j, v);
      }
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u) x[u] = g(j[u]);
#pragma unroll
      for (int u = 0; u < kGatherBatch; ++u)
        if (w0 + u < s.w) acc = fmaf(v[u], x[u], acc);
    }
    ol[i] = acc;
  }
  if (first == last) return;
  __syncthreads();  // the narrow sums before the wide adds onto them

  // 3. the block's wide columns in tiles of tc columns, the rows split
  // over kClusterThreads / tc groups (the first tile's first rows loaded
  // in 0.); a warp's groups are summed with a fixed butterfly, the warps
  // in order, and the first column of each run of columns with one
  // segment adds the run's sums, in order, onto the segment's narrow sum
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int m0 = first; m0 < last; m0 += tc) {
    const int m = m0 + tx;
    float acc = 0.0f;
    if (m < last) {
      const int d = ws[m];
      int w = ty;
      if (m0 == first) {
#pragma unroll
        for (int u = 0; u < kWideAhead<Tail>; ++u)
          if (ty + u * groups < s.ww) acc = fmaf(qv[u], g(qj[u]), acc);
        w += kWideAhead<Tail> * groups;
      }
#pragma unroll 4
      for (; w < s.ww; w += groups) {
        const int64_t e = wbase + (int64_t)w * D + d;
        acc = fmaf(__ldg(s.wval + e), g(__ldg(s.widx + e)), acc);
      }
    }
    for (int o = 16; o >= tc; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (lane < tc) sred[warp * tc + lane] = acc;
    __syncthreads();
    const bool col = threadIdx.x < tc && m0 + threadIdx.x < last;
    float sum = 0.0f;
    if (col) {
#pragma unroll 8
      for (int w8 = 0; w8 < kClusterThreads / 32; ++w8)
        sum = __fadd_rn(sum, sred[w8 * tc + threadIdx.x]);
    }
    __syncthreads();  // every column summed before sred holds the sums
    if (col) sred[threadIdx.x] = sum;
    __syncthreads();
    if (col) {
      const int n = min(tc, last - m0);
      const int i = wid[ws[m0 + threadIdx.x]];
      if (threadIdx.x == 0 || wid[ws[m0 + threadIdx.x - 1]] != i) {
        float o = ol[i];
        for (int c = threadIdx.x; c < n && wid[ws[m0 + c]] == i; ++c)
          o = __fadd_rn(o, sred[c]);
        ol[i] = o;
      }
    }
    __syncthreads();
  }
}

// The forward half-step: x_new over the N columns, kx over the M rows.
// (Tail names the instance, so a profile tells the two half-steps apart.)
template <bool kLocal, class Tail>
__global__ void __launch_bounds__(kClusterThreads)
primal_lane_kernel(LaneSide s, Tail tail, float* v_new,
                   float* __restrict__ out) {
  extern __shared__ float sv[];  // [V] (kLocal)
  __shared__ float sred[kClusterThreads];
  lane_step<kLocal>(s, tail, v_new, out, sv, sred);
}

// The backward half-step: y_new over the M rows, kty over the N columns.
template <bool kLocal, class Tail>
__global__ void __launch_bounds__(kClusterThreads)
dual_lane_kernel(LaneSide s, Tail tail, float* v_new,
                 float* __restrict__ out) {
  extern __shared__ float sv[];  // [V] (kLocal)
  __shared__ float sred[kClusterThreads];
  lane_step<kLocal>(s, tail, v_new, out, sv, sred);
}

// each half-step's kernel instance
template <bool kLocal>
auto lane_kernel(PrimalTail) {
  return primal_lane_kernel<kLocal, PrimalTail>;
}
template <bool kLocal>
auto lane_kernel(DualTail) { return dual_lane_kernel<kLocal, DualTail>; }

// once per device: a kernel's opt-in (cudaFuncSetAttribute) of ``attr``
template <class Kernel>
cudaError_t opt_in(Kernel kernel, uint64_t* done, cudaFuncAttribute attr,
                   int value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// one launch of ``C`` blocks a lane: each holding the lane's whole tail in
// shared memory (``local``) or a cluster of them over the stored tail
template <class Tail>
int launch_lane(LaneSide* s, Tail tail, float* v_new, float* out, int C,
                bool local, cudaStream_t stream) {
  s->launches = 0;
  if (C < 1 || C > kMaxCluster ||
      (s->d > 0 && (s->wsort == nullptr || s->nreal == nullptr)))
    return cudaErrorInvalidValue;
  if (s->k <= 0 || (s->v_len <= 0 && s->s_len <= 0)) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, s->k, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;
  if (local) {
    static uint64_t opted = 0;
    auto kernel = lane_kernel<true>(tail);
    cfg.dynamicSmemBytes = sizeof(float) * (size_t)s->v_len;
    if (cfg.dynamicSmemBytes > (size_t)kLaneSmemBytes)
      return cudaErrorInvalidValue;
    err = opt_in(kernel, &opted, cudaFuncAttributeMaxDynamicSharedMemorySize,
                 kLaneSmemBytes);
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, *s, tail,
                                                     v_new, out);
  } else {
    static uint64_t opted = 0;
    auto kernel = lane_kernel<false>(tail);
    if (C > 8)  // a non-portable cluster size
      err = opt_in(kernel, &opted,
                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, *s, tail,
                                                     v_new, out);
  }
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  if (err != cudaSuccess) return err;
  if (last == cudaSuccess) s->launches = 1;
  return last;
}

}  // namespace

extern "C" {

// (x_new [k, n], kx [k, m]) for the row side ``side`` (v_len n, s_len m,
// its sorted bucket columns set): ``blocks`` blocks per lane, each holding
// the lane's tail in shared memory (``local``) or a cluster of them.
int structured_forward_step(LaneSide* side, const float* x, const float* c,
                            const float* l, const float* u, const float* kty,
                            const float* tau, float* x_new, float* kx,
                            int blocks, int local, void* stream) {
  const PrimalTail tail{x, c, l, u, kty, tau, 0.0f};
  return launch_lane(side, tail, x_new, kx, blocks, local != 0,
                     static_cast<cudaStream_t>(stream));
}

// (y_new [k, m], kty [k, n]) for the column side ``side`` (v_len m, s_len
// n, its sorted bucket columns set), launched as the forward step is.
int structured_backward_step(LaneSide* side, const float* y, const float* q,
                             const uint8_t* ineq_mask, const float* kx_new,
                             const float* kx_prev, const float* sigma,
                             float* y_new, float* kty, int blocks, int local,
                             void* stream) {
  const DualTail tail{y, q, ineq_mask, kx_new, kx_prev, sigma, 0.0f};
  return launch_lane(side, tail, y_new, kty, blocks, local != 0,
                     static_cast<cudaStream_t>(stream));
}

const char* structured_pdhg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

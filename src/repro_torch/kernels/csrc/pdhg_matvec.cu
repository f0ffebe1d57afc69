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
// What bounds them on this card: bytes.  Each reads A once and does 2 flops
// per element; at the densified main-path stack [8, 4,099, 6,145] A is
// 806 MB in f32 (0.241 ms at 3.35 TB/s) and 403 MB in bf16, far beyond the
// 50 MB L2.  The design, one launch a call for each:
//
//  * A grid of (blocks, k) blocks: each block owns a fixed set of whole
//    rows of one lane, the chunks j, j + B, j + 2B, ... of R rows (B blocks
//    a lane and R from the wrapper's plan, from the shape alone, so the
//    sum order is the same on every call).  bmatvec gives each block one
//    chunk of about 64 KB, handed out by the card in many waves as SMs free
//    up (measured faster than one wave of 2 blocks an SM, whose slowest SM
//    sets the time).  bmatvec_t keeps one wave of kBlocksPerSm blocks on
//    each of 132 SMs, since its blocks' partials are added at the end: one
//    contiguous chunk a block with bf16 A, chunks of about 128 KB with f32
//    A, so that a lane's blocks stream neighbouring rows at a time
//    (measured 1-4% faster in f32, slower in bf16).
//  * The rows of a chunk are one contiguous run of A.  One producer thread
//    copies each run into a ring of kDepth shared-memory stages of
//    kStageBytes with 1-D bulk copies (cp.async.bulk, the TMA), each stage
//    an aligned 16-byte superset of its part of the run, completion on an
//    mbarrier; the eight consumer warps release a stage on a second one.
//    A row may start at any offset (N = 6,145 is odd), a row may span
//    several stages (N = 80,000 f32 is 320 KB) and a stage may hold many
//    rows: consumers read the stage at consecutive addresses whatever the
//    offset, free of bank conflicts.  Two stages of 16 KB measured faster
//    than deeper or wider rings in both types.
//  * Columns are cut into slabs of at most kSlabFloats (one slab up to
//    N = 8,192).  With several slabs each row of the range is streamed
//    slab by slab (runs of one row), so that the slab's vector fits shared
//    memory.
//  * Consumer thread t owns the columns c = t (mod 256) of the slab, so the
//    order of every sum is fixed by the shape, not by where stages fall.
//  * bmatvec stages the lane's slab of x in shared memory; each thread
//    sums its columns of a row in column order, and the block adds the 256
//    sums in a fixed order (a butterfly in each warp, then the warps in
//    order) when the row ends; across slabs the owning block adds the
//    slab sums in slab order.  No atomics.
//  * bmatvec_t keeps the slab's sums in shared memory, each thread adding
//    its columns of each row in row order; each block writes its [N]
//    partials once.  The partials are added in block order, in two levels
//    of about sqrt(B) each: the last block of each group of consecutive
//    blocks adds the group's, the last group the group sums (a ticket per
//    group and per lane, taken after a __threadfence, reset by the block
//    it elects), in the same launch.  Deterministic; the last block of a
//    lane reads about 2 sqrt(B) partials, not B (at k = 1, B = 264, one
//    level took about 65 us more).
//  * bf16 A widens in registers; vectors and sums are f32.  Byte offsets
//    are 64-bit.  No tensor cores: a matrix-vector product cannot use them.
//
// The fused half-steps (fused_pdhg_step.cu) keep their own products in
// dense_pdhg.cuh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mv {

// consumer threads (eight warps) and the block with its producer warp
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;
// the ring: kDepth stages of kStageBytes
constexpr int kDepth = 2;
constexpr int kStageBytes = 16384;
// the widest column slab (x of bmatvec, the partial sums of bmatvec_t)
constexpr int kSlabFloats = 8192;
// blocks resident on one SM: the ring and the slab must fit twice
constexpr int kBlocksPerSm = 2;
// loads of block partials each thread of a lane's last block has in flight
constexpr int kSumBatch = 8;
constexpr int kSmemBytes = kDepth * kStageBytes + kSlabFloats * 4;
static_assert(kBlocksPerSm * (kSmemBytes + 1024 + 256) <= 233472,
              "the ring and the slab must fit kBlocksPerSm blocks an SM");

enum CoefType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// arm the stage's barrier for `bytes` and copy them from global memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the consumer warps alone (the producer warp takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The block's share of one lane: its chunks j, j + blocks, j + 2 blocks,
// ... of chunk_rows rows each (the lane's last chunk may be shorter), in
// that order; column slabs of width sw.
struct Share {
  int j, blocks, chunk_rows, m;
  int n, sw, n_slabs;
  __device__ int chunks() const {
    const int total = (m + chunk_rows - 1) / chunk_rows;
    return j < total ? (total - 1 - j) / blocks + 1 : 0;
  }
  __device__ int64_t lo(int q) const {
    return ((int64_t)q * blocks + j) * chunk_rows;
  }
  __device__ int64_t hi(int q) const { return min64(lo(q) + chunk_rows, m); }
};

__device__ __forceinline__ Share share_of(int m, int n, int blocks,
                                          int chunk_rows) {
  Share s;
  s.j = blockIdx.x;
  s.blocks = blocks;
  s.chunk_rows = chunk_rows;
  s.m = m;
  s.n = n;
  s.n_slabs = n > 0 ? (n + kSlabFloats - 1) / kSlabFloats : 1;
  s.sw = n > 0 ? (n + s.n_slabs - 1) / s.n_slabs : 0;
  return s;
}

// One contiguous run of A: `rows` rows of `width` elements from row row0,
// column n0 (a whole chunk with one slab, a single row's slab with
// several).  Element e of the run is row row0 + e / width, column n0 +
// e % width.  Its stages cover the aligned bytes [base, base + bytes).
struct Run {
  int64_t row0;
  int64_t elems;
  int width, n0;
  int head;  // elements between base and the run's first element
  const char* base;
  int64_t bytes;
  int stages;
};

template <class T>
__device__ __forceinline__ Run run_of(const T* A, const Share& s, int slab,
                                      int64_t row0, int64_t rows) {
  Run r;
  r.n0 = slab * s.sw;
  r.row0 = row0;
  r.width = min(s.n, r.n0 + s.sw) - r.n0;
  r.elems = rows * r.width;
  const int b = blockIdx.y;
  const char* src = reinterpret_cast<const char*>(
      A + ((int64_t)b * s.m + row0) * s.n + r.n0);
  r.base = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(src) &
                                         ~(uintptr_t)15);
  r.head = (int)((src - r.base) / (int)sizeof(T));
  const int64_t end = (int64_t)(src - r.base) + r.elems * (int64_t)sizeof(T);
  r.bytes = (end + 15) & ~(int64_t)15;
  r.stages = r.elems > 0 ? (int)((r.bytes + kStageBytes - 1) / kStageBytes)
                         : 0;
  return r;
}

// f(run) for every run of the share in one slab, in order: a chunk is one
// run with one slab, a run a row with several
template <class T, class F>
__device__ __forceinline__ void for_each_run(const T* A, const Share& s,
                                             int slab, F&& f) {
  for (int q = 0; q < s.chunks(); ++q) {
    if (s.n_slabs == 1) {
      f(run_of(A, s, slab, s.lo(q), s.hi(q) - s.lo(q)));
    } else {
      for (int64_t row = s.lo(q); row < s.hi(q); ++row)
        f(run_of(A, s, slab, row, 1));
    }
  }
}

// The producer: one thread walks every stage of every run, in the
// consumers' order, refilling a slot once all consumer warps released it.
template <class T>
__device__ void produce(const T* A, const Share& s, char* ring,
                        uint64_t* full, uint64_t* empty) {
  int64_t g = 0;
  for (int slab = 0; slab < s.n_slabs; ++slab) {
    for_each_run(A, s, slab, [&](const Run& r) {
      for (int t = 0; t < r.stages; ++t, ++g) {
        const int slot = (int)(g % kDepth);
        if (g >= kDepth)
          bar_wait(&empty[slot], (uint32_t)((g / kDepth - 1) & 1));
        const int64_t off = (int64_t)t * kStageBytes;
        const uint32_t bytes = (uint32_t)min64(kStageBytes, r.bytes - off);
        bulk_load(ring + slot * kStageBytes, r.base + off, bytes, &full[slot]);
      }
    });
  }
}

// The consumers' walk over the same stages.  For each stage, seg(row, c0,
// c1, stage, zero) is called for every row segment in it: row `row` of
// the lane, columns [c0, c1) of the slab, column c at stage[zero + c] in
// shared memory; row_end(row) follows the segment that ends a row.
// slab_begin(slab, n0, width) and slab_end() bracket a slab.
template <class T, class Body>
__device__ __forceinline__ void consume(const T* A, const Share& s,
                                        const char* ring, uint64_t* full,
                                        uint64_t* empty, Body& body) {
  constexpr int kStageElems = kStageBytes / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  int64_t g = 0;
  for (int slab = 0; slab < s.n_slabs; ++slab) {
    body.slab_begin(slab, slab * s.sw,
                    min(s.n, (slab + 1) * s.sw) - slab * s.sw);
    for_each_run(A, s, slab, [&](const Run& r) {
      // the row of the run the walk is in, and its first element
      int64_t rr = 0, row_lo = 0;
      for (int t = 0; t < r.stages; ++t, ++g) {
        const int slot = (int)(g % kDepth);
        bar_wait(&full[slot], (uint32_t)((g / kDepth) & 1));
        const T* stage =
            reinterpret_cast<const T*>(ring + slot * kStageBytes);
        // run elements [e, e_hi) sit in this stage, element e at
        // stage[e - first]
        const int64_t first = (int64_t)t * kStageElems - r.head;
        int64_t e = first > 0 ? first : 0;
        const int64_t e_hi = min64(first + kStageElems, r.elems);
        while (e < e_hi) {
          const int64_t row_hi = row_lo + r.width;
          const int64_t seg_hi = min64(e_hi, row_hi);
          // stage[row_lo - first] is column 0 of this row
          body.seg(r.row0 + rr, (int)(e - row_lo), (int)(seg_hi - row_lo),
                   stage, (int)(row_lo - first));
          if (seg_hi == row_hi) {
            body.row_end(r.row0 + rr);
            ++rr;
            row_lo = row_hi;
          }
          e = seg_hi;
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[slot]);
      }
    });
    body.slab_end();
  }
}

// the first column >= c0 that consumer thread t owns
__device__ __forceinline__ int first_col(int c0) {
  return c0 + ((threadIdx.x - c0) & (kConsumers - 1));
}

// y = A x: the row sums.
template <class T>
struct RowsBody {
  const float* x;  // the lane's x
  float* y;        // the lane's y
  float* xs;       // the slab of x in shared memory
  float* red;      // [2][kConsumerWarps]
  int slab, n0, parity;
  float acc;

  __device__ void slab_begin(int slab_index, int slab_n0, int width) {
    slab = slab_index;
    n0 = slab_n0;
    consumers_sync();  // every thread is done with the previous slab
    for (int i = threadIdx.x; i < width; i += kConsumers)
      xs[i] = __ldg(x + n0 + i);
    consumers_sync();
  }
  __device__ void slab_end() {}

  __device__ __forceinline__ void seg(int64_t, int c0, int c1,
                                      const T* stage, int zero) {
    const T* a = stage + zero;
    int c = first_col(c0);
    for (; c + 3 * kConsumers < c1; c += 4 * kConsumers) {
      T v[4];
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = a[c + u * kConsumers];
        w[u] = xs[c + u * kConsumers];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = fmaf(to_f32(v[u]), w[u], acc);
    }
    for (; c < c1; c += kConsumers) acc = fmaf(to_f32(a[c]), xs[c], acc);
  }

  __device__ void row_end(int64_t row) {
    float v = acc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0)
      red[parity * kConsumerWarps + threadIdx.x / 32] = v;
    consumers_sync();
    if (threadIdx.x == 0) {
      const float* p = red + parity * kConsumerWarps;
      float sum = p[0];
#pragma unroll
      for (int w = 1; w < kConsumerWarps; ++w) sum += p[w];
      y[row] = slab == 0 ? sum : y[row] + sum;
    }
    parity ^= 1;
    acc = 0.0f;
  }
};

// x = A^T y: each thread's columns summed over the rows, in row order.
template <class T>
struct ColsBody {
  const float* w;  // the lane's y
  float* dst;      // this block's [N] partials (or the lane's x)
  float* acc;      // the slab's sums in shared memory
  int n0, width;

  __device__ void slab_begin(int, int slab_n0, int slab_width) {
    n0 = slab_n0;
    width = slab_width;
    for (int c = threadIdx.x; c < width; c += kConsumers) acc[c] = 0.0f;
  }
  __device__ void slab_end() {
    for (int c = threadIdx.x; c < width; c += kConsumers) dst[n0 + c] = acc[c];
  }

  __device__ __forceinline__ void seg(int64_t row, int c0, int c1,
                                      const T* stage, int zero) {
    const T* a = stage + zero;
    const float wv = __ldg(w + row);
    int c = first_col(c0);
    for (; c + 3 * kConsumers < c1; c += 4 * kConsumers) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = a[c + u * kConsumers];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[c + u * kConsumers] =
            fmaf(to_f32(v[u]), wv, acc[c + u * kConsumers]);
    }
    for (; c < c1; c += kConsumers) acc[c] = fmaf(to_f32(a[c]), wv, acc[c]);
  }

  __device__ void row_end(int64_t) {}
};

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDepth; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// y [k, m] = A [k, m, n] x [k, n]; grid (blocks, k), chunks of chunk_rows.
template <class T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
matvec_rows_kernel(const T* __restrict__ A, const float* __restrict__ x,
                   float* __restrict__ y, int m, int n, int blocks,
                   int chunk_rows) {
  extern __shared__ __align__(128) char smem[];
  __shared__ uint64_t full[kDepth], empty[kDepth];
  __shared__ float red[2 * kConsumerWarps];
  const Share s = share_of(m, n, blocks, chunk_rows);
  const int b = blockIdx.y;
  if (n == 0) {  // empty rows: every sum is 0
    for (int q = 0; q < s.chunks(); ++q)
      for (int64_t r = s.lo(q) + threadIdx.x; r < s.hi(q); r += kThreads)
        y[(int64_t)b * m + r] = 0.0f;
    return;
  }
  init_ring(full, empty);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(A, s, smem, full, empty);
    return;
  }
  RowsBody<T> body{x + (int64_t)b * n, y + (int64_t)b * m,
                   reinterpret_cast<float*>(smem + kDepth * kStageBytes), red,
                   0, 0, 0, 0.0f};
  consume(A, s, smem, full, empty, body);
}

// Whether this block is the last of `count` to take the ticket (after
// making its own writes visible); the consumer threads all get the answer.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, int count,
                                               int* flag) {
  __threadfence();
  consumers_sync();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1u) == (unsigned)(count - 1);
  consumers_sync();
  if (*flag) __threadfence();
  return *flag;
}

// Rows src[0], src[stride], ... (count of them, n_pad floats each, 16-byte
// aligned) added in row order, 4 columns a thread with kSumBatch loads in
// flight; written to out [n] or, padded, to pad_out (which may be src[0]:
// each thread reads its columns before it writes them).
__device__ void add_in_order(const float* src, int64_t stride, int count,
                             int n, int n_pad, float* out, float* pad_out) {
  const int q_len = n_pad / 4;
  const int64_t q_stride = stride / 4;
  const float4* p = reinterpret_cast<const float4*>(src);
  for (int q = threadIdx.x; q < q_len; q += kConsumers) {
    float4 sum = __ldcg(p + q);
    int jj = 1;
    for (; jj + kSumBatch <= count; jj += kSumBatch) {
      float4 v[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        v[u] = __ldcg(p + (jj + u) * q_stride + q);
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        sum.x += v[u].x;
        sum.y += v[u].y;
        sum.z += v[u].z;
        sum.w += v[u].w;
      }
    }
    for (; jj < count; ++jj) {
      const float4 v = __ldcg(p + jj * q_stride + q);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (pad_out != nullptr) {
      reinterpret_cast<float4*>(pad_out)[q] = sum;
    } else {
      const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * q + u < n) out[4 * q + u] = vals[u];
    }
  }
}

// x [k, n] = A [k, m, n]^T y [k, m]; grid (blocks, k).  With several blocks a
// lane, part [k, blocks, n_pad] holds each block's partials, and tickets
// [k, 1 + ceil(blocks / group)] (0 at the launch, 0 again at its end)
// elect the last block of each group and of each lane.
template <class T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
matvec_cols_kernel(const T* __restrict__ A, const float* __restrict__ y,
                   float* __restrict__ part, unsigned* __restrict__ tickets,
                   float* __restrict__ x, int m, int n, int n_pad,
                   int blocks, int chunk_rows, int group) {
  extern __shared__ __align__(128) char smem[];
  __shared__ uint64_t full[kDepth], empty[kDepth];
  __shared__ int last;
  const Share s = share_of(m, n, blocks, chunk_rows);
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  init_ring(full, empty);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(A, s, smem, full, empty);
    return;
  }
  float* dst = blocks == 1 ? x + (int64_t)b * n
                           : part + ((int64_t)b * blocks + j) * n_pad;
  ColsBody<T> body{y + (int64_t)b * m, dst,
                   reinterpret_cast<float*>(smem + kDepth * kStageBytes), 0,
                   0};
  consume(A, s, smem, full, empty, body);
  if (blocks == 1) return;
  // The partials are added in block order, in two levels: the last block
  // of each group of `group` consecutive blocks adds the group's partials
  // into the group's first slot, and the last group to finish adds the
  // group sums, in group order, into x.  Each level's last block is the
  // one whose ticket completes it (taken after a __threadfence), and
  // resets the ticket.
  const int n_groups = (blocks + group - 1) / group;
  const int g = j / group;
  const int g_size = min(blocks, (g + 1) * group) - g * group;
  unsigned* lane_tickets = tickets + (int64_t)b * (1 + n_groups);
  float* lane_part = part + (int64_t)b * blocks * n_pad;
  float* group_part = lane_part + (int64_t)g * group * n_pad;
  float* out = x + (int64_t)b * n;
  if (!last_to_arrive(&lane_tickets[1 + g], g_size, &last)) return;
  if (n_groups == 1) {
    add_in_order(group_part, n_pad, g_size, n, n_pad, out, nullptr);
    if (threadIdx.x == 0) lane_tickets[1] = 0u;
    return;
  }
  add_in_order(group_part, n_pad, g_size, n, n_pad, nullptr, group_part);
  if (threadIdx.x == 0) lane_tickets[1 + g] = 0u;
  if (!last_to_arrive(&lane_tickets[0], n_groups, &last)) return;
  add_in_order(lane_part, (int64_t)group * n_pad, n_groups, n, n_pad, out,
               nullptr);
  if (threadIdx.x == 0) lane_tickets[0] = 0u;
}

// The shared-memory attribute, set once per kernel.  (The anonymous
// namespace keeps the flag in this library: a static local of a template
// with external linkage is one symbol across every library loaded, so a
// second build of this source would skip its own call.)
namespace {
template <class K>
int prepare(K kernel) {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}
}  // namespace

// dynamic shared memory of a launch: the ring and one slab
inline int smem_bytes(int n) {
  const int slabs = n > 0 ? (n + kSlabFloats - 1) / kSlabFloats : 1;
  const int sw = n > 0 ? (n + slabs - 1) / slabs : 0;
  return kDepth * kStageBytes + sw * 4;
}

template <class T>
int rows(const T* A, const float* x, float* y, int k, int m, int n,
         int blocks, int chunk_rows, int* launches, cudaStream_t stream) {
  *launches = 0;
  if (k <= 0 || m <= 0) return cudaSuccess;
  if (blocks < 1 || chunk_rows < 1) return cudaErrorInvalidValue;
  int err = prepare(matvec_rows_kernel<T>);
  if (err != cudaSuccess) return err;
  matvec_rows_kernel<T><<<dim3(blocks, k), kThreads, smem_bytes(n), stream>>>(
      A, x, y, m, n, blocks, chunk_rows);
  *launches = 1;
  return cudaGetLastError();
}

template <class T>
int cols(const T* A, const float* y, float* part, unsigned* tickets, float* x,
         int k, int m, int n, int blocks, int chunk_rows, int group,
         int* launches, cudaStream_t stream) {
  *launches = 0;
  if (k <= 0 || n <= 0) return cudaSuccess;
  if (blocks < 1 || chunk_rows < 1 || group < 1) return cudaErrorInvalidValue;
  int err = prepare(matvec_cols_kernel<T>);
  if (err != cudaSuccess) return err;
  const int n_pad = (n + 3) & ~3;
  matvec_cols_kernel<T><<<dim3(blocks, k), kThreads, smem_bytes(n), stream>>>(
      A, y, part, tickets, x, m, n, n_pad, blocks, chunk_rows, group);
  *launches = 1;
  return cudaGetLastError();
}

}  // namespace mv

extern "C" {

// y [k, m] = A [k, m, n] x [k, n]; coef: 0 f32, 1 bf16; `blocks` blocks a
// lane, block j owning the chunks j, j + blocks, ... of chunk_rows rows
// (the wrapper's plan); *launches is set to the CUDA launches made.
int bmatvec(int coef, const void* A, const float* x, float* y, int k, int m,
            int n, int blocks, int chunk_rows, int* launches, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (coef) {
    case mv::kF32:
      return mv::rows(static_cast<const float*>(A), x, y, k, m, n, blocks,
                      chunk_rows, launches, s);
    case mv::kBF16:
      return mv::rows(static_cast<const __nv_bfloat16*>(A), x, y, k, m, n,
                      blocks, chunk_rows, launches, s);
    default:
      *launches = 0;
      return cudaErrorInvalidValue;
  }
}

// x [k, n] = A^T y [k, m], the same plan; part [k, blocks, (n + 3) & ~3]
// f32 scratch and tickets [k, 1 + ceil(blocks / group)] (all 0, left 0)
// when blocks > 1; the partials are added in groups of `group` blocks,
// then the groups.
int bmatvec_t(int coef, const void* A, const float* y, float* part,
              unsigned* tickets, float* x, int k, int m, int n, int blocks,
              int chunk_rows, int group, int* launches, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (coef) {
    case mv::kF32:
      return mv::cols(static_cast<const float*>(A), y, part, tickets, x, k, m,
                      n, blocks, chunk_rows, group, launches, s);
    case mv::kBF16:
      return mv::cols(static_cast<const __nv_bfloat16*>(A), y, part, tickets,
                      x, k, m, n, blocks, chunk_rows, group, launches, s);
    default:
      *launches = 0;
      return cudaErrorInvalidValue;
  }
}

const char* pdhg_matvec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

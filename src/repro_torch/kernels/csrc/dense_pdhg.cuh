// Dense batched products over A [k, M, N] (f32 or bf16 coefficients, f32
// accumulation) of the fused PDHG half-steps (fused_pdhg_step.cu).  The
// plain matvecs stream A their own way (pdhg_matvec.cu).
//
// What bounds them on this card: bytes.  Each product reads A once and does
// 2 flops per element, 0.5 flop per byte in f32, far below the H100's
// ~20 flop/byte f32 balance point; at the densified main-path stack
// [8, 4,099, 6,145] A is 806 MB, 0.241 ms at 3.35 TB/s, and does not fit the
// 50 MB L2.  So every design choice below is about reading A once, in long
// coalesced runs, with enough loads in flight to fill 132 SMs.
//
//  * Rows (A v, reduced over N): one warp per row, 8 rows per 256-thread
//    block, grid (ceil(M/8), k).  A row is read in 16-byte loads (4 f32 or
//    8 bf16): the row's first elements up to a 16-byte boundary and its last
//    ragged elements are read one by one (a row of N = 6,145 f32 starts at an
//    arbitrary 4-byte offset), four 16-byte loads per lane are issued before
//    their FMAs.  v is read from global memory: all warps of a block read the
//    same lane of it, so after the first row it comes from L1.  The 32 lane
//    sums are combined by a shuffle tree in a fixed order: deterministic.
//  * Columns (A^T w, reduced over M, A never transposed): one thread per
//    column, 256 columns per block; consecutive threads read consecutive
//    addresses of one row of A (coalesced), eight rows in flight per thread.
//    M is cut into chunks so that a narrow N still gives the card enough
//    blocks (grid (ceil(N/256), chunks, k)); each block stages its chunk of w
//    in shared memory (a broadcast read in the loop), and each writes its
//    partial sums to [k, chunks, N].  A second pass adds the chunks in order,
//    so there are no atomics and the result is deterministic.  With one chunk
//    the block writes the result directly and the second pass is skipped.
//  * Offsets into A are 64-bit: k*M*N is 201.5 M elements at the densified
//    stack and must not wrap on a larger one.
//  * No TMA, no tensor cores (a matrix-vector product cannot use them), no
//    shared-memory staging of A: right and simple first.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dense {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows of A each thread of the column pass has in flight
constexpr int kColUnroll = 8;
// 16-byte loads each lane of the row pass issues before their FMAs
constexpr int kRowUnroll = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the 16 bytes of one vector load as f32 values
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

// out[b, m] = sum_n A[b, m, n] * v[b, n]: one warp per row.  (Tail only
// names the instance in a profile.)
template <class T, class Tail>
__global__ void __launch_bounds__(kThreads)
dense_rows_kernel(const T* __restrict__ A, const float* __restrict__ v,
                  int m_len, int n_len, float* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= m_len) return;  // the same for the whole warp
  const T* a = A + ((int64_t)b * m_len + row) * n_len;
  const float* x = v + (int64_t)b * n_len;
  // elements before this row's first 16-byte boundary (fewer than kVec)
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(a) & 15)) & 15) /
                   sizeof(T));
  if (head > n_len) head = n_len;
  float acc = 0.0f;
  if (lane < head) acc = fmaf(to_f32(a[lane]), __ldg(x + lane), acc);
  const int n_vec = (n_len - head) / kVec;
  const uint4* av = reinterpret_cast<const uint4*>(a + head);
  const float* xv = x + head;
  int i = lane;
  for (; i + (kRowUnroll - 1) * 32 < n_vec; i += kRowUnroll * 32) {
    uint4 raw[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) raw[u] = __ldg(av + i + u * 32);
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      float f[kVec];
      unpack(raw[u], f);
      const float* xi = xv + (int64_t)(i + u * 32) * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc = fmaf(f[e], __ldg(xi + e), acc);
    }
  }
  for (; i < n_vec; i += 32) {
    float f[kVec];
    unpack(__ldg(av + i), f);
    const float* xi = xv + (int64_t)i * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc = fmaf(f[e], __ldg(xi + e), acc);
  }
  for (int n = head + n_vec * kVec + lane; n < n_len; n += 32)
    acc = fmaf(to_f32(a[n]), __ldg(x + n), acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) out[(int64_t)b * m_len + row] = acc;
}

// dst[b, chunk, n] = sum over the chunk's rows m of A[b, m, n] * w(m), where
// w is the lane's row vector, the dual tail (DualTail), staged once per
// block in shared memory.  With v_new non-null, the blocks of
// the first column tile also store w to v_new (each row exactly once).
template <class T, class Src>
__global__ void __launch_bounds__(kThreads)
dense_cols_kernel(const T* __restrict__ A, Src src, int m_len, int n_len,
                  int chunk_rows, float* __restrict__ v_new,
                  float* __restrict__ dst) {
  extern __shared__ float ws[];
  const int b = blockIdx.z;
  const int chunk = blockIdx.y;
  const int m0 = chunk * chunk_rows;
  const int rows = min(m_len, m0 + chunk_rows) - m0;
  const Src w = src.lane(b, m_len);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const float val = w(m0 + i);
    ws[i] = val;
    if (v_new != nullptr && blockIdx.x == 0)
      v_new[(int64_t)b * m_len + m0 + i] = val;
  }
  __syncthreads();
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_len) return;
  const T* a = A + ((int64_t)b * m_len + m0) * n_len + n;
  float acc = 0.0f;
  int m = 0;
  for (; m + kColUnroll <= rows; m += kColUnroll) {
    T r[kColUnroll];
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u) r[u] = a[(int64_t)(m + u) * n_len];
#pragma unroll
    for (int u = 0; u < kColUnroll; ++u)
      acc = fmaf(to_f32(r[u]), ws[m + u], acc);
  }
  for (; m < rows; ++m) acc = fmaf(to_f32(a[(int64_t)m * n_len]), ws[m], acc);
  dst[((int64_t)b * gridDim.y + chunk) * n_len + n] = acc;
}

// out[b, n] = sum over chunks c, in order, of part[b, c, n].  (Tail names
// the instance.)
template <class Tail>
__global__ void __launch_bounds__(kThreads)
dense_chunk_sum_kernel(const float* __restrict__ part, int n_chunks,
                       int n_len, float* __restrict__ out) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_len) return;
  const float* p = part + (int64_t)b * n_chunks * n_len + n;
  float acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c) acc = __fadd_rn(acc, p[(int64_t)c * n_len]);
  out[(int64_t)b * n_len + n] = acc;
}

// v_new[b, i] = tail(b, i) for every entry of every lane.
template <class Tail>
__global__ void __launch_bounds__(kThreads)
dense_tail_kernel(Tail tail, int v_len, float* __restrict__ v_new) {
  const int b = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < v_len) v_new[(int64_t)b * v_len + i] = tail.lane(b, v_len)(i);
}

inline int blocks_for(int64_t n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// out = A v over every lane; one launch.
template <class T, class Tail>
int rows_product(const T* A, const float* v, float* out, int k, int m, int n,
                 cudaStream_t stream) {
  if (k <= 0 || m <= 0) return cudaSuccess;
  const dim3 grid((m + kWarps - 1) / kWarps, k);
  dense_rows_kernel<T, Tail><<<grid, kThreads, 0, stream>>>(A, v, m, n, out);
  return cudaGetLastError();
}

// out = A^T w over every lane, the chunk partials in part [k, n_chunks, n]
// when n_chunks > 1; one launch, or two with chunks.
template <class T, class Src, class Tail>
int cols_product(const T* A, Src w, float* v_new, float* part, float* out,
                 int k, int m, int n, int chunk_rows, int n_chunks,
                 cudaStream_t stream) {
  if (k <= 0 || n <= 0) {
    if (k > 0 && v_new != nullptr && m > 0) {
      // no column to reduce, but the row vector is still an output
      dense_tail_kernel<Src><<<dim3(blocks_for(m), k), kThreads, 0, stream>>>(
          w, m, v_new);
      return cudaGetLastError();
    }
    return cudaSuccess;
  }
  if (n_chunks < 1 || chunk_rows < 0 || (int64_t)chunk_rows * n_chunks < m ||
      (m > 0 && (int64_t)chunk_rows * (n_chunks - 1) >= m) ||
      chunk_rows * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
  float* dst = n_chunks > 1 ? part : out;
  const dim3 grid(blocks_for(n), n_chunks, k);
  dense_cols_kernel<T, Src><<<grid, kThreads, chunk_rows * sizeof(float),
                              stream>>>(A, w, m, n, chunk_rows, v_new, dst);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  dense_chunk_sum_kernel<Tail><<<dim3(blocks_for(n), k), kThreads, 0,
                                 stream>>>(part, n_chunks, n, out);
  return cudaGetLastError();
}

// coefficient storage codes the wrappers pass (kernels/pdhg_matvec.py's
// COEF)
enum CoefType { kF32 = 0, kBF16 = 1 };

}  // namespace dense

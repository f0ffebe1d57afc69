// The element-wise PDHG half-step tails, shared by the lane kernels
// (structured_pdhg_step.cu) and the full-problem kernels
// (structured_full_pdhg_step.cu).
//
// The tails use round-to-nearest intrinsics (no FMA contraction), so the
// value a kernel stores, and the value the lane kernels recompute at each
// gathered index, is bit-equal to the plain PyTorch version's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pdhg {

// min(max(v, lo), hi), with a NaN in v kept (jnp.clip / torch semantics;
// fmaxf alone would drop it and hide a diverging lane)
__device__ __forceinline__ float clip_keep_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// x_new = clip(x - tau*(c + kty), l, u)
struct PrimalTail {
  const float* x;
  const float* c;
  const float* l;
  const float* u;
  const float* kty;
  const float* tau;  // [k]
  float step;

  __device__ PrimalTail lane(int b, int64_t v_len) const {
    const int64_t o = b * v_len;
    return {x + o, c + o, l + o, u + o, kty + o, tau, tau[b]};
  }
  __device__ __forceinline__ float operator()(int64_t i) const {
    return at(x[i], c[i], l[i], u[i], kty[i]);
  }
  __device__ __forceinline__ float at(float xi, float ci, float li, float ui,
                                      float ki) const {
    const float g = __fadd_rn(ci, ki);
    return clip_keep_nan(__fsub_rn(xi, __fmul_rn(step, g)), li, ui);
  }
  // The first entry from which the five vectors are all 16-byte aligned
  // (0..3), or -1 where they are not aligned alike.
  __device__ int quad_start() const {
    const uintptr_t a = reinterpret_cast<uintptr_t>(x);
    const uintptr_t apart = (a ^ reinterpret_cast<uintptr_t>(c)) |
                            (a ^ reinterpret_cast<uintptr_t>(l)) |
                            (a ^ reinterpret_cast<uintptr_t>(u)) |
                            (a ^ reinterpret_cast<uintptr_t>(kty));
    if ((apart & 15) || (a & 3)) return -1;
    return (int)(((16 - (a & 15)) & 15) >> 2);
  }
  // entries [i, i + 4) from one 16-byte load of each vector (i from
  // quad_start() on, in steps of 4)
  __device__ __forceinline__ void quad(int64_t i, float* v) const {
    const float4 xv = *reinterpret_cast<const float4*>(x + i);
    const float4 cv = *reinterpret_cast<const float4*>(c + i);
    const float4 lv = *reinterpret_cast<const float4*>(l + i);
    const float4 uv = *reinterpret_cast<const float4*>(u + i);
    const float4 kv = *reinterpret_cast<const float4*>(kty + i);
    v[0] = at(xv.x, cv.x, lv.x, uv.x, kv.x);
    v[1] = at(xv.y, cv.y, lv.y, uv.y, kv.y);
    v[2] = at(xv.z, cv.z, lv.z, uv.z, kv.z);
    v[3] = at(xv.w, cv.w, lv.w, uv.w, kv.w);
  }
};

// y_new = y + sigma*(2 kx_new - kx_prev - q), then >= 0 on ineq_mask rows
struct DualTail {
  const float* y;
  const float* q;
  const uint8_t* mask;
  const float* kx_new;
  const float* kx_prev;
  const float* sigma;  // [k]
  float step;

  __device__ DualTail lane(int b, int64_t v_len) const {
    const int64_t o = b * v_len;
    return {y + o, q + o, mask + o, kx_new + o, kx_prev + o, sigma, sigma[b]};
  }
  __device__ __forceinline__ float operator()(int64_t i) const {
    const float r = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, kx_new[i]), kx_prev[i]),
                              q[i]);
    const float v = __fadd_rn(y[i], __fmul_rn(step, r));
    return (mask[i] && v < 0.0f) ? 0.0f : v;
  }
};

}  // namespace pdhg

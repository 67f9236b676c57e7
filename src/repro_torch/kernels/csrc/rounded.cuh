// What the allocator's kernels share (pdhg_update.cu, tree_matvec.cu): the
// round-to-nearest arithmetic they keep the plain versions' bits with, and
// the primal prox of one device, so that primal_update and the fused
// primal_step compute it with the same operations in the same order.
#pragma once

#include <cuda_runtime.h>

namespace rn {

// Each product, sum and quotient rounded once: the __*_rn intrinsics are
// never contracted into an FMA.
template <typename T>
struct Rn;

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

// clip(v, lo, hi) = min(max(v, lo), hi), as jnp.clip and torch.clamp take it
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  const T a = v < lo ? lo : v;
  return a > hi ? hi : a;
}

// The primal prox (diagonal quadratic + box) and extrapolation of one
// device, in the plain expression's order:
//   x1 = clip((x - t*(g + c) + (t*w)*target) / (1 + t*w), lo, hi),  xe = 2*x1 - x
template <typename T>
__device__ __forceinline__ void primal_prox(T x, T g, T c, T w, T target, T lo, T hi, T t,
                                            T& x1, T& xe) {
  using R = Rn<T>;
  const T tw = R::mul(t, w);
  const T num = R::add(R::sub(x, R::mul(t, R::add(g, c))), R::mul(tw, target));
  x1 = clip(R::div(num, R::add(T(1), tw)), lo, hi);
  xe = R::sub(R::mul(T(2), x1), x);
}

}  // namespace rn

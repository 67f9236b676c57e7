// Fused PDHG updates of the nvPAX solver loop, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pdhg_update/kernel.py:
//   primal_update (_primal_kernel)
//     x1 = clip((x - tau*(gx + c) + tau*w*target) / (1 + tau*w), lo, hi),  xe = 2*x1 - x
//   dual_prox (_dual_kernel)
//     z = y + sigma*a,  out = z - sigma*clip(z/sigma, lo, hi)
//
// What bounds it on this card: memory traffic, and at the paper's fleet
// launch latency.  primal_update streams 8 vectors in and 2 out (0.98 MB in
// float64 at n = 12,288, about 0.3 us at 3.35 TB/s); dual_prox 5 in and 1 out.
//
// Design: one grid-stride elementwise pass each, the ragged edge masked by
// the loop bound, so nothing is padded (the TPU version's tau = 1 and
// +-finfo.max/2 padding lanes were block artefacts).  A step size is a
// vector or one broadcast scalar, read through a stride of 1 or 0.  Bounds
// may be +-inf; the comparisons below keep them exact.  Every product, sum
// and quotient is one IEEE-rounded operation in the plain version's order
// (the __*_rn intrinsics are never contracted into an FMA), so the kernel
// returns bit for bit what the plain PyTorch expression returns.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    primal_update_kernel(const T* __restrict__ x, const T* __restrict__ gx,
                         const T* __restrict__ c, const T* __restrict__ w,
                         const T* __restrict__ target, const T* __restrict__ lo,
                         const T* __restrict__ hi, const T* __restrict__ tau, int64_t tau_stride,
                         int64_t n, T* __restrict__ x1, T* __restrict__ xe) {
  using R = Rn<T>;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
    const T t = tau[i * tau_stride];
    const T xi = x[i];
    const T tw = R::mul(t, w[i]);
    const T num = R::add(R::sub(xi, R::mul(t, R::add(gx[i], c[i]))), R::mul(tw, target[i]));
    const T v = clip(R::div(num, R::add(T(1), tw)), lo[i], hi[i]);
    x1[i] = v;
    xe[i] = R::sub(R::mul(T(2), v), xi);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dual_prox_kernel(const T* __restrict__ y, const T* __restrict__ a,
                     const T* __restrict__ sigma, int64_t sigma_stride,
                     const T* __restrict__ lo, const T* __restrict__ hi, int64_t n,
                     T* __restrict__ out) {
  using R = Rn<T>;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
    const T s = sigma[i * sigma_stride];
    const T z = R::add(y[i], R::mul(s, a[i]));
    out[i] = R::sub(z, R::mul(s, clip(R::div(z, s), lo[i], hi[i])));
  }
}

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <typename T>
int primal_update_impl(int device, const T* x, const T* gx, const T* c, const T* w,
                       const T* target, const T* lo, const T* hi, const T* tau,
                       int64_t tau_stride, int64_t n, T* x1, T* xe, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    primal_update_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(x, gx, c, w, target, lo, hi,
                                                                 tau, tau_stride, n, x1, xe);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dual_prox_impl(int device, const T* y, const T* a, const T* sigma, int64_t sigma_stride,
                   const T* lo, const T* hi, int64_t n, T* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    dual_prox_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(y, a, sigma, sigma_stride, lo, hi,
                                                             n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int primal_update_f64(int device, const double* x, const double* gx, const double* c,
                      const double* w, const double* target, const double* lo, const double* hi,
                      const double* tau, int64_t tau_stride, int64_t n, double* x1, double* xe,
                      void* stream) {
  return primal_update_impl<double>(device, x, gx, c, w, target, lo, hi, tau, tau_stride, n, x1,
                                    xe, static_cast<cudaStream_t>(stream));
}

int primal_update_f32(int device, const float* x, const float* gx, const float* c,
                      const float* w, const float* target, const float* lo, const float* hi,
                      const float* tau, int64_t tau_stride, int64_t n, float* x1, float* xe,
                      void* stream) {
  return primal_update_impl<float>(device, x, gx, c, w, target, lo, hi, tau, tau_stride, n, x1,
                                   xe, static_cast<cudaStream_t>(stream));
}

int dual_prox_f64(int device, const double* y, const double* a, const double* sigma,
                  int64_t sigma_stride, const double* lo, const double* hi, int64_t n,
                  double* out, void* stream) {
  return dual_prox_impl<double>(device, y, a, sigma, sigma_stride, lo, hi, n, out,
                                static_cast<cudaStream_t>(stream));
}

int dual_prox_f32(int device, const float* y, const float* a, const float* sigma,
                  int64_t sigma_stride, const float* lo, const float* hi, int64_t n, float* out,
                  void* stream) {
  return dual_prox_impl<float>(device, y, a, sigma, sigma_stride, lo, hi, n, out,
                               static_cast<cudaStream_t>(stream));
}

// Threads in the largest grid a launch uses: a longer vector makes the
// grid-stride loop take more than one pass.
int64_t elementwise_grid_threads() { return kMaxBlocks * kThreads; }

}  // extern "C"

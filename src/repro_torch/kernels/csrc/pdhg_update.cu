// Fused PDHG updates of the nvPAX solver loop, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/pdhg_update/kernel.py:
//   primal_update (_primal_kernel)
//     x1 = clip((x - tau*(gx + c) + tau*w*target) / (1 + tau*w), lo, hi),  xe = 2*x1 - x
//   dual_prox (_dual_kernel)
//     z = y + sigma*a,  out = z - sigma*clip(z/sigma, lo, hi)
//   primal_chunk_stats (_primal_stats_kernel)   at every KKT check
//     ax + x,  max|x - px|,  max|x|,  sum (x - rx)^2,  sum ((ax + x)/cnt - rx)^2
//   dual_chunk_stats (_dual_stats_kernel)
//     ay + y,  sum (y - ry)^2,  sum ((ay + y)/cnt - ry)^2,  sum ry^2
//
// What bounds it on this card: memory traffic, and at the paper's fleet
// launch latency.  primal_update streams 8 vectors in and 2 out (0.98 MB in
// float64 at n = 12,288, about 0.3 us at 3.35 TB/s); dual_prox 5 in and 1 out.
//
// dual_update is the whole dual step of one PDHG iteration in one launch,
// in place of the launches around dual_prox that fed it: the row scaling of
// the scaled forward operator (core/solver/scaling.py:scaled_matvec)
//   a_tree = d_tree*kx,  a_sla = d_sla*sx,  a_imp = d_imp*(x - s_t*t_mov*te)
// and the dual prox of all three row blocks (tree, tenant, improvement),
// given the two matvec kernels' raw outputs kx and sx and x = s*mov*xe.
// One grid covers the m + k + n rows: each block's rows start at a CTA
// boundary, so every CTA runs one block's arithmetic and no warp straddles
// two; k = 0 leaves the tenant segment empty.  Like dual_prox it is one
// launch's floor at the paper's sizes (14,025 rows, 0.8 MB in float64, about
// 0.24 us at 3.35 TB/s): what it saves is the 17 other launches of the step.
//
// Design: one grid-stride elementwise pass each, the ragged edge masked by
// the loop bound, so nothing is padded (the TPU version's tau = 1 and
// +-finfo.max/2 padding lanes were block artefacts).  A step size is a
// vector or one broadcast scalar, read through a stride of 1 or 0.  Bounds
// may be +-inf; the comparisons below keep them exact.  Every product, sum
// and quotient is one IEEE-rounded operation in the plain version's order
// (the __*_rn intrinsics are never contracted into an FMA), so the kernel
// returns bit for bit what the plain PyTorch expression returns.
//
// The chunk statistics are one grid-stride pass that writes the new average
// accumulator and, per block, one row of partial results (a fixed-order
// shared-memory tree over the block's threads), then a one-block launch that
// combines the rows in a fixed order: max for the move norms, sums for the
// travel terms.  The TPU version leaves the per-block rows to the caller;
// here no float64 atomics are used, so repeated calls return the same bits.
// The sums add in another order than torch.sum, so they agree with the plain
// version to a few unit roundoffs of the sum of the terms, not bit for bit;
// the maxima and the accumulator are exact.  Bound: bytes, 40 n (primal: 4
// reads + 1 write of n values) and 32 r (dual) in float64.
#include <cuda_runtime.h>

#include <cstdint>

// The fused dual step's arguments.  The exported dual_update_* take them by
// value, so these types live outside the anonymous namespace: a parameter
// type local to this file would give those functions internal linkage.
//
// One row block of the fused dual step: out = prox(y + sig*a') with
// a' = d*a (tree and tenant rows) or d*(a - s_t*t_mov*te) (improvement rows,
// a = x).  A step size is read through sig_stride (1: a vector, 0: one
// scalar).  The layout is the wrapper's ctypes.Structure (_build.DualRows).
template <typename T>
struct DualRows {
  const T* y;
  const T* a;
  const T* d;
  const T* sig;
  int64_t sig_stride;
  const T* lo;
  const T* hi;
  T* out;
  int64_t count;
};

// The three row blocks and the scalars of the improvement rows' t column
// (_build.DualUpdateArgs).
template <typename T>
struct DualUpdateArgs {
  DualRows<T> tree;
  DualRows<T> sla;
  DualRows<T> imp;
  const T* s_t;
  const T* t_mov;
  const T* te;
};

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

// Row i of a block, every operation rounded once in the plain version's
// order: scaled_matvec's product, then dual_prox's z and prox.
template <typename T, bool kImp>
__device__ __forceinline__ void dual_row(const DualRows<T>& r, int64_t i, T shift) {
  using R = Rn<T>;
  const T ai = kImp ? R::sub(r.a[i], shift) : r.a[i];
  const T a = R::mul(r.d[i], ai);
  const T s = r.sig[i * r.sig_stride];
  const T z = R::add(r.y[i], R::mul(s, a));
  r.out[i] = R::sub(z, R::mul(s, clip(R::div(z, s), r.lo[i], r.hi[i])));
}

// Blocks [0, tree_blocks) take the tree rows, the next sla_blocks the
// tenant rows, the rest the improvement rows; one row per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dual_update_kernel(DualUpdateArgs<T> p, int64_t tree_blocks, int64_t sla_blocks) {
  using R = Rn<T>;
  int64_t b = blockIdx.x;
  if (b < tree_blocks) {
    const DualRows<T> r = p.tree;
    const int64_t i = b * kThreads + threadIdx.x;
    if (i < r.count) dual_row<T, false>(r, i, T(0));
    return;
  }
  b -= tree_blocks;
  if (b < sla_blocks) {
    const DualRows<T> r = p.sla;
    const int64_t i = b * kThreads + threadIdx.x;
    if (i < r.count) dual_row<T, false>(r, i, T(0));
    return;
  }
  b -= sla_blocks;
  const DualRows<T> r = p.imp;
  const int64_t i = b * kThreads + threadIdx.x;
  // s_t * t_mov * te, left to right as torch evaluates it
  if (i < r.count) dual_row<T, true>(r, i, R::mul(R::mul(*p.s_t, *p.t_mov), *p.te));
}

constexpr int kStatThreads = 256;

// max that lets a NaN through, as torch.max does
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// Reduce K values per thread over the block in a fixed order; the first
// kMax slots take the max, the rest the sum.  Thread 0 gets the results.
template <typename T, int K, int kMax>
__device__ void block_reduce(T (&v)[K], T* sh) {
  using R = Rn<T>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k * kStatThreads + tid] = v[k];
  __syncthreads();
  for (int half = kStatThreads / 2; half > 0; half >>= 1) {
    if (tid < half) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T a = sh[k * kStatThreads + tid];
        const T b = sh[k * kStatThreads + tid + half];
        sh[k * kStatThreads + tid] = k < kMax ? max_nan(a, b) : R::add(a, b);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = sh[k * kStatThreads];
}

template <typename T>
__global__ void __launch_bounds__(kStatThreads)
    primal_stats_kernel(const T* __restrict__ x, const T* __restrict__ px,
                        const T* __restrict__ rx, const T* __restrict__ ax, T cnt, int64_t n,
                        T* __restrict__ axn, T* __restrict__ part) {
  using R = Rn<T>;
  __shared__ T sh[4 * kStatThreads];
  T v[4] = {T(0), T(0), T(0), T(0)};  // |.| >= 0, so 0 is the max's identity
  const int64_t step = static_cast<int64_t>(gridDim.x) * kStatThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kStatThreads + threadIdx.x; i < n;
       i += step) {
    const T xi = x[i];
    const T a = R::add(ax[i], xi);
    axn[i] = a;
    const T r = rx[i];
    v[0] = max_nan(v[0], fabs(R::sub(xi, px[i])));
    v[1] = max_nan(v[1], fabs(xi));
    const T d = R::sub(xi, r);
    v[2] = R::add(v[2], R::mul(d, d));
    const T e = R::sub(R::div(a, cnt), r);
    v[3] = R::add(v[3], R::mul(e, e));
  }
  block_reduce<T, 4, 2>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) part[blockIdx.x * 4 + k] = v[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kStatThreads)
    dual_stats_kernel(const T* __restrict__ y, const T* __restrict__ ry,
                      const T* __restrict__ ay, T cnt, int64_t n, T* __restrict__ ayn,
                      T* __restrict__ part) {
  using R = Rn<T>;
  __shared__ T sh[3 * kStatThreads];
  T v[3] = {T(0), T(0), T(0)};
  const int64_t step = static_cast<int64_t>(gridDim.x) * kStatThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kStatThreads + threadIdx.x; i < n;
       i += step) {
    const T yi = y[i];
    const T a = R::add(ay[i], yi);
    ayn[i] = a;
    const T r = ry[i];
    const T d = R::sub(yi, r);
    v[0] = R::add(v[0], R::mul(d, d));
    const T e = R::sub(R::div(a, cnt), r);
    v[1] = R::add(v[1], R::mul(e, e));
    v[2] = R::add(v[2], R::mul(r, r));
  }
  block_reduce<T, 3, 0>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) part[blockIdx.x * 3 + k] = v[k];
  }
}

// One block: combine the nb rows of K partials, each thread a fixed stripe
// of rows, then the block tree.  nb = 0 gives zeros.
template <typename T, int K, int kMax>
__global__ void __launch_bounds__(kStatThreads)
    combine_rows(const T* __restrict__ part, int64_t nb, T* __restrict__ out) {
  using R = Rn<T>;
  __shared__ T sh[K * kStatThreads];
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = T(0);
  for (int64_t b = threadIdx.x; b < nb; b += kStatThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T p = part[b * K + k];
      v[k] = k < kMax ? max_nan(v[k], p) : R::add(v[k], p);
    }
  }
  block_reduce<T, K, kMax>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = v[k];
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

int64_t blocks_of(int64_t rows) { return (rows + kThreads - 1) / kThreads; }

template <typename T>
int dual_update_impl(int device, const DualUpdateArgs<T>& args, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tree_blocks = blocks_of(args.tree.count);
  const int64_t sla_blocks = blocks_of(args.sla.count);
  const int64_t blocks = tree_blocks + sla_blocks + blocks_of(args.imp.count);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    dual_update_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        args, tree_blocks, sla_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int primal_chunk_stats_impl(int device, const T* x, const T* px, const T* rx, const T* ax,
                            double cnt, int64_t n, T* axn, T* part, T* out,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned nb = n > 0 ? grid_for(n) : 0;
  if (nb > 0) {
    primal_stats_kernel<T><<<nb, kStatThreads, 0, stream>>>(x, px, rx, ax, static_cast<T>(cnt), n,
                                                           axn, part);
  }
  combine_rows<T, 4, 2><<<1, kStatThreads, 0, stream>>>(part, nb, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dual_chunk_stats_impl(int device, const T* y, const T* ry, const T* ay, double cnt,
                          int64_t n, T* ayn, T* part, T* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned nb = n > 0 ? grid_for(n) : 0;
  if (nb > 0) {
    dual_stats_kernel<T><<<nb, kStatThreads, 0, stream>>>(y, ry, ay, static_cast<T>(cnt), n, ayn,
                                                         part);
  }
  combine_rows<T, 3, 0><<<1, kStatThreads, 0, stream>>>(part, nb, out);
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

// The fused dual step: (y_tree, y_sla, y_imp) -> their outputs, see
// DualUpdateArgs; the structure is passed by value.
int dual_update_f64(int device, DualUpdateArgs<double> args, void* stream) {
  return dual_update_impl<double>(device, args, static_cast<cudaStream_t>(stream));
}

int dual_update_f32(int device, DualUpdateArgs<float> args, void* stream) {
  return dual_update_impl<float>(device, args, static_cast<cudaStream_t>(stream));
}

// (ax + x, [max|x - px|, max|x|, sum (x - rx)^2, sum ((ax + x)/cnt - rx)^2]);
// `part` holds chunk_stats_blocks(n) rows of 4.
int primal_chunk_stats_f64(int device, const double* x, const double* px, const double* rx,
                           const double* ax, double cnt, int64_t n, double* axn, double* part,
                           double* out, void* stream) {
  return primal_chunk_stats_impl<double>(device, x, px, rx, ax, cnt, n, axn, part, out,
                                         static_cast<cudaStream_t>(stream));
}

int primal_chunk_stats_f32(int device, const float* x, const float* px, const float* rx,
                           const float* ax, double cnt, int64_t n, float* axn, float* part,
                           float* out, void* stream) {
  return primal_chunk_stats_impl<float>(device, x, px, rx, ax, cnt, n, axn, part, out,
                                        static_cast<cudaStream_t>(stream));
}

// (ay + y, [sum (y - ry)^2, sum ((ay + y)/cnt - ry)^2, sum ry^2]);
// `part` holds chunk_stats_blocks(n) rows of 3.
int dual_chunk_stats_f64(int device, const double* y, const double* ry, const double* ay,
                         double cnt, int64_t n, double* ayn, double* part, double* out,
                         void* stream) {
  return dual_chunk_stats_impl<double>(device, y, ry, ay, cnt, n, ayn, part, out,
                                       static_cast<cudaStream_t>(stream));
}

int dual_chunk_stats_f32(int device, const float* y, const float* ry, const float* ay,
                         double cnt, int64_t n, float* ayn, float* part, float* out,
                         void* stream) {
  return dual_chunk_stats_impl<float>(device, y, ry, ay, cnt, n, ayn, part, out,
                                      static_cast<cudaStream_t>(stream));
}

// Threads in the largest grid a launch uses: a longer vector makes the
// grid-stride loop take more than one pass.
int64_t elementwise_grid_threads() { return kMaxBlocks * kThreads; }

// Rows of partial results the chunk-stats pass writes for n elements.
int64_t chunk_stats_blocks(int64_t n) { return n > 0 ? grid_for(n) : 0; }

}  // extern "C"

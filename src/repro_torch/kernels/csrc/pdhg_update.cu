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
// The chunk statistics are one launch per KKT check: check_chunk_stats
// takes the primal block (x; n rows), the solver's two dual blocks (the
// tree rows and the improvement rows) and the two accumulators the check
// also updates, at + t (a 0-d value) and ays + ys (the k tenant rows).  The
// grid is four segments, each starting at a CTA boundary: a statistics
// block keeps the CTAs a launch of its own would have (grid_for) and runs
// one grid-stride pass over them that writes the new average accumulator
// and, per CTA, one row of partial results (a fixed-order tree over the
// CTA's threads, block_reduce); each CTA then takes a ticket from its
// block's counter (an acquire-release add, no float64 atomics), and the CTA
// that draws the last ticket reads the block's rows back past L1, combines
// them in a fixed order (each thread a stripe of rows, then the tree: max
// for the move norms, sums for the travel terms) and resets the counter to
// 0.  The accumulator segment adds, one rounded add a value, and reads no
// statistic.  The standalone primal_chunk_stats, dual_chunk_stats and
// dual_chunk_stats_pair are the same kernel with their blocks alone, so a
// block's bits are the same in every call that takes it.  The TPU version
// leaves the per-block rows to the caller; here repeated calls return the
// same bits.  The sums add in another order than torch.sum, so they agree
// with the plain version to a few unit roundoffs of the sum of the terms,
// not bit for bit; the maxima and the accumulators are exact.
// Bound: bytes, 40 n (primal: 4 reads + 1 write of n values), 32 r per dual
// block and 24 k + 24 for the accumulators in float64: 0.94 MB at the
// paper's tenant fleet, about 0.28 us at 3.35 TB/s, far below a launch's
// floor.  What the one launch saves is launches: the pass, the ticket's
// round trip to L2 and the combine's tree are one dependent chain, where
// the check issued five launches before; the trees wait on three barriers
// each, not nine.
// The counters are a device buffer the wrapper allocates once per device,
// zero between launches, so the launch replays in a CUDA graph; two calls
// running at once on two streams would share them (the solver makes one
// call at a time).
//
// Lanes.  Every kernel here also takes K problems in one launch (the
// allocator's K-scenario path), the lane a grid axis (blockIdx.y): lane L's
// vectors follow lane L-1's, contiguous [K, size]; a step size or scalar is
// read through a lane stride of its own (the vector's size, 1 for one
// scalar per lane, 0 for one shared by every lane).  The chunk statistics
// give each lane its own partial rows, three ticket counters and count
// (cnt, read from a device array of K counts, since the lanes restart at
// different checks), so each lane's bits are those of a launch on that lane
// alone.
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

#include "rounded.cuh"

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
  int64_t sig_lane;
  const T* lo;
  const T* hi;
  T* out;
  int64_t count;
};

// The three row blocks and the scalars of the improvement rows' t column,
// read at lane * scalar_lane (_build.DualUpdateArgs).
template <typename T>
struct DualUpdateArgs {
  DualRows<T> tree;
  DualRows<T> sla;
  DualRows<T> imp;
  const T* s_t;
  const T* t_mov;
  const T* te;
  int64_t scalar_lane;
};

// The primal block of the chunk statistics: the iterate, the previous
// check's iterate, the restart anchor, the average accumulator, the new
// accumulator, the four results and the row count (_build.PrimalStatsRows).
template <typename T>
struct PrimalStatsRows {
  const T* x;
  const T* px;
  const T* rx;
  const T* ax;
  T* axn;
  T* out;
  int64_t count;
};

// One dual block of the chunk statistics: the duals, the restart anchor,
// the average accumulator, the new accumulator, the three sums and the row
// count (_build.StatsRows).
template <typename T>
struct StatsRows {
  const T* y;
  const T* ry;
  const T* ay;
  T* ayn;
  T* out;
  int64_t count;
};

// The accumulators a KKT check adds besides the statistics: the 0-d t and
// its accumulator, the k tenant duals and theirs (_build.AccRows).
template <typename T>
struct AccRows {
  const T* t;
  const T* at;
  T* atn;
  const T* ys;
  const T* ays;
  T* aysn;
  int64_t count;
};

// check_chunk_stats' blocks, the partial rows of its statistics blocks
// (primal's, then first's, then second's) and their three ticket counters
// (_build.ChunkStatsArgs).  Which blocks a launch takes is its `blocks`
// mask (kPrimal, kFirst, kSecond, kAcc).  With lanes, lane L's results are
// at out + L * out_lane in each block's `out`, its partial rows and
// counters follow lane L-1's, and its count is cnt[L] (a null `cnt` means
// the count passed by value).
template <typename T>
struct ChunkStatsArgs {
  PrimalStatsRows<T> primal;
  StatsRows<T> first;
  StatsRows<T> second;
  AccRows<T> acc;
  T* part;
  unsigned* tickets;
  const T* cnt;
  int64_t out_lane;
};

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

using rn::clip;
using rn::Rn;

// Lane blockIdx.y of `x` etc. ([lanes, n]); tau read at lane * tau_lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    primal_update_kernel(const T* __restrict__ x, const T* __restrict__ gx,
                         const T* __restrict__ c, const T* __restrict__ w,
                         const T* __restrict__ target, const T* __restrict__ lo,
                         const T* __restrict__ hi, const T* __restrict__ tau, int64_t tau_stride,
                         int64_t tau_lane, int64_t n, T* __restrict__ x1, T* __restrict__ xe) {
  const int64_t lane = blockIdx.y;
  const int64_t base = lane * n;
  tau += lane * tau_lane;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
    const int64_t li = base + i;
    T v, e;
    rn::primal_prox(x[li], gx[li], c[li], w[li], target[li], lo[li], hi[li], tau[i * tau_stride],
                    v, e);
    x1[li] = v;
    xe[li] = e;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dual_prox_kernel(const T* __restrict__ y, const T* __restrict__ a,
                     const T* __restrict__ sigma, int64_t sigma_stride, int64_t sigma_lane,
                     const T* __restrict__ lo, const T* __restrict__ hi, int64_t n,
                     T* __restrict__ out) {
  using R = Rn<T>;
  const int64_t lane = blockIdx.y;
  const int64_t base = lane * n;
  sigma += lane * sigma_lane;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += step) {
    const int64_t li = base + i;
    const T s = sigma[i * sigma_stride];
    const T z = R::add(y[li], R::mul(s, a[li]));
    out[li] = R::sub(z, R::mul(s, clip(R::div(z, s), lo[li], hi[li])));
  }
}

// Row i of a block, every operation rounded once in the plain version's
// order: scaled_matvec's product, then dual_prox's z and prox.
// Row i of lane `lane` of a block: its vectors at lane * count, its step
// sizes at lane * sig_lane.
template <typename T, bool kImp>
__device__ __forceinline__ void dual_row(const DualRows<T>& r, int64_t lane, int64_t i,
                                         T shift) {
  using R = Rn<T>;
  const int64_t li = lane * r.count + i;
  const T ai = kImp ? R::sub(r.a[li], shift) : r.a[li];
  const T a = R::mul(r.d[li], ai);
  const T s = r.sig[lane * r.sig_lane + i * r.sig_stride];
  const T z = R::add(r.y[li], R::mul(s, a));
  r.out[li] = R::sub(z, R::mul(s, clip(R::div(z, s), r.lo[li], r.hi[li])));
}

// Blocks [0, tree_blocks) take the tree rows, the next sla_blocks the
// tenant rows, the rest the improvement rows; one row per thread, of lane
// blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dual_update_kernel(DualUpdateArgs<T> p, int64_t tree_blocks, int64_t sla_blocks) {
  using R = Rn<T>;
  const int64_t lane = blockIdx.y;
  int64_t b = blockIdx.x;
  if (b < tree_blocks) {
    const DualRows<T> r = p.tree;
    const int64_t i = b * kThreads + threadIdx.x;
    if (i < r.count) dual_row<T, false>(r, lane, i, T(0));
    return;
  }
  b -= tree_blocks;
  if (b < sla_blocks) {
    const DualRows<T> r = p.sla;
    const int64_t i = b * kThreads + threadIdx.x;
    if (i < r.count) dual_row<T, false>(r, lane, i, T(0));
    return;
  }
  b -= sla_blocks;
  const DualRows<T> r = p.imp;
  const int64_t i = b * kThreads + threadIdx.x;
  const int64_t ls = lane * p.scalar_lane;
  // s_t * t_mov * te, left to right as torch evaluates it
  if (i < r.count) {
    dual_row<T, true>(r, lane, i, R::mul(R::mul(p.s_t[ls], p.t_mov[ls]), p.te[ls]));
  }
}

constexpr int kStatThreads = 256;

// max that lets a NaN through, as torch.max does
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// Reduce K values per thread over the block in a fixed order, a tree of
// the pairs (tid, tid + half) for half = 128, 64, ..., 1: the first kMax
// slots take the max, the rest the sum.  Thread 0 gets the results.  The
// three levels that cross warps go through shared memory, each level's
// upper threads publishing into a region of their own, so each level
// waits on one barrier and loads its K operands together; the last five
// run in warp 0 by shuffles, with the same pairs and so the same bits.
template <typename T, int K, int kMax>
__device__ void block_reduce(T (&v)[K], T* sh) {
  using R = Rn<T>;
  const int tid = threadIdx.x;
  int base = 0;
#pragma unroll
  for (int half = kStatThreads / 2; half >= 32; half >>= 1) {
    if (tid >= half && tid < 2 * half) {
#pragma unroll
      for (int k = 0; k < K; ++k) sh[k * kStatThreads + base + tid - half] = v[k];
    }
    __syncthreads();
    if (tid < half) {
      T o[K];
#pragma unroll
      for (int k = 0; k < K; ++k) o[k] = sh[k * kStatThreads + base + tid];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = k < kMax ? max_nan(v[k], o[k]) : R::add(v[k], o[k]);
    }
    base += half;
  }
  if (tid < 32) {
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T o = __shfl_down_sync(0xffffffffu, v[k], half);
        v[k] = k < kMax ? max_nan(v[k], o) : R::add(v[k], o);
      }
    }
  }
}

// Combine nb rows of K partials: each thread a fixed stripe of rows, then
// the block tree; thread 0 writes the K results.  The rows are read past
// L1 (__ldcg), since other CTAs of the same launch wrote them.
template <typename T, int K, int kMax>
__device__ void combine_partials(const T* part, int64_t nb, T* out, T* sh) {
  using R = Rn<T>;
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = T(0);
  for (int64_t b = threadIdx.x; b < nb; b += kStatThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T p = __ldcg(part + b * K + k);
      v[k] = k < kMax ? max_nan(v[k], p) : R::add(v[k], p);
    }
  }
  block_reduce<T, K, kMax>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = v[k];
  }
}

// CTA b of a statistics block of nb CTAs, after its pass: reduce its K
// partials over the CTA, write them as row b, take a ticket; the CTA that
// draws the last one combines the nb rows into `out` and resets the
// counter.
template <typename T, int K, int kMax>
__device__ void finish_block(T (&v)[K], T* part, int64_t b, int64_t nb, unsigned* ticket,
                             T* out, T* sh, bool& last) {
  block_reduce<T, K, kMax>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[b * K + k] = v[k];
    // release: this CTA's row is visible before its ticket; acquire: the
    // last ticket's holder sees every other CTA's row (and, past the
    // barrier below, so do its other threads)
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> t(*ticket);
    last = t.fetch_add(1u, cuda::memory_order_acq_rel) == static_cast<unsigned>(nb - 1);
  }
  __syncthreads();
  if (!last) return;
  combine_partials<T, K, kMax>(part, nb, out, sh);
  if (threadIdx.x == 0) *ticket = 0u;
}

// ax + x,  max|x - px|,  max|x|,  sum (x - rx)^2,  sum ((ax + x)/cnt - rx)^2
template <typename T>
__device__ void primal_block(const PrimalStatsRows<T>& r, T cnt, int64_t b, int64_t nb,
                             T* part, unsigned* ticket, T* sh, bool& last) {
  using R = Rn<T>;
  T v[4] = {T(0), T(0), T(0), T(0)};  // |.| >= 0, so 0 is the max's identity
  const int64_t step = nb * kStatThreads;
  for (int64_t i = b * kStatThreads + threadIdx.x; i < r.count; i += step) {
    // every load before the store: the pointers are not __restrict__, so a
    // load after the store could not be issued before it
    const T xi = r.x[i];
    const T axi = r.ax[i];
    const T pxi = r.px[i];
    const T ri = r.rx[i];
    const T a = R::add(axi, xi);
    r.axn[i] = a;
    v[0] = max_nan(v[0], fabs(R::sub(xi, pxi)));
    v[1] = max_nan(v[1], fabs(xi));
    const T d = R::sub(xi, ri);
    v[2] = R::add(v[2], R::mul(d, d));
    const T e = R::sub(R::div(a, cnt), ri);
    v[3] = R::add(v[3], R::mul(e, e));
  }
  finish_block<T, 4, 2>(v, part, b, nb, ticket, r.out, sh, last);
}

// ay + y,  sum (y - ry)^2,  sum ((ay + y)/cnt - ry)^2,  sum ry^2
template <typename T>
__device__ void dual_block(const StatsRows<T>& r, T cnt, int64_t b, int64_t nb, T* part,
                           unsigned* ticket, T* sh, bool& last) {
  using R = Rn<T>;
  T v[3] = {T(0), T(0), T(0)};
  const int64_t step = nb * kStatThreads;
  for (int64_t i = b * kStatThreads + threadIdx.x; i < r.count; i += step) {
    const T yi = r.y[i];
    const T ayi = r.ay[i];
    const T ry = r.ry[i];
    const T acc = R::add(ayi, yi);
    r.ayn[i] = acc;
    const T d = R::sub(yi, ry);
    v[0] = R::add(v[0], R::mul(d, d));
    const T e = R::sub(R::div(acc, cnt), ry);
    v[1] = R::add(v[1], R::mul(e, e));
    v[2] = R::add(v[2], R::mul(ry, ry));
  }
  finish_block<T, 3, 0>(v, part, b, nb, ticket, r.out, sh, last);
}

// Lane `lane` of a block: its vectors at lane * count, its results at
// lane * out_lane.
template <typename T>
__device__ __forceinline__ PrimalStatsRows<T> primal_lane(PrimalStatsRows<T> r, int64_t lane,
                                                           int64_t out_lane) {
  const int64_t o = lane * r.count;
  r.x += o;
  r.px += o;
  r.rx += o;
  r.ax += o;
  r.axn += o;
  r.out += lane * out_lane;
  return r;
}

template <typename T>
__device__ __forceinline__ StatsRows<T> dual_lane(StatsRows<T> r, int64_t lane,
                                                  int64_t out_lane) {
  const int64_t o = lane * r.count;
  r.y += o;
  r.ry += o;
  r.ay += o;
  r.ayn += o;
  r.out += lane * out_lane;
  return r;
}

// CTAs [0, bp) take the primal block, the next b0 the first dual block, the
// next b1 the second, the rest (ba) the accumulators; a block a launch does
// not take has no CTAs.  Each statistics block's CTAs grid-stride over it as
// a launch of that block alone would.  blockIdx.y is the lane: its partial
// rows, ticket counters and count are its own.
template <typename T>
__global__ void __launch_bounds__(kStatThreads)
    chunk_stats_kernel(ChunkStatsArgs<T> a, T cnt, int64_t bp, int64_t b0, int64_t b1,
                       int64_t ba) {
  using R = Rn<T>;
  __shared__ T sh[4 * kStatThreads];
  __shared__ bool last;
  const int64_t lane = blockIdx.y;
  if (a.cnt != nullptr) cnt = a.cnt[lane];
  T* part = a.part + lane * (4 * bp + 3 * (b0 + b1));
  unsigned* tickets = a.tickets + 3 * lane;
  int64_t b = blockIdx.x;
  if (b < bp) {
    primal_block(primal_lane(a.primal, lane, a.out_lane), cnt, b, bp, part, tickets, sh, last);
    return;
  }
  b -= bp;
  part += 4 * bp;
  if (b < b0) {
    dual_block(dual_lane(a.first, lane, a.out_lane), cnt, b, b0, part, tickets + 1, sh, last);
    return;
  }
  b -= b0;
  part += 3 * b0;
  if (b < b1) {
    dual_block(dual_lane(a.second, lane, a.out_lane), cnt, b, b1, part, tickets + 2, sh, last);
    return;
  }
  b -= b1;
  const AccRows<T> r = a.acc;
  const int64_t o = lane * r.count;
  if (b == 0 && threadIdx.x == 0) r.atn[lane] = R::add(r.at[lane], r.t[lane]);
  for (int64_t i = b * kStatThreads + threadIdx.x; i < r.count; i += ba * kStatThreads) {
    r.aysn[o + i] = R::add(r.ays[o + i], r.ys[o + i]);
  }
}

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// The grid's y axis holds the lanes.
constexpr int64_t kMaxLanes = 65535;

bool lanes_ok(int64_t lanes) { return lanes >= 1 && lanes <= kMaxLanes; }

template <typename T>
int primal_update_impl(int device, const T* x, const T* gx, const T* c, const T* w,
                       const T* target, const T* lo, const T* hi, const T* tau,
                       int64_t tau_stride, int64_t tau_lane, int64_t n, int64_t lanes, T* x1,
                       T* xe, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const dim3 grid(grid_for(n), static_cast<unsigned>(lanes));
    primal_update_kernel<T><<<grid, kThreads, 0, stream>>>(x, gx, c, w, target, lo, hi, tau,
                                                          tau_stride, tau_lane, n, x1, xe);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dual_prox_impl(int device, const T* y, const T* a, const T* sigma, int64_t sigma_stride,
                   int64_t sigma_lane, const T* lo, const T* hi, int64_t n, int64_t lanes, T* out,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const dim3 grid(grid_for(n), static_cast<unsigned>(lanes));
    dual_prox_kernel<T><<<grid, kThreads, 0, stream>>>(y, a, sigma, sigma_stride, sigma_lane, lo,
                                                      hi, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int64_t blocks_of(int64_t rows) { return (rows + kThreads - 1) / kThreads; }

template <typename T>
int dual_update_impl(int device, const DualUpdateArgs<T>& args, int64_t lanes,
                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tree_blocks = blocks_of(args.tree.count);
  const int64_t sla_blocks = blocks_of(args.sla.count);
  const int64_t blocks = tree_blocks + sla_blocks + blocks_of(args.imp.count);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(lanes));
    dual_update_kernel<T><<<grid, kThreads, 0, stream>>>(args, tree_blocks, sla_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of a statistics block: a launch of its own's, and one for an empty
// block, which writes its zeros.
int64_t stats_blocks(int64_t n) { return n > 0 ? grid_for(n) : 1; }

// The blocks a launch of check_chunk_stats takes (its `blocks` mask).
constexpr int kPrimal = 1, kFirst = 2, kSecond = 4, kAcc = 8;

template <typename T>
int chunk_stats_impl(int device, const ChunkStatsArgs<T>& args, double cnt, int blocks,
                     int64_t lanes, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks <= 0 || blocks > (kPrimal | kFirst | kSecond | kAcc) || !lanes_ok(lanes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t bp = blocks & kPrimal ? stats_blocks(args.primal.count) : 0;
  const int64_t b0 = blocks & kFirst ? stats_blocks(args.first.count) : 0;
  const int64_t b1 = blocks & kSecond ? stats_blocks(args.second.count) : 0;
  const int64_t ba = blocks & kAcc ? stats_blocks(args.acc.count) : 0;
  const dim3 grid(static_cast<unsigned>(bp + b0 + b1 + ba), static_cast<unsigned>(lanes));
  chunk_stats_kernel<T><<<grid, kStatThreads, 0, stream>>>(args, static_cast<T>(cnt), bp, b0, b1,
                                                           ba);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each takes `lanes` lanes of its vectors ([lanes, n]); a step size at
// lane * tau_lane (sigma_lane) and i * tau_stride (sigma_stride).
int primal_update_f64(int device, const double* x, const double* gx, const double* c,
                      const double* w, const double* target, const double* lo, const double* hi,
                      const double* tau, int64_t tau_stride, int64_t tau_lane, int64_t n,
                      int64_t lanes, double* x1, double* xe, void* stream) {
  return primal_update_impl<double>(device, x, gx, c, w, target, lo, hi, tau, tau_stride,
                                    tau_lane, n, lanes, x1, xe,
                                    static_cast<cudaStream_t>(stream));
}

int primal_update_f32(int device, const float* x, const float* gx, const float* c,
                      const float* w, const float* target, const float* lo, const float* hi,
                      const float* tau, int64_t tau_stride, int64_t tau_lane, int64_t n,
                      int64_t lanes, float* x1, float* xe, void* stream) {
  return primal_update_impl<float>(device, x, gx, c, w, target, lo, hi, tau, tau_stride,
                                   tau_lane, n, lanes, x1, xe, static_cast<cudaStream_t>(stream));
}

int dual_prox_f64(int device, const double* y, const double* a, const double* sigma,
                  int64_t sigma_stride, int64_t sigma_lane, const double* lo, const double* hi,
                  int64_t n, int64_t lanes, double* out, void* stream) {
  return dual_prox_impl<double>(device, y, a, sigma, sigma_stride, sigma_lane, lo, hi, n, lanes,
                                out, static_cast<cudaStream_t>(stream));
}

int dual_prox_f32(int device, const float* y, const float* a, const float* sigma,
                  int64_t sigma_stride, int64_t sigma_lane, const float* lo, const float* hi,
                  int64_t n, int64_t lanes, float* out, void* stream) {
  return dual_prox_impl<float>(device, y, a, sigma, sigma_stride, sigma_lane, lo, hi, n, lanes,
                               out, static_cast<cudaStream_t>(stream));
}

// The fused dual step: (y_tree, y_sla, y_imp) -> their outputs, see
// DualUpdateArgs, for each lane; the structure is passed by value.
int dual_update_f64(int device, DualUpdateArgs<double> args, int64_t lanes, void* stream) {
  return dual_update_impl<double>(device, args, lanes, static_cast<cudaStream_t>(stream));
}

int dual_update_f32(int device, DualUpdateArgs<float> args, int64_t lanes, void* stream) {
  return dual_update_impl<float>(device, args, lanes, static_cast<cudaStream_t>(stream));
}

// The chunk statistics of the blocks in the `blocks` mask (1: primal, 2:
// the first dual block, 4: the second, 8: the accumulators), in one
// launch:
//   primal: (ax + x, [max|x - px|, max|x|, sum (x - rx)^2,
//            sum ((ax + x)/cnt - rx)^2])
//   dual:   (ay + y, [sum (y - ry)^2, sum ((ay + y)/cnt - ry)^2, sum ry^2])
//   accumulators: at + t, ays + ys
// `part` holds, per lane, chunk_stats_blocks(count) rows of 4 for the
// primal block and of 3 for each dual block it takes, `tickets` three
// zeroed counters per lane, left at zero.  The structure is passed by
// value.
int chunk_stats_f64(int device, ChunkStatsArgs<double> args, double cnt, int blocks,
                    int64_t lanes, void* stream) {
  return chunk_stats_impl<double>(device, args, cnt, blocks, lanes,
                                  static_cast<cudaStream_t>(stream));
}

int chunk_stats_f32(int device, ChunkStatsArgs<float> args, double cnt, int blocks,
                    int64_t lanes, void* stream) {
  return chunk_stats_impl<float>(device, args, cnt, blocks, lanes,
                                 static_cast<cudaStream_t>(stream));
}

// Threads in the largest grid a launch uses: a longer vector makes the
// grid-stride loop take more than one pass.
int64_t elementwise_grid_threads() { return kMaxBlocks * kThreads; }

// CTAs, and so rows of partial results, of a chunk-statistics block of n
// rows.
int64_t chunk_stats_blocks(int64_t n) { return stats_blocks(n); }

}  // extern "C"

// Tree- and tenant-constraint matvecs of the nvPAX PDHG loop, written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/tree_matvec/kernel.py:
//   tree_matvec  (_blocked_prefix + _gather_kernel)   out[j] = csum[end_j] - csum[start_j]
//   tree_rmatvec (_scatter_diff_kernel + _blocked_prefix)   the adjoint:
//                out[i] = sum of y[j] over the rows j with start_j <= i < end_j
//   sla_matvec   (_sla_matvec_kernel)    out[t] = sum over edges e of tenant t of x[dev_e]
//   sla_rmatvec  (_sla_rmatvec_kernel)   out[d] = sum over edges e of device d of y[ten_e]
//
// What bounds them on this card: launch latency and chains of dependent
// loads, not bytes.  At the paper's fleet (n = 12,288 devices, m = 1,637
// tree rows) each call moves about 0.1-0.2 MB, well under a microsecond at
// 3.35 TB/s, so every launch of a call and every load that waits on another
// costs more than the bytes.
//
// tree_matvec.  The TPU version carries a prefix sum across a sequential
// grid.  Hopper blocks run in no order, so the scan needs a wait between
// the tiles' sums and the rows' gather.  Each call is one launch in which
//   1. blocks scan tiles of kTile positions of x (kItems per thread
//      sequentially, then warp shuffles, then the warp totals through
//      shared memory) into each tile's inclusive prefix and its total;
//   2. the blocks wait for each other;
//   3. the nb tile totals are scanned into tile offsets with a carry;
//   4. the blocks gather csum at both ends of every row, adding the tile
//      offset on the fly.
// Up to kClusterTiles tiles (n <= 16,384; the paper's fleet has 12) the
// blocks are one thread block cluster, a block per tile
// (tree_matvec_cluster): each keeps its tile's prefix in its own shared
// memory, the wait is the cluster's hardware barrier, every block scans
// the totals itself, and the totals and prefixes are read across the
// cluster through distributed shared memory; each thread loads its row's
// endpoints before the scan.  Past that it is a cooperative launch
// (tree_matvec_kernel), its grid no larger than what the card holds at
// once, grid-striding over tiles and rows, the prefixes, totals and
// offsets in device memory: a grid barrier, block 0 scans the totals, a
// second grid barrier.  The cluster path is the faster of the two at the
// fleet's size: a cooperative launch costs more than a plain one, and a
// grid barrier more than a cluster's (chip_smoke.py phase 6 times both
// paths at their boundary, n = 16,384 and 16,385).
// Both do the adds of the three launches they replace (scan_tiles,
// scan_totals, gather_rows: 8.09 us a call on an NVIDIA H100 80GB HBM3 at
// 700 W, chip_smoke.py), in the same order, so every bit is theirs; those
// launches' fixed costs were most of that time.  No atomics: barriers
// order the passes.
//
// tree_rmatvec and sla_rmatvec are one segmented-sum kernel (segment_sums):
// one thread per output sums a CSR list that the host builds once per
// topology, in list order, with no atomics, so the same bits come back on
// every launch.  For the adjoint, position i's list holds the rows covering
// it (start_j <= i < end_j) in ascending row order: its ancestors in the
// power tree, 4 of them at the paper's fleet, so 49,152 entries in all
// (n x depth for a tree).  One launch with one load chain per position
// (list pointer, row id, dual) replaces the TPU's scatter of a difference
// array and its prefix sum.  For the tenant pair the TPU version scatters
// each chunk of incidence edges into the output with `.at[].add`; on this
// card that would be fp64 atomics, whose order changes from run to run,
// and the feasibility repair and saturation tests compare these sums
// against thresholds.  The host sorts the edges into CSR lists (by tenant
// for the forward sum, by device for the adjoint; a stable sort, so each
// list keeps edge order), the order a sequential index_add_ adds in, so
// these kernels return the bits of the plain version.
//
// sla_matvec (gather_sums) walks the long lists: at the paper's Appendix B
// fleet k = 100 tenants hold E = 10,000 edges, ~100 per list, where the
// adjoint's lists hold ~1.  One thread per list left each edge's two
// dependent loads (id, then x[id]) waiting on L2 in turn (7.92 us a call
// on the same card).  Here a warp takes a list: its lanes load kSlaChunk ids
// coalesced and gather their x values all at once, stage them in shared
// memory, and lane 0 adds them with round-to-nearest adds in edge order,
// carrying the sum from chunk to chunk, while the lanes' loads of the next
// chunk are already in flight.  The adds are those of the thread-per-list
// kernel in the same order, so the bits are the plain version's; the chain
// of ~100 dependent fp64 adds (~1k cycles) is shorter than the loads it
// replaces.
//
// scaled_rmatvec is the whole scaled adjoint of one PDHG iteration in one
// launch (core/solver/scaling.py:scaled_rmatvec): for each device i
//   yi[i] = d_imp[i]*y_imp[i],
//   gx[i] = s[i]*mov[i] * ((sum of d_tree[r]*y_tree[r] over i's covering rows
//           + sum of d_sla[t]*y_sla[t] over i's tenants) + yi[i]),
// one thread per device walking the two CSR lists above (the tenant one only
// when k > 0), each sum from T(0) in list order and every product and sum
// rounded once, in the order of the 11 launches it replaces (the row scaling
// of y, tree_rmatvec, sla_rmatvec, the adds and the column scaling), so its
// bits are theirs.  The solver's gt = -s_t*t_mov*sum(yi) stays a torch
// reduction on yi: a sum in this launch would add in another order.
//
// primal_step is that adjoint with the primal update of the same PDHG
// iteration as its epilogue (core/solver/loop.py), in place of three
// launches: scaled_rmatvec, primal_update (pdhg_update.cu) and the column
// scaling xm = s*mov*xe of the two matvecs' input.  Thread i already holds
// gx[i] and sm[i] = s[i]*mov[i]; it keeps gx in a register and writes
//   yi[i],  x1[i] = clip((x - tau*(gx + c) + tau*w*target) / (1 + tau*w), lo, hi),
//   xe[i] = 2*x1[i] - x[i],  xm[i] = sm[i]*xe[i],
// the prox by rn::primal_prox, primal_update's own operations and order
// (rounded.cuh), so the bits are those of the three launches.  The step
// size tau is a vector or one broadcast scalar, read through a stride of 1
// or 0.  The prox's seven inputs are loaded before the list walk, so their
// loads are in flight with it.  Bound: bytes (0.52 us in float64 at the
// paper's tenant fleet); what the fusion saves is two launches per
// iteration and the gx round trip through memory.
//
// Lanes.  Every kernel here also takes K problems over one topology in one
// launch (the allocator's K-scenario path): lane L's vectors follow lane
// L-1's, contiguous [K, size], and the lane is a grid axis (blockIdx.y; the
// cooperative tree_matvec strides over lanes x tiles and lanes x rows), so
// the launches per PDHG iteration do not grow with K.  Each lane runs the
// one-lane arithmetic in the one-lane order on its own pointers, so a lane's
// bits are those of a launch on that lane alone.  The index arrays (row
// ranges, CSR lists) are read through a lane stride of their own, 0 when
// the lanes share one topology; a stacked fleet of K domains can pass K
// indexes laid end to end.  The cluster path's clusters are one lane each,
// grid (tiles, K).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rounded.cuh"

namespace cg = cooperative_groups;

// The scaled adjoint's inputs: the tree duals and row scales with the
// covering-rows CSR, the tenant duals and row scales with the device-tenant
// CSR (read only when k > 0), the improvement duals and row scales, and
// sm = s*mov over the n devices (_build.ScaledAdjoint).  primal_step takes
// its arguments by value, so these types live outside the anonymous
// namespace: a parameter type local to this file would give the exported
// functions internal linkage.
//
// With lanes, lane L reads y_tree and d_tree at L*m, y_sla and d_sla at L*k,
// y_imp, d_imp and sm at L*n, and the two CSR indexes through their own lane
// strides (0: one topology for every lane).
template <typename T>
struct ScaledAdjoint {
  const T* y_tree;
  const T* d_tree;
  const int32_t* cover_ptr;
  const int32_t* cover_rows;
  const T* y_sla;
  const T* d_sla;
  const int32_t* dev_ptr;
  const int32_t* dev_ten;
  const T* y_imp;
  const T* d_imp;
  const T* sm;
  int64_t k;
  int64_t n;
  int64_t m;
  int64_t cover_ptr_lane;
  int64_t cover_rows_lane;
  int64_t dev_ptr_lane;
  int64_t dev_ten_lane;
};

// primal_step's arguments: the adjoint's, the primal iterate, the primal
// prox's data (c, w, target, lo, hi), the step size (a stride of 1 or 0
// within a lane, tau_lane between lanes) and the four outputs
// (_build.PrimalStepArgs); lane L's vectors at L*n.
template <typename T>
struct PrimalStepArgs {
  ScaledAdjoint<T> adj;
  const T* x;
  const T* c;
  const T* w;
  const T* target;
  const T* lo;
  const T* hi;
  const T* tau;
  int64_t tau_stride;
  int64_t tau_lane;
  T* x1;
  T* xe;
  T* xm;
  T* yi;
};

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
// up to this many tiles (n <= 16,384) the blocks are one cluster; past 8,
// the most every Hopper part schedules, it is a non-portable size (the H100
// takes 16)
constexpr int kClusterTiles = 16;
constexpr int kPortableCluster = 8;
constexpr int kRowThreads = 256;
constexpr int kSlaWarps = 4;
constexpr int kSlaItems = 4;
constexpr int kSlaChunk = 32 * kSlaItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// Exclusive scan of one value per thread over the block.  `sums` holds
// kWarps + 1 entries of shared memory; `total` receives the block's sum.
template <typename T>
__device__ T block_exclusive_scan(T v, T* sums, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = T(0);
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < kWarps ? sums[lane] : T(0);
    T wi = w;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const T u = __shfl_up_sync(kFull, wi, d);
      if (lane >= d) wi += u;
    }
    T we = __shfl_up_sync(kFull, wi, 1);
    if (lane == 0) we = T(0);
    if (lane < kWarps) sums[lane] = we;
    if (lane == kWarps - 1) sums[kWarps] = wi;
  }
  __syncthreads();
  const T out = excl + sums[warp];
  total = sums[kWarps];
  __syncthreads();  // `sums` may be reused by the caller's next scan
  return out;
}

// Tile b's inclusive prefix of x over positions [0, n) into `local`, at
// local[p - local_base] for position p; returns the tile's sum.
template <typename T>
__device__ T scan_tile(const T* __restrict__ x, int64_t n, int64_t b, T* local,
                       int64_t local_base, T* sums) {
  const int64_t base = b * kTile + static_cast<int64_t>(threadIdx.x) * kItems;
  T run[kItems];
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = base + i;
    if (p < n) acc += x[p];
    run[i] = acc;
  }
  T total;
  const T off = block_exclusive_scan(acc, sums, total);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = base + i;
    if (p < n) local[p - local_base] = off + run[i];
  }
  return total;
}

// Exclusive prefix of the nb tile totals into `offsets`, by the whole block,
// kThreads totals at a time with a carry.
template <typename T>
__device__ void scan_totals(const T* totals, int64_t nb, T* offsets, T* sums) {
  T carry = T(0);
  for (int64_t b0 = 0; b0 < nb; b0 += kThreads) {
    const int64_t b = b0 + threadIdx.x;
    const T v = b < nb ? totals[b] : T(0);
    T total;
    const T excl = block_exclusive_scan(v, sums, total);
    if (b < nb) offsets[b] = carry + excl;
    carry += total;
  }
}

// csum[p] = x[0] + ... + x[p-1], from the tile prefix and the tile offset.
template <typename T>
__device__ __forceinline__ T prefix_at(const T* local, const T* offsets, int64_t p) {
  if (p <= 0) return T(0);
  return local[p - 1] + offsets[(p - 1) / kTile];
}

// out[j] = csum[end_j] - csum[start_j], all in one cooperative launch, for
// each of `lanes` lanes: the blocks stride over the lanes' tiles, then over
// the lanes' totals (a block per lane), then over the lanes' rows, so any
// number of lanes fits the resident grid.  `local`, `totals` and `offsets`
// (lanes x n, lanes x nb, lanes x nb) are written and read back within the
// launch, so they are read through the coherent path (no __restrict__).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tree_matvec_kernel(const T* __restrict__ x, int64_t n, const int32_t* __restrict__ start,
                       const int32_t* __restrict__ end, int64_t m, int64_t row_lane,
                       int64_t lanes, T* local, T* totals, T* offsets, T* __restrict__ out) {
  __shared__ T sums[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int64_t nb = (n + kTile - 1) / kTile;
  for (int64_t w = blockIdx.x; w < lanes * nb; w += gridDim.x) {
    const int64_t lane = w / nb;
    const int64_t b = w - lane * nb;
    const T total = scan_tile(x + lane * n, n, b, local + lane * n, 0, sums);
    if (threadIdx.x == 0) totals[lane * nb + b] = total;
  }
  grid.sync();
  for (int64_t lane = blockIdx.x; lane < lanes; lane += gridDim.x) {
    scan_totals(totals + lane * nb, nb, offsets + lane * nb, sums);
  }
  grid.sync();
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; w < lanes * m;
       w += step) {
    const int64_t lane = w / m;
    const int64_t j = w - lane * m;
    const T* lp = local + lane * n;
    const T* lo = offsets + lane * nb;
    out[w] = prefix_at(lp, lo, end[lane * row_lane + j]) -
             prefix_at(lp, lo, start[lane * row_lane + j]);
  }
}

// out[j] = csum[end_j] - csum[start_j] for n <= kClusterTiles * kTile: one
// cluster of max(nb, 1) blocks, block b scanning tile b into its shared
// memory, read by the others through distributed shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    tree_matvec_cluster(const T* __restrict__ x, int64_t n, const int32_t* __restrict__ start,
                        const int32_t* __restrict__ end, int64_t m, int64_t row_lane,
                        T* __restrict__ out) {
  // a cluster per lane (blockIdx.y), its blocks the lane's tiles
  const int64_t lane = blockIdx.y;
  x += lane * n;
  out += lane * m;
  start += lane * row_lane;
  end += lane * row_lane;
  __shared__ T local[kTile];
  __shared__ T sums[kWarps + 1];
  __shared__ T tile_total;
  __shared__ T offsets[kClusterTiles];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = static_cast<int>(gridDim.x);
  const int64_t step = static_cast<int64_t>(nb) * kThreads;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // the first row's endpoints, loaded beside x
  const int32_t s0 = j0 < m ? start[j0] : 0;
  const int32_t e0 = j0 < m ? end[j0] : 0;
  const T total = scan_tile(x, n, blockIdx.x, local, static_cast<int64_t>(blockIdx.x) * kTile,
                            sums);
  if (threadIdx.x == 0) tile_total = total;
  cluster.sync();
  // scan_totals' first and only pass (nb <= kThreads), carry 0
  const T v = static_cast<int>(threadIdx.x) < nb
                  ? *cluster.map_shared_rank(&tile_total, threadIdx.x)
                  : T(0);
  T all;
  const T excl = block_exclusive_scan(v, sums, all);
  if (static_cast<int>(threadIdx.x) < nb) offsets[threadIdx.x] = T(0) + excl;
  __syncthreads();
  auto csum = [&](int64_t p) -> T {
    if (p <= 0) return T(0);
    const int rank = static_cast<int>((p - 1) / kTile);
    return cluster.map_shared_rank(local, rank)[(p - 1) % kTile] + offsets[rank];
  };
  if (j0 < m) out[j0] = csum(e0) - csum(s0);
  for (int64_t j = j0 + step; j < m; j += step) out[j] = csum(end[j]) - csum(start[j]);
  cluster.sync();  // every block's shared memory stays until the others are done reading it
}

// out[s] = sum of v[idx[e]] for e in [ptr[s], ptr[s + 1]), added in list
// order with round-to-nearest adds (nothing to contract, but kept explicit).
template <typename T>
__device__ __forceinline__ T add_rn(T a, T b) { return rn::Rn<T>::add(a, b); }

// CSR lists through lane strides of their own.  A lane is blockIdx.y; its
// values are at lane * v_lane, its outputs at lane * nseg.
struct Lists {
  const int32_t* ptr;
  const int32_t* idx;
  int64_t ptr_lane;
  int64_t idx_lane;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    segment_sums(const T* __restrict__ v, int64_t v_lane, Lists lists, int64_t nseg,
                 T* __restrict__ out) {
  const int64_t lane = blockIdx.y;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (s >= nseg) return;
  v += lane * v_lane;
  out += lane * nseg;
  const int32_t* __restrict__ ptr = lists.ptr + lane * lists.ptr_lane;
  const int32_t* __restrict__ idx = lists.idx + lane * lists.idx_lane;
  T acc = T(0);
  const int32_t stop = ptr[s + 1];
  for (int32_t e = ptr[s]; e < stop; ++e) acc = add_rn(acc, v[idx[e]]);
  out[s] = acc;
}

template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b) { return rn::Rn<T>::mul(a, b); }

// List entries a thread of scaled_rmatvec gathers at once: a tree's
// covering-rows lists hold its depth (4 at the paper's fleet), a device's
// tenant list 0 or 1 entries under disjoint tenancy.
constexpr int kWalk = 4;

// The products d[ids[e]] * y[ids[e]] of list entries e = base ... base +
// kWalk - 1 below stop, each rounded; the loads of all of them go out before
// any is used.
template <typename T>
__device__ __forceinline__ void gather_products(const T* __restrict__ d, const T* __restrict__ y,
                                                const int32_t* __restrict__ ids, int32_t base,
                                                int32_t stop, T (&p)[kWalk]) {
#pragma unroll
  for (int j = 0; j < kWalk; ++j) {
    const int32_t e = base + j;
    p[j] = T(0);
    if (e < stop) {
      const int32_t r = ids[e];
      p[j] = mul_rn(d[r], y[r]);
    }
  }
}

// acc + p[0] + ... + p[count - 1], added in that order
template <typename T>
__device__ __forceinline__ T add_in_order(T acc, const T (&p)[kWalk], int32_t count) {
#pragma unroll
  for (int j = 0; j < kWalk; ++j) {
    if (j < count) acc = add_rn(acc, p[j]);
  }
  return acc;
}

// Device i's gx[i], with yi[i] = d_imp[i]*y_imp[i] in `v` and sm[i] in
// `scale`: device i walks its covering-rows list and (k > 0) its tenant
// list together, kWalk entries of each at a time, so the loads of both
// lists' entries (id, then the dual and its row scale) are in flight at
// once, and each sum still adds its own list's products d*y in list order
// from T(0), every product rounded before its add, as segment_sums over
// the products does.  The inputs come in as __restrict__ pointers and are
// read with plain loads: the compiler makes them read-only-path loads
// itself (LDG.E.CONSTANT).  A build that wrote the same loads as explicit
// __ldg got the same load instructions, scheduled worse: scaled_rmatvec
// took 3.76 us a call at the paper's tenant fleet in chip_smoke.py's phase
// 6 (NVIDIA H100 80GB HBM3, 700 W), against 3.04 for these plain loads.
template <typename T>
__device__ __forceinline__ T scaled_adjoint_at(
    const T* __restrict__ y_tree, const T* __restrict__ d_tree,
    const int32_t* __restrict__ cover_ptr, const int32_t* __restrict__ cover_rows,
    const T* __restrict__ y_sla, const T* __restrict__ d_sla, const int32_t* __restrict__ dev_ptr,
    const int32_t* __restrict__ dev_ten, const T* __restrict__ y_imp, const T* __restrict__ d_imp,
    const T* __restrict__ sm, int64_t k, int64_t i, T& v, T& scale) {
  int32_t a = cover_ptr[i];
  const int32_t a_stop = cover_ptr[i + 1];
  int32_t b = 0, b_stop = 0;
  if (k > 0) {
    b = dev_ptr[i];
    b_stop = dev_ptr[i + 1];
  }
  v = mul_rn(d_imp[i], y_imp[i]);
  scale = sm[i];
  T tree_sum = T(0);
  T sla_sum = T(0);
  for (; a < a_stop || b < b_stop; a += kWalk, b += kWalk) {
    T pt[kWalk], ps[kWalk];
    gather_products(d_tree, y_tree, cover_rows, a, a_stop, pt);
    gather_products(d_sla, y_sla, dev_ten, b, b_stop, ps);
    tree_sum = add_in_order(tree_sum, pt, a_stop - a);
    sla_sum = add_in_order(sla_sum, ps, b_stop - b);
  }
  const T g = k > 0 ? add_rn(tree_sum, sla_sum) : tree_sum;
  return mul_rn(scale, add_rn(g, v));
}

// The inputs of lane `lane` (see ScaledAdjoint).
template <typename T>
__device__ __forceinline__ ScaledAdjoint<T> adjoint_lane(ScaledAdjoint<T> p, int64_t lane) {
  p.y_tree += lane * p.m;
  p.d_tree += lane * p.m;
  p.cover_ptr += lane * p.cover_ptr_lane;
  p.cover_rows += lane * p.cover_rows_lane;
  p.y_sla += lane * p.k;
  p.d_sla += lane * p.k;
  p.dev_ptr += lane * p.dev_ptr_lane;
  p.dev_ten += lane * p.dev_ten_lane;
  p.y_imp += lane * p.n;
  p.d_imp += lane * p.n;
  p.sm += lane * p.n;
  return p;
}

// scaled_adjoint_at's arguments from a ScaledAdjoint p, and device i
#define SCALED_ADJOINT_ARGS(p, i)                                                      \
  (p).y_tree, (p).d_tree, (p).cover_ptr, (p).cover_rows, (p).y_sla, (p).d_sla, (p).dev_ptr, \
      (p).dev_ten, (p).y_imp, (p).d_imp, (p).sm, (p).k, (i)

// One thread per device of lane blockIdx.y: (gx, yi) of the scaled adjoint.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    scaled_rmatvec_kernel(ScaledAdjoint<T> p, T* __restrict__ gx, T* __restrict__ yi) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= p.n) return;
  const int64_t lane = blockIdx.y;
  p = adjoint_lane(p, lane);
  T v, scale;
  const T g = scaled_adjoint_at(SCALED_ADJOINT_ARGS(p, i), v, scale);
  yi[lane * p.n + i] = v;
  gx[lane * p.n + i] = g;
}

// One thread per device: the scaled adjoint, then the primal prox,
// extrapolation and column scaling on its gx, which never leaves the
// register.
template <typename T>
__global__ void __launch_bounds__(kRowThreads) primal_step_kernel(PrimalStepArgs<T> p) {
  const int64_t n = p.adj.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t lane = blockIdx.y;
  const int64_t li = lane * n + i;  // device i of this lane
  const T x = p.x[li];
  const T c = p.c[li];
  const T w = p.w[li];
  const T target = p.target[li];
  const T lo = p.lo[li];
  const T hi = p.hi[li];
  const T tau = p.tau[lane * p.tau_lane + i * p.tau_stride];
  const ScaledAdjoint<T> adj = adjoint_lane(p.adj, lane);
  T v, scale;
  const T g = scaled_adjoint_at(SCALED_ADJOINT_ARGS(adj, i), v, scale);
  T x1, xe;
  rn::primal_prox(x, g, c, w, target, lo, hi, tau, x1, xe);
  p.yi[li] = v;
  p.x1[li] = x1;
  p.xe[li] = xe;
  p.xm[li] = mul_rn(scale, xe);
}

// The same sums, a warp per list: the lanes gather kSlaChunk values of the
// list at a time, lane 0 adds them in list order.
template <typename T>
__global__ void __launch_bounds__(kSlaWarps * 32)
    gather_sums(const T* __restrict__ v, int64_t v_lane, Lists lists, int64_t nseg,
                T* __restrict__ out) {
  __shared__ T staged[kSlaWarps][kSlaChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kSlaWarps + warp;
  if (s >= nseg) return;  // the whole warp leaves together
  // the problem lane (blockIdx.y), not the warp lane above
  const int64_t plane = blockIdx.y;
  v += plane * v_lane;
  out += plane * nseg;
  const int32_t* __restrict__ ptr = lists.ptr + plane * lists.ptr_lane;
  const int32_t* __restrict__ idx = lists.idx + plane * lists.idx_lane;
  const int64_t begin = ptr[s];
  const int64_t stop = ptr[s + 1];
  T* buf = staged[warp];
  T vals[kSlaItems];
  auto gather = [&](int64_t base) {
#pragma unroll
    for (int i = 0; i < kSlaItems; ++i) {
      const int64_t e = base + i * 32 + lane;
      vals[i] = e < stop ? v[idx[e]] : T(0);
    }
  };
  T acc = T(0);
  if (begin < stop) gather(begin);
  for (int64_t base = begin; base < stop; base += kSlaChunk) {
#pragma unroll
    for (int i = 0; i < kSlaItems; ++i) buf[i * 32 + lane] = vals[i];
    __syncwarp();
    // the next chunk's loads go out before the adds of this one
    if (base + kSlaChunk < stop) gather(base + kSlaChunk);
    if (lane == 0) {
      const int count = static_cast<int>(stop - base < kSlaChunk ? stop - base : kSlaChunk);
#pragma unroll 8
      for (int j = 0; j < count; ++j) acc = add_rn(acc, buf[j]);
    }
    __syncwarp();
  }
  if (lane == 0) out[s] = acc;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The grid of a launch over `lanes` lanes (blockIdx.y), or an error for a
// count the grid's y axis cannot hold.
constexpr int64_t kMaxLanes = 65535;

bool lanes_ok(int64_t lanes) { return lanes >= 1 && lanes <= kMaxLanes; }

template <typename T>
int segment_sums_impl(int device, const T* v, int64_t v_lane, Lists lists, int64_t nseg,
                      int64_t lanes, T* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (nseg > 0) {
    const dim3 grid(static_cast<unsigned>(ceil_div(nseg, kRowThreads)),
                    static_cast<unsigned>(lanes));
    segment_sums<T><<<grid, kRowThreads, 0, stream>>>(v, v_lane, lists, nseg, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gather_sums_impl(int device, const T* v, int64_t v_lane, Lists lists, int64_t nseg,
                     int64_t lanes, T* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (nseg > 0) {
    const dim3 grid(static_cast<unsigned>(ceil_div(nseg, kSlaWarps)),
                    static_cast<unsigned>(lanes));
    gather_sums<T><<<grid, kSlaWarps * 32, 0, stream>>>(v, v_lane, lists, nseg, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scaled_rmatvec_impl(int device, const ScaledAdjoint<T>& p, int64_t lanes, T* gx, T* yi,
                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n > 0) {
    const dim3 grid(static_cast<unsigned>(ceil_div(p.n, kRowThreads)),
                    static_cast<unsigned>(lanes));
    scaled_rmatvec_kernel<T><<<grid, kRowThreads, 0, stream>>>(p, gx, yi);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int primal_step_impl(int device, const PrimalStepArgs<T>& p, int64_t lanes,
                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.adj.n > 0) {
    const dim3 grid(static_cast<unsigned>(ceil_div(p.adj.n, kRowThreads)),
                    static_cast<unsigned>(lanes));
    primal_step_kernel<T><<<grid, kRowThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of tree_matvec_kernel<T> the card holds at once (the cooperative
// launch's largest grid), with the most shared memory a launch asks for;
// queried once per device.
template <typename T>
cudaError_t resident_blocks(int device, int* blocks) {
  static int cache[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cache[device] > 0) {
    *blocks = cache[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tree_matvec_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (device >= 0 && device < kMaxDevices) cache[device] = *blocks;
  return cudaSuccess;
}

// Lets tree_matvec_cluster<T> run as a cluster past the portable size; once
// per device.
template <typename T>
cudaError_t allow_large_clusters(int device) {
  static bool done[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      tree_matvec_cluster<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) done[device] = true;
  return err;
}

// scratch (the cooperative path's): per lane n tile prefixes, then per lane
// nb totals, then per lane nb offsets.
template <typename T>
int tree_matvec_impl(int device, const T* x, const int32_t* start, const int32_t* end,
                     T* scratch, T* out, int64_t n, int64_t m, int64_t row_lane, int64_t lanes,
                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!lanes_ok(lanes)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = ceil_div(n, kTile);
  if (nb <= kClusterTiles) {
    const unsigned blocks = nb > 1 ? static_cast<unsigned>(nb) : 1u;
    if (blocks > kPortableCluster) {
      err = allow_large_clusters<T>(device);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks, static_cast<unsigned>(lanes));
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = 0;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, tree_matvec_cluster<T>, x, n, start, end, m, row_lane,
                             out);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  int resident = 0;
  err = resident_blocks<T>(device, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = ceil_div(lanes * m, kThreads);
  int64_t grid = lanes * nb > rows ? lanes * nb : rows;
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  T* local = scratch;
  T* totals = scratch + lanes * n;
  T* offsets = totals + lanes * nb;
  void* args[] = {&x, &n, &start, &end, &m, &row_lane, &lanes, &local, &totals, &offsets, &out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(tree_matvec_kernel<T>),
                                    dim3(static_cast<unsigned>(grid)), dim3(kThreads), args,
                                    0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile size of the scan; the wrapper sizes the scratch with it.
int tree_scan_tile() { return kTile; }

// Tiles whose blocks form one cluster; past it the launch is cooperative.
int tree_cluster_tiles() { return kClusterTiles; }

// out[j] = sum x[start_j:end_j] for each of `lanes` lanes (x [lanes, n], out
// [lanes, m]; the row ranges read at lane * row_lane); scratch holds
// lanes * (n + 2 * ceil(n / tile)) values.
int tree_matvec_f64(int device, const double* x, const int32_t* start, const int32_t* end,
                    double* scratch, double* out, int64_t n, int64_t m, int64_t row_lane,
                    int64_t lanes, void* stream) {
  return tree_matvec_impl<double>(device, x, start, end, scratch, out, n, m, row_lane, lanes,
                                  static_cast<cudaStream_t>(stream));
}

int tree_matvec_f32(int device, const float* x, const int32_t* start, const int32_t* end,
                    float* scratch, float* out, int64_t n, int64_t m, int64_t row_lane,
                    int64_t lanes, void* stream) {
  return tree_matvec_impl<float>(device, x, start, end, scratch, out, n, m, row_lane, lanes,
                                 static_cast<cudaStream_t>(stream));
}

// Segmented sums, a thread per list: out[s] = sum of v[idx[e]] over the CSR
// list of segment s, for each lane (v at lane * v_lane, out [lanes, nseg],
// the lists at lane * ptr_lane and lane * idx_lane).  tree_rmatvec passes
// (y, position lists of covering rows, n); sla_rmatvec (y, device lists of
// tenant ids, n).
int segment_sums_f64(int device, const double* v, int64_t v_lane, const int32_t* ptr,
                     int64_t ptr_lane, const int32_t* idx, int64_t idx_lane, int64_t nseg,
                     int64_t lanes, double* out, void* stream) {
  return segment_sums_impl<double>(device, v, v_lane, Lists{ptr, idx, ptr_lane, idx_lane}, nseg,
                                   lanes, out, static_cast<cudaStream_t>(stream));
}

int segment_sums_f32(int device, const float* v, int64_t v_lane, const int32_t* ptr,
                     int64_t ptr_lane, const int32_t* idx, int64_t idx_lane, int64_t nseg,
                     int64_t lanes, float* out, void* stream) {
  return segment_sums_impl<float>(device, v, v_lane, Lists{ptr, idx, ptr_lane, idx_lane}, nseg,
                                  lanes, out, static_cast<cudaStream_t>(stream));
}

// The scaled adjoint: (gx, yi) = (sm * (tree sums + tenant sums + yi),
// d_imp * y_imp) over the covering-rows and device-tenant CSR lists, for
// each lane (gx, yi [lanes, n]); the tenant lists are read only when k > 0.
// The structure is passed by value.
int scaled_rmatvec_f64(int device, ScaledAdjoint<double> p, int64_t lanes, double* gx,
                       double* yi, void* stream) {
  return scaled_rmatvec_impl<double>(device, p, lanes, gx, yi,
                                     static_cast<cudaStream_t>(stream));
}

int scaled_rmatvec_f32(int device, ScaledAdjoint<float> p, int64_t lanes, float* gx, float* yi,
                       void* stream) {
  return scaled_rmatvec_impl<float>(device, p, lanes, gx, yi, static_cast<cudaStream_t>(stream));
}

// The scaled adjoint with the primal update as its epilogue: (x1, xe, xm,
// yi), see PrimalStepArgs, for each lane; the structure is passed by value.
int primal_step_f64(int device, PrimalStepArgs<double> args, int64_t lanes, void* stream) {
  return primal_step_impl<double>(device, args, lanes, static_cast<cudaStream_t>(stream));
}

int primal_step_f32(int device, PrimalStepArgs<float> args, int64_t lanes, void* stream) {
  return primal_step_impl<float>(device, args, lanes, static_cast<cudaStream_t>(stream));
}

// The same sums, a warp per list: sla_matvec passes (x, tenant lists of
// device ids, k).
int sla_matvec_f64(int device, const double* x, int64_t v_lane, const int32_t* ptr,
                   int64_t ptr_lane, const int32_t* idx, int64_t idx_lane, int64_t k,
                   int64_t lanes, double* out, void* stream) {
  return gather_sums_impl<double>(device, x, v_lane, Lists{ptr, idx, ptr_lane, idx_lane}, k,
                                  lanes, out, static_cast<cudaStream_t>(stream));
}

int sla_matvec_f32(int device, const float* x, int64_t v_lane, const int32_t* ptr,
                   int64_t ptr_lane, const int32_t* idx, int64_t idx_lane, int64_t k,
                   int64_t lanes, float* out, void* stream) {
  return gather_sums_impl<float>(device, x, v_lane, Lists{ptr, idx, ptr_lane, idx_lane}, k,
                                 lanes, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

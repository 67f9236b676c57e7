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
// grid.  Hopper blocks run in no order, so the scan is three passes:
//   1. scan_tiles: each block scans a tile of kTile positions of x (kItems
//      per thread sequentially, then warp shuffles, then the warp totals
//      through shared memory) and writes the tile's inclusive prefix and its
//      total;
//   2. scan_totals: one block scans the per-tile totals into per-tile
//      offsets, looping over them with a carry, so any n is covered;
//   3. gather_rows reads csum at both ends of every row, adding the tile
//      offset on the fly.
//
// tree_rmatvec, and the tenant pair, are one segmented-sum kernel
// (segment_sums): one thread per output sums a CSR list that the host builds
// once per topology, in list order, with no atomics, so the same bits come
// back on every launch.  For the adjoint, position i's list holds the rows
// covering it (start_j <= i < end_j) in ascending row order: its ancestors
// in the power tree, 4 of them at the paper's fleet, so 49,152 entries in
// all (n x depth for a tree).  One launch with one load chain per position
// (list pointer, row id, dual) replaces the TPU's scatter of a difference
// array and its prefix sum, which here took three launches (measured 9.30 us
// against 2.67 us for sla_rmatvec's segment_sums at the same n, H100 80GB
// HBM3, 700 W, chip_smoke.py).  For the tenant pair the TPU version scatters
// each chunk of incidence edges into the output with `.at[].add`; on this
// card that would be fp64 atomics, whose order changes from run to run,
// and the feasibility repair and saturation tests compare these sums
// against thresholds.  The host sorts the edges into CSR lists (by tenant
// for the forward sum, by device for the adjoint; a stable sort, so each
// list keeps edge order), the order a sequential index_add_ adds in, so
// these kernels return the bits of the plain version.  At the paper's
// Appendix B fleet (k = 100 tenants, E = 10,000 edges, n = 12,288 devices) a
// call moves 0.16-0.26 MB; a thread walks at most ~100 edges, so latency of
// the dependent adds, not bytes, bounds it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// Pass 1: tile-local inclusive prefix of x over positions [0, n) into
// `local`, the tile's sum into totals[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_tiles(const T* x, int64_t n, T* local, T* totals) {
  __shared__ T sums[kWarps + 1];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile +
                       static_cast<int64_t>(threadIdx.x) * kItems;
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
    if (p < n) local[p] = off + run[i];
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Pass 2: exclusive prefix of the nb tile totals, one block with a carry.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_totals(const T* totals, int64_t nb, T* offsets) {
  __shared__ T sums[kWarps + 1];
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

// Pass 3: out[j] = csum[end_j] - csum[start_j].
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    gather_rows(const T* local, const T* offsets, const int32_t* start, const int32_t* end,
                int64_t m, T* out) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (j < m) out[j] = prefix_at(local, offsets, end[j]) - prefix_at(local, offsets, start[j]);
}

// out[s] = sum of v[idx[e]] for e in [ptr[s], ptr[s + 1]), added in list
// order with round-to-nearest adds (nothing to contract, but kept explicit).
template <typename T>
__device__ __forceinline__ T add_rn(T a, T b);
template <>
__device__ __forceinline__ double add_rn<double>(double a, double b) { return __dadd_rn(a, b); }
template <>
__device__ __forceinline__ float add_rn<float>(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
    segment_sums(const T* __restrict__ v, const int32_t* __restrict__ ptr,
                 const int32_t* __restrict__ idx, int64_t nseg, T* __restrict__ out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (s >= nseg) return;
  T acc = T(0);
  const int32_t stop = ptr[s + 1];
  for (int32_t e = ptr[s]; e < stop; ++e) acc = add_rn(acc, v[idx[e]]);
  out[s] = acc;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
int segment_sums_impl(int device, const T* v, const int32_t* ptr, const int32_t* idx,
                      int64_t nseg, T* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nseg > 0) {
    segment_sums<T><<<static_cast<unsigned>(ceil_div(nseg, kRowThreads)), kRowThreads, 0, stream>>>(
        v, ptr, idx, nseg, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tree_matvec_impl(int device, const T* x, const int32_t* start, const int32_t* end,
                     T* local, T* totals, T* offsets, T* out, int64_t n, int64_t m,
                     cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nb = ceil_div(n, kTile);
  if (nb > 0) {
    scan_tiles<T><<<static_cast<unsigned>(nb), kThreads, 0, stream>>>(x, n, local, totals);
    scan_totals<T><<<1, kThreads, 0, stream>>>(totals, nb, offsets);
  }
  if (m > 0) {
    gather_rows<T><<<static_cast<unsigned>(ceil_div(m, kRowThreads)), kRowThreads, 0, stream>>>(
        local, offsets, start, end, m, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tile size of the scan; the wrapper sizes the totals/offsets scratch with it.
int tree_scan_tile() { return kTile; }

int tree_matvec_f64(int device, const double* x, const int32_t* start, const int32_t* end,
                    double* local, double* totals, double* offsets, double* out, int64_t n,
                    int64_t m, void* stream) {
  return tree_matvec_impl<double>(device, x, start, end, local, totals, offsets, out, n, m,
                                  static_cast<cudaStream_t>(stream));
}

int tree_matvec_f32(int device, const float* x, const int32_t* start, const int32_t* end,
                    float* local, float* totals, float* offsets, float* out, int64_t n,
                    int64_t m, void* stream) {
  return tree_matvec_impl<float>(device, x, start, end, local, totals, offsets, out, n, m,
                                 static_cast<cudaStream_t>(stream));
}

// Segmented sums: out[s] = sum of v[idx[e]] over the CSR list of segment s.
// tree_rmatvec passes (y, position lists of covering rows, n); sla_matvec
// (x, tenant lists of device ids, k); sla_rmatvec (y, device lists of
// tenant ids, n).
int segment_sums_f64(int device, const double* v, const int32_t* ptr, const int32_t* idx,
                     int64_t nseg, double* out, void* stream) {
  return segment_sums_impl<double>(device, v, ptr, idx, nseg, out,
                                   static_cast<cudaStream_t>(stream));
}

int segment_sums_f32(int device, const float* v, const int32_t* ptr, const int32_t* idx,
                     int64_t nseg, float* out, void* stream) {
  return segment_sums_impl<float>(device, v, ptr, idx, nseg, out,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"

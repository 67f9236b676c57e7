// Flash attention forward (blocked online softmax), written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention/kernel.py:
//   flash_attention (_fa_kernel)
//     q [B, Sq, H, dh], k and v [B, Sk, KV, dh], H % KV == 0 -> out [B, Sq, H, dh]
//     out = softmax(mask(q k^T * dh^-0.5)) v, causal rows aligned so that the
//     last query sees the last key (offset Sk - Sq), masked logits -1e30.
//
// Arithmetic, as the Pallas kernel's: per (batch x head, query tile) the CTA
// sweeps the key tiles keeping the running max m, the running sum l and the
// accumulator acc in float32.  Logits accumulate in float32 and are scaled
// after the product; P is rounded to v's type before the PV product (its
// float32 value goes into l); out = acc / max(l, 1e-30), rounded to q's type.
// A causal row that sees no key (Sq > Sk) weighs every key alike and returns
// the mean of V, as the reference does.
// Optionally each kernel also writes the rows' log-sum-exp, lse [B, H, Sq]
// in float32 (store_lse in flash_attention.cuh): m + log(max(l, 1e-30)), the
// residual of the reference's blocked forward under its hand-written VJP
// (src/repro/models/flash_vjp.py, _fwd_impl), from which a backward
// recomputes each probability tile.  One thread per row stores it after the
// output; out is the same with or without it.
//
// GQA: query head h reads key/value head h / (H / KV) in place through the
// strides the wrapper passes (batch, sequence, head; the head dimension is
// contiguous), so K and V are never repeated in memory.
//
// What bounds it on this card: tensor-core operations.  The serving prefill
// (B = 4, Sq = Sk = 2,048, H = 32, KV = 8, dh = 128, causal) needs
// 4 B H dh Sq (Sq + 1) / 2 = 1.37e11 useful flops, 0.139 ms at 989.4 TFLOP/s
// (dense bf16), against 168 MB of q, k, v and out, 0.050 ms at 3.35 TB/s.
//
// Three kernels compute it; the wrapper picks one from the shapes and strides
// before the launch (kernels/flash_attention/kernel.py: variant):
//   fa_wgmma_kernel (flash_attention_hopper.cu), bfloat16, every built dh,
//     inputs a TMA tensor map can describe: the fast path, see that file;
//   fa_bf16_kernel (here), bfloat16 inputs no tensor map can read (a strided
//     head dim, strides or base not in 16-byte steps, heads outside
//     sequence), copied to a readable layout first;
//   fa_f32_kernel (here), float32.
//
// Design (fa_bf16_kernel, mma.sync): one CTA of 4 warps per (batch x head,
// 64-row query tile), 16 rows per warp, query tiles issued last-first so the
// longest causal tiles start first.  Each warp keeps its Q fragments in
// registers for the whole sweep.  Per 64-key tile the CTA stages K and V in
// shared memory (rows padded by 16 bytes so ldmatrix reads are
// conflict-free; keys past Sk are zero), each warp computes S = Q K^T with
// mma.sync m16n8k16 (bf16 in, f32 accumulate; K fragments by ldmatrix),
// applies the mask only on tiles that cross the diagonal or the ragged end,
// updates (m, l) with quad shuffles, converts P to bf16 A fragments in
// registers (the C layout of two n-tiles is the A layout of one k-step) and
// accumulates P V with mma.sync (V fragments by ldmatrix.trans).  Causal
// tiles above the diagonal are not visited unless a row of the tile sees no
// key at all.  What holds it back: its loads are synchronous, one tile at a
// time, so the tensor cores wait on each tile's loads, and mma.sync runs
// below wgmma's rate on this card (1.319 ms at the serving shape, 9.5x the
// bound, measured on an H100 80GB HBM3 at 700 W by chip_smoke.py).
//
// Design (fa_f32_kernel).  Float32 products stay float32, outside the tensor
// cores (no TF32), so the arithmetic is the Pallas kernel's; what bounds it is
// float32 FMAs, 67 TFLOP/s on this card: 1.09e10 useful flops at B = 1,
// Sq = Sk = 1,152, H = 32, KV = 8, dh = 128, causal, 0.162 ms.  Its
// predecessor (a CTA per 16 query rows, 32-key tiles) spent a shuffle and a
// shared load on every FMA of Q K^T and a shuffle on every key of P V, and
// fetched each K/V tile for 16 rows only: 1.331 ms there.  Now one CTA of
// 256 threads (a 16 x 16 grid, ty x tx) per (batch x head, 64-row query
// tile), 64-key tiles, register blocking:
//   - Q (once) and K sit in shared memory row-major, rows padded by 4 floats;
//     thread (ty, tx) computes the 4 x 4 block of S for rows 4 ty .. 4 ty + 3
//     and keys tx + 16 j: per 4 head-dim columns, four float4 loads of Q (one
//     address per half warp: a broadcast) and four of K feed 64 FMAs;
//   - a row's 64 logits lie across the 16 threads of a half warp: its max
//     and sum take four xor shuffles each; m, l and the rescale of O stay in
//     registers;
//   - P goes to shared memory transposed (key-major), so that P V reads the
//     thread's four rows of one key as one float4; O is 4 rows x dh / 16
//     columns per thread (column pairs 2 tx + 32 c), per key one float4 of P
//     and dh / 32 float2 loads of V feed dh / 4 FMAs;
//   - K and V of the next tile load with cp.async into the other of two
//     stages while this tile is in use (zero-filled past Sk).
// Causal tiles past the CTA's last visible key are not visited unless a row
// of the tile sees no key at all; the mask applies only on tiles that cross
// the diagonal or the ragged end.  Shared memory: 225 KB at dh 160, one CTA
// per SM.
#include "flash_attention.cuh"

namespace {

using namespace fa;

constexpr int kThreads = 128;  // 4 warps

// ---------------------------------------------------------------- bfloat16

constexpr int kBq = 64;   // query rows per CTA, 16 per warp
constexpr int kBk = 64;   // keys per tile
constexpr int kPad = 8;   // bf16 elements (16 bytes) of padding per shared row

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: a 16x16 (row major), b 16x8 (column major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DH>
__global__ void __launch_bounds__(kThreads) fa_bf16_kernel(const FaArgs a) {
  static_assert(DH % 16 == 0, "head_dim must be a multiple of 16");
  __shared__ __align__(16) __nv_bfloat16 ks[kBk][DH + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kBk][DH + kPad];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, column pair
  const Tile tl = tile_of(a, kBq);
  const int64_t off = a.Sk - a.Sq;
  const auto* qp = static_cast<const __nv_bfloat16*>(a.q) + tl.b * a.sq_b + tl.h * a.sq_h;
  const auto* kp = static_cast<const __nv_bfloat16*>(a.k) + tl.b * a.sk_b + tl.kvh * a.sk_h;
  const auto* vp = static_cast<const __nv_bfloat16*>(a.v) + tl.b * a.sv_b + tl.kvh * a.sv_h;
  const int64_t r0 = tl.q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  // Q as A fragments, one per 16-wide k-step; rows past Sq read as zero
  uint32_t qf[DH / 16][4];
  auto q2 = [&](int64_t row, int col) -> uint32_t {
    return row < a.Sq ? *reinterpret_cast<const uint32_t*>(qp + row * a.sq_s + col) : 0u;
  };
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = q2(r0, c);
    qf[kk][1] = q2(r1, c);
    qf[kk][2] = q2(r0, c + 8);
    qf[kk][3] = q2(r1, c + 8);
  }

  float o[DH / 8][4];  // C fragments: 8 head-dim columns each
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int64_t end = kv_end(a, tl.q0, kBq);
  for (int64_t k0 = 0; k0 < end; k0 += kBk) {
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kChunks = kBk * DH / 8;  // 16-byte chunks per tile
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int row = c / (DH / 8), col = (c % (DH / 8)) * 8;
      const int64_t key = k0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key < a.Sk) {
        kx = *reinterpret_cast<const uint4*>(kp + key * a.sk_s + col);
        vx = *reinterpret_cast<const uint4*>(vp + key * a.sv_s + col);
      }
      *reinterpret_cast<uint4*>(&ks[row][col]) = kx;
      *reinterpret_cast<uint4*>(&vs[row][col]) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: 8 n-tiles of 8 keys
    float s[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBk / 16; ++np) {
        // matrices: keys +0..7 / dims +0..7, keys +0..7 / dims +8..15,
        // keys +8..15 / dims +0..7, keys +8..15 / dims +8..15
        uint32_t b[4];
        ldmatrix_x4(b, &ks[np * 16 + (lane & 7) + ((lane >> 4) << 3)]
                          [kk * 16 + (((lane >> 3) & 1) << 3)]);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    const bool edge = k0 + kBk > a.Sk || (a.causal && k0 + kBk - 1 > tl.q0 + off);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * a.scale;
        if (edge) x = masked(x, e < 2 ? r0 : r1, k0 + nt * 8 + 2 * t + (e & 1), a);
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four threads of a row group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mx0);
      s[nt][1] = __expf(s[nt][1] - mx0);
      s[nt][2] = __expf(s[nt][2] - mx1);
      s[nt][3] = __expf(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float c0 = __expf(m0 - mx0), c1 = __expf(m1 - mx1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[nd][0] *= c0;
      o[nd][1] *= c0;
      o[nd][2] *= c1;
      o[nd][3] *= c1;
    }

    // O += P V: P's C fragments of n-tiles 2kk, 2kk+1 are the A fragment of
    // k-step kk (16 keys)
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        // transposed matrices: keys +0..7 / dims +0..7, keys +8..15 / dims
        // +0..7, keys +0..7 / dims +8..15, keys +8..15 / dims +8..15
        uint32_t b[4];
        ldmatrix_x4_trans(b, &vs[kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)]
                                [np * 16 + ((lane >> 4) << 3)]);
        mma_bf16(o[2 * np], pa, b[0], b[1]);
        mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

  auto* op = static_cast<__nv_bfloat16*>(a.o) + tl.b * a.so_b + tl.h * a.so_h;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r0 < a.Sq)
      *reinterpret_cast<uint32_t*>(op + r0 * a.so_s + col) = pack_bf16(o[nd][0] / d0, o[nd][1] / d0);
    if (r1 < a.Sq)
      *reinterpret_cast<uint32_t*>(op + r1 * a.so_s + col) = pack_bf16(o[nd][2] / d1, o[nd][3] / d1);
  }
  if (t == 0) {  // the four threads of a row group hold the same m and l
    store_lse(a, tl, r0, m0, l0);
    store_lse(a, tl, r1, m1, l1);
  }
}

// ---------------------------------------------------------------- float32

constexpr int kRowsF32 = 64;       // query rows per CTA
constexpr int kKeysF32 = 64;       // keys per tile
constexpr int kThreadsF32 = 256;   // a 16 x 16 grid of threads (ty, tx)
constexpr int kLdP = kKeysF32 + 4;  // a row of P^T, padded: STS.128 across tx without conflicts

// Shared memory of the float32 kernel, in floats: Q [64][DH + 4], two K
// stages [64][DH + 4], two V stages [64][DH], P^T [64 keys][68 rows].  The
// 4-float pad keeps Q and K rows 16-byte aligned and puts consecutive rows
// 4 banks apart, so eight threads reading float4s of eight consecutive rows
// touch 32 different banks.
template <int DH>
struct SmemF32 {
  static constexpr int kLd = DH + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kRowsF32 * kLd;
  static constexpr int kV = kK + 2 * kKeysF32 * kLd;
  static constexpr int kP = kV + 2 * kKeysF32 * DH;
  static constexpr int kBytes = 4 * (kP + kKeysF32 * kLdP);
  static_assert(kBytes <= 232448, "a CTA holds at most 227 KB of shared memory");
};

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 writes
// zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + 64) of a [S, DH] slice (row stride ld_g) into a
// [64][ld_s] shared array; rows past S are zeros
template <int DH>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld_s, const float* src, int64_t ld_g,
                                              int64_t row0, int64_t S) {
  constexpr int kChunks = kRowsF32 * DH / 4;
  for (int c = threadIdx.x; c < kChunks; c += kThreadsF32) {
    const int row = c / (DH / 4), col = (c % (DH / 4)) * 4;
    const bool in = row0 + row < S;
    cp_async16(dst + row * ld_s + col, in ? src + (row0 + row) * ld_g + col : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int s = 8; s > 0; s /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int s = 8; s > 0; s /= 2) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int DH>
__global__ void __launch_bounds__(kThreadsF32, 1) fa_f32_kernel(const FaArgs a) {
  static_assert(DH % 32 == 0, "head_dim must be a multiple of 32");
  using L = SmemF32<DH>;
  constexpr int C = DH / 32;  // column pairs per thread in O
  extern __shared__ __align__(16) float smf[];
  float* qs = smf + L::kQ;
  float* pt = smf + L::kP;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // a half warp shares ty
  const Tile tl = tile_of(a, kRowsF32);
  const float* qp = static_cast<const float*>(a.q) + tl.b * a.sq_b + tl.h * a.sq_h;
  const float* kp = static_cast<const float*>(a.k) + tl.b * a.sk_b + tl.kvh * a.sk_h;
  const float* vp = static_cast<const float*>(a.v) + tl.b * a.sv_b + tl.kvh * a.sv_h;
  const int64_t row0 = tl.q0 + 4 * ty;  // this thread's rows: row0 .. row0 + 3
  const int64_t off = a.Sk - a.Sq;
  const int64_t end = kv_end(a, tl.q0, kRowsF32);
  const int n_tiles = static_cast<int>((end + kKeysF32 - 1) / kKeysF32);

  // Q and the first K/V tile in one group
  load_rows_f32<DH>(qs, L::kLd, qp, a.sq_s, tl.q0, a.Sq);
  load_rows_f32<DH>(smf + L::kK, L::kLd, kp, a.sk_s, 0, a.Sk);
  load_rows_f32<DH>(smf + L::kV, DH, vp, a.sv_s, 0, a.Sk);
  cp_async_commit();

  float o[4][2 * C];  // rows row0 + i, columns 2 tx + 32 c and + 1
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 2 * C; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int64_t k0 = static_cast<int64_t>(t) * kKeysF32;
    if (t + 1 < n_tiles) {  // the next tile streams in while this one is used
      const int nb = buf ^ 1;
      load_rows_f32<DH>(smf + L::kK + nb * kKeysF32 * L::kLd, L::kLd, kp, a.sk_s, k0 + kKeysF32, a.Sk);
      load_rows_f32<DH>(smf + L::kV + nb * kKeysF32 * DH, DH, vp, a.sv_s, k0 + kKeysF32, a.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = smf + L::kK + buf * kKeysF32 * L::kLd;
    const float* vs = smf + L::kV + buf * kKeysF32 * DH;

    // S = Q K^T: rows row0 + i, keys k0 + tx + 16 j; per 4 head-dim columns
    // two sets of four LDS.128 feed 64 FMAs
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * L::kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * L::kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }

    // online softmax: a row's 64 keys lie across the 16 threads of a half warp
    const bool edge = k0 + kKeysF32 > a.Sk || (a.causal && k0 + kKeysF32 - 1 > tl.q0 + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = sc[i][j] * a.scale;
        if (edge) x = masked(x, row0 + i, k0 + tx + 16 * j, a);
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - mx);
        sum += sc[i][j];
      }
      const float corr = expf(m[i] - mx);
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 2 * C; ++c) o[i][c] *= corr;
    }
    // P^T: key-major, this thread's four rows side by side
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * kLdP + 4 * ty) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

    // O += P V: per key one LDS.128 of P and C LDS.64 of V feed 8 C FMAs
#pragma unroll 4
    for (int j = 0; j < kKeysF32; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pt + j * kLdP + 4 * ty);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 v = *reinterpret_cast<const float2*>(vs + j * DH + 2 * tx + 32 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][2 * c] = fmaf(pr[i], v.x, o[i][2 * c]);
          o[i][2 * c + 1] = fmaf(pr[i], v.y, o[i][2 * c + 1]);
        }
      }
    }
    __syncthreads();  // K, V and P of this tile are free for the next loads
  }

  float* op = static_cast<float*>(a.o) + tl.b * a.so_b + tl.h * a.so_h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + i;
    if (tx == 0) store_lse(a, tl, row, m[i], l[i]);  // the half warp holds one m and l
    if (row >= a.Sq) continue;
    const float d = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      *reinterpret_cast<float2*>(op + row * a.so_s + 2 * tx + 32 * c) =
          make_float2(o[i][2 * c] / d, o[i][2 * c + 1] / d);
  }
}

// ---------------------------------------------------------------- launch

// kernels are built for these head dims (the wrapper's HEAD_DIMS); another returns
// cudaErrorInvalidValue
template <template <int> class Launch>
int dispatch_head_dim(int64_t dh, const FaArgs& a, unsigned blocks, cudaStream_t stream) {
  switch (dh) {
    case 32: Launch<32>::run(a, blocks, stream); break;
    case 64: Launch<64>::run(a, blocks, stream); break;
    case 128: Launch<128>::run(a, blocks, stream); break;
    case 160: Launch<160>::run(a, blocks, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
struct LaunchBf16 {
  static void run(const FaArgs& a, unsigned blocks, cudaStream_t s) {
    fa_bf16_kernel<DH><<<blocks, kThreads, 0, s>>>(a);
  }
};

template <int DH>
struct LaunchF32 {
  static void run(const FaArgs& a, unsigned blocks, cudaStream_t s) {
    // above 48 KB of dynamic shared memory only once allowed; a refusal is
    // the runtime's last error, which the caller returns
    if (cudaFuncSetAttribute(fa_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SmemF32<DH>::kBytes) != cudaSuccess)
      return;
    fa_f32_kernel<DH><<<blocks, kThreadsF32, SmemF32<DH>::kBytes, s>>>(a);
  }
};

template <template <int> class Launch>
int flash_attention_impl(int device, const void* q, const void* k, const void* v, void* o,
                         float* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                         int64_t dh, const int64_t* strides, float scale, int causal, int rows,
                         cudaStream_t stream) {
  FaArgs a;
  if (!make_args(a, q, k, v, o, lse, B, Sq, Sk, H, KV, strides, scale, causal, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch_head_dim<Launch>(dh, a, static_cast<unsigned>(a.n_q_tiles) * a.bh, stream);
}

}  // namespace

extern "C" {

// lse: a float32 [B, H, Sq] array for the rows' log-sum-exp, or null
int flash_attention_mma(int device, const void* q, const void* k, const void* v, void* o,
                        float* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                        int64_t dh, const int64_t* strides, float scale, int causal,
                        cudaStream_t stream) {
  return flash_attention_impl<LaunchBf16>(device, q, k, v, o, lse, B, Sq, Sk, H, KV, dh, strides,
                                          scale, causal, kBq, stream);
}

int flash_attention_f32(int device, const void* q, const void* k, const void* v, void* o,
                        float* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                        int64_t dh, const int64_t* strides, float scale, int causal,
                        cudaStream_t stream) {
  return flash_attention_impl<LaunchF32>(device, q, k, v, o, lse, B, Sq, Sk, H, KV, dh, strides,
                                         scale, causal, kRowsF32, stream);
}

}  // extern "C"

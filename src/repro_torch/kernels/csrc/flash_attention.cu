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
//   fa_wgmma_kernel (flash_attention_hopper.cu), bfloat16, dh 64 and 128,
//     inputs a TMA tensor map can describe: the fast path, see that file;
//   fa_bf16_kernel (here), bfloat16, every built dh (32 and 160 need it);
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
// Design (float32, no tensor cores, so the arithmetic stays float32 as the
// Pallas kernel's does): one CTA of 4 warps per (batch x head, 16-row query
// tile), 4 rows per warp, 32-key tiles in shared memory; lane j computes the
// logit of key j (the query broadcast by shuffles), the warp reduces m and l,
// and each lane accumulates dh / 32 output columns.
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
}

// ---------------------------------------------------------------- float32

constexpr int kRowsF32 = 16;  // query rows per CTA, 4 per warp
constexpr int kKeysF32 = 32;  // keys per tile: one per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s /= 2) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) fa_f32_kernel(const FaArgs a) {
  static_assert(DH % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int C = DH / 32;  // head-dim columns per lane
  constexpr int R = kRowsF32 / 4;
  __shared__ float ks[kKeysF32][DH + 1];  // +1: lane j reads row j without conflicts
  __shared__ __align__(16) float vs[kKeysF32][DH];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Tile tl = tile_of(a, kRowsF32);
  const float* qp = static_cast<const float*>(a.q) + tl.b * a.sq_b + tl.h * a.sq_h;
  const float* kp = static_cast<const float*>(a.k) + tl.b * a.sk_b + tl.kvh * a.sk_h;
  const float* vp = static_cast<const float*>(a.v) + tl.b * a.sv_b + tl.kvh * a.sv_h;
  const int64_t row0 = tl.q0 + warp * R;

  float qv[R][C], acc[R][C], m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = row0 + i;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qv[i][c] = row < a.Sq ? qp[row * a.sq_s + lane + 32 * c] : 0.f;
      acc[i][c] = 0.f;
    }
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  const int64_t end = kv_end(a, tl.q0, kRowsF32);
  for (int64_t k0 = 0; k0 < end; k0 += kKeysF32) {
    __syncthreads();
    constexpr int kChunks = kKeysF32 * DH / 4;  // 16-byte chunks per tile
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int row = c / (DH / 4), col = (c % (DH / 4)) * 4;
      const int64_t key = k0 + row;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < a.Sk) {
        kx = *reinterpret_cast<const float4*>(kp + key * a.sk_s + col);
        vx = *reinterpret_cast<const float4*>(vp + key * a.sv_s + col);
      }
      ks[row][col] = kx.x;
      ks[row][col + 1] = kx.y;
      ks[row][col + 2] = kx.z;
      ks[row][col + 3] = kx.w;
      *reinterpret_cast<float4*>(&vs[row][col]) = vx;
    }
    __syncthreads();

    const int64_t key = k0 + lane;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          dot = fmaf(__shfl_sync(0xffffffffu, qv[i][c], j), ks[lane][32 * c + j], dot);
        }
      }
      const float x = masked(dot * a.scale, row0 + i, key, a);
      const float mx = fmaxf(m[i], warp_max(x));
      const float p = expf(x - mx);
      const float corr = expf(m[i] - mx);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= corr;
#pragma unroll 8
      for (int j = 0; j < kKeysF32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pj, vs[j][32 * c + lane], acc[i][c]);
      }
    }
  }

  float* op = static_cast<float*>(a.o) + tl.b * a.so_b + tl.h * a.so_h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = row0 + i;
    if (row >= a.Sq) continue;
    const float d = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) op[row * a.so_s + lane + 32 * c] = acc[i][c] / d;
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
    fa_f32_kernel<DH><<<blocks, kThreads, 0, s>>>(a);
  }
};

template <template <int> class Launch>
int flash_attention_impl(int device, const void* q, const void* k, const void* v, void* o,
                         int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t dh,
                         const int64_t* strides, float scale, int causal, int rows,
                         cudaStream_t stream) {
  FaArgs a;
  if (!make_args(a, q, k, v, o, B, Sq, Sk, H, KV, strides, scale, causal, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch_head_dim<Launch>(dh, a, static_cast<unsigned>(a.n_q_tiles) * a.bh, stream);
}

}  // namespace

extern "C" {

int flash_attention_mma(int device, const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t dh,
                        const int64_t* strides, float scale, int causal, cudaStream_t stream) {
  return flash_attention_impl<LaunchBf16>(device, q, k, v, o, B, Sq, Sk, H, KV, dh, strides,
                                          scale, causal, kBq, stream);
}

int flash_attention_f32(int device, const void* q, const void* k, const void* v, void* o,
                        int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV, int64_t dh,
                        const int64_t* strides, float scale, int causal, cudaStream_t stream) {
  return flash_attention_impl<LaunchF32>(device, q, k, v, o, B, Sq, Sk, H, KV, dh, strides,
                                         scale, causal, kRowsF32, stream);
}

}  // extern "C"

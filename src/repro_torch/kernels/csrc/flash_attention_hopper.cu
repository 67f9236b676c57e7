// Flash attention forward for Hopper (sm_90a): TMA loads, wgmma products and
// warp specialisation.  The bfloat16 path for every built head dim: 32, 64,
// 128 and 160.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention/kernel.py:
//   flash_attention (_fa_kernel), as flash_attention.cu's kernels do, with the
//   same arithmetic (flash_attention.cu's head): logits accumulated in float32
//   and scaled after the product, keys past Sk at -inf and causally hidden
//   keys at -1e30, P rounded to bfloat16 before P V with its float32 value in
//   l, out = acc / max(l, 1e-30), a causal row that sees no key returns the
//   mean of V.  GQA reads kv head h / (H / KV) in place (the tensor maps
//   carry the caller's batch, sequence and head strides).
//
// What bounds it on this card: tensor-core operations.  The qwen3-4b serving
// prefill (B = 4, Sq = Sk = 2,048, H = 32, KV = 8, dh = 128, causal) needs
// 1.37e11 useful flops, 0.139 ms at 989.4 TFLOP/s dense bf16, against
// 168 MB of q, k, v and out, 0.050 ms at 3.35 TB/s; stablelm-12b's (the same
// at dh = 160) 1.72e11 flops, 0.174 ms, against 210 MB, 0.063 ms.  The
// mma.sync kernel took 1.319 ms at the first (H100 80GB HBM3, 700 W):
// synchronous loads left the tensor cores idle, and mma.sync cannot reach
// their full rate.
//
// Design.  One CTA of three warpgroups per (batch x head, 128-row query
// tile), query tiles issued last-first (tile_of) so the longest causal
// sweeps start first:
//   - warpgroup 0, the producer, gives up registers (setmaxnreg) and one of
//     its threads issues every load with TMA: the Q tile once, then K and V
//     tiles of 128 keys through a ring of kStages shared-memory stages, each
//     with a "full" mbarrier (the TMA's bytes arrived) and an "empty" one
//     (both consumers are done with it).  Tensor maps are 4-D over (head
//     dim, heads, sequence, batch) with the caller's strides; a tile is a
//     row of boxes of 128 rows each (Layout below).  Rows past Sq or Sk
//     arrive as zeros.
//   - warpgroups 1 and 2, the consumers, take more registers and own 64
//     query rows each.  Per key tile: S = Q K^T with wgmma m64n128k16 (A = Q
//     and B = K from shared memory, both K-major, swizzled descriptors; at
//     dh 160 two S tiles of 64 keys, m64n64k16, each through the steps below),
//     the mask only on tiles that cross the diagonal or the ragged end, the
//     online softmax in registers on the accumulator layout (row max and sum
//     by quad shuffles), P converted to bf16 A fragments in registers (the
//     accumulator layout of two 8-key blocks is the A layout of one 16-key
//     step), then O += P V with one wgmma m64n<dh>k16 per 16 keys (A = P from
//     registers, B = the V tile read MN-major through the transpose bit, so
//     V is never transposed in memory).  After wgmma.wait_group shows that
//     the P V product has read the stage, each consumer warp arrives on its
//     empty barrier.  A consumer skips the math of tiles past its own rows'
//     causal limit (they would add exact zeros) but still waits and arrives,
//     which keeps the ring's phases in step.
//   - the epilogue divides by max(l, 1e-30) and stores bf16 pairs row by row
//     (rows past Sq are not written); when asked, one thread of each row's
//     quad also stores the row's log-sum-exp m + log(l) (store_lse), what a
//     backward needs to recompute the probabilities.
//
// Head dims 32 and 160.  A 160-column row is 320 bytes, not a whole number
// of 128-byte swizzle spans, and padding the tile to 192 columns does not fit
// (Q plus two K and two V stages of 48 KB: 240 KB of the 227 KB).  So dh 32
// and 160 take boxes of 32 columns (64 bytes) with the 64-byte swizzle, 1
// and 5 boxes, rather than two 128-byte boxes and a 64-byte tail: one
// tensor-map layout and one descriptor kind per head dim, and P V stays one
// wgmma per 16 keys (n160, n32), the B descriptor stepping from one
// 32-column box to the next by its leading offset.  Eight 64-byte rows of
// the 64-byte swizzle put a 16-byte column chunk in eight different bank
// groups, as the 128-byte swizzle does, so wgmma reads them without
// conflicts.  At dh 160 a tile is 40 KB and Q plus the ring take 200 KB.
// A consumer thread holds 80 floats of O there; with a 128-key S tile (64
// floats of S, 32 words of P) ptxas spilled 528 bytes and serialised the
// wgmmas, so the stage's 128 keys go through S, softmax and P V as two
// 64-key S tiles (32 floats of S, 16 words of P).
// Not yet: overlap of one tile's softmax with the next tile's Q K^T (the
// two consumers only overlap each other), persistent CTAs, clusters.
#include <cuda.h>  // CUtensorMap and the cuTensorMapEncodeTiled types

#include "flash_attention.cuh"

namespace {

using namespace fa;

constexpr int kRows = 128;    // query rows per CTA, 64 per consumer warpgroup
constexpr int kKeys = 128;    // keys per tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreadsWs = 384;              // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65,536
static_assert(kRows == kKeys, "Q, K and V tiles share one box shape");

// How a tile of DH columns lies in shared memory: boxes of kRows rows, each
// row one swizzle span.  Head dims 64 and 128 take 64-column boxes (128-byte
// rows, the 128-byte swizzle), 32 and 160 take 32-column boxes (64-byte
// rows, the 64-byte swizzle).  An 8-row group is one swizzle atom: the
// descriptors' stride offset.
template <int DH>
struct Layout {
  static constexpr int kBoxCols = DH % 64 == 0 ? 64 : 32;
  static constexpr int kRowBytes = 2 * kBoxCols;
  static constexpr int kBoxes = DH / kBoxCols;
  static constexpr int kBoxBytes = kRows * kRowBytes;
  static constexpr int kGroupBytes = 8 * kRowBytes;
  static constexpr int kStepsPerRow = kRowBytes / 32;  // 16-column k steps per box row
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte swizzle
  static constexpr uint64_t kDescLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // keys per S tile: the whole 128-key stage, or at dh 160 two S tiles of 64
  // keys, so that a consumer thread holds 80 floats of O beside 32 of S and
  // 16 words of P (with 64 of S, ptxas spilled and serialised the wgmmas)
  static constexpr int kSKeys = DH > 128 ? 64 : kKeys;
  static_assert(DH % kBoxCols == 0 && DH % 16 == 0, "head_dim must fill whole boxes");
};

// Shared memory, offsets from a 1024-byte aligned base (the swizzle repeats
// every 8 rows, and wgmma reads the pattern from the address bits).
template <int DH>
struct Smem {
  static constexpr int kTile = Layout<DH>::kBoxes * Layout<DH>::kBoxBytes;  // one Q, K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;              // kStages K tiles
  static constexpr int kV = kK + kStages * kTile;    // kStages V tiles
  static constexpr int kBar = kV + kStages * kTile;  // q_full, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "a CTA holds at most 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts 2^36 clocks (tens of seconds) traps, so that a broken ring
// surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 36)) __trap();
  }
}

// ---------------------------------------------------------------- TMA

// One box of the 4-D map at (head-dim column, head, row, batch) into dst,
// its bytes reported to bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor for a swizzled layout: start address,
// leading and stride byte offsets (all in 16-byte units), layout type
// (Layout::kDescLayout).  K-major (Q, K): rows of one swizzle span, 8-row
// groups one atom apart (stride offset); the leading offset is unused.
// MN-major (V read transposed): the stride offset steps 8 keys (one atom),
// the leading offset steps to the next box of head-dim columns.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lead >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((stride >> 4) & 0x3fff) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d = a b (accumulate 0) or d += a b, m64n128k16: a and b from shared memory
// (descriptors), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = a b (accumulate 0) or d += a b, m64n64k16: a and b from shared memory
// (descriptors), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a b, m64n128k16: a from registers (bf16 pairs), b from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b, m64n64k16: a from registers (bf16 pairs), b from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b, m64n160k16: a from registers (bf16 pairs), b from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, "
      "%82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b, m64n32k16: a from registers (bf16 pairs), b from shared memory,
// MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, "
      "1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NS>
struct SS;  // S = Q K^T over one S tile of NS keys, one 16-column step
template <>
struct SS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    wgmma_ss_n128(d, da, db, acc);
  }
};
template <>
struct SS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    wgmma_ss_n64(d, da, db, acc);
  }
};

template <int DH>
struct PV;  // O += P V for one 16-key step, by head dim
template <>
struct PV<128> {
  static __device__ __forceinline__ void run(float (&o)[64], const uint32_t (&p)[4], uint64_t d) {
    wgmma_rs_n128(o, p, d);
  }
};
template <>
struct PV<64> {
  static __device__ __forceinline__ void run(float (&o)[32], const uint32_t (&p)[4], uint64_t d) {
    wgmma_rs_n64(o, p, d);
  }
};
template <>
struct PV<160> {
  static __device__ __forceinline__ void run(float (&o)[80], const uint32_t (&p)[4], uint64_t d) {
    wgmma_rs_n160(o, p, d);
  }
};
template <>
struct PV<32> {
  static __device__ __forceinline__ void run(float (&o)[16], const uint32_t (&p)[4], uint64_t d) {
    wgmma_rs_n32(o, p, d);
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreadsWs, 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const FaArgs a) {
  using L = Smem<DH>;
  using T = Layout<DH>;
  constexpr int NS = T::kSKeys;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8;                // full[s] at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;      // empty[s] at empty0 + 8 s
  const Tile tl = tile_of(a, kRows);
  const int64_t end = kv_end(a, tl.q0, kRows);
  const int n_tiles = static_cast<int>((end + kKeys - 1) / kKeys);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int q0 = static_cast<int>(tl.q0);
      mbar_expect_tx(q_full, L::kTile);
#pragma unroll
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(base + L::kQ + c * T::kBoxBytes, &tq, q_full, c * T::kBoxCols, tl.h, q0, tl.b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // the stage's previous tile (t - kStages) has been released; the
        // first kStages waits pass at once (parity of the phase before 0)
        mbar_wait(empty0 + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c) {
          tma_load(base + L::kK + s * L::kTile + c * T::kBoxBytes, &tk, full0 + 8 * s,
                   c * T::kBoxCols, tl.kvh, t * kKeys, tl.b);
          tma_load(base + L::kV + s * L::kTile + c * T::kBoxBytes, &tv, full0 + 8 * s,
                   c * T::kBoxCols, tl.kvh, t * kKeys, tl.b);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;  // this warpgroup's 64 rows: [q0 + 64 cw, q0 + 64 cw + 64)
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;  // accumulator row group, column pair
    const int64_t off = a.Sk - a.Sq;
    const int64_t first = tl.q0 + 64 * cw;
    const int64_t r0 = first + 16 * warp + g, r1 = r0 + 8;  // this thread's two rows
    // keys past this warpgroup's causal limit add exact zeros (its rows have
    // seen key 0, so m is finite and exp(-1e30 - m) = 0); rows past Sq are
    // not stored
    const int64_t my_end = first >= a.Sq ? 0 : kv_end(a, first, 64);

    // descriptors at stage 0 / k-step 0; steps add (bytes >> 4) to the
    // start address
    const uint64_t dq =
        smem_desc(base + L::kQ + cw * 64 * T::kRowBytes, 16, T::kGroupBytes, T::kDescLayout);
    const uint64_t dk = smem_desc(base + L::kK, 16, T::kGroupBytes, T::kDescLayout);
    const uint64_t dv = smem_desc(base + L::kV, T::kBoxBytes, T::kGroupBytes, T::kDescLayout);

    float o[DH / 2];  // accumulator: DH / 8 blocks of 8 columns, 4 values each
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int64_t k0 = static_cast<int64_t>(t) * kKeys;
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);
#pragma unroll
      for (int h = 0; h < kKeys / NS; ++h) {
        const int64_t kh = k0 + h * NS;  // the S tile's first key
        if (kh >= my_end) break;
        // S = Q K^T: NS keys, DH / 16 steps of 16 head-dim columns (32
        // bytes within a swizzled box row: 4 steps per 128-byte row, 2 per
        // 64-byte row)
        float sacc[NS / 2];
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) sacc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint32_t step =
              (kk / T::kStepsPerRow) * T::kBoxBytes + (kk % T::kStepsPerRow) * 32;
          SS<NS>::run(sacc, dq + (step >> 4),
                      dk + ((s * L::kTile + h * NS * T::kRowBytes + step) >> 4), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();

        // online softmax: block j of 8 keys holds (row g: keys 8j + 2t4, +1)
        // in sacc[4j], sacc[4j + 1] and (row g + 8: same keys) in
        // sacc[4j + 2], sacc[4j + 3]
        const bool edge = kh + NS > a.Sk || (a.causal && kh + NS - 1 > first + off);
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sacc[4 * j + e] * a.scale;
            if (edge) x = masked(x, e < 2 ? r0 : r1, kh + 8 * j + 2 * t4 + (e & 1), a);
            sacc[4 * j + e] = x;
          }
          mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 8; ++j) {
          sacc[4 * j] = __expf(sacc[4 * j] - mx0);
          sacc[4 * j + 1] = __expf(sacc[4 * j + 1] - mx0);
          sacc[4 * j + 2] = __expf(sacc[4 * j + 2] - mx1);
          sacc[4 * j + 3] = __expf(sacc[4 * j + 3] - mx1);
          sum0 += sacc[4 * j] + sacc[4 * j + 1];
          sum1 += sacc[4 * j + 2] + sacc[4 * j + 3];
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
        for (int j = 0; j < DH / 8; ++j) {
          o[4 * j] *= c0;
          o[4 * j + 1] *= c0;
          o[4 * j + 2] *= c1;
          o[4 * j + 3] *= c1;
        }

        // P as bf16 A fragments: 16-key step kk is blocks 2kk and 2kk + 1;
        // they stay untouched until the products that read them are done
        uint32_t p[NS / 16][4];
#pragma unroll
        for (int kk = 0; kk < NS / 16; ++kk) {
          p[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
          p[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          p[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          p[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
        // O += P V: 16 keys (two 8-row atoms) per step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NS / 16; ++kk)
          PV<DH>::run(o, p[kk],
                      dv + ((s * L::kTile + (h * NS + kk * 16) * T::kRowBytes) >> 4));
        wgmma_commit();
        wgmma_wait_all();
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp is done with stage s
    }

    auto* op = static_cast<__nv_bfloat16*>(a.o) + tl.b * a.so_b + tl.h * a.so_h;
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (r0 < a.Sq)
        *reinterpret_cast<uint32_t*>(op + r0 * a.so_s + col) = pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (r1 < a.Sq)
        *reinterpret_cast<uint32_t*>(op + r1 * a.so_s + col) =
            pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
    if (t4 == 0) {  // the four threads of a row group hold the same m and l
      store_lse(a, tl, r0, m0, l0);
      store_lse(a, tl, r1, m1, l1);
    }
  }
}

// ---------------------------------------------------------------- launch

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map (head dim, heads, sequence, batch) of a [B, S, heads, DH]
// bfloat16 tensor with element strides (batch, sequence, head), boxes of
// Layout<DH>::kBoxCols columns x 1 head x 128 rows, swizzled, zeros out of
// bounds.
template <int DH>
CUresult encode(CUtensorMap* map, const void* ptr, int64_t B, int64_t S, int64_t heads,
                int64_t s_b, int64_t s_s, int64_t s_h) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_s) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {Layout<DH>::kBoxCols, 1, kRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, Layout<DH>::kSwizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DH>
int launch_wgmma(const FaArgs& a, int64_t B, int64_t KV, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  CUresult r = encode<DH>(&tq, a.q, B, a.Sq, a.H, a.sq_b, a.sq_s, a.sq_h);
  if (r == CUDA_SUCCESS) r = encode<DH>(&tk, a.k, B, a.Sk, KV, a.sk_b, a.sk_s, a.sk_h);
  if (r == CUDA_SUCCESS) r = encode<DH>(&tv, a.v, B, a.Sk, KV, a.sv_b, a.sv_s, a.sv_h);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(fa_wgmma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<DH>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fa_wgmma_kernel<DH><<<static_cast<unsigned>(a.n_q_tiles) * a.bh, kThreadsWs, Smem<DH>::kBytes,
                        stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The Hopper kernel: bfloat16, dh 32, 64, 128 or 160, Sk >= 1, 16-byte aligned
// pointers and strides whose tensor maps the driver accepts (the wrapper
// checks all of it first); lse as flash_attention.cu's entries take it.
// Returns a cudaError, or minus a CUresult if a tensor map could not be
// encoded.
int flash_attention_wgmma(int device, const void* q, const void* k, const void* v, void* o,
                          float* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                          int64_t dh, const int64_t* strides, float scale, int causal,
                          cudaStream_t stream) {
  FaArgs a;
  if (Sk < 1 ||
      !make_args(a, q, k, v, o, lse, B, Sq, Sk, H, KV, strides, scale, causal, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dh) {
    case 32: return launch_wgmma<32>(a, B, KV, stream);
    case 64: return launch_wgmma<64>(a, B, KV, stream);
    case 128: return launch_wgmma<128>(a, B, KV, stream);
    case 160: return launch_wgmma<160>(a, B, KV, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

// What the flash-attention kernels share (flash_attention.cu: the mma.sync
// bfloat16 and SIMT float32 kernels; flash_attention_hopper.cu: the
// TMA + wgmma bfloat16 kernel): the launch arguments, the CTA's tile, the
// causal sweep's end and the mask, so that every variant computes the same
// function.  See flash_attention.cu's head for the arithmetic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace fa {

constexpr float kMasked = -1e30f;  // the reference's NEG_INF for masked logits

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] row log-sum-exp, or null: not written
  int64_t sq_b, sq_s, sq_h;  // strides in elements: batch, sequence, head
  int64_t sk_b, sk_s, sk_h;
  int64_t sv_b, sv_s, sv_h;
  int64_t so_b, so_s, so_h;
  int64_t Sq, Sk;
  int H, rep;  // query heads, query heads per key/value head
  int bh;      // B * H
  int n_q_tiles;
  float scale;
  int causal;
};

struct Tile {
  int b, h, kvh;
  int64_t q0;
};

// The CTA's (batch, head, kv head, first query row); the last query tiles
// (the longest causal sweeps) get the lowest block indices.
__device__ __forceinline__ Tile tile_of(const FaArgs& a, int rows) {
  const int idx = blockIdx.x;
  const int qt = a.n_q_tiles - 1 - idx / a.bh;
  const int bh = idx % a.bh;
  const int h = bh % a.H;
  return {bh / a.H, h, h / a.rep, static_cast<int64_t>(qt) * rows};
}

// One past the last key the query rows [q0, q0 + rows) visit.  A causal row
// i sees keys j <= i + Sk - Sq; if the rows hold one that sees none, they
// visit every key (that row weighs them all alike, the others give the keys
// past their limit exactly zero weight).
__device__ __forceinline__ int64_t kv_end(const FaArgs& a, int64_t q0, int rows) {
  const int64_t off = a.Sk - a.Sq;
  if (!a.causal || q0 + off < 0) return a.Sk;
  const int64_t end = q0 + rows + off;
  return end < a.Sk ? end : a.Sk;
}

// The logit of (row, key) from its scaled product: keys past the ragged end
// take no weight at all, causally hidden keys the reference's -1e30.
__device__ __forceinline__ float masked(float x, int64_t row, int64_t key, const FaArgs& a) {
  if (key >= a.Sk) return -INFINITY;
  if (a.causal && key > row + (a.Sk - a.Sq)) return kMasked;
  return x;
}

// The row's log-sum-exp of its scaled, masked logits, m + log(max(l, 1e-30))
// in natural-log units, as the reference's blocked forward defines it
// (src/repro/models/flash_vjp.py, _fwd_impl): m is the running max of the
// logits (a row that sees no key holds -1e30, the masked value; keys past Sk
// never raise it) and l the running sum of exp(logit - m).  Written to
// lse[b, h, row] when the caller passed the array and the row exists; out
// does not depend on it.
__device__ __forceinline__ void store_lse(const FaArgs& a, const Tile& tl, int64_t row, float m,
                                          float l) {
  if (a.lse != nullptr && row < a.Sq)
    a.lse[(static_cast<int64_t>(tl.b) * a.H + tl.h) * a.Sq + row] = m + logf(fmaxf(l, 1e-30f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The arguments of one call, checked: false if the shapes are empty or
// inconsistent, or the grid of ceil(Sq / rows) * B * H CTAs overflows int.
inline bool make_args(FaArgs& a, const void* q, const void* k, const void* v, void* o, float* lse,
                      int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
                      const int64_t* strides, float scale, int causal, int rows) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sk < 0) return false;
  const int64_t n_q_tiles = (Sq + rows - 1) / rows;
  if (B * H > INT_MAX || n_q_tiles * B * H > INT_MAX) return false;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
  a.sq_b = strides[0], a.sq_s = strides[1], a.sq_h = strides[2];
  a.sk_b = strides[3], a.sk_s = strides[4], a.sk_h = strides[5];
  a.sv_b = strides[6], a.sv_s = strides[7], a.sv_h = strides[8];
  a.so_b = strides[9], a.so_s = strides[10], a.so_h = strides[11];
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = static_cast<int>(H);
  a.rep = static_cast<int>(H / KV);
  a.bh = static_cast<int>(B * H);
  a.n_q_tiles = static_cast<int>(n_q_tiles);
  a.scale = scale;
  a.causal = causal;
  return true;
}

}  // namespace fa

// The tile code of mpnet_attention_bhsd.cu ([B, heads, S, hd], any hd up
// to 128): each CTA stages its own rows; the products, the score epilogue
// and the softmax are these functions.  flash_attention.cu and the
// two-pass loop of mpnet_attention.cu (attention_twopass.cuh) reuse the
// mma.sync and fragment helpers.
//
// Contract (the TPU kernel's): scores = (q k^T) * scale + bias + mask in
// f32, with one [heads, S, S] f32 bias shared by every batch row and an
// additive [B, S] f32 key mask; whole-row softmax in f32, a row whose max
// is not finite gets uniform weights instead of NaN; the probabilities are
// rounded to bf16 before P V, which accumulates in f32.
//
// Design: one CTA per (64-query block, head, batch row), 4 warps of 16
// query rows.  The whole score block [64, S] stays in shared memory (S <=
// 512: at most 132 KB), so the softmax is the TPU kernel's whole-row
// softmax, and the bf16 rounding of the normalized probabilities happens
// at the same place.  K and V pass through one [64, HDP] bf16 shared tile
// (row stride HDP + 8) per 64 keys; both products use mma.sync m16n8k16
// (bf16 in, f32 accumulate), so HDP, the head size in shared memory, is a
// multiple of 16.  The probabilities overwrite their own f32 score row in
// place as bf16.  The two-pass loop of attention_twopass.cuh keeps the
// same rounding without the score block; this kernel can move onto it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kBlockQ = 64;    // query rows per CTA
constexpr int kBlockK = 64;    // keys per K/V tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kMaxSeq = 512;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Dynamic shared memory of one CTA: the f32 score block and one tile.
__host__ __device__ constexpr size_t smem_bytes(int s, int hdp) {
  return (size_t)kBlockQ * (s + 4) * 4 + (size_t)kBlockK * (hdp + 8) * 2;
}

// A fragments of q for this warp's 16 rows; p points at element (row g,
// column 2 * tig) of them, rows `stride` elements apart.
template <int HDP>
__device__ __forceinline__ void load_q(uint32_t qa[HDP / 16][4],
                                       const __nv_bfloat16* p, size_t stride) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    qa[kk][0] = ld32(p + kk * 16);
    qa[kk][1] = ld32(p + 8 * stride + kk * 16);
    qa[kk][2] = ld32(p + kk * 16 + 8);
    qa[kk][3] = ld32(p + 8 * stride + kk * 16 + 8);
  }
}

// Phase 1, one 64-key tile: scores = (q k^T) * scale + bias + mask into
// the f32 score rows Sr (stride ss) of this warp.
template <int HDP>
__device__ __forceinline__ void score_tile(
    const uint32_t qa[HDP / 16][4], const __nv_bfloat16* KV,
    const float* __restrict__ bias, const float* __restrict__ kmask,
    float* Sr, int ss, int s, int q0, int head, int b, int kb, int wr,
    int g, int tig, float scale) {
  constexpr int KS = HDP + 8;
  float acc[kBlockK / 8][4];
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      const __nv_bfloat16* p = KV + (nt * 8 + g) * KS + kk * 16 + tig * 2;
      const uint32_t bb[2] = {ld32(p), ld32(p + 8)};
      mma_bf16(acc[nt], qa[kk], bb);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wr + g + half * 8;
      const int key = kb + nt * 8 + tig * 2;
      const float2 bv = *reinterpret_cast<const float2*>(
          bias + ((size_t)head * s + q0 + row) * s + key);
      const float2 mv =
          *reinterpret_cast<const float2*>(kmask + (size_t)b * s + key);
      Sr[row * ss + key] = __fadd_rn(
          __fadd_rn(__fmul_rn(acc[nt][half * 2], scale), bv.x), mv.x);
      Sr[row * ss + key + 1] = __fadd_rn(
          __fadd_rn(__fmul_rn(acc[nt][half * 2 + 1], scale), bv.y), mv.y);
    }
  }
}

// Phase 2: whole-row softmax of this warp's 16 rows; bf16 probs in place.
__device__ __forceinline__ void softmax_rows(float* Sr, int ss, int s, int wr,
                                             int lane) {
  for (int r = wr; r < wr + 16; ++r) {
    float* row = Sr + r * ss;
    float vals[kMaxSeq / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kMaxSeq / 32; ++i) {
      const int c = i * 32 + lane;
      vals[i] = c < s ? row[c] : -INFINITY;
      mx = fmaxf(mx, vals[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const bool safe = isfinite(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSeq / 32; ++i) {
      const int c = i * 32 + lane;
      const float x = safe ? __fsub_rn(vals[i], mx) : 0.f;
      vals[i] = c < s ? expf(x) : 0.f;
      sum += vals[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    __syncwarp();
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(row);
#pragma unroll
    for (int i = 0; i < kMaxSeq / 32; ++i) {
      const int c = i * 32 + lane;
      if (c < s) prow[c] = __float2bfloat16_rn(__fdiv_rn(vals[i], sum));
    }
    __syncwarp();
  }
}

// Phase 3, one 64-key tile of V: o += P[:, kb:kb+64] V for this warp's
// rows (P: the bf16 probabilities, row stride ps).
template <int HDP>
__device__ __forceinline__ void pv_tile(float o[HDP / 8][4],
                                        const __nv_bfloat16* P, int ps,
                                        const __nv_bfloat16* KV, int kb,
                                        int wr, int g, int tig) {
  constexpr int KS = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < kBlockK; kk += 16) {
    const __nv_bfloat16* pa = P + (wr + g) * ps + kb + kk + tig * 2;
    const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * ps), ld32(pa + 8),
                           ld32(pa + 8 * ps + 8)};
#pragma unroll
    for (int nt = 0; nt < HDP / 8; ++nt) {
      const __nv_bfloat16* pv = KV + (kk + tig * 2) * KS + nt * 8 + g;
      const uint32_t bb[2] = {pack2(pv[0], pv[KS]),
                              pack2(pv[8 * KS], pv[9 * KS])};
      mma_bf16(o[nt], a, bb);
    }
  }
}

}  // namespace attn

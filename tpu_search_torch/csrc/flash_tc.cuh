// Helpers of the stock flash mode's tensor-core kernels: the bf16 forward
// above hd 128 (flash_attention.cu's flash_wide_kernel, on the row scheme
// of attention_tc.cuh), the f32 forward and the backward (through
// flash_wgmma.cuh and flash_tf32.cuh).
//
// The flash contract differs from the dense one (attention_tc.cuh's
// score_rows / score_cols) in three ways, each here:
//   - the bias comes before the scale: s = (q k^T + ab) * scale + mask;
//   - the mask is by segment ids: 0 where the query's segment is the key's,
//     -0.7 * FLT_MAX elsewhere (finite: a pad query attends to the pad
//     keys, and every row has a finite max);
//   - ab is [heads, S, S] in the compute dtype T (bf16 or f32), not f32.
// S is a multiple of 128, so no tile is ragged: every row and key of a
// tile lies inside the sequence.  Every head size the stock kernel takes
// (the dense mode's kernels stop at kMaxHd).

#pragma once

#include <float.h>

#include "attention_tc.cuh"

namespace flash {

using namespace tcattn;

constexpr float kMask = (float)(-0.7 * (double)FLT_MAX);

// The output columns a CTA owns: all HDP up to 128; above, half of them
// (two CTAs share the row block, each recomputing the scores), which keeps
// the accumulators within the registers.
template <int HDP>
__host__ __device__ constexpr int out_cols() {
  return HDP > 128 ? 128 : HDP;
}

// Two adjacent elements of T as floats (p 4- or 8-byte aligned).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two adjacent elements stored as T (p 4- or 8-byte aligned).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// One score, each rounding where the stock kernel's separate operations
// round: ((dot + ab) * scale) + mask.
__device__ __forceinline__ float score(float dot, float ab, bool same,
                                       float scale) {
  return __fadd_rn(__fmul_rn(__fadd_rn(dot, ab), scale), same ? 0.f : kMask);
}

// Issue the 16-byte copies of an [R][C] tile of T (rows `stride` elements
// apart in global memory, ld apart in dst; C * sizeof(T), the stride and
// both bases multiples of 16 bytes).
template <typename T, int R, int C>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src,
                                           long long stride, int tid) {
  constexpr int kPer = C * (int)sizeof(T) / 16;
  for (int i = tid; i < R * kPer; i += kThreads) {
    const int r = i / kPer, w = i - r * kPer;
    attn2::cp_async16(reinterpret_cast<char*>(dst + r * ld) + w * 16,
                      reinterpret_cast<const char*>(src + r * stride) +
                          w * 16);
  }
}

// Issue the copies of N ints (N a multiple of 4, both bases 16-byte
// aligned).
template <int N>
__device__ __forceinline__ void stage_ints(int* dst, const int* src,
                                           int tid) {
  for (int i = tid; i < N / 4; i += kThreads)
    attn2::cp_async16(dst + 4 * i, src + 4 * i);
}

// Scores of a row tile in place: rows are the thread's queries (tile rows
// r, r + 8, segment ids qs0, qs1), columns keys 8 n + 2 t + e % 2 of the
// tile, from its staged bias tile (rows ldb apart) and key segment ids.
template <typename T, int NT>
__device__ __forceinline__ void score_rows(float (&sc)[NT][4], const T* bias,
                                           int ldb, const int* segs, int r,
                                           int t, int qs0, int qs1,
                                           float scale) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    const int2 ks = *reinterpret_cast<const int2*>(segs + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 bv = load2(bias + (r + 8 * h) * ldb + c);
      const int qs = h ? qs1 : qs0;
      sc[n][2 * h] = score(sc[n][2 * h], bv.x, qs == ks.x, scale);
      sc[n][2 * h + 1] = score(sc[n][2 * h + 1], bv.y, qs == ks.y, scale);
    }
  }
}

// The 16-byte copy width of q, k, v-like [*, hd] rows of T (16, 8 or 4
// bytes, dividing the row's bytes and every base), or 0: element stores
// (bf16 at an odd hd).
inline int row_chunk(int hd, int es, const void* const* ptrs, int n) {
  int chunk = 16;
  auto aligned = [&](int c) {
    for (int i = 0; i < n; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % c) return false;
    return true;
  };
  while (chunk >= 4 && ((hd * es) % chunk || !aligned(chunk))) chunk /= 2;
  return chunk < 4 ? 0 : chunk;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace flash

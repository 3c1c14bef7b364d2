// Helpers of the attention kernels (mpnet_attention.cu over [B, S, H],
// mpnet_attention_bhsd.cu over [B, heads, S, hd], flash_attention.cu's
// online loop): the mma.sync fragments, the cp.async ring that stages K, V
// and bias tiles (16-byte copies from any row stride, or rows of any head
// size zero-padded to a multiple of 16), q k^T by wgmma from a swizzled K
// tile, ldmatrix fragment loads, quad reductions, the score epilogue, the
// row statistics of the two-pass softmax and P V.  Written against one
// warpgroup of 64 query rows and tiles of 64 keys; flash_attention.cu's
// online loop takes its copies, wgmma, reductions and P V per 64-key half
// of each 128-key step.
//
// The two-pass loop (see mpnet_attention.cu for the contract it keeps):
//   pass 1, per 64-key tile: s = (q k^T) * scale + bias + mask in
//     registers, the row's running max m and the thread's share of the
//     running sum l, rescaled when m grows (online_rows);
//   pass 2, per tile: the same s from the same instructions in the same
//     order (bit-identical to pass 1), p = bf16(exp(s - m) / l), or
//     bf16(1 / S) where m is not finite (normalize_rows), and o += p V with
//     p's accumulator fragments reused as the A operand.
// Only helpers live here; each kernel body stays in its .cu file.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn2 {

constexpr int kBlockQ = 64;    // query rows of one batch row in a CTA
constexpr int kBlockK = 64;    // keys per tile
constexpr int kStages = 2;     // depth of the cp.async ring
constexpr int kThreads = 128;  // 4 warps x 16 query rows: one warpgroup
constexpr unsigned kFull = 0xffffffffu;

// -- mma.sync fragments --------------------------------------------------------

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

// A fragments of q for this warp's 16 rows of hd < HDP columns, zero past
// hd, element by element: p points at (row g, column 0), rows `stride`
// elements apart.
template <int HDP>
__device__ __forceinline__ void load_q_padded(uint32_t qa[HDP / 16][4],
                                              const __nv_bfloat16* p,
                                              size_t stride, int hd,
                                              int tig) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  auto at = [&](int r, int c) { return c < hd ? p[r * stride + c] : zero; };
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int c = kk * 16 + 2 * tig;
    qa[kk][0] = pack2(at(0, c), at(0, c + 1));
    qa[kk][1] = pack2(at(8, c), at(8, c + 1));
    qa[kk][2] = pack2(at(0, c + 8), at(0, c + 9));
    qa[kk][3] = pack2(at(8, c + 8), at(8, c + 9));
  }
}

// -- cp.async ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Four 8x8 b16 matrices, transposed; lane l gives the address of row l % 8
// of matrix l / 8, and lane (g, tig) receives rows 2 tig and 2 tig + 1 of
// column g of each.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(kFull, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(kFull, x, 2));
}

// Issue the cp.async copies of one [kBlockK, HD] bf16 tile: `src` points at
// its first row, rows `stride` elements apart (16-byte aligned); `dst` has
// row stride HD + 8.  kThreads threads (a divisor of 8 HD) share the
// copies.
template <int HD, int kThreads>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int tid) {
  constexpr int KS = HD + 8, kVec = HD / 8;
#pragma unroll
  for (int it = 0; it < kBlockK * kVec / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kVec, c = (i % kVec) * 8;
    cp_async16(dst + r * KS + c, src + r * stride + c);
  }
}

// Row stride (f32) of a staged [64 queries, 64 keys] bias tile: 288 bytes,
// so a warp's float2 reads of 8 rows take the two wavefronts they need.
constexpr int kBiasStride = kBlockK + 8;

// Issue the cp.async copies of one [kBlockQ, kBlockK] f32 bias tile: `src`
// points at its first element, rows `s` elements apart.
template <int kThreads>
__device__ __forceinline__ void stage_bias(float* dst,
                                           const float* __restrict__ src,
                                           int s, int tid) {
  constexpr int kVec = kBlockK / 4;
#pragma unroll
  for (int it = 0; it < kBlockQ * kVec / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kVec, c = (i % kVec) * 4;
    cp_async16(dst + r * kBiasStride + c, src + (size_t)r * s + c);
  }
}

// -- q k^T on wgmma ------------------------------------------------------------
// A K tile for wgmma: ceil(HD / 64) blocks of [64 keys][128 bytes], each in
// the 128-byte swizzled K-major layout (16-byte chunk c of row r at
// position c ^ (r % 8)); at HD 32 a row fills half its 128 bytes.
template <int HD>
constexpr int sw_tile_bytes() {
  return (HD + 63) / 64 * kBlockK * 128;
}

template <int HD, int kThreads>
__device__ __forceinline__ void stage_tile_sw128(unsigned char* dst,
                                                 const __nv_bfloat16* src,
                                                 size_t stride, int tid) {
  constexpr int kVec = HD / 8;
#pragma unroll
  for (int it = 0; it < kBlockK * kVec / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kVec, c = i % kVec;
    cp_async16(dst + (c >> 3) * (kBlockK * 128) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               src + r * stride + c * 8);
  }
}

// Byte offset of 16-byte chunk c (head columns 8 c .. 8 c + 7) of key r in
// swizzled K tiles of NB blocks a 64 keys (keys 64 .. 127 in the second
// such tile).
template <int NB>
__device__ __forceinline__ int k_offset(int r, int c) {
  return (r >> 6) * (NB * 64 * 128) + (c >> 3) * (64 * 128) + (r & 63) * 128 +
         (((c & 7) ^ (r & 7)) << 4);
}

// Issue the copies of kKeys rows of one head's contiguous [S, hd] K and V
// slices (columns < hd, rows hd elements apart) into the swizzled K tiles
// `ksw` and, unless `vs` is null, the V tile `vs` (row stride HDP + 8): 16
// bytes at a time where hd % 8 == 0 (kVec16), else 4 where hd is even
// (TinyBERT's 52-byte rows), else plain 2-byte stores.  The padding columns
// hd .. HDP - 1 are never written, so zeros put there once stay.  Each
// thread steps its (row, unit) pair without a division, which read faster
// on an H100 than dividing each index (PERF.md).
template <int HDP, int kKeys, int kThreads, bool kVec16>
__device__ __forceinline__ void stage_rows(unsigned char* ksw,
                                           __nv_bfloat16* vs,
                                           const __nv_bfloat16* kg,
                                           const __nv_bfloat16* vg, int hd,
                                           int tid) {
  constexpr int kVS = HDP + 8, NB = (HDP + 63) / 64;
  // item i = tid + it * kThreads is (row r, unit w) of `per` units a row,
  // stepped without a division
  const int per = kVec16 ? hd >> 3 : (hd & 1) == 0 ? hd >> 1 : hd;
  const int dr = kThreads / per, dw = kThreads - dr * per;
  int r = tid / per, w = tid - r * per;
  for (int i = tid; i < kKeys * per; i += kThreads) {
    if constexpr (kVec16) {
      cp_async16(ksw + k_offset<NB>(r, w), kg + r * hd + w * 8);
      if (vs) cp_async16(vs + r * kVS + w * 8, vg + r * hd + w * 8);
    } else {
      if ((hd & 1) == 0) {
        cp_async4(ksw + k_offset<NB>(r, w >> 2) + ((w & 3) << 2),
                  kg + r * hd + 2 * w);
        if (vs) cp_async4(vs + r * kVS + 2 * w, vg + r * hd + 2 * w);
      } else {
        *reinterpret_cast<__nv_bfloat16*>(ksw + k_offset<NB>(r, w >> 3) +
                                          ((w & 7) << 1)) = kg[r * hd + w];
        if (vs) vs[r * kVS + w] = vg[r * hd + w];
      }
    }
    r += dr;
    w += dw;
    if (w >= per) {
      w -= per;
      ++r;
    }
  }
}

// One stage of the two-pass loop's ring: the K tile (128-byte swizzled for
// wgmma), the V tile (rows of HD + 8) and the [64, 64] f32 bias tile (rows
// of kBiasStride).  Every size is a multiple of 1024 bytes, so each
// swizzled K tile starts on the swizzle's period.  The ring is kStages
// stages, independent of S: 71,680 bytes at HD 64, 63,488 at HD 32.
template <int HD>
struct Ring {
  static constexpr size_t kK = sw_tile_bytes<HD>();
  static constexpr size_t kV = (size_t)kBlockK * (HD + 8) * 2;
  static constexpr size_t kBias = (size_t)kBlockQ * kBiasStride * 4;
  static constexpr size_t kSlot = kK + kV + kBias;
  static constexpr size_t kBytes = kStages * kSlot;
};

// Descriptor of a 128-byte swizzled K-major tile: start address >> 4,
// leading offset 1 (unused by this layout), 1024 bytes between 8-row
// groups, layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Make generic-proxy shared-memory writes (cp.async) visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] += a[64 x 16] . b[64 x 16]^T: a in registers (each warp's 16
// rows in the m16n8k16 A layout), b K-major bf16 in shared memory; d as
// m16n8 accumulators (d[j][e]: row 16 w + g + 8 (e / 2), column 8 j + 2 t
// + e % 2).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[kBlockK / 8][4],
                                                   const uint32_t a[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void fence_scores(float (&sc)[kBlockK / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(sc[nt][j])::"memory");
}

// s = q k^T for the warpgroup's 64 rows and the 64 keys of the swizzled
// tile Ksw, one wgmma per 16 columns of q, waited for before return.
template <int HD>
__device__ __forceinline__ void qk_tile_wgmma(float (&sc)[kBlockK / 8][4],
                                              const uint32_t qa[HD / 16][4],
                                              const unsigned char* Ksw) {
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
  fence_scores(sc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)  // 32 bytes: 2 descriptor units
    wgmma_rs_m64n64k16(
        sc, qa[kk], sw128_desc(Ksw + (kk >> 2) * (kBlockK * 128)) + 2 * (kk & 3));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_scores(sc);
}

// s = (s * scale + bias) + mask with each rounding written out; bias0 and
// bias1 point at the bias rows of this thread's two query rows, mask at
// the batch row's key mask, all at the tile's first key plus 2 tig.
__device__ __forceinline__ void score_epilogue(float sc[kBlockK / 8][4],
                                               const float* __restrict__ bias0,
                                               const float* __restrict__ bias1,
                                               const float* __restrict__ mask,
                                               float scale) {
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
    const float2 mv = *reinterpret_cast<const float2*>(mask + nt * 8);
    const float2 b0 = *reinterpret_cast<const float2*>(bias0 + nt * 8);
    const float2 b1 = *reinterpret_cast<const float2*>(bias1 + nt * 8);
    sc[nt][0] = __fadd_rn(__fadd_rn(__fmul_rn(sc[nt][0], scale), b0.x), mv.x);
    sc[nt][1] = __fadd_rn(__fadd_rn(__fmul_rn(sc[nt][1], scale), b0.y), mv.y);
    sc[nt][2] = __fadd_rn(__fadd_rn(__fmul_rn(sc[nt][2], scale), b1.x), mv.x);
    sc[nt][3] = __fadd_rn(__fadd_rn(__fmul_rn(sc[nt][3], scale), b1.y), mv.y);
  }
}

// -- the two-pass softmax ------------------------------------------------------

// Pass 1, one tile: fold its scores into the running max m of each of the
// thread's two rows and the thread's share of the sum l of exp(s - m),
// rescaled whenever m grows.
__device__ __forceinline__ void online_rows(const float (&sc)[kBlockK / 8][4],
                                            float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt)
      mx = fmaxf(mx, fmaxf(sc[nt][half * 2], sc[nt][half * 2 + 1]));
    const float m_new = fmaxf(m[half], quad_max(mx));
    // a row with no finite score yet keeps l = 0 (exp(-inf - 0) = 0)
    const float shift = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      sum = __fadd_rn(sum, expf(__fsub_rn(sc[nt][half * 2], shift)));
      sum = __fadd_rn(sum, expf(__fsub_rn(sc[nt][half * 2 + 1], shift)));
    }
    l[half] =
        __fadd_rn(__fmul_rn(l[half], expf(__fsub_rn(m[half], shift))), sum);
    m[half] = m_new;
  }
}

// After pass 1: each row's whole sum l (over its quad), whether its max is
// finite, and the correctly rounded reciprocal of l.
__device__ __forceinline__ void finish_rows(const float (&m)[2], float (&l)[2],
                                            bool (&safe)[2],
                                            float (&rcp)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] = quad_sum(l[half]);
    safe[half] = isfinite(m[half]);
    rcp[half] = __frcp_rn(l[half]);
  }
}

// Pass 2, one tile, in place: p = exp(s - m) / l, or `uniform` (1 / S)
// where the row's max is not finite.  The quotient is correctly rounded
// (Markstein): through the correctly rounded reciprocal, then one
// exact-residual FMA.
__device__ __forceinline__ void normalize_rows(float (&sc)[kBlockK / 8][4],
                                               const float (&m)[2],
                                               const float (&l)[2],
                                               const bool (&safe)[2],
                                               const float (&rcp)[2],
                                               float uniform) {
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1;
      const float ex = expf(__fsub_rn(sc[nt][e], m[half]));
      const float q1 = __fmul_rn(ex, rcp[half]);
      const float p = __fmaf_rn(__fmaf_rn(-q1, l[half], ex), rcp[half], q1);
      sc[nt][e] = safe[half] ? p : uniform;
    }
}

// o += p V for one warp's 16 rows over the 64 keys of the tile Vs, p the
// bf16 probabilities in m16n8 accumulator order (the A fragment order of
// m16n8k16: fragments 2 kk and 2 kk + 1 make the A operand of keys 16 kk ..
// 16 kk + 15).
template <int HD>
__device__ __forceinline__ void pv_tile(float o[HD / 8][4],
                                        const float p[kBlockK / 8][4],
                                        const __nv_bfloat16* Vs, int lane) {
  constexpr int KS = HD + 8;
  // lane's ldmatrix row: key ((lane / 8) % 2) * 8 + lane % 8 of a 16-key
  // slice, columns (lane / 16) * 8 of a 16-column pair
  const __nv_bfloat16* base =
      Vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * KS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    const uint32_t a[4] = {
        pack2(__float2bfloat16_rn(p[2 * kk][0]),
              __float2bfloat16_rn(p[2 * kk][1])),
        pack2(__float2bfloat16_rn(p[2 * kk][2]),
              __float2bfloat16_rn(p[2 * kk][3])),
        pack2(__float2bfloat16_rn(p[2 * kk + 1][0]),
              __float2bfloat16_rn(p[2 * kk + 1][1])),
        pack2(__float2bfloat16_rn(p[2 * kk + 1][2]),
              __float2bfloat16_rn(p[2 * kk + 1][3]))};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, base + kk * 16 * KS + dp * 16);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(o[2 * dp], a, b0);
      mma_bf16(o[2 * dp + 1], a, b1);
    }
  }
}

}  // namespace attn2

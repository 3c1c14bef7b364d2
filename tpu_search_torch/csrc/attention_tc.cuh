// Helpers of the tensor-core row / column attention kernels: the attention
// backward (mpnet_attention_bwd.cu) and the f32 forward
// (mpnet_attention_f32.cu).
//
// Both take q, k, v (and the output gradient) in either of the encoder's
// layouts, [B, S, H] with the heads split inside or [B, heads, S, hd], by
// strides: element (b, head, row, col) sits at
//   b * sb + head * sh + row * ss + col.
// A CTA is one warpgroup (4 warps x 16 rows of a 64-row block); every
// product is an mma.sync over 16 x 16 fragments, in one of two element
// types:
//   Bf16Ops: bf16 operands, m16n8k16, f32 sums.  An operand that is f32
//     (dS) goes in as bf16 hi + lo, two products into one f32 sum.
//   F32Ops: 3xTF32, m16n8k8: each f32 operand a = big + small as tf32,
//     a b = small big + big small + big big into an f32 sum (the lost
//     small small term is 2^-22 of the product).  A 16-column k slice is
//     two k8 products whose k positions are permuted alike on both
//     operands (k8 index t <-> column 2t, t + 4 <-> 2t + 1), so a thread
//     holds the same columns as in the bf16 layout and accumulator tiles
//     feed A operands directly.
// Tiles live in shared memory as T, rows of LD = HDP + 8 elements (HDP the
// head size rounded up to 16; the padding columns are zero), filled by
// cp.async with zero fill past the sequence's end.  Scores, P, dP and dS
// live in registers as m16n8 accumulator tiles (sc[n][e]: row g + 8 (e /
// 2), column 8 n + 2 t + e % 2 of the warp's 16 rows), never in shared
// memory: S has no cap.

#pragma once

#include "attention_twopass.cuh"

namespace tcattn {

using attn2::mma_bf16;
using attn2::pack2;
using attn2::quad_max;
using attn2::quad_sum;
using attn2::smem_u32;

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kRows = 64;      // the rows a CTA owns
constexpr int kMaxHd = 128;

struct Strides {
  long long sb, sh, ss;
};

// Rows a ring step of T rows of HDP columns: 64, or 32 where a row holds
// more than kStepRowBytes (bf16 above hd 32, f32 above hd 16), which keeps
// the ring, the bias tile and the accumulators small enough for three or
// four CTAs a multiprocessor (a threshold of 128 read up to 1.2x slower
// on an H100, PERF.md).
constexpr int kStepRowBytes = 64;
template <typename T, int HDP>
__host__ __device__ constexpr int step_rows() {
  return HDP * (int)sizeof(T) > kStepRowBytes ? 32 : 64;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and lane (g, t) receives columns 2 t, 2 t + 1 of row g of each.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// -- the two element types ----------------------------------------------------
// A: 16 rows x 16 k of an operand held as T; AX: the same of f32 values
// (dS, P) that must keep f32 precision; B: 16 k x 16 n, two n8 tiles.
// load_a reads A from a row-major [row][k] tile; load_bt reads B from an
// [n][k] tile (B[k][n] = tile[n][k]: K for q k^T); load_bn from a [k][n]
// tile (B[k][n] = tile[k][n]: V for P V).  round_a makes an A of
// accumulator tiles c0 (k 0-7) and c1 (k 8-15) rounded to T (P_r); split_a
// an AX of them.

struct Bf16Ops {
  using T = __nv_bfloat16;
  struct A {
    uint32_t r[4];
  };
  struct AX {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t r[4];
  };

  static __device__ __forceinline__ void load_a(A& a, const T* tile, int ld,
                                                int r0, int k0, int lane) {
    ldsm_x4(a.r, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 +
                     (lane >> 4) * 8);
  }
  static __device__ __forceinline__ void load_bt(B& b, const T* tile, int ld,
                                                 int n0, int k0, int lane) {
    ldsm_x4(b.r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
  }
  static __device__ __forceinline__ void load_bn(B& b, const T* tile, int ld,
                                                 int k0, int n0, int lane) {
    attn2::ldsm_x4_trans(b.r, tile + (k0 + ((lane >> 3) & 1) * 8 +
                                      (lane & 7)) * ld +
                                  n0 + (lane >> 4) * 8);
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a,
                                             const B& b, int nt) {
    const uint32_t bb[2] = {b.r[2 * nt], b.r[2 * nt + 1]};
    mma_bf16(c, a.r, bb);
  }
  static __device__ __forceinline__ void mma(float c[4], const AX& a,
                                             const B& b, int nt) {
    const uint32_t bb[2] = {b.r[2 * nt], b.r[2 * nt + 1]};
    mma_bf16(c, a.lo, bb);
    mma_bf16(c, a.hi, bb);
  }
  template <class AA>
  static __device__ __forceinline__ void mma_add(float c[4], const AA& a,
                                                 const B& b, int nt) {
    mma(c, a, b, nt);
  }
  static __device__ __forceinline__ void round_a(A& a, const float c0[4],
                                                 const float c1[4]) {
    a.r[0] = pack2(__float2bfloat16_rn(c0[0]), __float2bfloat16_rn(c0[1]));
    a.r[1] = pack2(__float2bfloat16_rn(c0[2]), __float2bfloat16_rn(c0[3]));
    a.r[2] = pack2(__float2bfloat16_rn(c1[0]), __float2bfloat16_rn(c1[1]));
    a.r[3] = pack2(__float2bfloat16_rn(c1[2]), __float2bfloat16_rn(c1[3]));
  }
  static __device__ __forceinline__ void split_a(AX& a, const float c0[4],
                                                 const float c1[4]) {
    const float x[8] = {c0[0], c0[1], c0[2], c0[3],
                        c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16 h0 = __float2bfloat16_rn(x[2 * i]);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(x[2 * i + 1]);
      a.hi[i] = pack2(h0, h1);
      a.lo[i] = pack2(__float2bfloat16_rn(x[2 * i] - __bfloat162float(h0)),
                      __float2bfloat16_rn(x[2 * i + 1] - __bfloat162float(h1)));
    }
  }
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

struct F32Ops {
  using T = float;
  // x[i] in the order (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), then the
  // same at columns 2t + 8, 2t + 9: the order of two accumulator tiles.
  struct A {
    uint32_t big[8], small[8];
  };
  using AX = A;
  // v[nt]: B at k rows 2t, 2t+1, 2t+8, 2t+9 of column g of n8 tile nt.
  struct B {
    float v[2][4];
  };

  static __device__ __forceinline__ void set(A& a, const float x[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) split_tf32(x[i], a.big[i], a.small[i]);
  }
  static __device__ __forceinline__ void load_a(A& a, const T* tile, int ld,
                                                int r0, int k0, int lane) {
    const T* p = tile + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    const float2 x0 = *reinterpret_cast<const float2*>(p);
    const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
    const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
    const float x[8] = {x0.x, x0.y, x1.x, x1.y, x2.x, x2.y, x3.x, x3.y};
    set(a, x);
  }
  static __device__ __forceinline__ void load_bt(B& b, const T* tile, int ld,
                                                 int n0, int k0, int lane) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const T* p = tile + (n0 + 8 * nt + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
      const float2 x0 = *reinterpret_cast<const float2*>(p);
      const float2 x1 = *reinterpret_cast<const float2*>(p + 8);
      b.v[nt][0] = x0.x;
      b.v[nt][1] = x0.y;
      b.v[nt][2] = x1.x;
      b.v[nt][3] = x1.y;
    }
  }
  static __device__ __forceinline__ void load_bn(B& b, const T* tile, int ld,
                                                 int k0, int n0, int lane) {
    const T* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      b.v[nt][0] = p[8 * nt];
      b.v[nt][1] = p[ld + 8 * nt];
      b.v[nt][2] = p[8 * ld + 8 * nt];
      b.v[nt][3] = p[9 * ld + 8 * nt];
    }
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a,
                                             const B& b, int nt) {
    uint32_t bb[4], bs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(b.v[nt][i], bb[i], bs[i]);
    // k columns 2t, 2t+1 (k8 positions t, t + 4), then 2t + 8, 2t + 9
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = 4 * h;
      mma_tf32(c, a.small[o], a.small[o + 2], a.small[o + 1], a.small[o + 3],
               bb[2 * h], bb[2 * h + 1]);
      mma_tf32(c, a.big[o], a.big[o + 2], a.big[o + 1], a.big[o + 3],
               bs[2 * h], bs[2 * h + 1]);
      mma_tf32(c, a.big[o], a.big[o + 2], a.big[o + 1], a.big[o + 3],
               bb[2 * h], bb[2 * h + 1]);
    }
  }
  // c += a b for a running total over many k16 slices (keys): the slice's
  // products sum into a fresh tile, added to c with one correctly rounded
  // add.  The tensor cores' own sums truncate, and a total carried through
  // them over thousands of keys drifts (1.3e-5 on O(0.03) outputs at S
  // 3,000 when it was).
  static __device__ __forceinline__ void mma_add(float c[4], const A& a,
                                                 const B& b, int nt) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma(d, a, b, nt);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], d[i]);
  }
  static __device__ __forceinline__ void round_a(A& a, const float c0[4],
                                                 const float c1[4]) {
    const float x[8] = {c0[0], c0[1], c0[2], c0[3],
                        c1[0], c1[1], c1[2], c1[3]};
    set(a, x);
  }
  static __device__ __forceinline__ void split_a(AX& a, const float c0[4],
                                                 const float c1[4]) {
    round_a(a, c0, c1);
  }
};

// -- products over shared-memory tiles -----------------------------------------

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// c[16 x 8 NT] = a_tile[r0 .. r0 + 15][0 .. HDP) . b_tile[0 .. 8 NT)[0 .. HDP)^T:
// scores (q k^T, k q^T) and dP (dO v^T, v dO^T); c += ... without kZero (a
// product over head chunks).
template <class Ops, int HDP, int NT, bool kZero = true>
__device__ __forceinline__ void rows_by_rows(float (&c)[NT][4],
                                             const typename Ops::T* a_tile,
                                             const typename Ops::T* b_tile,
                                             int ld, int r0, int lane) {
  if constexpr (kZero) zero(c);
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    typename Ops::A a;
    Ops::load_a(a, a_tile, ld, r0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      typename Ops::B b;
      Ops::load_bt(b, b_tile, ld, np * 16, kk * 16, lane);
      Ops::mma(c[2 * np], a, b, 0);
      Ops::mma(c[2 * np + 1], a, b, 1);
    }
  }
}

// acc[16 x HDP] += x[16 x 8 NT] . b_tile[0 .. 8 NT)[0 .. HDP), with x
// accumulator tiles rounded to T (kExact false: P_r for dV; F32Ops keeps
// f32 either way) or in f32 precision (kExact: dS).
template <class Ops, int HDP, int NT, bool kExact>
__device__ __forceinline__ void mix(float (&acc)[HDP / 8][4],
                                    const float (&x)[NT][4],
                                    const typename Ops::T* b_tile, int ld,
                                    int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    typename Ops::AX ax;
    typename Ops::A a;
    if constexpr (kExact)
      Ops::split_a(ax, x[2 * kk], x[2 * kk + 1]);
    else
      Ops::round_a(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < HDP / 16; ++dp) {
      typename Ops::B b;
      Ops::load_bn(b, b_tile, ld, kk * 16, dp * 16, lane);
      if constexpr (kExact) {
        Ops::mma_add(acc[2 * dp], ax, b, 0);
        Ops::mma_add(acc[2 * dp + 1], ax, b, 1);
      } else {
        Ops::mma_add(acc[2 * dp], a, b, 0);
        Ops::mma_add(acc[2 * dp + 1], a, b, 1);
      }
    }
  }
}

// -- staging -----------------------------------------------------------------------

// cp.async of N bytes (4, 8 or 16); zeros where `ok` is false.
template <int N>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool ok) {
  const int n = ok ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N), "r"(n));
}

// Issue the copies of rows 0 .. R - 1 of a slice (rows ss elements apart,
// hd columns) into dst [R][LD]: rows at or past `valid` are zero, columns
// hd .. LD - 1 are never written (the kernels zero them once).  `chunk`
// bytes a copy (16, 8 or 4, dividing the row's bytes, the strides and the
// base), or 0: plain element stores (bf16 with an odd hd).
template <typename T, int R>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           long long ss, int valid, int hd,
                                           int chunk, int tid) {
  if (chunk == 0) {
    for (int i = tid; i < R * hd; i += kThreads) {
      const int r = i / hd, c = i - r * hd;
      dst[r * ld + c] = r < valid ? src[r * ss + c] : from_f<T>(0.f);
    }
    return;
  }
  const int per = hd * (int)sizeof(T) / chunk;
  for (int i = tid; i < R * per; i += kThreads) {
    const int r = i / per, w = i - r * per;
    const bool ok = r < valid;
    const char* s =
        reinterpret_cast<const char*>(src + (ok ? r * ss : 0)) + w * chunk;
    char* d = reinterpret_cast<char*>(dst + r * ld) + w * chunk;
    if (chunk == 16)
      cp_async_zfill<16>(d, s, ok);
    else if (chunk == 8)
      cp_async_zfill<8>(d, s, ok);
    else
      cp_async_zfill<4>(d, s, ok);
  }
}

// Issue the copies of an [R][C] f32 tile (rows `stride` apart: the bias,
// the rows' statistics) into dst (rows ld apart): rows at or past rv and
// columns at or past cv zero.  16-byte copies when `vec4` (the stride, the base and
// cv multiples of 4 floats), else 4-byte ones.
template <int R, int C>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          long long stride, int rv, int cv,
                                          bool vec4, int tid) {
  if (vec4) {
    for (int i = tid; i < R * C / 4; i += kThreads) {
      const int r = i / (C / 4), c = i % (C / 4) * 4;
      const bool ok = r < rv && c < cv;
      cp_async_zfill<16>(dst + r * ld + c, ok ? src + r * stride + c : src,
                         ok);
    }
  } else {
    for (int i = tid; i < R * C; i += kThreads) {
      const int r = i / C, c = i % C;
      const bool ok = r < rv && c < cv;
      cp_async_zfill<4>(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  }
}

// One stage of a row pass's ring (the backward's row pass, the f32
// forward): K and V tiles of KT keys ([KT][LD] T) and the f32 bias tile of
// the CTA's 64 queries x KT keys (rows LDB = KT + 8 apart: a warp's float2
// reads of 8 rows hit distinct banks).  The key mask is read from global
// memory, a few values a thread and tile.
template <typename T, int HDP>
struct RowSlot {
  static constexpr int LD = HDP + 8, KT = step_rows<T, HDP>(), LDB = KT + 8;
  static constexpr int kTile = KT * LD * (int)sizeof(T);
  static constexpr int kBias = 2 * kTile;  // byte offset in the slot
  static constexpr int kBytes = kBias + kRows * LDB * 4;
};

// Issue the copies of a row pass's stage: K (and V unless vh is null) rows
// kb .. kb + KT - 1 and the bias of queries q0 .. q0 + 63 against those
// keys (bias_h: the head's [S, S] bias); past S, zeros.
template <typename T, int HDP>
__device__ __forceinline__ void stage_keys(unsigned char* slot, const T* kh,
                                           const T* vh,
                                           const float* bias_h, long long ss,
                                           int s, int q0, int kb, int hd,
                                           int chunk, bool vec4, int tid) {
  using L = RowSlot<T, HDP>;
  const int nk = min(L::KT, s - kb);
  T* ks = reinterpret_cast<T*>(slot);
  stage_rows<T, L::KT>(ks, L::LD, kh + kb * ss, ss, nk, hd, chunk, tid);
  if (vh != nullptr)
    stage_rows<T, L::KT>(ks + L::KT * L::LD, L::LD, vh + kb * ss, ss, nk, hd,
                         chunk, tid);
  stage_f32<kRows, L::KT>(reinterpret_cast<float*>(slot + L::kBias), L::LDB,
                          bias_h + (long long)q0 * s + kb, s,
                          min(kRows, s - q0), nk, vec4, tid);
}

// A kernel's dynamic shared memory, with the multiprocessor's carveout at
// its most shared memory, so that as many CTAs fit as the ring allows.
template <typename Kernel>
cudaError_t ring_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Zero `bytes` (a multiple of 16) of shared memory, then a barrier.
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes,
                                          int tid) {
  for (int i = tid; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(p)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// -- scores and the softmax ----------------------------------------------------

// One score: ((dot * scale) + bias) + mask, each rounding written out as
// the plain version's separate operations round.
__device__ __forceinline__ float score(float dot, float bias, float mask,
                                       float scale) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dot, scale), bias), mask);
}

// Scores of a row tile in place: rows are the thread's queries (tile rows
// r, r + 8), columns keys 8 n + 2 t + e % 2 of the tile, from its staged
// bias tile (rows ldb apart) and the mask at the tile's first key (global
// memory, 8-byte aligned unless kRagged).  Outside the sequence (query at
// or past qv, key at or past kv, checked when kRagged) -inf.
template <bool kRagged, int NT>
__device__ __forceinline__ void score_rows(float (&sc)[NT][4],
                                           const float* bias, int ldb,
                                           const float* __restrict__ mask,
                                           int r, int t, int qv, int kv,
                                           float scale) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    float2 mk;
    if constexpr (kRagged) {
      mk.x = c < kv ? mask[c] : 0.f;
      mk.y = c + 1 < kv ? mask[c + 1] : 0.f;
    } else {
      mk = *reinterpret_cast<const float2*>(mask + c);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 bv =
          *reinterpret_cast<const float2*>(bias + (r + 8 * h) * ldb + c);
      float& s0 = sc[n][2 * h];
      float& s1 = sc[n][2 * h + 1];
      s0 = score(s0, bv.x, mk.x, scale);
      s1 = score(s1, bv.y, mk.y, scale);
      if constexpr (kRagged) {
        const bool row_in = r + 8 * h < qv;
        if (!row_in || c >= kv) s0 = -INFINITY;
        if (!row_in || c + 1 >= kv) s1 = -INFINITY;
      }
    }
  }
}

// The same for a column tile: rows are the thread's keys (tile rows r, r +
// 8, mask values mk), columns queries 8 n + 2 t + e % 2 of the tile; the
// staged bias tile is [query][key] (rows ldb apart), read transposed.
template <bool kRagged, int NT>
__device__ __forceinline__ void score_cols(float (&sc)[NT][4],
                                           const float* bias, int ldb,
                                           const float (&mk)[2], int r,
                                           int t, int qv, int kv,
                                           float scale) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = 8 * n + 2 * t + (e & 1), key = r + 8 * (e >> 1);
      sc[n][e] = score(sc[n][e], bias[q * ldb + key], mk[e >> 1], scale);
      if constexpr (kRagged)
        if (q >= qv || key >= kv) sc[n][e] = -INFINITY;
    }
}

// Fold one row tile into each of the thread's two rows' running max m,
// the thread's share of the sum l of exp(s - m) and of d = sum exp(s - m)
// dP; both rescaled whenever m grows (m is the quad's).
template <int NT>
__device__ __forceinline__ void online_rows(const float (&sc)[NT][4],
                                            const float (&dp)[NT][4],
                                            float (&m)[2], float (&l)[2],
                                            float (&d)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mx = fmaxf(mx, fmaxf(sc[n][half * 2], sc[n][half * 2 + 1]));
    const float m_new = fmaxf(m[half], quad_max(mx));
    // a row with no finite score yet keeps l = 0 (exp(-inf - 0) = 0)
    const float shift = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f, dsum = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ex = expf(__fsub_rn(sc[n][half * 2 + e], shift));
        sum = __fadd_rn(sum, ex);
        dsum = __fmaf_rn(ex, dp[n][half * 2 + e], dsum);
      }
    const float f = expf(__fsub_rn(m[half], shift));
    l[half] = __fadd_rn(__fmul_rn(l[half], f), sum);
    d[half] = __fadd_rn(__fmul_rn(d[half], f), dsum);
    m[half] = m_new;
  }
}

// p = exp(s - m) / l, correctly rounded (through the correctly rounded
// reciprocal rcp, then one exact-residual FMA); where the row's max is not
// finite, `uniform` (1 / S) on keys inside the sequence and 0 past it.
__device__ __forceinline__ float prob(float sc, float m, float l, float rcp,
                                      bool safe, bool key_in, float uniform) {
  if (!safe) return key_in ? uniform : 0.f;
  const float ex = expf(__fsub_rn(sc, m));
  const float q1 = __fmul_rn(ex, rcp);
  return __fmaf_rn(__fmaf_rn(-q1, l, ex), rcp, q1);
}

}  // namespace tcattn

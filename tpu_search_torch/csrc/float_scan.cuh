// The tile products of the first flat bf16 / f32 scan, kept for
// scan_overhead_probe.cu, which measures that design against cp.async
// rings.  The production flat and IVF scans have their own
// (ivf_float_scan.cuh).
//
// A CTA stages its query block (16 or 32 queries) in shared memory once;
// tile_dots then computes one 128-row corpus tile against it: the tile is
// staged in 64-dim chunks with 16-byte loads, and each of the 8 warps
// computes 16 rows x QB queries with mma.sync m16n8k16 (bf16 in, f32
// accumulate).  f32 corpora take a plain FMA path with the same staging.
// The raw dot products land in S [QB, 128] f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "topk_select.cuh"

namespace {

constexpr int kTile = 128;    // corpus rows per tile
constexpr int kChunk = 64;    // dims staged per pass
constexpr int kThreads = 256; // 8 warps

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kBf16>
struct Layout {
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  static __host__ __device__ int q_stride(int dp) { return kBf16 ? dp + 8 : dp; }
  static __host__ __device__ int v_stride() { return kBf16 ? kChunk + 8 : kChunk + 1; }
  static __host__ __device__ size_t bytes(int qb, int dp, int kpad) {
    return (size_t)qb * q_stride(dp) * sizeof(T) +
           (size_t)kTile * v_stride() * sizeof(T) + (size_t)qb * kTile * 4 +
           (size_t)qb * kpad * 8;
  }
};

// Raw dot products of the tile's rows with the block's queries -> S.
template <int QB>
__device__ void tile_dots(const __nv_bfloat16* __restrict__ V, int n, int d,
                          int dp, int t0, const __nv_bfloat16* Qs,
                          __nv_bfloat16* Vs, float* S) {
  constexpr int MT = QB / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int qs = Layout<true>::q_stride(dp), vs = Layout<true>::v_stride();
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int kc = 0; kc < dp; kc += kChunk) {
    __syncthreads();
    for (int i = tid; i < kTile * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), c8 = (i % (kChunk / 8)) * 8;
      const int row = t0 + r, col = kc + c8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < n && col < d)
        v = *reinterpret_cast<const uint4*>(V + (size_t)row * d + col);
      *reinterpret_cast<uint4*>(Vs + r * vs + c8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 16) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* p = Vs + (warp * 16 + nt * 8 + g) * vs + ks + tig * 2;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* p = Qs + (mt * 16 + g) * qs + kc + ks + tig * 2;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(p);
        a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * qs);
        a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * qs + 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int q = mt * 16 + g, c = warp * 16 + nt * 8 + tig * 2;
      S[q * kTile + c] = acc[mt][nt][0];
      S[q * kTile + c + 1] = acc[mt][nt][1];
      S[(q + 8) * kTile + c] = acc[mt][nt][2];
      S[(q + 8) * kTile + c + 1] = acc[mt][nt][3];
    }
}

template <int QB>
__device__ void tile_dots(const float* __restrict__ V, int n, int d, int dp,
                          int t0, const float* Qs, float* Vs, float* S) {
  constexpr int kGroups = kThreads / kTile;  // query groups per thread
  constexpr int kPer = QB / kGroups;
  const int tid = threadIdx.x;
  const int r = tid % kTile, qg = tid / kTile;
  const int vs = Layout<false>::v_stride();
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < dp; kc += kChunk) {
    __syncthreads();
    for (int i = tid; i < kTile * kChunk; i += kThreads) {
      const int rr = i / kChunk, c = i % kChunk;
      const int row = t0 + rr, col = kc + c;
      Vs[rr * vs + c] = (row < n && col < d) ? V[(size_t)row * d + col] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kChunk; ++c) {
      const float v = Vs[r * vs + c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(Qs[(qg + kGroups * i) * dp + kc + c], v, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) S[(qg + kGroups * i) * kTile + r] = acc[i];
}

// Stage a CTA's query block [QB, d] into Qs (zero past q and d).
template <bool kBf16, int QB>
__device__ void stage_queries(const typename Layout<kBf16>::T* __restrict__ queries,
                              int q, int d, int dp, int q0,
                              typename Layout<kBf16>::T* Qs) {
  using T = typename Layout<kBf16>::T;
  const int qs = Layout<kBf16>::q_stride(dp);
  for (int i = threadIdx.x; i < QB * dp; i += kThreads) {
    const int qq = i / dp, dd = i % dp;
    T v = T(0.f);
    if (q0 + qq < q && dd < d) v = queries[(size_t)(q0 + qq) * d + dd];
    Qs[qq * qs + dd] = v;
  }
}

}  // namespace

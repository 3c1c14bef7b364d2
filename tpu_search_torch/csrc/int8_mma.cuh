// Device helpers of the int8 kernels (int8_ffn_ln.cu, int8_gemm.cu,
// int8_ffn_in.cu, int8_ffn_out.cu): the s8 x s8 -> s32
// mma.sync product, its fragment loads, the activation quantizer, the
// tanh-gelu with every rounding written out, warp reductions, the
// cp.async copies that stage int8 tiles, the mma.sync main loop of an int8
// x int8 tile (gemm_s8_tile; int8_gemm.cu and int8_ffn_ln.cu have their
// wgmma loop in int8_wgmma.cuh), and the f32 epilogue of the JAX package's
// int8 kernels.
// Only helpers live here; each kernel keeps its own body and epilogue (a
// whole kernel body in a header made a kernel spill).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

// f32(1 / 127): under jit, XLA computes ``amax / 127.0`` as a multiply by
// this constant (measured against the JAX kernels in interpret mode).
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// clip(rint(v * inv), -127, 127) as int8
__device__ __forceinline__ int8_t quant(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

// 127 / amax as the f32 quotient (0 for an all-zero row), and the scale
// amax * f32(1/127) (1 for an all-zero row), as the JAX kernels compute
// them under jit.
__device__ __forceinline__ float inv_of(float amax) {
  return amax > 0.f ? __fdiv_rn(127.f, amax) : 0.f;
}
__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? __fmul_rn(amax, kInv127) : 1.f;
}

__device__ __forceinline__ float gelu_tanh(float y) {
  const float c = 0.7978845608028654f;
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, y), y), y);
  const float t = tanhf(__fmul_rn(c, __fadd_rn(y, cube)));
  return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, t));
}

// The JAX int8 kernels' epilogue ``acc * s_row * s_col + bias``: XLA
// rounds the first product and fuses the second into the add.
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col,
                                         float bias) {
  return __fmaf_rn(__fmul_rn((float)acc, s_row), s_col, bias);
}

// The row and column, inside its m16n8 tile, of accumulator element ``j``:
// c[0..1] are row g, c[2..3] row g + 8, at columns 2 * tig and 2 * tig + 1.
__device__ __forceinline__ int frag_row(int lane, int j) {
  return (lane >> 2) + (j >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int lane, int j) {
  return (lane & 3) * 2 + (j & 1);
}

// One warp's MT x NT tiles of m16n8k32 over ``depth`` (a multiple of 32)
// columns: ``a`` points at the warp's first row, ``b`` at its first
// output column's row of the [N, K] operand, both at the same k.
template <int MT, int NT>
__device__ __forceinline__ void warp_mma(int (&acc)[MT][NT][4],
                                         const int8_t* a, int lda,
                                         const int8_t* b, int ldb,
                                         int depth) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < depth; ks += 32) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* pa = a + (mt * 16 + g) * lda + ks + tig * 4;
      af[mt][0] = ld32(pa);
      af[mt][1] = ld32(pa + 8 * lda);
      af[mt][2] = ld32(pa + 16);
      af[mt][3] = ld32(pa + 8 * lda + 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int8_t* pb = b + (nt * 8 + g) * ldb + ks + tig * 4;
      const uint32_t bf[2] = {ld32(pb), ld32(pb + 16)};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], af[mt], bf);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;
}

// cp.async of ``bytes`` (8 or 16) from global to shared memory, reading
// ``src_bytes`` of them and zero-filling the rest (0: all zero).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage ``rows`` x ``cols`` int8 values of a row-major [n_rows, k] global
// array, from (row0, k0), into shared memory with row stride ``lds``,
// zero-filling rows >= n_rows and columns >= k.  ``k`` and ``cols`` are
// multiples of 8; ``vec16`` (k a multiple of 16) copies 16 bytes at a time.
template <int kThreads>
__device__ __forceinline__ void stage_s8_async(int8_t* dst, int lds,
                                               const int8_t* src, int n_rows,
                                               int k, int row0, int k0,
                                               int rows, int cols,
                                               bool vec16) {
  if (vec16) {
    const int per_row = cols / 16;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * 16;
      const bool ok = row0 + r < n_rows && k0 + c < k;
      const int8_t* p = ok ? src + (size_t)(row0 + r) * k + k0 + c : src;
      cp_async<16>(dst + r * lds + c, p, ok ? 16 : 0);
    }
  } else {
    const int per_row = cols / 8;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * 8;
      const bool ok = row0 + r < n_rows && k0 + c < k;
      const int8_t* p = ok ? src + (size_t)(row0 + r) * k + k0 + c : src;
      cp_async<8>(dst + r * lds + c, p, ok ? 8 : 0);
    }
  }
}

// The main loop of one [BM, BN] tile of x [m, k] . w [n, k]^T (int8 rows,
// k a multiple of 8): both operands stream through a kStages-deep cp.async
// ring of KC-deep chunks, zero past m, n and k, and warp (wm, wn) of WM x
// (warps / WM) accumulates its MT x NT m16n8 tiles from row wm * MT * 16
// and column wn * NT * 8.  ``ring`` holds kStages * (BM + BN) * (KC + 16)
// bytes of shared memory.
template <int BM, int BN, int KC, int kStages, int kThreads, int WM, int MT,
          int NT>
__device__ __forceinline__ void gemm_s8_tile(int (&acc)[MT][NT][4],
                                             int8_t* ring, const int8_t* x,
                                             int m, const int8_t* w, int n,
                                             int k, int m0, int n0) {
  constexpr int kLds = KC + 16, kStageBytes = (BM + BN) * kLds;
  const int warp = threadIdx.x >> 5, wm = warp % WM, wn = warp / WM;
  const bool vec16 = (k & 15) == 0;
  const int nk = (k + KC - 1) / KC;
  auto load = [&](int t) {
    if (t < nk) {
      int8_t* a = ring + (t % kStages) * kStageBytes;
      stage_s8_async<kThreads>(a, kLds, x, m, k, m0, t * KC, BM, KC, vec16);
      stage_s8_async<kThreads>(a + BM * kLds, kLds, w, n, k, n0, t * KC, BN,
                               KC, vec16);
    }
    cp_async_commit();
  };
  zero_acc(acc);
  for (int s = 0; s < kStages - 1; ++s) load(s);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // chunk t + kStages - 1 goes into the slot chunk t - 1 left, which
    // every warp finished before the barrier above
    load(t + kStages - 1);
    const int8_t* a = ring + (t % kStages) * kStageBytes;
    warp_mma<MT, NT>(acc, a + wm * MT * 16 * kLds, kLds,
                     a + (BM + wn * NT * 8) * kLds, kLds, KC);
  }
}

// Two neighbouring columns of a row, as f32.
template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two neighbouring columns of an output row.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace

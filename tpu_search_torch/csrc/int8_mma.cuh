// Device helpers of the int8 kernels (int8_ffn_ln.cu, int8_gemm.cu, the
// digit scans, int4_probe.cu): the s8 x s8 -> s32 mma.sync product, the
// activation quantizer, the tanh-gelu with every rounding written out,
// warp reductions, cp.async copies, and the f32 epilogue of the JAX
// package's int8 kernels.  The int8 GEMMs multiply with wgmma
// (int8_wgmma.cuh).
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

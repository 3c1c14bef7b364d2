// Helpers of the row-at-a-time attention kernels: the f32 forward
// (mpnet_attention_f32.cu) and the backward (mpnet_attention_bwd.cu).
//
// Both take q, k, v (and the output gradient) in either of the encoder's
// layouts, [B, S, H] with the heads split inside or [B, heads, S, hd], by
// strides: element (b, head, row, col) sits at
//   b * sb + head * sh + row * ss + col.
// One CTA of 256 threads owns kQB query rows of one (batch row, head) and
// keeps their whole score rows in shared memory ([kQB, S] f32), so the
// softmax is the contract's whole-row softmax, not an online one.  K and V
// (and Q, dO in the backward's column pass) come through shared memory in
// tiles of kKB rows, converted to f32, with an odd row stride (`hd | 1`) so
// that sixteen threads reading one column of sixteen rows hit sixteen
// banks.  All products are f32 FMAs on the CUDA cores: these kernels are
// right and simple first (see the notes in each .cu file).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rowattn {

constexpr int kQB = 16;        // query rows a CTA in the row passes
constexpr int kKB = 64;        // rows of a staged K / V tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxHd = 128;
// A CTA's dynamic shared memory: the H100's 232,448 bytes less room for
// the kernels' static arrays.
constexpr int kSmemMax = 231424;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long sb, sh, ss;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// x rounded to T's precision, back in f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__host__ __device__ __forceinline__ int round_up(int x, int to) {
  return (x + to - 1) / to * to;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Stages `rows` rows of hd elements (rows ss apart in global memory) from
// src into dst [rows][ld] as f32; rows at or past `limit` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows,
                                      int limit, int hd, int ld,
                                      long long ss) {
  for (int i = threadIdx.x; i < rows * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    dst[r * ld + c] = r < limit ? to_f(src[(long long)r * ss + c]) : 0.f;
  }
}

// out[r][kb + c] for the kQB rows of `a` [kQB][ld] against the kKB rows of
// each staged tile of `src` (s rows, ss apart): thread t owns row t / 16
// and columns (t % 16) + 16 j, j < 4.  With `bias_rows` set (the CTA's
// [kQB, s] slice of the [heads, S, S] bias), a score is
//   (dot * scale + bias) + mask
// rounded at each step as the plain version's separate operations round;
// without, the bare dot.  Ends on a barrier.
template <typename T>
__device__ void dot_rows(float* out, int sld, const float* a, float* tile,
                         const T* src, int s, int nq, int hd, int ld,
                         long long ss, const float* bias_rows,
                         const float* mrow, float scale) {
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  for (int kb = 0; kb < s; kb += kKB) {
    __syncthreads();  // the previous tile's readers are done
    stage(tile, src + (long long)kb * ss, kKB, min(kKB, s - kb), hd, ld, ss);
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < hd; ++d) {
      const float x = a[r * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = fmaf(x, tile[(c + 16 * j) * ld + d], acc[j]);
    }
    if (r < nq) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kb + c + 16 * j;
        if (key >= s) continue;
        float v = acc[j];
        if (bias_rows != nullptr)
          v = __fadd_rn(
              __fadd_rn(__fmul_rn(v, scale), bias_rows[(long long)r * s + key]),
              mrow[key]);
        out[r * sld + key] = v;
      }
    }
  }
  __syncthreads();
}

// Whole-row softmax of `row` (n entries) in place, by one warp, in f32:
// p = exp(s - max) / sum.  A row whose max is not finite gets uniform
// weights 1 / n (exp(0) each), as the plain version's guard gives; returns
// whether the max was finite.
__device__ __forceinline__ bool softmax_row(float* row, int n) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
  m = warp_max(m);
  const bool safe = isfinite(m);
  float l = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float e = safe ? expf(row[j] - m) : 1.f;
    row[j] = e;
    l += e;
  }
  l = warp_sum(l);
  for (int j = lane; j < n; j += 32) row[j] = __fdiv_rn(row[j], l);
  return safe;
}

// out rows (ss apart) = (pm [kQB][sld] . src) * post, over the s rows of
// src staged kKB at a time: thread t owns row t / 16 and columns
// (t % 16) + 16 m.  Rows at or past nq are not written.
template <typename T, typename TO>
__device__ void mix_rows(TO* out, const float* pm, int sld, float* tile,
                         const T* src, int s, int nq, int hd, int ld,
                         long long ss, float post) {
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  float acc[kMaxHd / 16];
#pragma unroll
  for (int m = 0; m < kMaxHd / 16; ++m) acc[m] = 0.f;
  for (int kb = 0; kb < s; kb += kKB) {
    const int n = min(kKB, s - kb);
    __syncthreads();
    stage(tile, src + (long long)kb * ss, kKB, n, hd, ld, ss);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float p = pm[r * sld + kb + j];
#pragma unroll
      for (int m = 0; m < kMaxHd / 16; ++m) {
        const int d = c + 16 * m;
        if (d < hd) acc[m] = fmaf(p, tile[j * ld + d], acc[m]);
      }
    }
  }
  if (r < nq) {
#pragma unroll
    for (int m = 0; m < kMaxHd / 16; ++m) {
      const int d = c + 16 * m;
      if (d < hd) out[(long long)r * ss + d] = from_f<TO>(acc[m] * post);
    }
  }
}

// Dynamic shared memory of a row pass: `score_rows` rows of [kQB, S] f32,
// one [kQB, ld] row block and one [kKB, ld] tile.
__host__ __forceinline__ long long row_pass_bytes(int s, int hd,
                                                  int score_rows) {
  const int ld = hd | 1, sld = round_up(s, kKB);
  return 4LL * (score_rows * kQB * (long long)sld + kQB * ld + kKB * ld);
}

}  // namespace rowattn

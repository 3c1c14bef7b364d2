// The post-attention half of an encoder layer with a W8A8 FFN:
// LN1 -> int8 quantize -> GEMM1 -> gelu -> int8 requantize -> GEMM2 ->
// residual -> LN2.
//
// Replaces: tpu_search/ops/pallas_int8_gemm.py, int8_ffn_ln_fused (kernel
// body _ffn_ln_fused_kernel), run by every encoder layer when the int8 FFN
// is on.
//
// Contract, with every rounding site of the TPU kernel mirrored:
//   x   = LN1(pre) with f32 statistics, then rounded to bf16 (:372);
//   x_q = clip(rint(x * (127 / amax_x)), +-127)  -- multiply, not divide
//         (:375-376), round half to even (rintf), zero rows quantize to 0;
//   sx  = amax_x * f32(1/127) (:379, ``amax / 127.0`` under jit);
//   y   = (acc1 * sx) * s1 + b1 with acc1 = x_q . W1 exact in int32;
//   h   = tanh-gelu(y);
//   h_q = clip(rint(h * (127 / amax_h)), +-127) with amax_h over the whole
//         I-wide row (:391-392);
//   ff  = ((acc2 * scale_h) * s2 + b2) + x, scale_h = amax_h * f32(1/127),
//         rounded to bf16 (:407);
//   out = bf16(LN2(ff)).
// Weights arrive per-output-column quantized ([out, in] int8 rows, so the
// tensor-core B fragments are contiguous) with f32 column scales; biases
// and LN parameters arrive as f32 copies of their bf16 values.
//
// Widths: H a multiple of 8 up to 1,024 and I a multiple of 8 up to 4,096
// (the BERT family up to large, TinyBERT-312).  Each kernel is built for
// HP, H rounded up to a multiple of 128; columns past H and I are zero in
// shared memory (zero codes add nothing to the int32 sums), their outputs
// are never stored, and the LayerNorm statistics run over the true H.
// Where H is HP and I a multiple of 128 (kExact: every BERT-family width
// but TinyBERT's), those bounds are compile-time and fold away.
//
// What bounds it on the H100: at M = 128*384 rows the two GEMMs are
// 4*M*H*I = 464 G int8 ops per layer against ~0.2 GB of activations, so
// the tensor cores bound it; mma.sync m16n8k32 s8 reaches only a part of
// the 1,979 TOP/s peak that wgmma would.
//
// Design: two launches.  The requantize needs amax over the full
// I-wide gelu row before GEMM2 can start, and a row block of the
// [M, I] f32 activation does not fit next to the weight tiles in
// 227 KB of shared memory, so h goes to device memory once (f32, written
// by launch 1, read by launch 2).
//  - Launch 1 (ffn_in): a CTA owns 64 rows x 128 columns of GEMM1.  It
//    recomputes LN1 + quantize for its 64 rows into shared memory (cheap:
//    H values a row), streams W1 in 128-deep chunks, runs mma.sync
//    s8 x s8 -> s32, applies the epilogue and gelu, writes h, and folds
//    the row |h| maxima into a global per-row amax with atomicMax on the
//    float bits (non-negative floats order like their bit patterns).  The
//    CTAs of column block 0 also write the bf16 residual x.
//  - Launch 2 (ffn_out): a CTA owns 32 full rows (all HP columns), so LN2
//    is local.  It quantizes h while staging 64-column chunks, streams W2,
//    and reduces the LN2 statistics across its 16 warps in a fixed order
//    (deterministic, no float atomics).

#include "int8_mma.cuh"

namespace {

// launch 1
constexpr int kBM1 = 64, kBN1 = 128, kKC1 = 128, kThreads1 = 256;
// launch 2
constexpr int kBM2 = 32, kKC2 = 64, kThreads2 = 512;
constexpr int kMaxH = 1024, kMaxI = 4096;

// ---------------------------------------------------------------------------
// Launch 1: LN1 + quantize + GEMM1 + gelu -> h [M, I] f32, amax [M].
// ---------------------------------------------------------------------------
template <int HP, bool kExact>
__global__ void __launch_bounds__(kThreads1)
ffn_in(const __nv_bfloat16* __restrict__ pre, const int8_t* __restrict__ w1t,
       const float* __restrict__ s1, const float* __restrict__ b1,
       const float* __restrict__ ln_s, const float* __restrict__ ln_b,
       float eps, int m_rows, int h_arg, int inter,
       __nv_bfloat16* __restrict__ xres, float* __restrict__ hbuf,
       int* __restrict__ amax_h) {
  constexpr int XS = HP + 16, WS = kKC1 + 16, kPer = HP / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Xq = reinterpret_cast<int8_t*>(smem);
  int8_t* Ws = Xq + kBM1 * XS;
  float* sx = reinterpret_cast<float*>(Ws + kBN1 * WS);
  int* rmax = reinterpret_cast<int*>(sx + kBM1);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * kBM1, n0 = blockIdx.x * kBN1;
  const int h = kExact ? HP : h_arg;
  const float hf = (float)h;

  // LN1 + bf16 round + per-row quantize, 8 rows per warp.
  for (int r = warp; r < kBM1; r += kThreads1 / 32) {
    const int m = m0 + r;
    if (threadIdx.x % 32 == 0) rmax[r] = 0;
    if (m >= m_rows) {
      for (int c = lane; c < HP; c += 32) Xq[r * XS + c] = 0;
      if (lane == 0) sx[r] = 1.f;
      continue;
    }
    float x[kPer];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = i * 32 + lane;
      x[i] = kExact || c < h ? __bfloat162float(pre[(size_t)m * h + c]) : 0.f;
      sum += x[i];
    }
    const float mean = __fdiv_rn(warp_sum(sum), hf);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (kExact || i * 32 + lane < h) {
        const float dlt = __fsub_rn(x[i], mean);
        sq = __fadd_rn(sq, __fmul_rn(dlt, dlt));
      }
    }
    const float var = __fdiv_rn(warp_sum(sq), hf);
    const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = i * 32 + lane;
      if (kExact || c < h) {
        const float ln = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(x[i], mean), rs), ln_s[c]), ln_b[c]);
        const __nv_bfloat16 xc = __float2bfloat16_rn(ln);
        if (blockIdx.x == 0) xres[(size_t)m * h + c] = xc;
        x[i] = __bfloat162float(xc);
        amax = fmaxf(amax, fabsf(x[i]));
      }
    }
    amax = warp_max(amax);
    const float inv = inv_of(amax);
#pragma unroll
    for (int i = 0; i < kPer; ++i) Xq[r * XS + i * 32 + lane] = quant(x[i], inv);
    if (lane == 0) sx[r] = scale_of(amax);
  }

  // GEMM1: warps 4 (rows) x 2 (columns), 16 x 64 per warp; K = h in
  // 128-deep chunks, zero past h.
  const int wm = warp & 3, wn = warp >> 2;
  const bool vec16 = kExact || (h & 15) == 0;
  int acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0;
  for (int kc = 0; kc < h; kc += kKC1) {
    __syncthreads();
    if (vec16) {
      for (int i = threadIdx.x; i < kBN1 * (kKC1 / 16); i += kThreads1) {
        const int r = i / (kKC1 / 16), c16 = (i % (kKC1 / 16)) * 16;
        const int n = n0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < inter && (kExact || kc + c16 < h))
          v = *reinterpret_cast<const uint4*>(w1t + (size_t)n * h + kc + c16);
        *reinterpret_cast<uint4*>(Ws + r * WS + c16) = v;
      }
    } else {
      for (int i = threadIdx.x; i < kBN1 * (kKC1 / 8); i += kThreads1) {
        const int r = i / (kKC1 / 8), c8 = (i % (kKC1 / 8)) * 8;
        const int n = n0 + r;
        uint2 v = make_uint2(0, 0);
        if (n < inter && kc + c8 < h)
          v = *reinterpret_cast<const uint2*>(w1t + (size_t)n * h + kc + c8);
        *reinterpret_cast<uint2*>(Ws + r * WS + c8) = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC1; ks += 32) {
      const int8_t* pa = Xq + (wm * 16 + g) * XS + kc + ks + tig * 4;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * XS), ld32(pa + 16),
                             ld32(pa + 8 * XS + 16)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* pb = Ws + (wn * 64 + nt * 8 + g) * WS + ks + tig * 4;
        const uint32_t b[2] = {ld32(pb), ld32(pb + 16)};
        mma_s8(acc[nt], a, b);
      }
    }
  }

  // Epilogue: dequant + bias + gelu -> h; row |h| maxima -> amax_h.
  float rm[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 16 + g + half * 8;
      const int m = m0 + r;
      const int col = n0 + wn * 64 + nt * 8 + tig * 2;
      if (!kExact && col >= inter) continue;  // inter % 8: col + 1 < inter
      float hv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float y = __fadd_rn(
            __fmul_rn(__fmul_rn((float)acc[nt][half * 2 + j], sx[r]),
                      s1[col + j]),
            b1[col + j]);
        hv[j] = gelu_tanh(y);
        rm[half] = fmaxf(rm[half], fabsf(hv[j]));
      }
      if (m < m_rows && col < inter)
        *reinterpret_cast<float2*>(hbuf + (size_t)m * inter + col) =
            make_float2(hv[0], hv[1]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = rm[half];
    v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
    v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
    if (tig == 0) atomicMax(&rmax[wm * 16 + g + half * 8], __float_as_int(v));
  }
  __syncthreads();
  if (threadIdx.x < kBM1 && m0 + threadIdx.x < m_rows)
    atomicMax(&amax_h[m0 + threadIdx.x], rmax[threadIdx.x]);
}

// ---------------------------------------------------------------------------
// Launch 2: requantize h + GEMM2 + residual + bf16 round + LN2 -> out.
// ---------------------------------------------------------------------------
template <int HP, bool kExact>
__global__ void __launch_bounds__(kThreads2)
ffn_out(const float* __restrict__ hbuf, const int* __restrict__ amax_h,
        const int8_t* __restrict__ w2t, const float* __restrict__ s2,
        const float* __restrict__ b2, const __nv_bfloat16* __restrict__ xres,
        const float* __restrict__ ln_s, const float* __restrict__ ln_b,
        float eps, int m_rows, int h_arg, int inter,
        __nv_bfloat16* __restrict__ out) {
  constexpr int HS = kKC2 + 16, WS = kKC2 + 16;
  constexpr int kWarpN = HP / 8;      // columns per warp (8 column warps)
  constexpr int kNT = kWarpN / 8;     // n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* Hq = reinterpret_cast<int8_t*>(smem);
  int8_t* Ws = Hq + kBM2 * HS;
  float* inv_h = reinterpret_cast<float*>(Ws + HP * WS);
  float* scale_h = inv_h + kBM2;
  float* red = scale_h + kBM2;        // [8 column warps][kBM2]
  float* stat = red + 8 * kBM2;       // [kBM2]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * kBM2;
  const int h = kExact ? HP : h_arg;
  const float hf = (float)h;
  const bool vec16 = kExact || (inter & 15) == 0;

  if (threadIdx.x < kBM2) {
    const int m = m0 + threadIdx.x;
    const float amax = m < m_rows ? __int_as_float(amax_h[m]) : 0.f;
    inv_h[threadIdx.x] = inv_of(amax);
    scale_h[threadIdx.x] = scale_of(amax);
  }

  int acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0;

  for (int kc = 0; kc < inter; kc += kKC2) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBM2 * (kKC2 / 4); i += kThreads2) {
      const int r = i / (kKC2 / 4), c4 = (i % (kKC2 / 4)) * 4;
      const int m = m0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < m_rows && (kExact || kc + c4 < inter))
        v = *reinterpret_cast<const float4*>(hbuf + (size_t)m * inter + kc + c4);
      const float inv = inv_h[r];
      char4 q;
      q.x = quant(v.x, inv);
      q.y = quant(v.y, inv);
      q.z = quant(v.z, inv);
      q.w = quant(v.w, inv);
      *reinterpret_cast<char4*>(Hq + r * HS + c4) = q;
    }
    if (vec16) {
      for (int i = threadIdx.x; i < HP * (kKC2 / 16); i += kThreads2) {
        const int r = i / (kKC2 / 16), c16 = (i % (kKC2 / 16)) * 16;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (kExact || (r < h && kc + c16 < inter))
          v = *reinterpret_cast<const uint4*>(w2t + (size_t)r * inter + kc + c16);
        *reinterpret_cast<uint4*>(Ws + r * WS + c16) = v;
      }
    } else {
      for (int i = threadIdx.x; i < HP * (kKC2 / 8); i += kThreads2) {
        const int r = i / (kKC2 / 8), c8 = (i % (kKC2 / 8)) * 8;
        uint2 v = make_uint2(0, 0);
        if (r < h && kc + c8 < inter)
          v = *reinterpret_cast<const uint2*>(w2t + (size_t)r * inter + kc + c8);
        *reinterpret_cast<uint2*>(Ws + r * WS + c8) = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC2; ks += 32) {
      const int8_t* pa = Hq + (wm * 16 + g) * HS + ks + tig * 4;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * HS), ld32(pa + 16),
                             ld32(pa + 8 * HS + 16)};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int8_t* pb = Ws + (wn * kWarpN + nt * 8 + g) * WS + ks + tig * 4;
        const uint32_t b[2] = {ld32(pb), ld32(pb + 16)};
        mma_s8(acc[nt], a, b);
      }
    }
  }

  // ff = bf16(((acc * scale_h) * s2 + b2) + x), kept in registers; 0 in
  // the padded columns, which no statistic reads.
  float ff[kNT][4];
  float part[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int half = j >> 1;
      const int r = wm * 16 + g + half * 8;
      const int m = m0 + r;
      const int col = wn * kWarpN + nt * 8 + tig * 2 + (j & 1);
      ff[nt][j] = 0.f;
      if (kExact || col < h) {
        const float x =
            m < m_rows ? __bfloat162float(xres[(size_t)m * h + col]) : 0.f;
        const float v = __fadd_rn(
            __fadd_rn(
                __fmul_rn(__fmul_rn((float)acc[nt][j], scale_h[r]), s2[col]),
                b2[col]),
            x);
        ff[nt][j] = __bfloat162float(__float2bfloat16_rn(v));
        part[half] += ff[nt][j];
      }
    }
  }

  // Row statistics over the h columns spread across 8 column warps:
  // quad shuffle, then a fixed-order sum over the column warps.
  auto row_reduce = [&](float p0, float p1) {
    float p[2] = {p0, p1};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = p[half];
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if (tig == 0) red[wn * kBM2 + wm * 16 + g + half * 8] = v;
    }
    __syncthreads();
    if (threadIdx.x < kBM2) {
      float s = 0.f;
      for (int w = 0; w < 8; ++w) s += red[w * kBM2 + threadIdx.x];
      stat[threadIdx.x] = __fdiv_rn(s, hf);
    }
    __syncthreads();
  };
  row_reduce(part[0], part[1]);
  const float mean0 = stat[wm * 16 + g], mean1 = stat[wm * 16 + g + 8];
  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int half = j >> 1;
      if (kExact || wn * kWarpN + nt * 8 + tig * 2 + (j & 1) < h) {
        const float d = __fsub_rn(ff[nt][j], half ? mean1 : mean0);
        sq[half] = __fadd_rn(sq[half], __fmul_rn(d, d));
      }
    }
  __syncthreads();
  row_reduce(sq[0], sq[1]);
  const float rs0 = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(stat[wm * 16 + g], eps)));
  const float rs1 =
      __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(stat[wm * 16 + g + 8], eps)));

#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 16 + g + half * 8;
      const int col = wn * kWarpN + nt * 8 + tig * 2;
      if (m >= m_rows || (!kExact && col >= h)) continue;  // h % 8 == 0
      const float mean = half ? mean1 : mean0, rs = half ? rs1 : rs0;
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(ff[nt][half * 2], mean), rs), ln_s[col]),
          ln_b[col]));
      pair.y = __float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(ff[nt][half * 2 + 1], mean), rs),
                    ln_s[col + 1]),
          ln_b[col + 1]));
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * h + col) = pair;
    }
  }
}

template <int HP, bool kExact>
cudaError_t launch(const void* pre, const void* w1t, const void* s1,
                   const void* b1, const void* w2t, const void* s2,
                   const void* b2, const void* ln1_s, const void* ln1_b,
                   const void* ln2_s, const void* ln2_b, float eps, int m,
                   int h, int inter, void* xres, void* hbuf, void* amax,
                   void* out, cudaStream_t stream) {
  const size_t bytes1 =
      (size_t)kBM1 * (HP + 16) + (size_t)kBN1 * (kKC1 + 16) + kBM1 * 8;
  const size_t bytes2 = (size_t)kBM2 * (kKC2 + 16) + (size_t)HP * (kKC2 + 16) +
                        (size_t)kBM2 * 4 * 11;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_in<HP, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ffn_out<HP, kExact>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes2);
  if (err != cudaSuccess) return err;
  dim3 grid1((inter + kBN1 - 1) / kBN1, (m + kBM1 - 1) / kBM1);
  ffn_in<HP, kExact><<<grid1, kThreads1, bytes1, stream>>>(
      static_cast<const __nv_bfloat16*>(pre), static_cast<const int8_t*>(w1t),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b), eps,
      m, h, inter, static_cast<__nv_bfloat16*>(xres),
      static_cast<float*>(hbuf), static_cast<int*>(amax));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ffn_out<HP, kExact><<<(m + kBM2 - 1) / kBM2, kThreads2, bytes2, stream>>>(
      static_cast<const float*>(hbuf), static_cast<const int*>(amax),
      static_cast<const int8_t*>(w2t), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(xres),
      static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b), eps,
      m, h, inter, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

}  // namespace

// pre [m, h] bf16; w1t [inter, h] int8; w2t [h, inter] int8; s1, b1
// [inter] f32; s2, b2, ln1_*, ln2_* [h] f32.  Scratch: xres [m, h] bf16,
// hbuf [m, inter] f32, amax [m] int32 zeroed.  out [m, h] bf16.
// Requires h % 8 == 0, h <= 1024, inter % 8 == 0, inter <= 4096.
extern "C" int int8_ffn_ln(const void* pre, const void* w1t, const void* s1,
                           const void* b1, const void* w2t, const void* s2,
                           const void* b2, const void* ln1_s,
                           const void* ln1_b, const void* ln2_s,
                           const void* ln2_b, float eps, int m, int h,
                           int inter, void* xres, void* hbuf, void* amax,
                           void* out, void* stream) {
  if (h <= 0 || h % 8 || h > kMaxH || inter <= 0 || inter % 8 ||
      inter > kMaxI)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT8_FFN_LN_CASE(HP)                                                \
  case HP:                                                                  \
    return h == HP && inter % kBN1 == 0                                     \
               ? (int)launch<HP, true>(pre, w1t, s1, b1, w2t, s2, b2,       \
                                       ln1_s, ln1_b, ln2_s, ln2_b, eps, m,  \
                                       h, inter, xres, hbuf, amax, out, st) \
               : (int)launch<HP, false>(pre, w1t, s1, b1, w2t, s2, b2,      \
                                        ln1_s, ln1_b, ln2_s, ln2_b, eps, m, \
                                        h, inter, xres, hbuf, amax, out, st);
  switch ((h + 127) / 128 * 128) {
    INT8_FFN_LN_CASE(128)
    INT8_FFN_LN_CASE(256)
    INT8_FFN_LN_CASE(384)
    INT8_FFN_LN_CASE(512)
    INT8_FFN_LN_CASE(640)
    INT8_FFN_LN_CASE(768)
    INT8_FFN_LN_CASE(896)
    INT8_FFN_LN_CASE(1024)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef INT8_FFN_LN_CASE
}

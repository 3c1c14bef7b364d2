// The FFN's second W8A8 GEMM, with h requantized on chip and the residual
// added:
//   h_q[m, k] = clip(rint(h[m, k] * (127 / amax[m])), +-127)  (0 where
//               amax is 0), the f32 quotient, round half to even;
//   y[m, n]   = ((acc[m, n] * scale[m]) * sw[n] + b[n]) + res[m, n],
//               scale = amax * f32(1/127) (1 where amax is 0),
// with acc = h_q[m, :] . w[n, :] exact in int32.
//
// Replaces: tpu_search/ops/pallas_int8_gemm.py, int8_ffn_out (:275, kernel
// body _ffn_out_kernel :228-254).  The first product rounds, the second
// fuses into the bias add (one FMA), the residual adds after, as XLA
// compiles the JAX kernel.
//
// Operands: h [M, K] bf16 or f32 (int8_ffn_in's output), amax [M] f32,
// w [N, K] int8 (the port's [out, in] layout), f32 sw [N], b [N],
// res [M, N] bf16 or f32; any M, K and N multiples of 8.
//
// What bounds it on the H100: at the bench's shape (M 49,152, K 3,072,
// N 768) it reads 302 MB of bf16 h, 75.5 MB of residual and writes 75.5
// MB: 0.136 ms of HBM time against 0.117 ms of int8 tensor-core time, so
// the bytes.  Design: no LayerNorm follows, so a CTA owns any 128 x 128
// output tile.  The int8 copy of h never exists in device memory: each
// thread loads its part of the next-but-one 64-deep chunk of h into
// registers before the current chunk's products and quantizes it into the
// shared-memory ring after them, while w streams through the same
// three-stage ring by cp.async.

#include "int8_mma.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kKC = 64, kStages = 3, kThreads = 256;
constexpr int kLds = kKC + 16;
constexpr int kStageBytes = (kBM + kBN) * kLds;
constexpr int kMT = 2, kNT = 8;
// 8-value units of h per thread and chunk
constexpr int kUnits = kBM * kKC / 8 / kThreads;

// Eight h values as raw 16-byte words: one for bf16, two for f32.
template <typename HT>
struct Raw8 {
  static constexpr int kWords = sizeof(HT) / 2;
  uint4 v[kWords];
};

template <typename HT>
__device__ __forceinline__ void unpack8(const Raw8<HT>& raw, float (&f)[8]);
template <>
__device__ __forceinline__ void unpack8<float>(const Raw8<float>& raw,
                                               float (&f)[8]) {
  const uint4 a = raw.v[0], b = raw.v[1];
  f[0] = __uint_as_float(a.x); f[1] = __uint_as_float(a.y);
  f[2] = __uint_as_float(a.z); f[3] = __uint_as_float(a.w);
  f[4] = __uint_as_float(b.x); f[5] = __uint_as_float(b.y);
  f[6] = __uint_as_float(b.z); f[7] = __uint_as_float(b.w);
}
template <>
__device__ __forceinline__ void unpack8<__nv_bfloat16>(
    const Raw8<__nv_bfloat16>& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.v[0].x, raw.v[0].y, raw.v[0].z, raw.v[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c,
                                          int8_t d) {
  return (uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
         ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24);
}

template <typename HT, typename RT, typename OutT>
__global__ void __launch_bounds__(kThreads)
ffn_out_kernel(const HT* __restrict__ h, const float* __restrict__ amax,
               const int8_t* __restrict__ w, const float* __restrict__ sw,
               const float* __restrict__ bias, const RT* __restrict__ res,
               OutT* __restrict__ y, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float inv_s[kBM], scale_s[kBM];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool vec16 = (k & 15) == 0;
  const int nk = (k + kKC - 1) / kKC;

  if (threadIdx.x < kBM) {
    const int row = m0 + threadIdx.x;
    const float a = row < m ? amax[row] : 0.f;
    inv_s[threadIdx.x] = inv_of(a);
    scale_s[threadIdx.x] = scale_of(a);
  }
  __syncthreads();

  // Unit u of this thread: row r, columns c .. c + 7 of chunk t.
  auto unit = [&](int u, int& r, int& c) {
    const int i = threadIdx.x + u * kThreads;
    r = i / (kKC / 8);
    c = (i % (kKC / 8)) * 8;
  };
  auto fetch_h = [&](int t, Raw8<HT> (&raw)[kUnits]) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      int r, c;
      unit(u, r, c);
      const int row = m0 + r, col = t * kKC + c;
      const bool ok = t < nk && row < m && col < k;
      const uint4* p =
          reinterpret_cast<const uint4*>(h + (size_t)row * k + col);
#pragma unroll
      for (int q = 0; q < Raw8<HT>::kWords; ++q)
        raw[u].v[q] = ok ? p[q] : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_h = [&](int t, const Raw8<HT> (&raw)[kUnits]) {
    int8_t* a = ring + (t % kStages) * kStageBytes;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      int r, c;
      unit(u, r, c);
      float f[8];
      unpack8<HT>(raw[u], f);
      const float inv = inv_s[r];
      *reinterpret_cast<uint2*>(a + r * kLds + c) = make_uint2(
          pack4(quant(f[0], inv), quant(f[1], inv), quant(f[2], inv),
                quant(f[3], inv)),
          pack4(quant(f[4], inv), quant(f[5], inv), quant(f[6], inv),
                quant(f[7], inv)));
    }
  };
  auto load_w = [&](int t) {
    if (t < nk)
      stage_s8_async<kThreads>(ring + (t % kStages) * kStageBytes + kBM * kLds,
                               kLds, w, n, k, n0, t * kKC, kBN, kKC, vec16);
    cp_async_commit();
  };

  Raw8<HT> raw[kUnits];
  for (int s = 0; s < kStages - 1; ++s) {
    load_w(s);
    fetch_h(s, raw);
    store_h(s, raw);
  }
  int acc[kMT][kNT][4];
  zero_acc(acc);
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // Chunk t + 2 goes into the slot chunk t - 1 left, which every warp
    // finished before the barrier above.
    load_w(t + kStages - 1);
    fetch_h(t + kStages - 1, raw);
    const int8_t* a = ring + (t % kStages) * kStageBytes;
    warp_mma<kMT, kNT>(acc, a + wm * 32 * kLds, kLds,
                       a + (kBM + wn * 64) * kLds, kLds, kKC);
    if (t + kStages - 1 < nk) store_h(t + kStages - 1, raw);
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mt * 16 + frag_row(lane, half * 2);
        const int row = m0 + r;
        const int col = n0 + wn * 64 + nt * 8 + frag_col(lane, 0);
        if (row >= m || col >= n) continue;  // n % 8 == 0: col + 1 < n too
        const float s = scale_s[r];
        const float2 rv = load2<RT>(res + (size_t)row * n + col);
        store2(y + (size_t)row * n + col,
               __fadd_rn(dequant(acc[mt][nt][half * 2], s, sw[col], bias[col]),
                         rv.x),
               __fadd_rn(dequant(acc[mt][nt][half * 2 + 1], s, sw[col + 1],
                                 bias[col + 1]),
                         rv.y));
      }
    }
  }
}

template <typename HT, typename RT, typename OutT>
cudaError_t launch(const void* h, const void* amax, const void* w,
                   const void* sw, const void* b, const void* res, void* y,
                   int m, int n, int k, cudaStream_t stream) {
  const int bytes = kStages * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_out_kernel<HT, RT, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  ffn_out_kernel<HT, RT, OutT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const HT*>(h), static_cast<const float*>(amax),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw),
      static_cast<const float*>(b), static_cast<const RT*>(res),
      static_cast<OutT*>(y), m, n, k);
  return cudaGetLastError();
}

template <typename HT, typename RT>
cudaError_t launch_out(int out_bf16, const void* h, const void* amax,
                       const void* w, const void* sw, const void* b,
                       const void* res, void* y, int m, int n, int k,
                       cudaStream_t st) {
  return out_bf16
             ? launch<HT, RT, __nv_bfloat16>(h, amax, w, sw, b, res, y, m, n,
                                             k, st)
             : launch<HT, RT, float>(h, amax, w, sw, b, res, y, m, n, k, st);
}

template <typename HT>
cudaError_t launch_res(int res_bf16, int out_bf16, const void* h,
                       const void* amax, const void* w, const void* sw,
                       const void* b, const void* res, void* y, int m, int n,
                       int k, cudaStream_t st) {
  return res_bf16 ? launch_out<HT, __nv_bfloat16>(out_bf16, h, amax, w, sw, b,
                                                  res, y, m, n, k, st)
                  : launch_out<HT, float>(out_bf16, h, amax, w, sw, b, res, y,
                                          m, n, k, st);
}

}  // namespace

// h [m, k] bf16 (h_bf16) or f32; amax [m] f32; w [n, k] int8; sw, b [n]
// f32; res [m, n] bf16 (res_bf16) or f32; y [m, n] bf16 (out_bf16) or f32.
// Requires k % 8 == 0 and n % 8 == 0.
extern "C" int int8_ffn_out(const void* h, const void* amax, const void* w,
                            const void* sw, const void* b, const void* res,
                            void* y, int m, int n, int k, int h_bf16,
                            int res_bf16, int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return h_bf16 ? (int)launch_res<__nv_bfloat16>(res_bf16, out_bf16, h, amax,
                                                 w, sw, b, res, y, m, n, k, st)
                : (int)launch_res<float>(res_bf16, out_bf16, h, amax, w, sw, b,
                                         res, y, m, n, k, st);
}

// The FFN's first W8A8 GEMM with gelu, and each row's max |y|:
//   y[m, n] = gelu(((acc[m, n] * sx[m]) * sw[n]) + b[n]),
//   h = y cast to the output dtype, amax[m] = max_n |y[m, n]| in f32.
//
// Replaces: tpu_search/ops/pallas_int8_gemm.py, int8_ffn_in (:158, kernel
// body _ffn_in_kernel :123-154).  The maximum is taken over the f32 y
// before the cast (:142, :146): a maximum over the bf16-rounded h can
// round up and move int8_ffn_out's codes.  The epilogue rounds as
// int8_gemm.cu's does.
//
// Operands: x_q [M, K] int8, w [N, K] int8 (the port's [out, in] layout),
// f32 sx [M], sw [N], b [N]; any M, K and N multiples of 8.
//
// What bounds it on the H100: the tensor cores, as int8_gemm.cu (232 G
// int8 ops at the bench's shape, 0.117 ms).  Design: int8_gemm.cu's
// tiles and cp.async ring.  The TPU kernel carries the row maximum across
// its sequential column blocks; here the column-block CTAs run in
// parallel, so each folds its rows' maxima into shared memory and then
// into a zeroed global buffer with atomicMax on the float bits
// (non-negative floats order like their bit patterns).

#include "int8_mma.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kKC = 64, kStages = 3, kThreads = 256;
constexpr int kLds = kKC + 16;
constexpr int kStageBytes = (kBM + kBN) * kLds;
constexpr int kMT = 2, kNT = 8;

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
ffn_in_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ sx, const float* __restrict__ sw,
              const float* __restrict__ bias, OutT* __restrict__ h,
              int* __restrict__ amax, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rmax[kBM];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (threadIdx.x < kBM) rmax[threadIdx.x] = 0;

  int acc[kMT][kNT][4];
  gemm_s8_tile<kBM, kBN, kKC, kStages, kThreads, 4, kMT, kNT>(
      acc, ring, x, m, w, n, k, m0, n0);

  float rm[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    rm[mt][0] = rm[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mt * 16 + frag_row(lane, half * 2);
        const int col = n0 + wn * 64 + nt * 8 + frag_col(lane, 0);
        if (row >= m || col >= n) continue;  // n % 8 == 0: col + 1 < n too
        const float s = sx[row];
        const float v0 =
            gelu_tanh(dequant(acc[mt][nt][half * 2], s, sw[col], bias[col]));
        const float v1 = gelu_tanh(
            dequant(acc[mt][nt][half * 2 + 1], s, sw[col + 1], bias[col + 1]));
        rm[mt][half] = fmaxf(rm[mt][half], fmaxf(fabsf(v0), fabsf(v1)));
        store2(h + (size_t)row * n + col, v0, v1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = rm[mt][half];
      v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
      v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
      if ((lane & 3) == 0)
        atomicMax(&rmax[wm * 32 + mt * 16 + frag_row(lane, half * 2)],
                  __float_as_int(v));
    }
  }
  __syncthreads();
  if (threadIdx.x < kBM && m0 + threadIdx.x < m)
    atomicMax(&amax[m0 + threadIdx.x], rmax[threadIdx.x]);
}

template <typename OutT>
cudaError_t launch(const void* x, const void* w, const void* sx,
                   const void* sw, const void* b, void* h, void* amax, int m,
                   int n, int k, cudaStream_t stream) {
  const int bytes = kStages * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_in_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  ffn_in_kernel<OutT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(b), static_cast<OutT*>(h),
      static_cast<int*>(amax), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// x [m, k] int8; w [n, k] int8; sx [m], sw [n], b [n] f32; h [m, n] bf16
// (out_bf16) or f32; amax [m] int32, zeroed, receives the f32 bits of
// max |y|.  Requires k % 8 == 0 and n % 8 == 0.
extern "C" int int8_ffn_in(const void* x, const void* w, const void* sx,
                           const void* sw, const void* b, void* h, void* amax,
                           int m, int n, int k, int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? (int)launch<__nv_bfloat16>(x, w, sx, sw, b, h, amax, m, n,
                                               k, st)
                  : (int)launch<float>(x, w, sx, sw, b, h, amax, m, n, k, st);
}

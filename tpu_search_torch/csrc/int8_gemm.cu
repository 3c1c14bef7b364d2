// W8A8 GEMM with the scale, bias and optional gelu epilogue fused:
//   y[m, n] = ((acc[m, n] * sx[m]) * sw[n] + b[n]), gelu if asked, cast to
//   the output dtype, with acc = x_q[m, :] . w[n, :] exact in int32.
//
// Replaces: tpu_search/ops/pallas_int8_gemm.py, int8_gemm (:646, kernel
// body _kernel :60-82).  Every rounding site of the JAX kernel as XLA
// compiles it: the first product rounds, the second fuses into the bias
// add (one FMA), the tanh-gelu rounds after each operation.
//
// Operands: x_q [M, K] int8 rows, w [N, K] int8 rows (the port's
// [out, in] layout, so both tensor-core fragments are contiguous), f32
// sx [M], sw [N], b [N].  Any M; K and N multiples of 8 (K is zero-padded
// to the 64-deep chunk in shared memory).
//
// What bounds it on the H100: at the bench's ffn_in shape (M 49,152,
// K 768, N 3,072) 2*M*K*N = 232 G int8 ops against 0.34 GB of operands
// and bf16 output, so the tensor cores (0.117 ms at 1,979 TOP/s).
// Design: 128 x 128 output tiles, 8 warps of 32 x 64, mma.sync m16n8k32
// s8; x and w stream through a three-stage cp.async ring of 64-deep
// chunks.  wgmma and TMA are later work.

#include "int8_mma.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kKC = 64, kStages = 3, kThreads = 256;
constexpr int kLds = kKC + 16;  // bytes per staged row (conflict-free)
constexpr int kStageBytes = (kBM + kBN) * kLds;
constexpr int kMT = 2, kNT = 8;  // m16n8 tiles per warp (4 x 2 warps)

template <bool kGelu, typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ sx, const float* __restrict__ sw,
            const float* __restrict__ bias, OutT* __restrict__ y, int m,
            int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[kMT][kNT][4];
  gemm_s8_tile<kBM, kBN, kKC, kStages, kThreads, 4, kMT, kNT>(
      acc, ring, x, m, w, n, k, m0, n0);

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mt * 16 + frag_row(lane, half * 2);
        const int col = n0 + wn * 64 + nt * 8 + frag_col(lane, 0);
        if (row >= m || col >= n) continue;  // n % 8 == 0: col + 1 < n too
        const float s = sx[row];
        float v0 = dequant(acc[mt][nt][half * 2], s, sw[col], bias[col]);
        float v1 =
            dequant(acc[mt][nt][half * 2 + 1], s, sw[col + 1], bias[col + 1]);
        if (kGelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        store2(y + (size_t)row * n + col, v0, v1);
      }
    }
  }
}

template <bool kGelu, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* sx,
                   const void* sw, const void* b, void* y, int m, int n, int k,
                   cudaStream_t stream) {
  const int bytes = kStages * kStageBytes;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<kGelu, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  gemm_kernel<kGelu, OutT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(b), static_cast<OutT*>(y), m, n, k);
  return cudaGetLastError();
}

}  // namespace

// x [m, k] int8; w [n, k] int8; sx [m], sw [n], b [n] f32; y [m, n] bf16
// (out_bf16) or f32.  Requires k % 8 == 0 and n % 8 == 0.
extern "C" int int8_gemm(const void* x, const void* w, const void* sx,
                         const void* sw, const void* b, void* y, int m, int n,
                         int k, int gelu, int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gelu)
    return out_bf16 ? (int)launch<true, __nv_bfloat16>(x, w, sx, sw, b, y, m,
                                                       n, k, st)
                    : (int)launch<true, float>(x, w, sx, sw, b, y, m, n, k, st);
  return out_bf16
             ? (int)launch<false, __nv_bfloat16>(x, w, sx, sw, b, y, m, n, k, st)
             : (int)launch<false, float>(x, w, sx, sw, b, y, m, n, k, st);
}

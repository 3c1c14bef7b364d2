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
// [out, in] layout: both K-major, as wgmma's int8 operands must be), f32
// sx [M], sw [N], b [N].  Any M; K and N multiples of 8 (K is zero-filled
// to the 128-deep chunk in shared memory).
//
// What bounds it on the H100: at the bench's ffn_in shape (M 49,152,
// K 768, N 3,072) 2*M*K*N = 232 G int8 ops against 0.34 GB of operands
// and bf16 output, so the tensor cores (0.117 ms at 1,979 TOP/s).  Next
// come the epilogue (an accurate tanhf for each of 151 M outputs, as many
// instructions as the products' issue) and, at K 768, the six K chunks a
// tile, too few to hide the ring's fill.
// Design (the main loop in int8_wgmma.cuh): wgmma.mma_async m64nNk32 s8
// from a ring of 128-byte swizzled K chunks that a producer fills with
// cp.async and mbarriers hand over; two consumer warpgroups of 64 rows.
// Two tiles: 128 x 256 with a producer warpgroup whose registers
// setmaxnreg hands to the consumers (one CTA a multiprocessor: the most
// operand reuse), and 128 x 128 with two producer warps (two CTAs a
// multiprocessor, so one CTA's epilogue overlaps the other's products).
// int8_gemm takes the first for a plain epilogue and the second for gelu.
// The accumulators map to the same dequant / gelu sequence as the m16n8
// fragments did, so the result is unchanged bit for bit.  The producer
// copies with cp.async, not TMA, for every shape: TMA needs 16-byte
// global strides, which K = 312 rows do not have, and one code path
// serves every K.  Not yet done (later work): TMA where K % 16 == 0, and
// a persistent tile loop that overlaps an epilogue with the next tile's
// products at any tile width.

#include "int8_wgmma.cuh"

namespace {

template <bool kGelu, typename OutT, bool kVec16, int BN, int P>
__global__ void __launch_bounds__(WgTile<BN, P>::kThreads,
                                  WgTile<BN, P>::kCtas)
gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ sx, const float* __restrict__ sw,
            const float* __restrict__ bias, OutT* __restrict__ y, int m,
            int n, int k) {
  using T = WgTile<BN, P>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring starts on a 1024-byte boundary (the swizzle's period)
  uint8_t* sa = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + T::kStages * kWgABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + T::kStages * T::kBBytes);
  uint64_t* empty = full + T::kStages;
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], P);  // one cp.async arrival per producer thread
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    if constexpr (P == 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          T::kProducerRegs));
    wgmma_produce<kVec16, BN, P>(sa, sb, full, empty, x, m, w, n, k, m0, n0,
                                 threadIdx.x - 256);
  } else {
    if constexpr (P == 128)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          T::kConsumerRegs));
    int acc[BN / 2];
    wgmma_consume<BN, P>(acc, sa, sb, full, empty, k, wg);

    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int row_base = m0 + wg * 64 + warp * 16 + (lane >> 2);
    const int col_base = n0 + (lane & 3) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_base + half * 8;
      if (row >= m) continue;
      const float s = sx[row];
      OutT* yrow = y + (size_t)row * n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col_base + j * 8;
        if (col >= n) continue;  // n % 8 == 0: col + 1 < n too
        float v0 = dequant(acc[4 * j + 2 * half], s, sw[col], bias[col]);
        float v1 =
            dequant(acc[4 * j + 2 * half + 1], s, sw[col + 1], bias[col + 1]);
        if (kGelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        store2(yrow + col, v0, v1);
      }
    }
  }
}

template <bool kGelu, typename OutT, bool kVec16, int BN, int P>
cudaError_t launch(const void* x, const void* w, const void* sx,
                   const void* sw, const void* b, void* y, int m, int n, int k,
                   cudaStream_t stream) {
  using T = WgTile<BN, P>;
  auto kernel = gemm_kernel<kGelu, OutT, kVec16, BN, P>;
  cudaError_t err;
  if constexpr (P == 128) {
    // setmaxnreg.inc waits until the producer has returned enough
    // registers: a launch with fewer than that would never finish.
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if ((attr.numRegs - T::kProducerRegs) * 128 <
        (T::kConsumerRegs - attr.numRegs) * 256)
      return cudaErrorInvalidConfiguration;
  }
  constexpr int bytes = T::kSmem;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (m + kWgBM - 1) / kWgBM);
  kernel<<<grid, T::kThreads, bytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(b), static_cast<OutT*>(y), m, n, k);
  return cudaGetLastError();
}

template <bool kGelu, typename OutT, int BN, int P>
cudaError_t launch_k(const void* x, const void* w, const void* sx,
                     const void* sw, const void* b, void* y, int m, int n,
                     int k, cudaStream_t stream) {
  if (k % 16 == 0)
    return launch<kGelu, OutT, true, BN, P>(x, w, sx, sw, b, y, m, n, k,
                                            stream);
  return launch<kGelu, OutT, false, BN, P>(x, w, sx, sw, b, y, m, n, k,
                                           stream);
}

template <int BN, int P>
int launch_bn(const void* x, const void* w, const void* sx, const void* sw,
              const void* b, void* y, int m, int n, int k, int gelu,
              int out_bf16, cudaStream_t st) {
  if (gelu)
    return out_bf16 ? (int)launch_k<true, __nv_bfloat16, BN, P>(
                          x, w, sx, sw, b, y, m, n, k, st)
                    : (int)launch_k<true, float, BN, P>(x, w, sx, sw, b, y, m,
                                                        n, k, st);
  return out_bf16 ? (int)launch_k<false, __nv_bfloat16, BN, P>(
                        x, w, sx, sw, b, y, m, n, k, st)
                  : (int)launch_k<false, float, BN, P>(x, w, sx, sw, b, y, m,
                                                       n, k, st);
}

}  // namespace

// x [m, k] int8; w [n, k] int8; sx [m], sw [n], b [n] f32; y [m, n] bf16
// (out_bf16) or f32.  Requires k % 8 == 0 and n % 8 == 0.  wide: 128 x 256
// tiles fed by a producer warpgroup (one CTA a multiprocessor), else
// 128 x 128 tiles fed by two producer warps (two CTAs a multiprocessor).
// The port calls int8_gemm below, which picks the tile by epilogue; this
// export exists so that chip_smoke.py times both tiles on the bench's two
// shapes each run, the measurement that justifies that choice.
extern "C" int int8_gemm_tile(const void* x, const void* w, const void* sx,
                              const void* sw, const void* b, void* y, int m,
                              int n, int k, int gelu, int out_bf16, int wide,
                              void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide)
    return launch_bn<256, 128>(x, w, sx, sw, b, y, m, n, k, gelu, out_bf16,
                               st);
  return launch_bn<128, 64>(x, w, sx, sw, b, y, m, n, k, gelu, out_bf16, st);
}

// The same with the tile that serves the epilogue best: a gelu epilogue
// (an accurate tanhf an output) takes the 128-wide tiles, so that one
// CTA's epilogue overlaps the other's products; a plain one the 256-wide.
extern "C" int int8_gemm(const void* x, const void* w, const void* sx,
                         const void* sw, const void* b, void* y, int m, int n,
                         int k, int gelu, int out_bf16, void* stream) {
  return int8_gemm_tile(x, w, sx, sw, b, y, m, n, k, gelu, out_bf16, !gelu,
                        stream);
}

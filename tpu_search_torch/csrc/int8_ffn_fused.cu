// The whole W8A8 FFN in one launch, with the [M, I] activation kept on
// chip:
//   y   = gelu(((acc1 * sx) * s1) + b1), acc1 = x_q . W1 exact in int32;
//   h_q = clip(rint(y * (127 / amax)), +-127), amax = max |y| over the row
//         (f32 y: the pair quantizes the bf16 h int8_ffn_in wrote, this
//         kernel the f32 one, as the JAX kernels do);
//   out = ((acc2 * scale) * s2 + b2) + res, scale = amax * f32(1/127),
//         acc2 = h_q . W2 exact in int32.
//
// Replaces: tpu_search/ops/pallas_int8_gemm.py, int8_ffn_fused (:578,
// kernel body _ffn_fused_kernel :500-554).  Epilogues round as
// int8_gemm.cu's and int8_ffn_out.cu's do.
//
// Operands: x_q [M, H] int8, sx [M] f32, w1 [I, H] and w2 [H, I] int8 (the
// port's [out, in] layout), f32 s1, b1 [I] and s2, b2 [H], res [M, H]
// bf16 or f32.  H a multiple of 8 up to 1,024, I a multiple of 8 up to
// 4,096.
//
// What bounds it on the H100: the two GEMMs, 4*M*H*I = 464 G int8 ops at
// the bench's shape (0.234 ms), against 0.19 GB of x, residual and output.
// The TPU kernel keeps both weights resident in VMEM (4.5 MB at H 768); a
// CTA here has 227 KB of shared memory, and even 16 rows of the f32 y
// (16 x 3,072 x 4 = 196 KB) leave no room for the weight tiles.  Design:
// a CTA owns BM rows (64 where the tiles fit, else 32) and keeps their
// x_q and their int8 h_q [BM, I] in shared memory; it runs GEMM1 twice.
// Pass 1 computes y and keeps only each row's max |y|; pass 2 recomputes
// y block by block (exact: int32 sums and the same epilogue instructions)
// and quantizes it into h_q; GEMM2 then streams W2 against h_q.  W1 (both
// passes) and W2 stream through one three-stage cp.async ring of 256 x 64
// tiles.  The recomputation adds half of the products again: 6*M*H*I
// int8 ops in all.  With one CTA a multiprocessor (its tiles take most of
// the shared memory), the barrier between tiles is what limits it: a
// 256-wide tile (16 x 64 per warp at BM 32) halves the barriers per
// product against a 128-wide one, and ran faster on the card; a deeper ring
// did not.

#include "int8_mma.cuh"

namespace {

constexpr int kBN = 256, kKC = 64, kStages = 3, kThreads = 256;
constexpr int kWarpN = kBN / 4;  // columns per warp (4 column warps)
constexpr int kLds = kKC + 16;
constexpr int kTileBytes = kBN * kLds;
constexpr int kMaxH = 1024, kMaxI = 4096;

__host__ __device__ constexpr int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// Shared-memory row strides: x_q up to the last 64-deep chunk of H, h_q
// up to the last 256-wide column block of I, each + 16 bytes (conflict-
// free fragment loads).
__host__ __device__ inline int x_stride(int h) { return round_up(h, kKC) + 16; }
__host__ __device__ inline int h_stride(int inter) {
  return round_up(inter, kBN) + 16;
}

template <int BM>
size_t smem_bytes(int h, int inter) {
  return (size_t)BM * (x_stride(h) + h_stride(inter)) +
         (size_t)kStages * kTileBytes + (size_t)BM * 16;
}

template <int BM, typename RT, typename OutT>
__global__ void __launch_bounds__(kThreads)
ffn_fused_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                 const int8_t* __restrict__ w1, const float* __restrict__ s1,
                 const float* __restrict__ b1, const int8_t* __restrict__ w2,
                 const float* __restrict__ s2, const float* __restrict__ b2,
                 const RT* __restrict__ res, OutT* __restrict__ y, int m,
                 int h, int inter) {
  // warps 2 (rows) x 4 (columns): MT x NT m16n8 tiles each
  constexpr int kMT = BM / 32, kNT = kWarpN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs = x_stride(h), hs = h_stride(inter);
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int8_t* xq = ring + kStages * kTileBytes;
  int8_t* hq = xq + BM * xs;
  float* sx_s = reinterpret_cast<float*>(hq + BM * hs);
  int* rmax = reinterpret_cast<int*>(sx_s + BM);
  float* inv_s = reinterpret_cast<float*>(rmax + BM);
  float* scale_s = inv_s + BM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * BM;
  const int nk1 = (h + kKC - 1) / kKC, nb1 = (inter + kBN - 1) / kBN;
  const int nk2 = (inter + kKC - 1) / kKC, nb2 = (h + kBN - 1) / kBN;
  const int t1 = nb1 * nk1, t_all = 2 * t1 + nb2 * nk2;
  const bool vec16_1 = (h & 15) == 0, vec16_2 = (inter & 15) == 0;

  if (threadIdx.x < BM) {
    const int row = m0 + threadIdx.x;
    sx_s[threadIdx.x] = row < m ? sx[row] : 1.f;
    rmax[threadIdx.x] = 0;
  }

  // The tile stream: W1 [I, H] tiles (column block, 64-deep chunk) twice,
  // then W2 [H, I] tiles.
  auto load = [&](int t) {
    if (t < t_all) {
      int8_t* dst = ring + (t % kStages) * kTileBytes;
      if (t < 2 * t1) {
        const int u = t % t1;
        stage_s8_async<kThreads>(dst, kLds, w1, inter, h, (u / nk1) * kBN,
                                 (u % nk1) * kKC, kBN, kKC, vec16_1);
      } else {
        const int u = t - 2 * t1;
        stage_s8_async<kThreads>(dst, kLds, w2, h, inter, (u / nk2) * kBN,
                                 (u % nk2) * kKC, kBN, kKC, vec16_2);
      }
    }
    cp_async_commit();
  };

  // x_q rows, zero past M and H, with the first tile.
  stage_s8_async<kThreads>(xq, xs, x, m, h, m0, 0, BM, round_up(h, kKC),
                           vec16_1);
  for (int s = 0; s < kStages - 1; ++s) load(s);

  // y of accumulator element (mt, nt, j) of column block nb: the same
  // instructions in both passes, so pass 2 recomputes pass 1's values.
  int acc[kMT][kNT][4];
  auto gelu_y = [&](int mt, int nt, int j, int nb, int& r, int& col) {
    r = wm * (BM / 2) + mt * 16 + frag_row(lane, j);
    col = nb * kBN + wn * kWarpN + nt * 8 + frag_col(lane, j);
    return col < inter
               ? gelu_tanh(dequant(acc[mt][nt][j], sx_s[r], s1[col], b1[col]))
               : 0.f;
  };

  zero_acc(acc);
  for (int t = 0; t < t_all; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t == t1) {  // pass 1 done: every row's amax is final
      if (threadIdx.x < BM) {
        const float a = __int_as_float(rmax[threadIdx.x]);
        inv_s[threadIdx.x] = inv_of(a);
        scale_s[threadIdx.x] = scale_of(a);
      }
      __syncthreads();
    }
    load(t + kStages - 1);
    const int8_t* wt = ring + (t % kStages) * kTileBytes + wn * kWarpN * kLds;
    const bool gemm1 = t < 2 * t1;
    const int u = gemm1 ? t % t1 : t - 2 * t1;
    const int nk = gemm1 ? nk1 : nk2;
    const int nb = u / nk, kk = u % nk;
    if (gemm1)
      warp_mma<kMT, kNT>(acc, xq + wm * (BM / 2) * xs + kk * kKC, xs, wt,
                         kLds, kKC);
    else
      warp_mma<kMT, kNT>(acc, hq + wm * (BM / 2) * hs + kk * kKC, hs, wt,
                         kLds, kKC);
    if (kk != nk - 1) continue;

    if (t < t1) {  // pass 1: row maxima of |y|
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = 0.f;
          int r = 0, col;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int j = half * 2; j < half * 2 + 2; ++j)
              v = fmaxf(v, fabsf(gelu_y(mt, nt, j, nb, r, col)));
          v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
          v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
          if ((lane & 3) == 0) atomicMax(&rmax[r], __float_as_int(v));
        }
      }
    } else if (gemm1) {  // pass 2: y again, quantized into h_q
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            int r, col;
            const float v = gelu_y(mt, nt, j, nb, r, col);
            hq[r * hs + col] = col < inter ? quant(v, inv_s[r]) : (int8_t)0;
          }
    } else {  // GEMM2 epilogue: dequant + bias + residual
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * (BM / 2) + mt * 16 + frag_row(lane, half * 2);
            const int row = m0 + r;
            const int col = nb * kBN + wn * kWarpN + nt * 8 + frag_col(lane, 0);
            if (row >= m || col >= h) continue;  // h % 8 == 0
            const float s = scale_s[r];
            const size_t at = (size_t)row * h + col;
            store2(y + at,
                   __fadd_rn(dequant(acc[mt][nt][half * 2], s, s2[col],
                                     b2[col]),
                             to_f32(res[at])),
                   __fadd_rn(dequant(acc[mt][nt][half * 2 + 1], s, s2[col + 1],
                                     b2[col + 1]),
                             to_f32(res[at + 1])));
          }
    }
    zero_acc(acc);
  }
}

template <int BM, typename RT, typename OutT>
cudaError_t launch(const void* x, const void* sx, const void* w1,
                   const void* s1, const void* b1, const void* w2,
                   const void* s2, const void* b2, const void* res, void* y,
                   int m, int h, int inter, cudaStream_t stream) {
  const int bytes = (int)smem_bytes<BM>(h, inter);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fused_kernel<BM, RT, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ffn_fused_kernel<BM, RT, OutT>
      <<<(m + BM - 1) / BM, kThreads, bytes, stream>>>(
          static_cast<const int8_t*>(x), static_cast<const float*>(sx),
          static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
          static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
          static_cast<const float*>(s2), static_cast<const float*>(b2),
          static_cast<const RT*>(res), static_cast<OutT*>(y), m, h, inter);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bm(int res_bf16, int out_bf16, const void* x,
                      const void* sx, const void* w1, const void* s1,
                      const void* b1, const void* w2, const void* s2,
                      const void* b2, const void* res, void* y, int m, int h,
                      int inter, cudaStream_t st) {
  if (res_bf16)
    return out_bf16 ? launch<BM, __nv_bfloat16, __nv_bfloat16>(
                          x, sx, w1, s1, b1, w2, s2, b2, res, y, m, h, inter, st)
                    : launch<BM, __nv_bfloat16, float>(
                          x, sx, w1, s1, b1, w2, s2, b2, res, y, m, h, inter, st);
  return out_bf16 ? launch<BM, float, __nv_bfloat16>(
                        x, sx, w1, s1, b1, w2, s2, b2, res, y, m, h, inter, st)
                  : launch<BM, float, float>(x, sx, w1, s1, b1, w2, s2, b2,
                                             res, y, m, h, inter, st);
}

}  // namespace

// x [m, h] int8; sx [m] f32; w1 [inter, h], w2 [h, inter] int8; s1, b1
// [inter], s2, b2 [h] f32; res [m, h] bf16 (res_bf16) or f32; y [m, h]
// bf16 (out_bf16) or f32; rows, the row block, 64 or 32 (the wrapper
// takes 64 where its tiles fit in a CTA's shared memory).  Requires
// h % 8 == 0, h <= 1024, inter % 8 == 0, inter <= 4096.
extern "C" int int8_ffn_fused(const void* x, const void* sx, const void* w1,
                              const void* s1, const void* b1, const void* w2,
                              const void* s2, const void* b2, const void* res,
                              void* y, int m, int h, int inter, int rows,
                              int res_bf16, int out_bf16, void* stream) {
  if (m <= 0 || h <= 0 || h % 8 || h > kMaxH || inter <= 0 || inter % 8 ||
      inter > kMaxI || (rows != 32 && rows != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 64)
    return (int)launch_bm<64>(res_bf16, out_bf16, x, sx, w1, s1, b1, w2, s2,
                              b2, res, y, m, h, inter, st);
  return (int)launch_bm<32>(res_bf16, out_bf16, x, sx, w1, s1, b1, w2, s2, b2,
                            res, y, m, h, inter, st);
}

// Masked top-k over an int8-coded corpus with two-digit int8 queries:
// digit_partial, the row-range scan of the flat digit scans
// (flat_digit_scan.cuh composes them): flat_topk_int8.cu (int8 rows, or
// the JAX package's word-packed int8 layout; at Q > 8 the word layout
// only) and flat_topk_int4.cu at Q <= 8 (biased nibbles).
//
// Contract (that of the TPU kernels _kernel_int8 / _kernel_int4 and of
// ops/topk_scan.py flat_topk_int8_plain / flat_topk_int4_plain):
//   d1, d2     = exact int32 dots of query digit 1 / digit 2 with the row
//                (int4: minus the nibble bias 8 * sum(digit), in int32)
//   score[q,r] = fma(rho[q], d2, d1) * scale[r] + penalty[r]
// penalty 0 (live row) or -inf (masked row).  The k best per query,
// descending, first-index ties, slots past the live rows -inf / -1.  The
// query scale qs1 > 0 multiplies the selected scores in the merge.
// The epilogue writes out __fmaf_rn / __fmul_rn / __fadd_rn, so its
// rounding does not depend on nvcc's -fmad.
//
// What bounds it on the H100: at small Q the corpus bytes (1 B a component
// for int8, 0.5 B for int4; 2 x Q x N x D int8 ops sit far under the
// ~590 op/byte int8 ridge), so HBM bandwidth.
//
// Design (the shape of flat_topk.cu): the TPU kernels walk the corpus in
// one sequential grid with a running top-k; here N splits into row ranges,
// one CTA per (query block, range), each with partial lists in shared
// memory behind a k-th-best gate (topk_select.cuh), then run_merge.cuh's
// tree merge.
//  - A query block is QB = 8 or 32 queries.  Its digits form the A operand
//    of mma.sync m16n8k32 s8 x s8 -> s32, arranged per m-tile of 16 rows
//    as 8 queries' digit 1 (rows 0-7) then the same 8 queries' digit 2
//    (rows 8-15), so a thread's accumulator holds d1 (c0, c1) and d2
//    (c2, c3) of the same query and row, and the digit combine happens in
//    registers.
//  - The corpus tile (128 rows x 128 dims) is staged in shared memory as
//    int8 rows with D contiguous, the B operand; the Stage policy decodes
//    the layout on the way in.  Each of the 8 warps takes 16 rows.
//  - The scan is latency-bound at small Q, so each thread loads the next
//    chunk (or the next tile's first) into registers before the current
//    chunk's MMAs, and the tile's row scales and penalties before its
//    first chunk: the HBM reads overlap the compute.
// The cp.async ring and wgmma are ivf_digit_scan.cuh's, which the flat
// row and nibble scans take at Q > 8 where it reads faster.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "smem_cap.cuh"
#include "topk_select.cuh"

namespace {

constexpr int kTile = 128;             // corpus rows per tile
constexpr int kChunk = 128;            // dims (bytes) staged per pass
constexpr int kThreads = 256;          // 8 warps
constexpr int kVStride = kChunk + 16;  // bytes per staged row: no bank conflicts

__device__ __forceinline__ uint4 zero4() { return make_uint4(0, 0, 0, 0); }

__host__ __device__ inline size_t digit_smem_bytes(int qb, int dp, int kpad) {
  return (size_t)qb * kTile * 4      // S: the tile's scores
         + (size_t)qb * kpad * 8     // partial lists
         + (size_t)qb * 4            // rho
         + (size_t)qb * 2 * 4        // nibble bias offsets
         + (size_t)2 * qb * (dp + 16)  // query digits (A)
         + (size_t)kTile * kVStride;   // corpus tile (B)
}

// Corpus staging policies (the Stage of the kernels below).
// RowStage: [n, d] int8 rows.  128 rows x 128 dims: 8 16-byte loads a
// row, 4 a thread.  Needs d % 16 == 0.
struct RowStage {
  static constexpr int kLoads = kTile * (kChunk / 16) / kThreads;
  struct Regs {
    uint4 v[kLoads];
  };
  __device__ static void load(const void* V, int n, int d, int t0, int kc,
                              Regs& regs) {
    const int8_t* R = static_cast<const int8_t*>(V);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int row = t0 + i / (kChunk / 16);
      const int col = kc + (i % (kChunk / 16)) * 16;
      regs.v[j] = row < n && col < d
                      ? *reinterpret_cast<const uint4*>(R + (size_t)row * d + col)
                      : zero4();
    }
  }
  __device__ static void store(const Regs& regs, int8_t* Vs) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      *reinterpret_cast<uint4*>(Vs + (i / (kChunk / 16)) * kVStride +
                                (i % (kChunk / 16)) * 16) = regs.v[j];
    }
  }
};

// NibbleStage: nibble-pair byte rows [ceil(n/2), d] uint8, byte row m =
// logical rows 2m (low nibble) and 2m+1 (high), biased codes 1..15.  64
// byte rows x 128 dims: 8 16-byte loads a byte row, two logical rows each,
// 2 a thread; each load splits in registers (& 0x0F0F0F0F, >> 4) into the
// s8 values of its two rows.  Needs d % 16 == 0 and an even t0.
struct NibbleStage {
  static constexpr int kPerRow = kChunk / 16;
  static constexpr int kLoads = (kTile / 2) * kPerRow / kThreads;
  struct Regs {
    uint4 v[kLoads];
  };
  __device__ static void load(const void* V, int n, int d, int t0, int kc,
                              Regs& regs) {
    const uint8_t* B = static_cast<const uint8_t*>(V);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int brow = t0 / 2 + i / kPerRow, col = kc + (i % kPerRow) * 16;
      regs.v[j] = 2 * brow < n && col < d
                      ? *reinterpret_cast<const uint4*>(B + (size_t)brow * d + col)
                      : zero4();
    }
  }
  __device__ static void store(const Regs& regs, int8_t* Vs) {
    const uint32_t lo = 0x0F0F0F0Fu;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const uint4 v = regs.v[j];
      int8_t* dst = Vs + (2 * (i / kPerRow)) * kVStride + (i % kPerRow) * 16;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(v.x & lo, v.y & lo, v.z & lo, v.w & lo);
      *reinterpret_cast<uint4*>(dst + kVStride) =
          make_uint4((v.x >> 4) & lo, (v.y >> 4) & lo, (v.z >> 4) & lo,
                     (v.w >> 4) & lo);
    }
  }
};

// Partial scan of one (query block, row range).  Stage::load(V, n, d, t0,
// kc, regs) reads the bytes of tile rows t0.., dims kc.. into registers
// (zero past n and d); Stage::store(regs, Vs) writes them to Vs[r *
// kVStride + c] as the int8 values of tile row r, dim kc + c.  qoff is
// null for int8 corpora.
template <class Stage, int QB>
__global__ void __launch_bounds__(kThreads)
digit_partial(const void* __restrict__ V, const float* __restrict__ scale,
              const float* __restrict__ penalty,
              const int8_t* __restrict__ digits, const float* __restrict__ rho,
              const int* __restrict__ qoff, int n, int d, int q, int k,
              int kpad, int rows_per_split, float* __restrict__ part_s,
              int* __restrict__ part_i, float* __restrict__ out_scores) {
  constexpr int MT = QB / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = round_up(d, kChunk);
  const int qstr = dp + 16;
  float* S = reinterpret_cast<float*>(smem);
  float* bs = S + QB * kTile;
  int* bi = reinterpret_cast<int*>(bs + QB * kpad);
  float* rho_s = reinterpret_cast<float*>(bi + QB * kpad);
  int* qoff_s = reinterpret_cast<int*>(rho_s + QB);
  int8_t* Qs = reinterpret_cast<int8_t*>(qoff_s + 2 * QB);
  int8_t* Vs = Qs + 2 * QB * qstr;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);

  // A rows: m-tile mt, row r -> digit (r < 8 ? 1 : 2) of query mt*8 + r%8.
  const int c16s = dp / 16;
  for (int i = tid; i < 2 * QB * c16s; i += kThreads) {
    const int ar = i / c16s, c16 = (i % c16s) * 16;
    const int r = ar % 16, qi = q0 + (ar / 16) * 8 + (r & 7);
    uint4 v = zero4();
    if (qi < q && c16 < d)
      v = *reinterpret_cast<const uint4*>(
          digits + (size_t)(r < 8 ? qi : q + qi) * d + c16);
    *reinterpret_cast<uint4*>(Qs + ar * qstr + c16) = v;
  }
  for (int i = tid; i < QB; i += kThreads) {
    const bool live = q0 + i < q;
    rho_s[i] = live ? rho[q0 + i] : 0.f;
    qoff_s[i] = live && qoff ? qoff[q0 + i] : 0;
    qoff_s[QB + i] = live && qoff ? qoff[q + q0 + i] : 0;
  }
  for (int i = tid; i < QB * kpad; i += kThreads) {
    bs[i] = -INFINITY;
    bi[i] = -1;
  }

  typename Stage::Regs regs;
  if (row_begin < row_end) Stage::load(V, n, d, row_begin, 0, regs);
  for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
    // The epilogue's row scales and penalties, read ahead of the MMAs.
    float sc[2][2], pn[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = t0 + warp * 16 + nt * 8 + tig * 2 + j;
        sc[nt][j] = row < row_end ? scale[row] : 0.f;
        pn[nt][j] = row < row_end ? penalty[row] : -INFINITY;
      }
    int acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

    for (int kc = 0; kc < dp; kc += kChunk) {
      __syncthreads();
      Stage::store(regs, Vs);
      __syncthreads();
      const bool last = kc + kChunk >= dp;
      const int next_t0 = last ? t0 + kTile : t0;
      if (next_t0 < row_end)
        Stage::load(V, n, d, next_t0, last ? 0 : kc + kChunk, regs);
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += 32) {
        uint32_t b[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int8_t* p = Vs + (warp * 16 + nt * 8 + g) * kVStride + ks + tig * 4;
          b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
          b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int8_t* p = Qs + (mt * 16 + g) * qstr + kc + ks + tig * 4;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(p);
          a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * qstr);
          a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
          a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * qstr + 16);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_s8(acc[mt][nt], a, b[nt]);
        }
      }
    }
    // Epilogue in registers: c0/c1 are d1 and c2/c3 d2 of query mt*8 + g.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qq = mt * 8 + g, c = warp * 16 + nt * 8 + tig * 2 + j;
          const float d1 = __int2float_rn(acc[mt][nt][j] - qoff_s[qq]);
          const float d2 = __int2float_rn(acc[mt][nt][j + 2] - qoff_s[QB + qq]);
          // Rows past the range carry penalty -inf and scale 0: -inf.
          S[qq * kTile + c] = __fadd_rn(
              __fmul_rn(__fmaf_rn(rho_s[qq], d2, d1), sc[nt][j]), pn[nt][j]);
        }
    __syncthreads();
    consume_tile<QB, kTile, kThreads>(S, q0, q, t0, row_end, n, k, kpad, bs,
                                      bi, out_scores);
  }
  if (out_scores) return;
  __syncthreads();
  store_partials<QB, kThreads>(bs, bi, q0, q, kpad, part_s, part_i);
}

template <class Stage, int QB>
cudaError_t launch_digit_qb(const void* V, const float* scale,
                            const float* penalty, const int8_t* digits,
                            const float* rho, const int* qoff, int n, int d,
                            int q, int k, int n_splits, int rows_per_split,
                            float* part_s, int* part_i, float* out_scores,
                            cudaStream_t stream) {
  const int kpad = out_scores ? 0 : round_up(k, 32);
  const size_t bytes = digit_smem_bytes(QB, round_up(d, kChunk), kpad);
  static size_t caps[kCapDevices] = {};
  cudaError_t err = raise_smem_cap(
      (const void*)digit_partial<Stage, QB>, bytes, caps);
  if (err != cudaSuccess) return err;
  dim3 grid((q + QB - 1) / QB, n_splits);
  digit_partial<Stage, QB><<<grid, kThreads, bytes, stream>>>(
      V, scale, penalty, digits, rho, qoff, n, d, q, k, kpad, rows_per_split,
      part_s, part_i, out_scores);
  return cudaGetLastError();
}

}  // namespace

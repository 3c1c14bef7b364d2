// Where the int4 flat scan's time goes at 1M x 768: stripped variants of
// an int4 scan, each a template instance of the pieces in digit_scan.cuh
// and topk_select.cuh, and (full) the production scan of flat_topk_int4.cu
// itself, built here so that the production kernels' own instantiations
// stay as they are.
//
// Replaces: benchmarks/int4_probe.py, build (:199; pallas_call :205,
// kernel make_kernel :71), the TPU probe of pallas_flat_topk_dma_int4.
//
// Modes (the TPU probe's names), over the nibble-pair corpus [ceil(n/2),
// d] uint8 of ops/int4_pack.py, the query digits and per-row scales and
// penalties of flat_topk_int4:
//   dma       (0): the byte stream only, folded: the XOR of every 32-bit
//                  word of the CTA's rows -> fold[split] int32;
//   mm_only   (1): the digit MMA on the raw bytes as int8 rows (no nibble
//                  split): the max over the CTA's byte rows of each
//                  query's digit-1 dot -> fold[q, split] f32 (exact);
//   unpack    (2): both nibble planes split into shared memory (the
//                  production staging), no MMA: the XOR of the split words
//                  -> fold[split] int32;
//   nomerge   (3): everything but the top-k: the max of each query's
//                  scores over the CTA's rows -> fold[q, split] f32;
//   concat1mm (4): the tile staged in plane order, its 64 low-nibble rows
//                  then its 64 high-nibble rows (the TPU probe's
//                  concatenated planes), one MMA loop, the scores offered
//                  to the top-k in logical row order (the TPU probe's
//                  ``local`` map, :113) -> partial lists, then merge_topk;
//   full      (5): the production scan and merge of flat_topk_int4.cu
//                  (flat_digit_scan.cuh: at Q <= 8 digit_partial over the
//                  given row ranges, then the tree merge) on the given
//                  digits -> top-k.
// Contract of the scores and the top-k: digit_scan.cuh.  A CTA owns
// rows_per_split logical rows (a multiple of 256: whole 128-row tiles of
// logical rows and of byte rows); the TPU probe's tile sweep (2048, 4096,
// 8192 rows of VMEM) becomes a sweep of that range, the rows one CTA
// streams in sequence.
//
// Bound on the H100: 1M x 768 int4 is 0.403 GB of nibbles (plus 8 bytes a
// row of scale and penalty), 0.120 ms at 3.35 TB/s.

#include "flat_digit_scan.cuh"
#include "probe_select.cuh"

namespace {

enum Mode { kDma = 0, kMmOnly = 1, kUnpack = 2, kNoMerge = 3, kConcat = 4 };
constexpr int kQB = 8;

// NibbleStage's loads; the store puts the tile's low nibbles in rows
// 0..63 and its high nibbles in rows 64..127 (plane order).
struct ConcatStage : NibbleStage {
  __device__ static void store(const Regs& regs, int8_t* Vs) {
    const uint32_t lo = 0x0F0F0F0Fu;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const uint4 v = regs.v[j];
      int8_t* dst = Vs + (i / kPerRow) * kVStride + (i % kPerRow) * 16;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(v.x & lo, v.y & lo, v.z & lo, v.w & lo);
      *reinterpret_cast<uint4*>(dst + (kTile / 2) * kVStride) =
          make_uint4((v.x >> 4) & lo, (v.y >> 4) & lo, (v.z >> 4) & lo,
                     (v.w >> 4) & lo);
    }
  }
};

// Logical row of tile row c: plane order for concat1mm, else c.
template <int kMode>
__device__ __forceinline__ int logical(int c) {
  if constexpr (kMode == kConcat)
    return c < kTile / 2 ? 2 * c : 2 * (c - kTile / 2) + 1;
  return c;
}

__device__ __forceinline__ uint32_t xor4(uint4 v) {
  return v.x ^ v.y ^ v.z ^ v.w;
}

// XOR of every thread's ``x`` -> fold[blockIdx.y] (int32).
__device__ void store_xor(uint32_t x, int* fold) {
  __shared__ uint32_t warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(kFull, x, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t all = 0;
    for (int w = 0; w < kThreads / 32; ++w) all ^= warps[w];
    fold[blockIdx.y] = (int)all;
  }
}

// dma and unpack: the byte stream of the CTA's rows, the next chunk loaded
// before the current one is folded, as digit_partial loads ahead.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
stream_probe(const void* __restrict__ V, int n, int d, int rows_per_split,
             int* __restrict__ fold) {
  __shared__ __align__(16) int8_t Vs[kTile * kVStride];
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int dp = round_up(d, kChunk);
  const uint32_t lo = 0x0F0F0F0Fu;
  uint32_t x = 0;
  NibbleStage::Regs regs;
  if (row_begin < row_end) NibbleStage::load(V, n, d, row_begin, 0, regs);
  for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
    for (int kc = 0; kc < dp; kc += kChunk) {
      const NibbleStage::Regs cur = regs;
      const bool last = kc + kChunk >= dp;
      const int next_t0 = last ? t0 + kTile : t0;
      if (next_t0 < row_end)
        NibbleStage::load(V, n, d, next_t0, last ? 0 : kc + kChunk, regs);
      if constexpr (kMode == kUnpack) {
        NibbleStage::store(cur, Vs);
#pragma unroll
        for (int j = 0; j < NibbleStage::kLoads; ++j) {
          const uint4 v = cur.v[j];
          x ^= xor4(make_uint4(v.x & lo, v.y & lo, v.z & lo, v.w & lo)) ^
               xor4(make_uint4((v.x >> 4) & lo, (v.y >> 4) & lo,
                               (v.z >> 4) & lo, (v.w >> 4) & lo));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NibbleStage::kLoads; ++j) x ^= xor4(cur.v[j]);
      }
    }
  }
  store_xor(x, fold);
}

// mm_only, nomerge and concat1mm: digit_partial's body with the mode's
// staging and tail.  Rows are logical rows, or byte rows for mm_only.
template <int kMode, class Stage>
__global__ void __launch_bounds__(kThreads)
mma_probe(const void* __restrict__ V, const float* __restrict__ scale,
          const float* __restrict__ penalty, const int8_t* __restrict__ digits,
          const float* __restrict__ rho, const int* __restrict__ qoff, int n,
          int d, int q, int k, int kpad, int rows_per_split,
          float* __restrict__ part_s, int* __restrict__ part_i,
          float* __restrict__ fold) {
  constexpr int QB = kQB, MT = QB / 8;
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
  float* fmx = reinterpret_cast<float*>(Vs + kTile * kVStride);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * QB;
  const int scale_rows = kMode == kMmOnly ? 2 : 1;  // logical rows a row
  const int row_begin = blockIdx.y * rows_per_split / scale_rows;
  const int row_end = min(n, row_begin + rows_per_split / scale_rows);

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
    qoff_s[i] = live && kMode != kMmOnly ? qoff[q0 + i] : 0;
    qoff_s[QB + i] = live && kMode != kMmOnly ? qoff[q + q0 + i] : 0;
    fmx[i] = -INFINITY;
  }
  for (int i = tid; i < QB * kpad; i += kThreads) {
    bs[i] = -INFINITY;
    bi[i] = -1;
  }

  typename Stage::Regs regs;
  if (row_begin < row_end) Stage::load(V, n, d, row_begin, 0, regs);
  for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
    float sc[2][2], pn[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = t0 + logical<kMode>(warp * 16 + nt * 8 + tig * 2 + j);
        const bool in = row < row_end;
        sc[nt][j] = in && kMode != kMmOnly ? scale[row] : 0.f;
        pn[nt][j] = in ? (kMode != kMmOnly ? penalty[row] : 0.f) : -INFINITY;
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
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qq = mt * 8 + g, c = warp * 16 + nt * 8 + tig * 2 + j;
          if constexpr (kMode == kMmOnly) {
            // the raw digit-1 dot; rows past the range count as -inf
            S[qq * kTile + c] = pn[nt][j] == -INFINITY
                                    ? -INFINITY
                                    : __int2float_rn(acc[mt][nt][j]);
          } else {
            const float d1 = __int2float_rn(acc[mt][nt][j] - qoff_s[qq]);
            const float d2 =
                __int2float_rn(acc[mt][nt][j + 2] - qoff_s[QB + qq]);
            S[qq * kTile + c] = __fadd_rn(
                __fmul_rn(__fmaf_rn(rho_s[qq], d2, d1), sc[nt][j]), pn[nt][j]);
          }
        }
    __syncthreads();
    for (int qq = warp; qq < QB && q0 + qq < q; qq += kThreads / 32) {
      if constexpr (kMode == kConcat) {
        // logical row r sits at tile row r / 2 (even) or 64 + r / 2 (odd)
        float* ls = bs + qq * kpad;
        int* li = bi + qq * kpad;
#pragma unroll 1
        for (int j = 0; j < kTile / 32; ++j) {
          const int r = j * 32 + lane;
          const int c = (r & 1) ? kTile / 2 + r / 2 : r / 2;
          warp_offer(ls, li, k, S[qq * kTile + c], t0 + r, lane);
        }
      } else {
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < kTile / 32; ++j)
          m = fmaxf(m, S[qq * kTile + j * 32 + lane]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
        if (lane == 0) fmx[qq] = fmaxf(fmx[qq], m);
      }
    }
  }
  __syncthreads();
  if constexpr (kMode == kConcat) {
    store_partials<QB, kThreads>(bs, bi, q0, q, kpad, part_s, part_i);
  } else {
    for (int i = tid; i < QB; i += kThreads)
      if (q0 + i < q) fold[(size_t)(q0 + i) * gridDim.y + blockIdx.y] = fmx[i];
  }
}

template <int kMode, class Stage>
cudaError_t launch_mma(const void* V, const float* scale, const float* penalty,
                       const int8_t* digits, const float* rho, const int* qoff,
                       int n, int d, int q, int k, int n_splits,
                       int rows_per_split, float* part_s, int* part_i,
                       float* fold, cudaStream_t stream) {
  const int kpad = kMode == kConcat ? round_up(k, 32) : 0;
  const size_t bytes =
      digit_smem_bytes(kQB, round_up(d, kChunk), kpad) + kQB * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mma_probe<kMode, Stage>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((q + kQB - 1) / kQB, n_splits);
  mma_probe<kMode, Stage><<<grid, kThreads, bytes, stream>>>(
      V, scale, penalty, digits, rho, qoff, n, d, q, k, kpad, rows_per_split,
      part_s, part_i, fold);
  return cudaGetLastError();
}

}  // namespace

// nibbles [ceil(n/2), d] uint8; scale, penalty [n] f32; digits [2q, d]
// int8; rho [q] f32; qoff [2q] int32; mode as above.  Outputs: dma and
// unpack fold [n_splits] int32; mm_only and nomerge fold [q, n_splits]
// f32; concat1mm and full part_s / part_i [q, n_splits, round_up(k, 32)]
// scratch and out_s / out_i [q, k]; full also grp_s / grp_i [q,
// cdiv(n_splits, 16), k] and count [q] scratch.  Requires q <= 8, d % 16
// == 0, 1 <= k <= 128, rows_per_split % 256 == 0 and n_splits *
// rows_per_split >= n.
extern "C" int int4_probe(const void* nibbles, const void* scale,
                          const void* penalty, const void* digits,
                          const void* rho, const void* qoff, int n, int d,
                          int q, int k, int mode, int n_splits,
                          int rows_per_split, void* part_s, void* part_i,
                          void* out_s, void* out_i, void* fold, void* grp_s,
                          void* grp_i, void* count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kQB || d % 16 || k < 1 || k > 128 ||
      rows_per_split % (2 * kTile) || (long long)n_splits * rows_per_split < n)
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* pn = static_cast<const float*>(penalty);
  const int8_t* dg = static_cast<const int8_t*>(digits);
  const float* rh = static_cast<const float*>(rho);
  const int* qo = static_cast<const int*>(qoff);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* ff = static_cast<float*>(fold);
  cudaError_t err;
  switch (mode) {
    case kDma:
    case kUnpack: {
      dim3 grid(1, n_splits);
      if (mode == kDma)
        stream_probe<kDma><<<grid, kThreads, 0, st>>>(
            nibbles, n, d, rows_per_split, static_cast<int*>(fold));
      else
        stream_probe<kUnpack><<<grid, kThreads, 0, st>>>(
            nibbles, n, d, rows_per_split, static_cast<int*>(fold));
      return (int)cudaGetLastError();
    }
    case kMmOnly:
      return (int)launch_mma<kMmOnly, RowStage>(
          nibbles, sc, pn, dg, rh, qo, (n + 1) / 2, d, q, k, n_splits,
          rows_per_split, ps, pi, ff, st);
    case kNoMerge:
      return (int)launch_mma<kNoMerge, NibbleStage>(
          nibbles, sc, pn, dg, rh, qo, n, d, q, k, n_splits, rows_per_split,
          ps, pi, ff, st);
    case kConcat:
      err = launch_mma<kConcat, ConcatStage>(nibbles, sc, pn, dg, rh, qo, n,
                                             d, q, k, n_splits, rows_per_split,
                                             ps, pi, ff, st);
      if (err != cudaSuccess) return (int)err;
      return (int)launch_merge(ps, pi, q, n_splits, k,
                               static_cast<float*>(out_s),
                               static_cast<int*>(out_i), st);
    case 5: {
      err = cudaMemsetAsync(count, 0, (size_t)q * sizeof(int), st);
      if (err != cudaSuccess) return (int)err;
      const FlatDigitCall c = {
          nullptr, q, d, n, k, n_splits, rows_per_split, nibbles, sc, pn,
          const_cast<int8_t*>(dg), const_cast<float*>(rh), nullptr,
          const_cast<int*>(qo),
          {ps, pi, static_cast<float*>(grp_s), static_cast<int*>(grp_i),
           static_cast<int*>(count), static_cast<float*>(out_s),
           static_cast<int*>(out_i)},
          nullptr};
      return launch_flat_digit(
          c, false, [&](int) { return flat_partial<NibbleStage, kQB>(c, st); },
          st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fixed and per-tile costs of the bf16 flat scan at 1M x 768:
// variants of the first flat_topk.cu's partial_topk (synchronous tile loads
// over fixed row ranges; the production scan has since moved onto the
// cp.async ring of ivf_float_scan.cuh), each a template instance of the
// pieces in float_scan.cuh and topk_select.cuh.
//
// Replaces: benchmarks/scan_overhead_probe.py, build (:136; pallas_call
// :142, kernel make_kernel :54), the TPU probe of pallas_flat_topk_dma.
//
// Variants (slots, merge):
//   prod    (0, 1): that partial_topk: tile_dots stages each
//                   128-row x 64-dim chunk with synchronous 16-byte loads,
//                   then the k-th-best gate and the partial top-k
//                   (probe_select.cuh's offer_each, one insertion a
//                   candidate);
//   nomerge (0, 0): the same products with the gate off: the max of each
//                   query's scores over the CTA's rows is folded instead
//                   -> fold[q, split];
//   slot2, slot3, slot4 (2..4, 1): the chunks stream through a cp.async
//                   ring of that many stages (the TPU probe's 2-, 3- and
//                   4-slot prefetch): the copies of the next slots-1
//                   chunks are in flight while one chunk's MMAs run.
// score[q, r] = q . v_r - penalty[r] in f32 (alpha 1), ties to the lower
// row id, as flat_topk.cu.  A CTA owns rows_per_split rows (a multiple of
// 128); the TPU probe's tile sweep (2048, 4096 rows of VMEM) becomes a
// sweep of that range, the rows one CTA streams in sequence.  The merged
// variants end with merge_topk.
//
// Bound on the H100: 1M x 768 bf16 plus the f32 penalty is 1.615 GB, 0.482
// ms at 3.35 TB/s; 2 x 8 x 1M x 768 flops are far under the bf16 ridge.

#include "float_scan.cuh"
#include "probe_select.cuh"

namespace {

constexpr int kQB = 16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// cp.async of the 128 x 64 chunk (rows t0.., dims kc..) into Vs, zero
// past n and d.
__device__ void stage_chunk_async(const __nv_bfloat16* __restrict__ V, int n,
                                  int d, int t0, int kc, __nv_bfloat16* Vs) {
  const int vs = Layout<true>::v_stride();
  for (int i = threadIdx.x; i < kTile * (kChunk / 8); i += kThreads) {
    const int r = i / (kChunk / 8), c8 = (i % (kChunk / 8)) * 8;
    const int row = t0 + r, col = kc + c8;
    const bool ok = row < n && col < d;
    cp_async16(Vs + r * vs + c8, ok ? V + (size_t)row * d + col : V,
               ok ? 16 : 0);
  }
}

// tile_dots's products for one staged chunk (dims kc..kc+63).
__device__ __forceinline__ void chunk_mma(const __nv_bfloat16* Qs, int qs,
                                          int kc, const __nv_bfloat16* Vs,
                                          float acc[2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int vs = Layout<true>::v_stride();
#pragma unroll
  for (int ks = 0; ks < kChunk; ks += 16) {
    uint32_t b[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat16* p = Vs + (warp * 16 + nt * 8 + g) * vs + ks + tig * 2;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
    const __nv_bfloat16* p = Qs + g * qs + kc + ks + tig * 2;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(p);
    a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * qs);
    a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * qs + 8);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[nt], a, b[nt]);
  }
}

// The tile's raw dots in S -> scores (minus the penalty, -inf past the
// range), then the partial top-k or the folded max.
template <bool kMerge>
__device__ void finish_tile(float* S, const float* __restrict__ penalty,
                            int q0, int q, int t0, int row_end, int n, int k,
                            int kpad, float* bs, int* bi, float* fmx) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  for (int i = tid; i < kQB * kTile; i += kThreads) {
    const int row = t0 + i % kTile;
    S[i] = row < row_end ? __fsub_rn(S[i], penalty[row]) : -INFINITY;
  }
  __syncthreads();
  if constexpr (kMerge) {
    for (int qq = warp; qq < kQB && q0 + qq < q; qq += kThreads / 32)
#pragma unroll 1
      for (int j = 0; j < kTile / 32; ++j)
        offer_each(bs + qq * kpad, bi + qq * kpad, k,
                   S[qq * kTile + j * 32 + lane], t0 + j * 32 + lane, lane);
  } else {
    for (int qq = warp; qq < kQB && q0 + qq < q; qq += kThreads / 32) {
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

template <int kSlots, bool kMerge>
__global__ void __launch_bounds__(kThreads)
overhead_scan(const __nv_bfloat16* __restrict__ V,
              const float* __restrict__ penalty,
              const __nv_bfloat16* __restrict__ queries, int n, int d, int q,
              int k, int kpad, int rows_per_split, float* __restrict__ part_s,
              int* __restrict__ part_i, float* __restrict__ fold) {
  constexpr int kRing = kSlots > 0 ? kSlots : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = round_up(d, kChunk);
  const int qs = Layout<true>::q_stride(dp);
  const int chunk_elems = kTile * Layout<true>::v_stride();
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Qs + kQB * qs;
  float* S = reinterpret_cast<float*>(Vs + kRing * chunk_elems);
  float* bs = S + kQB * kTile;
  int* bi = reinterpret_cast<int*>(bs + kQB * kpad);
  float* fmx = reinterpret_cast<float*>(bi + kQB * kpad);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kQB;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);

  stage_queries<true, kQB>(queries, q, d, dp, q0, Qs);
  for (int i = tid; i < kQB * kpad; i += kThreads) {
    bs[i] = -INFINITY;
    bi[i] = -1;
  }
  for (int i = tid; i < kQB; i += kThreads) fmx[i] = -INFINITY;

  if constexpr (kSlots == 0) {
    for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
      tile_dots<kQB>(V, n, d, dp, t0, Qs, Vs, S);
      finish_tile<kMerge>(S, penalty, q0, q, t0, row_end, n, k, kpad, bs, bi,
                          fmx);
    }
  } else {
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, tig = lane & 3;
    const int nch = dp / kChunk;
    const int tiles = row_begin < row_end
                          ? (row_end - row_begin + kTile - 1) / kTile
                          : 0;
    const int units = tiles * nch;  // (tile, chunk) pairs, in order
    auto issue = [&](int u) {
      if (u < units)
        stage_chunk_async(V, n, d, row_begin + (u / nch) * kTile,
                          (u % nch) * kChunk, Vs + (u % kSlots) * chunk_elems);
      cp_commit();  // one group a unit, empty past the end
    };
    __syncthreads();  // the query block is staged
    for (int u = 0; u < kSlots - 1; ++u) issue(u);
    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
    for (int u = 0; u < units; ++u) {
      issue(u + kSlots - 1);
      cp_wait<kSlots - 1>();  // unit u has landed (this thread's copies)
      __syncthreads();        // ... and every thread's
      const int chunk = u % nch;
      chunk_mma(Qs, qs, chunk * kChunk, Vs + (u % kSlots) * chunk_elems, acc);
      if (chunk == nch - 1) {
        const int t0 = row_begin + (u / nch) * kTile;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = warp * 16 + nt * 8 + tig * 2;
          S[g * kTile + c] = acc[nt][0];
          S[g * kTile + c + 1] = acc[nt][1];
          S[(g + 8) * kTile + c] = acc[nt][2];
          S[(g + 8) * kTile + c + 1] = acc[nt][3];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
        }
        finish_tile<kMerge>(S, penalty, q0, q, t0, row_end, n, k, kpad, bs,
                            bi, fmx);
      }
      __syncthreads();  // slot u % kSlots is free for the next issue
    }
    cp_wait<0>();
  }
  __syncthreads();
  if constexpr (kMerge) {
    store_partials<kQB, kThreads>(bs, bi, q0, q, kpad, part_s, part_i);
  } else {
    for (int i = tid; i < kQB; i += kThreads)
      if (q0 + i < q) fold[(size_t)(q0 + i) * gridDim.y + blockIdx.y] = fmx[i];
  }
}

template <int kSlots, bool kMerge>
cudaError_t launch(const void* V, const float* penalty, const void* queries,
                   int n, int d, int q, int k, int n_splits,
                   int rows_per_split, float* part_s, int* part_i,
                   float* fold, cudaStream_t stream) {
  const int kpad = kMerge ? round_up(k, 32) : 0;
  const int dp = round_up(d, kChunk);
  const size_t bytes =
      (size_t)kQB * Layout<true>::q_stride(dp) * 2 +
      (size_t)(kSlots > 0 ? kSlots : 1) * kTile * Layout<true>::v_stride() * 2 +
      (size_t)kQB * kTile * 4 + (size_t)kQB * kpad * 8 + kQB * 4;
  cudaError_t err = cudaFuncSetAttribute(
      overhead_scan<kSlots, kMerge>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((q + kQB - 1) / kQB, n_splits);
  overhead_scan<kSlots, kMerge><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(V), penalty,
      static_cast<const __nv_bfloat16*>(queries), n, d, q, k, kpad,
      rows_per_split, part_s, part_i, fold);
  return cudaGetLastError();
}

}  // namespace

// vectors [n, d] bf16, penalty [n] f32, queries [q, d] bf16; slots 0
// (synchronous tile loads), 2, 3 or 4; merge 1: part_s / part_i [q,
// n_splits, round_up(k, 32)] scratch and out_s / out_i [q, k]; merge 0
// (slots 0 only): fold [q, n_splits] f32.  Requires q <= 16, d % 8 == 0,
// 1 <= k <= 128, rows_per_split % 128 == 0 and n_splits * rows_per_split
// >= n.
extern "C" int scan_overhead_probe(const void* vectors, const void* penalty,
                                   const void* queries, int n, int d, int q,
                                   int k, int slots, int merge, int n_splits,
                                   int rows_per_split, void* part_s,
                                   void* part_i, void* out_s, void* out_i,
                                   void* fold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q < 1 || q > kQB || d % 8 || k < 1 || k > 128 ||
      rows_per_split % kTile || (long long)n_splits * rows_per_split < n)
    return (int)cudaErrorInvalidValue;
  const float* pn = static_cast<const float*>(penalty);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* ff = static_cast<float*>(fold);
  cudaError_t err;
  if (!merge) {
    if (slots != 0) return (int)cudaErrorInvalidValue;
    return (int)launch<0, false>(vectors, pn, queries, n, d, q, k, n_splits,
                                 rows_per_split, ps, pi, ff, st);
  }
  switch (slots) {
    case 0:
      err = launch<0, true>(vectors, pn, queries, n, d, q, k, n_splits,
                            rows_per_split, ps, pi, ff, st);
      break;
    case 2:
      err = launch<2, true>(vectors, pn, queries, n, d, q, k, n_splits,
                            rows_per_split, ps, pi, ff, st);
      break;
    case 3:
      err = launch<3, true>(vectors, pn, queries, n, d, q, k, n_splits,
                            rows_per_split, ps, pi, ff, st);
      break;
    case 4:
      err = launch<4, true>(vectors, pn, queries, n, d, q, k, n_splits,
                            rows_per_split, ps, pi, ff, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(ps, pi, q, n_splits, k, static_cast<float*>(out_s),
                           static_cast<int*>(out_i), st);
}

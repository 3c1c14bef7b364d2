// Exact masked top-k over a device-resident [N, D] corpus.
//
// Replaces: tpu_search/ops/pallas_topk_dma.py, pallas_flat_topk_dma
// (kernel body _kernel), the scan behind every search of the flat index.
//
// Contract (the same as the TPU kernel):
//   score[q, r] = alpha * dot(query[q], vector[r]) - penalty[r]
// with penalty 0 (ip, live row), |v|^2 (l2, live row) or +inf (masked row),
// f32 accumulation, queries already cast to the corpus dtype by the caller.
// Output: the k best scores per query, descending, ties broken by the
// lower row id (the TPU kernel's _select_topk order); slots past the live
// rows carry -inf and id -1.  For k > 128 (flat_scores) the kernel writes
// the masked [Q, N] scores instead, and the caller selects with a stable
// sort, as the JAX package sends k > 128 to its XLA scan.
//
// What bounds it on the H100: at small Q the scan reads N*D*2 bytes of
// bf16 corpus for 2*Q*N*D flops, far under the ~295 flop/byte ridge, so
// HBM bandwidth bounds it; at Q=128 the dot products approach the
// tensor-core limit of mma.sync.  The top-k selection is a branch-heavy
// merge that must stay off the critical path.
//
// Design: the TPU kernel walks the corpus in ONE sequential grid and
// carries a running top-k across steps; Hopper's CTAs run in parallel and
// carry nothing between them.  So N is split into contiguous row ranges,
// one per CTA (blockIdx.y), and each CTA keeps a per-query partial top-k
// of its range in shared memory.  A second kernel merges the partials.
//  - A CTA stages its query block (16 or 32 queries) in shared memory once,
//    then walks its rows in tiles of 128: the tile is staged in 64-dim
//    chunks with 16-byte loads, and each of the 8 warps computes 16 rows x
//    QB queries with mma.sync m16n8k16 (bf16 in, f32 accumulate).  f32
//    corpora take a plain FMA path with the same staging.
//  - The tile's scores go to shared memory; one warp per query compares
//    them with the current k-th best (the pruning gate of the TPU kernel)
//    and inserts the few that beat it into a sorted list (topk_select.cuh:
//    first-index tie order in the partial lists and the merge).
//  - The query blocks of one row range are neighbours in blockIdx.x, so
//    they run together and read the range once from HBM, then from L2.
// Not yet done (later work): cp.async/TMA double buffering and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "topk_select.cuh"

namespace {

constexpr int kTile = 128;    // corpus rows per tile
constexpr int kChunk = 64;    // dims staged per pass
constexpr int kThreads = 256; // 8 warps

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kBf16>
struct Layout {
  using T = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  static __host__ __device__ int q_stride(int dp) { return kBf16 ? dp + 8 : dp; }
  static __host__ __device__ int v_stride() { return kBf16 ? kChunk + 8 : kChunk + 1; }
  static __host__ __device__ size_t bytes(int qb, int dp, int kpad) {
    return (size_t)qb * q_stride(dp) * sizeof(T) +
           (size_t)kTile * v_stride() * sizeof(T) + (size_t)qb * kTile * 4 +
           (size_t)qb * kpad * 8;
  }
};

// Raw dot products of the tile's rows with the block's queries -> S.
template <int QB>
__device__ void tile_dots(const __nv_bfloat16* __restrict__ V, int n, int d,
                          int dp, int t0, const __nv_bfloat16* Qs,
                          __nv_bfloat16* Vs, float* S) {
  constexpr int MT = QB / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int qs = Layout<true>::q_stride(dp), vs = Layout<true>::v_stride();
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int kc = 0; kc < dp; kc += kChunk) {
    __syncthreads();
    for (int i = tid; i < kTile * (kChunk / 8); i += kThreads) {
      const int r = i / (kChunk / 8), c8 = (i % (kChunk / 8)) * 8;
      const int row = t0 + r, col = kc + c8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < n && col < d)
        v = *reinterpret_cast<const uint4*>(V + (size_t)row * d + col);
      *reinterpret_cast<uint4*>(Vs + r * vs + c8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 16) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* p = Vs + (warp * 16 + nt * 8 + g) * vs + ks + tig * 2;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* p = Qs + (mt * 16 + g) * qs + kc + ks + tig * 2;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(p);
        a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * qs);
        a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * qs + 8);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int q = mt * 16 + g, c = warp * 16 + nt * 8 + tig * 2;
      S[q * kTile + c] = acc[mt][nt][0];
      S[q * kTile + c + 1] = acc[mt][nt][1];
      S[(q + 8) * kTile + c] = acc[mt][nt][2];
      S[(q + 8) * kTile + c + 1] = acc[mt][nt][3];
    }
}

template <int QB>
__device__ void tile_dots(const float* __restrict__ V, int n, int d, int dp,
                          int t0, const float* Qs, float* Vs, float* S) {
  constexpr int kGroups = kThreads / kTile;  // query groups per thread
  constexpr int kPer = QB / kGroups;
  const int tid = threadIdx.x;
  const int r = tid % kTile, qg = tid / kTile;
  const int vs = Layout<false>::v_stride();
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < dp; kc += kChunk) {
    __syncthreads();
    for (int i = tid; i < kTile * kChunk; i += kThreads) {
      const int rr = i / kChunk, c = i % kChunk;
      const int row = t0 + rr, col = kc + c;
      Vs[rr * vs + c] = (row < n && col < d) ? V[(size_t)row * d + col] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kChunk; ++c) {
      const float v = Vs[r * vs + c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(Qs[(qg + kGroups * i) * dp + kc + c], v, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) S[(qg + kGroups * i) * kTile + r] = acc[i];
}

template <bool kBf16, int QB>
__global__ void __launch_bounds__(kThreads)
partial_topk(const typename Layout<kBf16>::T* __restrict__ V,
             const float* __restrict__ penalty,
             const typename Layout<kBf16>::T* __restrict__ queries, int n,
             int d, int q, int k, int kpad, int rows_per_split, float alpha,
             float* __restrict__ part_s, int* __restrict__ part_i,
             float* __restrict__ out_scores) {
  using T = typename Layout<kBf16>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = round_up(d, kChunk);
  const int qs = Layout<kBf16>::q_stride(dp);
  T* Qs = reinterpret_cast<T*>(smem);
  T* Vs = Qs + QB * qs;
  float* S = reinterpret_cast<float*>(Vs + kTile * Layout<kBf16>::v_stride());
  float* bs = S + QB * kTile;
  int* bi = reinterpret_cast<int*>(bs + QB * kpad);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);

  for (int i = tid; i < QB * dp; i += kThreads) {
    const int qq = i / dp, dd = i % dp;
    T v = T(0.f);
    if (q0 + qq < q && dd < d) v = queries[(size_t)(q0 + qq) * d + dd];
    Qs[qq * qs + dd] = v;
  }
  for (int i = tid; i < QB * kpad; i += kThreads) {
    bs[i] = -INFINITY;
    bi[i] = -1;
  }

  for (int t0 = row_begin; t0 < row_end; t0 += kTile) {
    tile_dots<QB>(V, n, d, dp, t0, Qs, Vs, S);
    __syncthreads();
    for (int i = tid; i < QB * kTile; i += kThreads) {
      const int row = t0 + i % kTile;
      float s = S[i];
      if (alpha != 1.f) s = __fmul_rn(s, alpha);
      S[i] = row < row_end ? __fsub_rn(s, penalty[row]) : -INFINITY;
    }
    __syncthreads();
    consume_tile<QB, kTile, kThreads>(S, q0, q, t0, row_end, n, k, kpad, bs,
                                      bi, out_scores);
  }
  if (out_scores) return;
  __syncthreads();
  store_partials<QB, kThreads>(bs, bi, q0, q, kpad, part_s, part_i);
}

template <bool kBf16, int QB>
cudaError_t launch(const void* vectors, const float* penalty,
                   const void* queries, int n, int d, int q, int k,
                   float alpha, int n_splits, int rows_per_split,
                   float* part_s, int* part_i, float* out_scores,
                   cudaStream_t stream) {
  using T = typename Layout<kBf16>::T;
  const int kpad = out_scores ? 0 : round_up(k, 32);
  const size_t bytes = Layout<kBf16>::bytes(QB, round_up(d, kChunk), kpad);
  cudaError_t err = cudaFuncSetAttribute(
      partial_topk<kBf16, QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((q + QB - 1) / QB, n_splits);
  partial_topk<kBf16, QB><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(vectors), penalty, static_cast<const T*>(queries),
      n, d, q, k, kpad, rows_per_split, alpha, part_s, part_i, out_scores);
  return cudaGetLastError();
}

cudaError_t launch_partial(const void* vectors, const float* pen,
                           const void* queries, int n, int d, int q, int k,
                           int is_bf16, float alpha, int n_splits,
                           int rows_per_split, float* ps, int* pi,
                           float* out_scores, cudaStream_t st) {
  if (is_bf16)
    return q <= 16 ? launch<true, 16>(vectors, pen, queries, n, d, q, k, alpha,
                                      n_splits, rows_per_split, ps, pi,
                                      out_scores, st)
                   : launch<true, 32>(vectors, pen, queries, n, d, q, k, alpha,
                                      n_splits, rows_per_split, ps, pi,
                                      out_scores, st);
  return q <= 16 ? launch<false, 16>(vectors, pen, queries, n, d, q, k, alpha,
                                     n_splits, rows_per_split, ps, pi,
                                     out_scores, st)
                 : launch<false, 32>(vectors, pen, queries, n, d, q, k, alpha,
                                     n_splits, rows_per_split, ps, pi,
                                     out_scores, st);
}

}  // namespace

// vectors [n, d] (bf16 if is_bf16 else f32), penalty [n] f32, queries
// [q, d] in the corpus dtype, part_s/part_i [q, n_splits, round_up(k, 32)]
// scratch, out_s/out_i [q, k].  rows_per_split is a multiple of 128 and
// n_splits * rows_per_split >= n.  Requires d % 8 == 0, 1 <= k <= 128.
extern "C" int flat_topk(const void* vectors, const void* penalty,
                         const void* queries, int n, int d, int q, int k,
                         int is_bf16, float alpha, int n_splits,
                         int rows_per_split, void* part_s, void* part_i,
                         void* out_s, void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err = launch_partial(vectors, static_cast<const float*>(penalty),
                                   queries, n, d, q, k, is_bf16, alpha,
                                   n_splits, rows_per_split, ps, pi, nullptr,
                                   st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(ps, pi, q, n_splits, k, static_cast<float*>(out_s),
                           static_cast<int*>(out_i), st);
}

// The scores-only mode (k > 128): the same products, alpha and penalty,
// written to scores [q, n] f32 for a selection outside the kernel.
extern "C" int flat_scores(const void* vectors, const void* penalty,
                           const void* queries, int n, int d, int q,
                           int is_bf16, float alpha, int n_splits,
                           int rows_per_split, void* scores, void* stream) {
  return (int)launch_partial(vectors, static_cast<const float*>(penalty),
                             queries, n, d, q, 0, is_bf16, alpha, n_splits,
                             rows_per_split, nullptr, nullptr,
                             static_cast<float*>(scores),
                             static_cast<cudaStream_t>(stream));
}

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
//    then walks its rows in tiles of 128 (float_scan.cuh tile_dots: 64-dim
//    chunks, mma.sync m16n8k16 bf16 -> f32; f32 corpora a plain FMA path).
//  - The tile's scores go to shared memory; one warp per query compares
//    them with the current k-th best (the pruning gate of the TPU kernel)
//    and inserts the few that beat it into a sorted list (topk_select.cuh:
//    first-index tie order in the partial lists and the merge).
//  - The query blocks of one row range are neighbours in blockIdx.x, so
//    they run together and read the range once from HBM, then from L2.
// Not yet done (later work): cp.async/TMA double buffering and wgmma.

#include "float_scan.cuh"

namespace {

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
  T* Qs = reinterpret_cast<T*>(smem);
  T* Vs = Qs + QB * Layout<kBf16>::q_stride(dp);
  float* S = reinterpret_cast<float*>(Vs + kTile * Layout<kBf16>::v_stride());
  float* bs = S + QB * kTile;
  int* bi = reinterpret_cast<int*>(bs + QB * kpad);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);

  stage_queries<kBf16, QB>(queries, q, d, dp, q0, Qs);
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

// IVF probe scan over bf16 / f32 cluster blocks.
//
// Replaces: tpu_search/ops/pallas_ivf_scan.py, pallas_ivf_topk (:213, body
// _kernel_ivf :104), the scan behind every search of a bf16 / f32 IVF
// index.
//
// Contract (the TPU kernel's): the corpus is the index's [nlist, cap, D]
// block viewed as nlist * cap rows, a row's id its flat slot cluster * cap
// + slot.  The schedule (ops/ivf_scan.py build_probe_schedule, a device
// pre-pass) lists the 128-row tiles inside each probed cluster's fill,
// ascending; its length n_sched stays on the device.  For query q and a
// row of scheduled cluster c:
//   score = alpha * dot(query[q], row) - penalty[row]   if q probes c
//         = -inf                                        otherwise
// penalty 0 (ip, live) / |v|^2 (l2, live) / +inf (tombstoned, filtered or
// past the fill).  Output: the k best per query, descending, first-index
// (lowest flat slot) ties, -inf / -1 past the live candidates; with
// scores set (k > 128) the masked scores of every schedule position
// instead, [q, max_sched * 128], for a stable sort outside.
//
// What bounds it on the H100: the bytes of the scheduled tiles (D * 2 B a
// row for bf16) at small Q, as the flat scan; the TPU kernel streams each
// probed cluster's fill prefix once, and so does this one.
//
// Design: the TPU kernel walks the schedule in one sequential grid with a
// running top-k.  Here the schedule is cut into contiguous runs of
// entries, one CTA per (query block, run), each with sorted partial lists
// behind a k-th-best gate (topk_select.cuh), merged in run order, which
// keeps first-index ties since the schedule ascends in flat slot.  The
// grid is sized from the static bound max_sched = min(Q * nprobe, nlist) *
// cap / 128, and a CTA reads n_sched itself and stops there: no host sync.
// Membership: a CTA looks up its queries' probe positions of the entry's
// cluster (pos [q, nlist], -1 = not probed); when none of its queries
// probes the cluster it skips the tile's bytes entirely, otherwise the
// rows of non-member queries score -inf, as the TPU kernel masks them.
// Not yet done (later work): prefetch across tiles, cp.async/TMA, wgmma.

#include "float_scan.cuh"

namespace {

template <bool kBf16, int QB>
__global__ void __launch_bounds__(kThreads)
ivf_partial(const typename Layout<kBf16>::T* __restrict__ V,
            const float* __restrict__ penalty,
            const typename Layout<kBf16>::T* __restrict__ queries,
            const int* __restrict__ tile_idx, const int* __restrict__ clusters,
            const int* __restrict__ n_sched_p, const int* __restrict__ pos,
            int n, int d, int q, int k, int kpad, int nlist, int max_sched,
            int eps, float alpha, float* __restrict__ part_s,
            int* __restrict__ part_i, float* __restrict__ out_scores) {
  using T = typename Layout<kBf16>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = round_up(d, kChunk);
  T* Qs = reinterpret_cast<T*>(smem);
  T* Vs = Qs + QB * Layout<kBf16>::q_stride(dp);
  float* S = reinterpret_cast<float*>(Vs + kTile * Layout<kBf16>::v_stride());
  float* bs = S + QB * kTile;
  int* bi = reinterpret_cast<int*>(bs + QB * kpad);
  int* member_s = bi + QB * kpad;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int n_sched = min(*n_sched_p, max_sched);
  const int j0 = blockIdx.y * eps;
  const int j1 = min(j0 + eps, n_sched);
  const size_t n_out = (size_t)max_sched * kTile;

  stage_queries<kBf16, QB>(queries, q, d, dp, q0, Qs);
  for (int i = tid; i < QB * kpad; i += kThreads) {
    bs[i] = -INFINITY;
    bi[i] = -1;
  }

  for (int j = j0; j < j1; ++j) {
    const int c = clusters[j];
    __syncthreads();  // the previous tile's readers are done
    int member = 0;
    if (tid < QB) {
      member = q0 + tid < q && pos[(size_t)(q0 + tid) * nlist + c] >= 0;
      member_s[tid] = member;
    }
    if (!__syncthreads_or(member)) continue;  // no query probes c
    const int t0 = tile_idx[j] * kTile;
    tile_dots<QB>(V, n, d, dp, t0, Qs, Vs, S);
    __syncthreads();
    for (int i = tid; i < QB * kTile; i += kThreads) {
      float s = S[i];
      if (alpha != 1.f) s = __fmul_rn(s, alpha);
      S[i] = member_s[i / kTile] ? __fsub_rn(s, penalty[t0 + i % kTile])
                                 : -INFINITY;
    }
    __syncthreads();
    if (out_scores) {
      for (int i = tid; i < QB * kTile; i += kThreads) {
        const int qq = i / kTile;
        if (q0 + qq < q)
          out_scores[(size_t)(q0 + qq) * n_out + (size_t)j * kTile + i % kTile] =
              S[i];
      }
    } else {
      consume_tile<QB, kTile, kThreads>(S, q0, q, t0, t0 + kTile, n, k, kpad,
                                        bs, bi, nullptr);
    }
  }
  if (out_scores) return;
  __syncthreads();
  store_partials<QB, kThreads>(bs, bi, q0, q, kpad, part_s, part_i);
}

template <bool kBf16, int QB>
cudaError_t launch(const void* blocks, const float* penalty,
                   const void* queries, const int* tile_idx,
                   const int* clusters, const int* n_sched, const int* pos,
                   int n, int d, int q, int k, int nlist, float alpha,
                   int max_sched, int eps, int n_splits, float* part_s,
                   int* part_i, float* out_scores, cudaStream_t stream) {
  using T = typename Layout<kBf16>::T;
  const int kpad = out_scores ? 0 : round_up(k, 32);
  const size_t bytes =
      Layout<kBf16>::bytes(QB, round_up(d, kChunk), kpad) + QB * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_partial<kBf16, QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((q + QB - 1) / QB, n_splits);
  ivf_partial<kBf16, QB><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(blocks), penalty, static_cast<const T*>(queries),
      tile_idx, clusters, n_sched, pos, n, d, q, k, kpad, nlist, max_sched,
      eps, alpha, part_s, part_i, out_scores);
  return cudaGetLastError();
}

}  // namespace

// blocks [n / cap, cap, d] (bf16 if is_bf16 else f32) viewed as n rows;
// penalty [n] f32; queries [q, d] in the block dtype; tile_idx / clusters
// [max_sched + 1] int32 and n_sched [1] int32 (build_probe_schedule); pos
// [q, nlist] int32; part_s / part_i [q, n_splits, round_up(k, 32)]
// scratch; out_s / out_i [q, k].  With scores non-null (k > 128) only the
// masked scores [q, max_sched * 128] f32 are written (the caller fills them
// with -inf first).  n_splits * eps >= max_sched.  Requires d % 8 == 0.
extern "C" int ivf_topk(const void* blocks, const void* penalty,
                        const void* queries, const void* tile_idx,
                        const void* clusters, const void* n_sched,
                        const void* pos, int n, int d, int q, int k, int nlist,
                        int is_bf16, float alpha, int max_sched, int eps,
                        int n_splits, void* part_s, void* part_i, void* out_s,
                        void* out_i, void* scores, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* sc = static_cast<float*>(scores);
  auto run = [&](auto bf16, auto qb) {
    return launch<decltype(bf16)::value, decltype(qb)::value>(
        blocks, static_cast<const float*>(penalty), queries,
        static_cast<const int*>(tile_idx), static_cast<const int*>(clusters),
        static_cast<const int*>(n_sched), static_cast<const int*>(pos), n, d,
        q, k, nlist, alpha, max_sched, eps, n_splits, ps, pi, sc, st);
  };
  using B1 = std::true_type;
  using B0 = std::false_type;
  using Q16 = std::integral_constant<int, 16>;
  using Q32 = std::integral_constant<int, 32>;
  cudaError_t err =
      is_bf16 ? (q <= 16 ? run(B1{}, Q16{}) : run(B1{}, Q32{}))
              : (q <= 16 ? run(B0{}, Q16{}) : run(B0{}, Q32{}));
  if (err != cudaSuccess || sc) return (int)err;
  return (int)launch_merge(ps, pi, q, n_splits, k, static_cast<float*>(out_s),
                           static_cast<int*>(out_i), st);
}

// Top-k selection shared by the scan kernels (flat_topk.cu,
// flat_topk_int8.cu, flat_topk_int4.cu, the IVF scans and the probes);
// merge_topk serves flat_topk.cu and the probes (the flat digit scans and
// the ring-fed scans merge with run_merge.cuh).
//
// A scan CTA keeps, per query, a list of the k best (score, row id) pairs
// of its row range in shared memory, sorted by score descending and id
// ascending.  Candidates arrive 32 at a time, one per lane with ids
// ascending with the lane, and rows are visited in increasing order, so a
// strict '>' against the k-th best keeps the first-index tie order of the
// TPU kernels' _select_topk.  merge_topk then folds the per-range lists of
// one query in range order, which keeps that order across ranges.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lanes.cuh"

namespace {

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Insert (s, id) into a list sorted by (score desc, id asc) of length k
// (k <= 128), held in shared memory.  Precondition: s > ls[k-1] and id is
// larger than every listed id of equal score.  Warp-cooperative.
__device__ void warp_insert(float* ls, int* li, int k, float s, int id,
                            int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int e = base + lane;
    pos += __popc(__ballot_sync(kFull, e < k && ls[e] >= s));
  }
  float vs[4];
  int vi[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = r * 32 + lane;
    if (e < k && e > pos) {
      vs[r] = ls[e - 1];
      vi[r] = li[e - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int e = r * 32 + lane;
    if (e < k && e > pos) {
      ls[e] = vs[r];
      li[e] = vi[r];
    } else if (e == pos) {
      ls[e] = s;
      li[e] = id;
    }
  }
  __syncwarp();
}

// Offer 32 candidates (one per lane, ids ascending with the lane) to a
// sorted list.  Returns false when none of them beat the k-th best.
__device__ bool warp_offer(float* ls, int* li, int k, float s, int id,
                           int lane) {
  unsigned m = __ballot_sync(kFull, s > ls[k - 1]);
  if (!m) return false;
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const float sb = __shfl_sync(kFull, s, b);
    const int ib = __shfl_sync(kFull, id, b);
    if (sb > ls[k - 1]) warp_insert(ls, li, k, sb, ib, lane);
  }
  return true;
}

// One warp per query: merge the per-range partial lists, in range order.
// part_s / part_i are [q, n_splits, kpad]; out_s / out_i are [q, k].
__global__ void merge_topk(const float* __restrict__ part_s,
                           const int* __restrict__ part_i, int n_splits, int k,
                           int kpad, float* __restrict__ out_s,
                           int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  float* ls = reinterpret_cast<float*>(merge_smem);
  int* li = reinterpret_cast<int*>(ls + kpad);
  const int qi = blockIdx.x, lane = threadIdx.x;
  for (int e = lane; e < kpad; e += 32) {
    ls[e] = -INFINITY;
    li[e] = -1;
  }
  __syncwarp();
  const size_t base = (size_t)qi * n_splits * kpad;
  for (int s0 = 0; s0 < n_splits; s0 += 32) {
    // One load brings the best score of 32 lists.  A sorted list whose
    // best does not beat the current k-th best adds nothing, so only the
    // others are read, still in range order.
    const int own = s0 + lane;
    const float head =
        own < n_splits ? part_s[base + (size_t)own * kpad] : -INFINITY;
    unsigned live = __ballot_sync(kFull, head > ls[k - 1]);
    while (live) {
      const int b = __ffs(live) - 1;
      live &= live - 1;
      if (!(__shfl_sync(kFull, head, b) > ls[k - 1])) continue;
      const float* cs = part_s + base + (size_t)(s0 + b) * kpad;
      const int* ci = part_i + base + (size_t)(s0 + b) * kpad;
      for (int b0 = 0; b0 < k; b0 += 32) {
        const int e = b0 + lane;
        const float s = e < k ? cs[e] : -INFINITY;
        const int id = e < k ? ci[e] : -1;
        // Once a group of 32 misses, the rest of the list misses too.
        if (!warp_offer(ls, li, k, s, id, lane)) break;
      }
    }
  }
  for (int e = lane; e < k; e += 32) {
    out_s[(size_t)qi * k + e] = ls[e];
    out_i[(size_t)qi * k + e] = li[e];
  }
}

// Launch merge_topk over q queries; returns cudaGetLastError().
inline cudaError_t launch_merge(const float* part_s, const int* part_i,
                                int q, int n_splits, int k, float* out_s,
                                int* out_i, cudaStream_t stream) {
  const int kpad = round_up(k, 32);
  merge_topk<<<q, 32, (size_t)kpad * 8, stream>>>(part_s, part_i, n_splits,
                                                  k, kpad, out_s, out_i);
  return cudaGetLastError();
}

// The per-query tail of a scan CTA's tile: the tile's QB x 128 scores
// (masked rows and rows past the range already -inf) sit in S.  With
// out_scores set (the scores-only mode, for k > 128) they are written to
// out_scores[q, row]; otherwise one warp per query offers them to its list.
template <int QB, int kTile, int kThreads>
__device__ void consume_tile(const float* S, int q0, int q, int t0,
                             int row_end, int n_out, int k, int kpad,
                             float* bs, int* bi, float* out_scores) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (out_scores) {
    for (int i = tid; i < QB * kTile; i += kThreads) {
      const int qq = i / kTile, row = t0 + i % kTile;
      if (q0 + qq < q && row < row_end)
        out_scores[(size_t)(q0 + qq) * n_out + row] = S[i];
    }
    return;
  }
  for (int qq = warp; qq < QB && q0 + qq < q; qq += kThreads / 32) {
    float* ls = bs + qq * kpad;
    int* li = bi + qq * kpad;
#pragma unroll 1
    for (int j = 0; j < kTile / 32; ++j)
      warp_offer(ls, li, k, S[qq * kTile + j * 32 + lane], t0 + j * 32 + lane,
                 lane);
  }
}

// Write a CTA's partial lists to part_s / part_i [q, n_splits, kpad].
template <int QB, int kThreads>
__device__ void store_partials(const float* bs, const int* bi, int q0, int q,
                               int kpad, float* part_s, int* part_i) {
  const int split = blockIdx.y, n_splits = gridDim.y;
  for (int i = threadIdx.x; i < QB * kpad; i += kThreads) {
    const int qq = i / kpad, e = i % kpad;
    if (q0 + qq < q) {
      const size_t o = ((size_t)(q0 + qq) * n_splits + split) * kpad + e;
      part_s[o] = bs[i];
      part_i[o] = bi[i];
    }
  }
}

}  // namespace

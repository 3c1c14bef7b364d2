// The first flat scan's selection and merge, kept for the probes:
// offer_each inserts the candidates that beat a list's k-th best one
// warp_insert at a time (scan_overhead_probe.cu's variants, which measure
// that design), and merge_topk folds one query's per-range lists with one
// warp, in range order (both probes).  The production scans take
// candidates with topk_select.cuh's warp_offer and merge with
// run_merge.cuh.  With warp_offer inlined, scan_overhead_probe's prod
// spilled 100 bytes at 80 registers and read 1.5x slower on an H100, no
// longer the design it stands for.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "topk_select.cuh"

namespace {

// Offer 32 candidates (one per lane, ids ascending with the lane) to a
// sorted list, one warp_insert each.  Returns false when none of them beat
// the k-th best.
__device__ bool offer_each(float* ls, int* li, int k, float s, int id,
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
        if (!offer_each(ls, li, k, s, id, lane)) break;
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

}  // namespace

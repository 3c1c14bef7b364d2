// Top-k selection shared by the scan kernels (flat_topk.cu,
// flat_topk_int8.cu, flat_topk_int4.cu, the IVF scans and int4_probe.cu);
// their partial lists merge in run_merge.cuh (the probes' merge_topk:
// probe_select.cuh).
//
// A scan CTA keeps, per query, a list of the k best (score, row id) pairs
// of its row range in shared memory, sorted by score descending and id
// ascending.  Candidates arrive 32 at a time, one per lane with ids
// ascending with the lane, and rows are visited in increasing order, so a
// strict '>' against the k-th best keeps the first-index tie order of the
// TPU kernels' _select_topk; the merges keep that order across ranges.
//
// Where more than kBatchAt of 32 candidates beat the gate (a range's first
// tiles, whose lists are still filling: about 35 insertions a query for
// k 10 over one 128-row tile), warp_merge takes them in one step, sorted
// in registers and merged by rank; fewer go in one warp_insert each.  The
// result is the same list either way.  Against one warp_insert a candidate
// on an H100 (1M rows, Q 1 and 8): digit_partial 17-27 % faster at k 128,
// within 3 % at k 10 on int8 / int4 rows, 1-5 % slower on the int8 word
// layout at k 10; the IVF ring scans 1.6-1.8x faster at Q 128, k 128.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "lanes.cuh"

namespace {

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The selection's total order: score descending, then row id ascending.
__device__ __forceinline__ bool ranks_before(float sa, int ia, float sb,
                                             int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Candidates beating the gate above which warp_offer merges a group at
// once.
constexpr int kBatchAt = 3;

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

// Merge the candidates of the lanes with live set (each beats the k-th
// best, and its id is above every listed id of equal score) into the
// sorted list of k (k <= 128) in one step: a bitonic sort of the 32 in
// registers (lane 0 the best), then each candidate's and each listed
// entry's new place, its rank plus the count of the other side's entries
// that rank before it.  Warp-cooperative.
__device__ void warp_merge(float* ls, int* li, int k, float s, int id,
                           bool live, int lane) {
  if (!live) {  // ranks after every entry, padding included
    s = -INFINITY;
    id = 0x7fffffff;
  }
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float os = __shfl_xor_sync(kFull, s, stride);
      const int oi = __shfl_xor_sync(kFull, id, stride);
      const bool best_here = ((lane & size) == 0) == ((lane & stride) == 0);
      if (ranks_before(os, oi, s, id) == best_here && (os != s || oi != id)) {
        s = os;
        id = oi;
      }
    }
  // this candidate's place: its rank plus the listed entries before it
  int before = 0;
#pragma unroll
  for (int step = 64; step > 0; step >>= 1)
    if (before + step <= k &&
        ranks_before(ls[before + step - 1], li[before + step - 1], s, id))
      before += step;
  if (before < k && ranks_before(ls[before], li[before], s, id)) ++before;
  const int place = lane + before;
  // listed entry j = 32 r + lane: j plus the candidates before it
  float es[4];
  int ei[4], ep[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = r * 32 + lane;
    es[r] = j < k ? ls[j] : -INFINITY;
    ei[r] = j < k ? li[j] : 0x7fffffff;
    int c = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      const float cs = __shfl_sync(kFull, s, c + step - 1);
      const int ci = __shfl_sync(kFull, id, c + step - 1);
      if (ranks_before(cs, ci, es[r], ei[r])) c += step;
    }
    const float cs = __shfl_sync(kFull, s, c);
    const int ci = __shfl_sync(kFull, id, c);
    if (c < 32 && ranks_before(cs, ci, es[r], ei[r])) ++c;
    ep[r] = j + c;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r * 32 + lane < k && ep[r] < k) {
      ls[ep[r]] = es[r];
      li[ep[r]] = ei[r];
    }
  if (place < k) {
    ls[place] = s;
    li[place] = id;
  }
  __syncwarp();
}

// Offer 32 candidates (one per lane, ids ascending with the lane) to a
// sorted list.  Returns false when none of them beat the k-th best.
__device__ bool warp_offer(float* ls, int* li, int k, float s, int id,
                           int lane) {
  unsigned m = __ballot_sync(kFull, s > ls[k - 1]);
  if (!m) return false;
  if (__popc(m) > kBatchAt) {
    warp_merge(ls, li, k, s, id, (m >> lane) & 1u, lane);
    return true;
  }
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const float sb = __shfl_sync(kFull, s, b);
    const int ib = __shfl_sync(kFull, id, b);
    if (sb > ls[k - 1]) warp_insert(ls, li, k, sb, ib, lane);
  }
  return true;
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

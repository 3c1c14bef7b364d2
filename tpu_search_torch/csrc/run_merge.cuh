// The run split and the merge of the ring-fed scans (ivf_digit_scan.cuh:
// the IVF int8 / int4 scans and the flat int4 and int8 row scans;
// ivf_float_scan.cuh: the IVF and flat bf16 / f32 scans) and of
// digit_partial's row ranges (flat_digit_scan.cuh).
//
// A scan CTA takes the contiguous run [n r / runs, n (r + 1) / runs) of
// its query block's n entries (run_begin) and leaves, per query, a sorted
// list of its run's k best (score, row id) pairs in part_s / part_i [q,
// runs, kpad].  tree_merge merges a query's runs' lists: the lists merged
// pairwise in a tree by merge path, every output its own thread's binary
// search (merge_path_at), ordered by (score descending, row id
// ascending), a total order on the live candidates (ids are unique), so
// the first k are the k best with first-index ties, whatever order the
// lists are merged in.  Groups of kMergeBatch runs merge on CTAs of their
// own; the group's last CTA to finish (a counter a query, zeroed by the
// scan's prologue) merges the groups' lists and writes the k best, times
// the query scale qs1 (__fmul_rn, as ``top * qs1[:, None]``) where the
// scan has one.  On an H100 at one query, an insertion merge (one
// insertion at a time) read 0.28 ms at k 128 over 264 lists, one CTA a
// query walking batches of 16 lists one after another 0.06 ms at k 10;
// the groups read 0.026 and 0.011.  tests/test_torch_ivf_prep.py mirrors
// run_begin and the merge in Python.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "topk_select.cuh"

namespace {

constexpr int kMergeThreads = 256;
constexpr int kMergeBatch = 16;  // runs' lists a merge round
constexpr int kMergeSlots = kMergeBatch + kMergeBatch / 2 + 2;

// The first entry of run r of runs over n entries: contiguous runs
// covering [0, n), empty at n = 0.
__device__ __forceinline__ int run_begin(int n, int runs, int r) {
  return (int)(((long long)n * r) / runs);
}

// Output i (< k) of the merge of two sorted lists of k, a and b: the merge
// path's co-rank, a binary search for how many of the first i outputs come
// from a (ties, which only the -inf / -1 padding has, from a first).
__device__ __forceinline__ void merge_path_at(const float* as, const int* ai,
                                              const float* bs, const int* bi,
                                              int k, int i, float* cs,
                                              int* ci) {
  int lo = 0, hi = i, a, b;
  while (true) {
    a = (lo + hi) >> 1;
    b = i - a;
    if (a > 0 && b < k && ranks_before(bs[b], bi[b], as[a - 1], ai[a - 1]))
      hi = a - 1;
    else if (b > 0 && a < k && !ranks_before(bs[b - 1], bi[b - 1], as[a], ai[a]))
      lo = a + 1;
    else
      break;
  }
  const bool take_a = a < k && (b >= k || !ranks_before(bs[b], bi[b], as[a], ai[a]));
  cs[i] = take_a ? as[a] : bs[b];
  ci[i] = take_a ? ai[a] : bi[b];
}

// Merge n sorted lists of k from global memory (list j at s + j * stride)
// into one, in shared memory slots of k (ls / li): batches of kMergeBatch
// lists merged pairwise in a tree, every output of a level computed by its
// own thread (merge_path_at), each batch's result merged into the running
// list.  Returns the running list's slot.  Every thread calls.
__device__ int merge_lists(const float* s, const int* i, size_t stride, int n,
                           int k, float* ls, int* li) {
  const int tid = threadIdx.x;
  int run = kMergeSlots - 2, next = kMergeSlots - 1;
  for (int e = tid; e < k; e += kMergeThreads) {
    ls[run * k + e] = -INFINITY;
    li[run * k + e] = -1;
  }
  for (int r0 = 0; r0 < n; r0 += kMergeBatch) {
    int cnt = min(kMergeBatch, n - r0);
    for (int x = tid; x < cnt * k; x += kMergeThreads) {
      const int j = x / k, e = x - j * k;
      ls[x] = __ldcg(s + (size_t)(r0 + j) * stride + e);
      li[x] = __ldcg(i + (size_t)(r0 + j) * stride + e);
    }
    __syncthreads();
    int src = 0, dst = kMergeBatch;
    while (cnt > 1) {
      const int pairs = cnt >> 1;
      for (int x = tid; x < pairs * k; x += kMergeThreads) {
        const int p = x / k, o = x - p * k;
        const int a0 = (src + 2 * p) * k, b0 = a0 + k, c0 = (dst + p) * k;
        merge_path_at(ls + a0, li + a0, ls + b0, li + b0, k, o, ls + c0,
                      li + c0);
      }
      if (cnt & 1)
        for (int e = tid; e < k; e += kMergeThreads) {
          ls[(dst + pairs) * k + e] = ls[(src + cnt - 1) * k + e];
          li[(dst + pairs) * k + e] = li[(src + cnt - 1) * k + e];
        }
      __syncthreads();
      cnt = pairs + (cnt & 1);
      const int t = src;
      src = dst;
      dst = t;
    }
    for (int o = tid; o < k; o += kMergeThreads)
      merge_path_at(ls + run * k, li + run * k, ls + src * k, li + src * k, k,
                    o, ls + next * k, li + next * k);
    __syncthreads();
    const int t = run;
    run = next;
    next = t;
  }
  __syncthreads();
  return run;
}

// The merge, grid (q, groups): CTA (q, g) merges the runs' lists of group
// g (a contiguous share) into one, writes it to grp_s / grp_i [q, groups,
// k], and the group's last CTA to finish merges the groups' lists and
// writes the k best, times qs1[q] unless qs1 is null.
__global__ void __launch_bounds__(kMergeThreads)
tree_merge(const float* __restrict__ part_s, const int* __restrict__ part_i,
           const float* __restrict__ qs1, int n_runs, int k, int kpad,
           int groups, float* grp_s, int* grp_i, int* count,
           float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char merge_lists_smem[];
  __shared__ int last;
  float* ls = reinterpret_cast<float*>(merge_lists_smem);
  int* li = reinterpret_cast<int*>(ls + kMergeSlots * k);
  const int tid = threadIdx.x, qi = blockIdx.x, g = blockIdx.y;
  const int r0 = run_begin(n_runs, groups, g);
  const int r1 = run_begin(n_runs, groups, g + 1);
  const size_t base = ((size_t)qi * n_runs + r0) * kpad;
  int slot = merge_lists(part_s + base, part_i + base, kpad, r1 - r0, k, ls, li);
  if (groups > 1) {
    const size_t mine = ((size_t)qi * groups + g) * k;
    for (int e = tid; e < k; e += kMergeThreads) {
      grp_s[mine + e] = ls[slot * k + e];
      grp_i[mine + e] = li[slot * k + e];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(count + qi, 1) == groups - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const size_t all = (size_t)qi * groups * k;
    slot = merge_lists(grp_s + all, grp_i + all, k, groups, k, ls, li);
  }
  const float s1 = qs1 ? qs1[qi] : 1.f;
  for (int e = tid; e < k; e += kMergeThreads) {
    const float s = ls[slot * k + e];
    out_s[(size_t)qi * k + e] = qs1 ? __fmul_rn(s, s1) : s;
    out_i[(size_t)qi * k + e] = li[slot * k + e];
  }
}

// Where a scan leaves its runs' lists and the merge its groups' lists and
// results: part [q, runs, kpad], grp [q, cdiv(runs, kMergeBatch), k], out
// [q, k]; count [q] zeroed before the scan.
struct MergeArgs {
  float* part_s;
  int* part_i;
  float* grp_s;
  int* grp_i;
  int* count;
  float* out_s;
  int* out_i;
};

inline cudaError_t launch_tree_merge(const MergeArgs& m, const float* qs1,
                                    int q, int runs, int k, int kpad,
                                    cudaStream_t st) {
  const int groups = (runs + kMergeBatch - 1) / kMergeBatch;
  tree_merge<<<dim3(q, groups), kMergeThreads, (size_t)kMergeSlots * k * 8,
               st>>>(m.part_s, m.part_i, qs1, runs, k, kpad, groups, m.grp_s,
                     m.grp_i, m.count, m.out_s, m.out_i);
  return cudaGetLastError();
}

}  // namespace

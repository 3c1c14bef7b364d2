// IVF probe scan over int8 cluster blocks with two-digit int8 queries.
//
// Replaces: tpu_search/ops/pallas_ivf_scan.py, pallas_ivf_topk_int8 (:400,
// body _kernel_ivf_int8 :294), the scan behind every search of an int8 IVF
// index.
//
// Contract: digit_scan.cuh ivf_digit_partial (the score, first-index ties,
// the scores-only mode) over [nlist, cap, d] int8 blocks read through
// RowStage; schedule, membership and grid: ivf_topk.cu.  The digits, rho,
// the bias cbias / qs1 and the final * qs1 are PyTorch in ops/ivf_scan.py,
// as the JAX package computes them outside pl.pallas_call.
// What bounds it on the H100: the scheduled tiles' bytes (D + 8 B a row:
// the int8 row, its scale and its penalty) at small Q.

#include "digit_scan.cuh"

// blocks [n / cap, cap, d] int8 viewed as n rows; scale, penalty [n] f32;
// digits [2q, d] int8; rho [q] f32; tile_idx / clusters [max_sched + 1],
// n_sched [1], pos [q, nlist] int32; cbias [q, nprobe] f32 (already divided
// by qs1); the rest as ivf_topk.  Requires d % 16 == 0.
extern "C" int ivf_topk_int8(const void* blocks, const void* scale,
                             const void* penalty, const void* digits,
                             const void* rho, const void* tile_idx,
                             const void* clusters, const void* n_sched,
                             const void* pos, const void* cbias, int n, int d,
                             int q, int k, int nlist, int nprobe,
                             int max_sched, int eps, int n_splits,
                             void* part_s, void* part_i, void* out_s,
                             void* out_i, void* scores, void* stream) {
  return launch_ivf_digit_scan<RowStage>(
      blocks, static_cast<const float*>(scale),
      static_cast<const float*>(penalty), static_cast<const int8_t*>(digits),
      static_cast<const float*>(rho), nullptr,
      static_cast<const int*>(tile_idx), static_cast<const int*>(clusters),
      static_cast<const int*>(n_sched), static_cast<const int*>(pos),
      static_cast<const float*>(cbias), n, d, q, k, nlist, nprobe, max_sched,
      eps, n_splits, static_cast<float*>(part_s), static_cast<int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i),
      static_cast<float*>(scores), static_cast<cudaStream_t>(stream));
}

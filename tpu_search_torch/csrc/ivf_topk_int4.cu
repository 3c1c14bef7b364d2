// IVF probe scan over int4 cluster blocks with two-digit int8 queries.
//
// Replaces: tpu_search/ops/pallas_ivf_scan.py, pallas_ivf_topk_int4 (:632,
// body _kernel_ivf_int4 :508), the scan behind every search of an int4 IVF
// index (stage 1 of the refine re-rank when the index carries one).
//
// Contract: digit_scan.cuh ivf_digit_partial over [nlist, cap/2, d]
// nibble-pair byte blocks (rows in logical order: byte row m of a cluster
// holds slots 2m and 2m+1) read through NibbleStage, with the nibble bias
// 8 * sum(digit) removed in int32 (qoff); schedule, membership and grid:
// ivf_topk.cu.  The JAX package keeps [nlist, cap/8, d] int32 words and
// plane-ordered aux streams for the TPU's DMA and VMEM; those are not
// carried over, and flat slot ids come out in logical order directly.
// What bounds it on the H100: the scheduled tiles' bytes (D / 2 + 8 B a
// row) at small Q.

#include "digit_scan.cuh"

// nibbles [n / cap, cap / 2, d] uint8 viewed as n logical rows; qoff [2q]
// int32; the rest as ivf_topk_int8.  Requires d % 16 == 0.
extern "C" int ivf_topk_int4(const void* nibbles, const void* scale,
                             const void* penalty, const void* digits,
                             const void* rho, const void* qoff,
                             const void* tile_idx, const void* clusters,
                             const void* n_sched, const void* pos,
                             const void* cbias, int n, int d, int q, int k,
                             int nlist, int nprobe, int max_sched, int eps,
                             int n_splits, void* part_s, void* part_i,
                             void* out_s, void* out_i, void* scores,
                             void* stream) {
  return launch_ivf_digit_scan<NibbleStage>(
      nibbles, static_cast<const float*>(scale),
      static_cast<const float*>(penalty), static_cast<const int8_t*>(digits),
      static_cast<const float*>(rho), static_cast<const int*>(qoff),
      static_cast<const int*>(tile_idx), static_cast<const int*>(clusters),
      static_cast<const int*>(n_sched), static_cast<const int*>(pos),
      static_cast<const float*>(cbias), n, d, q, k, nlist, nprobe, max_sched,
      eps, n_splits, static_cast<float*>(part_s), static_cast<int*>(part_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i),
      static_cast<float*>(scores), static_cast<cudaStream_t>(stream));
}

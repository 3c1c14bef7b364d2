// Masked top-k over an int4 corpus with two-digit int8 queries.
//
// Replaces: tpu_search/ops/pallas_topk_dma.py, pallas_flat_topk_dma_int4
// (:358, body _kernel_int4 :237): the scan of the int4 flat tier.
//
// Contract, bound and design: digit_scan.cuh (staging: NibbleStage).  The
// corpus is nibble-pair byte rows [ceil(n/2), d] uint8 (ops/int4_pack.py,
// the TPUSIDX2 layout): byte row m holds logical row 2m in its low nibble
// and row 2m+1 in its high nibble, as biased codes u = q + 8 in 1..15.
// Hopper's tensor cores take int8, not int4, so the staging splits each
// 16-byte load in
// registers (& 0x0F0F0F0F, >> 4) into the s8 values of two logical rows,
// which feed the int8 MMA as they are; the bias 8 * sum(digit) comes off
// in int32 before the combine (qoff, ops/topk_scan.py
// query_nibble_offsets).  Rows are scored and numbered in logical order:
// the TPU kernel's plane order and its permuted aux streams are a VMEM
// layout artifact and are not carried over.
// Bound on the H100: 1M x 768 int4 is 0.384 GB, 0.115 ms at 3.35 TB/s.

#include "digit_scan.cuh"

// nibbles [ceil(n/2), d] uint8; scale, penalty [n] f32; digits [2q, d]
// int8; rho [q] f32; qoff [2q] int32 (8 * sum of each digit row); the rest
// as flat_topk_int8.  Requires d % 16 == 0, 1 <= k <= 128.
extern "C" int flat_topk_int4(const void* nibbles, const void* scale,
                              const void* penalty, const void* digits,
                              const void* rho, const void* qoff, int n, int d,
                              int q, int k, int n_splits, int rows_per_split,
                              void* part_s, void* part_i, void* out_s,
                              void* out_i, void* scores, void* stream) {
  return launch_digit_scan<NibbleStage>(
      nibbles, static_cast<const float*>(scale),
      static_cast<const float*>(penalty), static_cast<const int8_t*>(digits),
      static_cast<const float*>(rho), static_cast<const int*>(qoff), n, d, q,
      k, n_splits, rows_per_split, static_cast<float*>(part_s),
      static_cast<int*>(part_i), static_cast<float*>(out_s),
      static_cast<int*>(out_i), static_cast<float*>(scores),
      static_cast<cudaStream_t>(stream));
}

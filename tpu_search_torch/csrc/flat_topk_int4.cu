// Masked top-k over an int4 corpus with two-digit int8 queries.
//
// Replaces: tpu_search/ops/pallas_topk_dma.py, pallas_flat_topk_dma_int4
// (:358, body _kernel_int4 :237): the scan of the int4 flat tier, with
// the XLA around it (the query digits and nibble offsets of
// ops/topk_scan.py quantize_queries / query_nibble_offsets, and the final
// * qs1).
//
// Contract (ops/topk_scan.py flat_topk_int4_plain): the corpus is
// nibble-pair byte rows [ceil(n/2), d] uint8 (ops/int4_pack.py, the
// TPUSIDX2 layout): byte row m holds logical row 2m in its low nibble and
// row 2m+1 in its high nibble, as biased codes u = q + 8 in 1..15.  For
// query q and row r, d1 / d2 the exact int32 dots of q's two digits with
// the codes minus the nibble bias 8 * sum(digit),
//   score = fma(rho, d2, d1) * scale[r] + penalty[r]
// each step one f32 rounding, penalty 0 / -inf; the k best per query,
// descending, first-index ties, -inf / -1 past the live rows, each times
// qs1 (__fmul_rn).  Rows are scored and numbered in logical order: the
// TPU kernel's plane order and its permuted aux streams are a VMEM layout
// artifact and are not carried over.
//
// Bound on the H100: 1M x 768 int4 is 0.384 GB of nibbles (plus 8 bytes a
// row of scale and penalty), 0.117 ms at 3.35 TB/s; at small Q the bytes.
//
// Design: flat_digit_scan.cuh (the prologue, the scan and the merge, three
// launches of this one call): digit_partial<NibbleStage, 8> at Q <= 8, the
// ring ivf_digit_scan<NibbleTiles, 32, FlatSource> above.

#include "flat_digit_scan.cuh"

// nibbles [ceil(n/2), d] uint8; scale, penalty [n] f32; queries [q, d] f32;
// the scratch as ops/flat_topk_int4.py lays it out: digits [2q, d] int8,
// rho, qs1 [q] f32, qoff [2q] int32, merge_count [q], part_s / part_i [q,
// runs, round_up(k, 32)], grp_s / grp_i [q, cdiv(runs, 16), k]; out_s /
// out_i [q, k], or with scores set (k > 128) scores [q, n] (every row
// written).  qb 8: runs row ranges of rows_per_split rows (a multiple of
// 128, runs * rows_per_split >= n); qb 32: runs of tiles.
// prologue_only: the prologue alone.  Requires d % 16 == 0.
extern "C" int flat_topk_int4(const void* nibbles, const void* scale,
                              const void* penalty, const void* queries, int n,
                              int d, int q, int k, int qb, int runs,
                              int rows_per_split, int prologue_only,
                              void* digits, void* rho,
                              void* qs1, void* qoff, void* merge_count,
                              void* part_s, void* part_i, void* grp_s,
                              void* grp_i, void* out_s, void* out_i,
                              void* scores, void* stream) {
  const FlatDigitCall c = {
      static_cast<const float*>(queries), q, d, n, k, runs, rows_per_split,
      nibbles,
      static_cast<const float*>(scale), static_cast<const float*>(penalty),
      static_cast<int8_t*>(digits), static_cast<float*>(rho),
      static_cast<float*>(qs1), static_cast<int*>(qoff),
      {static_cast<float*>(part_s), static_cast<int*>(part_i),
       static_cast<float*>(grp_s), static_cast<int*>(grp_i),
       static_cast<int*>(merge_count), static_cast<float*>(out_s),
       static_cast<int*>(out_i)},
      static_cast<float*>(scores)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_flat_digit(
      c, prologue_only != 0,
      [&](int kpad) {
        if (qb == 8) return flat_partial<NibbleStage, 8>(c, st);
        if (qb == 32) return flat_ring<NibbleTiles>(c, kpad, st);
        return cudaErrorInvalidValue;
      },
      st);
}

// The ring scan's shared memory (out[0], bytes) and CTAs a multiprocessor
// (out[1]) at query block qb (32: the ring runs at q > 8 only) and k.
extern "C" int flat_topk_int4_config(int qb, int k, void* out) {
  if (qb != 32) return (int)cudaErrorInvalidValue;
  return ring_config<NibbleTiles, 32, FlatSource>(k, static_cast<int*>(out));
}

// The flat digit scans (flat_topk_int8.cu, int8 rows and words;
// flat_topk_int4.cu; int4_probe.cu's full mode) as three launches of one C
// call, with nothing of PyTorch's between them:
//  - the prologue digit_prep (ivf_prep.cuh): the digits, rho, qs1 and, for
//    int4, nibble offsets of each query, one warp a query, the IVF
//    prologue's code (prep_digits), and zeros in the merge's counters;
//  - the scan, which the C entry picks by query block and layout:
//    flat_partial, digit_partial<Stage, QB> (digit_scan.cuh: mma.sync,
//    each thread loading the next chunk into registers while the current
//    one multiplies, fixed row ranges), or flat_ring,
//    ivf_digit_scan<Tiles, 32, FlatSource> (ivf_digit_scan.cuh: every
//    128-row tile through the 3-stage cp.async ring, wgmma, runs of tiles
//    sized from the card);
//  - run_merge.cuh's tree merge of the ranges' or runs' lists, times qs1
//    (or, qs1 null, unscaled).
// Which scan, as measured on an H100 at 1M x 768, 10 % masked:
//  - int4 (flat_topk_int4.cu): digit_partial at Q <= 8, which read 0.171 /
//    0.189 ms at Q 1 / 8 and k 10 against the ring's 0.224 / 0.239 (at
//    k 128 0.316 / 0.463 against 0.392 / 0.458; neither a 4- or 6-stage
//    ring nor launch bounds of 3 or 4 CTAs a multiprocessor closed the
//    gap), and the ring above, 0.468 against 0.528 at Q 32;
//  - int8 rows (flat_topk_int8.cu): digit_partial<RowStage, 8> at Q <= 8,
//    the ring above (2.2-2.4x digit_partial<RowStage, 32> at k 128, 1.0-
//    1.15x at k 10, at Q 16-128; readings in flat_topk_int8.cu);
//  - int8 words: digit_partial<WordStage, QB> at every Q (no ring stage
//    decodes the word layout).
#pragma once

#include "digit_scan.cuh"
#include "ivf_digit_scan.cuh"

namespace {

// Everything one call reads and writes; queries null: the digits, rho and
// qoff are given (no prologue) and merge.count is zeroed by the caller.
struct FlatDigitCall {
  const float* queries;  // [q, d] f32
  int q, d, n, k;
  int runs;            // row ranges (digit_partial) or runs of tiles (ring)
  int rows_per_split;  // digit_partial: the rows of a range (x 128)
  const void* V;       // the corpus in the scan's layout
  const float* scale;
  const float* penalty;
  int8_t* digits;
  float* rho;
  float* qs1;  // null: the merge leaves the scores unscaled
  int* qoff;   // null: an int8 corpus (no nibble bias)
  MergeArgs merge;
  float* out_scores;  // [q, n], or null
};

// digit_partial<Stage, QB> over c.runs ranges of c.rows_per_split rows.
template <class Stage, int QB>
cudaError_t flat_partial(const FlatDigitCall& c, cudaStream_t st) {
  return launch_digit_qb<Stage, QB>(
      c.V, c.scale, c.penalty, c.digits, c.rho, c.qoff, c.n, c.d, c.q, c.k,
      c.runs, c.rows_per_split, c.merge.part_s, c.merge.part_i, c.out_scores,
      st);
}

// The ring at query block 32 over c.runs runs of 128-row tiles.
template <class Tiles>
cudaError_t flat_ring(const FlatDigitCall& c, int kpad, cudaStream_t st) {
  PrepArgs p = {};
  p.q = c.q;
  p.d = c.d;
  p.qb = 32;
  p.digits = c.digits;
  p.rho = c.rho;
  p.qoff = c.qoff;
  return launch_ivf_scan_qb<Tiles, 32, FlatSource>(
      p, c.V, c.scale, c.penalty, c.k, c.runs, c.n, c.merge, c.out_scores,
      kpad, st);
}

// The prologue (unless c.queries is null), then unless prologue_only
// scan(kpad) (a cudaError_t) and, without out_scores, the merge.
template <class Scan>
int launch_flat_digit(const FlatDigitCall& c, bool prologue_only, Scan scan,
                      cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (c.queries)
    err = launch_digit_prep(c.queries, c.q, c.d, c.digits, c.rho, c.qs1,
                            c.qoff, c.merge.count, st);
  if (err != cudaSuccess || prologue_only) return (int)err;
  const int kpad = c.out_scores ? 0 : round_up(c.k, 32);
  err = scan(kpad);
  if (err != cudaSuccess || c.out_scores) return (int)err;
  return (int)launch_tree_merge(c.merge, c.qs1, c.q, c.runs, c.k, kpad, st);
}

}  // namespace

// The flat int4 scan (flat_topk_int4.cu; int4_probe.cu's full mode) as
// three launches of one C call, with nothing of PyTorch's between them:
//  - the prologue digit_prep (ivf_prep.cuh): the digits, rho, qs1 and
//    nibble offsets of each query, one warp a query, the IVF prologue's
//    code (prep_digits), and zeros in the merge's counters;
//  - the scan: at Q > 8 ivf_digit_scan<NibbleTiles, 32, FlatSource>
//    (ivf_digit_scan.cuh: every 128-row tile through the 3-stage cp.async
//    ring, wgmma on the tile decoded in shared memory, runs of tiles sized
//    from the card); at Q <= 8 digit_partial<NibbleStage, 8>
//    (digit_scan.cuh: mma.sync, each thread loading the next chunk into
//    registers while the current one multiplies, fixed row ranges), which
//    on an H100 at 1M x 768 read 0.171 / 0.189 ms at Q 1 / 8 and k 10
//    against the ring's 0.224 / 0.239 (at k 128 0.316 / 0.463 against
//    0.392 / 0.458; neither a 4- or 6-stage ring nor launch bounds of 3 or
//    4 CTAs a multiprocessor closed the gap), and 0.528 against 0.468 at
//    Q 32;
//  - run_merge.cuh's tree merge of the runs' lists, times qs1 (or, qs1
//    null, unscaled).
#pragma once

#include "digit_scan.cuh"
#include "ivf_digit_scan.cuh"

namespace {

// Everything one call reads and writes; queries null: the digits, rho and
// qoff are given (no prologue) and merge.count is zeroed by the caller.
struct FlatDigitCall {
  const float* queries;  // [q, d] f32
  int q, d, n, k;
  int qb;              // 8: digit_partial; 32: the ring
  int runs;            // row ranges (qb 8) or runs of tiles (qb 32)
  int rows_per_split;  // qb 8: the rows of a range (a multiple of 128)
  const void* V;       // [ceil(n/2), d] nibble-pair bytes
  const float* scale;
  const float* penalty;
  int8_t* digits;
  float* rho;
  float* qs1;  // null: the merge leaves the scores unscaled
  int* qoff;
  MergeArgs merge;
  float* out_scores;  // [q, n], or null
};

// The prologue (unless c.queries is null), then unless prologue_only the
// scan and, without out_scores, the merge.
inline int launch_flat_int4(const FlatDigitCall& c, bool prologue_only,
                            cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (c.queries)
    err = launch_digit_prep(c.queries, c.q, c.d, c.digits, c.rho, c.qs1,
                            c.qoff, c.merge.count, st);
  if (err != cudaSuccess || prologue_only) return (int)err;
  const int kpad = c.out_scores ? 0 : round_up(c.k, 32);
  if (c.qb == 8) {
    err = launch_digit_qb<NibbleStage, 8>(
        c.V, c.scale, c.penalty, c.digits, c.rho, c.qoff, c.n, c.d, c.q, c.k,
        c.runs, c.rows_per_split, c.merge.part_s, c.merge.part_i,
        c.out_scores, st);
  } else if (c.qb == 32) {
    PrepArgs p = {};
    p.q = c.q;
    p.d = c.d;
    p.qb = 32;
    p.digits = c.digits;
    p.rho = c.rho;
    p.qoff = c.qoff;
    err = launch_ivf_scan_qb<NibbleTiles, 32, FlatSource>(
        p, c.V, c.scale, c.penalty, c.k, c.runs, c.n, c.merge, c.out_scores,
        kpad, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || c.out_scores) return (int)err;
  return (int)launch_tree_merge(c.merge, c.qs1, c.q, c.runs, c.k, kpad, st);
}

}  // namespace

// Exact masked top-k over a device-resident [N, D] bf16 / f32 corpus.
//
// Replaces: tpu_search/ops/pallas_topk_dma.py, pallas_flat_topk_dma
// (:551, body _kernel), the scan behind every search of the flat index,
// with the bf16 cast of the queries the JAX package makes around it.
//
// Contract (the same as the TPU kernel; ops/topk_scan.py flat_topk_plain):
//   score[q, r] = alpha * dot(query[q], vector[r]) - penalty[r]
// with penalty 0 (ip, live row), |v|^2 (l2, live row) or +inf (masked
// row), the dot in f32 (bf16 rows: of the queries rounded to bf16), then
// __fmul_rn by alpha and __fsub_rn of the penalty.  Output: the k best
// scores per query, descending, ties broken by the lower row id (the TPU
// kernel's _select_topk order); slots past the live rows carry -inf and id
// -1.  For k > 128 the scan writes the masked [Q, N] scores instead, and
// the caller selects with a stable sort, as the JAX package sends k > 128
// to its XLA scan.
//
// What bounds it on the H100: at small Q the scan reads N * (2 D + 4)
// bytes of bf16 rows and penalties (4 D + 4 for f32) for 2 Q N D
// operations, far under the ~295 operations a byte of the tensor cores'
// ridge: HBM bandwidth.  At the fused path's shape (32,768 slots x 768,
// Q 8) that is 50 MB, 15 us at 3.35 TB/s, so a call's launches and its
// fixed costs a CTA weigh as much as its bytes.
//
// Design: one C call of three launches, nothing of PyTorch's between them,
// the ring-scan family of the IVF and flat digit scans:
//  - the prologue float_prep (ivf_prep.cuh): the queries cast to bf16 for
//    bf16 rows (bit for bit Tensor.to(torch.bfloat16)) and zeros in the
//    merge's counters;
//  - the scan ivf_float_scan<Rows, QB, FlatSource> (ivf_float_scan.cuh):
//    entry e is 128-row tile e, rows past n score -inf and are never read;
//    grid (query blocks, runs), runs = multiprocessors x CTAs a
//    multiprocessor / query blocks, each a contiguous run of tiles in row
//    order, so a 32,768-row capacity is one or two tiles a CTA and 1M rows
//    about twenty; a 3-stage cp.async ring over (tile, 128-byte chunk)
//    pairs; bf16 wgmma m64n32k16 at QB 32 (Q > 16), mma.sync at QB 16, f32
//    exact FMAs at QB 16; each run keeps a sorted list a query;
//  - run_merge.cuh's tree merge of the runs' lists (unscaled), which keeps
//    first-index ties: runs are contiguous in row order and the merge
//    orders by (score descending, id ascending).
// Which scan, as measured on an H100 (device time a call, prologue and
// merge included; benchmarks/compare_trees.py --family flat):
//  - the ring at every Q.  The first design's partial_topk (float_scan.cuh:
//    synchronous 64-dim tile loads over fixed row ranges of split_rows)
//    fed to the same prologue and tree merge read 0.0611 / 0.1098 ms at
//    the fused shape (32,768 rows, Q 8 / 32, k 10) against the ring's
//    0.0498 / 0.0957, and 0.6418 / 0.6505 ms at 1M rows, Q 1 / 8, k 10
//    against 0.5529 / 0.5616 (1.1684 against 0.7032 at Q 1, k 128);
//  - runs sized from the card, one tile a run at the fused shape: runs of
//    at least 2 or 4 tiles read 0.0574 / 0.0838 ms there against 0.0496,
//    and a 4-stage ring 0.0501;
//  - the selection of a run's first tile (empty lists, about 35
//    insertions a query at k 10) took a group of 32 at once (warp_merge):
//    0.0948 -> 0.0622 ms at the fused shape, Q 32, with the bf16 QB 16
//    instance bound to 3 CTAs a multiprocessor (0.0480 -> 0.0393 at Q 8).

#include "ivf_float_scan.cuh"

// vectors [n, d] (bf16 if is_bf16 else f32), penalty [n] f32, queries
// [q, d] f32; the scratch as ops/flat_topk.py lays it out: qcast [q, d]
// bf16 (bf16 rows; else null), merge_count [q], part_s / part_i [q, runs,
// round_up(k, 32)], grp_s / grp_i [q, cdiv(runs, 16), k]; out_s / out_i
// [q, k], or with scores set (k > 128) scores [q, n] (every row written).
// qb: bf16 16 or 32, f32 16; runs: runs of tiles a query block.
// prologue_only: the prologue alone.  Requires d % 8 == 0.
extern "C" int flat_topk(const void* vectors, const void* penalty,
                         const void* queries, int n, int d, int q, int k,
                         int qb, int runs, int is_bf16, float alpha,
                         int prologue_only, void* qcast,
                         void* merge_count, void* part_s, void* part_i,
                         void* grp_s, void* grp_i, void* out_s, void* out_i,
                         void* scores, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PrepArgs p = {};
  p.queries = static_cast<const float*>(queries);
  p.q = q;
  p.d = d;
  p.qb = qb;
  p.qcast = is_bf16 ? static_cast<__nv_bfloat16*>(qcast) : nullptr;
  const MergeArgs m = {static_cast<float*>(part_s), static_cast<int*>(part_i),
                       static_cast<float*>(grp_s), static_cast<int*>(grp_i),
                       static_cast<int*>(merge_count),
                       static_cast<float*>(out_s), static_cast<int*>(out_i)};
  cudaError_t err = launch_float_prep(p.queries, q, d, p.qcast, m.count, st);
  if (err != cudaSuccess || prologue_only) return (int)err;
  return launch_float_scan_merge<FlatSource>(
      p, is_bf16, vectors, static_cast<const float*>(penalty), alpha, k, runs,
      n, m, static_cast<float*>(scores), st);
}

// The ring scan's shared memory (out[0], bytes) and CTAs a multiprocessor
// (out[1]) at (is_bf16, qb, k).
extern "C" int flat_topk_config(int is_bf16, int qb, int k, void* out) {
  return float_config<FlatSource>(is_bf16, qb, k, static_cast<int*>(out));
}

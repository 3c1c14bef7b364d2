// IVF probe scan over bf16 / f32 cluster blocks.
//
// Replaces: tpu_search/ops/pallas_ivf_scan.py, pallas_ivf_topk (:213, body
// _kernel_ivf :104), the scan behind every search of a bf16 / f32 IVF
// index, with the XLA around it (build_probe_schedule and the probe
// membership of tpu_search/index/ivf.py _ivf_search_pallas_impl).
//
// Contract, bounds and design: ivf_float_scan.cuh (the prologue, the scan
// and the merge, three launches of this one call), over [nlist, cap, d]
// blocks viewed as n = nlist * cap rows, a row's id its flat slot cluster
// * cap + slot.

#include "ivf_float_scan.cuh"

namespace {

// Everything one call of the float scan reads and writes.
struct IvfFloatCall {
  PrepArgs prep;  // digits null; qcast set for bf16 blocks
  const void* V;
  const float* penalty;
  int is_bf16;
  float alpha;
  int k, runs;
  MergeArgs merge;  // merge.count: prep.merge_count
  float* out_scores;
};

// The IVF C entry's body.  stages 1: the prologue alone; otherwise the
// scan and, unless out_scores is set, the merge after it.
inline int launch_ivf_float(const IvfFloatCall& c, int stages,
                            cudaStream_t st) {
  cudaError_t err = launch_ivf_prep(c.prep, st);
  if (err != cudaSuccess || stages == 1) return (int)err;
  return launch_float_scan_merge<IvfSource>(c.prep, c.is_bf16, c.V, c.penalty,
                                            c.alpha, c.k, c.runs, 0, c.merge,
                                            c.out_scores, st);
}

}  // namespace

// blocks [nlist, cap, d] (bf16 if is_bf16 else f32); penalty [n] f32;
// queries [q, d] f32; probe [q, nprobe] int32; fills [nlist] int32; the
// scratch as ops/ivf_scan.py lays it out: qcast [q, d] bf16 (bf16 blocks;
// else null), table [q, nlist] f32, tile_idx / clusters [max_sched + 1],
// n_sched [1], mem [cdiv(q, qb), max_sched] int2, mem_count
// [cdiv(q, qb)], merge_count [q], part_s / part_i [q, runs, round_up(k,
// 32)], grp_s / grp_i [q, cdiv(runs, 16), k]; out_s / out_i [q, k], or
// with scores set (k > 128) scores [q, max_sched * 128] (-inf filled).
// qb: bf16 16 or 32, f32 16.  prologue_only: the prologue alone.
// Requires d % 8 == 0.
extern "C" int ivf_topk(const void* blocks, const void* penalty,
                        const void* queries, const void* probe,
                        const void* fills, int d, int q, int k, int nlist,
                        int nprobe, int cap, int max_sched, int qb, int runs,
                        int is_bf16, float alpha, int prologue_only,
                        void* qcast, void* table, void* tile_idx,
                        void* clusters, void* n_sched, void* mem,
                        void* mem_count, void* merge_count, void* part_s,
                        void* part_i, void* grp_s, void* grp_i, void* out_s,
                        void* out_i, void* scores, void* stream) {
  PrepArgs p = {};
  p.queries = static_cast<const float*>(queries);
  p.probe = static_cast<const int*>(probe);
  p.fills = static_cast<const int*>(fills);
  p.q = q;
  p.d = d;
  p.nlist = nlist;
  p.nprobe = nprobe;
  p.tpc = cap / kIvfTile;
  p.max_sched = max_sched;
  p.qb = qb;
  p.table = static_cast<float*>(table);
  p.tile_idx = static_cast<int*>(tile_idx);
  p.clusters = static_cast<int*>(clusters);
  p.n_sched = static_cast<int*>(n_sched);
  p.mem = static_cast<int2*>(mem);
  p.mem_count = static_cast<int*>(mem_count);
  p.merge_count = static_cast<int*>(merge_count);
  p.qcast = static_cast<__nv_bfloat16*>(qcast);
  const IvfFloatCall c = {
      p, blocks, static_cast<const float*>(penalty), is_bf16, alpha, k, runs,
      {static_cast<float*>(part_s), static_cast<int*>(part_i),
       static_cast<float*>(grp_s), static_cast<int*>(grp_i),
       static_cast<int*>(merge_count), static_cast<float*>(out_s),
       static_cast<int*>(out_i)},
      static_cast<float*>(scores)};
  return launch_ivf_float(c, prologue_only ? 1 : 3,
                          static_cast<cudaStream_t>(stream));
}

// The scan's shared memory (out[0], bytes) and CTAs a multiprocessor
// (out[1]) at (is_bf16, qb, k).
extern "C" int ivf_topk_config(int is_bf16, int qb, int k, void* out) {
  return float_config<IvfSource>(is_bf16, qb, k, static_cast<int*>(out));
}

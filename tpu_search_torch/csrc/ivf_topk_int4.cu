// IVF probe scan over int4 cluster blocks with two-digit int8 queries.
//
// Replaces: tpu_search/ops/pallas_ivf_scan.py, pallas_ivf_topk_int4 (:632,
// body _kernel_ivf_int4 :508), the scan behind every search of an int4 IVF
// index, with the XLA around it (the schedule, the query digits and the
// cbias / qs1 of tpu_search/index/ivf.py _ivf_search_pallas_impl).
//
// Contract, bounds and design: ivf_digit_scan.cuh (the prologue, the scan
// and the merge, three launches of this one call), over [nlist, cap/2, d]
// nibble-pair byte blocks (rows in logical order: byte row m of a cluster
// holds slots 2m and 2m+1), the nibble bias 8 * sum(digit) removed in
// int32 (the prologue's qoff).  The JAX package keeps [nlist, cap/8, d]
// int32 words and plane-ordered aux streams for the TPU's DMA and VMEM;
// those are not carried over, and flat slot ids come out in logical order.
// What bounds it on the H100: the scheduled tiles' bytes (D / 2 + 8 B a
// row) at small Q.

#include "ivf_digit_scan.cuh"

// nibbles [n / 2, d] uint8 viewed as n logical rows; qoff [2q] int32 (the
// nibble offsets); the rest as ivf_topk_int8.  Requires d % 16 == 0.
extern "C" int ivf_topk_int4(
    const void* blocks, const void* scale, const void* penalty,
    const void* queries, const void* probe, const void* fills,
    const void* cbias, int d, int q, int k, int nlist, int nprobe, int cap,
    int max_sched, int qb, int runs, int prologue_only, void* digits,
    void* rho, void* qs1, void* qoff, void* table, void* tile_idx,
    void* clusters, void* n_sched, void* mem, void* mem_count,
    void* merge_count, void* part_s, void* part_i, void* grp_s, void* grp_i,
    void* out_s, void* out_i, void* scores, void* stream) {
  const IvfDigitCall c = {
      {static_cast<const float*>(queries), static_cast<const int*>(probe),
       static_cast<const int*>(fills), static_cast<const float*>(cbias), q, d,
       nlist, nprobe, cap / kIvfTile, max_sched, qb,
       static_cast<int8_t*>(digits), static_cast<float*>(rho),
       static_cast<float*>(qs1), static_cast<int*>(qoff),
       static_cast<float*>(table), static_cast<int*>(tile_idx),
       static_cast<int*>(clusters), static_cast<int*>(n_sched),
       static_cast<int2*>(mem), static_cast<int*>(mem_count),
       static_cast<int*>(merge_count)},
      blocks, static_cast<const float*>(scale),
      static_cast<const float*>(penalty), k, runs,
      {static_cast<float*>(part_s), static_cast<int*>(part_i),
       static_cast<float*>(grp_s), static_cast<int*>(grp_i),
       static_cast<int*>(merge_count), static_cast<float*>(out_s),
       static_cast<int*>(out_i)},
      static_cast<float*>(scores)};
  return launch_ivf_digit<NibbleTiles>(c, prologue_only ? 1 : 3,
                                    static_cast<cudaStream_t>(stream));
}

// The scan's shared memory (out[0], bytes) and CTAs a multiprocessor
// (out[1]) at query block qb and k.
extern "C" int ivf_topk_int4_config(int qb, int k, void* out) {
  return ivf_digit_config<NibbleTiles>(qb, k, static_cast<int*>(out));
}

// Masked top-k over an int8 corpus with two-digit int8 queries.
//
// Replaces: tpu_search/ops/pallas_topk_dma.py, pallas_flat_topk_dma_int8
// (:515) and pallas_flat_topk_dma_int8_packed (:531), both through
// _int8_call / _kernel_int8: the scan of the int8 flat tier, with the XLA
// around it (the query digits of ops/topk_scan.py quantize_queries, and
// the final * qs1).
//
// Contract (ops/topk_scan.py flat_topk_int8_plain): for query q and row r,
// d1 / d2 the exact int32 dots of q's two digits with the row,
//   score = fma(rho, d2, d1) * scale[r] + penalty[r]
// each step one f32 rounding, penalty 0 / -inf; the k best per query,
// descending, first-index ties, -inf / -1 past the live rows, each times
// qs1 (__fmul_rn).  Two corpus layouts, each a Stage policy of
// digit_scan.cuh:
//  - RowStage: [n, d] int8 rows (the port's index layout);
//  - WordStage: [n/4, d] int32 words, byte b of word (s, c) = row 4s+b,
//    column c (the JAX package's word-packed layout, ops/int8_pack.py).
//    A 16-byte load brings 4 columns of 4 rows; four __byte_perm pairs
//    transpose that 4x4 byte block into 4-byte pieces of the 4 rows.
// Bound on the H100: 1M x 768 int8 is 0.768 GB (plus 8 bytes a row of
// scale and penalty), 0.232 ms at 3.35 TB/s; at small Q the bytes.
//
// Design: flat_digit_scan.cuh, three launches of this one call: the
// prologue digit_prep (no nibble offsets), the scan, the tree merge times
// qs1.  The scan: digit_partial<Stage, 8> at Q <= 8 in both layouts; above
// Q 8 the rows take the ring ivf_digit_scan<RowTiles, 32, FlatSource>, the
// words digit_partial<WordStage, 32> (no ring stage decodes words).  On an
// H100 at 1M x 768, 10 % masked (benchmarks/compare_trees.py against a
// copy with the rows on digit_partial<RowStage, 32> above Q 8), the ring
// against that read 0.426 / 0.466 ms at Q 16 and k 10, 0.502 / 0.579 at
// Q 32, 1.522 / 1.537 at Q 128, and at k 128 0.919 / 2.058, 1.479 / 3.573,
// 2.853 / 6.165.  digit_partial<RowStage, 8> spills 20 bytes at 64
// registers; a launch bound of 3 CTAs a multiprocessor removed the spill
// but read 0.373 against 0.345 ms at Q 1, k 10 and 0.649 against 0.473 at
// k 128 (3 CTAs a multiprocessor against split_rows' 4), so the kernel
// keeps no bound but its thread count.

#include "flat_digit_scan.cuh"

namespace {

struct WordStage {
  // 32 word rows x 128 columns: 32 16-byte loads a word row, each 4
  // columns x 4 rows, 4 a thread.  Needs n % 4 == 0 and d % 4 == 0.
  static constexpr int kPerRow = kChunk / 4;
  static constexpr int kLoads = (kTile / 4) * kPerRow / kThreads;
  struct Regs {
    uint4 w[kLoads];
  };
  __device__ static void load(const void* V, int n, int d, int t0, int kc,
                              Regs& regs) {
    const int32_t* W = static_cast<const int32_t*>(V);
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int wrow = t0 / 4 + i / kPerRow, col = kc + (i % kPerRow) * 4;
      regs.w[j] = wrow * 4 < n && col < d
                      ? *reinterpret_cast<const uint4*>(W + (size_t)wrow * d + col)
                      : zero4();
    }
  }
  __device__ static void store(const Regs& regs, int8_t* Vs) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const uint4 w = regs.w[j];
      // w.x..w.w: 4 columns; byte b of each is row 4 * (word row) + b.
      const uint32_t lo01 = __byte_perm(w.x, w.y, 0x5140);  // b0, b1 of x, y
      const uint32_t hi01 = __byte_perm(w.x, w.y, 0x7362);  // b2, b3 of x, y
      const uint32_t lo23 = __byte_perm(w.z, w.w, 0x5140);
      const uint32_t hi23 = __byte_perm(w.z, w.w, 0x7362);
      int8_t* dst = Vs + (4 * (i / kPerRow)) * kVStride + (i % kPerRow) * 4;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + kVStride) =
          __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kVStride) =
          __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kVStride) =
          __byte_perm(hi01, hi23, 0x7632);
    }
  }
};

}  // namespace

// vectors [n, d] int8 (words 0) or [n/4, d] int32 (words 1); scale,
// penalty [n] f32; queries [q, d] f32; the scratch as
// ops/flat_topk_int8.py lays it out: digits [2q, d] int8, rho, qs1 [q]
// f32, merge_count [q], part_s / part_i [q, runs, round_up(k, 32)], grp_s
// / grp_i [q, cdiv(runs, 16), k]; out_s / out_i [q, k], or with scores
// set (k > 128) scores [q, n] (every row written).  qb 8, or qb 32 with
// words: digit_partial over runs row ranges of rows_per_split rows (a
// multiple of 128, runs * rows_per_split >= n); qb 32 with rows: the ring
// over runs of tiles.  prologue_only: the prologue alone.  Requires
// d % 16 == 0.
extern "C" int flat_topk_int8(const void* vectors, const void* scale,
                              const void* penalty, const void* queries, int n,
                              int d, int q, int k, int qb, int runs,
                              int rows_per_split, int prologue_only,
                              int words, void* digits, void* rho,
                              void* qs1, void* merge_count, void* part_s,
                              void* part_i, void* grp_s, void* grp_i,
                              void* out_s, void* out_i, void* scores,
                              void* stream) {
  const FlatDigitCall c = {
      static_cast<const float*>(queries), q, d, n, k, runs, rows_per_split,
      vectors,
      static_cast<const float*>(scale), static_cast<const float*>(penalty),
      static_cast<int8_t*>(digits), static_cast<float*>(rho),
      static_cast<float*>(qs1), nullptr,
      {static_cast<float*>(part_s), static_cast<int*>(part_i),
       static_cast<float*>(grp_s), static_cast<int*>(grp_i),
       static_cast<int*>(merge_count), static_cast<float*>(out_s),
       static_cast<int*>(out_i)},
      static_cast<float*>(scores)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_flat_digit(
      c, prologue_only != 0,
      [&](int kpad) {
        if (qb == 8)
          return words ? flat_partial<WordStage, 8>(c, st)
                       : flat_partial<RowStage, 8>(c, st);
        if (qb != 32) return cudaErrorInvalidValue;
        return words ? flat_partial<WordStage, 32>(c, st)
                     : flat_ring<RowTiles>(c, kpad, st);
      },
      st);
}

// The row ring's shared memory (out[0], bytes) and CTAs a multiprocessor
// (out[1]) at query block qb (32: the ring runs at q > 8 only) and k.
extern "C" int flat_topk_int8_config(int qb, int k, void* out) {
  if (qb != 32) return (int)cudaErrorInvalidValue;
  return ring_config<RowTiles, 32, FlatSource>(k, static_cast<int*>(out));
}

// Masked top-k over an int8 corpus with two-digit int8 queries.
//
// Replaces: tpu_search/ops/pallas_topk_dma.py, pallas_flat_topk_dma_int8
// (:515) and pallas_flat_topk_dma_int8_packed (:531), both through
// _int8_call / _kernel_int8: the scan of the int8 flat tier.
//
// Contract, bound and design: digit_scan.cuh.  Two corpus layouts, picked
// by the Stage policy:
//  - RowStage (digit_scan.cuh): [n, d] int8 rows (the port's index layout);
//  - WordStage: [n/4, d] int32 words, byte b of word (s, c) = row 4s+b,
//    column c (the JAX package's word-packed layout, ops/int8_pack.py).
//    A 16-byte load brings 4 columns of 4 rows; four __byte_perm pairs
//    transpose that 4x4 byte block into 4-byte pieces of the 4 rows.
// Bound on the H100: 1M x 768 int8 is 0.768 GB, 0.229 ms at 3.35 TB/s.

#include "digit_scan.cuh"

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

// vectors: [n, d] int8 (words == 0) or [n/4, d] int32 (words == 1);
// scale, penalty [n] f32; digits [2q, d] int8 (digit 1 rows, then digit 2);
// rho [q] f32; part_s / part_i [q, n_splits, round_up(k, 32)] scratch;
// out_s / out_i [q, k].  With scores non-null (k > 128) only the masked
// scores [q, n] f32 are written.  rows_per_split is a multiple of 128 and
// n_splits * rows_per_split >= n.  Requires d % 16 == 0, 1 <= k <= 128.
extern "C" int flat_topk_int8(const void* vectors, int words,
                              const void* scale, const void* penalty,
                              const void* digits, const void* rho, int n,
                              int d, int q, int k, int n_splits,
                              int rows_per_split, void* part_s, void* part_i,
                              void* out_s, void* out_i, void* scores,
                              void* stream) {
  auto run = [&](auto stage) {
    return launch_digit_scan<decltype(stage)>(
        vectors, static_cast<const float*>(scale),
        static_cast<const float*>(penalty),
        static_cast<const int8_t*>(digits), static_cast<const float*>(rho),
        nullptr, n, d, q, k, n_splits, rows_per_split,
        static_cast<float*>(part_s), static_cast<int*>(part_i),
        static_cast<float*>(out_s), static_cast<int*>(out_i),
        static_cast<float*>(scores), static_cast<cudaStream_t>(stream));
  };
  return words ? run(WordStage{}) : run(RowStage{});
}

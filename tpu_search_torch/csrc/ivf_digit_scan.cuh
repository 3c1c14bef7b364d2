// The digit scans fed by a cp.async ring: the IVF int8 / int4 scans
// (ivf_topk_int8.cu, ivf_topk_int4.cu) and, at Q > 8, the flat int4 and
// int8 row scans (flat_digit_scan.cuh), each three launches of one C
// call: a prologue (ivf_prep.cuh), the scan and the merge (run_merge.cuh),
// with nothing of PyTorch's between them.
//
// Contract (the TPU kernels _kernel_ivf_int8 / _kernel_ivf_int4 of
// tpu_search/ops/pallas_ivf_scan.py and ops/ivf_scan.py's plain versions):
// for query q and a row of a scheduled tile of cluster c,
//   score = ((fma(rho, d2, d1) * scale[row]) + penalty[row]) + bias[q, c]
// each step one f32 rounding, d1 / d2 the exact int32 dots of q's two
// digits with the row (int4: minus 8 * sum(digit)), bias = cbias / qs1 or
// -inf where q does not probe c; the k best per query, descending,
// first-index (lowest flat slot) ties, -inf / -1 past the candidates,
// each selected score times qs1 (__fmul_rn, as top * qs1[:, None]); with
// out_scores set (k > 128) the masked scores of every schedule position
// instead, [q, max_sched * 128], for a stable sort outside.  The flat scan
// (FlatSource, the TPU kernels _kernel_int4 / _kernel_int8 of
// ops/pallas_topk_dma.py, ops/topk_scan.py flat_topk_int4_plain /
// flat_topk_int8_plain) is the same scan over every
// 128-row tile of an n-row corpus, without the bias, rows past n scoring
// -inf (their bytes, scales and penalties never read); its scores-only
// mode writes [q, n].
//
// What bounds it on the H100: at small Q the bytes of the scheduled tiles
// (D + 8 B a row for int8, D / 2 + 8 for int4), which at nprobe 32 and Q 1
// is 13-26 MB: under 8 us at 3.35 TB/s, so the latency of a short scan
// and of its launches, more than the bandwidth.  At Q 128 every query
// block re-reads the tiles its queries probe, and the products (2 digits x
// QB queries a row) reach the tensor cores' range.
//
// Design, against those:
//  - The grid is sized from the card: (query blocks, runs) with runs =
//    multiprocessors x CTAs a multiprocessor / query blocks.  Each query
//    block has its own member list from the prologue (the schedule entries
//    one of its queries probes, ascending), so no CTA spends a turn on an
//    entry none of its queries probes; a CTA takes the contiguous run
//    [n r / runs, n (r + 1) / runs) of that list, n = mem_count[block],
//    read on the device (tests/test_torch_ivf_prep.py mirrors the split).
//    Each run keeps first-index ties in its own list (tiles in ascending
//    order, a strict k-th-best gate); the merge keeps them by its order.
//  - Copies: every chunk of 128 dims of a member tile (128 rows, int4: 64
//    rows of nibble pairs) and of the block's query digits goes through a
//    3-stage cp.async ring in the 128-byte swizzled K-major layout, with
//    the tile's scales, penalties and per-query bias on a side ring.  The
//    ring runs over (entry, chunk) pairs, so the next member tile's first
//    chunks are in flight while this tile's last chunks multiply.  The
//    digits ride with each chunk (L2-resident, 2 QB x 128 bytes) rather
//    than staying resident, which keeps the shared memory under half the
//    multiprocessor's at any D and k (two CTAs a multiprocessor, QB 32).
//    Resident digits, where two CTAs still fit (D 768, k <= 32), read only
//    5-10 % faster at Q 128 on an H100, and no search of one query runs
//    QB 32.
//  - Products: QB 32 (Q > 8) puts 64 digit rows under wgmma
//    m64n64k32.s32.s8.s8, each of the two warpgroups taking 64 of the
//    tile's 128 rows.  QB 64 (two m64 slabs, n128 each) read 1.4-1.8x QB
//    32's time at Q 128 on an H100 (1M x 768 rows, nlist 1024): 160
//    registers left one CTA a multiprocessor, and its digits streamed with
//    each chunk weigh as much as the tile.  QB 8 (Q <= 8) keeps mma.sync
//    m16n8k32: its 16 digit rows would fill a quarter of wgmma's 64, and at
//    Q <= 8 the scan is paced by its bytes, not its products.  int4 under
//    wgmma is decoded in shared memory (raw nibble pairs in the ring, one
//    pass into a decoded tile); under mma.sync a fragment splits its
//    nibbles in registers.
//  - Selection: the tile's scores go to shared memory (aliasing the stage
//    just multiplied) and one warp a query offers them to its sorted list
//    behind a k-th-best gate (topk_select.cuh consume_tile, a group of 32
//    at once where more than 3 pass: warp_merge).
//  - Merge: run_merge.cuh's tree merge, then * qs1.
#pragma once

#include "int8_wgmma.cuh"
#include "ivf_prep.cuh"
#include "run_merge.cuh"
#include "smem_cap.cuh"
#include "topk_select.cuh"

namespace {

constexpr int kIvfTile = 128;     // rows of a schedule entry
constexpr int kIvfChunk = 128;    // dims (bytes) of a ring stage
constexpr int kIvfThreads = 256;  // 8 warps, two warpgroups
constexpr int kIvfStages = 3;

// Corpus layouts: int8 rows, or nibble-pair bytes (byte row m = logical
// rows 2m, low nibble, and 2m + 1, high; biased codes 1..15).
struct RowTiles {
  static constexpr int kRawRows = kIvfTile;
  static constexpr bool kNibbles = false;
};
struct NibbleTiles {
  static constexpr int kRawRows = kIvfTile / 2;
  static constexpr bool kNibbles = true;
};

// Where a CTA's entries come from: the IVF scan's member lists (entry e of
// the run: mem[block][e], its bias from the table), or every tile of a
// flat corpus of n rows (entry e: tile e, no bias, rows past n -inf).
struct IvfSource {
  static constexpr bool kFlat = false;
};
struct FlatSource {
  static constexpr bool kFlat = true;
};

// Shared memory of one scan CTA: the ring (digits then corpus bytes a
// stage, each 1024-byte aligned), the decoded int4 tile under wgmma, the
// side ring, then the partial lists.  A tile's scores S [QB, 128] f32
// alias the stage it was multiplied from (the decoded tile under wgmma
// int4), free until the next item is issued into it.
template <class Tiles, int QB>
struct IvfLayout {
  static constexpr bool kWgmma = QB == 32;
  static constexpr int kABytes = 2 * QB * kIvfChunk;
  static constexpr int kBBytes = Tiles::kRawRows * kIvfChunk;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr bool kDecode = Tiles::kNibbles && kWgmma;
  static constexpr int kDecBytes = kDecode ? kIvfTile * kIvfChunk : 0;
  static_assert(QB * kIvfTile * 4 <= (kDecode ? kDecBytes : kStageBytes),
                "S must fit the region it aliases");
  // scale[128], penalty[128], bias[QB], tile, entry
  static constexpr int kSideBytes = (2 * kIvfTile * 4 + QB * 4 + 8 + 15) / 16 * 16;
  static constexpr int kFixed =
      kIvfStages * kStageBytes + kDecBytes + kIvfStages * kSideBytes;
  static size_t bytes(int kpad) { return kFixed + (size_t)QB * kpad * 8 + 1024; }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// The 32-bit word at byte kb (a multiple of 4) of row r of a swizzled tile.
__device__ __forceinline__ uint32_t ld_sw(const uint8_t* tile, int r, int kb) {
  return *reinterpret_cast<const uint32_t*>(
      tile + r * 128 + ((((kb >> 4) ^ r) & 7) << 4) + (kb & 15));
}

// d[64 x 64] += a[64 x 32] . b[64 x 32]^T, both K-major s8 in shared
// memory (int8_wgmma.cuh has the n128 and n256 shapes and the layout).
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// One query block's run of its entries.  digits [2q, d] int8, rho [q],
// qoff [2q] (int4) or null; IvfSource: table [q, nlist], mem / mem_count
// from the prologue; FlatSource: the n rows' tiles (table, mem and
// mem_count unused).  V the corpus as kRawRows-row tiles of d bytes a row;
// out_scores [q, n_out].
template <class Tiles, int QB, class Source>
__global__ void __launch_bounds__(kIvfThreads)
ivf_digit_scan(const uint8_t* __restrict__ V, const float* __restrict__ scale,
               const float* __restrict__ penalty,
               const int8_t* __restrict__ digits, const float* __restrict__ rho,
               const int* __restrict__ qoff, const float* __restrict__ table,
               const int2* __restrict__ mem, const int* __restrict__ mem_count,
               int d, int q, int k, int kpad, int nlist, int tpc,
               int max_sched, int n, size_t n_out, float* __restrict__ part_s,
               int* __restrict__ part_i, float* __restrict__ out_scores) {
  using L = IvfLayout<Tiles, QB>;
  constexpr bool kFlat = Source::kFlat;
  constexpr int kRaw = Tiles::kRawRows;
  extern __shared__ __align__(1024) unsigned char ivf_smem[];
  uint8_t* ring = ivf_smem + ((1024 - (smem_addr(ivf_smem) & 1023)) & 1023);
  uint8_t* dec = ring + kIvfStages * L::kStageBytes;
  uint8_t* side = dec + L::kDecBytes;
  float* bs = reinterpret_cast<float*>(side + kIvfStages * L::kSideBytes);
  int* bi = reinterpret_cast<int*>(bs + QB * kpad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int blk = blockIdx.x, q0 = blk * QB;
  const int nkc = (d + kIvfChunk - 1) / kIvfChunk;
  const int n_mem = kFlat ? (n + kIvfTile - 1) / kIvfTile : mem_count[blk];
  const int e0 = run_begin(n_mem, gridDim.y, blockIdx.y);
  const int n_ent = run_begin(n_mem, gridDim.y, blockIdx.y + 1) - e0;
  const int n_items = n_ent * nkc;
  const int2* recs = kFlat ? nullptr : mem + (size_t)blk * max_sched + e0;
  // rows of V (flat: bytes past them are never read)
  const int raw_rows = Tiles::kNibbles ? (n + 1) / 2 : n;
  auto record = [&](int e) {
    return kFlat ? make_int2(e0 + e, e0 + e) : recs[e];
  };

  // The query whose two digit rows this thread's accumulators hold.
  const int wg = warp >> 2;
  const int qq = L::kWgmma ? (warp & 3) * 8 + g : g;
  const bool q_live = q0 + qq < q;
  const float rho_q = q_live ? rho[q0 + qq] : 0.f;
  const int off1 = q_live && qoff ? qoff[q0 + qq] : 0;
  const int off2 = q_live && qoff ? qoff[q + q0 + qq] : 0;

  if (!out_scores)
    for (int i = tid; i < QB * kpad; i += kIvfThreads) {
      bs[i] = -INFINITY;
      bi[i] = -1;
    }

  // Issue item v (entry v / nkc, chunk v % nkc) into stage v % kIvfStages,
  // and a commit group (empty past the run).  rec_next is read one entry
  // ahead of its use.
  int2 rec = make_int2(0, 0), rec_next = n_ent ? record(0) : rec;
  int rec_e = -1;
  auto issue = [&](int v) {
    if (v < n_items) {
      const int e = v / nkc, kc = (v - e * nkc) * kIvfChunk;
      if (e != rec_e) {
        rec = rec_next;
        rec_next = e + 1 < n_ent ? record(e + 1) : rec;
        rec_e = e;
      }
      uint8_t* st = ring + (v % kIvfStages) * L::kStageBytes;
      for (int i = tid; i < 2 * QB * 8; i += kIvfThreads) {
        // A row ar: m-tile ar / 16; rows 0-7 digit 1, 8-15 digit 2 of the
        // same 8 queries, so d1 and d2 land in one thread's accumulators.
        const int ar = i >> 3, c = i & 7, kb = kc + c * 16;
        const int qi = q0 + (ar >> 4) * 8 + (ar & 7);
        const bool ok = qi < q && kb < d;
        const int8_t* src = digits + (size_t)((ar & 8) ? q + qi : qi) * d + kb;
        cp_async<16>(st + ar * 128 + ((c ^ (ar & 7)) << 4), ok ? src : digits,
                     ok ? 16 : 0);
      }
      const uint8_t* rows = V + (size_t)rec.x * kRaw * d;
      for (int i = tid; i < kRaw * 8; i += kIvfThreads) {
        const int r = i >> 3, c = i & 7, kb = kc + c * 16;
        const bool ok = kb < d && (!kFlat || rec.x * kRaw + r < raw_rows);
        cp_async<16>(st + L::kABytes + r * 128 + ((c ^ (r & 7)) << 4),
                     ok ? rows + (size_t)r * d + kb : V, ok ? 16 : 0);
      }
      if (kc == 0) {
        uint8_t* sd = side + (e % kIvfStages) * L::kSideBytes;
        const size_t row0 = (size_t)rec.x * kIvfTile;
        if (kFlat) {
          // row by row: n need not be a multiple of 4
          const int r = tid & (kIvfTile - 1);
          const bool ok = row0 + r < (size_t)n;
          const float* src = tid < kIvfTile ? scale : penalty;
          cp_async4(sd + (tid < kIvfTile ? 0 : 512) + r * 4,
                    ok ? src + row0 + r : src, ok ? 4 : 0);
          if (tid == 0) {
            int* ids = reinterpret_cast<int*>(sd + 1024 + QB * 4);
            ids[0] = rec.x;
            ids[1] = rec.y;
          }
        } else if (tid < 32) {
          cp_async<16>(sd + tid * 16, scale + row0 + tid * 4, 16);
        } else if (tid < 64) {
          cp_async<16>(sd + 512 + (tid - 32) * 16, penalty + row0 + (tid - 32) * 4,
                       16);
        } else if (tid < 64 + QB) {
          const int j = tid - 64;
          const bool ok = q0 + j < q;
          cp_async4(sd + 1024 + j * 4,
                    ok ? table + (size_t)(q0 + j) * nlist + rec.x / tpc : table,
                    ok ? 4 : 0);
        } else if (tid == 64 + QB) {
          int* ids = reinterpret_cast<int*>(sd + 1024 + QB * 4);
          ids[0] = rec.x;
          ids[1] = rec.y;
        }
      }
    }
    cp_async_commit();
  };

  constexpr int kN = L::kWgmma ? 64 : 16;  // columns a warpgroup / warp
  int acc[L::kWgmma ? kN / 2 : 8];
  for (int v = 0; v < kIvfStages - 1; ++v) issue(v);
  for (int u = 0; u < n_items; ++u) {
    cp_async_wait<kIvfStages - 2>();
    __syncthreads();  // item u landed everywhere; stage (u - 1) is free
    issue(u + kIvfStages - 1);
    const int e = u / nkc, kci = u - e * nkc;
    uint8_t* st = ring + (u % kIvfStages) * L::kStageBytes;
    if (kci == 0) {
#pragma unroll
      for (int i = 0; i < (int)(sizeof(acc) / sizeof(int)); ++i) acc[i] = 0;
    }
    if constexpr (L::kWgmma) {
      const uint8_t* B = st + L::kABytes;
      if constexpr (L::kDecode) {
        const uint32_t lo = 0x0F0F0F0Fu;
        for (int i = tid; i < kRaw * 8; i += kIvfThreads) {
          const int m = i >> 3, c = i & 7, r0 = 2 * m, r1 = 2 * m + 1;
          const uint4 v = *reinterpret_cast<const uint4*>(
              B + m * 128 + ((c ^ (m & 7)) << 4));
          *reinterpret_cast<uint4*>(dec + r0 * 128 + ((c ^ (r0 & 7)) << 4)) =
              make_uint4(v.x & lo, v.y & lo, v.z & lo, v.w & lo);
          *reinterpret_cast<uint4*>(dec + r1 * 128 + ((c ^ (r1 & 7)) << 4)) =
              make_uint4((v.x >> 4) & lo, (v.y >> 4) & lo, (v.z >> 4) & lo,
                         (v.w >> 4) & lo);
        }
        fence_proxy_async();
        __syncthreads();
        B = dec;
      }
      const uint64_t da = sw128_desc(st);
      const uint64_t db = sw128_desc(B + wg * 64 * kIvfChunk);
      fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kIvfChunk / 32; ++kk)
        wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    } else {
      const uint8_t* B = st + L::kABytes;
#pragma unroll
      for (int ks = 0; ks < kIvfChunk; ks += 32) {
        uint32_t a[4];
        a[0] = ld_sw(st, g, ks + t * 4);
        a[1] = ld_sw(st, g + 8, ks + t * 4);
        a[2] = ld_sw(st, g, ks + 16 + t * 4);
        a[3] = ld_sw(st, g + 8, ks + 16 + t * 4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = warp * 16 + nt * 8 + g;
          uint32_t b[2];
          if constexpr (Tiles::kNibbles) {
            const int sh = (r & 1) * 4;
            b[0] = (ld_sw(B, r >> 1, ks + t * 4) >> sh) & 0x0F0F0F0Fu;
            b[1] = (ld_sw(B, r >> 1, ks + 16 + t * 4) >> sh) & 0x0F0F0F0Fu;
          } else {
            b[0] = ld_sw(B, r, ks + t * 4);
            b[1] = ld_sw(B, r, ks + 16 + t * 4);
          }
          mma_s8(acc + nt * 4, a, b);
        }
      }
    }
    if (kci != nkc - 1) continue;

    // The tile's epilogue: scores into S, then the selection.
    const uint8_t* sd = side + (e % kIvfStages) * L::kSideBytes;
    const float* sc = reinterpret_cast<const float*>(sd);
    const float* pn = sc + kIvfTile;
    const float bias =
        kFlat ? 0.f : reinterpret_cast<const float*>(sd + 1024)[qq];
    const int* ids = reinterpret_cast<const int*>(sd + 1024 + QB * 4);
    float* S = reinterpret_cast<float*>(L::kDecode ? dec : st);
    __syncthreads();  // every warp is done reading the region S aliases
    // accumulator 4 j + h: digit 1 (h < 2) or 2 of query qq, column
    // col0 + 8 j + 2 t + h % 2 (mma.sync: n-tile j of the warp's 16 rows)
    const int col0 = L::kWgmma ? wg * 64 : warp * 16;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 8 * j + 2 * t + h;
        const float d1 = __int2float_rn(acc[4 * j + h] - off1);
        const float d2 = __int2float_rn(acc[4 * j + 2 + h] - off2);
        const float s =
            __fadd_rn(__fmul_rn(__fmaf_rn(rho_q, d2, d1), sc[col]), pn[col]);
        if constexpr (kFlat)
          S[qq * kIvfTile + col] =
              ids[0] * kIvfTile + col < n ? s : -INFINITY;
        else
          S[qq * kIvfTile + col] = __fadd_rn(s, bias);
      }
    __syncthreads();
    if (out_scores) {
      // IVF: schedule position ids[1]; flat: the row itself
      const size_t at = (size_t)ids[kFlat ? 0 : 1] * kIvfTile;
      for (int i = tid; i < QB * kIvfTile; i += kIvfThreads) {
        const int r = i / kIvfTile;
        if (q0 + r < q && at + i % kIvfTile < n_out)
          out_scores[(size_t)(q0 + r) * n_out + at + i % kIvfTile] = S[i];
      }
    } else {
      const int t0 = ids[0] * kIvfTile;
      consume_tile<QB, kIvfTile, kIvfThreads>(
          S, q0, q, t0, t0 + kIvfTile, 0, k, kpad, bs, bi, nullptr);
    }
  }
  cp_async_wait<0>();
  if (out_scores) return;
  __syncthreads();
  store_partials<QB, kIvfThreads>(bs, bi, q0, q, kpad, part_s, part_i);
}

// Everything one call of an IVF digit scan reads and writes.
struct IvfDigitCall {
  PrepArgs prep;
  const void* V;
  const float* scale;
  const float* penalty;
  int k, runs;
  MergeArgs merge;  // merge.count: prep.merge_count
  float* out_scores;
};

template <class Tiles, int QB, class Source>
cudaError_t ivf_scan_attr(int kpad, size_t* bytes) {
  static size_t caps[kCapDevices] = {};
  *bytes = IvfLayout<Tiles, QB>::bytes(kpad);
  return raise_smem_cap((const void*)ivf_digit_scan<Tiles, QB, Source>,
                        *bytes, caps);
}

// The scan launch of an IVF call (p: its prologue's outputs) or, with
// Source FlatSource, of a flat call (p.q, p.d, the digits, rho and qoff
// set; n rows).
template <class Tiles, int QB, class Source>
cudaError_t launch_ivf_scan_qb(const PrepArgs& p, const void* V,
                               const float* scale, const float* penalty,
                               int k, int runs, int n, const MergeArgs& m,
                               float* out_scores, int kpad, cudaStream_t st) {
  size_t bytes;
  cudaError_t err = ivf_scan_attr<Tiles, QB, Source>(kpad, &bytes);
  if (err != cudaSuccess) return err;
  const size_t n_out =
      Source::kFlat ? (size_t)n : (size_t)p.max_sched * kIvfTile;
  dim3 grid((p.q + QB - 1) / QB, runs);
  ivf_digit_scan<Tiles, QB, Source><<<grid, kIvfThreads, bytes, st>>>(
      static_cast<const uint8_t*>(V), scale, penalty, p.digits, p.rho,
      p.qoff, p.table, p.mem, p.mem_count, p.d, p.q, k, kpad, p.nlist, p.tpc,
      p.max_sched, n, n_out, m.part_s, m.part_i, out_scores);
  return cudaGetLastError();
}

// The IVF C entries' body.  stages 1: the prologue alone; otherwise the
// scan and, unless out_scores is set, the merge after it.
template <class Tiles>
int launch_ivf_digit(const IvfDigitCall& c, int stages, cudaStream_t st) {
  cudaError_t err = launch_ivf_prep(c.prep, st);
  if (err != cudaSuccess || stages == 1) return (int)err;
  const int kpad = c.out_scores ? 0 : round_up(c.k, 32);
  switch (c.prep.qb) {
    case 8:
      err = launch_ivf_scan_qb<Tiles, 8, IvfSource>(
          c.prep, c.V, c.scale, c.penalty, c.k, c.runs, 0, c.merge,
          c.out_scores, kpad, st);
      break;
    case 32:
      err = launch_ivf_scan_qb<Tiles, 32, IvfSource>(
          c.prep, c.V, c.scale, c.penalty, c.k, c.runs, 0, c.merge,
          c.out_scores, kpad, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || c.out_scores) return (int)err;
  return (int)launch_tree_merge(c.merge, c.prep.qs1, c.prep.q, c.runs, c.k,
                                kpad, st);
}

// The shared memory (out[0]) and CTAs a multiprocessor (out[1]) of the
// scan instance <Tiles, QB, Source> at k.
template <class Tiles, int QB, class Source>
int ring_config(int k, int* out) {
  const int kpad = k > 128 ? 0 : round_up(k, 32);
  size_t bytes = 0;
  cudaError_t err = ivf_scan_attr<Tiles, QB, Source>(kpad, &bytes);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, ivf_digit_scan<Tiles, QB, Source>, kIvfThreads, bytes);
  out[0] = (int)bytes;
  out[1] = ctas;
  return (int)err;
}

// The IVF digit scans' ring_config at query block qb (8 or 32).
template <class Tiles>
int ivf_digit_config(int qb, int k, int* out) {
  if (qb == 8) return ring_config<Tiles, 8, IvfSource>(k, out);
  if (qb == 32) return ring_config<Tiles, 32, IvfSource>(k, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

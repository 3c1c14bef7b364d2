// The bf16 / f32 scans fed by a cp.async ring: the IVF probe scan
// (ivf_topk.cu) and the flat scan (flat_topk.cu), each three launches of
// one C call: a prologue (ivf_prep.cuh: for the IVF scan ivf_prep without
// digits, the schedule, the probe table, the member lists and, for bf16
// blocks, the queries cast to bf16; for the flat scan float_prep, the cast
// and the merge's counters), the scan and the merge (run_merge.cuh), with
// nothing of PyTorch's between them.
//
// Contract (the TPU kernel _kernel_ivf of tpu_search/ops/pallas_ivf_scan.py
// and ops/ivf_scan.py ivf_topk_plain): for query q and a row of a
// scheduled tile of cluster c,
//   score = alpha * dot(q, row) - penalty[row]   if q probes c
//         = -inf                                  otherwise
// the dot in f32 (bf16 blocks: of bf16 operands), then __fmul_rn by alpha
// and __fsub_rn of the penalty (0 / |v|^2 / +inf), a non-member row -inf
// by a select; the k best per query, descending, first-index (lowest
// flat slot) ties, -inf / -1 past the candidates; with out_scores set (k
// > 128) the masked scores of every schedule position instead, [q,
// max_sched * 128], for a stable sort outside.  The flat scan (FlatSource,
// the TPU kernel _kernel of ops/pallas_topk_dma.py, ops/topk_scan.py
// flat_topk_plain) is the same scan over every 128-row tile of an n-row
// corpus, without the probe table, rows past n scoring -inf (their bytes
// and penalties never read); its scores-only mode writes [q, n].
//
// What bounds it on the H100: the bytes of the scheduled tiles (2 D + 4 B
// a row for bf16, 4 D + 4 for f32), at nprobe 32 and Q 1 about 50 MB (15
// us); at Q 128 the member tiles of every query block, which each block
// streams once, so the fewer blocks the fewer bytes.
//
// Design (the digit scans' ring, ivf_digit_scan.cuh, with float
// operands):
//  - Grid (query blocks, runs), runs = multiprocessors x CTAs a
//    multiprocessor / query blocks; a CTA takes a contiguous run of its
//    block's member list (run_begin), so it never visits an entry none of
//    its queries probes (flat: a contiguous run of the corpus's tiles).
//  - A 3-stage cp.async ring over (entry, 128-byte chunk of a row) pairs,
//    128-byte swizzled K-major: the tile's 128 rows (bf16: 64 dims, f32:
//    32) and the block's QB query rows of the same dims, which ride with
//    each chunk from L2; the tile's penalties and the block's probe-table
//    entries on a side ring.  The next member tile's first chunks land
//    while this tile's last ones multiply.
//  - Products.  bf16 at QB 32 (Q above the small-query cutoff of 16):
//    wgmma m64n32k16 f32 += bf16 x bf16, the tile's 128 rows as M over two
//    warpgroups, the block's 32 queries as N.  QB 64 (m64n64k16, two
//    blocks at Q 128) read 0.95x QB 32's time at Q 128, k 10 and 1.7x at
//    k 128 (one CTA a multiprocessor) on an H100, and 1.1x at Q 32, so it
//    went.  bf16 at QB 16: mma.sync m16n8k16, 16 queries x 16 rows a warp
//    (at Q 8 it read 0.98x QB 32 and 0.91x QB 64).  f32: exact f32 FMAs on
//    the CUDA cores (not TF32, which would be another result), a thread a
//    row and every second query, fed from the same ring (16-byte reads of
//    the swizzled rows, free of bank conflicts), at QB 16 for every Q (QB
//    64 read 1.7-2.6x its time at Q 8-128).  Neither a 4- or 6-stage ring
//    nor a bound of 2-4 CTAs a multiprocessor nor leaving each chunk's
//    wgmma in flight until the next chunk landed read faster on an H100.
//  - Epilogue and selection: the tile's scores go to shared memory
//    (aliasing the stage just multiplied), and one warp a query offers
//    them to its sorted list behind a k-th-best gate (topk_select.cuh
//    consume_tile, a group of 32 at once where more than 3 pass:
//    warp_merge); the run's lists go to part_s / part_i for the tree
//    merge, which here multiplies by nothing.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "ivf_digit_scan.cuh"

namespace {

// The block dtypes (types, not bools, so that the kernels' SASS names say
// which is which).
struct Bf16Rows {
  static constexpr bool kBf16 = true;
};
struct F32Rows {
  static constexpr bool kBf16 = false;
};

// Shared memory of one scan CTA: the ring (the tile's 128 rows, then the
// QB query rows, of one 128-byte chunk a stage; 1024-byte aligned), the
// side ring, then the partial lists.  S [QB, 128] f32 aliases the stage
// just multiplied.
template <bool kBf16, int QB>
struct FloatLayout {
  static constexpr bool kWgmma = kBf16 && QB == 32;
  // The launch bound's CTAs a multiprocessor: bf16 at QB 16 three, as its
  // shared memory allows (80 registers; left to ptxas it spilled 68 bytes
  // at 80 once warp_merge joined the selection, and read 5-8 % slower at
  // 1M rows on an H100); the other instances as ptxas chooses.
  static constexpr int kMinCtas = kBf16 && QB == 16 ? 3 : 1;
  static constexpr int kTileBytes = kIvfTile * kIvfChunk;
  static constexpr int kStageBytes = kTileBytes + QB * kIvfChunk;
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(QB * kIvfTile * 4 <= kStageBytes,
                "S must fit the stage it aliases");
  // penalty[128], the probe table's entry of each query [QB], tile, entry
  static constexpr int kSideBytes = (kIvfTile * 4 + QB * 4 + 8 + 15) / 16 * 16;
  static constexpr int kFixed = kIvfStages * (kStageBytes + kSideBytes);
  static size_t bytes(int kpad) { return kFixed + (size_t)QB * kpad * 8 + 1024; }
};

__device__ __forceinline__ void hmma_16816(float c[4], const uint32_t a[4],
                                           const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[64 x 32] += a[64 x 16] . b[32 x 16]^T, bf16 operands K-major in shared
// memory (128-byte swizzle), f32 accumulators laid out as in
// int8_wgmma.cuh.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One query block's run of its entries.  V the corpus as 128-row tiles
// of row_bytes a row; Qv the queries [q, d] in the corpus dtype;
// IvfSource: table [q, nlist] (0 / -inf), mem / mem_count from the
// prologue; FlatSource: the n rows' tiles (table, mem and mem_count
// unused).  out_scores [q, n_out].
template <class Rows, int QB, class Source>
__global__ void __launch_bounds__(kIvfThreads,
                                  FloatLayout<Rows::kBf16, QB>::kMinCtas)
ivf_float_scan(const uint8_t* __restrict__ V, const float* __restrict__ penalty,
               const uint8_t* __restrict__ Qv, const float* __restrict__ table,
               const int2* __restrict__ mem, const int* __restrict__ mem_count,
               int row_bytes, int q, int k, int kpad, int nlist, int tpc,
               int max_sched, int n, size_t n_out, float alpha,
               float* __restrict__ part_s, int* __restrict__ part_i,
               float* __restrict__ out_scores) {
  constexpr bool kBf16 = Rows::kBf16;
  constexpr bool kFlat = Source::kFlat;
  using L = FloatLayout<kBf16, QB>;
  extern __shared__ __align__(1024) unsigned char float_smem[];
  uint8_t* ring =
      float_smem + ((1024 - (smem_addr(float_smem) & 1023)) & 1023);
  uint8_t* side = ring + kIvfStages * L::kStageBytes;
  float* bs = reinterpret_cast<float*>(side + kIvfStages * L::kSideBytes);
  int* bi = reinterpret_cast<int*>(bs + QB * kpad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wg = warp >> 2;
  const int blk = blockIdx.x, q0 = blk * QB;
  const int nkc = (row_bytes + kIvfChunk - 1) / kIvfChunk;
  const int n_mem = kFlat ? (n + kIvfTile - 1) / kIvfTile : mem_count[blk];
  const int e0 = run_begin(n_mem, gridDim.y, blockIdx.y);
  const int n_ent = run_begin(n_mem, gridDim.y, blockIdx.y + 1) - e0;
  const int n_items = n_ent * nkc;
  const int2* recs = kFlat ? nullptr : mem + (size_t)blk * max_sched + e0;
  auto record = [&](int e) {
    return kFlat ? make_int2(e0 + e, e0 + e) : recs[e];
  };

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
      const uint8_t* rows = V + (size_t)rec.x * kIvfTile * row_bytes;
      for (int i = tid; i < kIvfTile * 8; i += kIvfThreads) {
        const int r = i >> 3, c = i & 7, kb = kc + c * 16;
        // flat: the bytes of rows past n are never read
        const bool ok = kb < row_bytes && (!kFlat || rec.x * kIvfTile + r < n);
        cp_async<16>(st + r * 128 + ((c ^ (r & 7)) << 4),
                     ok ? rows + (size_t)r * row_bytes + kb : V, ok ? 16 : 0);
      }
      for (int i = tid; i < QB * 8; i += kIvfThreads) {
        const int r = i >> 3, c = i & 7, kb = kc + c * 16;
        const bool ok = q0 + r < q && kb < row_bytes;
        cp_async<16>(st + L::kTileBytes + r * 128 + ((c ^ (r & 7)) << 4),
                     ok ? Qv + (size_t)(q0 + r) * row_bytes + kb : Qv,
                     ok ? 16 : 0);
      }
      if (kc == 0) {
        uint8_t* sd = side + (e % kIvfStages) * L::kSideBytes;
        if (kFlat) {
          // row by row: n need not be a multiple of 4
          if (tid < kIvfTile) {
            const size_t row = (size_t)rec.x * kIvfTile + tid;
            const bool ok = row < (size_t)n;
            cp_async4(sd + tid * 4, ok ? penalty + row : penalty, ok ? 4 : 0);
          } else if (tid == kIvfTile) {
            int* ids = reinterpret_cast<int*>(sd + 512 + QB * 4);
            ids[0] = rec.x;
            ids[1] = rec.y;
          }
        } else if (tid < 32) {
          cp_async<16>(sd + tid * 16,
                       penalty + (size_t)rec.x * kIvfTile + tid * 4, 16);
        } else if (tid < 32 + QB) {
          const int j = tid - 32;
          const bool ok = q0 + j < q;
          cp_async4(sd + 512 + j * 4,
                    ok ? table + (size_t)(q0 + j) * nlist + rec.x / tpc : table,
                    ok ? 4 : 0);
        } else if (tid == 32 + QB) {
          int* ids = reinterpret_cast<int*>(sd + 512 + QB * 4);
          ids[0] = rec.x;
          ids[1] = rec.y;
        }
      }
    }
    cp_async_commit();
  };

  // wgmma: query 8 j + 2 t + e % 2, tile row 64 wg + 16 (warp % 4) + g + 8
  // (e / 2) in acc[4 j + e]; mma.sync: query g + 8 (e / 2), tile row 16
  // warp + 8 nt + 2 t + e % 2 in acc[4 nt + e]; FMA: query (tid / 128) + 2
  // i, tile row tid % 128 in acc[i].
  constexpr int kAcc = L::kWgmma || !kBf16 ? QB / 2 : 8;
  float acc[kAcc];
  for (int v = 0; v < kIvfStages - 1; ++v) issue(v);
  for (int u = 0; u < n_items; ++u) {
    cp_async_wait<kIvfStages - 2>();
    __syncthreads();  // item u landed everywhere; stage (u - 1) is free
    issue(u + kIvfStages - 1);
    const int e = u / nkc, kci = u - e * nkc;
    uint8_t* st = ring + (u % kIvfStages) * L::kStageBytes;
    const uint8_t* Qs = st + L::kTileBytes;
    if (kci == 0) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    }
    if constexpr (L::kWgmma) {
      const uint64_t da = sw128_desc(st + wg * 64 * kIvfChunk);
      const uint64_t db = sw128_desc(Qs);
      fence_proxy_async();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kIvfChunk / 32; ++kk)
        wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    } else if constexpr (kBf16) {
#pragma unroll
      for (int ks = 0; ks < kIvfChunk; ks += 32) {
        uint32_t a[4];
        a[0] = ld_sw(Qs, g, ks + t * 4);
        a[1] = ld_sw(Qs, g + 8, ks + t * 4);
        a[2] = ld_sw(Qs, g, ks + 16 + t * 4);
        a[3] = ld_sw(Qs, g + 8, ks + 16 + t * 4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int r = warp * 16 + nt * 8 + g;
          const uint32_t b[2] = {ld_sw(st, r, ks + t * 4),
                                 ld_sw(st, r, ks + 16 + t * 4)};
          hmma_16816(acc + nt * 4, a, b);
        }
      }
    } else {
      const int r = tid & (kIvfTile - 1), grp = tid >> 7;
#pragma unroll 1
      for (int c = 0; c < 8; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(
            st + r * 128 + ((c ^ (r & 7)) << 4));
#pragma unroll
        for (int i = 0; i < QB / 2; ++i) {
          const int qq = grp + 2 * i;
          const float4 x = *reinterpret_cast<const float4*>(
              Qs + qq * 128 + ((c ^ (qq & 7)) << 4));
          acc[i] = fmaf(x.x, v.x, acc[i]);
          acc[i] = fmaf(x.y, v.y, acc[i]);
          acc[i] = fmaf(x.z, v.z, acc[i]);
          acc[i] = fmaf(x.w, v.w, acc[i]);
        }
      }
    }
    if (kci != nkc - 1) continue;

    // The tile's epilogue: scores into S, then the selection (or the
    // scores-only output).
    const uint8_t* sd = side + (e % kIvfStages) * L::kSideBytes;
    const float* pn = reinterpret_cast<const float*>(sd);
    const float* probed = pn + kIvfTile;  // 0, or -inf: not probed
    const int* ids = reinterpret_cast<const int*>(sd + 512 + QB * 4);
    float* S = reinterpret_cast<float*>(st);
    // IVF: -inf where the query does not probe the tile's cluster; flat:
    // -inf past the n rows
    auto put = [&](int qq, int row, float s) {
      const bool live = kFlat ? ids[0] * kIvfTile + row < n
                              : probed[qq] != -INFINITY;
      S[qq * kIvfTile + row] =
          live ? __fsub_rn(__fmul_rn(s, alpha), pn[row]) : -INFINITY;
    };
    __syncthreads();  // every warp is done reading the region S aliases
    if constexpr (L::kWgmma) {
#pragma unroll
      for (int j = 0; j < QB / 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          put(8 * j + 2 * t + (x & 1),
              wg * 64 + (warp & 3) * 16 + g + 8 * (x >> 1), acc[4 * j + x]);
    } else if constexpr (kBf16) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          put(g + 8 * (x >> 1), warp * 16 + nt * 8 + 2 * t + (x & 1),
              acc[4 * nt + x]);
    } else {
#pragma unroll
      for (int i = 0; i < QB / 2; ++i)
        put((tid >> 7) + 2 * i, tid & (kIvfTile - 1), acc[i]);
    }
    __syncthreads();
    if (out_scores) {
      // IVF: schedule position ids[1]; flat: the tile itself
      const size_t at = (size_t)ids[1] * kIvfTile;
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

template <class Rows, int QB, class Source>
cudaError_t float_scan_attr(int kpad, size_t* bytes) {
  static size_t caps[kCapDevices] = {};
  *bytes = FloatLayout<Rows::kBf16, QB>::bytes(kpad);
  return raise_smem_cap((const void*)ivf_float_scan<Rows, QB, Source>, *bytes,
                        caps);
}

// The scan launch of an IVF call (p: its prologue's outputs) or, with
// Source FlatSource, of a flat call over n rows (p.q, p.d, p.queries and,
// for bf16 rows, p.qcast set).
template <class Rows, int QB, class Source>
cudaError_t launch_float_scan_qb(const PrepArgs& p, const void* V,
                                 const float* penalty, float alpha, int k,
                                 int runs, int n, const MergeArgs& m,
                                 float* out_scores, int kpad, cudaStream_t st) {
  constexpr bool kBf16 = Rows::kBf16;
  size_t bytes;
  cudaError_t err = float_scan_attr<Rows, QB, Source>(kpad, &bytes);
  if (err != cudaSuccess) return err;
  const void* qv = kBf16 ? static_cast<const void*>(p.qcast)
                         : static_cast<const void*>(p.queries);
  const size_t n_out =
      Source::kFlat ? (size_t)n : (size_t)p.max_sched * kIvfTile;
  dim3 grid((p.q + QB - 1) / QB, runs);
  ivf_float_scan<Rows, QB, Source><<<grid, kIvfThreads, bytes, st>>>(
      static_cast<const uint8_t*>(V), penalty,
      static_cast<const uint8_t*>(qv), p.table, p.mem, p.mem_count,
      p.d * (kBf16 ? 2 : 4), p.q, k, kpad, p.nlist, p.tpc, p.max_sched, n,
      n_out, alpha, m.part_s, m.part_i, out_scores);
  return cudaGetLastError();
}

// The query blocks: bf16 16 (mma.sync) or 32 (wgmma); f32 16.  fn(Rows{},
// qb constant) for the call's (is_bf16, qb), or cudaErrorInvalidValue.
template <class Fn>
cudaError_t float_dispatch(int is_bf16, int qb, Fn&& fn) {
  using Q16 = std::integral_constant<int, 16>;
  using Q32 = std::integral_constant<int, 32>;
  if (is_bf16 && qb == 16) return fn(Bf16Rows{}, Q16{});
  if (is_bf16 && qb == 32) return fn(Bf16Rows{}, Q32{});
  if (!is_bf16 && qb == 16) return fn(F32Rows{}, Q16{});
  return cudaErrorInvalidValue;
}

// The scan of a call at (is_bf16, qb) over Source, then unless out_scores
// is set the tree merge (merge.count zeroed before).
template <class Source>
int launch_float_scan_merge(const PrepArgs& p, int is_bf16, const void* V,
                            const float* penalty, float alpha, int k, int runs,
                            int n, const MergeArgs& m, float* out_scores,
                            cudaStream_t st) {
  const int kpad = out_scores ? 0 : round_up(k, 32);
  cudaError_t err = float_dispatch(is_bf16, p.qb, [&](auto rows, auto qb) {
    return launch_float_scan_qb<decltype(rows), decltype(qb)::value, Source>(
        p, V, penalty, alpha, k, runs, n, m, out_scores, kpad, st);
  });
  if (err != cudaSuccess || out_scores) return (int)err;
  return (int)launch_tree_merge(m, nullptr, p.q, runs, k, kpad, st);
}

// The scan's shared memory and CTAs a multiprocessor at (is_bf16, qb, k)
// over Source (out[0], out[1]).
template <class Source>
int float_config(int is_bf16, int qb, int k, int* out) {
  const int kpad = k > 128 ? 0 : round_up(k, 32);
  size_t bytes = 0;
  const void* fn = nullptr;
  cudaError_t err = float_dispatch(is_bf16, qb, [&](auto rows, auto b) {
    using R = decltype(rows);
    constexpr int kQ = decltype(b)::value;
    fn = (const void*)ivf_float_scan<R, kQ, Source>;
    return float_scan_attr<R, kQ, Source>(kpad, &bytes);
  });
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kIvfThreads,
                                                      bytes);
  out[0] = (int)bytes;
  out[1] = ctas;
  return (int)err;
}

}  // namespace

// The gradient of the stock flash attention of the JAX encoder's
// attention_impl="flash" mode: dQ, dK, dV and the bias's gradient, for
// bf16 and f32, over [B, heads, S, hd].
//
// Replaces: the VJP of jax.experimental.pallas.ops.tpu.flash_attention
// (_flash_attention_bwd) and its two kernels, _flash_attention_bwd_dkv (dK,
// dV) and _flash_attention_bwd_dq (dQ and dS, which is the bias's
// gradient), as jax.grad reaches them through tpu_search/models/mpnet.py
// :262-274 (operands :409-417), at the default block sizes (128), with no
// causal mask.
//
// Contract (ops/flash_attention.py flash_attention_bwd_plain; T the
// compute dtype of q, k, v, o, dO and ab; f32 math), per (batch row, head),
// from the forward's output o (in T) and its residuals m, l ([b, heads, s]
// f32):
//   di = rowsum(f32(o) f32(dO))       -- not rowsum(P o dP);
//   s  = (q k^T + ab) * scale + (q_seg == kv_seg ? 0 : -0.7 * FLT_MAX);
//   p  = exp(s - m) * (1 / l);
//   dV = T(p)^T dO;   dP = dO V^T;   dS = ((dP - di) * p) * scale;
//   dK = T(dS)^T q;   dQ = T(dS) K   -- in bf16 dS rounds once, before
//        both products (the stock kernel's rounding site); in f32 nothing
//        rounds;
//   dab[h] = T(sum over b of f32(T(dS[b, h]))): each batch row's dS in
//        ab's dtype, summed in f32 in groups of batch rows (each group in
//        order, then the groups in order: ops/flash_attention.py
//        bias_group_rows), rounded once (the transpose of JAX's broadcast
//        of one [heads, S, S] bias to every batch row); the segment ids get
//        no gradient.
// dQ, dK, dV come out in T.  Any head size the stock kernel takes.
//
// What bounds it on the H100: at B 128, S 384, H 768 (12 heads of 64,
// bf16) it reads q, k, v, o and dO and writes dQ, dK and dV (8 B S H 2 =
// 604 MB) plus ab and dab (7 MB): 0.18 ms at 3.35 TB/s.  Its five products
// of 2 B heads S^2 hd flops each (1.45e11) take 0.147 ms at 989 TFLOP/s
// bf16: bytes bound it.  In f32 the same products run as 3xTF32 (three
// tf32 products each, 4.35e11 flops, 0.88 ms at 495 TFLOP/s) over twice
// the bytes: operations bound it.  Both designs below recompute s and dP
// in each of their two passes: seven products, not five, the price of
// having no atomics.
//
// Every path starts with row_stats: each row's (m, 1 / l, di), di from o
// and dO, for both passes (one launch), and ends, where the bias's
// gradient has more than one batch group, with dab_sum: dab = T(the
// groups' f32 partials summed in group order).  The groups are B / 16
// from B 32 on (one group below), so the partials hold an eighth of the
// bytes of a per-row bf16 dS, a sixteenth of a per-row f32 one; without a
// bias gradient every batch row is a group of its own.  Nothing of [B,
// heads, S, S] is written.  Every sum runs in a fixed order and there are
// no atomics: two calls give the same bits.
//
// bf16 up to hd 256 (rows_wgmma, cols_wgmma, helpers in flash_wgmma.cuh):
// every product is a bf16 wgmma, every q, k, v and dO tile a TMA copy.
// Each CTA is one or two consumer warpgroups and one producer warp whose
// one thread keeps a ring of TMA copies in flight, stage by stage on
// "full" and "empty" mbarriers.
//   1. rows (dQ and the bias's gradient): one CTA per (64 query rows,
//      head, group of `group` batch rows).  For each batch row of the
//      group in order: its q and dO tiles (its rows' statistics loaded a
//      batch row ahead); per 64-key tile of K, V, the [64 queries, 64
//      keys] bias tile and the key segment ids, the tiles alternating
//      between the warpgroups: s = q k^T and dP = dO V^T (wgmma, both
//      operands K-major from the tiles), p and dS in registers, dS added
//      to the CTA's [64, keys] f32 tile of the bias's gradient in shared
//      memory (each thread owns its elements: no barrier, a fixed order),
//      dQ += T(dS) K (dS from registers, K MN-major); at the batch row's
//      end the second warpgroup's dQ goes to the first through the row's q
//      buffer, which adds it to its own and writes the row (one
//      warpgroup above hd 64).  The tile of dab is swizzled instead of
//      padded and the segment ids sit apart from the 1024-byte stages,
//      which leaves room for two q buffers and four stages at S 384, hd
//      64.  After the group, the tile is the group's partial sum, written
//      to a [groups, heads, S, S] f32 partial (or, one group, to dab).
//      Where the tile of every key does not fit beside the ring (large S),
//      the keys go in chunks, dQ carried between them in an f32 scratch the
//      CTA owns (the same chunks without a bias gradient, so that dQ sums
//      in one order either way).
//   2. columns (dK, dV): one CTA (one consumer warpgroup, two CTAs a
//      multiprocessor up to hd 64) per (64 keys, head, batch row): K and V
//      once, then per step of QT queries Q, dO, their (m, 1 / l, di), the
//      bias tile and the query segment ids: s^T = K Q^T, dP^T = V dO^T,
//      p^T and dS^T in registers, dV += T(p)^T dO and dK += T(dS)^T Q
//      (MN-major Q and dO).
// Above hd 128 a CTA owns half of the output columns (out_cols), so two
// CTAs share each row block, each recomputing the scores.
//
// f32, and bf16 above hd 256 (helpers in flash_tf32.cuh): the same two
// passes on tf32 wgmma.  tf32 wgmma reads both operands K-major, which
// dQ's, dK's and dV's products do not have, so each of those products' B
// operand is staged transposed (K^T, Q^T, dO^T: the head's columns along
// the plane's rows); every operand is split into tf32 hi and lo planes
// once, as it is staged (bf16 operands are exact in tf32: one product, not
// three).  Each tile's dQ, dV and dK products sum in a fresh accumulator
// added to the total with one rounded add (the tensor cores' own sums
// truncate and drift past 1e-5 over a thousand keys).
//   1. rows (dQ, dS, the bias's gradient): for each batch row of a CTA's
//      group, its q and dO planes, then per 32-key tile K and V planes and
//      the K^T planes of the CTA's dQ columns; s and dP by 3xTF32 wgmma
//      from the planes, dS in registers (rounded to T), into the group's
//      f32 partial of the bias's gradient (each thread its own elements, a
//      fixed order, no atomics) and, split in registers, into dQ += dS K.
//      The keys are split where the CTAs would not fill the card twice
//      over (small B: one batch group) or (rows_tf32) where the tile of
//      every key does not fit: each split writes its share of dQ to an f32
//      part and dq_sum adds the parts in order.  The split count does not
//      depend on the bias's gradient, so dQ sums in one order either way.
//   2. columns (dK, dV): per 32-query tile the Q and dO planes and the Q^T
//      and dO^T planes of the CTA's columns against the CTA's K and V
//      planes; s^T and dP^T, p^T and dS^T in registers, dV += p^T dO and
//      dK += dS^T Q.
// Up to hd 64 in f32 (rows_pair, cols_pair: one score chunk), a CTA is two
// warpgroups of 64 rows (queries, or keys) sharing each streamed tile's
// planes, whose rows (K and V, or Q and dO) come by cp.async into a raw f32
// tile one tile ahead and are split there by both warpgroups, half the
// split a row it would cost one; above hd 32 rows_pair keeps the group's
// partial of the bias's gradient in global memory (a [128, keys] f32 tile
// would not fit beside the planes).  Above (rows_tf32, cols_tf32: one
// warpgroup, slices of up to 64 output columns) the score products run over
// the head in chunks of 64 columns, everything loaded and staged again for
// each chunk of each tile (correct, not yet fast), and rows_tf32 sums the
// bias's gradient in a [64, keys] f32 tile in shared memory.  The bias,
// the statistics and the segment ids are read from global memory.  What
// paces the passes is each tile's staging and the warpgroups' serialized
// products, not the products' rate (PERF.md §6).

#include <type_traits>

#include "flash_tf32.cuh"

namespace {

using namespace tcattn;
using flash::out_cols;

// -- bf16: wgmma and TMA ------------------------------------------------------

constexpr int kBiasTile = 64 * 128;  // [64 rows][64 keys] bf16
constexpr int kMaxStages = 6;
constexpr int kBarBytes = 128;  // room for 4 + 2 kMaxStages mbarriers
constexpr int kGroupRows = 16;  // batch rows a bias group sums at B >= 32

__host__ __device__ constexpr int round1024(int x) {
  return (x + 1023) / 1024 * 1024;
}

// The row pass's consumer warpgroups: two up to HDP 64, which split the
// keys between them; one above, whose wider tiles and accumulators would
// spill in the registers two warpgroups leave each thread.
template <int HDP>
__host__ __device__ constexpr int consumer_groups() {
  return HDP > 64 ? 1 : 2;
}
template <int NW>
__host__ __device__ constexpr int wg_threads() {
  return 128 * NW + 32;  // and the producer warp
}

// Queries a column-pass step: 64, or 32 from HDP 128 on, which keeps dK's
// and dV's accumulators beside the scores within the registers.
template <int HDP>
__host__ __device__ constexpr int col_step() {
  return HDP >= 128 ? 32 : 64;
}

struct WgArgs {
  const __nv_bfloat16 *o, *dout;  // rows hd apart: di
  const int *q_seg, *kv_seg;
  const float *m, *l;
  __nv_bfloat16 *dq, *dk, *dv, *dab;
  float *stats, *dab_part, *dq_part;
  int b, s, nh, hd, group, ns, kc, qbufs, vec;
  float scale;
};

// q, dO, k, v as [B heads S, ld] operand tiles; ab as [heads S, S] tiles
// of 64 keys.
struct Maps {
  CUtensorMap q, dout, k, v, ab;
};

// The row pass's shared memory (after 1024-byte alignment): `qbufs` (1 or
// 2) buffers of the q and dO tiles (at a batch row's end the second
// warpgroup's dQ passes to the first through the row's buffer, [64][OC]
// f32, the buffer's size), `ns` stages of the K and V tiles and the bias
// tile, each stage's 64 key segment ids, the mbarriers, then the [64][kc]
// f32 tile of the bias's gradient (swizzled, dab_at).
template <int HDP>
struct RowSmem {
  using TT = fwg::Tile<HDP, 64>;
  static constexpr int kBias = 2 * TT::kBytes;  // offset in a stage
  static constexpr int kStage = kBias + kBiasTile;
  static_assert(64 * out_cols<HDP>() * 4 <= 2 * TT::kBytes, "swap fits");
  static __host__ __device__ int ring(int qbufs) {
    return qbufs * 2 * TT::kBytes;
  }
  static __host__ __device__ int segs(int qbufs, int ns) {
    return ring(qbufs) + ns * kStage;
  }
  static __host__ __device__ int bars(int qbufs, int ns) {
    return segs(qbufs, ns) + ns * 256;
  }
  static __host__ __device__ int dab(int qbufs, int ns) {
    return bars(qbufs, ns) + kBarBytes;
  }
  static int bytes(int qbufs, int ns, int kc, bool bias) {
    return 1024 + dab(qbufs, ns) + (bias ? 64 * kc * 4 : 0);
  }
};

// Element (row, col) of the row pass's [64][kc] f32 tile of the bias's
// gradient (kc a multiple of 128): columns XORed by the row's low bits in
// units of 8, so that a warp's float2 accesses of 8 rows meet no bank twice
// in a half-warp.
__device__ __forceinline__ float2* dab_at(float* dab, int kc, int row,
                                          int col) {
  return reinterpret_cast<float2*>(dab + row * kc +
                                   (col ^ ((row & 3) << 3)));
}

// The column pass's (one consumer warpgroup): the K and V tiles, `ns`
// stages of the Q and dO tiles of QT queries, the bias tile of those
// queries and the CTA's keys, their (m, 1 / l, di, -) and segment ids,
// then the mbarriers.  Up to HDP 64, two CTAs a multiprocessor: two
// warpgroups there that keep their own pace read faster than two in
// lockstep over one stream of q and dO (PERF.md).
template <int HDP>
struct ColSmem {
  static constexpr int QT = col_step<HDP>(), kMinCtas = HDP <= 64 ? 2 : 1;
  using KTile = fwg::Tile<HDP, 64>;
  using QTile = fwg::Tile<HDP, QT>;
  static constexpr int kBias = 2 * QTile::kBytes;  // offsets in a stage
  static constexpr int kStats = kBias + QT * 128;
  static constexpr int kSeg = kStats + QT * 16;
  static constexpr int kStage = round1024(kSeg + QT * 4);
  static constexpr int kRing = 2 * KTile::kBytes;
  static __host__ __device__ int bars(int ns) { return kRing + ns * kStage; }
  static int bytes(int ns) { return 1024 + bars(ns) + kBarBytes; }
};

using ftf::align1024;

// Named barriers between the row pass's two consumer warpgroups (0 is
// __syncthreads's): the first is done with the batch row's q and dO / the
// second's dQ is in their buffer.
constexpr int kQDone = 1, kSwapFull = 2;

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// rowsum(f32(o) f32(dO)) over one row of hd elements: this thread's
// share, read `vec` elements at a time (8: every 4th run of 8 columns
// from 8 t; 2: every 4th pair from 2 t; 1: every 4th column from t),
// summed over the quad.
__device__ __forceinline__ float row_dot(const __nv_bfloat16* o,
                                         const __nv_bfloat16* d, int hd,
                                         int t, int vec) {
  float acc = 0.f;
  if (vec == 8) {
#pragma unroll 2
    for (int c = 8 * t; c < hd; c += 32) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + c);
      const uint4 y = *reinterpret_cast<const uint4*>(d + c);
      const auto* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const auto* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 u = __bfloat1622float2(xs[i]);
        const float2 w = __bfloat1622float2(ys[i]);
        acc = __fadd_rn(acc, __fmul_rn(u.x, w.x));
        acc = __fadd_rn(acc, __fmul_rn(u.y, w.y));
      }
    }
  } else if (vec == 2) {
    for (int c = 2 * t; c < hd; c += 8) {
      const float2 x = flash::load2(o + c), y = flash::load2(d + c);
      acc = __fadd_rn(acc, __fmul_rn(x.x, y.x));
      acc = __fadd_rn(acc, __fmul_rn(x.y, y.y));
    }
  } else {
    for (int c = t; c < hd; c += 4)
      acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(o[c]),
                                     __bfloat162float(d[c])));
  }
  return quad_sum(acc);
}

// The same over f32 rows, 4 elements at a time (every 4th run of 4
// columns from 4 t) where vec is 4, else every 4th column from t.
__device__ __forceinline__ float row_dot(const float* o, const float* d,
                                         int hd, int t, int vec) {
  float acc = 0.f;
  if (vec == 4) {
    for (int c = 4 * t; c < hd; c += 16) {
      const float4 x = *reinterpret_cast<const float4*>(o + c);
      const float4 y = *reinterpret_cast<const float4*>(d + c);
      acc = __fadd_rn(acc, __fmul_rn(x.x, y.x));
      acc = __fadd_rn(acc, __fmul_rn(x.y, y.y));
      acc = __fadd_rn(acc, __fmul_rn(x.z, y.z));
      acc = __fadd_rn(acc, __fmul_rn(x.w, y.w));
    }
  } else {
    for (int c = t; c < hd; c += 4) acc = __fadd_rn(acc, __fmul_rn(o[c], d[c]));
  }
  return quad_sum(acc);
}

// Each row's (m, 1 / l, di, -) for both passes, a quad of threads a row
// (row_dot), 64 rows a block: one launch before them, so that no pass waits
// on o and dO.
template <typename T>
__global__ void __launch_bounds__(256)
    row_stats(const T* __restrict__ o, const T* __restrict__ dout,
              const float* __restrict__ m, const float* __restrict__ l,
              float* __restrict__ stats, int hd, int vec) {
  const long long row = (long long)blockIdx.x * 64 + (threadIdx.x >> 2);
  const float mr = m[row], lr = l[row];
  const float di = row_dot(o + row * hd, dout + row * hd, hd,
                           threadIdx.x & 3, vec);
  if ((threadIdx.x & 3) == 0)
    *reinterpret_cast<float4*>(stats + row * 4) =
        make_float4(mr, __fdiv_rn(1.f, lr), di, 0.f);
}

// A row-pass thread's two rows of one batch row: their (m, 1 / l, di, -)
// and segment ids, loaded a batch row ahead of their use.
struct RowInfo {
  float4 st[2];
  int qsg[2];
};

__device__ __forceinline__ RowInfo row_info(const WgArgs& a, int head,
                                            int q, int bb) {
  RowInfo r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = ((long long)bb * a.nh + head) * a.s + q + 8 * h;
    r.st[h] = *reinterpret_cast<const float4*>(a.stats + row * 4);
    r.qsg[h] = a.q_seg[(long long)bb * a.s + q + 8 * h];
  }
  return r;
}

// dS of one score in f32, before it rounds to bf16.
__device__ __forceinline__ float ds_of(float dot, float ab, bool same,
                                       float dpv, float m, float inv_l,
                                       float di, float scale) {
  const float p = __fmul_rn(
      expf(__fsub_rn(flash::score(dot, ab, same, scale), m)), inv_l);
  return __fmul_rn(__fmul_rn(__fsub_rn(dpv, di), p), scale);
}

// Two f32 values rounded to bf16 and packed: the word of an A operand
// (columns 2 t, 2 t + 1 of one row).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 values of a packed word, as f32.
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

template <int HDP, bool kBias>
__global__ void __launch_bounds__(wg_threads<consumer_groups<HDP>()>(), 1)
    rows_wgmma(const __grid_constant__ Maps maps, const WgArgs a) {
  using TT = fwg::Tile<HDP, 64>;
  using L = RowSmem<HDP>;
  constexpr int OC = out_cols<HDP>(), HALVES = HDP / OC,
                NW = consumer_groups<HDP>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);  // buffer i: q, then dO
  unsigned char* ring = sm + L::ring(a.qbufs);
  int* seg_ring = reinterpret_cast<int*>(sm + L::segs(a.qbufs, a.ns));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bars(a.qbufs, a.ns));
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_full + 4;
  uint64_t* empty = full + a.ns;
  float* dab = reinterpret_cast<float*>(sm + L::dab(a.qbufs, a.ns));

  const int s = a.s, nh = a.nh, head = blockIdx.y;
  const int half = blockIdx.x % HALVES, col0 = half * OC;
  const int q0 = blockIdx.x / HALVES * 64;
  const int b0 = blockIdx.z * a.group, b1 = min(a.b, b0 + a.group);
  const int chunks = (s + a.kc - 1) / a.kc;
  const bool own_bias = kBias && half == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      fwg::mbar_init(q_full + i, 1);
      fwg::mbar_init(q_empty + i, 128);  // the first warpgroup frees it
    }
    for (int i = 0; i < a.ns; ++i) {
      fwg::mbar_init(full + i, 1);
      fwg::mbar_init(empty + i, 128);  // one warpgroup takes each tile
    }
    fwg::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NW) {  // the producer warp: one thread
    if (threadIdx.x != 128 * NW) return;
    int st = 0, it = 0;
    uint32_t ph = 0, qph = 0;  // qph: bit i the phase of q buffer i
    for (int c = 0; c < chunks; ++c) {
      const int kc0 = c * a.kc, tiles = min(a.kc, s - kc0) / 64;
      for (int bb = b0; bb < b1; ++bb, ++it) {
        const int row = (bb * nh + head) * s, qb = it % a.qbufs;
        unsigned char* qs = sm + qb * 2 * TT::kBytes;
        fwg::mbar_wait(q_empty + qb, ((qph >> qb) & 1) ^ 1);
        fwg::mbar_expect(q_full + qb, 2 * TT::kBytes);
        for (int nb = 0; nb < TT::NB; ++nb) {
          fwg::tma_load(qs + nb * TT::kBlock, &maps.q, nb * TT::SWE, row + q0,
                        q_full + qb);
          fwg::tma_load(qs + TT::kBytes + nb * TT::kBlock, &maps.dout,
                        nb * TT::SWE, row + q0, q_full + qb);
        }
        qph ^= 1u << qb;
        for (int j = 0; j < tiles; ++j) {
          const int kb = kc0 + 64 * j;
          unsigned char* sl = ring + st * L::kStage;
          fwg::mbar_wait(empty + st, ph ^ 1);
          fwg::mbar_expect(full + st, L::kStage + 256);
          for (int nb = 0; nb < TT::NB; ++nb) {
            fwg::tma_load(sl + nb * TT::kBlock, &maps.k, nb * TT::SWE,
                          row + kb, full + st);
            fwg::tma_load(sl + TT::kBytes + nb * TT::kBlock, &maps.v,
                          nb * TT::SWE, row + kb, full + st);
          }
          fwg::tma_load(sl + L::kBias, &maps.ab, kb, head * s + q0,
                        full + st);
          fwg::bulk_load(seg_ring + 64 * st, a.kv_seg + (long long)bb * s + kb,
                         256, full + st);
          if (++st == a.ns) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // Warpgroup wg takes the key tiles j with j % NW == wg of every chunk;
  // the tiles go to the stages in order, whichever warpgroup takes them.
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows of the block: r0, r0 + 8
  int tile = 0, it = 0;           // every tile's and batch row's count
  uint32_t qph = 0;
  float dq[OC / 8][4];
  RowInfo next = row_info(a, head, q0 + r0, b0);
  for (int c = 0; c < chunks; ++c) {
    const int kc0 = c * a.kc, tiles = min(a.kc, s - kc0) / 64;
    if (own_bias)
      for (int j = wg; j < tiles; j += NW)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *dab_at(dab, a.kc, r0 + 8 * h, 64 * j + 8 * n + 2 * t) =
                make_float2(0.f, 0.f);
    for (int bb = b0; bb < b1; ++bb, ++it) {
      const long long bh = (long long)bb * nh + head;
      const int qb = it % a.qbufs;
      const unsigned char* qs = sm + qb * 2 * TT::kBytes;
      const unsigned char* dos = qs + TT::kBytes;
      // this batch row's statistics, and the loads of the next one's
      const RowInfo cur = next;
      next = row_info(a, head, q0 + r0, bb + 1 < b1 ? bb + 1 : b0);
      float m[2], inv_l[2], di[2];
      int qsg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[h] = cur.st[h].x;
        inv_l[h] = cur.st[h].y;
        di[h] = cur.st[h].z;
        qsg[h] = cur.qsg[h];
      }
      if (c == 0 || wg != 0) {
        fwg::zero_acc(dq);
      } else {  // the first warpgroup carries dQ from the earlier chunks
#pragma unroll
        for (int n = 0; n < OC / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = *reinterpret_cast<const float2*>(
                a.dq_part + (bh * s + q0 + r0 + 8 * h) * HDP + col0 + 8 * n +
                2 * t);
            dq[n][2 * h] = v.x;
            dq[n][2 * h + 1] = v.y;
          }
      }
      fwg::mbar_wait(q_full + qb, (qph >> qb) & 1);
      qph ^= 1u << qb;
      for (int j = 0; j < tiles; ++j, ++tile) {
        if (j % NW != wg) continue;
        const int st = tile % a.ns;
        const unsigned char* sl = ring + st * L::kStage;
        fwg::mbar_wait(full + st, (tile / a.ns) & 1);
        float sc[8][4], dp[8][4];
        fwg::zero_acc(sc);
        fwg::zero_acc(dp);
        fwg::fence_acc(sc);
        fwg::fence_acc(dp);
        fwg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          fwg::wgmma_ss(sc, TT::kmajor(qs, kk), TT::kmajor(sl, kk));
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk)
          fwg::wgmma_ss(dp, TT::kmajor(dos, kk),
                        TT::kmajor(sl + TT::kBytes, kk));
        fwg::wgmma_commit();
        fwg::wgmma_wait();
        fwg::fence_acc(sc);
        fwg::fence_acc(dp);

        // dS rounded to bf16 once, packed as dQ's A operand (k16 step n /
        // 2, word 2 (n % 2) + h) and added to the bias's gradient
        const unsigned char* bias = sl + L::kBias;
        const int* segs = seg_ring + 64 * st;
        uint32_t af[4][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = 8 * n + 2 * t;
          const int2 ks = *reinterpret_cast<const int2*>(segs + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 bv = fwg::sw128_pair(bias, r0 + 8 * h, col);
            const uint32_t w = pack_bf16(
                ds_of(sc[n][2 * h], bv.x, qsg[h] == ks.x, dp[n][2 * h], m[h],
                      inv_l[h], di[h], a.scale),
                ds_of(sc[n][2 * h + 1], bv.y, qsg[h] == ks.y,
                      dp[n][2 * h + 1], m[h], inv_l[h], di[h], a.scale));
            af[n >> 1][2 * (n & 1) + h] = w;
            if (own_bias) {
              const float2 d = unpack_bf16(w);
              float2* acc = dab_at(dab, a.kc, r0 + 8 * h, 64 * j + col);
              const float2 v = *acc;
              *acc = make_float2(__fadd_rn(v.x, d.x), __fadd_rn(v.y, d.y));
            }
          }
        }
        fwg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          fwg::wgmma_rs(dq, af[kk], TT::mnmajor(sl, kk, col0));
        fwg::wgmma_commit();
        fwg::wgmma_wait();
        fwg::fence_acc(dq);
        fwg::mbar_arrive(empty + st);
      }
      if (NW > 1) {  // dQ = the first warpgroup's + the second's, in order
        float4* swap = reinterpret_cast<float4*>(sm + qb * 2 * TT::kBytes);
        if (wg == 1) {
          named_sync(kQDone);
#pragma unroll
          for (int n = 0; n < OC / 8; ++n)
            swap[n * 128 + tid] =
                make_float4(dq[n][0], dq[n][1], dq[n][2], dq[n][3]);
          fwg::fence_proxy_async();  // before TMA refills the buffer
          named_arrive(kSwapFull);
          continue;
        }
        named_arrive(kQDone);
        named_sync(kSwapFull);
#pragma unroll
        for (int n = 0; n < OC / 8; ++n) {
          const float4 v = swap[n * 128 + tid];
          dq[n][0] = __fadd_rn(dq[n][0], v.x);
          dq[n][1] = __fadd_rn(dq[n][1], v.y);
          dq[n][2] = __fadd_rn(dq[n][2], v.z);
          dq[n][3] = __fadd_rn(dq[n][3], v.w);
        }
        fwg::fence_proxy_async();
      }
      fwg::mbar_arrive(q_empty + qb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = bh * s + q0 + r0 + 8 * h;
#pragma unroll
        for (int n = 0; n < OC / 8; ++n) {
          const int col = col0 + 8 * n + 2 * t;
          if (c + 1 == chunks)
            ftf::store_pair(a.dq + row * a.hd, col, a.hd, dq[n][2 * h],
                       dq[n][2 * h + 1]);
          else
            *reinterpret_cast<float2*>(a.dq_part + row * HDP + col) =
                make_float2(dq[n][2 * h], dq[n][2 * h + 1]);
        }
      }
    }
    if (own_bias) {
      // the group's sum of this chunk's keys: to its partial, or to dab
      for (int j = wg; j < tiles; j += NW)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = 64 * j + 8 * n + 2 * t;
            const float2 v = *dab_at(dab, a.kc, r0 + 8 * h, col);
            const long long e =
                ((long long)head * s + q0 + r0 + 8 * h) * s + kc0 + col;
            if (a.dab_part != nullptr)
              *reinterpret_cast<float2*>(
                  a.dab_part + (long long)blockIdx.z * nh * s * s + e) = v;
            else
              flash::store2(a.dab + e, v.x, v.y);
          }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(wg_threads<1>(), ColSmem<HDP>::kMinCtas)
    cols_wgmma(const __grid_constant__ Maps maps, const WgArgs a) {
  using L = ColSmem<HDP>;
  using KTile = typename L::KTile;
  using QTile = typename L::QTile;
  constexpr int QT = L::QT, OC = out_cols<HDP>(), HALVES = HDP / OC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* ks = sm;  // the CTA's K tile, then its V tile
  unsigned char* vs = sm + KTile::kBytes;
  unsigned char* ring = sm + L::kRing;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::bars(a.ns));
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + a.ns;

  const int s = a.s, nh = a.nh, head = blockIdx.y, bb = blockIdx.z;
  const int half = blockIdx.x % HALVES, col0 = half * OC;
  const int k0 = blockIdx.x / HALVES * 64;
  const long long bh = (long long)bb * nh + head;
  const int tiles = s / QT;

  if (threadIdx.x == 0) {
    fwg::mbar_init(kv_full, 1);
    for (int i = 0; i < a.ns; ++i) {
      fwg::mbar_init(full + i, 1);
      fwg::mbar_init(empty + i, 128);
    }
    fwg::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: one thread
    if (threadIdx.x != 128) return;
    const int row = (int)(bh * s);
    fwg::mbar_expect(kv_full, 2 * KTile::kBytes);
    for (int nb = 0; nb < KTile::NB; ++nb) {
      fwg::tma_load(ks + nb * KTile::kBlock, &maps.k, nb * KTile::SWE,
                    row + k0, kv_full);
      fwg::tma_load(vs + nb * KTile::kBlock, &maps.v, nb * KTile::SWE,
                    row + k0, kv_full);
    }
    int st = 0;
    uint32_t ph = 0;
    for (int i = 0; i < tiles; ++i) {
      const int qb = i * QT;
      unsigned char* sl = ring + st * L::kStage;
      fwg::mbar_wait(empty + st, ph ^ 1);
      fwg::mbar_expect(full + st, L::kSeg + QT * 4);
      for (int nb = 0; nb < QTile::NB; ++nb) {
        fwg::tma_load(sl + nb * QTile::kBlock, &maps.q, nb * QTile::SWE,
                      row + qb, full + st);
        fwg::tma_load(sl + QTile::kBytes + nb * QTile::kBlock, &maps.dout,
                      nb * QTile::SWE, row + qb, full + st);
      }
      fwg::tma_load(sl + L::kBias, &maps.ab, k0, head * s + qb, full + st);
      fwg::bulk_load(sl + L::kStats, a.stats + (bh * s + qb) * 4, QT * 16,
                     full + st);
      fwg::bulk_load(sl + L::kSeg, a.q_seg + (long long)bb * s + qb, QT * 4,
                     full + st);
      if (++st == a.ns) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's keys of the block: r0, r0 + 8
  const int kseg[2] = {a.kv_seg[(long long)bb * s + k0 + r0],
                       a.kv_seg[(long long)bb * s + k0 + r0 + 8]};
  float dk[OC / 8][4], dv[OC / 8][4];
  fwg::zero_acc(dk);
  fwg::zero_acc(dv);
  fwg::mbar_wait(kv_full, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int i = 0; i < tiles; ++i) {
    const unsigned char* sl = ring + st * L::kStage;
    const unsigned char* dosl = sl + QTile::kBytes;
    fwg::mbar_wait(full + st, ph);
    float sc[QT / 8][4], dp[QT / 8][4];
    fwg::zero_acc(sc);
    fwg::zero_acc(dp);
    fwg::fence_acc(sc);
    fwg::fence_acc(dp);
    fwg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      fwg::wgmma_ss(sc, KTile::kmajor(ks, kk), QTile::kmajor(sl, kk));
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      fwg::wgmma_ss(dp, KTile::kmajor(vs, kk), QTile::kmajor(dosl, kk));
    fwg::wgmma_commit();
    fwg::wgmma_wait();
    fwg::fence_acc(sc);
    fwg::fence_acc(dp);

    // p^T and dS^T rounded to bf16 and packed as dV's and dK's A operands
    // (k16 step n / 2, word 2 (n % 2) + h)
    const unsigned char* bias = sl + L::kBias;
    const float* stats = reinterpret_cast<const float*>(sl + L::kStats);
    const int* segs = reinterpret_cast<const int*>(sl + L::kSeg);
    uint32_t pa[QT / 16][4], da[QT / 16][4];
#pragma unroll
    for (int n = 0; n < QT / 8; ++n) {
      const int q = 8 * n + 2 * t;
      const float4 r[2] = {*reinterpret_cast<const float4*>(stats + 4 * q),
                           *reinterpret_cast<const float4*>(stats + 4 * q + 4)};
      const int2 qsg = *reinterpret_cast<const int2*>(segs + q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2], ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float ab =
              __bfloat162float(*fwg::sw128_at(bias, q + c, r0 + 8 * h));
          p[c] = __fmul_rn(
              expf(__fsub_rn(flash::score(sc[n][2 * h + c], ab,
                                          (c ? qsg.y : qsg.x) == kseg[h],
                                          a.scale),
                             r[c].x)),
              r[c].y);
          ds[c] = __fmul_rn(__fmul_rn(__fsub_rn(dp[n][2 * h + c], r[c].z),
                                      p[c]),
                            a.scale);
        }
        pa[n >> 1][2 * (n & 1) + h] = pack_bf16(p[0], p[1]);
        da[n >> 1][2 * (n & 1) + h] = pack_bf16(ds[0], ds[1]);
      }
    }
    fwg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      fwg::wgmma_rs(dv, pa[kk], QTile::mnmajor(dosl, kk, col0));
      fwg::wgmma_rs(dk, da[kk], QTile::mnmajor(sl, kk, col0));
    }
    fwg::wgmma_commit();
    fwg::wgmma_wait();
    fwg::fence_acc(dv);
    fwg::fence_acc(dk);
    fwg::mbar_arrive(empty + st);
    if (++st == a.ns) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long key = bh * s + k0 + r0 + 8 * h;
#pragma unroll
    for (int n = 0; n < OC / 8; ++n) {
      const int col = col0 + 8 * n + 2 * t;
      ftf::store_pair(a.dk + key * a.hd, col, a.hd, dk[n][2 * h],
                      dk[n][2 * h + 1]);
      ftf::store_pair(a.dv + key * a.hd, col, a.hd, dv[n][2 * h],
                      dv[n][2 * h + 1]);
    }
  }
}

// dab[e] = T(sum over the groups, in order, of part[g][e]), four
// elements a thread.
template <typename T>
__global__ void dab_sum(const float* __restrict__ part, T* __restrict__ dab,
                        int groups, long long n) {
  for (long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       e < n; e += 4 * (long long)gridDim.x * blockDim.x) {
    float4 acc = *reinterpret_cast<const float4*>(part + e);
    for (int g = 1; g < groups; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(part + (long long)g * n + e);
      acc = make_float4(__fadd_rn(acc.x, v.x), __fadd_rn(acc.y, v.y),
                        __fadd_rn(acc.z, v.z), __fadd_rn(acc.w, v.w));
    }
    flash::store2(dab + e, acc.x, acc.y);
    flash::store2(dab + e + 2, acc.z, acc.w);
  }
}

// -- tf32: the f32 passes, and bf16's above hd 256 ---------------------------

constexpr int kTfThreads = 128;  // one warpgroup
constexpr int kRowKeys = 32;     // keys a row-pass tile
constexpr int kColQueries = 32;  // queries a column-pass tile
constexpr int kChunkBlocks = 2;  // head blocks (64 columns) a score chunk
constexpr int kRowOut = 2;       // dQ blocks (64 columns) a row-pass CTA
constexpr int kColOut = 2;       // dK and dV blocks (64 columns) a column CTA

struct TfArgs {
  const void *q, *k, *v, *dout, *ab;  // T; q, k, v, dout rows ld apart
  const int *q_seg, *kv_seg;
  const float* stats;  // each row's (m, 1 / l, di, -)
  void *dq, *dk, *dv, *dab;  // T, rows hd apart
  float *dab_part, *dq_part;
  int b, s, nh, hd, ld, nblk, cb, group, kc, krows, orows, vec, chunk;
  float scale;
};

// The row pass's shared memory (rows_tf32): the q and dO planes (64 rows,
// cb blocks), a key tile's K and V planes (kRowKeys rows, cb blocks), its
// K^T planes (krows rows, one block of keys), hi then lo each; then the
// [64][kc] f32 tile of the bias's gradient.
inline int tf_row_bytes(int cb, int krows, int kc, bool bias) {
  return 1024 + 2 * (2 * 64 * 128 * cb + 2 * kRowKeys * 128 * cb +
                     krows * 128) +
         (bias ? 64 * kc * 4 : 0);
}

// The column pass's (cols_tf32): the CTA's K and V planes (64 rows, cb
// blocks), a query tile's Q and dO planes (kColQueries rows, cb blocks)
// and its Q^T and dO^T planes (orows rows, one block of queries).
inline int tf_col_bytes(int cb, int orows) {
  return 1024 + 2 * (2 * 64 * 128 * cb + 2 * kColQueries * 128 * cb +
                     2 * orows * 128);
}

// The bytes of rows_pair's and cols_pair's raw tile at nb blocks (two
// operands' 32 rows).
inline int pair_raw_bytes(int nb) { return 2 * 32 * ftf::raw_ld(nb) * 4; }

// One head chunk of both passes' score products: sc += a b^T and dp += c
// d^T over nk k8 steps of the planes (a, c: 64 rows from row a0 of planes
// of ar rows; b, d: br rows), into the totals directly where the head is
// one chunk, else each in a fresh accumulator added to its total
// (ftf::add_acc: over hundreds of columns the tensor cores' truncating sums
// drift past 1e-5).
template <bool kSplit, int NT>
__device__ __forceinline__ void chunk_products(
    float (&sc)[NT][4], float (&dp)[NT][4], const unsigned char* ah,
    const unsigned char* al, const unsigned char* bh, const unsigned char* bl,
    const unsigned char* ch, const unsigned char* cl, const unsigned char* dh,
    const unsigned char* dl, int br, int nk, bool fresh, int ar = 64,
    int a0 = 0) {
  if (!fresh) {
    fwg::fence_acc(sc);
    fwg::fence_acc(dp);
    fwg::wgmma_fence();
    ftf::mma_planes<kSplit>(sc, ah, al, bh, bl, br, nk, ar, a0);
    ftf::mma_planes<kSplit>(dp, ch, cl, dh, dl, br, nk, ar, a0);
    fwg::wgmma_commit();
    fwg::wgmma_wait();
    fwg::fence_acc(sc);
    fwg::fence_acc(dp);
    return;
  }
  float ps[NT][4], pd[NT][4];
  fwg::zero_acc(ps);
  fwg::zero_acc(pd);
  fwg::fence_acc(ps);
  fwg::fence_acc(pd);
  fwg::wgmma_fence();
  ftf::mma_planes<kSplit>(ps, ah, al, bh, bl, br, nk, ar, a0);
  ftf::mma_planes<kSplit>(pd, ch, cl, dh, dl, br, nk, ar, a0);
  fwg::wgmma_commit();
  fwg::wgmma_wait();
  fwg::fence_acc(ps);
  fwg::fence_acc(pd);
  ftf::add_acc(sc, ps);
  ftf::add_acc(dp, pd);
}

// The row pass (dQ, dS and the bias's gradient) above hd 64 in f32 and
// above 256 in bf16 (at hd <= 64 in f32: rows_pair): K, V and (above one
// chunk) q and dO loaded and split straight from global memory for each
// chunk of each tile.
template <typename T>
__global__ void __launch_bounds__(kTfThreads) rows_tf32(const TfArgs a) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int NT = kRowKeys / 8;
  extern __shared__ unsigned char smem_raw[];
  const int qp = 64 * 128 * a.cb, kp = kRowKeys * 128 * a.cb,
            tp = a.krows * 128;
  unsigned char* qh = align1024(smem_raw);
  unsigned char* ql = qh + qp;
  unsigned char* doh = ql + qp;
  unsigned char* dol = doh + qp;
  unsigned char* kh = dol + qp;
  unsigned char* kl = kh + kp;
  unsigned char* vh = kl + kp;
  unsigned char* vl = vh + kp;
  unsigned char* kth = vl + kp;
  unsigned char* ktl = kth + tp;
  float* dab = reinterpret_cast<float*>(ktl + tp);

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int s = a.s, hd = a.hd, ld = a.ld, nh = a.nh, head = blockIdx.y;
  const int slices = (a.nblk + kRowOut - 1) / kRowOut;
  const int splits = (s + a.kc - 1) / a.kc;
  const int split = blockIdx.x % splits, kc0 = split * a.kc;
  const int slice = blockIdx.x / splits % slices;
  const int col0 = slice * kRowOut * ftf::kBlk;
  const int ob = min(kRowOut, a.nblk - slice * kRowOut);
  const int q0 = blockIdx.x / (splits * slices) * 64;
  const int b0 = blockIdx.z * a.group, b1 = min(a.b, b0 + a.group);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows of the block: r0, r0 + 8
  const int hchunks = (a.nblk + a.cb - 1) / a.cb;
  const int width = a.nblk * ftf::kBlk;  // dq_part's row
  const int tiles = min(a.kc, s - kc0) / kRowKeys;
  const bool own_bias = a.dab != nullptr && slice == 0, vec = a.vec != 0;
  const T* abr =  // the bias's row r0 of the block
      static_cast<const T*>(a.ab) + ((long long)head * s + q0 + r0) * s;

  if (own_bias)
    for (int j = 0; j < tiles; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *dab_at(dab, a.kc, r0 + 8 * h, kRowKeys * j + 8 * n + 2 * t) =
              make_float2(0.f, 0.f);
  for (int bb = b0; bb < b1; ++bb) {
    const long long bh = (long long)bb * nh + head;
    const long long base = bh * s * ld;
    float m[2], inv_l[2], di[2];
    int qsg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = bh * s + q0 + r0 + 8 * h;
      const float4 st = *reinterpret_cast<const float4*>(a.stats + row * 4);
      m[h] = st.x;
      inv_l[h] = st.y;
      di[h] = st.z;
      qsg[h] = a.q_seg[(long long)bb * s + q0 + r0 + 8 * h];
    }
    float dq[kRowOut][4][4];
    ftf::zero_out(dq);
    for (int j = 0; j < tiles; ++j) {
      const int kb = kc0 + j * kRowKeys;
      float sc[NT][4], dp[NT][4];
      fwg::zero_acc(sc);
      fwg::zero_acc(dp);
      for (int hc = 0; hc < hchunks; ++hc) {
        const int c0 = hc * a.cb * ftf::kBlk;
        const int nb = min(a.cb, a.nblk - hc * a.cb);
        __syncthreads();  // every warp is done with the planes
        if (hchunks > 1 || j == 0) {  // this batch row's q and dO
          ftf::stage_plane<T, kSplit, 64>(qh, ql, q + base + q0 * ld + c0,
                                          ld, hd - c0, a.cb, vec, tid,
                                          kTfThreads);
          ftf::stage_plane<T, kSplit, 64>(doh, dol,
                                          dout + base + q0 * ld + c0, ld,
                                          hd - c0, a.cb, vec, tid,
                                          kTfThreads);
        }
        ftf::stage_plane<T, kSplit, kRowKeys>(
            kh, kl, k + base + (long long)kb * ld + c0, ld, hd - c0, a.cb,
            vec, tid, kTfThreads);
        ftf::stage_plane<T, kSplit, kRowKeys>(
            vh, vl, v + base + (long long)kb * ld + c0, ld, hd - c0, a.cb,
            vec, tid, kTfThreads);
        if (hc + 1 == hchunks)
          ftf::stage_trans<T, kSplit, kRowKeys>(
              kth, ktl, k + base + (long long)kb * ld + col0, ld, hd - col0,
              ob * ftf::kBlk, a.krows, tid, kTfThreads);
        fwg::fence_proxy_async();
        __syncthreads();
        chunk_products<kSplit>(sc, dp, qh, ql, kh, kl, doh, dol, vh, vl,
                               kRowKeys, 4 * nb, hchunks > 1);
      }

      // dS (rounded to T once), into the bias's gradient and dQ's A; the
      // bias and the keys' segment ids loaded first (the tile of dab is
      // written between them otherwise)
      float2 bv[NT][2];
      int2 ks[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * n + 2 * t;
        ks[n] = *reinterpret_cast<const int2*>(a.kv_seg + (long long)bb * s +
                                               kb + col);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bv[n][h] = flash::load2(abr + (long long)(8 * h) * s + kb + col);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * n + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d0 = ftf::round_as<T>(
              ds_of(sc[n][2 * h], bv[n][h].x, qsg[h] == ks[n].x, dp[n][2 * h],
                    m[h], inv_l[h], di[h], a.scale));
          const float d1 = ftf::round_as<T>(
              ds_of(sc[n][2 * h + 1], bv[n][h].y, qsg[h] == ks[n].y,
                    dp[n][2 * h + 1], m[h], inv_l[h], di[h], a.scale));
          sc[n][2 * h] = d0;
          sc[n][2 * h + 1] = d1;
          if (own_bias) {
            float2* acc = dab_at(dab, a.kc, r0 + 8 * h, kb - kc0 + col);
            const float2 x = *acc;
            *acc = make_float2(__fadd_rn(x.x, d0), __fadd_rn(x.y, d1));
          }
        }
      }
      uint32_t dh[NT][4], dl[NT][4];
      ftf::frag_a<kSplit>(dh, dl, sc);
      float part[kRowOut][4][4];  // this tile's dS K (ftf::add_out)
      ftf::zero_out(part);
      ftf::fence_out(part);
      fwg::wgmma_fence();
      ftf::mma_frags<kSplit>(part, dh, dl, kth, ktl, a.krows, ob);
      fwg::wgmma_commit();
      fwg::wgmma_wait();
      ftf::fence_out(part);
      ftf::add_out(dq, part, ob);
    }
    // dQ of this split's keys: dQ itself, or its part (dq_sum)
    float* part_rows =
        splits > 1 ? a.dq_part + split * a.b * nh * (long long)s * width
                   : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = bh * s + q0 + r0 + 8 * h;
#pragma unroll
      for (int nb = 0; nb < kRowOut; ++nb)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = col0 + 32 * nb + 8 * n + 2 * t;
          if (nb >= ob) continue;
          if (part_rows == nullptr)
            ftf::store_pair(static_cast<T*>(a.dq) + row * hd, col, hd,
                            dq[nb][n][2 * h], dq[nb][n][2 * h + 1]);
          else
            *reinterpret_cast<float2*>(part_rows + row * width + col) =
                make_float2(dq[nb][n][2 * h], dq[nb][n][2 * h + 1]);
        }
    }
  }
  if (own_bias) {
    // the group's sum of this split's keys: to its partial, or to dab
    for (int j = 0; j < tiles; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = kRowKeys * j + 8 * n + 2 * t;
          const float2 x = *dab_at(dab, a.kc, r0 + 8 * h, col);
          const long long e =
              ((long long)head * s + q0 + r0 + 8 * h) * s + kc0 + col;
          if (a.dab_part != nullptr)
            *reinterpret_cast<float2*>(
                a.dab_part + (long long)blockIdx.z * nh * s * s + e) = x;
          else
            flash::store2(static_cast<T*>(a.dab) + e, x.x, x.y);
        }
  }
}

// The column pass (dK, dV) above hd 64 in f32 and above 256 in bf16 (at
// hd <= 64 in f32: cols_pair): Q and dO loaded and split straight from
// global memory, with K and V too above one chunk.
template <typename T>
__global__ void __launch_bounds__(kTfThreads) cols_tf32(const TfArgs a) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int NT = kColQueries / 8;
  extern __shared__ unsigned char smem_raw[];
  const int kp = 64 * 128 * a.cb, qp = kColQueries * 128 * a.cb,
            tp = a.orows * 128;
  unsigned char* kh = align1024(smem_raw);
  unsigned char* kl = kh + kp;
  unsigned char* vh = kl + kp;
  unsigned char* vl = vh + kp;
  unsigned char* qh = vl + kp;
  unsigned char* ql = qh + qp;
  unsigned char* doh = ql + qp;
  unsigned char* dol = doh + qp;
  unsigned char* qth = dol + qp;
  unsigned char* qtl = qth + tp;
  unsigned char* doth = qtl + tp;
  unsigned char* dotl = doth + tp;

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const T* ab = static_cast<const T*>(a.ab);
  const int s = a.s, hd = a.hd, ld = a.ld, nh = a.nh, head = blockIdx.y;
  const int bb = blockIdx.z;
  const int slices = (a.nblk + kColOut - 1) / kColOut;
  const int slice = blockIdx.x % slices, col0 = slice * kColOut * ftf::kBlk;
  const int ob = min(kColOut, a.nblk - slice * kColOut);
  const int k0 = blockIdx.x / slices * 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's keys of the block: r0, r0 + 8
  const long long bh = (long long)bb * nh + head;
  const long long base = bh * s * ld;
  const int hchunks = (a.nblk + a.cb - 1) / a.cb;
  const int tiles = s / kColQueries;
  const bool vec = a.vec != 0;
  const int kseg[2] = {a.kv_seg[(long long)bb * s + k0 + r0],
                       a.kv_seg[(long long)bb * s + k0 + r0 + 8]};
  const T* abk = ab + (long long)head * s * s + k0 + r0;  // column r0

  float dk[kColOut][4][4], dv[kColOut][4][4];
  ftf::zero_out(dk);
  ftf::zero_out(dv);
  for (int i = 0; i < tiles; ++i) {
    const int qb = i * kColQueries;
    float sc[NT][4], dp[NT][4];
    fwg::zero_acc(sc);
    fwg::zero_acc(dp);
    for (int hc = 0; hc < hchunks; ++hc) {
      const int c0 = hc * a.cb * ftf::kBlk;
      const int nb = min(a.cb, a.nblk - hc * a.cb);
      __syncthreads();  // every warp is done with the planes
      if (hchunks > 1 || i == 0) {  // the CTA's keys and values
        ftf::stage_plane<T, kSplit, 64>(kh, kl, k + base + k0 * ld + c0, ld,
                                        hd - c0, a.cb, vec, tid, kTfThreads);
        ftf::stage_plane<T, kSplit, 64>(vh, vl, v + base + k0 * ld + c0, ld,
                                        hd - c0, a.cb, vec, tid, kTfThreads);
      }
      ftf::stage_plane<T, kSplit, kColQueries>(
          qh, ql, q + base + (long long)qb * ld + c0, ld, hd - c0, a.cb, vec,
          tid, kTfThreads);
      ftf::stage_plane<T, kSplit, kColQueries>(
          doh, dol, dout + base + (long long)qb * ld + c0, ld, hd - c0, a.cb,
          vec, tid, kTfThreads);
      if (hc + 1 == hchunks) {
        ftf::stage_trans<T, kSplit, kColQueries>(
            qth, qtl, q + base + (long long)qb * ld + col0, ld, hd - col0,
            ob * ftf::kBlk, a.orows, tid, kTfThreads);
        ftf::stage_trans<T, kSplit, kColQueries>(
            doth, dotl, dout + base + (long long)qb * ld + col0, ld,
            hd - col0, ob * ftf::kBlk, a.orows, tid, kTfThreads);
      }
      fwg::fence_proxy_async();
      __syncthreads();
      chunk_products<kSplit>(sc, dp, kh, kl, qh, ql, vh, vl, doh, dol,
                             kColQueries, 4 * nb, hchunks > 1);
    }

    // p^T and dS^T (each rounded to T), dV's and dK's A
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int qc = qb + 8 * n + 2 * t;
      const float4 st[2] = {
          *reinterpret_cast<const float4*>(a.stats + (bh * s + qc) * 4),
          *reinterpret_cast<const float4*>(a.stats + (bh * s + qc + 1) * 4)};
      const int2 qsg =
          *reinterpret_cast<const int2*>(a.q_seg + (long long)bb * s + qc);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float abv =
              ftf::load1(abk + (long long)(qc + c) * s + 8 * h);
          const float p = __fmul_rn(
              expf(__fsub_rn(flash::score(sc[n][2 * h + c], abv,
                                          (c ? qsg.y : qsg.x) == kseg[h],
                                          a.scale),
                             st[c].x)),
              st[c].y);
          dp[n][2 * h + c] = ftf::round_as<T>(__fmul_rn(
              __fmul_rn(__fsub_rn(dp[n][2 * h + c], st[c].z), p), a.scale));
          sc[n][2 * h + c] = ftf::round_as<T>(p);
        }
    }
    // this tile's p^T dO, then its dS^T Q, each in a fresh accumulator
    // added to the total (ftf::add_out)
    uint32_t ah[NT][4], al[NT][4];
    float part[kColOut][4][4];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      ftf::frag_a<kSplit>(ah, al, w ? dp : sc);
      ftf::zero_out(part);
      ftf::fence_out(part);
      fwg::wgmma_fence();
      ftf::mma_frags<kSplit>(part, ah, al, w ? qth : doth, w ? qtl : dotl,
                             a.orows, ob);
      fwg::wgmma_commit();
      fwg::wgmma_wait();
      ftf::fence_out(part);
      ftf::add_out(w ? dk : dv, part, ob);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long key = bh * s + k0 + r0 + 8 * h;
#pragma unroll
    for (int nb = 0; nb < kColOut; ++nb)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = col0 + 32 * nb + 8 * n + 2 * t;
        if (nb >= ob) continue;
        ftf::store_pair(static_cast<T*>(a.dk) + key * hd, col, hd,
                        dk[nb][n][2 * h], dk[nb][n][2 * h + 1]);
        ftf::store_pair(static_cast<T*>(a.dv) + key * hd, col, hd,
                        dv[nb][n][2 * h], dv[nb][n][2 * h + 1]);
      }
  }
}

// The row pass at hd <= 64 in f32 (NB = hd / 32 blocks, one score chunk):
// one CTA per (128 query rows, head, batch group, key split), two
// warpgroups of 64 rows sharing each key tile's planes; each tile's K and
// V rows come by cp.async into a raw tile one tile ahead and both
// warpgroups split them there.  The group's f32 partial of the bias's
// gradient: at NB 1 a [128, kc] tile in shared memory, as rows_tf32's; at
// NB 2 (the tile would not fit beside the planes) in global memory, each
// thread adding its own elements batch row by batch row (no atomics, a
// fixed order either way).
template <int NB>
__global__ void __launch_bounds__(2 * kTfThreads, 1) rows_pair(const TfArgs a) {
  constexpr int NT = kRowKeys / 8, kPair = 2 * kTfThreads;
  constexpr bool kTile = NB == 1;  // the bias's partial in shared memory
  constexpr int qp = 128 * 128 * NB, kp = kRowKeys * 128 * NB;
  constexpr int tp = 32 * NB * 128;                      // a K^T plane
  constexpr int kRawTile = kRowKeys * ftf::raw_ld(NB);  // floats
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qh = align1024(smem_raw);  // [128 rows][NB blocks]
  unsigned char* ql = qh + qp;
  unsigned char* doh = ql + qp;
  unsigned char* dol = doh + qp;
  unsigned char* kh = dol + qp;
  unsigned char* kl = kh + kp;
  unsigned char* vh = kl + kp;
  unsigned char* vl = vh + kp;
  unsigned char* kth = vl + kp;
  unsigned char* ktl = kth + tp;
  float* raw = reinterpret_cast<float*>(ktl + tp);  // K rows, then V rows
  float* dab = raw + 2 * kRawTile;  // kTile: [128][kc] f32 (dab_at)

  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int s = a.s, hd = a.hd, nh = a.nh, head = blockIdx.y;
  const int splits = (s + a.kc - 1) / a.kc;
  const int split = blockIdx.x % splits, kc0 = split * a.kc;
  const int q0 = blockIdx.x / splits * 128;
  const bool bias = a.dab != nullptr;
  const int b0 = blockIdx.z * a.group, b1 = min(a.b, b0 + a.group);
  const int tiles = min(a.kc, s - kc0) / kRowKeys;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const int width = a.nblk * ftf::kBlk;     // dq_part's row
  const float* abr =  // the bias's row r0 of the block
      static_cast<const float*>(a.ab) + ((long long)head * s + q0 + r0) * s;
  // (NB 2) the group's partial of the bias's gradient at row r0, key kc0
  float* part_row = kTile || !bias
                        ? nullptr
                        : a.dab_part + (long long)blockIdx.z * nh * s * s +
                              ((long long)head * s + q0 + r0) * s + kc0;

  auto fetch = [&](int it) {  // tile it of (batch row, key tile)
    if (it < (b1 - b0) * tiles && wg == 0) {
      const int bb = b0 + it / tiles, kb = kc0 + it % tiles * kRowKeys;
      const long long rows = (((long long)bb * nh + head) * s + kb) * hd;
      ftf::copy_raw<kRowKeys, NB>(raw, k + rows, hd, hd, a.chunk, tid);
      ftf::copy_raw<kRowKeys, NB>(raw + kRawTile, v + rows, hd, hd, a.chunk,
                                  tid);
    }
    attn2::cp_async_commit();
  };
  // the raw tile's columns past hd stay zero: cp.async never writes them
  for (int i = tid; i < 2 * kRawTile / 4; i += kPair)
    reinterpret_cast<float4*>(raw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kTile && bias)
    for (int j = 0; j < tiles; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *dab_at(dab, a.kc, r0 + 8 * h, kRowKeys * j + 8 * n + 2 * t) =
              make_float2(0.f, 0.f);
  __syncthreads();
  fetch(0);

  int it = 0;
  for (int bb = b0; bb < b1; ++bb) {
    const long long bh = (long long)bb * nh + head;
    const long long base = bh * s * hd;
    float m[2], inv_l[2], di[2];
    int qsg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = bh * s + q0 + r0 + 8 * h;
      const float4 sr = *reinterpret_cast<const float4*>(a.stats + row * 4);
      m[h] = sr.x;
      inv_l[h] = sr.y;
      di[h] = sr.z;
      qsg[h] = a.q_seg[(long long)bb * s + q0 + r0 + 8 * h];
    }
    float dq[NB][4][4];
    ftf::zero_out(dq);
    for (int j = 0; j < tiles; ++j, ++it) {
      const int kb = kc0 + j * kRowKeys;
      attn2::cp_async_wait<0>();  // tile it's rows
      __syncthreads();            // every warp is done with the planes
      if (j == 0) {               // this batch row's q and dO
        ftf::stage_plane<float, true, 128>(
            qh, ql, static_cast<const float*>(a.q) + base + (long long)q0 * hd,
            hd, hd, NB, a.vec != 0, tid, kPair);
        ftf::stage_plane<float, true, 128>(
            doh, dol,
            static_cast<const float*>(a.dout) + base + (long long)q0 * hd, hd,
            hd, NB, a.vec != 0, tid, kPair);
      }
      ftf::split_plane<kRowKeys, NB>(kh, kl, raw, tid, kPair);
      ftf::split_plane<kRowKeys, NB>(vh, vl, raw + kRawTile, tid, kPair);
      ftf::split_trans<kRowKeys, NB>(kth, ktl, raw, tid, kPair);
      fwg::fence_proxy_async();
      __syncthreads();
      fetch(it + 1);  // the next tile's rows while this one's products run
      float sc[NT][4], dp[NT][4];
      fwg::zero_acc(sc);
      fwg::zero_acc(dp);
      fwg::fence_acc(sc);
      fwg::fence_acc(dp);
      fwg::wgmma_fence();
      ftf::mma_planes<true>(sc, qh, ql, kh, kl, kRowKeys, 4 * NB, 128,
                            64 * wg);
      ftf::mma_planes<true>(dp, doh, dol, vh, vl, kRowKeys, 4 * NB, 128,
                            64 * wg);
      fwg::wgmma_commit();
      // the bias's partial so far and the bias, loaded while they run
      float2 acc[NT][2], bv[NT][2];
      int2 ks[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * n + 2 * t;
        ks[n] = *reinterpret_cast<const int2*>(a.kv_seg + (long long)bb * s +
                                               kb + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bv[n][h] = flash::load2(abr + (long long)(8 * h) * s + kb + col);
          if (kTile)
            acc[n][h] = bias ? *dab_at(dab, a.kc, r0 + 8 * h,
                                       kRowKeys * j + col)
                             : make_float2(0.f, 0.f);
          else
            acc[n][h] = bb == b0 || part_row == nullptr
                            ? make_float2(0.f, 0.f)
                            : *reinterpret_cast<const float2*>(
                                  part_row + (long long)(8 * h) * s +
                                  j * kRowKeys + col);
        }
      }
      fwg::wgmma_wait();
      fwg::fence_acc(sc);
      fwg::fence_acc(dp);

      // dS, into the bias's partial and dQ's A
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * n + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d0 =
              ds_of(sc[n][2 * h], bv[n][h].x, qsg[h] == ks[n].x,
                    dp[n][2 * h], m[h], inv_l[h], di[h], a.scale);
          const float d1 =
              ds_of(sc[n][2 * h + 1], bv[n][h].y, qsg[h] == ks[n].y,
                    dp[n][2 * h + 1], m[h], inv_l[h], di[h], a.scale);
          sc[n][2 * h] = d0;
          sc[n][2 * h + 1] = d1;
          const float2 sum = make_float2(__fadd_rn(acc[n][h].x, d0),
                                         __fadd_rn(acc[n][h].y, d1));
          if (kTile && bias)
            *dab_at(dab, a.kc, r0 + 8 * h, kRowKeys * j + col) = sum;
          else if (part_row != nullptr)
            *reinterpret_cast<float2*>(part_row + (long long)(8 * h) * s +
                                       j * kRowKeys + col) = sum;
        }
      }
      uint32_t dh[NT][4], dl[NT][4];
      ftf::frag_a<true>(dh, dl, sc);
      float part[NB][4][4];  // this tile's dS K (ftf::add_out)
      ftf::zero_out(part);
      ftf::fence_out(part);
      fwg::wgmma_fence();
      ftf::mma_frags<true>(part, dh, dl, kth, ktl, 32 * NB, NB);
      fwg::wgmma_commit();
      fwg::wgmma_wait();
      ftf::fence_out(part);
      ftf::add_out(dq, part, NB);
    }
    // dQ of this split's keys: dQ itself, or its part (dq_sum)
    float* part_rows =
        splits > 1 ? a.dq_part + split * a.b * nh * (long long)s * width
                   : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = bh * s + q0 + r0 + 8 * h;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = 32 * nb + 8 * n + 2 * t;
          if (part_rows == nullptr)
            ftf::store_pair(static_cast<float*>(a.dq) + row * hd, col, hd,
                            dq[nb][n][2 * h], dq[nb][n][2 * h + 1]);
          else
            *reinterpret_cast<float2*>(part_rows + row * width + col) =
                make_float2(dq[nb][n][2 * h], dq[nb][n][2 * h + 1]);
        }
    }
  }
  if (kTile && bias) {
    // the group's sum of this split's keys: to its partial, or to dab
    for (int j = 0; j < tiles; ++j)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = kRowKeys * j + 8 * n + 2 * t;
          const float2 x = *dab_at(dab, a.kc, r0 + 8 * h, col);
          const long long e =
              ((long long)head * s + q0 + r0 + 8 * h) * s + kc0 + col;
          if (a.dab_part != nullptr)
            *reinterpret_cast<float2*>(
                a.dab_part + (long long)blockIdx.z * nh * s * s + e) = x;
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.dab) + e) = x;
        }
  }
}

// The column pass at hd <= 64 in f32 (NB = hd / 32 blocks, one score
// chunk): one CTA per (128 keys, head, batch row), two warpgroups of 64
// keys sharing each query tile's planes; each tile's Q and dO rows come by
// cp.async into a raw tile one tile ahead, and both warpgroups split them
// there, half the split a key it would cost one.
template <int NB>
__global__ void __launch_bounds__(2 * kTfThreads, 1) cols_pair(const TfArgs a) {
  constexpr int NT = kColQueries / 8, kPair = 2 * kTfThreads;
  constexpr int kp = 128 * 128 * NB, qp = kColQueries * 128 * NB;
  constexpr int tp = 32 * NB * 128;                         // a Q^T plane
  constexpr int kRawTile = kColQueries * ftf::raw_ld(NB);  // floats
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kh = align1024(smem_raw);  // [128 keys][NB blocks]
  unsigned char* kl = kh + kp;
  unsigned char* vh = kl + kp;
  unsigned char* vl = vh + kp;
  unsigned char* qh = vl + kp;
  unsigned char* ql = qh + qp;
  unsigned char* doh = ql + qp;
  unsigned char* dol = doh + qp;
  unsigned char* qth = dol + qp;
  unsigned char* qtl = qth + tp;
  unsigned char* doth = qtl + tp;
  unsigned char* dotl = doth + tp;
  float* raw = reinterpret_cast<float*>(dotl + tp);  // Q rows, then dO rows

  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  const int s = a.s, hd = a.hd, nh = a.nh, head = blockIdx.y, bb = blockIdx.z;
  const int k0 = blockIdx.x * 128;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + warp * 16 + g;  // this thread's keys: r0, r0 + 8
  const long long bh = (long long)bb * nh + head;
  const long long base = bh * s * hd;
  const int tiles = s / kColQueries;
  const int kseg[2] = {a.kv_seg[(long long)bb * s + k0 + r0],
                       a.kv_seg[(long long)bb * s + k0 + r0 + 8]};
  const float* abk = static_cast<const float*>(a.ab) +
                     (long long)head * s * s + k0 + r0;  // column r0

  auto fetch = [&](int i) {  // query tile i's Q and dO rows
    if (i < tiles && wg == 0) {
      const long long rows = base + (long long)i * kColQueries * hd;
      ftf::copy_raw<kColQueries, NB>(raw, q + rows, hd, hd, a.chunk, tid);
      ftf::copy_raw<kColQueries, NB>(raw + kRawTile, dout + rows, hd, hd,
                                     a.chunk, tid);
    }
    attn2::cp_async_commit();
  };
  // the raw tile's columns past hd stay zero: cp.async never writes them
  for (int i = tid; i < 2 * kRawTile / 4; i += kPair)
    reinterpret_cast<float4*>(raw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  ftf::stage_plane<float, true, 128>(
      kh, kl, static_cast<const float*>(a.k) + base + (long long)k0 * hd, hd,
      hd, NB, a.vec != 0, tid, kPair);
  ftf::stage_plane<float, true, 128>(
      vh, vl, static_cast<const float*>(a.v) + base + (long long)k0 * hd, hd,
      hd, NB, a.vec != 0, tid, kPair);
  fwg::fence_proxy_async();
  __syncthreads();
  fetch(0);

  float dk[NB][4][4], dv[NB][4][4];
  ftf::zero_out(dk);
  ftf::zero_out(dv);
  for (int i = 0; i < tiles; ++i) {
    const int qb = i * kColQueries;
    attn2::cp_async_wait<0>();  // tile i's rows
    __syncthreads();            // every warp is done with the planes
    ftf::split_plane<kColQueries, NB>(qh, ql, raw, tid, kPair);
    ftf::split_plane<kColQueries, NB>(doh, dol, raw + kRawTile, tid, kPair);
    ftf::split_trans<kColQueries, NB>(qth, qtl, raw, tid, kPair);
    ftf::split_trans<kColQueries, NB>(doth, dotl, raw + kRawTile, tid,
                                      kPair);
    fwg::fence_proxy_async();
    __syncthreads();
    fetch(i + 1);  // the next tile's rows while this one's products run
    float sc[NT][4], dp[NT][4];
    fwg::zero_acc(sc);
    fwg::zero_acc(dp);
    chunk_products<true>(sc, dp, kh, kl, qh, ql, vh, vl, doh, dol,
                         kColQueries, 4 * NB, false, 128, 64 * wg);

    // p^T and dS^T, dV's and dK's A
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int qc = qb + 8 * n + 2 * t;
      const float4 st[2] = {
          *reinterpret_cast<const float4*>(a.stats + (bh * s + qc) * 4),
          *reinterpret_cast<const float4*>(a.stats + (bh * s + qc + 1) * 4)};
      const int2 qsg =
          *reinterpret_cast<const int2*>(a.q_seg + (long long)bb * s + qc);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = __fmul_rn(
              expf(__fsub_rn(flash::score(sc[n][2 * h + c],
                                          abk[(long long)(qc + c) * s + 8 * h],
                                          (c ? qsg.y : qsg.x) == kseg[h],
                                          a.scale),
                             st[c].x)),
              st[c].y);
          dp[n][2 * h + c] = __fmul_rn(
              __fmul_rn(__fsub_rn(dp[n][2 * h + c], st[c].z), p), a.scale);
          sc[n][2 * h + c] = p;
        }
    }
    // this tile's p^T dO, then its dS^T Q, each in a fresh accumulator
    // added to the total (ftf::add_out)
    uint32_t ah[NT][4], al[NT][4];
    float part[NB][4][4];
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      ftf::frag_a<true>(ah, al, w ? dp : sc);
      ftf::zero_out(part);
      ftf::fence_out(part);
      fwg::wgmma_fence();
      ftf::mma_frags<true>(part, ah, al, w ? qth : doth, w ? qtl : dotl,
                           32 * NB, NB);
      fwg::wgmma_commit();
      fwg::wgmma_wait();
      ftf::fence_out(part);
      ftf::add_out(w ? dk : dv, part, NB);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long key = bh * s + k0 + r0 + 8 * h;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 32 * nb + 8 * n + 2 * t;
        ftf::store_pair(static_cast<float*>(a.dk) + key * hd, col, hd,
                        dk[nb][n][2 * h], dk[nb][n][2 * h + 1]);
        ftf::store_pair(static_cast<float*>(a.dv) + key * hd, col, hd,
                        dv[nb][n][2 * h], dv[nb][n][2 * h + 1]);
      }
  }
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// How the bf16 passes cut the work at (b, s, HDP): the row pass's batch
// groups, q buffers, stages and keys a chunk, the column pass's stages.
struct Plan {
  int groups, group, qbufs, row_ns, kc, col_ns;
  int chunks(int s) const { return (s + kc - 1) / kc; }
};

template <int HDP>
bool plan_for(int b, int s, bool bias, Plan* p) {
  using R = RowSmem<HDP>;
  using C = ColSmem<HDP>;
  const int most = smem_optin();
  p->groups = bias ? (b / kGroupRows > 1 ? b / kGroupRows : 1) : b;
  p->group = (b + p->groups - 1) / p->groups;
  // the row pass: every key in one chunk where the bias's tile fits
  // (chunks of 128 keys, so that each warpgroup takes as many tiles; the
  // same chunks without a bias gradient, so that dQ sums in the same
  // order), then a second q buffer (the next batch row's q and dO load
  // during this one's last tiles) and as many stages as fit (at least one
  // a warpgroup)
  const int ns_min = consumer_groups<HDP>();
  p->qbufs = 1;
  p->row_ns = ns_min;
  p->kc = s;
  while (p->kc > 128 && R::bytes(1, ns_min, p->kc, true) > most)
    p->kc -= 128;
  if (R::bytes(1, ns_min, p->kc, bias) > most) return false;
  if (R::bytes(2, ns_min, p->kc, bias) <= most) p->qbufs = 2;
  while (p->row_ns < kMaxStages &&
         R::bytes(p->qbufs, p->row_ns + 1, p->kc, bias) <= most)
    ++p->row_ns;
  // the column pass: as many stages as fit beside its other CTAs on the
  // multiprocessor (228 KB, 1 KB of it each CTA's own)
  p->col_ns = 0;
  for (int ns = kMaxStages; ns >= 1 && !p->col_ns; --ns)
    if (C::bytes(ns) <= most && C::kMinCtas * (C::bytes(ns) + 1024) <= 233472)
      p->col_ns = ns;
  return p->col_ns > 0;
}

// The workspace of a bf16 call: each row's (m, 1 / l, di, -), the
// groups' f32 partials of the bias's gradient (more than one group), dQ's
// f32 scratch (more than one key chunk); each part 256-byte aligned.
struct Workspace {
  long long stats, dab_part, dq_part, bytes;
};

__host__ long long align256(long long x) { return (x + 255) / 256 * 256; }

Workspace workspace_of(long long b, long long nh, long long s, int hdp,
                       const Plan& p, bool bias) {
  Workspace w{};
  long long at = align256(b * nh * s * 16);
  w.dab_part = w.dq_part = -1;
  if (bias && p.groups > 1) {
    w.dab_part = at;
    at += align256(p.groups * nh * s * s * 4);
  }
  if (p.chunks((int)s) > 1) {
    w.dq_part = at;
    at += align256(b * nh * s * hdp * 4);
  }
  w.bytes = at;
  return w;
}

template <int NW, typename Kernel>
cudaError_t launch_wg(Kernel kernel, int bytes, dim3 grid, const Maps& maps,
                      const WgArgs& a, cudaStream_t stream) {
  cudaError_t err = ring_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, wg_threads<NW>(), bytes, stream>>>(maps, a);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_bf16(WgArgs a, const void* q, const void* k,
                        const void* v, const void* dout, const void* ab,
                        int ld, unsigned char* work, cudaStream_t stream) {
  using TT = fwg::Tile<HDP, 64>;
  using C = ColSmem<HDP>;
  constexpr int HALVES = HDP / out_cols<HDP>();
  const bool bias = a.dab != nullptr;
  Plan p;
  if (!plan_for<HDP>(a.b, a.s, bias, &p)) return cudaErrorInvalidConfiguration;
  const Workspace w = workspace_of(a.b, a.nh, a.s, HDP, p, bias);
  a.stats = reinterpret_cast<float*>(work);
  a.dab_part =
      w.dab_part < 0 ? nullptr : reinterpret_cast<float*>(work + w.dab_part);
  a.dq_part =
      w.dq_part < 0 ? nullptr : reinterpret_cast<float*>(work + w.dq_part);
  a.group = p.group;
  a.kc = p.kc;
  a.qbufs = p.qbufs;

  const long long rows = (long long)a.b * a.nh * a.s;
  const long long ab_rows = (long long)a.nh * a.s;
  cudaError_t err = fwg::bind_context();
  if (err != cudaSuccess) return err;
  Maps rm, cm;
  bool ok = fwg::bf16_map(&rm.q, q, rows, ld, ld, 64, TT::SWE, TT::SW) &&
            fwg::bf16_map(&rm.dout, dout, rows, ld, ld, 64, TT::SWE, TT::SW) &&
            fwg::bf16_map(&rm.k, k, rows, ld, ld, 64, TT::SWE, TT::SW) &&
            fwg::bf16_map(&rm.v, v, rows, ld, ld, 64, TT::SWE, TT::SW) &&
            fwg::bf16_map(&rm.ab, ab, ab_rows, a.s, a.s, 64, 64, 128);
  cm = rm;
  ok = ok &&
       fwg::bf16_map(&cm.q, q, rows, ld, ld, C::QT, TT::SWE, TT::SW) &&
       fwg::bf16_map(&cm.dout, dout, rows, ld, ld, C::QT, TT::SWE, TT::SW) &&
       fwg::bf16_map(&cm.ab, ab, ab_rows, a.s, a.s, C::QT, 64, 128);
  if (!ok) return cudaErrorInvalidValue;

  row_stats<__nv_bfloat16><<<(int)(rows / 64), 256, 0, stream>>>(
      a.o, a.dout, a.m, a.l, a.stats, a.hd, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.ns = p.row_ns;
  const dim3 rgrid(a.s / 64 * HALVES, a.nh, (a.b + p.group - 1) / p.group);
  constexpr int NW = consumer_groups<HDP>();
  err = bias ? launch_wg<NW>(
                   rows_wgmma<HDP, true>,
                   RowSmem<HDP>::bytes(p.qbufs, p.row_ns, p.kc, true), rgrid,
                   rm, a, stream)
             : launch_wg<NW>(
                   rows_wgmma<HDP, false>,
                   RowSmem<HDP>::bytes(p.qbufs, p.row_ns, p.kc, false), rgrid,
                   rm, a, stream);
  if (err != cudaSuccess) return err;
  a.ns = p.col_ns;
  err = launch_wg<1>(cols_wgmma<HDP>, C::bytes(p.col_ns),
                     dim3(a.s / 64 * HALVES, a.nh, a.b), cm, a, stream);
  if (err != cudaSuccess || a.dab_part == nullptr) return err;
  const long long n = (long long)a.nh * a.s * a.s;
  const long long want = (n / 4 + 255) / 256;
  dab_sum<__nv_bfloat16>
      <<<(int)(want < 132 * 8 ? want : 132 * 8), 256, 0, stream>>>(
      a.dab_part, a.dab, p.groups, n);
  return cudaGetLastError();
}

// The widest operand row (ld) the bf16 passes' TMA tiles take; wider bf16
// rows go to the tf32 passes.
constexpr int kTmaMaxLd = 256;

// The operand width of row length ld: 32, 64, 128 or 256.
int hdp_of(int ld) {
  return ld <= 32 ? 32 : ld <= 64 ? 64 : ld <= 128 ? 128 : 256;
}

template <int HDP>
int occupancy_bf16(int s, int pass, int* bytes) {
  Plan p;
  if (!plan_for<HDP>(1, s, true, &p)) return -(int)cudaErrorInvalidValue;
  *bytes = pass ? ColSmem<HDP>::bytes(p.col_ns)
                : RowSmem<HDP>::bytes(p.qbufs, p.row_ns, p.kc, true);
  int ctas = 0;
  cudaError_t err = pass ? ring_smem(cols_wgmma<HDP>, *bytes)
                         : ring_smem(rows_wgmma<HDP, true>, *bytes);
  if (err == cudaSuccess)
    err = pass ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &ctas, cols_wgmma<HDP>, wg_threads<1>(), *bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &ctas, rows_wgmma<HDP, true>,
                     wg_threads<consumer_groups<HDP>()>(), *bytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

template <int HDP>
long long workspace_bf16(int b, int nh, int s, bool bias) {
  Plan p;
  if (!plan_for<HDP>(b, s, bias, &p)) return -1;
  return workspace_of(b, nh, s, HDP, p, bias).bytes;
}

// dq[row][c] = T(sum over the key splits, in order, of part[split][row][c])
// for c < hd (part's rows `width` apart), two columns a thread.
template <typename T>
__global__ void dq_sum(const float* __restrict__ part, T* __restrict__ dq,
                       int splits, long long rows, int width, int hd) {
  const long long n = rows * (width / 2), step = rows * width;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / (width / 2);
    const int col = (int)(i - row * (width / 2)) * 2;
    if (col >= hd) continue;
    float2 acc = *reinterpret_cast<const float2*>(part + row * width + col);
    for (int sp = 1; sp < splits; ++sp) {
      const float2 x = *reinterpret_cast<const float2*>(
          part + sp * step + row * width + col);
      acc = make_float2(__fadd_rn(acc.x, x.x), __fadd_rn(acc.y, x.y));
    }
    ftf::store_pair(dq + row * hd, col, hd, acc.x, acc.y);
  }
}

// How the tf32 passes cut the work at (b, nh, s, ld): head blocks, a
// score chunk's blocks, the K^T planes' rows (dQ's columns a CTA), the Q^T
// and dO^T planes' rows (dK's and dV's), the bias's batch groups, the row
// pass's keys a split (the CTAs of a row block's splits run at once, each
// writing its share of dQ to a part that dq_sum adds in order), and nb,
// the head blocks of rows_pair and cols_pair (f32 at hd <= 64; 0:
// rows_tf32 and cols_tf32).
struct TfPlan {
  int nblk, cb, krows, orows, groups, group, kc, nb;
  int splits(int s) const { return (s + kc - 1) / kc; }
  int row_bytes(bool bias) const {  // rows_pair up to hd 64
    return nb ? 1024 + 2 * (2 * 128 * 128 * nb + 2 * kRowKeys * 128 * nb +
                            32 * nb * 128) +
                    pair_raw_bytes(nb) +
                    (nb == 1 && bias ? 128 * kc * 4 : 0)  // its dab tile
              : tf_row_bytes(cb, krows, kc, bias);
  }
  int col_bytes() const {  // cols_pair up to hd 64
    return nb ? 1024 + 2 * (2 * 128 * 128 * nb + 2 * kColQueries * 128 * nb +
                            2 * 32 * nb * 128) +
                    pair_raw_bytes(nb)
              : tf_col_bytes(cb, orows);
  }
};

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n;
}

bool tf_plan(int b, int nh, int s, int ld, bool bf16, bool bias,
             TfPlan* p) {
  const int most = smem_optin();
  p->nblk = (ld + ftf::kBlk - 1) / ftf::kBlk;
  p->cb = p->nblk < kChunkBlocks ? p->nblk : kChunkBlocks;
  p->krows = (p->nblk < kRowOut ? p->nblk : kRowOut) * ftf::kBlk;
  p->orows = (p->nblk < kColOut ? p->nblk : kColOut) * ftf::kBlk;
  p->nb = !bf16 && p->nblk <= 2 ? p->nblk : 0;
  const int bias_groups = b / kGroupRows > 1 ? b / kGroupRows : 1;
  p->groups = bias ? bias_groups : b;
  p->group = (b + p->groups - 1) / p->groups;
  // keys a split: as many as the tile of the bias's gradient leaves room
  // for (rows_pair at NB 2 keeps it in global memory), and few enough that
  // the row pass's CTAs fill the card twice over; chosen as with a bias
  // gradient either way, so that dQ sums in one order
  int most_keys = s;
  while (p->nb != 2 && most_keys > kRowKeys) {
    p->kc = most_keys;
    if (p->row_bytes(true) <= most) break;
    most_keys -= kRowKeys;
  }
  const long long ctas = (long long)(s / (p->nb ? 128 : 64)) *
                         ((p->nblk + kRowOut - 1) / kRowOut) * nh * bias_groups;
  const long long want = 2LL * sm_count();
  const int splits = ctas >= want ? 1 : (int)((want + ctas - 1) / ctas);
  int kc = ((s + splits - 1) / splits + kRowKeys - 1) / kRowKeys * kRowKeys;
  p->kc = kc < most_keys ? kc : most_keys;
  return p->row_bytes(bias) <= most && p->col_bytes() <= most;
}

// The workspace of a tf32 call: each row's statistics, the groups' f32
// partials of the bias's gradient (more than one group, or rows_pair at NB
// 2), dQ's f32 parts (more than one key split; rows of nblk * 32); each
// part 256-byte aligned.
Workspace tf_workspace(long long b, long long nh, long long s,
                       const TfPlan& p, bool bias) {
  Workspace w{};
  long long at = align256(b * nh * s * 16);
  w.dab_part = w.dq_part = -1;
  if (bias && (p.groups > 1 || p.nb == 2)) {
    w.dab_part = at;
    at += align256(p.groups * nh * s * s * 4);
  }
  if (p.splits((int)s) > 1) {
    w.dq_part = at;
    at += align256(p.splits((int)s) * b * nh * s * p.nblk * ftf::kBlk * 4);
  }
  w.bytes = at;
  return w;
}

template <typename Kernel>
cudaError_t launch_tf(Kernel kernel, int bytes, dim3 grid, const TfArgs& a,
                      cudaStream_t stream, int threads = kTfThreads) {
  cudaError_t err = ring_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The row pass (and dq_sum over its key splits), then the column pass:
// rows_pair and cols_pair at NB head blocks, else rows_tf32 and
// cols_tf32.
template <typename T, int NB>
cudaError_t launch_passes(const TfArgs& a, const TfPlan& p, bool bias,
                          cudaStream_t stream) {
  const long long rows = (long long)a.b * a.nh * a.s;
  const int row_slices = (p.nblk + kRowOut - 1) / kRowOut;
  const int splits = p.splits(a.s);
  const dim3 rgrid(a.s / 64 * row_slices * splits, a.nh,
                   (a.b + p.group - 1) / p.group);
  cudaError_t err;
  if constexpr (NB > 0)
    err = launch_tf(rows_pair<NB>, p.row_bytes(bias),
                    dim3(a.s / 128 * splits, a.nh, rgrid.z), a, stream,
                    2 * kTfThreads);
  else
    err = launch_tf(rows_tf32<T>, p.row_bytes(bias), rgrid, a, stream);
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long n = rows * p.nblk * ftf::kBlk / 2;
    const long long blocks = (n + 255) / 256;
    dq_sum<T><<<(int)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                stream>>>(a.dq_part, static_cast<T*>(a.dq), splits, rows,
                          p.nblk * ftf::kBlk, a.hd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int col_slices = (p.nblk + kColOut - 1) / kColOut;
  if constexpr (NB > 0)
    return launch_tf(cols_pair<NB>, p.col_bytes(),
                     dim3(a.s / 128, a.nh, a.b), a, stream, 2 * kTfThreads);
  else
    return launch_tf(cols_tf32<T>, p.col_bytes(),
                     dim3(a.s / 64 * col_slices, a.nh, a.b), a, stream);
}

template <typename T>
cudaError_t launch_tf32(TfArgs a, const T* o, const T* dout_rows,
                        const float* m, const float* l, int stats_vec,
                        unsigned char* work, cudaStream_t stream) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const bool bias = a.dab != nullptr;
  TfPlan p;
  if (!tf_plan(a.b, a.nh, a.s, a.ld, kBf16, bias, &p))
    return cudaErrorInvalidConfiguration;
  const Workspace w = tf_workspace(a.b, a.nh, a.s, p, bias);
  float* stats = reinterpret_cast<float*>(work);
  a.stats = stats;
  a.dab_part =
      w.dab_part < 0 ? nullptr : reinterpret_cast<float*>(work + w.dab_part);
  a.dq_part =
      w.dq_part < 0 ? nullptr : reinterpret_cast<float*>(work + w.dq_part);
  a.nblk = p.nblk;
  a.cb = p.cb;
  a.krows = p.krows;
  a.orows = p.orows;
  a.group = p.group;
  a.kc = p.kc;

  const long long rows = (long long)a.b * a.nh * a.s;
  row_stats<T><<<(int)(rows / 64), 256, 0, stream>>>(o, dout_rows, m, l,
                                                     stats, a.hd, stats_vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kBf16) {
    err = launch_passes<T, 0>(a, p, bias, stream);
  } else {
    err = p.nb == 1   ? launch_passes<T, 1>(a, p, bias, stream)
          : p.nb == 2 ? launch_passes<T, 2>(a, p, bias, stream)
                      : launch_passes<T, 0>(a, p, bias, stream);
  }
  if (err != cudaSuccess || a.dab_part == nullptr) return err;
  const long long n = (long long)a.nh * a.s * a.s;
  const long long want = (n / 4 + 255) / 256;
  dab_sum<T><<<(int)(want < 132 * 8 ? want : 132 * 8), 256, 0, stream>>>(
      a.dab_part, static_cast<T*>(a.dab), p.groups, n);
  return cudaGetLastError();
}

template <typename Kernel>
int occupancy_kernel(Kernel kernel, int bytes, int threads = kTfThreads) {
  int ctas = 0;
  cudaError_t err = ring_smem(kernel, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        threads, bytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

template <typename T>
int occupancy_tf32(int ld, int s, int b, int nh, int pass, int* bytes) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  TfPlan p;
  if (!tf_plan(b, nh, s, ld, kBf16, true, &p))
    return -(int)cudaErrorInvalidValue;
  *bytes = pass ? p.col_bytes() : p.row_bytes(true);
  if constexpr (!kBf16) {
    if (p.nb == 1)
      return occupancy_kernel(pass ? cols_pair<1> : rows_pair<1>, *bytes,
                              2 * kTfThreads);
    if (p.nb == 2)
      return occupancy_kernel(pass ? cols_pair<2> : rows_pair<2>, *bytes,
                              2 * kTfThreads);
  }
  return pass ? occupancy_kernel(cols_tf32<T>, *bytes)
              : occupancy_kernel(rows_tf32<T>, *bytes);
}

}  // namespace

// The bytes of the workspace `work` that flash_attention_bwd takes at
// these sizes (ab_grad != 0: the bias needs a gradient; ld the row length
// of the operands), or -1 where no plan fits the card.
extern "C" long long flash_attention_bwd_workspace(int b, int nh, int s,
                                                   int ld, int bf16,
                                                   int ab_grad) {
  if (!bf16 || ld > kTmaMaxLd) {
    TfPlan p;
    if (!tf_plan(b, nh, s, ld, bf16, ab_grad, &p)) return -1;
    return tf_workspace(b, nh, s, p, ab_grad).bytes;
  }
  switch (hdp_of(ld)) {
    case 32: return workspace_bf16<32>(b, nh, s, ab_grad);
    case 64: return workspace_bf16<64>(b, nh, s, ab_grad);
    case 128: return workspace_bf16<128>(b, nh, s, ab_grad);
    default: return workspace_bf16<256>(b, nh, s, ab_grad);
  }
}

// q, k, v, dout: [b, nh, s, *] with rows ld elements apart (in bf16 ld a
// multiple of 8 >= hd, columns past hd zero, 16-byte aligned: up to 256
// the TMA operands; in f32 ld == hd); o, dout_rows: [b, nh, s, hd] (di's
// operands); dq, dk, dv: [b, nh, s, hd]; ab and dab: [nh, s, s]; all bf16
// when bf16 != 0, else f32.  q_seg, kv_seg: [b, s] int32; m, l: [b, nh, s]
// f32 (the forward's residuals); work: flash_attention_bwd_workspace's
// bytes, 256-byte aligned.  dab is null when the bias needs no gradient.
// ab, the segment ids and work 16-byte aligned.  Requires s % 128 == 0 and
// hd >= 1 (ops/flash_attention.py check_flash_shapes refuses what the
// stock kernel refuses).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* dout_rows, const void* ab, const void* q_seg,
    const void* kv_seg, const void* m, const void* l, void* dq, void* dk,
    void* dv, void* dab, void* work, int b, int nh, int s, int hd, int ld,
    int bf16, float scale, void* stream) {
  if (hd < 1 || s < 128 || s % 128 || b < 1 || nh < 1 || ld < hd ||
      (bf16 ? ld % 8 : ld != hd))
    return (int)cudaErrorInvalidValue;
  if (!flash::aligned16(ab) || !flash::aligned16(q_seg) ||
      !flash::aligned16(kv_seg) || !flash::aligned16(work))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<unsigned char*>(work);
  const uintptr_t ops = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(dout);
  // di's loads: 16 bytes where every row starts on 16 bytes
  const uintptr_t at = reinterpret_cast<uintptr_t>(o) |
                       reinterpret_cast<uintptr_t>(dout_rows);
  if (bf16 && ld <= kTmaMaxLd) {
    if (ops % 16) return (int)cudaErrorMisalignedAddress;
    WgArgs a{};
    a.o = static_cast<const __nv_bfloat16*>(o);
    a.dout = static_cast<const __nv_bfloat16*>(dout_rows);
    a.q_seg = static_cast<const int*>(q_seg);
    a.kv_seg = static_cast<const int*>(kv_seg);
    a.m = static_cast<const float*>(m);
    a.l = static_cast<const float*>(l);
    a.dq = static_cast<__nv_bfloat16*>(dq);
    a.dk = static_cast<__nv_bfloat16*>(dk);
    a.dv = static_cast<__nv_bfloat16*>(dv);
    a.dab = static_cast<__nv_bfloat16*>(dab);
    a.b = b;
    a.s = s;
    a.nh = nh;
    a.hd = hd;
    // else 4, 2 bytes
    a.vec = hd % 8 == 0 && at % 16 == 0 ? 8 : hd % 2 == 0 && at % 4 == 0 ? 2
                                                                         : 1;
    a.scale = scale;
    switch (hdp_of(ld)) {
      case 32: return (int)launch_bf16<32>(a, q, k, v, dout, ab, ld, ws, stm);
      case 64: return (int)launch_bf16<64>(a, q, k, v, dout, ab, ld, ws, stm);
      case 128:
        return (int)launch_bf16<128>(a, q, k, v, dout, ab, ld, ws, stm);
      default:
        return (int)launch_bf16<256>(a, q, k, v, dout, ab, ld, ws, stm);
    }
  }
  TfArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.ab = ab;
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dab = dab;
  a.b = b;
  a.s = s;
  a.nh = nh;
  a.hd = hd;
  a.ld = ld;
  // the planes' loads: 4 elements where every operand row starts aligned;
  // the raw tiles' copies (f32): 16, 8 or 4 bytes
  a.vec = ld % 4 == 0 && ops % (bf16 ? 8 : 16) == 0;
  const void* rows[] = {q, k, v, dout};
  a.chunk = flash::row_chunk(ld, bf16 ? 2 : 4, rows, 4);
  a.scale = scale;
  if (bf16) {
    const int vec = hd % 8 == 0 && at % 16 == 0 ? 8
                    : hd % 2 == 0 && at % 4 == 0 ? 2
                                                 : 1;
    return (int)launch_tf32<__nv_bfloat16>(
        a, static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout_rows),
        static_cast<const float*>(m), static_cast<const float*>(l), vec, ws,
        stm);
  }
  return (int)launch_tf32<float>(
      a, static_cast<const float*>(o), static_cast<const float*>(dout_rows),
      static_cast<const float*>(m), static_cast<const float*>(l),
      hd % 4 == 0 && at % 16 == 0 ? 4 : 1, ws, stm);
}

// CTAs a multiprocessor of the row pass (pass 0) or the column pass (pass
// 1) for head size hd (the bf16 row length ld rounds it up to 8) at
// sequence length s, batch b and nh heads (the row pass's tile of the
// bias's gradient grows with its keys: s in bf16, the plan's split in the
// tf32 passes) in bf16 (bf16 != 0) or f32, with a bias that needs a
// gradient (a negative CUDA error code on failure), and its dynamic
// shared memory in *bytes.
extern "C" int flash_attention_bwd_occupancy(int hd, int s, int b, int nh,
                                             int bf16, int pass,
                                             int* bytes) {
  *bytes = 0;
  if (hd < 1 || s < 128 || s % 128 || b < 1 || nh < 1)
    return -(int)cudaErrorInvalidValue;
  const int ld = bf16 ? (hd + 7) / 8 * 8 : hd;
  if (!bf16) return occupancy_tf32<float>(ld, s, b, nh, pass, bytes);
  if (ld > kTmaMaxLd)
    return occupancy_tf32<__nv_bfloat16>(ld, s, b, nh, pass, bytes);
  switch (hdp_of(ld)) {
    case 32: return occupancy_bf16<32>(s, pass, bytes);
    case 64: return occupancy_bf16<64>(s, pass, bytes);
    case 128: return occupancy_bf16<128>(s, pass, bytes);
    default: return occupancy_bf16<256>(s, pass, bytes);
  }
}

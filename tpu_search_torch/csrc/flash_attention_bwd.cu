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
//        ab's dtype, summed in f32, rounded once (the transpose of JAX's
//        broadcast of one [heads, S, S] bias to every batch row); the
//        segment ids get no gradient.
// dQ, dK, dV come out in T.  Head sizes 1 to 256 (flash::kFlashMaxHd).
//
// What bounds it on the H100: at B 128, S 384, H 768 (12 heads of 64,
// bf16) it reads q, k, v, o and dO and writes dQ, dK and dV (8 B S H 2 =
// 604 MB) plus ab and dab (7 MB): 0.18 ms at 3.35 TB/s.  Its five products
// of 2 B heads S^2 hd flops each (1.45e11) take 0.147 ms at 989 TFLOP/s
// bf16: bytes bound it.  Both designs below recompute s and dP in each of
// their two passes: seven products, not five, the price of having no
// atomics.
//
// bf16 (rows_wgmma, cols_wgmma, helpers in flash_wgmma.cuh): every product
// is a wgmma, every q, k, v and dO tile a TMA copy, and nothing of [B,
// heads, S, S] is written.  Each CTA is one or two consumer warpgroups and
// one producer warp whose one thread keeps a ring of TMA copies in flight,
// stage by stage on "full" and "empty" mbarriers.
//   0. stats: each row's (m, 1 / l, di), di from o and dO, for both
//      passes (row_stats, one launch).
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
//      to a [groups, heads, S, S] f32 partial (or, one group, to dab); the
//      groups are B / 16, so the partial is an eighth of the bytes of a
//      per-row bf16 dS.  Where the tile of every key does not fit beside
//      the ring (large S), the keys go in chunks, dQ carried between them
//      in an f32 scratch the CTA owns (the same chunks without a bias
//      gradient, so that dQ sums in one order either way).
//   2. columns (dK, dV): one CTA (one consumer warpgroup, two CTAs a
//      multiprocessor up to hd 64) per (64 keys, head, batch row): K and V
//      once, then per step of QT queries Q, dO, their (m, 1 / l, di), the
//      bias tile and the query segment ids: s^T = K Q^T, dP^T = V dO^T,
//      p^T and dS^T in registers, dV += T(p)^T dO and dK += T(dS)^T Q
//      (MN-major Q and dO).
//   3. where there is more than one group, dab = T(the groups' partials
//      summed in group order).
// Above hd 128 a CTA owns half of the output columns (out_cols), so two
// CTAs share each row block, each recomputing the scores.  Every sum runs
// in a fixed order and there are no atomics: two calls give the same bits.
//
// f32 (bwd_rows, bwd_cols): the first design, on the row / column scheme of
// attention_tc.cuh, every product 3xTF32 (three tf32 mma.sync at 495
// TFLOP/s each): tf32 wgmma takes both operands K-major, which dK and dV's
// products do not have.  The row pass writes each batch row's dS to a [B,
// heads, S, S] scratch that bias_grad_kernel sums over the batch in order.
//   1. rows: one CTA (4 warps x 16 rows) per (64 query rows, head, batch
//      row); q and dO rows staged once; K and V tiles, the bias tile and
//      the key segment ids through a two-stage cp.async ring; dS to the
//      scratch; dQ += dS K.
//   2. columns: one CTA per (64 keys, head, batch row): K and V staged
//      once; Q, dO, the rows' (m, 1 / l, di), the bias tile and the query
//      segment ids through the ring; dV += p^T dO and dK += dS^T Q.
//   3. bias: dab sums the scratch over b in order.

#include "flash_wgmma.cuh"

namespace {

using namespace tcattn;
using flash::out_cols;

// -- f32: the 3xTF32 mma.sync passes ------------------------------------------

using Ops = F32Ops;

// The row pass's shared memory: q and dO rows, then two ring stages.
template <int HDP>
__host__ __device__ constexpr int rows_bytes() {
  return 2 * kRows * (HDP + 8) * 4 + 2 * flash::RowSlot<float, HDP>::kBytes;
}

// One stage of the column pass's ring: Q and dO tiles of QT queries, the
// rows' (m, 1 / l, di, -), the bias tile of those queries x the CTA's 64
// keys ([query][key], rows LDB apart, read transposed) and the queries'
// segment ids; every part on a 16-byte boundary.
template <int HDP>
struct ColSlot {
  static constexpr int LD = HDP + 8, QT = flash::tile_rows<float, HDP>(),
                       LDB = kRows + 4;
  static constexpr int kTile = QT * LD * 4;
  static constexpr int kStats = 2 * kTile;  // byte offsets in the slot
  static constexpr int kBias = kStats + QT * 16;
  static constexpr int kSeg = kBias + QT * LDB * 4;
  static constexpr int kBytes = kSeg + QT * 4;
};

template <int HDP>
__host__ __device__ constexpr int cols_bytes() {
  return 2 * kRows * (HDP + 8) * 4 + 2 * ColSlot<HDP>::kBytes;
}

struct Args {
  const float *q, *k, *v, *o, *dout, *ab;
  const int *q_seg, *kv_seg;
  const float *m, *l;
  float *dq, *dk, *dv, *ds;
  float* stats;
  int s, nh, hd, chunk;
  float scale;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads) bwd_rows(Args a) {
  using L = flash::RowSlot<float, HDP>;
  constexpr int LD = L::LD, KT = L::KT, NT = KT / 8, OC = out_cols<HDP>(),
                HALVES = HDP / OC;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [64][LD] q rows
  float* dos = qs + kRows * LD;                // [64][LD] dO rows
  unsigned char* ring = reinterpret_cast<unsigned char*>(dos + kRows * LD);

  const int s = a.s, hd = a.hd;
  const int half = blockIdx.x % HALVES, col0 = half * OC;
  const int q0 = blockIdx.x / HALVES * kRows, head = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int q_a = q0 + r0 + g;  // this thread's rows: q_a, q_a + 8
  const long long bh = (long long)b * a.nh + head;
  const long long base = bh * s * hd;
  const float* kh = a.k + base;
  const float* vh = a.v + base;
  const float* abh = a.ab + (long long)head * s * s;
  const int* kvs = a.kv_seg + (long long)b * s;
  const int qs0 = a.q_seg[(long long)b * s + q_a];
  const int qs1 = a.q_seg[(long long)b * s + q_a + 8];

  if (hd != HDP) zero_smem(smem, rows_bytes<HDP>(), tid);
  stage_rows<float, kRows>(qs, LD, a.q + base + q0 * hd, hd, kRows, hd,
                           a.chunk, tid);
  stage_rows<float, kRows>(dos, LD, a.dout + base + q0 * hd, hd, kRows, hd,
                           a.chunk, tid);
  attn2::cp_async_commit();

  const int tiles = s / KT;
  auto slot = [&](int j) { return ring + (j & 1) * L::kBytes; };
  auto issue = [&](int j) {
    if (j < tiles)
      flash::stage_keys<float, HDP>(slot(j), kh, vh, abh, kvs, s, q0, j * KT,
                                    hd, a.chunk, tid);
    attn2::cp_async_commit();
  };
  issue(0);

  // di from o (global) and the staged dO, each row's 4 threads summing
  // every 4th column; then (m, 1 / l, di) for the column pass.
  attn2::cp_async_wait<1>();  // the q and dO rows have landed
  __syncthreads();
  const float* oh = a.o + base;
  float m[2], inv_l[2], di[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_a + 8 * h;
    float acc = 0.f;
    for (int c = t; c < hd; c += 4)
      acc = __fadd_rn(acc, __fmul_rn(oh[(long long)row * hd + c],
                                     dos[(r0 + g + 8 * h) * LD + c]));
    di[h] = quad_sum(acc);
    m[h] = a.m[bh * s + row];
    inv_l[h] = __fdiv_rn(1.f, a.l[bh * s + row]);
    if (t == 0 && half == 0)
      *reinterpret_cast<float4*>(a.stats + (bh * s + row) * 4) =
          make_float4(m[h], inv_l[h], di[h], 0.f);
  }

  float dq[OC / 8][4];
  zero(dq);
  float* ds_rows =
      a.ds == nullptr || half != 0 ? nullptr : a.ds + bh * s * s;
  for (int j = 0; j < tiles; ++j) {
    attn2::cp_async_wait<0>();
    __syncthreads();
    issue(j + 1);
    const unsigned char* sl = slot(j);
    const float* ks = reinterpret_cast<const float*>(sl);
    const int kb = j * KT;
    float sc[NT][4], dp[NT][4];
    rows_by_rows<Ops, HDP, NT>(sc, qs, ks, LD, r0, lane);
    rows_by_rows<Ops, HDP, NT>(dp, dos, ks + KT * LD, LD, r0, lane);
    flash::score_rows(sc, reinterpret_cast<const float*>(sl + L::kBias),
                      L::LDB, reinterpret_cast<const int*>(sl + L::kSeg),
                      r0 + g, t, qs0, qs1, a.scale);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p =
            __fmul_rn(expf(__fsub_rn(sc[n][e], m[h])), inv_l[h]);
        sc[n][e] =
            __fmul_rn(__fmul_rn(__fsub_rn(dp[n][e], di[h]), p), a.scale);
      }
    if (ds_rows != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* dst = ds_rows + (long long)(q_a + 8 * h) * s + kb;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          flash::store2(dst + 8 * n + 2 * t, sc[n][2 * h], sc[n][2 * h + 1]);
      }
    }
    mix<Ops, OC, NT, false>(dq, sc, ks + col0, LD, lane);
  }

  float* dqh = a.dq + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = q_a + 8 * h;
#pragma unroll
    for (int n = 0; n < OC / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + 8 * n + 2 * t + c;
        if (col < hd) dqh[row * hd + col] = dq[n][2 * h + c];
      }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads) bwd_cols(Args a) {
  using L = ColSlot<HDP>;
  constexpr int LD = L::LD, QT = L::QT, NT = QT / 8, OC = out_cols<HDP>(),
                HALVES = HDP / OC;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [64][LD] the CTA's keys
  float* vs = ks + kRows * LD;                 // [64][LD] their values
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kRows * LD);

  const int s = a.s, hd = a.hd;
  const int half = blockIdx.x % HALVES, col0 = half * OC;
  const int k0 = blockIdx.x / HALVES * kRows, head = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int k_a = k0 + r0 + g;  // this thread's keys: k_a, k_a + 8
  const long long bh = (long long)b * a.nh + head;
  const long long base = bh * s * hd;
  const float* qh = a.q + base;
  const float* doh = a.dout + base;
  const float* abh = a.ab + (long long)head * s * s + k0;
  const float* stats = a.stats + bh * s * 4;
  const int* qsg = a.q_seg + (long long)b * s;
  const int kseg[2] = {a.kv_seg[(long long)b * s + k_a],
                       a.kv_seg[(long long)b * s + k_a + 8]};

  if (hd != HDP) zero_smem(smem, cols_bytes<HDP>(), tid);
  stage_rows<float, kRows>(ks, LD, a.k + base + k0 * hd, hd, kRows, hd,
                           a.chunk, tid);
  stage_rows<float, kRows>(vs, LD, a.v + base + k0 * hd, hd, kRows, hd,
                           a.chunk, tid);
  attn2::cp_async_commit();

  const int tiles = s / QT;
  auto slot = [&](int j) { return ring + (j & 1) * L::kBytes; };
  auto issue = [&](int j) {
    if (j < tiles) {
      const int qb = j * QT;
      unsigned char* sl = slot(j);
      float* qsl = reinterpret_cast<float*>(sl);
      stage_rows<float, QT>(qsl, LD, qh + (long long)qb * hd, hd, QT, hd,
                            a.chunk, tid);
      stage_rows<float, QT>(qsl + QT * LD, LD, doh + (long long)qb * hd, hd,
                            QT, hd, a.chunk, tid);
      flash::stage_tile<float, QT, 4>(
          reinterpret_cast<float*>(sl + L::kStats), 4,
          stats + 4 * (long long)qb, 4, tid);
      flash::stage_tile<float, QT, kRows>(
          reinterpret_cast<float*>(sl + L::kBias), L::LDB,
          abh + (long long)qb * s, s, tid);
      flash::stage_ints<QT>(reinterpret_cast<int*>(sl + L::kSeg), qsg + qb,
                            tid);
    }
    attn2::cp_async_commit();
  };
  issue(0);

  float dk[OC / 8][4], dv[OC / 8][4];
  zero(dk);
  zero(dv);
  for (int j = 0; j < tiles; ++j) {
    attn2::cp_async_wait<0>();
    __syncthreads();
    issue(j + 1);
    const unsigned char* sl = slot(j);
    const float* qsl = reinterpret_cast<const float*>(sl);
    const float* dosl = qsl + QT * LD;
    const float* st = reinterpret_cast<const float*>(sl + L::kStats);
    float sc[NT][4], dp[NT][4];
    rows_by_rows<Ops, HDP, NT>(sc, ks, qsl, LD, r0, lane);
    rows_by_rows<Ops, HDP, NT>(dp, vs, dosl, LD, r0, lane);
    flash::score_cols(sc, reinterpret_cast<const float*>(sl + L::kBias),
                      L::LDB, reinterpret_cast<const int*>(sl + L::kSeg),
                      kseg, r0 + g, t, a.scale);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 r = *reinterpret_cast<const float4*>(
            st + 4 * (8 * n + 2 * t + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          const float p = __fmul_rn(expf(__fsub_rn(sc[n][e], r.x)), r.y);
          sc[n][e] = p;
          dp[n][e] = __fmul_rn(__fmul_rn(__fsub_rn(dp[n][e], r.z), p),
                               a.scale);
        }
      }
    mix<Ops, OC, NT, false>(dv, sc, dosl + col0, LD, lane);
    mix<Ops, OC, NT, false>(dk, dp, qsl + col0, LD, lane);
  }

  float* dkh = a.dk + base;
  float* dvh = a.dv + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long key = k_a + 8 * h;
#pragma unroll
    for (int n = 0; n < OC / 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + 8 * n + 2 * t + c;
        if (col < hd) {
          dkh[key * hd + col] = dk[n][2 * h + c];
          dvh[key * hd + col] = dv[n][2 * h + c];
        }
      }
  }
}

// dab[e] = sum over b, in order, of ds[b][e], a pair of adjacent elements
// a thread.
__global__ void bias_grad_kernel(const float* __restrict__ ds,
                                 float* __restrict__ dab, int b,
                                 long long n) {
  for (long long e = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       e < n; e += 2 * (long long)gridDim.x * blockDim.x) {
    float x = 0.f, y = 0.f;
    for (int bb = 0; bb < b; ++bb) {
      const float2 v = flash::load2(ds + (long long)bb * n + e);
      x = __fadd_rn(x, v.x);
      y = __fadd_rn(y, v.y);
    }
    flash::store2(dab + e, x, y);
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, int bytes, dim3 grid, const Args& a,
                       cudaStream_t stream) {
  cudaError_t err = ring_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_f32(const Args& a, int b, cudaStream_t stream) {
  const dim3 grid(a.s / kRows * (HDP / out_cols<HDP>()), a.nh, b);
  cudaError_t err =
      launch_one(bwd_rows<HDP>, rows_bytes<HDP>(), grid, a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(bwd_cols<HDP>, cols_bytes<HDP>(), grid, a, stream);
}

// Head sizes round up to 16, 32, 64, 128 or 256.
cudaError_t launch_f32_hd(const Args& a, int b, cudaStream_t stream) {
  if (a.hd <= 16) return launch_f32<16>(a, b, stream);
  if (a.hd <= 32) return launch_f32<32>(a, b, stream);
  if (a.hd <= 64) return launch_f32<64>(a, b, stream);
  if (a.hd <= 128) return launch_f32<128>(a, b, stream);
  return launch_f32<256>(a, b, stream);
}

template <int HDP>
int occupancy_f32(int pass, int* bytes) {
  *bytes = pass ? cols_bytes<HDP>() : rows_bytes<HDP>();
  int ctas = 0;
  cudaError_t err = pass ? ring_smem(bwd_cols<HDP>, *bytes)
                         : ring_smem(bwd_rows<HDP>, *bytes);
  if (err == cudaSuccess)
    err = pass ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &ctas, bwd_cols<HDP>, kThreads, *bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &ctas, bwd_rows<HDP>, kThreads, *bytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

int occupancy_f32_hd(int hd, int pass, int* bytes) {
  if (hd <= 16) return occupancy_f32<16>(pass, bytes);
  if (hd <= 32) return occupancy_f32<32>(pass, bytes);
  if (hd <= 64) return occupancy_f32<64>(pass, bytes);
  if (hd <= 128) return occupancy_f32<128>(pass, bytes);
  return occupancy_f32<256>(pass, bytes);
}

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

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

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

// Each row's (m, 1 / l, di, -) for both passes, a quad of threads a row
// (row_dot), 64 rows a block: one launch before them, so that no pass waits
// on o and dO.
__global__ void __launch_bounds__(256)
    row_stats(const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout,
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

// Store columns col, col + 1 of a bf16 row of hd elements (col even;
// pairs where hd is even).
__device__ __forceinline__ void store_cols(__nv_bfloat16* row, int col,
                                           int hd, float x, float y) {
  if ((hd & 1) == 0) {
    if (col < hd) flash::store2(row + col, x, y);
  } else {
    if (col < hd) row[col] = __float2bfloat16_rn(x);
    if (col + 1 < hd) row[col + 1] = __float2bfloat16_rn(y);
  }
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
            store_cols(a.dq + row * a.hd, col, a.hd, dq[n][2 * h],
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
      store_cols(a.dk + key * a.hd, col, a.hd, dk[n][2 * h], dk[n][2 * h + 1]);
      store_cols(a.dv + key * a.hd, col, a.hd, dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

// dab[e] = bf16(sum over the groups, in order, of part[g][e]), four
// elements a thread.
__global__ void dab_sum(const float* __restrict__ part,
                        __nv_bfloat16* __restrict__ dab, int groups,
                        long long n) {
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

  row_stats<<<(int)(rows / 64), 256, 0, stream>>>(a.o, a.dout, a.m, a.l,
                                                  a.stats, a.hd, a.vec);
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
  dab_sum<<<(int)(want < 132 * 8 ? want : 132 * 8), 256, 0, stream>>>(
      a.dab_part, a.dab, p.groups, n);
  return cudaGetLastError();
}

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

}  // namespace

// The bytes of the workspace `work` that flash_attention_bwd takes at
// these sizes (ab_grad != 0: the bias needs a gradient; ld the row length
// of the bf16 operands), or -1 where no plan fits the card.
extern "C" long long flash_attention_bwd_workspace(int b, int nh, int s,
                                                   int ld, int bf16,
                                                   int ab_grad) {
  if (!bf16) {
    const long long stats = align256((long long)b * nh * s * 16);
    return stats + (ab_grad ? (long long)b * nh * s * s * 4 : 0);
  }
  switch (hdp_of(ld)) {
    case 32: return workspace_bf16<32>(b, nh, s, ab_grad);
    case 64: return workspace_bf16<64>(b, nh, s, ab_grad);
    case 128: return workspace_bf16<128>(b, nh, s, ab_grad);
    default: return workspace_bf16<256>(b, nh, s, ab_grad);
  }
}

// q, k, v, dout: [b, nh, s, *] with rows ld elements apart (in bf16 ld a
// multiple of 8 >= hd, columns past hd zero, 16-byte aligned: the TMA
// operands; in f32 ld == hd); o, dout_rows: [b, nh, s, hd] (di's
// operands); dq, dk, dv: [b, nh, s, hd]; ab and dab: [nh, s, s]; all bf16
// when bf16 != 0, else f32.  q_seg, kv_seg: [b, s] int32; m, l: [b, nh, s]
// f32 (the forward's residuals); work: flash_attention_bwd_workspace's
// bytes, 256-byte aligned.  dab is null when the bias needs no gradient.
// ab, the segment ids and work 16-byte aligned.  Requires s % 128 == 0 and
// 1 <= hd <= 256.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o, const void* dout_rows, const void* ab, const void* q_seg,
    const void* kv_seg, const void* m, const void* l, void* dq, void* dk,
    void* dv, void* dab, void* work, int b, int nh, int s, int hd, int ld,
    int bf16, float scale, void* stream) {
  if (hd < 1 || hd > flash::kFlashMaxHd || s < 128 || s % 128 || b < 1 ||
      nh < 1 || ld < hd || (bf16 ? ld % 8 || ld > flash::kFlashMaxHd
                                 : ld != hd))
    return (int)cudaErrorInvalidValue;
  if (!flash::aligned16(ab) || !flash::aligned16(q_seg) ||
      !flash::aligned16(kv_seg) || !flash::aligned16(work))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  auto* ws = static_cast<unsigned char*>(work);
  if (bf16) {
    const void* ops[] = {q, k, v, dout};
    for (const void* p : ops)
      if (!flash::aligned16(p)) return (int)cudaErrorMisalignedAddress;
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
    // di's loads: 16 bytes where every row starts on 16 bytes, else 4, 2
    const uintptr_t at = reinterpret_cast<uintptr_t>(o) |
                         reinterpret_cast<uintptr_t>(dout_rows);
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
  const void* rows[] = {q, k, v, dout};
  float* stats = reinterpret_cast<float*>(ws);
  float* ds = dab == nullptr
                  ? nullptr
                  : reinterpret_cast<float*>(
                        ws + align256((long long)b * nh * s * 16));
  const Args a{static_cast<const float*>(q),    static_cast<const float*>(k),
               static_cast<const float*>(v),    static_cast<const float*>(o),
               static_cast<const float*>(dout), static_cast<const float*>(ab),
               static_cast<const int*>(q_seg),  static_cast<const int*>(kv_seg),
               static_cast<const float*>(m),    static_cast<const float*>(l),
               static_cast<float*>(dq),         static_cast<float*>(dk),
               static_cast<float*>(dv),         ds,
               stats,                           s,
               nh,                              hd,
               flash::row_chunk(hd, 4, rows, 4), scale};
  cudaError_t err = launch_f32_hd(a, b, stm);
  if (err != cudaSuccess || dab == nullptr) return (int)err;
  const long long n = (long long)nh * s * s;
  const long long want = (n / 2 + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  bias_grad_kernel<<<blocks, 256, 0, stm>>>(ds, static_cast<float*>(dab), b,
                                            n);
  return (int)cudaGetLastError();
}

// CTAs a multiprocessor of the row pass (pass 0) or the column pass (pass
// 1) for head size hd (the bf16 row length ld rounds it up to 8) at
// sequence length s (the bf16 row pass's tile of the bias's gradient
// grows with s) in bf16 (bf16 != 0) or f32, with a bias that needs a
// gradient (a negative CUDA error code on failure), and its dynamic
// shared memory in *bytes.
extern "C" int flash_attention_bwd_occupancy(int hd, int s, int bf16,
                                             int pass, int* bytes) {
  *bytes = 0;
  if (hd < 1 || hd > flash::kFlashMaxHd || s < 128 || s % 128)
    return -(int)cudaErrorInvalidValue;
  if (!bf16) return occupancy_f32_hd(hd, pass, bytes);
  switch (hdp_of((hd + 7) / 8 * 8)) {
    case 32: return occupancy_bf16<32>(s, pass, bytes);
    case 64: return occupancy_bf16<64>(s, pass, bytes);
    case 128: return occupancy_bf16<128>(s, pass, bytes);
    default: return occupancy_bf16<256>(s, pass, bytes);
  }
}

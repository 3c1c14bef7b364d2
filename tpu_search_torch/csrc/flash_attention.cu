// The stock flash attention of the JAX encoder's attention_impl="flash"
// mode, over [B, heads, S, hd].
//
// Replaces: jax.experimental.pallas.ops.tpu.flash_attention (kernel body
// _flash_attention_kernel_single_batch, and _single_step for S = 128) as
// tpu_search/models/mpnet.py calls it (:262-274, operands :409-417), with
// the default block sizes (128 queries, 128 keys).
//
// Contract (the stock kernel's, f32 unless said):
//   s  = (q k^T + f32(ab)) * sm_scale   -- the bias BEFORE the scale
//   s += q_seg == kv_seg ? 0 : -0.7 * FLT_MAX   (a pad query attends to
//        the pad keys: segment ids, not a key mask)
//   S == 128: p = exp(s - max) / sum, rounded to bf16, o = p V;
//   S > 128, per 128-key block in order: m' = max(m, max s); p = exp(s -
//        m'); l' = sum p + exp(m - m') * l; inv = l' == 0 ? 1 : 1 / l';
//        o = o * (exp(m - m') * l * inv) + (bf16(p) V) * inv;
//   out = bf16(o); where m_out and l_out are not null (the autograd
//   forward, ops/flash_attention.py FlashAttention), also each row's final
//   m and l (the one step's max and sum at S = 128), f32 [b, heads, s]:
//   the stock kernel's save_residuals, which its backward
//   (flash_attention_bwd.cu) reads.  Null off the grad path, where the
//   kernel writes nothing more.
// q, k, v, out and ab are bf16; ab is one [heads, S, S] tensor shared by
// the batch (JAX broadcasts the same values to [B, heads, S, S]); segment
// ids are [B, S] int32.  S % 128 == 0, as the stock kernel's block sizes
// require, and any hd >= 1 (where S > 128 a head size above 128 is a
// multiple of 128, ops/flash_attention.py checks).  Every rounding step
// is written out (__fadd_rn, __fmul_rn, __fdiv_rn), so nvcc's -fmad
// changes nothing.  The step stays 128 keys: m' sets the scale at which p
// rounds to bf16, so another step would be another function.
//
// What bounds it on the H100: at B 128, S 384, H 768 (12 heads of 64) it
// reads q, k, v and ab and writes out once: 4*B*S*H*2 + heads*S^2*2 bytes
// (306 MB, 0.091 ms at 3.35 TB/s) for 4*B*heads*S^2*hd flops (0.059 ms at
// 989 TFLOP/s): bytes bound it.  In practice the per-score work paces it
// (the f32 epilogue, an exp, the running max and sum).
//
// Design (helpers in attention_twopass.cuh): one CTA per (64-query block,
// head, batch row), one warpgroup of 4 warps x 16 query rows.  Per 128-key
// step, a two-stage cp.async ring brings the step's K rows (128-byte
// swizzled for wgmma), its V rows, the [64, 128] bf16 bias tile and the
// 128 key segment ids, issued one step ahead, one __syncthreads a step.
// q k^T is wgmma.mma_async m64n64k16 twice (q from registers, one per
// 64-key half); its accumulators are the m16n8 fragments the score
// epilogue, the quad reductions and the bf16 p of P V (mma.sync m16n8k16,
// V by ldmatrix.trans) work on, so every thread keeps its keys and the
// order of its share of the row sum.  Head columns are zero-padded to HDP,
// a multiple of 16, in shared memory (hd 26 -> 32); rows of hd % 8 == 0
// copy 16 bytes at a time, other even hd 4 bytes (TinyBERT's 52-byte
// rows), odd hd by plain stores into the same layout.  Shared memory is the
// ring alone, independent of S: 107,520 bytes at hd 64, 91,136 at hd 32
// and below 48 (two CTAs a multiprocessor).  Two query warpgroups a CTA
// sharing each K/V stage (half the K/V traffic a query, twice the bias
// tile, one CTA a multiprocessor) read 5-10 % slower at S 384 and 512 and
// were dropped.  Not yet done (later work): P V by wgmma, TMA, overlap of
// one step's q k^T with the previous step's softmax.
//
// Head sizes above 128 (flash_wide_kernel): q in registers (64 a thread
// at 256) beside the 128-key step's scores, the output and P V's sums
// would not fit.  So q waits in shared memory, both products are
// mma.sync from shared memory (attention_tc.cuh's Bf16Ops: rows_by_rows
// for q k^T, mix for P V), and each CTA owns 64 of the output's columns
// (kWideCols): 4 CTAs a row block at hd 256, each recomputing the scores.
// A step's K rows, the CTA's V columns, the bias tile and the key segment
// ids load by cp.async and wait, one buffer: 137,728 bytes of shared
// memory, one CTA a multiprocessor.  Above 256 columns q k^T loops over
// head chunks of 256, q and the step's K rows staged again for each chunk,
// and hd / 64 CTAs share a row block.  A correct kernel, not yet a fast
// one.

#include <float.h>

#include "attention_twopass.cuh"
#include "flash_tc.cuh"

namespace {

#define FLASH_HDPS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

constexpr int kBQ = 64;        // query rows per CTA: one warpgroup
constexpr int kBK = 128;       // keys per softmax step (the stock block_k)
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kRingStages = 2;
constexpr int kAbStride = kBK + 8;  // bf16 row stride of the bias tile
constexpr float kMask = (float)(-0.7 * (double)FLT_MAX);

// One ring stage: K (two 64-key halves, each NB blocks of [64 keys][128
// bytes] swizzled), V ([128][HDP + 8] bf16), the bias tile ([64][136]
// bf16) and the 128 key segment ids; stages start on 1024-byte
// boundaries, the swizzle's period.
template <int HDP>
struct Stage {
  static constexpr int kNB = (HDP + 63) / 64;
  static constexpr int kVS = HDP + 8;
  static constexpr size_t kK = (size_t)2 * kNB * 64 * 128;
  static constexpr size_t kV = (size_t)kBK * kVS * 2;
  static constexpr size_t kAb = (size_t)kBQ * kAbStride * 2;
  static constexpr size_t kSeg = (size_t)kBK * 4;
  static constexpr size_t kSlot = (kK + kV + kAb + kSeg + 1023) / 1024 * 1024;
  // + the slack that aligns the ring
  static constexpr size_t kBytes = kRingStages * kSlot + 1024;
};

// s[64 x 128] = q k^T for the warpgroup's rows: one m64n64k16 wgmma per 16
// head columns and 64-key half, waited for before return.
template <int HDP>
__device__ __forceinline__ void qk_step(float (&sc)[kBK / 8][4],
                                        const uint32_t qa[HDP / 16][4],
                                        const unsigned char* ksw) {
  constexpr int NB = (HDP + 63) / 64;
  auto& lo = *reinterpret_cast<float(*)[kBK / 16][4]>(&sc[0]);
  auto& hi = *reinterpret_cast<float(*)[kBK / 16][4]>(&sc[kBK / 16]);
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
  attn2::fence_scores(lo);
  attn2::fence_scores(hi);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)  // 32 bytes: 2 descriptor units
    attn2::wgmma_rs_m64n64k16(
        lo, qa[kk],
        attn2::sw128_desc(ksw + (kk >> 2) * (64 * 128)) + 2 * (kk & 3));
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    attn2::wgmma_rs_m64n64k16(
        hi, qa[kk],
        attn2::sw128_desc(ksw + (NB + (kk >> 2)) * (64 * 128)) +
            2 * (kk & 3));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  attn2::fence_scores(lo);
  attn2::fence_scores(hi);
}

template <int HDP, bool kVec16>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ ab,
             const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
             __nv_bfloat16* __restrict__ out, float* __restrict__ m_out,
             float* __restrict__ l_out, int s, int nh, int hd,
             float scale) {
  using St = Stage<HDP>;
  constexpr int NT = kBK / 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (attn2::smem_u32(smem_raw) & 1023)) & 1023);

  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;
  const size_t base = ((size_t)b * nh + head) * s * hd;
  const int row0 = q0 + wr + g;  // this thread's rows: row0 and row0 + 8
  const int seg0 = q_seg[(size_t)b * s + row0];
  const int seg1 = q_seg[(size_t)b * s + row0 + 8];
  const __nv_bfloat16* kh = k + base;
  const __nv_bfloat16* vh = v + base;
  const __nv_bfloat16* abh = ab + ((size_t)head * s + q0) * s;
  const int* kvs = kv_seg + (size_t)b * s;
  auto slot_of = [&](int j) { return ring + (j % kRingStages) * St::kSlot; };

  uint32_t qa[HDP / 16][4];
  if (hd == HDP) {
    attn2::load_q<HDP>(qa, q + base + (size_t)row0 * hd + tig * 2, hd);
  } else {
    // Zero the ring once: the padding columns stay zero for the run.
    for (int i = tid; i < (int)(kRingStages * St::kSlot / 16); i += kThreads)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    attn2::load_q_padded<HDP>(qa, q + base + (size_t)row0 * hd, hd, hd, tig);
  }

  // Step j's K, V, bias tile and key segment ids, one cp.async group
  // (empty past the last step).
  const int steps = s / kBK;
  auto issue = [&](int j) {
    if (j < steps) {
      unsigned char* slot = slot_of(j);
      const int kb = j * kBK;
      attn2::stage_rows<HDP, kBK, kThreads, kVec16>(
          slot, reinterpret_cast<__nv_bfloat16*>(slot + St::kK),
          kh + (size_t)kb * hd, vh + (size_t)kb * hd, hd, tid);
      auto* abs = reinterpret_cast<__nv_bfloat16*>(slot + St::kK + St::kV);
#pragma unroll
      for (int it = 0; it < kBQ * (kBK / 8) / kThreads; ++it) {
        const int i = tid + it * kThreads, r = i >> 4, c = (i & 15) * 8;
        attn2::cp_async16(abs + r * kAbStride + c, abh + (size_t)r * s + kb + c);
      }
      if (tid < kBK / 4)
        attn2::cp_async16(slot + St::kK + St::kV + St::kAb + tid * 16,
                          kvs + kb + tid * 4);
    }
    attn2::cp_async_commit();
  };
  issue(0);

  float o[HDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
  float m_prev[2] = {-INFINITY, -INFINITY}, l_prev[2] = {0.f, 0.f};
  const bool single = s == kBK;

  for (int j = 0; j < steps; ++j) {
    // step j has landed; every warp has left the stage step j + 1 reuses
    attn2::cp_async_wait<0>();
    attn2::fence_proxy_async();
    __syncthreads();
    issue(j + 1);
    const unsigned char* slot = slot_of(j);
    const auto* Vs = reinterpret_cast<const __nv_bfloat16*>(slot + St::kK);
    const auto* abs =
        reinterpret_cast<const __nv_bfloat16*>(slot + St::kK + St::kV);
    const int* segs =
        reinterpret_cast<const int*>(slot + St::kK + St::kV + St::kAb);

    // s = (q k^T + ab) * scale + segment mask, 64 rows x 128 keys.
    float sc[NT][4];
    qk_step<HDP>(sc, qa, slot);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = nt * 8 + tig * 2;
      const int2 ks = *reinterpret_cast<const int2*>(segs + key);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
            abs + (wr + g + half * 8) * kAbStride + key);
        const int qs = half ? seg1 : seg0;
        const float c0 = __fadd_rn(
            __fmul_rn(__fadd_rn(sc[nt][half * 2], __low2float(bv)), scale),
            qs == ks.x ? 0.f : kMask);
        const float c1 = __fadd_rn(
            __fmul_rn(__fadd_rn(sc[nt][half * 2 + 1], __high2float(bv)),
                      scale),
            qs == ks.y ? 0.f : kMask);
        sc[nt][half * 2] = c0;
        sc[nt][half * 2 + 1] = c1;
        mx[half] = fmaxf(mx[half], fmaxf(c0, c1));
      }
    }

    float m_next[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half)
      m_next[half] = fmaxf(m_prev[half], attn2::quad_max(mx[half]));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = expf(__fsub_rn(sc[nt][e], m_next[e >> 1]));
        sum[e >> 1] = __fadd_rn(sum[e >> 1], sc[nt][e]);
      }
    float corr[2], inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float total = attn2::quad_sum(sum[half]);
      if (single) {
        // The stock one-step kernel: p /= l before the bf16 rounding.
        corr[half] = 0.f;
        inv[half] = 1.f;
        m_prev[half] = m_next[half];
        l_prev[half] = total;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          sc[nt][half * 2] = __fdiv_rn(sc[nt][half * 2], total);
          sc[nt][half * 2 + 1] = __fdiv_rn(sc[nt][half * 2 + 1], total);
        }
      } else {
        const float l_corr =
            __fmul_rn(expf(__fsub_rn(m_prev[half], m_next[half])), l_prev[half]);
        const float l_next = __fadd_rn(total, l_corr);
        inv[half] = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
        corr[half] = __fmul_rn(l_corr, inv[half]);
        l_prev[half] = l_next;
        m_prev[half] = m_next[half];
      }
    }

    // o = o * corr + (bf16(p) V) * inv, P V over the two 64-key halves in
    // order; p's accumulator layout is the A fragment layout of m16n8k16.
    float oc[HDP / 8][4];
#pragma unroll
    for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[nt][e] = 0.f;
    attn2::pv_tile<HDP>(oc, sc, Vs, lane);
    attn2::pv_tile<HDP>(oc, sc + kBK / 16, Vs + 64 * St::kVS, lane);
#pragma unroll
    for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        o[nt][e] = __fadd_rn(__fmul_rn(o[nt][e], corr[half]),
                             __fmul_rn(oc[nt][e], inv[half]));
      }
  }

  if (m_out != nullptr && tig == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t row = ((size_t)b * nh + head) * s + row0 + half * 8;
      m_out[row] = m_prev[half];
      l_out[row] = l_prev[half];
    }
  }

  // Output columns past hd come from the zero padding: never written.
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = nt * 8 + tig * 2;
      __nv_bfloat16* dst = out + base + (size_t)(row0 + half * 8) * hd + col;
      const __nv_bfloat16 lo = __float2bfloat16_rn(o[nt][half * 2]);
      const __nv_bfloat16 hi = __float2bfloat16_rn(o[nt][half * 2 + 1]);
      if (hd == HDP) {
        __nv_bfloat162 pair;
        pair.x = lo;
        pair.y = hi;
        *reinterpret_cast<__nv_bfloat162*>(dst) = pair;
      } else {
        if (col < hd) dst[0] = lo;
        if (col + 1 < hd) dst[1] = hi;
      }
    }
  }
}

// The wide kernel's shared memory: q [64][kWideLd], the step's K rows
// [128][kWideLd], its V columns [128][kWideCols + 8], the bias tile and
// the key segment ids.
constexpr int kWideHdp = 256;
constexpr int kWideCols = 64;
constexpr int kWideLd = kWideHdp + 8;
constexpr int kWideLdv = kWideCols + 8;
constexpr int kWideK = kBQ * kWideLd;  // element offsets
constexpr int kWideV = kWideK + kBK * kWideLd;
constexpr int kWideAb = kWideV + kBK * kWideLdv;
constexpr int kWideSeg = kWideAb + kBQ * kAbStride;
constexpr int kWideBytes = kWideSeg * 2 + kBK * 4;

__global__ void __launch_bounds__(kThreads)
flash_wide_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ ab,
                  const int* __restrict__ q_seg,
                  const int* __restrict__ kv_seg,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int s,
                  int nh, int hd, int chunk, float scale) {
  using Ops = tcattn::Bf16Ops;
  using T = __nv_bfloat16;
  constexpr int NT = kBK / 8, OT = kWideCols / 8;
  extern __shared__ __align__(16) unsigned char smem_wide[];
  T* qs = reinterpret_cast<T*>(smem_wide);
  T* ks = qs + kWideK;
  T* vs = qs + kWideV;
  T* abs = qs + kWideAb;
  int* segs = reinterpret_cast<int*>(qs + kWideSeg);

  const int quarters = (hd + kWideCols - 1) / kWideCols;
  const int hchunks = (hd + kWideHdp - 1) / kWideHdp;  // of q k^T
  const int col0 = blockIdx.x % quarters * kWideCols;
  const int q0 = blockIdx.x / quarters * kBQ, head = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3, wr = warp * 16;
  const int row0 = q0 + wr + g;  // this thread's rows: row0 and row0 + 8
  const size_t base = ((size_t)b * nh + head) * s * hd;
  const int seg0 = q_seg[(size_t)b * s + row0];
  const int seg1 = q_seg[(size_t)b * s + row0 + 8];
  const int vcols = min(kWideCols, hd - col0);

  // the padding columns (past hd, past the quarter's) stay zero
  tcattn::zero_smem(smem_wide, kWideBytes, tid);
  if (hchunks == 1)
    tcattn::stage_rows<T, kBQ>(qs, kWideLd, q + base + (size_t)q0 * hd, hd,
                               kBQ, hd, chunk, tid);

  float o[OT][4];
  tcattn::zero(o);
  float m_prev[2] = {-INFINITY, -INFINITY}, l_prev[2] = {0.f, 0.f};
  const bool single = s == kBK;
  for (int j = 0; j < s / kBK; ++j) {
    const int kb = j * kBK;
    float sc[NT][4];
    tcattn::zero(sc);
    // q k^T over head chunks of kWideHdp columns: one above which q and
    // the step's K rows are staged again for each chunk (hd > 256)
    for (int hc = 0; hc < hchunks; ++hc) {
      const int c0 = hc * kWideHdp, w = min(kWideHdp, hd - c0);
      __syncthreads();  // every warp has left the previous tiles
      if (w < kWideHdp && hchunks > 1) {  // a narrower last chunk's tail
        for (int i = tid; i < (kBQ + kBK) * (kWideHdp - w); i += kThreads) {
          const int r = i / (kWideHdp - w), c = w + i % (kWideHdp - w);
          (r < kBQ ? qs + r * kWideLd : ks + (r - kBQ) * kWideLd)[c] =
              __float2bfloat16_rn(0.f);
        }
      }
      if (hchunks > 1)
        tcattn::stage_rows<T, kBQ>(qs, kWideLd,
                                   q + base + (size_t)q0 * hd + c0, hd, kBQ, w,
                                   chunk, tid);
      tcattn::stage_rows<T, kBK>(ks, kWideLd, k + base + (size_t)kb * hd + c0,
                                 hd, kBK, w, chunk, tid);
      if (hc == 0) {
        tcattn::stage_rows<T, kBK>(vs, kWideLdv,
                                   v + base + (size_t)kb * hd + col0, hd, kBK,
                                   vcols, chunk, tid);
        flash::stage_tile<T, kBQ, kBK>(
            abs, kAbStride, ab + ((size_t)head * s + q0) * s + kb, s, tid);
        flash::stage_ints<kBK>(segs, kv_seg + (size_t)b * s + kb, tid);
      }
      attn2::cp_async_commit();
      attn2::cp_async_wait<0>();
      __syncthreads();
      tcattn::rows_by_rows<Ops, kWideHdp, NT, false>(sc, qs, ks, kWideLd, wr,
                                                     lane);
    }
    flash::score_rows(sc, abs, kAbStride, segs, wr + g, tig, seg0, seg1,
                      scale);
    // the step's softmax, as flash_kernel's
    float corr[2], inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][half * 2], sc[nt][half * 2 + 1]));
      const float m_next = fmaxf(m_prev[half], attn2::quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[nt][half * 2 + e] = expf(__fsub_rn(sc[nt][half * 2 + e], m_next));
          sum = __fadd_rn(sum, sc[nt][half * 2 + e]);
        }
      const float total = attn2::quad_sum(sum);
      if (single) {
        corr[half] = 0.f;
        inv[half] = 1.f;
        l_prev[half] = total;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          sc[nt][half * 2] = __fdiv_rn(sc[nt][half * 2], total);
          sc[nt][half * 2 + 1] = __fdiv_rn(sc[nt][half * 2 + 1], total);
        }
      } else {
        const float l_corr =
            __fmul_rn(expf(__fsub_rn(m_prev[half], m_next)), l_prev[half]);
        const float l_next = __fadd_rn(total, l_corr);
        inv[half] = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
        corr[half] = __fmul_rn(l_corr, inv[half]);
        l_prev[half] = l_next;
      }
      m_prev[half] = m_next;
    }
    // o = o * corr + (bf16(p) V) * inv over the quarter's columns
    float oc[OT][4];
    tcattn::zero(oc);
    tcattn::mix<Ops, kWideCols, NT, false>(oc, sc, vs, kWideLdv, lane);
#pragma unroll
    for (int nt = 0; nt < OT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[nt][e] = __fadd_rn(__fmul_rn(o[nt][e], corr[e >> 1]),
                             __fmul_rn(oc[nt][e], inv[e >> 1]));
  }

  if (m_out != nullptr && col0 == 0 && tig == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t row = ((size_t)b * nh + head) * s + row0 + half * 8;
      m_out[row] = m_prev[half];
      l_out[row] = l_prev[half];
    }
  }
#pragma unroll
  for (int nt = 0; nt < OT; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col0 + nt * 8 + tig * 2;
      __nv_bfloat16* dst = out + base + (size_t)(row0 + half * 8) * hd + col;
      if (col < hd) dst[0] = __float2bfloat16_rn(o[nt][half * 2]);
      if (col + 1 < hd) dst[1] = __float2bfloat16_rn(o[nt][half * 2 + 1]);
    }
}

cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        const void* ab, const int* q_seg, const int* kv_seg,
                        void* out, float* m_out, float* l_out, int b, int nh,
                        int s, int hd, float scale, cudaStream_t stream) {
  const void* rows[] = {q, k, v};
  const int chunk = flash::row_chunk(hd, 2, rows, 3);
  cudaError_t err = tcattn::ring_smem(flash_wide_kernel, kWideBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(s / kBQ * ((hd + kWideCols - 1) / kWideCols), nh, b);
  flash_wide_kernel<<<grid, kThreads, kWideBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(ab), q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(out), m_out, l_out, s, nh, hd, chunk,
      scale);
  return cudaGetLastError();
}

int occupancy_wide(int* bytes) {
  *bytes = kWideBytes;
  int ctas = 0;
  cudaError_t err = tcattn::ring_smem(flash_wide_kernel, kWideBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, flash_wide_kernel, kThreads, kWideBytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

template <int HDP, bool kVec16>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ab, const int* q_seg, const int* kv_seg,
                   void* out, float* m_out, float* l_out, int b, int nh,
                   int s, int hd, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Stage<HDP>::kBytes;
  auto kernel = flash_kernel<HDP, kVec16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kBQ, nh, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(ab), q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(out), m_out, l_out, s, nh, hd, scale);
  return cudaGetLastError();
}

// The kernel for head size hd (16-byte row copies where hd % 8 == 0).
template <int HDP>
cudaError_t launch_hdp(const void* q, const void* k, const void* v,
                       const void* ab, const int* q_seg, const int* kv_seg,
                       void* out, float* m_out, float* l_out, int b, int nh,
                       int s, int hd, float scale, cudaStream_t stream) {
  if (hd % 8 == 0)
    return launch<HDP, true>(q, k, v, ab, q_seg, kv_seg, out, m_out, l_out,
                             b, nh, s, hd, scale, stream);
  return launch<HDP, false>(q, k, v, ab, q_seg, kv_seg, out, m_out, l_out,
                            b, nh, s, hd, scale, stream);
}

// CTAs a multiprocessor of the kernel for head size hd, and its dynamic
// shared memory in *bytes.
template <int HDP>
int occupancy_hdp(int hd, int* bytes) {
  *bytes = (int)Stage<HDP>::kBytes;
  int ctas = 0;
  auto kernel = hd % 8 == 0 ? flash_kernel<HDP, true> : flash_kernel<HDP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kThreads, *bytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

}  // namespace

// q, k, v, out: [b, nh, s, hd] bf16; ab: [nh, s, s] bf16 (16-byte
// aligned); q_seg, kv_seg: [b, s] int32 (16-byte aligned above hd 128);
// m_out, l_out: [b, nh, s] f32, both null or neither.  Requires s % 128 ==
// 0 and hd >= 1 (ops/flash_attention.py check_flash_shapes refuses what the
// stock kernel refuses).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* ab, const void* q_seg,
                               const void* kv_seg, void* out, void* m_out,
                               void* l_out, int b, int nh, int s, int hd,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || s < kBK || s % kBK ||
      (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  if (hd > 128) {
    if (!flash::aligned16(ab) || !flash::aligned16(kv_seg))
      return (int)cudaErrorMisalignedAddress;
    return (int)launch_wide(q, k, v, ab, qs, ks, out, mo, lo, b, nh, s, hd,
                            scale, st);
  }
#define FLASH_CASE(HDP)                                                    \
  case HDP / 16:                                                           \
    return (int)launch_hdp<HDP>(q, k, v, ab, qs, ks, out, mo, lo, b, nh, s, \
                                hd, scale, st);
  switch ((hd + 15) / 16) {
    FLASH_HDPS(FLASH_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

// CTAs a multiprocessor of the kernel for head size hd (a negative CUDA
// error code on failure), and its dynamic shared memory in *bytes; neither
// depends on s.
extern "C" int flash_attention_occupancy(int hd, int* bytes) {
  *bytes = 0;
  if (hd > 128) return occupancy_wide(bytes);
#define FLASH_OCC(HDP) \
  case HDP / 16:       \
    return occupancy_hdp<HDP>(hd, bytes);
  switch ((hd + 15) / 16) {
    FLASH_HDPS(FLASH_OCC)
    default:
      return -(int)cudaErrorInvalidValue;
  }
#undef FLASH_OCC
}

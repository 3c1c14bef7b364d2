// The stock flash attention of the JAX encoder's attention_impl="flash"
// mode in f32, over [B, heads, S, hd].
//
// Replaces: jax.experimental.pallas.ops.tpu.flash_attention's forward
// (_flash_attention_kernel_single_batch, and _single_step for S = 128) at
// f32 compute, as tpu_search/models/mpnet.py calls it (:262-274, operands
// :409-417: compute_dtype=f32 makes q, k, v and ab f32), with the default
// block sizes.  flash_attention.cu is the same function in bf16; this file
// keeps its own kernel, on tf32 wgmma, which the bf16 kernel's products
// do not share.
//
// Contract (ops/flash_attention.py, f32 throughout, nothing rounded to a
// narrower type):
//   s  = (q k^T + ab) * scale + (q_seg == kv_seg ? 0 : -0.7 * FLT_MAX);
//   an online softmax over the keys with acc kept normalized, as the
//   stock kernel's: per step m' = max(m, max s); p = exp(s - m'); l_corr
//   = exp(m - m') l; l' = sum p + l_corr; inv = l' == 0 ? 1 : 1 / l';
//   o = o * (l_corr * inv) + (p * inv) V;
//   out = o; where m_out and l_out are not null, each row's final m and l
//   (f32 [b, heads, s]: the stock kernel's save_residuals, which the
//   backward, flash_attention_bwd.cu, reads).
// The step is the kernel's key tile (64 keys up to hd 64, 32 above), not
// the stock kernel's 128 keys, and p * inv is formed before the product,
// not (p V) * inv after it.  In bf16 the 128-key step fixes the scale at
// which p rounds to bf16, so flash_attention.cu keeps it; in f32 p never
// rounds to a narrower type, so the step and the place of inv change the
// order of f32 roundings alone (m is the exact row max in either, l the
// same sum).
//
// What bounds it on the H100: at B 128, S 384, H 768 (12 heads of 64) it
// reads q, k, v and ab and writes out once: 4 B S H 4 + heads S^2 4
// bytes (611 MB, 0.18 ms at 3.35 TB/s), for 4 B heads S^2 hd flops run
// as 3xTF32 (three tf32 products each: 1.7e11, 0.35 ms at 495 TFLOP/s):
// operations.
//
// Design (helpers in flash_tf32.cuh): every operand is split into tf32 hi
// and lo planes once, as it is staged: the CTA's query rows once, each K
// tile and each V tile (V transposed, its keys along the plane's rows)
// once as it lands.  q k^T and P V are 3xTF32 wgmma (the scores from the
// q and K planes; P V a 32-column output block at a time, P split in
// registers, V^T's planes as B).  Each tile's P V sums in a fresh
// accumulator added to o with one rounded add (the tensor cores' own sums
// truncate).  Scores stay in registers; the bias and the key segment ids
// are read from global memory (the bias is one [heads, S, S] tensor that
// every batch row reads, so L2 serves it).  The depth and the output
// width follow hd rounded up to 32, not a power of two.
//   - hd <= 64 (flash_pair_fwd): one CTA per (128 query rows, head, batch
//     row), two warpgroups of 64 rows sharing each 64-key tile's planes;
//     the tile's K and V rows come by cp.async into raw f32 tiles two
//     tiles ahead and both warpgroups split them there, the V tile while
//     the scores' products run, the next K tile while P V's do.  201,728
//     bytes of shared memory at hd 64, one CTA a multiprocessor.  One
//     warpgroup a CTA that loaded and split its tiles straight from global
//     memory read 1.20x slower, and one with a producer warpgroup 1.5x
//     (PERF.md §6): a tile's staging, not its products, paced them.
//   - above (flash_tf32_fwd): one warpgroup a CTA per (64 query rows,
//     slice of up to 128 output columns, head, batch row), 32-key tiles
//     loaded and split straight from global memory into one buffer each.
//     hd 160 is 20 k8 steps and five output blocks.  Up to hd 256 q stays
//     in shared memory (224 KB at hd 256); above, the score product loops
//     over head chunks of 256 columns, q and K staged again for each and
//     each chunk's scores in a fresh accumulator (correct, not fast).
//     Above 128 columns the output is cut into slices of 128, one a CTA,
//     each recomputing the scores.
// Shared memory is independent of S.

#include "flash_tf32.cuh"

namespace {

using namespace ftf;

constexpr int kThreads = 128;
constexpr int kKeys = 32;      // the key tile above hd 64
constexpr int kQBlocks = 8;    // head blocks (256 columns) q holds at once
constexpr int kOutBlocks = 4;  // output blocks (128 columns) a CTA owns

struct FwdArgs {
  const float *q, *k, *v, *ab;
  const int *q_seg, *kv_seg;
  float *out, *m_out, *l_out;
  int s, nh, hd, nblk, qb, vrows, vec, chunk;
  float scale;
};

// The scores of a key tile in place: ((dot + ab) * scale) + mask for the
// thread's rows (the bias's row r0 at brow, rows ld apart; query segment
// ids qs0, qs1) and keys 8 n + 2 t + e % 2 (segment ids segs).
template <int NT>
__device__ __forceinline__ void score_tile(float (&sc)[NT][4],
                                           const float* brow, long long ld,
                                           const int* segs, int qs0, int qs1,
                                           int t, float scale) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * n + 2 * t;
    const int2 ks = *reinterpret_cast<const int2*>(segs + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 bv = flash::load2(brow + 8 * h * ld + c);
      const int qs = h ? qs1 : qs0;
      sc[n][2 * h] = flash::score(sc[n][2 * h], bv.x, qs == ks.x, scale);
      sc[n][2 * h + 1] =
          flash::score(sc[n][2 * h + 1], bv.y, qs == ks.y, scale);
    }
  }
}

// One tile's step of the online softmax on the thread's two rows: the
// running max m and sum l, p * inv in sc, and corr[h], o's factor.
template <int NT>
__device__ __forceinline__ void softmax_tile(float (&sc)[NT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mx = fmaxf(mx, fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
    const float m_next = fmaxf(m[h], tcattn::quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(__fsub_rn(sc[n][2 * h + e], m_next));
        sc[n][2 * h + e] = p;
        sum = __fadd_rn(sum, p);
      }
    const float l_corr = __fmul_rn(expf(__fsub_rn(m[h], m_next)), l[h]);
    const float l_next = __fadd_rn(tcattn::quad_sum(sum), l_corr);
    const float inv = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
    corr[h] = __fmul_rn(l_corr, inv);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][2 * h] = __fmul_rn(sc[n][2 * h], inv);
      sc[n][2 * h + 1] = __fmul_rn(sc[n][2 * h + 1], inv);
    }
    m[h] = m_next;
    l[h] = l_next;
  }
}

// o = o * corr + pv (pv: this tile's (p * inv) V, summed apart).
template <int OB>
__device__ __forceinline__ void rescale_add(float (&o)[OB][4][4],
                                            const float (&pv)[OB][4][4],
                                            const float (&corr)[2], int ob) {
#pragma unroll
  for (int nb = 0; nb < OB; ++nb)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[nb][n][e] = __fmul_rn(o[nb][n][e], corr[e >> 1]);
  add_out(o, pv, ob);
}

// The residuals (slice 0) and the output columns col0 + 32 nb + ... of
// the thread's rows q0 + r0, q0 + r0 + 8.
template <int OB>
__device__ __forceinline__ void write_out(const FwdArgs& a,
                                          const float (&o)[OB][4][4],
                                          const float (&m)[2],
                                          const float (&l)[2], long long bh,
                                          int q0, int r0, int t, int col0,
                                          bool residuals) {
  if (residuals && a.m_out != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a.m_out[bh * a.s + q0 + r0 + 8 * h] = m[h];
      a.l_out[bh * a.s + q0 + r0 + 8 * h] = l[h];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = a.out + (bh * a.s + q0 + r0 + 8 * h) * a.hd;
#pragma unroll
    for (int nb = 0; nb < OB; ++nb)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        store_pair(row, col0 + 32 * nb + 8 * n + 2 * t, a.hd, o[nb][n][2 * h],
                   o[nb][n][2 * h + 1]);
  }
}

// hd <= 64 (NB = hd / 32 blocks, one score chunk): one CTA per (128
// query rows, head, batch row), two warpgroups of 64 rows sharing each key
// tile's planes; each 64-key tile's K and V rows come by cp.async into raw
// tiles two tiles ahead and both warpgroups split them there, half the
// split a query row it would cost one; the V tile is split while the
// scores' products run, the next K tile while P V's do.
template <int NB>
__global__ void __launch_bounds__(2 * kThreads, 1)
    flash_pair_fwd(const FwdArgs a) {
  constexpr int KT = 64, NT = KT / 8, kPairThreads = 2 * kThreads;
  constexpr int qp = 128 * 128 * NB, kp = KT * 128 * NB;  // planes' bytes
  constexpr int kRawTile = KT * raw_ld(NB);               // floats
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qh = align1024(smem_raw);  // [128 rows][NB blocks]
  unsigned char* ql = qh + qp;
  unsigned char* kh = ql + qp;
  unsigned char* kl = kh + kp;
  unsigned char* vh = kl + kp;  // [32 NB rows][2 blocks of keys]
  unsigned char* vl = vh + kp;
  float* raw = reinterpret_cast<float*>(vl + kp);  // 2 stages: K, then V

  const int s = a.s, hd = a.hd;
  const int q0 = blockIdx.x * 128, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const long long bh = (long long)b * a.nh + head;
  const long long base = bh * s * hd;
  const float* abr = a.ab + ((long long)head * s + q0 + r0) * s;
  const int* kvs = a.kv_seg + (long long)b * s;
  const int qs0 = a.q_seg[(long long)b * s + q0 + r0];
  const int qs1 = a.q_seg[(long long)b * s + q0 + r0 + 8];
  const int tiles = s / KT;

  auto fetch = [&](int j) {  // tile j's K and V rows into stage j % 2
    if (j < tiles && wg == 0) {
      float* st = raw + (j & 1) * 2 * kRawTile;
      const long long rows = base + (long long)j * KT * hd;
      copy_raw<KT, NB>(st, a.k + rows, hd, hd, a.chunk, tid);
      copy_raw<KT, NB>(st + kRawTile, a.v + rows, hd, hd, a.chunk, tid);
    }
    attn2::cp_async_commit();
  };
  // the raw tiles' columns past hd stay zero: cp.async never writes them
  for (int i = tid; i < 2 * 2 * kRawTile / 4; i += kPairThreads)
    reinterpret_cast<float4*>(raw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  fetch(0);
  fetch(1);
  stage_plane<float, true, 128>(qh, ql, a.q + base + (long long)q0 * hd, hd,
                                hd, NB, a.vec != 0, tid, kPairThreads);
  attn2::cp_async_wait<1>();
  __syncthreads();
  split_plane<KT, NB>(kh, kl, raw, tid, kPairThreads);
  fwg::fence_proxy_async();
  __syncthreads();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NB][4][4];
  zero_out(o);
  for (int j = 0; j < tiles; ++j) {
    const int kb = j * KT;
    const float* stage = raw + (j & 1) * 2 * kRawTile;
    float sc[NT][4];
    fwg::zero_acc(sc);
    fwg::fence_acc(sc);
    fwg::wgmma_fence();
    mma_planes<true>(sc, qh, ql, kh, kl, KT, 4 * NB, 128, 64 * wg);
    fwg::wgmma_commit();
    // V^T of this tile while the scores' products run
    split_trans<KT, NB>(vh, vl, stage + kRawTile, tid, kPairThreads);
    fwg::fence_proxy_async();
    fwg::wgmma_wait();
    fwg::fence_acc(sc);
    __syncthreads();  // V^T landed; the K planes and raw stage j % 2 free
    fetch(j + 2);

    score_tile(sc, abr + kb, s, kvs + kb, qs0, qs1, t, a.scale);
    float corr[2];
    softmax_tile(sc, m, l, corr);
    // (p * inv) V into a fresh accumulator, then o = o * corr + that
    uint32_t ph[NT][4], pl[NT][4];
    frag_a<true>(ph, pl, sc);
    float pv[NB][4][4];
    zero_out(pv);
    fence_out(pv);
    fwg::wgmma_fence();
    mma_frags<true>(pv, ph, pl, vh, vl, 32 * NB, NB);
    fwg::wgmma_commit();
    // the next K tile while P V's products run
    if (j + 1 < tiles) {
      attn2::cp_async_wait<1>();  // tile j + 1's rows (all but j + 2's)
      __syncthreads();
      split_plane<KT, NB>(kh, kl, raw + ((j + 1) & 1) * 2 * kRawTile, tid,
                          kPairThreads);
    }
    fwg::fence_proxy_async();
    fwg::wgmma_wait();
    fence_out(pv);
    rescale_add(o, pv, corr, NB);
    __syncthreads();  // the next K tile landed; the V^T planes are free
  }
  write_out(a, o, m, l, bh, q0, r0, t, 0, true);
}

// hd above 64 (see the top of this file).
__global__ void __launch_bounds__(kThreads) flash_tf32_fwd(const FwdArgs a) {
  constexpr int KT = kKeys, NT = KT / 8, OB = kOutBlocks;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qh = align1024(smem_raw);
  unsigned char* ql = qh + 64 * 128 * a.qb;
  unsigned char* kh = ql + 64 * 128 * a.qb;
  unsigned char* kl = kh + KT * 128 * a.qb;
  unsigned char* vh = kl + KT * 128 * a.qb;
  unsigned char* vl = vh + a.vrows * KT * 4;

  const int s = a.s, hd = a.hd;
  const int slices = (a.nblk + kOutBlocks - 1) / kOutBlocks;
  const int slice = blockIdx.x % slices, col0 = slice * kOutBlocks * kBlk;
  const int ob = min(OB, a.nblk - slice * kOutBlocks);
  const int q0 = blockIdx.x / slices * 64, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const long long bh = (long long)b * a.nh + head;
  const long long base = bh * s * hd;
  const float* qg = a.q + base + (long long)q0 * hd;
  const float* abr = a.ab + ((long long)head * s + q0 + r0) * s;
  const int* kvs = a.kv_seg + (long long)b * s;
  const int qs0 = a.q_seg[(long long)b * s + q0 + r0];
  const int qs1 = a.q_seg[(long long)b * s + q0 + r0 + 8];
  const int chunks = (a.nblk + a.qb - 1) / a.qb;  // of the score product
  const int tiles = s / KT;
  const bool vec = a.vec != 0;

  auto stage_q = [&](int c) {
    stage_plane<float, true, 64>(qh, ql, qg + c * a.qb * kBlk, hd,
                                 hd - c * a.qb * kBlk, a.qb, vec, tid,
                                 kThreads);
  };
  auto stage_k = [&](int j, int c) {
    stage_plane<float, true, KT>(
        kh, kl, a.k + base + (long long)j * KT * hd + c * a.qb * kBlk, hd,
        hd - c * a.qb * kBlk, a.qb, vec, tid, kThreads);
  };
  auto chunk_steps = [&](int c) {  // k8 steps of chunk c
    return min(a.qb, a.nblk - c * a.qb) * 4;
  };

  if (chunks == 1) {
    stage_q(0);
    stage_k(0, 0);
    fwg::fence_proxy_async();
    __syncthreads();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[OB][4][4];
  zero_out(o);
  for (int j = 0; j < tiles; ++j) {
    const int kb = j * KT;
    float sc[NT][4];
    fwg::zero_acc(sc);
    fwg::fence_acc(sc);
    if (chunks == 1) {  // q and this K tile are staged
      fwg::wgmma_fence();
      mma_planes<true>(sc, qh, ql, kh, kl, KT, chunk_steps(0));
      fwg::wgmma_commit();
    } else {  // each chunk's sum in a fresh accumulator (add_acc)
      for (int c = 0; c < chunks; ++c) {
        if (c) __syncthreads();  // every warp is done with chunk c - 1
        stage_q(c);
        stage_k(j, c);
        fwg::fence_proxy_async();
        __syncthreads();
        float part[NT][4];
        fwg::zero_acc(part);
        fwg::fence_acc(part);
        fwg::wgmma_fence();
        mma_planes<true>(part, qh, ql, kh, kl, KT, chunk_steps(c));
        fwg::wgmma_commit();
        fwg::wgmma_wait();
        fwg::fence_acc(part);
        add_acc(sc, part);
      }
    }
    // V^T of this tile while the scores' products run
    stage_trans<float, true, KT>(vh, vl,
                                 a.v + base + (long long)kb * hd + col0, hd,
                                 hd - col0, ob * kBlk, a.vrows, tid, kThreads);
    fwg::fence_proxy_async();
    fwg::wgmma_wait();
    fwg::fence_acc(sc);
    __syncthreads();  // V^T landed; the K planes are free

    score_tile(sc, abr + kb, s, kvs + kb, qs0, qs1, t, a.scale);
    float corr[2];
    softmax_tile(sc, m, l, corr);
    // (p * inv) V into a fresh accumulator, then o = o * corr + that
    uint32_t ph[NT][4], pl[NT][4];
    frag_a<true>(ph, pl, sc);
    float pv[OB][4][4];
    zero_out(pv);
    fence_out(pv);
    fwg::wgmma_fence();
    mma_frags<true>(pv, ph, pl, vh, vl, a.vrows, ob);
    fwg::wgmma_commit();
    // the next K tile while P V's products run
    if (chunks == 1 && j + 1 < tiles) stage_k(j + 1, 0);
    fwg::fence_proxy_async();
    fwg::wgmma_wait();
    fence_out(pv);
    rescale_add(o, pv, corr, ob);
    __syncthreads();  // the next K tile landed; the V^T planes are free
  }
  write_out(a, o, m, l, bh, q0, r0, t, col0, slice == 0);
}

// The launch's shape at head size hd: head blocks, q's blocks, V^T's rows,
// the key tile and the shared memory.
struct FwdPlan {
  int nblk, qb, vrows, kt, bytes;
};

inline FwdPlan fwd_plan(int hd) {
  FwdPlan p;
  p.nblk = (hd + kBlk - 1) / kBlk;
  p.qb = p.nblk < kQBlocks ? p.nblk : kQBlocks;
  p.vrows = (p.nblk < kOutBlocks ? p.nblk : kOutBlocks) * kBlk;
  p.kt = p.nblk <= 2 ? 64 : kKeys;
  p.bytes = p.nblk <= 2
                ? 1024 + 2 * (128 * 128 * p.qb + 2 * 64 * 128 * p.qb) +
                      2 * 2 * 64 * raw_ld(p.nblk) * 4
                : 1024 + 2 * (64 * 128 * p.qb + p.kt * 128 * p.qb +
                              p.vrows * p.kt * 4);
  return p;
}

// flash_pair_fwd: 128 query rows and two warpgroups a CTA; else 64 and
// one.
template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, bool pair, const FwdArgs& a,
                          const FwdPlan& p, int b, cudaStream_t stream) {
  cudaError_t err = tcattn::ring_smem(kernel, p.bytes);
  if (err != cudaSuccess) return err;
  const int slices = (p.nblk + kOutBlocks - 1) / kOutBlocks;
  const int rows = pair ? 128 : 64;
  kernel<<<dim3(a.s / rows * slices, a.nh, b), rows * 2, p.bytes, stream>>>(
      a);
  return cudaGetLastError();
}

template <typename Kernel>
int occupancy_of(Kernel kernel, bool pair, const FwdPlan& p) {
  int ctas = 0;
  cudaError_t err = tcattn::ring_smem(kernel, p.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, kernel, pair ? 2 * kThreads : kThreads, p.bytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

}  // namespace

// q, k, v, out: [b, nh, s, hd] f32; ab: [nh, s, s] f32 (16-byte aligned);
// q_seg, kv_seg: [b, s] int32 (8-byte aligned); m_out, l_out: [b, nh, s]
// f32, both null or neither.  Requires s % 128 == 0 and hd >= 1
// (ops/flash_attention.py check_flash_shapes refuses what the stock kernel
// refuses).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, const void* ab,
                                   const void* q_seg, const void* kv_seg,
                                   void* out, void* m_out, void* l_out, int b,
                                   int nh, int s, int hd, float scale,
                                   void* stream) {
  if (hd < 1 || s < 128 || s % 128 || b < 1 || nh < 1 ||
      (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const uintptr_t pairs = reinterpret_cast<uintptr_t>(q_seg) |
                          reinterpret_cast<uintptr_t>(kv_seg);
  if (pairs % 8 || !flash::aligned16(ab))
    return (int)cudaErrorMisalignedAddress;
  const FwdPlan p = fwd_plan(hd);
  const uintptr_t rows = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  FwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.ab = static_cast<const float*>(ab);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.out = static_cast<float*>(out);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.s = s;
  a.nh = nh;
  a.hd = hd;
  a.nblk = p.nblk;
  a.qb = p.qb;
  a.vrows = p.vrows;
  a.vec = hd % 4 == 0 && rows % 16 == 0;  // 4-float loads
  const void* ops[] = {q, k, v};
  a.chunk = flash::row_chunk(hd, 4, ops, 3);  // the raw tiles' copies
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.nblk == 1)
    return (int)launch_kernel(flash_pair_fwd<1>, true, a, p, b, st);
  if (p.nblk == 2)
    return (int)launch_kernel(flash_pair_fwd<2>, true, a, p, b, st);
  return (int)launch_kernel(flash_tf32_fwd, false, a, p,
                            b, st);
}

// CTAs a multiprocessor of the kernel for head size hd (a negative CUDA
// error code on failure), and its dynamic shared memory in *bytes; neither
// depends on s.
extern "C" int flash_attention_f32_occupancy(int hd, int* bytes) {
  *bytes = 0;
  if (hd < 1) return -(int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(hd);
  *bytes = p.bytes;
  if (p.nblk == 1) return occupancy_of(flash_pair_fwd<1>, true, p);
  if (p.nblk == 2) return occupancy_of(flash_pair_fwd<2>, true, p);
  return occupancy_of(flash_tf32_fwd, false, p);
}

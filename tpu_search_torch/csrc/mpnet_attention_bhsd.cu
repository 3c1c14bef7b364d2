// Encoder attention over the head-major layout [B, heads, S, hd], for any
// head size up to 128.
//
// Replaces: tpu_search/ops/pallas_mpnet_attention.py,
// mpnet_flash_attention (kernel body _kernel), which the JAX encoder runs
// where the layout-native kernel does not apply: a hidden size that is not
// a multiple of 128 or a head size that does not divide 128 (the tiny-
// overlap reranker, H 64 / hd 32; the TinyBERT-L-4 cross-encoders, H 312
// / hd 26).  In the port, every head size outside {32, 64, 128} comes here
// too (models/mpnet.py, ops.mpnet_attention.attention_layout).
//
// Contract (the TPU kernel's): q, k, v and out are [B, heads, S, hd] bf16;
// one [heads, S, S] f32 bias is shared by every batch row (zero for BERT
// and XLM-R); the key mask is an additive [B, S] f32.
//   scores = (q k^T) * scale + bias + mask     (f32)
//   whole-row softmax in f32; a row whose max is not finite gets uniform
//   weights instead of NaN; probs are rounded to bf16 before P V (as the
//   TPU kernel does at :64), and P V accumulates in f32.
// Requires S % 64 == 0 and S <= 512 (the reranker's buckets are 64..512).
//
// What bounds it on the H100: at B 128, S 512, H 312 (12 heads of 26) it
// moves 4*B*S*H*2 + heads*S^2*4 + B*S*4 bytes (176 MB, 0.053 ms at
// 3.35 TB/s) for 4*B*heads*S^2*hd flops (0.042 ms at 989 TFLOP/s), so the
// bound is bytes; with hd padded to 32 the tensor cores do 23 % more work
// than that count.  In practice the per-score work sets the pace, as in
// mpnet_attention.cu: the f32 epilogue, two exps, a division and the bias
// read in each pass.
//
// Design: mpnet_attention.cu's two-pass loop (helpers in
// attention_twopass.cuh) over this layout.  One CTA per (64-query block,
// head, batch row), one warpgroup of 4 warps x 16 query rows; the scores
// never leave registers.  Pass 1 keeps each row's running max and sum over
// 64-key tiles; pass 2 recomputes the same scores bit for bit and rounds
// p = exp(s - m) / l (correctly rounded) to bf16 before P V.  q k^T is
// wgmma m64n64k16 from a 128-byte swizzled K tile, P V mma.sync with V by
// ldmatrix.trans; K, V and the [64, 64] f32 bias tile arrive through a
// two-stage cp.async ring (V in pass 2 only), so shared memory is the ring
// alone, independent of S: 63,488 bytes at HDP 32 (three CTAs a
// multiprocessor).  A head's [S, hd] slice is contiguous, rows hd elements
// apart.  Where hd is a multiple of 16 (kExact) the rows copy 16 bytes at
// a time and the query fragments load straight from global memory, as in
// mpnet_attention.cu.  Otherwise head columns are zero-padded to HDP, a
// multiple of 16, in shared memory (hd 26 -> 32, hd 13 -> 16): the ring is
// zeroed once and the copies never write the padding columns, so zero
// columns add nothing to q k^T and the output columns past hd are never
// written.  Those rows copy 16 bytes at a time where hd % 8 == 0, 4 where
// hd is even (TinyBERT's 52-byte rows), else by plain stores, and the
// query fragments load element by element from global memory, zero past
// hd, which read faster on an H100 than q staged through shared memory
// (PERF.md); the 4-byte copies keep hd 26 about 45 % above hd 32's time.

#include "attention_twopass.cuh"

namespace {

#define BHSD_HDPS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

using attn2::kBiasStride;
using attn2::kBlockK;
using attn2::kBlockQ;
using attn2::kStages;
using attn2::kThreads;

template <int HDP, bool kExact>
__global__ void __launch_bounds__(kThreads, HDP > 64 ? 1 : 3)
attention_bhsd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ kmask,
                      __nv_bfloat16* __restrict__ out, int s, int nh, int hd,
                      float scale) {
  using R = attn2::Ring<HDP>;
  constexpr int NT = kBlockK / 8;
  extern __shared__ __align__(1024) unsigned char smem[];

  const int q0 = blockIdx.x * kBlockQ, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp * 16;  // this warp's first query row in the block
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + wr + g;  // this thread's rows: row0, row0 + 8
  const size_t base = ((size_t)b * nh + head) * s * hd;  // this head's rows
  const __nv_bfloat16* kh = k + base;
  const __nv_bfloat16* vh = v + base;
  const float* bias_blk = bias + ((size_t)head * s + q0) * s;
  const float* mrow = kmask + (size_t)b * s + tig * 2;
  auto slot_of = [&](int j) { return smem + (j % kStages) * R::kSlot; };

  uint32_t qa[HDP / 16][4];
  if constexpr (kExact) {
    attn2::load_q<HDP>(qa, q + base + (size_t)row0 * hd + tig * 2, hd);
  } else {
    // zero the ring once: the padding columns stay zero for the run
    for (int i = tid; i < (int)(R::kBytes / 16); i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    attn2::load_q_padded<HDP>(qa, q + base + (size_t)row0 * hd, hd, hd, tig);
  }

  // Load step j < T stages K tile j and its bias tile (pass 1); step T + t
  // stages K, V and bias tile t (pass 2).  Each step is one cp.async
  // group, empty past the end.
  const int tiles = s / kBlockK, steps = 2 * tiles;
  auto issue = [&](int j) {
    if (j < steps) {
      unsigned char* slot = slot_of(j);
      const int kb = (j < tiles ? j : j - tiles) * kBlockK;
      const size_t off = (size_t)kb * hd;
      __nv_bfloat16* vs =
          j >= tiles ? reinterpret_cast<__nv_bfloat16*>(slot + R::kK) : nullptr;
      if constexpr (kExact) {
        attn2::stage_tile_sw128<HDP, kThreads>(slot, kh + off, hd, tid);
        if (vs) attn2::stage_tile<HDP, kThreads>(vs, vh + off, hd, tid);
      } else if (hd % 8 == 0) {
        attn2::stage_rows<HDP, kBlockK, kThreads, true>(slot, vs, kh + off,
                                                        vh + off, hd, tid);
      } else {
        attn2::stage_rows<HDP, kBlockK, kThreads, false>(slot, vs, kh + off,
                                                         vh + off, hd, tid);
      }
      attn2::stage_bias<kThreads>(
          reinterpret_cast<float*>(slot + R::kK + R::kV), bias_blk + kb, s,
          tid);
    }
    attn2::cp_async_commit();
  };
  // Wait for step j's tiles (and make plain stores and cp.async writes
  // visible to wgmma); every warp has left the slot step j + 1 reuses.
  auto arrive = [&](int j) {
    attn2::cp_async_wait<kStages - 2>();
    attn2::fence_proxy_async();
    __syncthreads();
    issue(j + kStages - 1);
  };
  // Step j's scores: (q k^T) * scale + bias + mask.
  auto scores = [&](int j, float (&sc)[NT][4]) {
    const unsigned char* slot = slot_of(j);
    attn2::qk_tile_wgmma<HDP>(sc, qa, slot);
    const int kb = (j < tiles ? j : j - tiles) * kBlockK;
    const float* r0 = reinterpret_cast<const float*>(slot + R::kK + R::kV) +
                      (wr + g) * kBiasStride + tig * 2;
    attn2::score_epilogue(sc, r0, r0 + 8 * kBiasStride, mrow + kb, scale);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  // Pass 1: each row's max m and sum l of exp(s - m).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    arrive(j);
    float sc[NT][4];
    scores(j, sc);
    attn2::online_rows(sc, m, l);
  }
  bool safe[2];
  float rcp[2];
  attn2::finish_rows(m, l, safe, rcp);
  const float uniform = __fdiv_rn(1.f, (float)s);

  // Pass 2: the same scores again, p = bf16(exp(s - m) / l), o += p V.
  float o[HDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
  for (int j = tiles; j < steps; ++j) {
    arrive(j);
    float sc[NT][4];
    scores(j, sc);
    attn2::normalize_rows(sc, m, l, safe, rcp, uniform);
    attn2::pv_tile<HDP>(
        o, sc, reinterpret_cast<const __nv_bfloat16*>(slot_of(j) + R::kK),
        lane);
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
      if constexpr (kExact) {
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

// The kernel for head size hd (hd == HDP: 16-byte rows, q from global).
template <int HDP>
auto kernel_for(int hd) {
  return hd == HDP ? attention_bhsd_kernel<HDP, true>
                   : attention_bhsd_kernel<HDP, false>;
}

template <typename Kernel>
cudaError_t ring_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* kmask, void* out, int b,
                   int nh, int s, int hd, float scale, cudaStream_t stream) {
  constexpr int bytes = (int)attn2::Ring<HDP>::kBytes;
  auto kernel = kernel_for<HDP>(hd);
  cudaError_t err = ring_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kBlockQ, nh, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(kmask), static_cast<__nv_bfloat16*>(out), s,
      nh, hd, scale);
  return cudaGetLastError();
}

// CTAs a multiprocessor of the kernel for head size hd, and its dynamic
// shared memory in *bytes.
template <int HDP>
int occupancy(int hd, int* bytes) {
  *bytes = (int)attn2::Ring<HDP>::kBytes;
  auto kernel = kernel_for<HDP>(hd);
  int ctas = 0;
  cudaError_t err = ring_smem(kernel, *bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kThreads, *bytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

}  // namespace

// q, k, v, out: [b, nh, s, hd] bf16; bias: [nh, s, s] f32; kmask: [b, s]
// f32.  Requires s % 64 == 0, s <= 512 and 1 <= hd <= 128.
extern "C" int mpnet_attention_bhsd(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* kmask, void* out, int b,
                                    int nh, int s, int hd, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 128 || s <= 0 || s % kBlockQ || s > 512)
    return (int)cudaErrorInvalidValue;
#define BHSD_CASE(HDP)                                                      \
  case HDP / 16:                                                            \
    return (int)launch<HDP>(q, k, v, bias, kmask, out, b, nh, s, hd, scale, \
                            st);
  switch ((hd + 15) / 16) {
    BHSD_HDPS(BHSD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BHSD_CASE
}

// CTAs a multiprocessor of the kernel for head size hd (a negative CUDA
// error code on failure), and its dynamic shared memory in *bytes; neither
// depends on s.
extern "C" int mpnet_attention_bhsd_occupancy(int hd, int* bytes) {
  *bytes = 0;
#define BHSD_OCC(HDP) \
  case HDP / 16:      \
    return occupancy<HDP>(hd, bytes);
  switch ((hd + 15) / 16) {
    BHSD_HDPS(BHSD_OCC)
    default:
      return -(int)cudaErrorInvalidValue;
  }
#undef BHSD_OCC
}

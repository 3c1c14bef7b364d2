// MPNet self-attention read straight from the projection layout.
//
// Replaces: tpu_search/ops/pallas_mpnet_attention.py,
// mpnet_flash_attention_nsh (kernel body _kernel_nsh), run by every
// encoder layer.
//
// Contract (the same as the TPU kernel): q, k, v and out are [B, S, H]
// bf16, the GEMM output layout, with heads split inside the kernel
// (head h owns columns h*hd .. h*hd+hd-1).  One [heads, S, S] f32
// relative-position bias is shared by every batch row; the key mask is an
// additive [B, S] f32 (0 for live keys, a large negative or -inf for pads).
//   scores = (q k^T) * scale + bias + mask     (f32)
//   whole-row softmax in f32; a row whose max is not finite gets uniform
//   weights instead of NaN; probs are rounded to bf16 before P V (as the
//   TPU kernel does at :128), and P V accumulates in f32.
// S % 64 == 0, S <= 512, hd in {32, 64, 128}.
//
// What bounds it on the H100: 4*B*heads*S^2*hd flops against 4*B*S*H*2
// bytes of q/k/v/out plus the bias once: at B 128, S 384, hd 64 the bytes
// (0.092 ms at 3.35 TB/s) outweigh the flops (0.059 ms at 989 TFLOP/s).
// In practice the per-score work sets the pace: the f32 epilogue, two
// exps, a division, and the bias read in each pass.
//
// Design (helpers in attention_twopass.cuh): one CTA per (64-query block,
// head, batch row), one warpgroup of 4 warps x 16 query rows.  The scores
// never leave registers.  Pass 1 walks the 64-key tiles, computes the 64 x
// 64 scores with wgmma.mma_async m64n64k16 (q from registers, K from a
// 128-byte swizzled tile), applies the scale, bias and mask with every
// rounding written out, and keeps each row's running max m and sum l (l
// rescaled when m grows).  Pass 2 walks the same tiles, recomputes the
// same scores bit for bit (same instructions, same order), and forms p =
// bf16(exp(s - m) / l) (bf16(1 / S) where m is not finite), whose
// accumulator fragments are the A operand of P V (mma.sync m16n8k16, V by
// ldmatrix.trans).  So the normalized probabilities round to bf16 where
// the TPU kernel rounds them, which a one-pass online softmax (round
// exp(s - m_running), divide at the end) would not; the price is a second
// q k^T (1.5x the flops).  The division is exact: the correctly rounded
// reciprocal of l, then one FMA correction (Markstein), the correctly
// rounded quotient for these operands.  K, V and the [64, 64] f32 bias
// tile arrive through a two-stage cp.async ring, one __syncthreads a tile
// (K alone and the bias in pass 1).  Shared memory is the ring alone,
// independent of S: 71,680 bytes at hd 64, 63,488 at hd 32 (three CTAs a
// multiprocessor).  Not yet done (later work): P V by wgmma, TMA, K/V
// resident across query blocks.

#include "attention_twopass.cuh"

namespace {

using attn2::kBiasStride;
using attn2::kBlockK;
using attn2::kBlockQ;
using attn2::kStages;
using attn2::kThreads;

template <int HD>
__global__ void __launch_bounds__(kThreads, HD > 64 ? 1 : 3)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 const float* __restrict__ kmask,
                 __nv_bfloat16* __restrict__ out, int s, int h, float scale) {
  using R = attn2::Ring<HD>;
  constexpr int NT = kBlockK / 8;
  extern __shared__ __align__(1024) unsigned char smem[];

  const int q0 = blockIdx.x * kBlockQ, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp * 16;  // this warp's first query row in the block
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = q0 + wr + g;  // this thread's rows: row0, row0 + 8
  const size_t col = (size_t)head * HD;

  uint32_t qa[HD / 16][4];
  attn2::load_q<HD>(qa, q + ((size_t)b * s + row0) * h + col + tig * 2, h);
  const float* bias_blk = bias + ((size_t)head * s + q0) * s;
  const float* mrow = kmask + (size_t)b * s + tig * 2;
  const __nv_bfloat16* kbase = k + (size_t)b * s * h + col;
  const __nv_bfloat16* vbase = v + (size_t)b * s * h + col;

  // Load step j < T stages K tile j and its bias tile (pass 1); step T + t
  // stages K, V and bias tile t (pass 2).  Each step is one cp.async
  // group, empty past the end.
  const int tiles = s / kBlockK, steps = 2 * tiles;
  auto slot_of = [&](int j) { return smem + (j % kStages) * R::kSlot; };
  auto issue = [&](int j) {
    if (j < steps) {
      unsigned char* slot = slot_of(j);
      const int kb = (j < tiles ? j : j - tiles) * kBlockK;
      const size_t off = (size_t)kb * h;
      attn2::stage_tile_sw128<HD, kThreads>(slot, kbase + off, h, tid);
      if (j >= tiles)
        attn2::stage_tile<HD, kThreads>(
            reinterpret_cast<__nv_bfloat16*>(slot + R::kK), vbase + off, h,
            tid);
      attn2::stage_bias<kThreads>(
          reinterpret_cast<float*>(slot + R::kK + R::kV), bias_blk + kb, s,
          tid);
    }
    attn2::cp_async_commit();
  };
  // Wait for step j's tiles; every warp has left the slot step j + 1 reuses.
  auto arrive = [&](int j) {
    attn2::cp_async_wait<kStages - 2>();
    attn2::fence_proxy_async();
    __syncthreads();
    issue(j + kStages - 1);
  };
  // Step j's scores: (q k^T) * scale + bias + mask.
  auto scores = [&](int j, float (&sc)[NT][4]) {
    const unsigned char* slot = slot_of(j);
    attn2::qk_tile_wgmma<HD>(sc, qa, slot);
    const int kb = (j < tiles ? j : j - tiles) * kBlockK;
    const float* r0 = reinterpret_cast<const float*>(slot + R::kK + R::kV) +
                      (wr + g) * kBiasStride + tig * 2;
    attn2::score_epilogue(sc, r0, r0 + 8 * kBiasStride, mrow + kb, scale);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);

  // Pass 1: each row's max m, and this thread's share of the sum l of
  // exp(s - m) (rescaled whenever m grows).
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
  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
  for (int j = tiles; j < steps; ++j) {
    arrive(j);
    float sc[NT][4];
    scores(j, sc);
    attn2::normalize_rows(sc, m, l, safe, rcp, uniform);
    attn2::pv_tile<HD>(
        o, sc, reinterpret_cast<const __nv_bfloat16*>(slot_of(j) + R::kK),
        lane);
  }

#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16_rn(o[nt][half * 2]);
      pair.y = __float2bfloat16_rn(o[nt][half * 2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)b * s + row0 + half * 8) * h + col + nt * 8 +
          tig * 2) = pair;
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* kmask, void* out, int b,
                   int s, int h, int nh, float scale, cudaStream_t stream) {
  constexpr size_t bytes = attn2::Ring<HD>::kBytes;
  auto kernel = attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kBlockQ, nh, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(kmask), static_cast<__nv_bfloat16*>(out), s,
      h, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: [b, s, h] bf16; bias: [nh, s, s] f32; kmask: [b, s] f32.
// Requires s % 64 == 0, s <= 512, h % nh == 0 and h / nh in {32, 64, 128}.
extern "C" int mpnet_attention(const void* q, const void* k, const void* v,
                               const void* bias, const void* kmask, void* out,
                               int b, int s, int h, int nh, float scale,
                               void* stream) {
  if (s <= 0 || s % kBlockQ || s > 512) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h / nh) {
    case 32:
      return (int)launch<32>(q, k, v, bias, kmask, out, b, s, h, nh, scale, st);
    case 64:
      return (int)launch<64>(q, k, v, bias, kmask, out, b, s, h, nh, scale, st);
    case 128:
      return (int)launch<128>(q, k, v, bias, kmask, out, b, s, h, nh, scale,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory one launch takes at this width (bytes; 0 for a
// head size the kernel is not built for).  It does not depend on s.
extern "C" int mpnet_attention_smem_bytes(int h, int nh) {
  switch (h / nh) {
    case 32:
      return (int)attn2::Ring<32>::kBytes;
    case 64:
      return (int)attn2::Ring<64>::kBytes;
    case 128:
      return (int)attn2::Ring<128>::kBytes;
    default:
      return 0;
  }
}

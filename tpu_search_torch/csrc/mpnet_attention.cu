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
//
// What bounds it on the H100: 4*B*heads*S^2*hd flops against 4*B*S*H*2
// bytes of q/k/v/out plus the bias: at S=384, hd=64 about 190 flops per
// byte, under the bf16 ridge, so with a simple mma.sync kernel the limit
// is the issue rate of the tensor-core and softmax instructions, not HBM.
// The dense composite this replaces writes and reads the [B, heads, S, S]
// f32 score tensor through HBM (0.9 GB per layer at b128 s384).
//
// Design (the tile code in attention_tile.cuh, shared with
// mpnet_attention_bhsd.cu): one CTA per (64-query block, head, batch row),
// 4 warps of 16 query rows.  The whole score block [64, S] stays in shared
// memory (S <= 512: at most 132 KB), so the softmax is the TPU kernel's
// whole-row softmax, not an online one, and the bf16 rounding of the
// normalized probabilities happens at the same place.  The query fragments
// load straight from global memory; K and V pass through one [64, hd]
// shared tile per 64 keys (uint4 loads: hd is 32, 64 or 128); both
// products use mma.sync m16n8k16 (bf16 in, f32 accumulate).  Not yet done
// (later work): wgmma, TMA, and keeping K/V for several heads resident.

#include "attention_tile.cuh"

namespace {

using attn::kBlockK;
using attn::kBlockQ;
using attn::kThreads;

// Stage rows kb..kb+63 of head `head` from a [B, S, H] tensor into KV.
template <int HD>
__device__ void load_tile(const __nv_bfloat16* __restrict__ src, int b, int s,
                          int h, int head, int kb, __nv_bfloat16* KV) {
  constexpr int KS = HD + 8;
  constexpr int kVec = HD / 8;
  for (int i = threadIdx.x; i < kBlockK * kVec; i += kThreads) {
    const int r = i / kVec, c8 = (i % kVec) * 8;
    const size_t off = ((size_t)b * s + kb + r) * h + (size_t)head * HD + c8;
    *reinterpret_cast<uint4*>(KV + r * KS + c8) =
        *reinterpret_cast<const uint4*>(src + off);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ bias,
                 const float* __restrict__ kmask,
                 __nv_bfloat16* __restrict__ out, int s, int h, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ss = s + 4;  // f32 score row stride (bank-conflict padding)
  float* Sr = reinterpret_cast<float*>(smem);
  __nv_bfloat16* KV = reinterpret_cast<__nv_bfloat16*>(Sr + kBlockQ * ss);

  const int q0 = blockIdx.x * kBlockQ, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;  // first row of this warp inside the block

  // Query fragments of this warp's 16 rows, straight from global memory.
  uint32_t qa[HD / 16][4];
  attn::load_q<HD>(
      qa, q + ((size_t)b * s + q0 + wr + g) * h + (size_t)head * HD + tig * 2,
      h);

  // Phase 1: scores = (q k^T) * scale + bias + mask  -> Sr.
  for (int kb = 0; kb < s; kb += kBlockK) {
    __syncthreads();
    load_tile<HD>(k, b, s, h, head, kb, KV);
    __syncthreads();
    attn::score_tile<HD>(qa, KV, bias, kmask, Sr, ss, s, q0, head, b, kb, wr,
                         g, tig, scale);
  }
  __syncwarp();

  // Phase 2: whole-row softmax of this warp's rows; bf16 probs in place.
  attn::softmax_rows(Sr, ss, s, wr, lane);

  // Phase 3: out = P V, accumulated over 64-key tiles of V.
  const __nv_bfloat16* P = reinterpret_cast<const __nv_bfloat16*>(Sr);
  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
  for (int kb = 0; kb < s; kb += kBlockK) {
    __syncthreads();
    load_tile<HD>(v, b, s, h, head, kb, KV);
    __syncthreads();
    attn::pv_tile<HD>(o, P, 2 * ss, KV, kb, wr, g, tig);
  }
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wr + g + half * 8;
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16_rn(o[nt][half * 2]);
      pair.y = __float2bfloat16_rn(o[nt][half * 2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)b * s + row) * h + (size_t)head * HD + nt * 8 +
          tig * 2) = pair;
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* kmask, void* out, int b,
                   int s, int h, int nh, float scale, cudaStream_t stream) {
  const size_t bytes = attn::smem_bytes(s, HD);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kBlockQ, nh, b);
  attention_kernel<HD><<<grid, kThreads, bytes, stream>>>(
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h / nh) {
    case 32:
      return (int)launch<32>(q, k, v, bias, kmask, out, b, s, h, nh, scale, st);
    case 64:
      return (int)launch<64>(q, k, v, bias, kmask, out, b, s, h, nh, scale, st);
    case 128:
      return (int)launch<128>(q, k, v, bias, kmask, out, b, s, h, nh, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
// than that count, and the whole-row softmax in shared memory is the
// simple kernel's real limit, as in mpnet_attention.cu.
//
// Design: the tile code of attention_tile.cuh (products, score epilogue,
// whole-row softmax), shared with mpnet_attention.cu; this file stages the
// rows.  A head's [S, hd] slice is contiguous, so a 64-row tile is one
// contiguous run of 64 * hd elements: the element-wise staging reads it
// coalesced.  Head columns are zero-padded to HDP, a multiple of 16, in
// shared memory, so the m16n8k16 bf16 tiles apply to any hd (hd 26 -> 32,
// hd 8 -> 16); zero columns add nothing to q k^T and the output columns
// past hd are never written.  Where hd is already a multiple of 16, the
// rows load as uint4 and the query fragments straight from global memory:
// at hd 32 the element-wise staging takes 9-21 % longer (PERF.md).

#include "attention_tile.cuh"

namespace {

using attn::kBlockK;
using attn::kBlockQ;
using attn::kThreads;

// Stage rows r0..r0+63 (columns < hd) of one head's contiguous [S, hd]
// slice into KV [64][HDP + 8]: uint4 loads where hd == HDP, else element
// by element (one coalesced run of 64 * hd), the padding columns untouched.
template <int HDP, bool kVec>
__device__ void load_rows(const __nv_bfloat16* __restrict__ head_rows, int hd,
                          int r0, __nv_bfloat16* KV) {
  constexpr int KS = HDP + 8;
  const __nv_bfloat16* run = head_rows + (size_t)r0 * hd;
  if constexpr (kVec) {
    constexpr int kVecN = HDP / 8;
    for (int i = threadIdx.x; i < kBlockK * kVecN; i += kThreads) {
      const int r = i / kVecN, c8 = (i % kVecN) * 8;
      *reinterpret_cast<uint4*>(KV + r * KS + c8) =
          *reinterpret_cast<const uint4*>(run + r * HDP + c8);
    }
  } else {
    for (int i = threadIdx.x; i < kBlockK * hd; i += kThreads) {
      const int r = i / hd;
      KV[r * KS + (i - r * hd)] = run[i];
    }
  }
}

template <int HDP, bool kVec>
__global__ void __launch_bounds__(kThreads)
attention_bhsd_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ kmask,
                      __nv_bfloat16* __restrict__ out, int s, int nh, int hd,
                      float scale) {
  constexpr int KS = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ss = s + 4;  // f32 score row stride (bank-conflict padding)
  float* Sr = reinterpret_cast<float*>(smem);
  __nv_bfloat16* KV = reinterpret_cast<__nv_bfloat16*>(Sr + kBlockQ * ss);

  const int q0 = blockIdx.x * kBlockQ, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;  // first row of this warp inside the block
  const size_t base = ((size_t)b * nh + head) * s * hd;  // this head's rows

  // Query fragments of this warp's 16 rows: straight from global memory
  // where hd == HDP, else staged through KV, whose padding columns are
  // zeroed first and stay zero for the whole run.
  uint32_t qa[HDP / 16][4];
  if constexpr (kVec) {
    attn::load_q<HDP>(qa, q + base + (size_t)(q0 + wr + g) * hd + tig * 2,
                      hd);
  } else {
    for (int i = threadIdx.x; i < kBlockK * KS; i += kThreads)
      KV[i] = __float2bfloat16_rn(0.f);
    __syncthreads();
    load_rows<HDP, false>(q + base, hd, q0, KV);
    __syncthreads();
    attn::load_q<HDP>(qa, KV + (wr + g) * KS + tig * 2, KS);
  }

  // Phase 1: scores = (q k^T) * scale + bias + mask  -> Sr.
  for (int kb = 0; kb < s; kb += kBlockK) {
    __syncthreads();
    load_rows<HDP, kVec>(k + base, hd, kb, KV);
    __syncthreads();
    attn::score_tile<HDP>(qa, KV, bias, kmask, Sr, ss, s, q0, head, b, kb,
                          wr, g, tig, scale);
  }
  __syncwarp();

  // Phase 2: whole-row softmax of this warp's rows; bf16 probs in place.
  attn::softmax_rows(Sr, ss, s, wr, lane);

  // Phase 3: out = P V, accumulated over 64-key tiles of V.
  const __nv_bfloat16* P = reinterpret_cast<const __nv_bfloat16*>(Sr);
  float o[HDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
  for (int kb = 0; kb < s; kb += kBlockK) {
    __syncthreads();
    load_rows<HDP, kVec>(v + base, hd, kb, KV);
    __syncthreads();
    attn::pv_tile<HDP>(o, P, 2 * ss, KV, kb, wr, g, tig);
  }
  // Output columns past hd come from the zero padding: never written.
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + wr + g + half * 8, col = nt * 8 + tig * 2;
      __nv_bfloat16* dst = out + base + (size_t)row * hd + col;
      const __nv_bfloat16 lo = __float2bfloat16_rn(o[nt][half * 2]);
      const __nv_bfloat16 hi = __float2bfloat16_rn(o[nt][half * 2 + 1]);
      if constexpr (kVec) {
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

template <int HDP, bool kVec>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* kmask, void* out, int b,
                   int nh, int s, int hd, float scale, cudaStream_t stream) {
  const size_t bytes = attn::smem_bytes(s, HDP);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bhsd_kernel<HDP, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kBlockQ, nh, b);
  attention_bhsd_kernel<HDP, kVec><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(kmask), static_cast<__nv_bfloat16*>(out), s,
      nh, hd, scale);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_hdp(const void* q, const void* k, const void* v,
                       const void* bias, const void* kmask, void* out, int b,
                       int nh, int s, int hd, float scale,
                       cudaStream_t stream) {
  if (hd == HDP)
    return launch<HDP, true>(q, k, v, bias, kmask, out, b, nh, s, hd, scale,
                             stream);
  return launch<HDP, false>(q, k, v, bias, kmask, out, b, nh, s, hd, scale,
                            stream);
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
  if (hd < 1 || hd > 128 || s % kBlockQ || s > attn::kMaxSeq)
    return (int)cudaErrorInvalidValue;
#define ATTN_BHSD_CASE(HDP)                                                 \
  case HDP / 16:                                                            \
    return (int)launch_hdp<HDP>(q, k, v, bias, kmask, out, b, nh, s, hd,    \
                                scale, st);
  switch ((hd + 15) / 16) {
    ATTN_BHSD_CASE(16)
    ATTN_BHSD_CASE(32)
    ATTN_BHSD_CASE(48)
    ATTN_BHSD_CASE(64)
    ATTN_BHSD_CASE(80)
    ATTN_BHSD_CASE(96)
    ATTN_BHSD_CASE(112)
    ATTN_BHSD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ATTN_BHSD_CASE
}

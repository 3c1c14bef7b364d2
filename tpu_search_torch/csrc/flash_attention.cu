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
//   out = bf16(o).
// q, k, v, out and ab are bf16; ab is one [heads, S, S] tensor shared by
// the batch (JAX broadcasts the same values to [B, heads, S, S]); segment
// ids are [B, S] int32.  S % 128 == 0 and 1 <= hd <= 128, as the stock
// kernel's block sizes require.  Every rounding step is written out
// (__fadd_rn, __fmul_rn, __fdiv_rn), so nvcc's -fmad changes nothing.
//
// What bounds it on the H100: at B 128, S 384, H 768 (12 heads of 64) it
// reads q, k, v and ab and writes out once: 4*B*S*H*2 + heads*S^2*2 bytes
// (306 MB, 0.091 ms at 3.35 TB/s) for 4*B*heads*S^2*hd flops (0.059 ms at
// 989 TFLOP/s): bytes bound it.
//
// Design: one CTA per (64-query block, head, batch row), 4 warps of 16
// query rows, as the other attention kernels (attention_tile.cuh: the
// mma.sync m16n8k16 bf16 -> f32 helpers).  Unlike them it never holds a
// [64, S] score block: per 128-key block (the stock kernel's softmax
// step, so the running max, sum and bf16 rounding of p happen where the
// TPU kernel has them) the K and V rows are staged in shared memory
// ([128, HDP + 8] bf16 each, 36 KB at hd 64), the 16 x 128 scores of each
// warp stay in registers, the row max and sum are quad shuffles, and p
// becomes the A fragments of P V in registers (the accumulator layout of
// m16n8k16 is its A layout).  Shared memory does not grow with S.  Head
// columns are zero-padded to HDP, a multiple of 16, in shared memory (hd
// 26 -> 32); the query fragments load from global memory where hd == HDP.
// Not yet done (later work): cp.async/TMA double buffering of K and V,
// and wgmma.

#include <float.h>

#include "attention_tile.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 128;      // keys per softmax step (the stock block_k)
constexpr int kThreads = 128; // 4 warps x 16 query rows
constexpr float kMask = (float)(-0.7 * (double)FLT_MAX);

__host__ __device__ constexpr size_t smem_bytes(int hdp) {
  return (size_t)2 * kBK * (hdp + 8) * 2;
}

// Stage rows r0..r0+nrows-1 (columns < hd) of one head's contiguous
// [S, hd] slice into T [nrows][HDP + 8]: uint4 loads where hd == HDP, else
// element by element; padding columns are never written.
template <int HDP, bool kVec>
__device__ void stage_rows(const __nv_bfloat16* __restrict__ head_rows,
                           int hd, int r0, int nrows, __nv_bfloat16* T) {
  constexpr int KS = HDP + 8;
  const __nv_bfloat16* run = head_rows + (size_t)r0 * hd;
  if constexpr (kVec) {
    constexpr int kVecN = HDP / 8;
    for (int i = threadIdx.x; i < nrows * kVecN; i += kThreads) {
      const int r = i / kVecN, c8 = (i % kVecN) * 8;
      *reinterpret_cast<uint4*>(T + r * KS + c8) =
          *reinterpret_cast<const uint4*>(run + r * HDP + c8);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * hd; i += kThreads) {
      const int r = i / hd;
      T[r * KS + (i - r * hd)] = run[i];
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(attn::kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(attn::kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(attn::kFull, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(attn::kFull, x, 2));
}

template <int HDP, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ ab,
             const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
             __nv_bfloat16* __restrict__ out, int s, int nh, int hd,
             float scale) {
  constexpr int KS = HDP + 8;
  constexpr int NT = kBK / 8;  // 8-key tiles of one step
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kBK * KS;

  const int q0 = blockIdx.x * kBQ, head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;
  const size_t base = ((size_t)b * nh + head) * s * hd;
  const int row0 = q0 + wr + g;  // this thread's rows: row0 and row0 + 8
  const int seg0 = q_seg[(size_t)b * s + row0];
  const int seg1 = q_seg[(size_t)b * s + row0 + 8];
  const __nv_bfloat16* ab0 = ab + ((size_t)head * s + row0) * s;
  const __nv_bfloat16* ab1 = ab0 + (size_t)8 * s;
  const int* kvs = kv_seg + (size_t)b * s;

  uint32_t qa[HDP / 16][4];
  if constexpr (kVec) {
    attn::load_q<HDP>(qa, q + base + (size_t)row0 * hd + tig * 2, hd);
  } else {
    // Zero both tiles once: the padding columns stay zero for the run.
    for (int i = threadIdx.x; i < 2 * kBK * KS; i += kThreads)
      Ks[i] = __float2bfloat16_rn(0.f);
    __syncthreads();
    stage_rows<HDP, false>(q + base, hd, q0, kBQ, Ks);
    __syncthreads();
    attn::load_q<HDP>(qa, Ks + (wr + g) * KS + tig * 2, KS);
  }

  float o[HDP / 8][4];
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[nt][j] = 0.f;
  float m_prev[2] = {-INFINITY, -INFINITY}, l_prev[2] = {0.f, 0.f};
  const bool single = s == kBK;

  for (int kb = 0; kb < s; kb += kBK) {
    __syncthreads();  // the previous step's readers are done
    stage_rows<HDP, kVec>(k + base, hd, kb, kBK, Ks);
    stage_rows<HDP, kVec>(v + base, hd, kb, kBK, Vs);
    __syncthreads();

    // s = (q k^T + ab) * scale + segment mask, 16 rows x 128 keys a warp.
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* p = Ks + (nt * 8 + g) * KS + kk * 16 + tig * 2;
        const uint32_t bb[2] = {attn::ld32(p), attn::ld32(p + 8)};
        attn::mma_bf16(sc[nt], qa[kk], bb);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = kb + nt * 8 + tig * 2;
      const int ks0 = kvs[key], ks1 = kvs[key + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(
            (half ? ab1 : ab0) + key);
        const int qs = half ? seg1 : seg0;
        const float c0 = __fadd_rn(
            __fmul_rn(__fadd_rn(sc[nt][half * 2], __low2float(bv)), scale),
            qs == ks0 ? 0.f : kMask);
        const float c1 = __fadd_rn(
            __fmul_rn(__fadd_rn(sc[nt][half * 2 + 1], __high2float(bv)),
                      scale),
            qs == ks1 ? 0.f : kMask);
        sc[nt][half * 2] = c0;
        sc[nt][half * 2 + 1] = c1;
        mx[half] = fmaxf(mx[half], fmaxf(c0, c1));
      }
    }

    float m_next[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half)
      m_next[half] = fmaxf(m_prev[half], quad_max(mx[half]));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[nt][j] = expf(__fsub_rn(sc[nt][j], m_next[j >> 1]));
        sum[j >> 1] = __fadd_rn(sum[j >> 1], sc[nt][j]);
      }
    float corr[2], inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float total = quad_sum(sum[half]);
      if (single) {
        // The stock one-step kernel: p /= l before the bf16 rounding.
        corr[half] = 0.f;
        inv[half] = 1.f;
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

    // o = o * corr + (bf16(p) V) * inv; p's accumulator layout is the A
    // fragment layout of the next product.
    float oc[HDP / 8][4];
#pragma unroll
    for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) oc[nt][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {
          attn::pack2(__float2bfloat16_rn(sc[2 * kk][0]),
                      __float2bfloat16_rn(sc[2 * kk][1])),
          attn::pack2(__float2bfloat16_rn(sc[2 * kk][2]),
                      __float2bfloat16_rn(sc[2 * kk][3])),
          attn::pack2(__float2bfloat16_rn(sc[2 * kk + 1][0]),
                      __float2bfloat16_rn(sc[2 * kk + 1][1])),
          attn::pack2(__float2bfloat16_rn(sc[2 * kk + 1][2]),
                      __float2bfloat16_rn(sc[2 * kk + 1][3]))};
#pragma unroll
      for (int nt = 0; nt < HDP / 8; ++nt) {
        const __nv_bfloat16* pv = Vs + (kk * 16 + tig * 2) * KS + nt * 8 + g;
        const uint32_t bb[2] = {attn::pack2(pv[0], pv[KS]),
                                attn::pack2(pv[8 * KS], pv[9 * KS])};
        attn::mma_bf16(oc[nt], a, bb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int half = j >> 1;
        o[nt][j] = __fadd_rn(__fmul_rn(o[nt][j], corr[half]),
                             __fmul_rn(oc[nt][j], inv[half]));
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
                   const void* ab, const int* q_seg, const int* kv_seg,
                   void* out, int b, int nh, int s, int hd, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HDP, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kBQ, nh, b);
  flash_kernel<HDP, kVec><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(ab), q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(out), s, nh, hd, scale);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_hdp(const void* q, const void* k, const void* v,
                       const void* ab, const int* q_seg, const int* kv_seg,
                       void* out, int b, int nh, int s, int hd, float scale,
                       cudaStream_t stream) {
  if (hd == HDP)
    return launch<HDP, true>(q, k, v, ab, q_seg, kv_seg, out, b, nh, s, hd,
                             scale, stream);
  return launch<HDP, false>(q, k, v, ab, q_seg, kv_seg, out, b, nh, s, hd,
                            scale, stream);
}

}  // namespace

// q, k, v, out: [b, nh, s, hd] bf16; ab: [nh, s, s] bf16; q_seg, kv_seg:
// [b, s] int32.  Requires s % 128 == 0 and 1 <= hd <= 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* ab, const void* q_seg,
                               const void* kv_seg, void* out, int b, int nh,
                               int s, int hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 128 || s < kBK || s % kBK)
    return (int)cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
#define FLASH_CASE(HDP)                                                    \
  case HDP / 16:                                                           \
    return (int)launch_hdp<HDP>(q, k, v, ab, qs, ks, out, b, nh, s, hd,    \
                                scale, st);
  switch ((hd + 15) / 16) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(48)
    FLASH_CASE(64)
    FLASH_CASE(80)
    FLASH_CASE(96)
    FLASH_CASE(112)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

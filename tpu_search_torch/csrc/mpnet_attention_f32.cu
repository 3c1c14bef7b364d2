// Encoder attention in f32, for both layouts ([B, S, H] with the heads
// split inside, and [B, heads, S, hd]) by strides, any head size up to 128
// and any S whose score rows fit in shared memory (S <= 2,944 at hd 128).
//
// Replaces no TPU kernel.  The JAX package runs f32 compute through its
// dense XLA attention (tpu_search/models/mpnet.py:276-281); the port's
// "dense" mode is its hand kernels, and the bf16 ones
// (mpnet_attention.cu, mpnet_attention_bhsd.cu) take bf16 alone, so f32
// compute on the card (EmbeddingConfig(compute_dtype="float32"), the
// trainer and the dry run in f32) needs a kernel of its own.
//
// Contract (ops/mpnet_attention.py): scores = (q k^T) * scale + bias +
// mask in f32, one [heads, S, S] f32 bias shared by the batch, an additive
// [B, S] f32 key mask; a whole-row softmax in f32 whose rows with a max
// that is not finite get uniform weights; P V accumulated in f32.
//
// What bounds it on the H100: at B 32, S 256, H 768 (12 heads of 64) it
// moves 4 * B * S * H * 4 + heads * S^2 * 4 + B * S * 4 bytes (104 MB, 0.031
// ms at 3.35 TB/s) for 4 * B * heads * S^2 * hd flops (6.4 GFLOP, 0.096 ms
// at 67 TFLOP/s of f32 FMAs): operations, on the CUDA cores.  This design
// is far from that: each CTA reads its head's whole K and V from L2, and
// every FMA reads an operand from shared memory.
//
// Design (helpers in attention_rows.cuh): one CTA of 256 threads per (16
// query rows, head, batch row).  The 16 score rows live whole in shared
// memory: pass 1 stages K in 64-row f32 tiles and writes
// (q k^T) * scale + bias + mask; a warp per row takes the softmax in place;
// pass 2 stages V tiles and accumulates P V, each thread one row and up to
// eight columns.

#include "attention_rows.cuh"

namespace {

using namespace rowattn;

__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const float* __restrict__ kmask, float* __restrict__ out,
                     int s, int hd, Strides st, float scale) {
  extern __shared__ float smem[];
  const int ld = hd | 1, sld = round_up(s, kKB);
  float* sc = smem;              // [kQB][sld] scores, then probabilities
  float* qs = sc + kQB * sld;    // [kQB][ld] the CTA's query rows
  float* tile = qs + kQB * ld;   // [kKB][ld] a K or V tile
  const int q0 = blockIdx.x * kQB, head = blockIdx.y, b = blockIdx.z;
  const int nq = min(kQB, s - q0);
  const long long base = (long long)b * st.sb + (long long)head * st.sh;

  stage(qs, q + base + (long long)q0 * st.ss, kQB, nq, hd, ld, st.ss);
  dot_rows(sc, sld, qs, tile, k + base, s, nq, hd, ld, st.ss,
           bias + ((long long)head * s + q0) * s, kmask + (long long)b * s,
           scale);
  for (int r = threadIdx.x >> 5; r < nq; r += kThreads / 32)
    softmax_row(sc + r * sld, s);
  mix_rows(out + base + (long long)q0 * st.ss, sc, sld, tile, v + base, s,
           nq, hd, ld, st.ss, 1.f);
}

}  // namespace

// q, k, v, out: f32 in the layout of (sb, sh, ss); bias [nh, s, s] f32;
// kmask [b, s] f32.  Requires 1 <= hd <= 128 and the row pass's shared
// memory within the card's 227 KB.
extern "C" int mpnet_attention_f32(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* kmask, void* out, int b,
                                   int nh, int s, int hd, long long sb,
                                   long long sh, long long ss, float scale,
                                   void* stream) {
  const long long bytes = row_pass_bytes(s, hd, 1);
  if (hd < 1 || hd > kMaxHd || s < 1 || b < 1 || nh < 1 ||
      bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + kQB - 1) / kQB, nh, b);
  attention_f32_kernel<<<grid, kThreads, (size_t)bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(kmask), static_cast<float*>(out), s, hd,
      Strides{sb, sh, ss}, scale);
  return (int)cudaGetLastError();
}

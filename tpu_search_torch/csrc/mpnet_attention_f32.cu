// Encoder attention in f32, for both layouts ([B, S, H] with the heads
// split inside, and [B, heads, S, hd]) by strides, any head size up to 128
// and any S.
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
// ms at 3.35 TB/s) for 4 * B * heads * S^2 * hd flops (6.4 GFLOP).  This
// design runs them as 3xTF32 on the tensor cores (three tf32 products each:
// 19.3 GFLOP, 0.039 ms at 495 TFLOP/s, against 0.096 ms as f32 FMAs at 67
// TFLOP/s): operations.  What paces it is the CUDA-core work around the
// products: each warp splits its K and V fragments into tf32 big + small
// itself, and each score takes an epilogue and an exp.
//
// Design (helpers in attention_tc.cuh).  P is never rounded in f32, so
// the softmax need not be final before P V: one online pass, as
// FlashAttention's, where the bf16 kernels take two.  One CTA (4 warps x
// 16 rows) per (64 query rows, head, batch row); the query rows staged
// once, K and V tiles with the [64 queries, keys] bias tile through a
// two-stage cp.async ring, 64 keys a step (32 above hd 16); the scores in
// registers.  Per key tile: s, each row's running max m and sum l of
// exp(s - m), o += exp(s - m) V with l and o rescaled whenever m grows;
// at the end o / l, correctly rounded.  exp(s - m) is split as tf32 big +
// small, each 16 keys' products added to o with one rounded add.  A row
// whose max is not finite gets 1 / S on each key from one more pass over
// V, run only by a CTA that holds such a row.  Shared memory is the query
// tile and the ring, independent of S.

#include "attention_tc.cuh"

namespace {

using namespace tcattn;
using Ops = F32Ops;

// The query rows, then two ring stages.
template <int HDP>
__host__ __device__ constexpr int fwd_bytes() {
  return kRows * (HDP + 8) * 4 + 2 * RowSlot<float, HDP>::kBytes;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
attention_f32_tc(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias_all,
                 const float* __restrict__ kmask, float* __restrict__ out,
                 int s, int hd, int chunk, int vec4, Strides st,
                 float scale) {
  using L = RowSlot<float, HDP>;
  constexpr int LD = L::LD, KT = L::KT, NT = KT / 8, DT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [64][LD] query rows
  unsigned char* ring = reinterpret_cast<unsigned char*>(qs + kRows * LD);

  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int q_a = q0 + r0 + g;  // this thread's rows: q_a, q_a + 8
  const long long base = (long long)b * st.sb + (long long)head * st.sh;
  const long long ss = st.ss;
  const float* bias = bias_all + (long long)head * s * s;
  const float* mask = kmask + (long long)b * s;

  if (hd != HDP) zero_smem(smem, fwd_bytes<HDP>(), tid);
  stage_rows<float, kRows>(qs, LD, q + base + q0 * ss, ss,
                           min(kRows, s - q0), hd, chunk, tid);
  attn2::cp_async_commit();

  // Step j stages K and V tile j with its bias tile.
  const int tiles = (s + KT - 1) / KT;
  auto slot = [&](int j) { return ring + (j & 1) * L::kBytes; };
  auto issue = [&](int j) {
    if (j < tiles)
      stage_keys<float, HDP>(slot(j), k + base, v + base, bias, ss, s, q0,
                             j * KT, hd, chunk, vec4, tid);
    attn2::cp_async_commit();
  };
  auto arrive = [&](int j) {
    attn2::cp_async_wait<0>();
    __syncthreads();
    issue(j + 1);
  };
  issue(0);

  // One pass: per key tile, the scores, each row's running max m (the
  // quad's) and the thread's share of l = sum exp(s - m), and
  // o += exp(s - m) V, with l and o rescaled whenever m grows.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DT][4];
  zero(o);
  for (int j = 0; j < tiles; ++j) {
    arrive(j);
    const unsigned char* sl = slot(j);
    const float* ks = reinterpret_cast<const float*>(sl);
    const float* bt = reinterpret_cast<const float*>(sl + L::kBias);
    const int kb = j * KT;
    float sc[NT][4];
    rows_by_rows<Ops, HDP, NT>(sc, qs, ks, LD, r0, lane);
    if (kb + KT > s || q0 + kRows > s || (s & 1))
      score_rows<true>(sc, bt, L::LDB, mask + kb, r0 + g, t, s - q0, s - kb,
                       scale);
    else
      score_rows<false>(sc, bt, L::LDB, mask + kb, r0 + g, t, 0, 0, scale);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      // a row with no finite score yet keeps l = 0 and o = 0
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float f = expf(__fsub_rn(m[h], shift));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float ex = expf(__fsub_rn(sc[n][2 * h + c], shift));
          sc[n][2 * h + c] = ex;
          sum = __fadd_rn(sum, ex);
        }
      l[h] = __fadd_rn(__fmul_rn(l[h], f), sum);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][2 * h] = __fmul_rn(o[n][2 * h], f);
        o[n][2 * h + 1] = __fmul_rn(o[n][2 * h + 1], f);
      }
      m[h] = m_new;
    }
    mix<Ops, HDP, NT, false>(o, sc, ks + KT * LD, LD, lane);
  }
  bool safe[2], uni[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    safe[h] = isfinite(m[h]);
    uni[h] = !safe[h] && q_a + 8 * h < s;
  }

  // A row whose max is not finite (every key masked by -inf) takes uniform
  // weights, 1 / S on each key inside the sequence: one more pass over V,
  // run only by a CTA that holds such a row.
  if (__syncthreads_or(uni[0] || uni[1])) {
    const float uniform = __fdiv_rn(1.f, (float)s);
    auto issue_v = [&](int j) {
      if (j < tiles)
        stage_rows<float, KT>(
            reinterpret_cast<float*>(slot(j)) + KT * LD, LD,
            v + base + j * KT * ss, ss, min(KT, s - j * KT), hd, chunk, tid);
      attn2::cp_async_commit();
    };
    issue_v(0);
    for (int j = 0; j < tiles; ++j) {
      attn2::cp_async_wait<0>();
      __syncthreads();
      issue_v(j + 1);
      float p[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[n][e] = uni[e >> 1] && j * KT + 8 * n + 2 * t + (e & 1) < s
                        ? uniform
                        : 0.f;
      mix<Ops, HDP, NT, false>(
          o, p, reinterpret_cast<const float*>(slot(j)) + KT * LD, LD, lane);
    }
  }
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (safe[e >> 1]) o[n][e] = __fdiv_rn(o[n][e], l[e >> 1]);

  float* oh = out + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_a + 8 * h;
    if (row >= s) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < hd) oh[row * ss + col] = o[n][2 * h + c];
      }
  }
}

template <int HDP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* bias, const float* kmask, float* out, int b,
                   int nh, int s, int hd, int chunk, int vec4, Strides st,
                   float scale, cudaStream_t stream) {
  constexpr int bytes = fwd_bytes<HDP>();
  cudaError_t err = ring_smem(attention_f32_tc<HDP>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kRows - 1) / kRows, nh, b);
  attention_f32_tc<HDP><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, kmask, out, s, hd, chunk, vec4, st, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: f32 in the layout of (sb, sh, ss); bias [nh, s, s] f32;
// kmask [b, s] f32.  Requires 1 <= hd <= 128.
extern "C" int mpnet_attention_f32(const void* q, const void* k,
                                   const void* v, const void* bias,
                                   const void* kmask, void* out, int b,
                                   int nh, int s, int hd, long long sb,
                                   long long sh, long long ss, float scale,
                                   void* stream) {
  if (hd < 1 || hd > kMaxHd || s < 1 || b < 1 || nh < 1)
    return (int)cudaErrorInvalidValue;
  int chunk = 16;
  auto aligned = [&](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % chunk == 0;
  };
  while (chunk > 4 && ((hd * 4) % chunk || (ss * 4) % chunk ||
                       (sh * 4) % chunk || (sb * 4) % chunk || !aligned(q) ||
                       !aligned(k) || !aligned(v)))
    chunk /= 2;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(bias);
  const auto* mf = static_cast<const float*>(kmask);
  auto* of = static_cast<float*>(out);
  // the bias and mask tiles copy 16 bytes at a time where rows allow
  const int vec4 = s % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(kmask) % 16 == 0;
  const Strides st{sb, sh, ss};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  if (hd <= 16)
    return (int)launch<16>(qf, kf, vf, bf, mf, of, b, nh, s, hd, chunk, vec4,
                           st, scale, stm);
  if (hd <= 32)
    return (int)launch<32>(qf, kf, vf, bf, mf, of, b, nh, s, hd, chunk, vec4,
                           st, scale, stm);
  if (hd <= 64)
    return (int)launch<64>(qf, kf, vf, bf, mf, of, b, nh, s, hd, chunk, vec4,
                           st, scale, stm);
  return (int)launch<128>(qf, kf, vf, bf, mf, of, b, nh, s, hd, chunk, vec4,
                          st, scale, stm);
}

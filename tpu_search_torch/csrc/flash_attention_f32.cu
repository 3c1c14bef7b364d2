// The stock flash attention of the JAX encoder's attention_impl="flash"
// mode in f32, over [B, heads, S, hd].
//
// Replaces: jax.experimental.pallas.ops.tpu.flash_attention's forward
// (_flash_attention_kernel_single_batch, and _single_step for S = 128) at
// f32 compute, as tpu_search/models/mpnet.py calls it (:262-274, operands
// :409-417: compute_dtype=f32 makes q, k, v and ab f32), with the default
// block sizes.  flash_attention.cu is the same function in bf16; this file
// keeps its own kernel so that the bf16 kernel's wgmma ring, which takes
// bf16 alone, stays as it is.
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
// The step is the ring's key tile (64 keys at hd 16 and below, 32 up to
// 128, 16 at 256: flash::tile_rows), not the stock kernel's 128 keys, and
// p * inv is formed before the product, not (p V) * inv after it.  In bf16
// the 128-key step fixes the scale at which p rounds to bf16, so
// flash_attention.cu keeps it; in f32 p never rounds to a narrower type, so
// the step and the place of inv change the order of f32 roundings alone (m
// is the exact row max in either, l the same sum), and the smaller step
// keeps the ring and the registers at the f32 forward's size
// (attention_tc.cuh).
//
// What bounds it on the H100: at B 128, S 384, H 768 (12 heads of 64) it
// reads q, k, v and ab and writes out once: 4 B S H 4 + heads S^2 4
// bytes (611 MB, 0.18 ms at 3.35 TB/s), for 4 B heads S^2 hd flops run
// as 3xTF32 (three tf32 products each: 1.7e11, 0.35 ms at 495 TFLOP/s):
// operations.  What paces it is the CUDA-core work around the products
// (each warp splits its K and V fragments into tf32 big + small, each
// score takes an epilogue and an exp).
//
// Design (helpers in attention_tc.cuh and flash_tc.cuh): one CTA (4 warps
// x 16 query rows) per (64 query rows, head, batch row); the query rows
// staged once; K and V tiles, the [64 queries, keys] f32 bias tile and
// the key segment ids through a two-stage cp.async ring; scores in
// registers; every product 3xTF32 mma.sync.  Shared memory is the query
// tile and the ring, independent of S: 147,584 bytes at hd 256 (one CTA a
// multiprocessor), where the output's 128 accumulators a thread are most
// of the registers.

#include "flash_tc.cuh"

namespace {

using namespace tcattn;
using Ops = F32Ops;

// The query rows, then two ring stages.
template <int HDP>
__host__ __device__ constexpr int fwd_bytes() {
  return kRows * (HDP + 8) * 4 + 2 * flash::RowSlot<float, HDP>::kBytes;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ ab,
                 const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int s,
                 int nh, int hd, int chunk, float scale) {
  using L = flash::RowSlot<float, HDP>;
  constexpr int LD = L::LD, KT = L::KT, NT = KT / 8, DT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [64][LD] query rows
  unsigned char* ring = smem + kRows * LD * 4;

  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int q_a = q0 + r0 + g;  // this thread's rows: q_a, q_a + 8
  const long long bh = (long long)b * nh + head;
  const long long base = bh * s * hd;
  const float* abh = ab + (long long)head * s * s;
  const int* kvs = kv_seg + (long long)b * s;
  const int qs0 = q_seg[(long long)b * s + q_a];
  const int qs1 = q_seg[(long long)b * s + q_a + 8];

  if (hd != HDP) zero_smem(smem, fwd_bytes<HDP>(), tid);
  stage_rows<float, kRows>(qs, LD, q + base + (long long)q0 * hd, hd, kRows,
                           hd, chunk, tid);
  attn2::cp_async_commit();

  const int tiles = s / KT;
  auto slot = [&](int j) { return ring + (j & 1) * L::kBytes; };
  auto issue = [&](int j) {
    if (j < tiles)
      flash::stage_keys<float, HDP>(slot(j), k + base, v + base, abh, kvs, s,
                                    q0, j * KT, hd, chunk, tid);
    attn2::cp_async_commit();
  };
  issue(0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DT][4];
  zero(o);
  for (int j = 0; j < tiles; ++j) {
    attn2::cp_async_wait<0>();
    __syncthreads();
    issue(j + 1);
    const unsigned char* sl = slot(j);
    const float* ks = reinterpret_cast<const float*>(sl);
    float sc[NT][4];
    rows_by_rows<Ops, HDP, NT>(sc, qs, ks, LD, r0, lane);
    flash::score_rows(sc, reinterpret_cast<const float*>(sl + L::kBias),
                      L::LDB, reinterpret_cast<const int*>(sl + L::kSeg),
                      r0 + g, t, qs0, qs1, scale);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * h], sc[n][2 * h + 1]));
      const float m_next = fmaxf(m[h], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(__fsub_rn(sc[n][2 * h + c], m_next));
          sc[n][2 * h + c] = p;
          sum = __fadd_rn(sum, p);
        }
      const float l_corr = __fmul_rn(expf(__fsub_rn(m[h], m_next)), l[h]);
      const float l_next = __fadd_rn(quad_sum(sum), l_corr);
      const float inv = l_next == 0.f ? 1.f : __fdiv_rn(1.f, l_next);
      const float corr = __fmul_rn(l_corr, inv);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][2 * h] = __fmul_rn(o[n][2 * h], corr);
        o[n][2 * h + 1] = __fmul_rn(o[n][2 * h + 1], corr);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        sc[n][2 * h] = __fmul_rn(sc[n][2 * h], inv);
        sc[n][2 * h + 1] = __fmul_rn(sc[n][2 * h + 1], inv);
      }
      m[h] = m_next;
      l[h] = l_next;
    }
    mix<Ops, HDP, NT, false>(o, sc, ks + KT * LD, LD, lane);
  }

  if (m_out != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_out[bh * s + q_a + 8 * h] = m[h];
      l_out[bh * s + q_a + 8 * h] = l[h];
    }
  }
  float* oh = out + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = q_a + 8 * h;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < hd) oh[row * hd + col] = o[n][2 * h + c];
      }
  }
}

template <int HDP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* ab, const int* q_seg, const int* kv_seg,
                   float* out, float* m_out, float* l_out, int b, int nh,
                   int s, int hd, int chunk, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = fwd_bytes<HDP>();
  cudaError_t err = ring_smem(flash_f32_kernel<HDP>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(s / kRows, nh, b);
  flash_f32_kernel<HDP><<<grid, kThreads, bytes, stream>>>(
      q, k, v, ab, q_seg, kv_seg, out, m_out, l_out, s, nh, hd, chunk, scale);
  return cudaGetLastError();
}

template <int HDP>
int occupancy_hdp(int* bytes) {
  *bytes = fwd_bytes<HDP>();
  int ctas = 0;
  cudaError_t err = ring_smem(flash_f32_kernel<HDP>, *bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, flash_f32_kernel<HDP>, kThreads, *bytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

}  // namespace

// q, k, v, out: [b, nh, s, hd] f32; ab: [nh, s, s] f32; q_seg, kv_seg:
// [b, s] int32 (ab and the segment ids 16-byte aligned); m_out, l_out:
// [b, nh, s] f32, both null or neither.  Requires s % 128 == 0 and 1 <= hd
// <= 256.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, const void* ab,
                                   const void* q_seg, const void* kv_seg,
                                   void* out, void* m_out, void* l_out, int b,
                                   int nh, int s, int hd, float scale,
                                   void* stream) {
  if (hd < 1 || hd > flash::kFlashMaxHd || s < 128 || s % 128 || b < 1 ||
      nh < 1 || (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!flash::aligned16(ab) || !flash::aligned16(q_seg) ||
      !flash::aligned16(kv_seg))
    return (int)cudaErrorMisalignedAddress;
  const void* rows[] = {q, k, v};
  const int chunk = flash::row_chunk(hd, 4, rows, 3);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* af = static_cast<const float*>(ab);
  const auto* qs = static_cast<const int*>(q_seg);
  const auto* ks = static_cast<const int*>(kv_seg);
  auto* of = static_cast<float*>(out);
  auto* mo = static_cast<float*>(m_out);
  auto* lo = static_cast<float*>(l_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 16)
    return (int)launch<16>(qf, kf, vf, af, qs, ks, of, mo, lo, b, nh, s, hd,
                           chunk, scale, st);
  if (hd <= 32)
    return (int)launch<32>(qf, kf, vf, af, qs, ks, of, mo, lo, b, nh, s, hd,
                           chunk, scale, st);
  if (hd <= 64)
    return (int)launch<64>(qf, kf, vf, af, qs, ks, of, mo, lo, b, nh, s, hd,
                           chunk, scale, st);
  if (hd <= 128)
    return (int)launch<128>(qf, kf, vf, af, qs, ks, of, mo, lo, b, nh, s, hd,
                            chunk, scale, st);
  return (int)launch<256>(qf, kf, vf, af, qs, ks, of, mo, lo, b, nh, s, hd,
                          chunk, scale, st);
}

// CTAs a multiprocessor of the kernel for head size hd (a negative CUDA
// error code on failure), and its dynamic shared memory in *bytes; neither
// depends on s.
extern "C" int flash_attention_f32_occupancy(int hd, int* bytes) {
  *bytes = 0;
  if (hd < 1 || hd > flash::kFlashMaxHd) return -(int)cudaErrorInvalidValue;
  if (hd <= 16) return occupancy_hdp<16>(bytes);
  if (hd <= 32) return occupancy_hdp<32>(bytes);
  if (hd <= 64) return occupancy_hdp<64>(bytes);
  if (hd <= 128) return occupancy_hdp<128>(bytes);
  return occupancy_hdp<256>(bytes);
}

// The gradient of the encoder attention: dQ, dK, dV and the bias's
// gradient, for bf16 and f32 inputs (f32 math), in both layouts by strides
// ([B, S, H] with the heads split inside, [B, heads, S, hd]), any head size
// up to 128 and any S whose two score blocks fit in shared memory (S <=
// 1,472 at hd 128).
//
// Replaces no TPU kernel.  The JAX package trains through XLA's
// differentiation of its dense attention (tpu_search/models/mpnet.py:
// 276-281); the port's "dense" mode is its forward kernels
// (mpnet_attention.cu, mpnet_attention_bhsd.cu, mpnet_attention_f32.cu),
// which write their output outside autograd, so the gradient through them
// is a kernel too (ops/mpnet_attention.py, MPNetAttention).
//
// Contract, per head h (the forward's: s = q k^T * scale + bias + mask in
// f32, P its whole-row softmax in f32, P rounded to v's dtype before P V):
//   dV = P_r^T dO            with P_r the rounded P;
//   dP = dO V^T;
//   dS = P o (dP - rowsum(P o dP)), 0 on a row whose max is not finite
//        (the forward's uniform rows);
//   dQ = dS K * scale,  dK = dS^T Q * scale;
//   dBias[h] = sum over b of dS[b, h]; the key mask gets no gradient.
//
// What bounds it on the H100: at B 32, S 512, 12 heads of 26 (bf16) it
// reads q, k, v, dO and the bias and writes dQ, dK, dV and dBias (97 MB,
// 0.029 ms at 3.35 TB/s) for about 10 * B * heads * S^2 * hd flops with the
// scores recomputed (26 GFLOP, 0.026 ms at 989 TFLOP/s bf16): bytes, by a
// little (in f32, the operations: 0.39 ms at 67 TFLOP/s).
// This design is far from either: it runs every product as f32 FMAs on the
// CUDA cores from shared memory, and writes dS and P_r ([B, heads, S, S]
// f32 each) to a scratch the column pass and the bias pass read back.
//
// Design, one C call of three launches:
//   1. rows: one CTA of 256 threads per (16 query rows, head, batch row),
//      as mpnet_attention_f32.cu's: the 16 score rows whole in shared
//      memory (recomputed from q, k, the bias and the mask, so the forward
//      kernels save nothing), their softmax P, dP = dO V^T into a second
//      block of 16 rows, rowsum(P o dP) by a warp a row, dS; writes dS and
//      P_r to the scratch and dQ = dS K * scale from K tiles;
//   2. columns: one CTA per (64 keys, head, batch row) loops over the
//      query rows 32 at a time, reading its 64 columns of dS and P_r and
//      the rows of Q and dO: dK and dV, each thread one key and HDP / 4
//      columns of both;
//   3. bias: dBias[h, i, j] sums dS[b, h, i, j] over b in order, one thread
//      an element: deterministic, no atomics.

#include "attention_rows.cuh"

namespace {

using namespace rowattn;

constexpr int kColRows = 32;  // query rows a step of the column pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ bias,
                const float* __restrict__ kmask, T* __restrict__ dq,
                float* __restrict__ ds_out, float* __restrict__ p_out, int s,
                int nh, int hd, Strides st, float scale) {
  extern __shared__ float smem[];
  const int ld = hd | 1, sld = round_up(s, kKB);
  float* sc = smem;              // [kQB][sld] scores, P, then dS
  float* dp = sc + kQB * sld;    // [kQB][sld] dP
  float* rows = dp + kQB * sld;  // [kQB][ld] q rows, then dO rows
  float* tile = rows + kQB * ld; // [kKB][ld] a K or V tile
  __shared__ bool safe[kQB];
  const int q0 = blockIdx.x * kQB, head = blockIdx.y, b = blockIdx.z;
  const int nq = min(kQB, s - q0);
  const long long base = (long long)b * st.sb + (long long)head * st.sh;
  const long long row0 = (long long)q0 * st.ss;

  stage(rows, q + base + row0, kQB, nq, hd, ld, st.ss);
  dot_rows(sc, sld, rows, tile, k + base, s, nq, hd, ld, st.ss,
           bias + ((long long)head * s + q0) * s, kmask + (long long)b * s,
           scale);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nq; r += kThreads / 32) {
    const bool ok = softmax_row(sc + r * sld, s);
    if (lane == 0) safe[r] = ok;
  }
  // dot_rows' barrier came before the softmax, which reads no q row.
  stage(rows, dout + base + row0, kQB, nq, hd, ld, st.ss);
  dot_rows<T>(dp, sld, rows, tile, v + base, s, nq, hd, ld, st.ss, nullptr,
              nullptr, 1.f);
  float* ds_h = ds_out + ((long long)(b * nh + head) * s + q0) * s;
  float* p_h = p_out + ((long long)(b * nh + head) * s + q0) * s;
  for (int r = threadIdx.x >> 5; r < nq; r += kThreads / 32) {
    float* pr = sc + r * sld;
    const float* dpr = dp + r * sld;
    float dl = 0.f;
    for (int j = lane; j < s; j += 32) dl = fmaf(pr[j], dpr[j], dl);
    dl = warp_sum(dl);
    const bool ok = safe[r];
    for (int j = lane; j < s; j += 32) {
      const float p = pr[j];
      const float d = ok ? p * (dpr[j] - dl) : 0.f;
      ds_h[(long long)r * s + j] = d;
      p_h[(long long)r * s + j] = round_to<T>(p);
      pr[j] = d;
    }
  }
  mix_rows(dq + base + row0, sc, sld, tile, k + base, s, nq, hd, ld, st.ss,
           scale);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                const float* __restrict__ ds, const float* __restrict__ pr,
                T* __restrict__ dk, T* __restrict__ dv, int s, int nh,
                int hd, Strides st, float scale) {
  extern __shared__ float smem[];
  constexpr int ld = HDP + 1, NC = HDP / 4;
  float* dss = smem;                    // [kColRows][kKB] dS columns
  float* ps = dss + kColRows * kKB;     // [kColRows][kKB] P_r columns
  float* qt = ps + kColRows * kKB;      // [kColRows][ld] Q rows
  float* dot = qt + kColRows * ld;      // [kColRows][ld] dO rows
  const int k0 = blockIdx.x * kKB, head = blockIdx.y, b = blockIdx.z;
  const int j = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int nk = min(kKB, s - k0);
  const long long base = (long long)b * st.sb + (long long)head * st.sh;
  const float* ds_h = ds + (long long)(b * nh + head) * s * s;
  const float* p_h = pr + (long long)(b * nh + head) * s * s;
  float ak[NC], av[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) ak[m] = av[m] = 0.f;
  for (int i0 = 0; i0 < s; i0 += kColRows) {
    const int ni = min(kColRows, s - i0);
    __syncthreads();
    for (int e = threadIdx.x; e < kColRows * kKB; e += kThreads) {
      const int i = e / kKB, jj = e - i * kKB;
      const bool ok = i < ni && jj < nk;
      const long long at = (long long)(i0 + i) * s + k0 + jj;
      dss[e] = ok ? ds_h[at] : 0.f;
      ps[e] = ok ? p_h[at] : 0.f;
    }
    stage(qt, q + base + (long long)i0 * st.ss, kColRows, ni, hd, ld, st.ss);
    stage(dot, dout + base + (long long)i0 * st.ss, kColRows, ni, hd, ld,
          st.ss);
    __syncthreads();
    for (int i = 0; i < ni; ++i) {
      const float dsv = dss[i * kKB + j], pv = ps[i * kKB + j];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        // columns at or past hd read stale shared memory, never written
        ak[m] = fmaf(dsv, qt[i * ld + c + 4 * m], ak[m]);
        av[m] = fmaf(pv, dot[i * ld + c + 4 * m], av[m]);
      }
    }
  }
  if (j < nk) {
    const long long at = base + (long long)(k0 + j) * st.ss;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = c + 4 * m;
      if (d < hd) {
        dk[at + d] = from_f<T>(ak[m] * scale);
        dv[at + d] = from_f<T>(av[m]);
      }
    }
  }
}

__global__ void bias_grad_kernel(const float* __restrict__ ds,
                                 float* __restrict__ dbias, int b, int nh,
                                 long long ss2) {
  const long long n = (long long)nh * ss2;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long head = e / ss2, rem = e - head * ss2;
    float acc = 0.f;
    for (int bb = 0; bb < b; ++bb) acc += ds[((long long)bb * nh + head) * ss2 + rem];
    dbias[e] = acc;
  }
}

template <int HDP>
constexpr int cols_bytes() {
  return 4 * (2 * kColRows * kKB + 2 * kColRows * (HDP + 1));
}

template <typename T, int HDP>
cudaError_t launch_cols(const void* q, const void* dout, const float* ds,
                        const float* pr, void* dk, void* dv, int b, int nh,
                        int s, int hd, Strides st, float scale,
                        cudaStream_t stream) {
  auto kernel = bwd_cols_kernel<T, HDP>;
  constexpr int bytes = cols_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kKB - 1) / kKB, nh, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(dout), ds, pr,
      static_cast<T*>(dk), static_cast<T*>(dv), s, nh, hd, st, scale);
  return cudaGetLastError();
}

#define BWD_HDPS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* bias, const float* kmask,
                   void* dq, void* dk, void* dv, float* dbias, float* ds,
                   float* pr, int b, int nh, int s, int hd, Strides st,
                   float scale, cudaStream_t stream) {
  const long long bytes = row_pass_bytes(s, hd, 2);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((s + kQB - 1) / kQB, nh, b);
  bwd_rows_kernel<T><<<grid, kThreads, (size_t)bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), bias, kmask,
      static_cast<T*>(dq), ds, pr, s, nh, hd, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define BWD_COLS(HDP)                                                     \
  case HDP / 16:                                                          \
    err = launch_cols<T, HDP>(q, dout, ds, pr, dk, dv, b, nh, s, hd, st,  \
                              scale, stream);                             \
    break;
  switch ((hd + 15) / 16) {
    BWD_HDPS(BWD_COLS)
    default:
      return cudaErrorInvalidValue;
  }
#undef BWD_COLS
  if (err != cudaSuccess || dbias == nullptr) return err;
  const long long n = (long long)nh * s * s;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  bias_grad_kernel<<<blocks, 256, 0, stream>>>(ds, dbias, b, nh,
                                               (long long)s * s);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [bf16 when bf16 != 0, else f32] in the layout
// of (sb, sh, ss); bias [nh, s, s] f32; kmask [b, s] f32; dbias [nh, s, s]
// f32 or null (no bias gradient); ds, pr: scratch of b * nh * s * s f32
// each.  Requires 1 <= hd <= 128 and the row pass's shared memory within
// the card's 227 KB.
extern "C" int mpnet_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* bias, const void* kmask,
                                   void* dq, void* dk, void* dv, void* dbias,
                                   void* ds, void* pr, int b, int nh, int s,
                                   int hd, long long sb, long long sh,
                                   long long ss, int bf16, float scale,
                                   void* stream) {
  if (hd < 1 || hd > kMaxHd || s < 1 || b < 1 || nh < 1 ||
      row_pass_bytes(s, hd, 2) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const Strides st{sb, sh, ss};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  auto* bias_f = static_cast<const float*>(bias);
  auto* mask_f = static_cast<const float*>(kmask);
  auto* dbias_f = static_cast<float*>(dbias);
  auto* ds_f = static_cast<float*>(ds);
  auto* pr_f = static_cast<float*>(pr);
  if (bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, dout, bias_f, mask_f, dq, dk,
                                      dv, dbias_f, ds_f, pr_f, b, nh, s, hd,
                                      st, scale, stm);
  return (int)launch<float>(q, k, v, dout, bias_f, mask_f, dq, dk, dv,
                            dbias_f, ds_f, pr_f, b, nh, s, hd, st, scale,
                            stm);
}

// The dynamic shared memory (bytes) of the row pass at (s, hd); the card
// takes at most 232,448.
extern "C" long long mpnet_attention_bwd_smem_bytes(int s, int hd) {
  return row_pass_bytes(s, hd, 2);
}

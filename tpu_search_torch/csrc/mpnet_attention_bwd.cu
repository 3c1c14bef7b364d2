// The gradient of the encoder attention: dQ, dK, dV and the bias's
// gradient, for bf16 and f32 inputs (f32 math), in both layouts by strides
// ([B, S, H] with the heads split inside, [B, heads, S, hd]), any head size
// up to 128 and any S.
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
// What bounds it on the H100: at B 32, S 256, H 768 (12 heads of 64, bf16)
// it reads q, k, v, dO and the bias and writes dQ, dK, dV and dBias (94
// MB, 0.028 ms at 3.35 TB/s) for about 10 B heads S^2 hd flops with the
// scores recomputed (16 GFLOP, 0.016 ms at 989 TFLOP/s bf16): bytes.  This
// design runs 11 such products (the f32 dS as bf16 hi + lo counts twice),
// 35 GFLOP, on mma.sync, and writes the f32 dS ([B, heads, S, S], 101 MB
// there) for the bias's batch sum.  In f32 every product is 3xTF32 (three
// tf32 mma.sync): f32 FMAs would take the 10 products at 67 TFLOP/s (0.24
// ms there), 3xTF32 takes 30 at 495 TFLOP/s (0.10 ms) and keeps f32
// accuracy (2^-22 a product).  What paces it is neither: the per-score
// work on the CUDA cores (the epilogue, three exps a score over the two
// passes, the softmax statistics) and the latency of 4-warp CTAs at three
// or four a multiprocessor: the bias tile comes through the ring, steps
// are 32 rows above 64 bytes a row, and the mask is read from global
// memory, which lets the bf16 row pass hold four CTAs (PERF.md).
//
// Design, one C call of two launches (three with the bias's gradient);
// helpers in attention_tc.cuh.  Nothing of [S, S] lives in shared memory:
// scores, P, dP and dS stay in registers tile by tile, and every CTA's
// shared memory is a fixed ring, so S has no cap.
//   1. rows: one CTA (4 warps) per (64 query rows, head, batch row); q and
//      dO rows staged once, K and V tiles and the [64 queries, keys] bias
//      tile through a two-stage cp.async ring, 64 keys a step (32 where a
//      row holds more than 64 bytes).  Pass A, per key tile: s = q k^T,
//      dP = dO V^T, and online each row's max m, sum l of exp(s - m) and
//      d = sum exp(s - m) dP (rescaled as m grows), so D = d / l is the
//      f32 rowsum(P o dP); writes (m, l, 1 / l, D) a row.  Pass B, per key
//      tile: s, P from m and l (correctly rounded), dP, dS = P (dP - D),
//      the f32 dS to the scratch when the bias needs a gradient, dQ += dS K
//      with dS as bf16 hi + lo.
//   2. columns: one CTA per (64 keys, head, batch row): K and V staged
//      once, Q, dO, the row statistics and the bias tile through the ring:
//      s^T = K q^T, P^T from the statistics, dP^T = V dO^T, dS^T, then
//      dV += P_r^T dO and dK += dS^T Q (hi + lo) in registers.
//   3. bias: dBias[h, i, j] sums dS[b, h, i, j] over b in order, one thread
//      an element: deterministic, no atomics.
// No atomics anywhere: dQ is the row pass's own, dK and dV the column
// pass's.

#include "attention_tc.cuh"

namespace {

using namespace tcattn;

// The row pass's shared memory: q and dO rows, then two ring stages.
template <class Ops, int HDP>
__host__ __device__ constexpr int rows_bytes() {
  return 2 * kRows * (HDP + 8) * (int)sizeof(typename Ops::T) +
         2 * RowSlot<typename Ops::T, HDP>::kBytes;
}

// One stage of the column pass's ring: Q and dO tiles of QT queries, the
// rows' (m, l, 1 / l, D), and the f32 bias tile of those queries x the
// CTA's 64 keys, [query][key] with rows 68 apart (read transposed: a
// warp's reads of 8 keys x 4 queries hit distinct banks).
template <class Ops, int HDP>
struct ColSlot {
  static constexpr int LD = HDP + 8, QT = step_rows<typename Ops::T, HDP>(),
                       LDB = kRows + 4;
  static constexpr int kTile = QT * LD * (int)sizeof(typename Ops::T);
  static constexpr int kStats = 2 * kTile;  // byte offsets in the slot
  static constexpr int kBias = kStats + QT * 16;
  static constexpr int kBytes = kBias + QT * LDB * 4;
};

template <class Ops, int HDP>
__host__ __device__ constexpr int cols_bytes() {
  return 2 * kRows * (HDP + 8) * (int)sizeof(typename Ops::T) +
         2 * ColSlot<Ops, HDP>::kBytes;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *bias, *kmask;
  void *dq, *dk, *dv;
  float *ds, *stats;
  int s, nh, hd, chunk, vec4;
  Strides st;
  float scale;
};

template <class Ops, int HDP>
__global__ void __launch_bounds__(kThreads) bwd_rows(Args a) {
  using T = typename Ops::T;
  using L = RowSlot<T, HDP>;
  constexpr int LD = L::LD, KT = L::KT, NT = KT / 8, DT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [64][LD] q rows
  T* dos = qs + kRows * LD;            // [64][LD] dO rows
  unsigned char* ring = reinterpret_cast<unsigned char*>(dos + kRows * LD);

  const int s = a.s, hd = a.hd;
  const int q0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int q_a = q0 + r0 + g;  // this thread's rows: q_a, q_a + 8
  const long long base = (long long)b * a.st.sb + (long long)head * a.st.sh;
  const long long ss = a.st.ss;
  const T* kh = static_cast<const T*>(a.k) + base;
  const T* vh = static_cast<const T*>(a.v) + base;
  const float* bias = a.bias + (long long)head * s * s;
  const float* mask = a.kmask + (long long)b * s;

  if (hd != HDP) zero_smem(smem, rows_bytes<Ops, HDP>(), tid);
  const int nq = min(kRows, s - q0);
  stage_rows<T, kRows>(qs, LD, static_cast<const T*>(a.q) + base + q0 * ss,
                       ss, nq, hd, a.chunk, tid);
  stage_rows<T, kRows>(dos, LD,
                       static_cast<const T*>(a.dout) + base + q0 * ss, ss,
                       nq, hd, a.chunk, tid);
  attn2::cp_async_commit();

  // Step j stages key tile j % tiles: pass A, then pass B.
  const int tiles = (s + KT - 1) / KT, steps = 2 * tiles;
  auto slot = [&](int j) { return ring + (j & 1) * L::kBytes; };
  auto issue = [&](int j) {
    if (j < steps)
      stage_keys<T, HDP>(slot(j), kh, vh, bias, ss, s, q0, (j % tiles) * KT,
                         hd, a.chunk, a.vec4, tid);
    attn2::cp_async_commit();
  };
  auto arrive = [&](int j) {
    attn2::cp_async_wait<0>();
    __syncthreads();
    issue(j + 1);
  };
  // Step j's s = q k^T and dP = dO V^T, s finished with the bias and mask.
  auto products = [&](int j, float (&sc)[NT][4], float (&dp)[NT][4]) {
    const unsigned char* sl = slot(j);
    const T* ks = reinterpret_cast<const T*>(sl);
    rows_by_rows<Ops, HDP, NT>(sc, qs, ks, LD, r0, lane);
    rows_by_rows<Ops, HDP, NT>(dp, dos, ks + KT * LD, LD, r0, lane);
    const float* bt = reinterpret_cast<const float*>(sl + L::kBias);
    const int kb = (j % tiles) * KT;
    if (kb + KT > s || q0 + kRows > s || (s & 1))
      score_rows<true>(sc, bt, L::LDB, mask + kb, r0 + g, t, s - q0, s - kb,
                       a.scale);
    else
      score_rows<false>(sc, bt, L::LDB, mask + kb, r0 + g, t, 0, 0, a.scale);
  };
  issue(0);

  // Pass A: m, l and d = sum exp(s - m) dP, online.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    arrive(j);
    float sc[NT][4], dp[NT][4];
    products(j, sc, dp);
    online_rows(sc, dp, m, l, d);
  }
  bool safe[2];
  float rcp[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    d[h] = quad_sum(d[h]);
    safe[h] = isfinite(m[h]);
    rcp[h] = __frcp_rn(l[h]);
    dd[h] = safe[h] ? __fdiv_rn(d[h], l[h]) : 0.f;
    const int row = q_a + 8 * h;
    if (t == 0 && row < s)
      *reinterpret_cast<float4*>(
          a.stats + (((long long)b * a.nh + head) * s + row) * 4) =
          make_float4(m[h], l[h], rcp[h], dd[h]);
  }
  const float uniform = __fdiv_rn(1.f, (float)s);

  // Pass B: dS tile by tile, dQ += dS K.
  float dq[DT][4];
  zero(dq);
  float* ds_rows = a.ds == nullptr
                       ? nullptr
                       : a.ds + (((long long)b * a.nh + head) * s) * s;
  for (int j = tiles; j < steps; ++j) {
    arrive(j);
    const int kb = (j - tiles) * KT;
    float sc[NT][4], dp[NT][4];
    products(j, sc, dp);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = prob(sc[n][e], m[h], l[h], rcp[h], safe[h],
                             kb + 8 * n + 2 * t + (e & 1) < s, uniform);
        sc[n][e] = safe[h] ? __fmul_rn(p, __fsub_rn(dp[n][e], dd[h])) : 0.f;
      }
    if (ds_rows != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q_a + 8 * h;
        if (row >= s) continue;
        float* dst = ds_rows + (long long)row * s;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int key = kb + 8 * n + 2 * t;
          if ((s & 1) == 0 && key + 1 < s) {
            *reinterpret_cast<float2*>(dst + key) =
                make_float2(sc[n][2 * h], sc[n][2 * h + 1]);
          } else {
            if (key < s) dst[key] = sc[n][2 * h];
            if (key + 1 < s) dst[key + 1] = sc[n][2 * h + 1];
          }
        }
      }
    }
    mix<Ops, HDP, NT, true>(dq, sc, reinterpret_cast<const T*>(slot(j)), LD,
                            lane);
  }

  T* dqh = static_cast<T*>(a.dq) + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_a + 8 * h;
    if (row >= s) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < hd) dqh[row * ss + col] = from_f<T>(dq[n][2 * h] * a.scale);
      if (col + 1 < hd)
        dqh[row * ss + col + 1] = from_f<T>(dq[n][2 * h + 1] * a.scale);
    }
  }
}

template <class Ops, int HDP>
__global__ void __launch_bounds__(kThreads) bwd_cols(Args a) {
  using T = typename Ops::T;
  using L = ColSlot<Ops, HDP>;
  constexpr int LD = L::LD, QT = L::QT, NT = QT / 8, DT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [64][LD] the CTA's keys
  T* vs = ks + kRows * LD;             // [64][LD] their values
  unsigned char* ring = reinterpret_cast<unsigned char*>(vs + kRows * LD);

  const int s = a.s, hd = a.hd;
  const int k0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int k_a = k0 + r0 + g;  // this thread's keys: k_a, k_a + 8
  const long long base = (long long)b * a.st.sb + (long long)head * a.st.sh;
  const long long ss = a.st.ss;
  const T* qh = static_cast<const T*>(a.q) + base;
  const T* doh = static_cast<const T*>(a.dout) + base;
  const float* bias = a.bias + (long long)head * s * s + k0;
  const float* stats = a.stats + ((long long)b * a.nh + head) * s * 4;
  const float* mask = a.kmask + (long long)b * s;
  const float mk[2] = {k_a < s ? mask[k_a] : 0.f,
                       k_a + 8 < s ? mask[k_a + 8] : 0.f};

  if (hd != HDP) zero_smem(smem, cols_bytes<Ops, HDP>(), tid);
  const int nk = min(kRows, s - k0);
  stage_rows<T, kRows>(ks, LD, static_cast<const T*>(a.k) + base + k0 * ss,
                       ss, nk, hd, a.chunk, tid);
  stage_rows<T, kRows>(vs, LD, static_cast<const T*>(a.v) + base + k0 * ss,
                       ss, nk, hd, a.chunk, tid);
  attn2::cp_async_commit();

  const int tiles = (s + QT - 1) / QT;
  auto slot = [&](int j) { return ring + (j & 1) * L::kBytes; };
  auto issue = [&](int j) {
    if (j < tiles) {
      const int qb = j * QT, nq = min(QT, s - qb);
      unsigned char* sl = slot(j);
      T* qsl = reinterpret_cast<T*>(sl);
      stage_rows<T, QT>(qsl, LD, qh + qb * ss, ss, nq, hd, a.chunk, tid);
      stage_rows<T, QT>(qsl + QT * LD, LD, doh + qb * ss, ss, nq, hd,
                        a.chunk, tid);
      stage_f32<QT, 4>(reinterpret_cast<float*>(sl + L::kStats), 4,
                       stats + 4 * (long long)qb, 4, nq, 4, true, tid);
      stage_f32<QT, kRows>(reinterpret_cast<float*>(sl + L::kBias), L::LDB,
                           bias + (long long)qb * s, s, nq, nk, a.vec4, tid);
    }
    attn2::cp_async_commit();
  };
  issue(0);

  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);
  const float uniform = __fdiv_rn(1.f, (float)s);
  for (int j = 0; j < tiles; ++j) {
    attn2::cp_async_wait<0>();
    __syncthreads();
    issue(j + 1);
    const unsigned char* sl = slot(j);
    const T* qsl = reinterpret_cast<const T*>(sl);
    const T* dosl = qsl + QT * LD;
    const float* st = reinterpret_cast<const float*>(sl + L::kStats);
    const float* bt = reinterpret_cast<const float*>(sl + L::kBias);
    const int qb = j * QT;
    float sc[NT][4], dp[NT][4];
    rows_by_rows<Ops, HDP, NT>(sc, ks, qsl, LD, r0, lane);
    rows_by_rows<Ops, HDP, NT>(dp, vs, dosl, LD, r0, lane);
    if (qb + QT > s || k0 + kRows > s)
      score_cols<true>(sc, bt, L::LDB, mk, r0 + g, t, s - qb, s - k0,
                       a.scale);
    else
      score_cols<false>(sc, bt, L::LDB, mk, r0 + g, t, 0, 0, a.scale);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ql = 8 * n + 2 * t + c;
        const float4 r = *reinterpret_cast<const float4*>(st + 4 * ql);
        const bool q_in = qb + ql < s, safe = q_in && isfinite(r.x);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          const float p =
              q_in ? prob(sc[n][e], r.x, r.y, r.z, safe, k_a + 8 * h < s,
                          uniform)
                   : 0.f;
          sc[n][e] = p;
          dp[n][e] = safe ? __fmul_rn(p, __fsub_rn(dp[n][e], r.w)) : 0.f;
        }
      }
    mix<Ops, HDP, NT, false>(dv, sc, dosl, LD, lane);
    mix<Ops, HDP, NT, true>(dk, dp, qsl, LD, lane);
  }

  T* dkh = static_cast<T*>(a.dk) + base;
  T* dvh = static_cast<T*>(a.dv) + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k_a + 8 * h;
    if (key >= s) continue;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < hd) {
          dkh[key * ss + col] = from_f<T>(dk[n][2 * h + c] * a.scale);
          dvh[key * ss + col] = from_f<T>(dv[n][2 * h + c]);
        }
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

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, int bytes, dim3 grid, const Args& a,
                       cudaStream_t stream) {
  cudaError_t err = ring_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <class Ops, int HDP>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const dim3 grid((a.s + kRows - 1) / kRows, a.nh, b);
  cudaError_t err =
      launch_one(bwd_rows<Ops, HDP>, rows_bytes<Ops, HDP>(), grid, a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(bwd_cols<Ops, HDP>, cols_bytes<Ops, HDP>(), grid, a,
                    stream);
}

// Head sizes round up to 16, 32, 64 or 128.
template <class Ops>
cudaError_t launch_hd(const Args& a, int b, cudaStream_t stream) {
  if (a.hd <= 16) return launch<Ops, 16>(a, b, stream);
  if (a.hd <= 32) return launch<Ops, 32>(a, b, stream);
  if (a.hd <= 64) return launch<Ops, 64>(a, b, stream);
  return launch<Ops, 128>(a, b, stream);
}

bool aligned(const void* p, int chunk) {
  return reinterpret_cast<uintptr_t>(p) % chunk == 0;
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [bf16 when bf16 != 0, else f32] in the layout
// of (sb, sh, ss); bias [nh, s, s] f32; kmask [b, s] f32; dbias [nh, s, s]
// f32, and ds a scratch of b * nh * s * s f32, both null when the bias
// needs no gradient; stats a scratch of b * nh * s * 4 f32.  Requires
// 1 <= hd <= 128.
extern "C" int mpnet_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* bias, const void* kmask,
                                   void* dq, void* dk, void* dv, void* dbias,
                                   void* ds, void* stats, int b, int nh, int s,
                                   int hd, long long sb, long long sh,
                                   long long ss, int bf16, float scale,
                                   void* stream) {
  if (hd < 1 || hd > kMaxHd || s < 1 || b < 1 || nh < 1 ||
      (dbias == nullptr) != (ds == nullptr))
    return (int)cudaErrorInvalidValue;
  const int es = bf16 ? 2 : 4;
  int chunk = 16;
  while (chunk >= 4 &&
         ((hd * es) % chunk || (ss * es) % chunk || (sh * es) % chunk ||
          (sb * es) % chunk || !aligned(q, chunk) || !aligned(k, chunk) ||
          !aligned(v, chunk) || !aligned(dout, chunk)))
    chunk /= 2;
  if (chunk < 4) chunk = 0;
  // the bias and mask tiles copy 16 bytes at a time where rows allow
  const int vec4 = s % 4 == 0 && aligned(bias, 16) && aligned(kmask, 16);
  const Args a{q, k, v, dout, static_cast<const float*>(bias),
               static_cast<const float*>(kmask), dq, dk, dv,
               static_cast<float*>(ds), static_cast<float*>(stats), s, nh, hd,
               chunk, vec4, Strides{sb, sh, ss}, scale};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch_hd<Bf16Ops>(a, b, stm)
                         : launch_hd<F32Ops>(a, b, stm);
  if (err != cudaSuccess || dbias == nullptr) return (int)err;
  const long long n = (long long)nh * s * s;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  bias_grad_kernel<<<blocks, 256, 0, stm>>>(static_cast<const float*>(ds),
                                            static_cast<float*>(dbias), b, nh,
                                            (long long)s * s);
  return (int)cudaGetLastError();
}

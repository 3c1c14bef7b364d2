// The gradient of the stock flash attention of the JAX encoder's
// attention_impl="flash" mode: dQ, dK, dV and the bias's gradient, for
// bf16 and f32, over [B, heads, S, hd].
//
// Replaces: the VJP of jax.experimental.pallas.ops.tpu.flash_attention
// (_flash_attention_bwd) and its two kernels, _flash_attention_bwd_dkv (dK,
// dV) and _flash_attention_bwd_dq (dQ and dS, which is the bias's
// gradient), as jax.grad reaches them through tpu_search/models/mpnet.py
// :262-274 (operands :409-417), at the default block sizes (128), with no
// causal mask.
//
// Contract (ops/flash_attention.py flash_attention_bwd_plain; T the
// compute dtype of q, k, v, o, dO and ab; f32 math), per (batch row, head),
// from the forward's output o (in T) and its residuals m, l ([b, heads, s]
// f32):
//   di = rowsum(f32(o) f32(dO))       -- not rowsum(P o dP);
//   s  = (q k^T + ab) * scale + (q_seg == kv_seg ? 0 : -0.7 * FLT_MAX);
//   p  = exp(s - m) * (1 / l);
//   dV = T(p)^T dO;   dP = dO V^T;   dS = ((dP - di) * p) * scale;
//   dK = T(dS)^T q;   dQ = T(dS) K   -- in bf16 dS rounds once, before
//        both products (the stock kernel's rounding site); in f32 nothing
//        rounds;
//   dab[h] = T(sum over b of f32(T(dS[b, h]))): each batch row's dS in
//        ab's dtype, summed in f32 in batch order, rounded once (the
//        transpose of JAX's broadcast of one [heads, S, S] bias to every
//        batch row); the segment ids get no gradient.
// dQ, dK, dV come out in T.
//
// What bounds it on the H100: at B 128, S 384, H 768 (12 heads of 64,
// bf16) it reads q, k, v, o and dO and writes dQ, dK and dV (8 B S H 2 =
// 604 MB) plus ab and dab (7 MB): 0.18 ms at 3.35 TB/s.  Its five products
// of 2 B heads S^2 hd flops each (1.45e11) take 0.147 ms at 989 TFLOP/s
// bf16: bytes bound it.  This design writes each batch row's dS in T to
// a [B, heads, S, S] scratch and reads it back for the batch sum, which
// moves 2 B heads S^2 2 bytes more (0.91 GB there in bf16, 0.27 ms): a
// cost the bound does not count, paid only where ab needs a gradient.
// The row pass recomputes s and dP for dQ and the column pass again for
// dK and dV: seven products, not five.  In f32 every product is 3xTF32
// (three tf32 mma.sync at 495 TFLOP/s each), as attention_tc.cuh's F32Ops.
//
// Design, one C call of two launches (three with the bias's gradient), on
// mpnet_attention_bwd.cu's shape (helpers in attention_tc.cuh and
// flash_tc.cuh).  Nothing of [S, S] lives in shared memory: scores, P, dP
// and dS stay in registers tile by tile, and every CTA's shared memory is
// a fixed ring.  The forward's m and l make one pass enough in each.
//   1. rows: one CTA (4 warps x 16 rows) per (64 query rows, head, batch
//      row); q and dO rows staged once; di from o (global) and the staged
//      dO; (m, 1 / l, di) a row written for the column pass; K and V
//      tiles, the [64 queries, keys] bias tile and the key segment ids
//      through a two-stage cp.async ring, 64 keys a step (32 above 64
//      bytes a row).  Per key tile: s = q k^T, dP = dO V^T, p, dS; T(dS)
//      to the scratch when the bias needs a gradient; dQ += T(dS) K.
//   2. columns: one CTA per (64 keys, head, batch row): K and V staged
//      once; Q, dO, the rows' (m, 1 / l, di), the [queries, 64 keys] bias
//      tile and the query segment ids through the ring: s^T = K q^T, p^T,
//      dP^T = V dO^T, dS^T; dV += T(p)^T dO and dK += T(dS)^T Q in
//      registers.
//   3. bias: dab[h, i, j] sums the scratch over b in order, one thread a
//      pair of elements: deterministic, no atomics.
// No atomics anywhere: dQ is the row pass's own, dK and dV the column
// pass's.

#include "flash_tc.cuh"

namespace {

using namespace tcattn;

// The row pass's shared memory: q and dO rows, then two ring stages.
template <class Ops, int HDP>
__host__ __device__ constexpr int rows_bytes() {
  return 2 * kRows * (HDP + 8) * (int)sizeof(typename Ops::T) +
         2 * flash::RowSlot<typename Ops::T, HDP>::kBytes;
}

// One stage of the column pass's ring: Q and dO tiles of QT queries, the
// rows' (m, 1 / l, di, -), the bias tile of those queries x the CTA's 64
// keys ([query][key], rows LDB apart, read transposed) and the queries'
// segment ids; every part on a 16-byte boundary.
template <class Ops, int HDP>
struct ColSlot {
  using T = typename Ops::T;
  static constexpr int LD = HDP + 8, QT = step_rows<T, HDP>(),
                       LDB = kRows + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int kTile = QT * LD * (int)sizeof(T);
  static constexpr int kStats = 2 * kTile;  // byte offsets in the slot
  static constexpr int kBias = kStats + QT * 16;
  static constexpr int kSeg = kBias + QT * LDB * (int)sizeof(T);
  static constexpr int kBytes = kSeg + QT * 4;
};

template <class Ops, int HDP>
__host__ __device__ constexpr int cols_bytes() {
  return 2 * kRows * (HDP + 8) * (int)sizeof(typename Ops::T) +
         2 * ColSlot<Ops, HDP>::kBytes;
}

struct Args {
  const void *q, *k, *v, *o, *dout, *ab;
  const int *q_seg, *kv_seg;
  const float *m, *l;
  void *dq, *dk, *dv, *ds;
  float* stats;
  int s, nh, hd, chunk;
  float scale;
};

template <class Ops, int HDP>
__global__ void __launch_bounds__(kThreads) bwd_rows(Args a) {
  using T = typename Ops::T;
  using L = flash::RowSlot<T, HDP>;
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
  const long long bh = (long long)b * a.nh + head;
  const long long base = bh * s * hd;
  const T* kh = static_cast<const T*>(a.k) + base;
  const T* vh = static_cast<const T*>(a.v) + base;
  const T* abh = static_cast<const T*>(a.ab) + (long long)head * s * s;
  const int* kvs = a.kv_seg + (long long)b * s;
  const int qs0 = a.q_seg[(long long)b * s + q_a];
  const int qs1 = a.q_seg[(long long)b * s + q_a + 8];

  if (hd != HDP) zero_smem(smem, rows_bytes<Ops, HDP>(), tid);
  stage_rows<T, kRows>(qs, LD, static_cast<const T*>(a.q) + base + q0 * hd,
                       hd, kRows, hd, a.chunk, tid);
  stage_rows<T, kRows>(dos, LD,
                       static_cast<const T*>(a.dout) + base + q0 * hd, hd,
                       kRows, hd, a.chunk, tid);
  attn2::cp_async_commit();

  const int tiles = s / KT;
  auto slot = [&](int j) { return ring + (j & 1) * L::kBytes; };
  auto issue = [&](int j) {
    if (j < tiles)
      flash::stage_keys<T, HDP>(slot(j), kh, vh, abh, kvs, s, q0, j * KT, hd,
                                a.chunk, tid);
    attn2::cp_async_commit();
  };
  issue(0);

  // di from o (global) and the staged dO, each row's 4 threads summing
  // every 4th column; then (m, 1 / l, di) for the column pass.
  attn2::cp_async_wait<1>();  // the q and dO rows have landed
  __syncthreads();
  const T* oh = static_cast<const T*>(a.o) + base;
  float m[2], inv_l[2], di[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q_a + 8 * h;
    float acc = 0.f;
    for (int c = t; c < hd; c += 4)
      acc = __fadd_rn(acc, __fmul_rn(flash::to_f(oh[(long long)row * hd + c]),
                                     flash::to_f(dos[(r0 + g + 8 * h) * LD +
                                                     c])));
    di[h] = quad_sum(acc);
    m[h] = a.m[bh * s + row];
    inv_l[h] = __fdiv_rn(1.f, a.l[bh * s + row]);
    if (t == 0)
      *reinterpret_cast<float4*>(a.stats + (bh * s + row) * 4) =
          make_float4(m[h], inv_l[h], di[h], 0.f);
  }

  float dq[DT][4];
  zero(dq);
  T* ds_rows = a.ds == nullptr ? nullptr : static_cast<T*>(a.ds) + bh * s * s;
  for (int j = 0; j < tiles; ++j) {
    attn2::cp_async_wait<0>();
    __syncthreads();
    issue(j + 1);
    const unsigned char* sl = slot(j);
    const T* ks = reinterpret_cast<const T*>(sl);
    const int kb = j * KT;
    float sc[NT][4], dp[NT][4];
    rows_by_rows<Ops, HDP, NT>(sc, qs, ks, LD, r0, lane);
    rows_by_rows<Ops, HDP, NT>(dp, dos, ks + KT * LD, LD, r0, lane);
    flash::score_rows(sc, reinterpret_cast<const T*>(sl + L::kBias), L::LDB,
                      reinterpret_cast<const int*>(sl + L::kSeg), r0 + g, t,
                      qs0, qs1, a.scale);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p =
            __fmul_rn(expf(__fsub_rn(sc[n][e], m[h])), inv_l[h]);
        // dS, rounded to T: the value the products and the bias's
        // gradient take (in f32 the rounding is the identity)
        sc[n][e] = flash::to_f(from_f<T>(__fmul_rn(
            __fmul_rn(__fsub_rn(dp[n][e], di[h]), p), a.scale)));
      }
    if (ds_rows != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T* dst = ds_rows + (long long)(q_a + 8 * h) * s + kb;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          flash::store2(dst + 8 * n + 2 * t, sc[n][2 * h], sc[n][2 * h + 1]);
      }
    }
    mix<Ops, HDP, NT, false>(dq, sc, ks, LD, lane);
  }

  T* dqh = static_cast<T*>(a.dq) + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = q_a + 8 * h;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < hd) dqh[row * hd + col] = from_f<T>(dq[n][2 * h + c]);
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
  const long long bh = (long long)b * a.nh + head;
  const long long base = bh * s * hd;
  const T* qh = static_cast<const T*>(a.q) + base;
  const T* doh = static_cast<const T*>(a.dout) + base;
  const T* abh = static_cast<const T*>(a.ab) + (long long)head * s * s + k0;
  const float* stats = a.stats + bh * s * 4;
  const int* qsg = a.q_seg + (long long)b * s;
  const int kseg[2] = {a.kv_seg[(long long)b * s + k_a],
                       a.kv_seg[(long long)b * s + k_a + 8]};

  if (hd != HDP) zero_smem(smem, cols_bytes<Ops, HDP>(), tid);
  stage_rows<T, kRows>(ks, LD, static_cast<const T*>(a.k) + base + k0 * hd,
                       hd, kRows, hd, a.chunk, tid);
  stage_rows<T, kRows>(vs, LD, static_cast<const T*>(a.v) + base + k0 * hd,
                       hd, kRows, hd, a.chunk, tid);
  attn2::cp_async_commit();

  const int tiles = s / QT;
  auto slot = [&](int j) { return ring + (j & 1) * L::kBytes; };
  auto issue = [&](int j) {
    if (j < tiles) {
      const int qb = j * QT;
      unsigned char* sl = slot(j);
      T* qsl = reinterpret_cast<T*>(sl);
      stage_rows<T, QT>(qsl, LD, qh + (long long)qb * hd, hd, QT, hd,
                        a.chunk, tid);
      stage_rows<T, QT>(qsl + QT * LD, LD, doh + (long long)qb * hd, hd, QT,
                        hd, a.chunk, tid);
      flash::stage_tile<float, QT, 4>(
          reinterpret_cast<float*>(sl + L::kStats), 4,
          stats + 4 * (long long)qb, 4, tid);
      flash::stage_tile<T, QT, kRows>(reinterpret_cast<T*>(sl + L::kBias),
                                      L::LDB, abh + (long long)qb * s, s,
                                      tid);
      flash::stage_ints<QT>(reinterpret_cast<int*>(sl + L::kSeg), qsg + qb,
                            tid);
    }
    attn2::cp_async_commit();
  };
  issue(0);

  float dk[DT][4], dv[DT][4];
  zero(dk);
  zero(dv);
  for (int j = 0; j < tiles; ++j) {
    attn2::cp_async_wait<0>();
    __syncthreads();
    issue(j + 1);
    const unsigned char* sl = slot(j);
    const T* qsl = reinterpret_cast<const T*>(sl);
    const T* dosl = qsl + QT * LD;
    const float* st = reinterpret_cast<const float*>(sl + L::kStats);
    float sc[NT][4], dp[NT][4];
    rows_by_rows<Ops, HDP, NT>(sc, ks, qsl, LD, r0, lane);
    rows_by_rows<Ops, HDP, NT>(dp, vs, dosl, LD, r0, lane);
    flash::score_cols(sc, reinterpret_cast<const T*>(sl + L::kBias), L::LDB,
                      reinterpret_cast<const int*>(sl + L::kSeg), kseg,
                      r0 + g, t, a.scale);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 r = *reinterpret_cast<const float4*>(
            st + 4 * (8 * n + 2 * t + c));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          const float p = __fmul_rn(expf(__fsub_rn(sc[n][e], r.x)), r.y);
          sc[n][e] = p;
          dp[n][e] = __fmul_rn(__fmul_rn(__fsub_rn(dp[n][e], r.z), p),
                               a.scale);
        }
      }
    // T(p) for dV and T(dS) for dK: mix rounds its operand to T
    mix<Ops, HDP, NT, false>(dv, sc, dosl, LD, lane);
    mix<Ops, HDP, NT, false>(dk, dp, qsl, LD, lane);
  }

  T* dkh = static_cast<T*>(a.dk) + base;
  T* dvh = static_cast<T*>(a.dv) + base;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long key = k_a + 8 * h;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * n + 2 * t + c;
        if (col < hd) {
          dkh[key * hd + col] = from_f<T>(dk[n][2 * h + c]);
          dvh[key * hd + col] = from_f<T>(dv[n][2 * h + c]);
        }
      }
  }
}

// dab[e] = T(sum over b, in order, of f32(ds[b][e])), a pair of adjacent
// elements a thread.
template <typename T>
__global__ void bias_grad_kernel(const T* __restrict__ ds,
                                 T* __restrict__ dab, int b,
                                 long long n) {
  for (long long e = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
       e < n; e += 2 * (long long)gridDim.x * blockDim.x) {
    float x = 0.f, y = 0.f;
    for (int bb = 0; bb < b; ++bb) {
      const float2 v = flash::load2(ds + (long long)bb * n + e);
      x = __fadd_rn(x, v.x);
      y = __fadd_rn(y, v.y);
    }
    flash::store2(dab + e, x, y);
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
  const dim3 grid(a.s / kRows, a.nh, b);
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

template <class Ops, int HDP>
int occupancy(int pass, int* bytes) {
  *bytes = pass ? cols_bytes<Ops, HDP>() : rows_bytes<Ops, HDP>();
  int ctas = 0;
  cudaError_t err =
      pass ? ring_smem(bwd_cols<Ops, HDP>, *bytes)
           : ring_smem(bwd_rows<Ops, HDP>, *bytes);
  if (err == cudaSuccess)
    err = pass ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &ctas, bwd_cols<Ops, HDP>, kThreads, *bytes)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &ctas, bwd_rows<Ops, HDP>, kThreads, *bytes);
  return err == cudaSuccess ? ctas : -(int)err;
}

template <class Ops>
int occupancy_hd(int hd, int pass, int* bytes) {
  if (hd <= 16) return occupancy<Ops, 16>(pass, bytes);
  if (hd <= 32) return occupancy<Ops, 32>(pass, bytes);
  if (hd <= 64) return occupancy<Ops, 64>(pass, bytes);
  return occupancy<Ops, 128>(pass, bytes);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: [b, nh, s, hd], ab and dab: [nh, s, s], ds
// a scratch of b * nh * s * s, all bf16 when bf16 != 0, else f32; q_seg,
// kv_seg: [b, s] int32; m, l: [b, nh, s] f32 (the forward's residuals);
// stats a scratch of b * nh * s * 4 f32.  dab and ds are both null when
// the bias needs no gradient.  ab, the segment ids and the stats 16-byte
// aligned.  Requires s % 128 == 0 and 1 <= hd <= 128.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* ab, const void* q_seg, const void* kv_seg,
    const void* m, const void* l, void* dq, void* dk, void* dv, void* dab,
    void* ds, void* stats, int b, int nh, int s, int hd, int bf16,
    float scale, void* stream) {
  if (hd < 1 || hd > kMaxHd || s < 128 || s % 128 || b < 1 || nh < 1 ||
      (dab == nullptr) != (ds == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!flash::aligned16(ab) || !flash::aligned16(q_seg) ||
      !flash::aligned16(kv_seg) || !flash::aligned16(stats))
    return (int)cudaErrorMisalignedAddress;
  const int es = bf16 ? 2 : 4;
  const void* rows[] = {q, k, v, dout};
  const Args a{q, k, v, o, dout, ab, static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg), static_cast<const float*>(m),
               static_cast<const float*>(l), dq, dk, dv, ds,
               static_cast<float*>(stats), s, nh, hd,
               flash::row_chunk(hd, es, rows, 4), scale};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch_hd<Bf16Ops>(a, b, stm)
                         : launch_hd<F32Ops>(a, b, stm);
  if (err != cudaSuccess || dab == nullptr) return (int)err;
  const long long n = (long long)nh * s * s;
  const long long want = (n / 2 + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (bf16)
    bias_grad_kernel<<<blocks, 256, 0, stm>>>(
        static_cast<const __nv_bfloat16*>(ds),
        static_cast<__nv_bfloat16*>(dab), b, n);
  else
    bias_grad_kernel<<<blocks, 256, 0, stm>>>(static_cast<const float*>(ds),
                                              static_cast<float*>(dab), b, n);
  return (int)cudaGetLastError();
}

// CTAs a multiprocessor of the row pass (pass 0) or the column pass (pass
// 1) for head size hd in bf16 (bf16 != 0) or f32 (a negative CUDA error
// code on failure), and its dynamic shared memory in *bytes; neither
// depends on s.
extern "C" int flash_attention_bwd_occupancy(int hd, int bf16, int pass,
                                             int* bytes) {
  *bytes = 0;
  if (hd < 1 || hd > kMaxHd) return -(int)cudaErrorInvalidValue;
  return bf16 ? occupancy_hd<Bf16Ops>(hd, pass, bytes)
              : occupancy_hd<F32Ops>(hd, pass, bytes);
}

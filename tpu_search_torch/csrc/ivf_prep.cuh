// The prologue of the ring-fed scans: one launch that writes everything
// the scan reads besides the corpus, which the JAX package computes in XLA
// around pl.pallas_call (tpu_search/index/ivf.py _ivf_search_pallas_impl,
// ops/pallas_ivf_scan.py build_probe_schedule, ops/topk_scan.py
// quantize_queries).  Its plain twins are ops/ivf_scan.py
// ivf_digit_prep_plain (the int8 / int4 IVF scans) and ivf_float_prep_plain
// (the bf16 / f32 IVF scan), composed of build_probe_schedule,
// probe_positions, quantize_queries, query_nibble_offsets and _bias_pre,
// and ops/flat_topk_int4.py flat_digit_prep_plain (the flat int4 scan:
// the digits alone, digit_prep below), and ops/flat_topk.py
// flat_float_prep_plain (the flat bf16 / f32 scan: float_prep below, the
// bf16 cast alone); the kernels match them bit for bit.
//
// ivf_prep, one CTA a query block (the scan's QB queries), each writing:
//  - with digits set, the query digits (prep_digits, a warp a query), bit
//    for bit as quantize_queries: qs1 = max(max|x| * f32(1/127), 1e-12),
//    q1 = rint(x / qs1) (true quotient, ties to even), the residual one
//    fma(-qs1, q1, x), qs2 and q2 alike, rho = qs2 / qs1; digits [2Q, D]
//    int8 (q1 rows first), rho [Q], qs1 [Q], and with qoff set the nibble
//    offsets 8 * sum(digit) [2Q] int32;
//  - with qcast set (bf16 blocks, no digits), the queries rounded to bf16
//    (__float2bfloat16_rn, as Tensor.to(torch.bfloat16)) [Q, D];
//  - table [Q, nlist] f32: cbias[q, p] / qs1[q] (a true quotient; 0 without
//    cbias) at the cluster of q's probe p, -inf where q does not probe the
//    cluster (the membership and bias the scan adds);
//  - the schedule, computed by every CTA from the probes of all queries: a
//    bitmap of the probed clusters in shared memory, then clusters in
//    ascending order in passes of 1024 with a block scan of their tiles
//    (cdiv(fills[c], 128)).  CTA 0 writes tile_idx / clusters [n_sched] and
//    n_sched (build_probe_schedule's entries j < n_sched);
//  - the block's member list: the entries (tile, j) of the clusters that
//    one of its queries probes, ascending in j, and its length mem_count;
//  - zeros in the merge's counters.
// Shared memory: two bitmaps of nlist bits (8 KB at nlist 32,768).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPrepThreads = 256;
constexpr int kPrepItems = 4;  // consecutive clusters a thread per pass
constexpr int kPrepSpan = kPrepThreads * kPrepItems;
constexpr int kPrepTile = 128;  // rows a schedule entry
constexpr unsigned kPrepMask = 0xffffffffu;

struct PrepArgs {
  const float* queries;  // [q, d] f32
  const int* probe;      // [q, nprobe]
  const int* fills;      // [nlist]
  const float* cbias;    // [q, nprobe] or null
  int q, d, nlist, nprobe, tpc, max_sched, qb;
  int8_t* digits;  // [2q, d], or null: no digits (qb <= 32 with digits)
  float* rho;      // [q]
  float* qs1;      // [q]
  int* qoff;       // [2q] or null
  float* table;    // [q, nlist]
  int* tile_idx;   // [max_sched + 1]
  int* clusters;   // [max_sched + 1]
  int* n_sched;    // [1]
  int2* mem;       // [cdiv(q, qb), max_sched]: (tile, j)
  int* mem_count;  // [cdiv(q, qb)]
  int* merge_count;  // [q]: the merge's finished groups, zeroed here
  __nv_bfloat16* qcast;  // [q, d] or null
};

__device__ __forceinline__ float prep_warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kPrepMask, v, o));
  return v;
}

__device__ __forceinline__ int prep_warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kPrepMask, v, o);
  return v;
}

// max(amax * f32(1/127), 1e-12), as absmax_scales computes it.
__device__ __forceinline__ float prep_scale(float amax) {
  return fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
}

// Exclusive block scan of two counts; totals in *tot.  Every thread calls.
__device__ int2 prep_scan2(int a, int b, int2* warp_part, int2* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ua = __shfl_up_sync(kPrepMask, ia, o);
    const int ub = __shfl_up_sync(kPrepMask, ib, o);
    if (lane >= o) {
      ia += ua;
      ib += ub;
    }
  }
  if (lane == 31) warp_part[warp] = make_int2(ia, ib);
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kPrepThreads / 32;
    int2 v = lane < kWarps ? warp_part[lane] : make_int2(0, 0);
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int ua = __shfl_up_sync(kPrepMask, v.x, o);
      const int ub = __shfl_up_sync(kPrepMask, v.y, o);
      if (lane >= o) {
        v.x += ua;
        v.y += ub;
      }
    }
    if (lane < kWarps) warp_part[lane] = v;
  }
  __syncthreads();
  const int2 before = warp ? warp_part[warp - 1] : make_int2(0, 0);
  *tot = warp_part[kPrepThreads / 32 - 1];
  __syncthreads();  // warp_part is reused by the next call
  return make_int2(before.x + ia - a, before.y + ib - b);
}

// Query qi's digits, rho, qs1 and (qoff set) nibble offsets; returns qs1.
// A warp calls, every lane.
__device__ float prep_digits(const float* __restrict__ queries, int q, int d,
                             int qi, int8_t* digits, float* rho, float* qs1,
                             int* qoff) {
  const int lane = threadIdx.x & 31;
  const float* x = queries + (size_t)qi * d;
  float amax = 0.f;
  for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(x[c]));
  const float s1 = prep_scale(prep_warp_max(amax));
  float amax2 = 0.f;
  int sum1 = 0;
  for (int c = lane; c < d; c += 32) {
    const int d1 = __float2int_rn(__fdiv_rn(x[c], s1));
    amax2 = fmaxf(amax2, fabsf(__fmaf_rn(-s1, (float)d1, x[c])));
    sum1 += d1;
    digits[(size_t)qi * d + c] = (int8_t)d1;
  }
  const float s2 = prep_scale(prep_warp_max(amax2));
  int sum2 = 0;
  for (int c = lane; c < d; c += 32) {
    const int d1 = __float2int_rn(__fdiv_rn(x[c], s1));
    const float r = __fmaf_rn(-s1, (float)d1, x[c]);
    const int d2 = __float2int_rn(__fdiv_rn(r, s2));
    sum2 += d2;
    digits[(size_t)(q + qi) * d + c] = (int8_t)d2;
  }
  sum1 = prep_warp_sum(sum1);
  sum2 = prep_warp_sum(sum2);
  if (lane == 0) {
    rho[qi] = __fdiv_rn(s2, s1);
    qs1[qi] = s1;
    if (qoff) {
      qoff[qi] = 8 * sum1;
      qoff[q + qi] = 8 * sum2;
    }
  }
  return s1;
}

__global__ void __launch_bounds__(kPrepThreads) ivf_prep(PrepArgs a) {
  extern __shared__ __align__(16) uint32_t prep_bits[];
  __shared__ float s1_of[32];
  __shared__ int2 warp_part[kPrepThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int words = (a.nlist + 31) / 32;
  uint32_t* probed = prep_bits;       // clusters any query probes
  uint32_t* mine = prep_bits + words;  // clusters a query of this block probes
  const int blk = blockIdx.x, q0 = blk * a.qb, q1 = min(a.q, q0 + a.qb);

  for (int i = tid; i < 2 * words; i += kPrepThreads) prep_bits[i] = 0;

  if (a.digits) {  // a warp a query
    for (int qi = q0 + warp; qi < q1; qi += kPrepThreads / 32) {
      const float s1 = prep_digits(a.queries, a.q, a.d, qi, a.digits, a.rho,
                                   a.qs1, a.qoff);
      if (lane == 0) s1_of[qi - q0] = s1;
    }
  } else if (a.qcast) {
    for (int i = tid; i < (q1 - q0) * a.d; i += kPrepThreads) {
      const size_t at = (size_t)q0 * a.d + i;
      a.qcast[at] = __float2bfloat16_rn(a.queries[at]);
    }
  }

  // The block's rows of the table: -inf, then each probe's bias in probe
  // order (a cluster probed twice keeps its last position, as scatter_).
  for (int qi = q0; qi < q1; ++qi)
    for (int c = tid; c < a.nlist; c += kPrepThreads)
      a.table[(size_t)qi * a.nlist + c] = -INFINITY;
  __syncthreads();
  if (tid < q1 - q0) {
    const int qi = q0 + tid;
    a.merge_count[qi] = 0;
    for (int p = 0; p < a.nprobe; ++p) {
      const int c = a.probe[(size_t)qi * a.nprobe + p];
      a.table[(size_t)qi * a.nlist + c] =
          a.cbias ? __fdiv_rn(a.cbias[(size_t)qi * a.nprobe + p], s1_of[tid])
                  : 0.f;
    }
  }
  const int n_probes = a.q * a.nprobe;
  for (int i = tid; i < n_probes; i += kPrepThreads) {
    const int c = a.probe[i];
    atomicOr(&probed[c >> 5], 1u << (c & 31));
    const int qi = i / a.nprobe;
    if (qi >= q0 && qi < q1) atomicOr(&mine[c >> 5], 1u << (c & 31));
  }
  __syncthreads();

  // The schedule and the member list, clusters ascending.
  int carry_t = 0, carry_m = 0;
  int2* mem = a.mem + (size_t)blk * a.max_sched;
  for (int c0 = 0; c0 < a.nlist; c0 += kPrepSpan) {
    int tiles[kPrepItems];
    bool member[kPrepItems];
    int sum_t = 0, sum_m = 0;
#pragma unroll
    for (int i = 0; i < kPrepItems; ++i) {
      const int c = c0 + tid * kPrepItems + i;
      const bool hit = c < a.nlist && (probed[c >> 5] >> (c & 31)) & 1u;
      tiles[i] = hit ? (a.fills[c] + kPrepTile - 1) / kPrepTile : 0;
      member[i] = hit && (mine[c >> 5] >> (c & 31)) & 1u;
      sum_t += tiles[i];
      sum_m += member[i] ? tiles[i] : 0;
    }
    int2 tot;
    const int2 ex = prep_scan2(sum_t, sum_m, warp_part, &tot);
    int jt = carry_t + ex.x, jm = carry_m + ex.y;
#pragma unroll
    for (int i = 0; i < kPrepItems; ++i) {
      const int c = c0 + tid * kPrepItems + i;
      for (int w = 0; w < tiles[i]; ++w) {
        const int tile = c * a.tpc + w;
        if (blk == 0) {
          a.tile_idx[jt + w] = tile;
          a.clusters[jt + w] = c;
        }
        if (member[i]) mem[jm + w] = make_int2(tile, jt + w);
      }
      jt += tiles[i];
      jm += member[i] ? tiles[i] : 0;
    }
    carry_t += tot.x;
    carry_m += tot.y;
  }
  if (tid == 0) {
    a.mem_count[blk] = carry_m;
    if (blk == 0) *a.n_sched = carry_t;
  }
}

// The flat int4 scan's prologue: a warp a query writes its digits, rho,
// qs1 and nibble offsets (prep_digits) and zeroes its merge counter.
__global__ void __launch_bounds__(kPrepThreads)
digit_prep(const float* __restrict__ queries, int q, int d, int8_t* digits,
           float* rho, float* qs1, int* qoff, int* merge_count) {
  const int qi = blockIdx.x * (kPrepThreads / 32) + (threadIdx.x >> 5);
  if (qi >= q) return;
  prep_digits(queries, q, d, qi, digits, rho, qs1, qoff);
  if ((threadIdx.x & 31) == 0) merge_count[qi] = 0;
}

// The flat bf16 / f32 scan's prologue: with qcast set (bf16 rows) the
// queries rounded to bf16 (__float2bfloat16_rn, as Tensor.to(torch.bfloat16))
// [q, d], and zeros in the merge's counters.  A thread four elements.
__global__ void __launch_bounds__(kPrepThreads)
float_prep(const float4* __restrict__ queries, int q, int d4,
           __nv_bfloat162* qcast, int* merge_count) {
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  if (i < q) merge_count[i] = 0;
  if (!qcast || i >= q * d4) return;
  const float4 v = queries[i];
  qcast[2 * i] = __floats2bfloat162_rn(v.x, v.y);
  qcast[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
}

// d % 4 == 0; qcast null: the counters alone.
inline cudaError_t launch_float_prep(const float* queries, int q, int d,
                                     __nv_bfloat16* qcast, int* merge_count,
                                     cudaStream_t stream) {
  const int cast = qcast ? q * (d / 4) : 0;
  const int items = cast > q ? cast : q;
  float_prep<<<(items + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0,
               stream>>>(reinterpret_cast<const float4*>(queries), q, d / 4,
                         reinterpret_cast<__nv_bfloat162*>(qcast),
                         merge_count);
  return cudaGetLastError();
}

inline cudaError_t launch_digit_prep(const float* queries, int q, int d,
                                     int8_t* digits, float* rho, float* qs1,
                                     int* qoff, int* merge_count,
                                     cudaStream_t stream) {
  constexpr int kWarps = kPrepThreads / 32;
  digit_prep<<<(q + kWarps - 1) / kWarps, kPrepThreads, 0, stream>>>(
      queries, q, d, digits, rho, qs1, qoff, merge_count);
  return cudaGetLastError();
}

// Launch the prologue: one CTA a block of qb queries (qb <= 32 with
// digits).
inline cudaError_t launch_ivf_prep(const PrepArgs& a, cudaStream_t stream) {
  const size_t bytes = (size_t)2 * ((a.nlist + 31) / 32) * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_prep, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  ivf_prep<<<(a.q + a.qb - 1) / a.qb, kPrepThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The post-attention half of an encoder layer with a W8A8 FFN:
// LN1 -> int8 quantize -> GEMM1 -> gelu -> int8 requantize -> GEMM2 ->
// residual -> LN2.
//
// Replaces: tpu_search/ops/pallas_int8_gemm.py, int8_ffn_ln_fused (kernel
// body _ffn_ln_fused_kernel), run by every encoder layer when the int8 FFN
// is on.
//
// Contract, with every rounding site of the TPU kernel mirrored:
//   x   = LN1(pre) with f32 statistics, then rounded to bf16 (:372);
//   x_q = clip(rint(x * (127 / amax_x)), +-127)  -- multiply, not divide
//         (:375-376), round half to even (rintf), zero rows quantize to 0;
//   sx  = amax_x * f32(1/127) (:379, ``amax / 127.0`` under jit);
//   y   = fma(acc1 * sx, s1, b1) with acc1 = x_q . W1 exact in int32 (one
//         rounding for the scale and the bias: XLA contracts them into an
//         FMA, which the kernel run in interpret mode shows on planted
//         inputs, tests/test_torch_int8_ffn.py);
//   h   = tanh-gelu(y);
//   h_q = clip(rint(h * (127 / amax_h)), +-127) with amax_h over the whole
//         I-wide row (:391-392);
//   ff  = fma(acc2 * scale_h, s2, b2) + x, scale_h = amax_h * f32(1/127),
//         rounded to bf16 (:407);
//   out = bf16(LN2(ff)).
// Weights arrive per-output-column quantized ([out, in] int8 rows: K-major,
// as wgmma's int8 operands must be) with f32 column scales; biases and LN
// parameters arrive as f32 copies of their bf16 values.
//
// Widths: H a multiple of 8 up to 1,024 and I a multiple of 8 up to 4,096
// (the BERT family up to large, TinyBERT-312).  The row passes are built
// for HP, H rounded up to a multiple of 128 (H / 32 values a lane in
// registers); the LayerNorm statistics run over the true H.
//
// What bounds it on the H100: at M = 128*384 rows the two GEMMs are
// 4*M*H*I = 464 G int8 ops per layer (0.23 ms at 1,979 TOP/s) against
// ~0.2 GB of input, output and weights.  The requantize needs amax over the
// whole I-wide gelu row before GEMM2 can start, and a 128-row block of the
// [M, I] f32 activation (1.5 MB at I 3,072) fits in no multiprocessor, so
// h goes through device memory once: 0.6 GB written, read, and 0.15 GB of
// int8 codes, the largest stream of the layer.
//
// Design: one C call, five launches on the caller's stream.
//  1. ln1_quant, a warp a row: LN1, the bf16 residual x, x_q and sx; it
//     zeroes the row's amax_h word for GEMM1.
//  2. GEMM1 on the wgmma loop of int8_wgmma.cuh (128 x 128 tiles, two
//     producer warps, two CTAs a multiprocessor so that one's gelu
//     epilogue overlaps the other's products): dequant + gelu -> h f32,
//     and the row |h| maxima of the tile folded into amax_h with atomicMax
//     on the float bits (non-negative floats order like their bit
//     patterns; every column tile of a row meets in the same word).
//  3. h_quant, elementwise: h_q = quant(h, 127 / amax_h) as int8 rows.
//  4. GEMM2 on the same loop and tile: ff = bf16(fma(acc2 * scale_h, s2,
//     b2) + x), written over x in place (each element is read and written
//     by the same thread).  The 128 x 256 tile fed by a producer warpgroup
//     (int8_gemm.cu's plain-epilogue tile) read 18-25 % slower at every M
//     from 512 to 49,152 with this residual epilogue, so one tile serves.
//  5. ln2, a warp a row: LN2 with f32 statistics in a fixed order (no
//     float atomics) -> out.
// LN1 and the quantize run once a row (not once a column tile), the
// products are wgmma's, and every large operand streams through cp.async.
// Each kernel's shared-memory attributes are set once a process, so a
// query's small M pays five launches and little else on the host.
//
// The same launches serve a second export, int8_ffn_fused: the W8A8 FFN
// without its LayerNorms, y = gelu(fma(acc1 * sx, s1, b1)) in f32, h_q =
// quant(y, 127 / amax) with amax over the whole I-wide f32 row, out =
// fma(acc2 * scale_h, s2, b2) + res, res and out bf16 or f32.  It replaces
// tpu_search/ops/pallas_int8_gemm.py, int8_ffn_fused (:578, kernel body
// _ffn_fused_kernel :500-554), whose [M, I] activation never leaves VMEM:
// that is a property of the TPU's design, not of the function.  Here the
// whole-row amax needs every I column before GEMM2, a 128-row block of f32
// y is 1.5 MB, and keeping h_q on chip costs one CTA a multiprocessor or a
// second GEMM1 (a kernel that did both, mma.sync products, read 6.57 ms at
// M 49,152, H 768, I 3,072 on an H100), so y takes the device-memory route
// of steps 2-4: one C call of four steps on the caller's stream (amax_h
// zeroed by cudaMemsetAsync, GEMM1, h_quant, GEMM2 with a residual and an
// output of either type).  Bound at that shape: the two GEMMs, 0.234 ms.
//
// Two more exports serve the FFN split in two calls, the pair of the JAX
// package's int8_ffn_in (:158, kernel body _ffn_in_kernel :123-154) and
// int8_ffn_out (:275, kernel body _ffn_out_kernel :228-254):
//  - int8_ffn_in: amax zeroed by cudaMemsetAsync, then GEMM1 with h of
//    either type: y = gelu(fma(acc * sx, sw, b)), h = y cast, amax[m] =
//    max_n |y| over the f32 y before the cast (:142, :146: a maximum over
//    the bf16-rounded h can round up and move int8_ffn_out's codes).  Any
//    widths the wrappers take (K and N multiples of 8): the caps above
//    belong to the row passes.  Bound: the products, 0.117 ms at M 49,152,
//    K 768, N 3,072.
//  - int8_ffn_out: h_q = clip(rint(h * (127 / amax))) per row (0 where
//    amax is 0), y = fma(acc * scale, sw, b) + res with scale = amax *
//    f32(1/127) (1 where amax is 0), h, res and y bf16 or f32.  The JAX
//    kernel quantizes h inside the product, so the int8 copy of h never
//    exists in device memory, and so does ffn_out_cq here: each consumer
//    warpgroup stages its 64 rows of h by cp.async, quantizes them into
//    its rows of the ring's A tile in the swizzled layout while the tensor
//    cores run the chunk before, and fences them for the async proxy
//    before its wgmma reads them; a producer warpgroup streams w.  Bound:
//    the bytes of h, 0.136 ms at M 49,152, K 3,072, N 768 (bf16), against
//    0.117 ms of products.  A CTA owns a 128 x 256 tile (one a
//    multiprocessor), so each 128-row block of h is quantized N / 256
//    times, by column CTAs that run side by side and find it in L2.  A
//    producer warpgroup that loaded and quantized h itself could not fit
//    a chunk's quantize in a chunk's product time (0.58 ms against 0.49
//    at that shape on an H100), nor did h_quant then GEMM2 (two
//    launches, h_q through device memory: 0.54 ms).

#include "int8_wgmma.cuh"

namespace {

constexpr int kMaxH = 1024, kMaxI = 4096;
constexpr int kRowWarps = 8;  // rows (one a warp) of a row-pass CTA
constexpr int kBN = 128, kP = 64;  // GEMM tile columns, producer threads
using Tile = WgTile<kBN, kP>;

// ---------------------------------------------------------------------------
// 1. LN1 + bf16 round + per-row quantize -> xres [M, H] bf16, x_q [M, H]
// int8, sx [M] f32; amax_h [M] zeroed for GEMM1's maxima.
// ---------------------------------------------------------------------------
template <int HP>
__global__ void __launch_bounds__(kRowWarps * 32)
ln1_quant(const __nv_bfloat16* __restrict__ pre,
          const float* __restrict__ ln_s, const float* __restrict__ ln_b,
          float eps, int m_rows, int h, __nv_bfloat16* __restrict__ xres,
          int8_t* __restrict__ x_q, float* __restrict__ sx,
          int* __restrict__ amax_h) {
  constexpr int kPer = HP / 32;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (m >= m_rows) return;
  const float hf = (float)h;
  const __nv_bfloat16* row = pre + (size_t)m * h;
  float x[kPer];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = i * 32 + lane;
    x[i] = c < h ? __bfloat162float(row[c]) : 0.f;
    sum += x[i];
  }
  const float mean = __fdiv_rn(warp_sum(sum), hf);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i * 32 + lane < h) {
      const float dlt = __fsub_rn(x[i], mean);
      sq = __fadd_rn(sq, __fmul_rn(dlt, dlt));
    }
  }
  const float var = __fdiv_rn(warp_sum(sq), hf);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = i * 32 + lane;
    if (c < h) {
      const float ln = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(x[i], mean), rs), ln_s[c]), ln_b[c]);
      const __nv_bfloat16 xc = __float2bfloat16_rn(ln);
      xres[(size_t)m * h + c] = xc;
      x[i] = __bfloat162float(xc);
      amax = fmaxf(amax, fabsf(x[i]));
    }
  }
  amax = warp_max(amax);
  const float inv = inv_of(amax);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = i * 32 + lane;
    if (c < h) x_q[(size_t)m * h + c] = quant(x[i], inv);
  }
  if (lane == 0) {
    sx[m] = scale_of(amax);
    amax_h[m] = 0;
  }
}

// ---------------------------------------------------------------------------
// 2 and 4. The two products on the wgmma loop; the roles and the ring are
// int8_gemm.cu's (int8_wgmma.cuh).  A thread's accumulators acc[4 j + e]
// are row 16 warp + g + 8 (e / 2), column 8 j + 2 tig + e % 2 of its
// warpgroup's 64 rows.
// ---------------------------------------------------------------------------

// Shared memory: the ring of tile T on a 1024-byte boundary, then its
// mbarriers.
template <typename T = Tile>
struct Ring {
  uint8_t* sa;
  uint8_t* sb;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit Ring(unsigned char* raw) {
    sa = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    sb = sa + T::kStages * kWgABytes;
    full = reinterpret_cast<uint64_t*>(sb + T::kStages * T::kBBytes);
    empty = full + T::kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < T::kStages; ++s) {
        // one cp.async arrival a producer thread (those from 256 on)
        mbar_init(&full[s], T::kThreads - 256);
        mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
      }
      mbar_init_fence();
    }
    __syncthreads();
  }
};

// ffn_out_cq's tile for h of type HT: 128 x 256 with a producer
// warpgroup, a ring and, after its mbarriers, one chunk of raw h (32 KB of
// bf16, 64 KB of f32); with bf16 four stages fit, with f32 three (four
// stages read 4 % faster than three with two raw chunks, bf16, H100).
template <typename HT>
struct OutTile : WgTile<256, 128> {
  static constexpr int kStages = sizeof(HT) == 2 ? 4 : 3;
  static constexpr int kRawBytes = kWgBM * kWgBK * (int)sizeof(HT);
  static constexpr int kSmem = kStages * (kWgABytes + kBBytes) +
                               2 * kStages * 8 + kRawBytes + 1024;
};

// GEMM1: h = gelu(fma(acc1 * sx, s1, b1)) [M, I] f32 (the FFN's) or bf16
// (int8_ffn_in's); amax_h |= the row max of the f32 values.
template <bool kVec16, typename OutT>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kCtas)
ffn_gemm1(const int8_t* __restrict__ x_q, const int8_t* __restrict__ w1t,
          const float* __restrict__ sx, const float* __restrict__ s1,
          const float* __restrict__ b1, OutT* __restrict__ hbuf,
          int* __restrict__ amax_h, int m, int inter, int h) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Ring<> ring(smem_raw);
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kBN;
  if (wg == 2) {
    wgmma_produce<kVec16, kBN, kP>(ring.sa, ring.sb, ring.full, ring.empty,
                                   x_q, m, w1t, inter, h, m0, n0,
                                   threadIdx.x - 256);
    return;
  }
  int acc[kBN / 2];
  wgmma_consume<kBN, kP>(acc, ring.sa, ring.sb, ring.full, ring.empty, h,
                         wg);

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row_base = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col_base = n0 + (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_base + half * 8;
    const bool live = row < m;
    const float s = live ? sx[row] : 0.f;
    OutT* hrow = hbuf + (size_t)row * inter;
    float rmax = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col_base + j * 8;
      if (col >= inter) continue;  // inter % 8 == 0: col + 1 < inter too
      const float v0 =
          gelu_tanh(dequant(acc[4 * j + 2 * half], s, s1[col], b1[col]));
      const float v1 = gelu_tanh(
          dequant(acc[4 * j + 2 * half + 1], s, s1[col + 1], b1[col + 1]));
      rmax = fmaxf(rmax, fmaxf(fabsf(v0), fabsf(v1)));
      if (live) store2(hrow + col, v0, v1);
    }
    // the quad (lanes 4 g .. 4 g + 3) holds the row's kBN columns
    rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, 1));
    rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, 2));
    if (live && (lane & 3) == 0) atomicMax(&amax_h[row], __float_as_int(rmax));
  }
}

// 3. h_q = clip(rint(h * (127 / amax_h))) int8 [M, I], 8 values a thread
// (I % 8 == 0: a group never crosses a row).
__global__ void __launch_bounds__(256)
h_quant(const float* __restrict__ hbuf, const int* __restrict__ amax_h,
        int8_t* __restrict__ h_q, size_t groups, int inter) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const float inv = inv_of(__int_as_float(amax_h[i * 8 / inter]));
  const float4 a = reinterpret_cast<const float4*>(hbuf)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(hbuf)[2 * i + 1];
  char4 lo, hi;
  lo.x = quant(a.x, inv);
  lo.y = quant(a.y, inv);
  lo.z = quant(a.z, inv);
  lo.w = quant(a.w, inv);
  hi.x = quant(b.x, inv);
  hi.y = quant(b.y, inv);
  hi.z = quant(b.z, inv);
  hi.w = quant(b.w, inv);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(h_q)[i] = packed;
}

// The epilogue of GEMM2 and ffn_out_cq on a [128, BN] tile at (m0, n0) of
// an [m, n] output: out = fma(acc * scale, s2, b2) + res, rounded to OutT,
// scale = scale_of(amax[row]).  Each element of res is read, and of out
// written, by one thread, so out may be res (int8_ffn_ln: ff over the
// bf16 residual x in place).
template <int BN, typename RT, typename OutT>
__device__ __forceinline__ void residual_epilogue(
    const int (&acc)[BN / 2], const float* __restrict__ amax,
    const float* __restrict__ s2, const float* __restrict__ b2, const RT* res,
    OutT* out, int m, int n, int m0, int n0, int wg) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row_base = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col_base = n0 + (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_base + half * 8;
    if (row >= m) continue;
    const float s = scale_of(amax[row]);
    const RT* rrow = res + (size_t)row * n;
    OutT* orow = out + (size_t)row * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col_base + j * 8;
      if (col >= n) continue;  // n % 8 == 0: col + 1 < n too
      const float2 x = load2<RT>(rrow + col);
      const float v0 = __fadd_rn(
          dequant(acc[4 * j + 2 * half], s, s2[col], b2[col]), x.x);
      const float v1 = __fadd_rn(
          dequant(acc[4 * j + 2 * half + 1], s, s2[col + 1], b2[col + 1]),
          x.y);
      store2(orow + col, v0, v1);
    }
  }
}

// GEMM2: out = fma(acc2 * scale_h, s2, b2) + res [M, H], rounded to OutT.
template <bool kVec16, typename RT, typename OutT>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kCtas)
ffn_gemm2(const int8_t* __restrict__ h_q, const int8_t* __restrict__ w2t,
          const int* __restrict__ amax_h, const float* __restrict__ s2,
          const float* __restrict__ b2, const RT* res, OutT* out, int m,
          int h, int inter) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Ring<> ring(smem_raw);
  const int wg = threadIdx.x >> 7;
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * kBN;
  if (wg == 2) {
    wgmma_produce<kVec16, kBN, kP>(ring.sa, ring.sb, ring.full, ring.empty,
                                   h_q, m, w2t, h, inter, m0, n0,
                                   threadIdx.x - 256);
    return;
  }
  int acc[kBN / 2];
  wgmma_consume<kBN, kP>(acc, ring.sa, ring.sb, ring.full, ring.empty,
                         inter, wg);
  residual_epilogue<kBN>(acc, reinterpret_cast<const float*>(amax_h), s2,
                         b2, res, out, m, h, m0, n0, wg);
}

// ---------------------------------------------------------------------------
// int8_ffn_out: GEMM2 with h quantized by the consumers into the ring.
// ---------------------------------------------------------------------------

// quant(v, inv) in the low byte of a word, with no conversion instruction
// (a quarter-rate one here, and ffn_out_cq quantizes every value of h
// once a column CTA): clip, then add 1.5 * 2^23, which rounds to an
// integer, ties to even, as rintf does (the clip and the rounding commute:
// +-127 are integers), and leaves it in the low mantissa bits, the word
// 0x4B400000 + r.
__device__ __forceinline__ uint32_t quant_word(float v, float inv) {
  const float t = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.f));
}

// The low bytes of four words, in order.
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The codes of one 16-byte unit of h: 8 bf16 values give 8 bytes, 4 f32
// values 4.
template <typename HT>
struct Codes;
template <>
struct Codes<__nv_bfloat16> {
  static constexpr int kValues = 8;
  using Word = uint2;
  __device__ static __forceinline__ uint2 of(uint4 v, float inv) {
    auto lo = [inv](uint32_t w) {
      return quant_word(__uint_as_float(w << 16), inv);
    };
    auto hi = [inv](uint32_t w) {
      return quant_word(__uint_as_float(w & 0xffff0000u), inv);
    };
    return make_uint2(low_bytes(lo(v.x), hi(v.x), lo(v.y), hi(v.y)),
                      low_bytes(lo(v.z), hi(v.z), lo(v.w), hi(v.w)));
  }
};
template <>
struct Codes<float> {
  static constexpr int kValues = 4;
  using Word = uint32_t;
  __device__ static __forceinline__ uint32_t of(uint4 v, float inv) {
    return low_bytes(quant_word(__uint_as_float(v.x), inv),
                     quant_word(__uint_as_float(v.y), inv),
                     quant_word(__uint_as_float(v.z), inv),
                     quant_word(__uint_as_float(v.w), inv));
  }
};

// The consumers of ffn_out_cq quantize their own A rows.  Warpgroup wg's
// wgmma reads rows 64 wg .. 64 wg + 63 of each A tile and nothing else
// does, so the warpgroup writes them itself, between issuing a chunk's
// products and waiting for them: at chunk kt it quantizes chunk kt +
// stages - 1 into the stage that chunk kt - 1 has just left (its
// wgmma_wait<1> says so), then fences its stores for the async proxy and
// meets at its own named barrier before any wgmma reads them.  Each thread
// brings its own 16-byte units of h into the raw area by cp.async (zero
// past m and k) a chunk ahead, so no thread reads another's copies and the
// loads hold no registers (the consumers' 128 accumulators leave few).
// The eight consumer warps run the quantize while the tensor cores run;
// the producer warpgroup streams w alone.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <typename HT>
__device__ __forceinline__ void quant_consume(int (&acc)[128],
                                              const Ring<OutTile<HT>>& ring,
                                              uint8_t* raw, const float* inv_s,
                                              const HT* __restrict__ h, int m,
                                              int k, int m0, int wg) {
  using T = OutTile<HT>;
  using C = Codes<HT>;
  constexpr int kPerRow = kWgBK / C::kValues;  // units a row of a chunk
  constexpr int kRowStep = 128 / kPerRow;
  constexpr int kUnits = 64 / kRowStep;  // a thread's units of a chunk
  constexpr int kPending = 1;  // wgmma groups in flight while quantizing
  const int t = threadIdx.x & 127;
  const int cu = t % kPerRow, r0 = wg * 64 + t / kPerRow;
  const int byte = cu * C::kValues;  // the codes' offset in a tile row
  const int nk = (k + kWgBK - 1) / kWgBK;
  const bool elected = t == 0;
  auto unit = [&](int u) {  // this thread's unit u of the raw chunk
    return raw + ((r0 + u * kRowStep) * kPerRow + cu) * 16;
  };

  auto fetch = [&](int kt) {  // one cp.async group a chunk, empty past nk
    if (kt < nk) {
      const int col = kt * kWgBK + byte;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int row = m0 + r0 + u * kRowStep;
        const bool ok = row < m && col < k;
        cp_async<16>(unit(u), ok ? h + (size_t)row * k + col : h,
                     ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  auto quantize = [&](int kt) {  // chunk kt -> its stage's A rows
    cp_async_wait<0>();  // chunk kt's copies have landed
    uint8_t* tile = ring.sa + (kt % T::kStages) * kWgABytes;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int r = r0 + u * kRowStep;
      *reinterpret_cast<typename C::Word*>(
          tile + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)) =
          C::of(*reinterpret_cast<const uint4*>(unit(u)), inv_s[r]);
    }
    fence_proxy_async();
    warpgroup_sync(wg);
    fetch(kt + 1);  // into the units this thread has just read
  };

  fetch(0);
  for (int kt = 0; kt < T::kStages - kPending && kt < nk; ++kt) quantize(kt);
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::kStages;
    mbar_wait(&ring.full[s], (kt / T::kStages) & 1);
    fence_proxy_async();
    const uint64_t da = sw128_desc(ring.sa + s * kWgABytes + wg * 64 * kWgBK);
    const uint64_t db = sw128_desc(ring.sb + s * T::kBBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk)  // 32 bytes: 2 descriptor units
      wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<kPending>();  // chunk kt - kPending's products are done
    if (kt >= kPending && elected)
      mbar_arrive(&ring.empty[(kt - kPending) % T::kStages]);
    // into the stage that chunk kt - kPending has left
    if (kt + T::kStages - kPending < nk)
      quantize(kt + T::kStages - kPending);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// The producer of ffn_out_cq: w's tiles alone, by cp.async.
template <bool kVec16, typename T>
__device__ __forceinline__ void w_produce(const Ring<T>& ring,
                                          const int8_t* __restrict__ w,
                                          int n, int k, int n0, int ptid) {
  const int nk = (k + kWgBK - 1) / kWgBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::kStages;
    mbar_wait(&ring.empty[s], ((kt / T::kStages) & 1) ^ 1);
    stage_sw128<kVec16, 256, 128>(ring.sb + s * T::kBBytes, w, n, k, n0,
                                  kt * kWgBK, ptid);
    mbar_arrive_cp_async(&ring.full[s]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// y = fma(acc * scale, sw, b) + res [m, n] with acc = quant(h) . w^T, on
// 128 x 256 tiles: the consumers quantize h (quant_consume), a producer
// warpgroup whose registers setmaxnreg hands to them (as int8_gemm.cu's
// 128 x 256 tile) streams w.
template <bool kVec16, typename HT, typename RT, typename OutT>
__global__ void __launch_bounds__(OutTile<HT>::kThreads, 1)
ffn_out_cq(const HT* __restrict__ h, const float* __restrict__ amax,
           const int8_t* __restrict__ w, const float* __restrict__ sw,
           const float* __restrict__ b, const RT* __restrict__ res,
           OutT* __restrict__ out, int m, int n, int k) {
  using T = OutTile<HT>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float inv_s[kWgBM];
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * 256;
  if (threadIdx.x < kWgBM)
    inv_s[threadIdx.x] =
        m0 + threadIdx.x < m ? inv_of(amax[m0 + threadIdx.x]) : 0.f;
  const Ring<T> ring(smem_raw);  // its barrier publishes inv_s too
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        T::kProducerRegs));
    w_produce<kVec16>(ring, w, n, k, n0, threadIdx.x - 256);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      T::kConsumerRegs));
  int acc[128];
  quant_consume<HT>(acc, ring,
                    reinterpret_cast<uint8_t*>(ring.empty + T::kStages),
                    inv_s, h, m, k, m0, wg);
  residual_epilogue<256>(acc, amax, sw, b, res, out, m, n, m0, n0, wg);
}

// ---------------------------------------------------------------------------
// 5. LN2 over ff (bf16, rounded by GEMM2's epilogue) -> out [M, H] bf16.
// ---------------------------------------------------------------------------
template <int HP>
__global__ void __launch_bounds__(kRowWarps * 32)
ln2(const __nv_bfloat16* __restrict__ ff, const float* __restrict__ ln_s,
    const float* __restrict__ ln_b, float eps, int m_rows, int h,
    __nv_bfloat16* __restrict__ out) {
  constexpr int kPer = HP / 32;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (m >= m_rows) return;
  const float hf = (float)h;
  const __nv_bfloat16* row = ff + (size_t)m * h;
  float x[kPer];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = i * 32 + lane;
    x[i] = c < h ? __bfloat162float(row[c]) : 0.f;
    sum = __fadd_rn(sum, x[i]);
  }
  const float mean = __fdiv_rn(warp_sum(sum), hf);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (i * 32 + lane < h) {
      const float dlt = __fsub_rn(x[i], mean);
      sq = __fadd_rn(sq, __fmul_rn(dlt, dlt));
    }
  }
  const float var = __fdiv_rn(warp_sum(sq), hf);
  const float rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = i * 32 + lane;
    if (c < h)
      out[(size_t)m * h + c] = __float2bfloat16_rn(__fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(x[i], mean), rs), ln_s[c]), ln_b[c]));
  }
}

// ---------------------------------------------------------------------------
// Launches.
// ---------------------------------------------------------------------------

// The ring's shared memory of tile T, asked for once a process (a
// static's initializer runs once, thread-safely; the port drives one card
// a process).
template <typename T = Tile, typename Kernel>
cudaError_t ring_smem(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

cudaError_t first_error(cudaError_t a, cudaError_t b) {
  return a != cudaSuccess ? a : b;
}

int row_tiles(int m) { return (m + kWgBM - 1) / kWgBM; }

// GEMM1 (x_q [m, h] . w1t [inter, h]^T) on st: amax_h must be zero on
// entry.
template <typename OutT>
cudaError_t launch_gemm1(const int8_t* x_q, const int8_t* w1t,
                         const float* sx, const float* s1, const float* b1,
                         OutT* hbuf, int* amax_h, int m, int h, int inter,
                         cudaStream_t st) {
  // GEMM1's K is h: 16-byte copies where h % 16 == 0
  auto gemm1 = h % 16 == 0 ? ffn_gemm1<true, OutT> : ffn_gemm1<false, OutT>;
  static const cudaError_t ready = first_error(
      ring_smem(ffn_gemm1<true, OutT>), ring_smem(ffn_gemm1<false, OutT>));
  if (ready != cudaSuccess) return ready;
  gemm1<<<dim3((inter + kBN - 1) / kBN, row_tiles(m)), Tile::kThreads,
          Tile::kSmem, st>>>(x_q, w1t, sx, s1, b1, hbuf, amax_h, m, inter, h);
  return cudaGetLastError();
}

// GEMM1, h_quant and GEMM2 on st: amax_h must be zero on entry.
template <typename RT, typename OutT>
cudaError_t launch_gemms(const int8_t* x_q, const int8_t* w1t,
                         const float* sx, const float* s1, const float* b1,
                         float* hbuf, int* amax_h, int8_t* h_q,
                         const int8_t* w2t, const float* s2, const float* b2,
                         const RT* res, OutT* out, int m, int h, int inter,
                         cudaStream_t st) {
  cudaError_t err =
      launch_gemm1(x_q, w1t, sx, s1, b1, hbuf, amax_h, m, h, inter, st);
  if (err != cudaSuccess) return err;

  const size_t groups = (size_t)m * inter / 8;
  h_quant<<<(unsigned)((groups + 255) / 256), 256, 0, st>>>(hbuf, amax_h, h_q,
                                                            groups, inter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // GEMM2's K is inter: 16-byte copies where inter % 16 == 0
  auto gemm2 = inter % 16 == 0 ? ffn_gemm2<true, RT, OutT>
                               : ffn_gemm2<false, RT, OutT>;
  static const cudaError_t ready =
      first_error(ring_smem(ffn_gemm2<true, RT, OutT>),
                  ring_smem(ffn_gemm2<false, RT, OutT>));
  if (ready != cudaSuccess) return ready;
  gemm2<<<dim3((h + kBN - 1) / kBN, row_tiles(m)), Tile::kThreads,
          Tile::kSmem, st>>>(h_q, w2t, amax_h, s2, b2, res, out, m, h, inter);
  return cudaGetLastError();
}

// ffn_out_cq: setmaxnreg.inc waits until the producer has returned enough
// registers, so a kernel compiled to fewer than that is refused.
template <typename HT, typename RT, typename OutT>
cudaError_t launch_out_cq(const HT* h, const float* amax, const int8_t* w,
                          const float* sw, const float* b, const RT* res,
                          OutT* y, int m, int n, int k, cudaStream_t st) {
  using T = OutTile<HT>;
  auto kernel = k % 16 == 0 ? ffn_out_cq<true, HT, RT, OutT>
                            : ffn_out_cq<false, HT, RT, OutT>;
  auto ready_of = [](auto kern) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    if ((attr.numRegs - T::kProducerRegs) * 128 <
        (T::kConsumerRegs - attr.numRegs) * 256)
      return cudaErrorInvalidConfiguration;
    return ring_smem<T>(kern);
  };
  static const cudaError_t ready =
      first_error(ready_of(ffn_out_cq<true, HT, RT, OutT>),
                  ready_of(ffn_out_cq<false, HT, RT, OutT>));
  if (ready != cudaSuccess) return ready;
  kernel<<<dim3((n + 255) / 256, row_tiles(m)), T::kThreads, T::kSmem, st>>>(
      h, amax, w, sw, b, res, y, m, n, k);
  return cudaGetLastError();
}

template <int HP>
cudaError_t launch_rows(const __nv_bfloat16* pre, const float* ln1_s,
                        const float* ln1_b, const float* ln2_s,
                        const float* ln2_b, float eps, int m, int h,
                        __nv_bfloat16* xres, int8_t* x_q, float* sx,
                        int* amax_h, __nv_bfloat16* out, bool first,
                        cudaStream_t st) {
  const int blocks = (m + kRowWarps - 1) / kRowWarps;
  if (first)
    ln1_quant<HP><<<blocks, kRowWarps * 32, 0, st>>>(
        pre, ln1_s, ln1_b, eps, m, h, xres, x_q, sx, amax_h);
  else
    ln2<HP><<<blocks, kRowWarps * 32, 0, st>>>(xres, ln2_s, ln2_b, eps, m, h,
                                               out);
  return cudaGetLastError();
}

cudaError_t launch_rows_hp(const __nv_bfloat16* pre, const float* ln1_s,
                           const float* ln1_b, const float* ln2_s,
                           const float* ln2_b, float eps, int m, int h,
                           __nv_bfloat16* xres, int8_t* x_q, float* sx,
                           int* amax_h, __nv_bfloat16* out, bool first,
                           cudaStream_t st) {
#define INT8_FFN_ROWS(HP)                                                   \
  case HP:                                                                  \
    return launch_rows<HP>(pre, ln1_s, ln1_b, ln2_s, ln2_b, eps, m, h,      \
                           xres, x_q, sx, amax_h, out, first, st);
  switch ((h + 127) / 128 * 128) {
    INT8_FFN_ROWS(128)
    INT8_FFN_ROWS(256)
    INT8_FFN_ROWS(384)
    INT8_FFN_ROWS(512)
    INT8_FFN_ROWS(640)
    INT8_FFN_ROWS(768)
    INT8_FFN_ROWS(896)
    INT8_FFN_ROWS(1024)
    default:
      return cudaErrorInvalidValue;
  }
#undef INT8_FFN_ROWS
}

// The widths int8_ffn_ln and int8_ffn_fused take.
bool widths_ok(int m, int h, int inter) {
  return m > 0 && h > 0 && h % 8 == 0 && h <= kMaxH && inter > 0 &&
         inter % 8 == 0 && inter <= kMaxI;
}

}  // namespace

// pre [m, h] bf16; w1t [inter, h] int8; w2t [h, inter] int8; s1, b1
// [inter] f32; s2, b2, ln1_*, ln2_* [h] f32.  Scratch: xres [m, h] bf16
// (the residual, then ff), x_q [m, h] int8, sx [m] f32, amax [m] int32,
// hbuf [m, inter] f32, h_q [m, inter] int8, each 16-byte aligned.  out
// [m, h] bf16.  Requires m > 0, h % 8 == 0, h <= 1024, inter % 8 == 0,
// inter <= 4096.
extern "C" int int8_ffn_ln(const void* pre, const void* w1t, const void* s1,
                           const void* b1, const void* w2t, const void* s2,
                           const void* b2, const void* ln1_s,
                           const void* ln1_b, const void* ln2_s,
                           const void* ln2_b, float eps, int m, int h,
                           int inter, void* xres, void* x_q, void* sx,
                           void* amax, void* hbuf, void* h_q, void* out,
                           void* stream) {
  if (!widths_ok(m, h, inter)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xr = static_cast<__nv_bfloat16*>(xres);
  auto* xq = static_cast<int8_t*>(x_q);
  auto* sxf = static_cast<float*>(sx);
  auto* am = static_cast<int*>(amax);
  const auto* ln1s = static_cast<const float*>(ln1_s);
  const auto* ln1b = static_cast<const float*>(ln1_b);
  const auto* ln2s = static_cast<const float*>(ln2_s);
  const auto* ln2b = static_cast<const float*>(ln2_b);

  cudaError_t err =
      launch_rows_hp(static_cast<const __nv_bfloat16*>(pre), ln1s, ln1b, ln2s,
                     ln2b, eps, m, h, xr, xq, sxf, am, nullptr, true, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemms(xq, static_cast<const int8_t*>(w1t), sxf,
                     static_cast<const float*>(s1),
                     static_cast<const float*>(b1), static_cast<float*>(hbuf),
                     am, static_cast<int8_t*>(h_q),
                     static_cast<const int8_t*>(w2t),
                     static_cast<const float*>(s2),
                     static_cast<const float*>(b2), xr, xr, m, h, inter, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_rows_hp(nullptr, ln1s, ln1b, ln2s, ln2b, eps, m, h, xr,
                             nullptr, nullptr, nullptr,
                             static_cast<__nv_bfloat16*>(out), false, st);
}

// The W8A8 FFN without its LayerNorms (int8_ffn_fused): x_q [m, h] int8;
// sx [m] f32; w1t [inter, h], w2t [h, inter] int8; s1, b1 [inter], s2, b2
// [h] f32; res [m, h] bf16 (res_bf16) or f32; out [m, h] bf16 (out_bf16)
// or f32.  Scratch: amax [m] int32, hbuf [m, inter] f32, h_q [m, inter]
// int8, each 16-byte aligned.  Requires m > 0, h % 8 == 0, h <= 1024,
// inter % 8 == 0, inter <= 4096.
extern "C" int int8_ffn_fused(const void* x_q, const void* sx,
                              const void* w1t, const void* s1, const void* b1,
                              const void* w2t, const void* s2, const void* b2,
                              const void* res, void* out, int m, int h,
                              int inter, void* amax, void* hbuf, void* h_q,
                              int res_bf16, int out_bf16, void* stream) {
  if (!widths_ok(m, h, inter)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, (size_t)m * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  auto gemms = [&](const auto* r, auto* o) {
    return launch_gemms(
        static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w1t),
        static_cast<const float*>(sx), static_cast<const float*>(s1),
        static_cast<const float*>(b1), static_cast<float*>(hbuf),
        static_cast<int*>(amax), static_cast<int8_t*>(h_q),
        static_cast<const int8_t*>(w2t), static_cast<const float*>(s2),
        static_cast<const float*>(b2), r, o, m, h, inter, st);
  };
  auto* bf_out = static_cast<__nv_bfloat16*>(out);
  auto* f_out = static_cast<float*>(out);
  if (res_bf16) {
    const auto* r = static_cast<const __nv_bfloat16*>(res);
    return (int)(out_bf16 ? gemms(r, bf_out) : gemms(r, f_out));
  }
  const auto* r = static_cast<const float*>(res);
  return (int)(out_bf16 ? gemms(r, bf_out) : gemms(r, f_out));
}

// The FFN's first GEMM with gelu (int8_ffn_in): x [m, k] int8; w [n, k]
// int8; sx [m], sw [n], b [n] f32; h [m, n] bf16 (out_bf16) or f32; amax
// [m] int32 receives the f32 bits of max |y|.  Requires k % 8 == 0 and
// n % 8 == 0.
extern "C" int int8_ffn_in(const void* x, const void* w, const void* sx,
                           const void* sw, const void* b, void* h, void* amax,
                           int m, int n, int k, int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(amax, 0, (size_t)m * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  auto gemm1 = [&](auto* hout) {
    return launch_gemm1(static_cast<const int8_t*>(x),
                        static_cast<const int8_t*>(w),
                        static_cast<const float*>(sx),
                        static_cast<const float*>(sw),
                        static_cast<const float*>(b), hout,
                        static_cast<int*>(amax), m, k, n, st);
  };
  return (int)(out_bf16 ? gemm1(static_cast<__nv_bfloat16*>(h))
                        : gemm1(static_cast<float*>(h)));
}

// The FFN's second GEMM with h requantized on the way into the ring
// (int8_ffn_out): h [m, k] bf16 (h_bf16) or f32; amax [m] f32; w [n, k]
// int8; sw, b [n] f32; res [m, n] bf16 (res_bf16) or f32; y [m, n] bf16
// (out_bf16) or f32.  Requires k % 8 == 0 and n % 8 == 0.
extern "C" int int8_ffn_out(const void* h, const void* amax, const void* w,
                            const void* sw, const void* b, const void* res,
                            void* y, int m, int n, int k, int h_bf16,
                            int res_bf16, int out_bf16, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 || k % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto out_q = [&](const auto* hp, const auto* rp, auto* yp) {
    return launch_out_cq(hp, static_cast<const float*>(amax),
                         static_cast<const int8_t*>(w),
                         static_cast<const float*>(sw),
                         static_cast<const float*>(b), rp, yp, m, n, k, st);
  };
  auto with_out = [&](const auto* hp, const auto* rp) {
    return out_bf16 ? out_q(hp, rp, static_cast<__nv_bfloat16*>(y))
                    : out_q(hp, rp, static_cast<float*>(y));
  };
  auto with_res = [&](const auto* hp) {
    return res_bf16 ? with_out(hp, static_cast<const __nv_bfloat16*>(res))
                    : with_out(hp, static_cast<const float*>(res));
  };
  return (int)(h_bf16 ? with_res(static_cast<const __nv_bfloat16*>(h))
                      : with_res(static_cast<const float*>(h)));
}

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

// Shared memory: the ring on a 1024-byte boundary, then its mbarriers.
struct Ring {
  uint8_t* sa;
  uint8_t* sb;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit Ring(unsigned char* raw) {
    sa = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    sb = sa + Tile::kStages * kWgABytes;
    full = reinterpret_cast<uint64_t*>(sb + Tile::kStages * Tile::kBBytes);
    empty = full + Tile::kStages;
    if (threadIdx.x == 0) {
      for (int s = 0; s < Tile::kStages; ++s) {
        mbar_init(&full[s], kP);  // one cp.async arrival a producer thread
        mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
      }
      mbar_init_fence();
    }
    __syncthreads();
  }
};

// GEMM1: h = gelu(fma(acc1 * sx, s1, b1)) f32 [M, I]; amax_h |= row max.
template <bool kVec16>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kCtas)
ffn_gemm1(const int8_t* __restrict__ x_q, const int8_t* __restrict__ w1t,
          const float* __restrict__ sx, const float* __restrict__ s1,
          const float* __restrict__ b1, float* __restrict__ hbuf,
          int* __restrict__ amax_h, int m, int inter, int h) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Ring ring(smem_raw);
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
    float* hrow = hbuf + (size_t)row * inter;
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

// GEMM2: out = fma(acc2 * scale_h, s2, b2) + res, rounded to OutT.  Each
// element of res is read, and of out written, by one thread, so out may be
// res (int8_ffn_ln: ff over the bf16 residual x in place).
template <bool kVec16, typename RT, typename OutT>
__global__ void __launch_bounds__(Tile::kThreads, Tile::kCtas)
ffn_gemm2(const int8_t* __restrict__ h_q, const int8_t* __restrict__ w2t,
          const int* __restrict__ amax_h, const float* __restrict__ s2,
          const float* __restrict__ b2, const RT* res, OutT* out, int m,
          int h, int inter) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Ring ring(smem_raw);
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

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row_base = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int col_base = n0 + (lane & 3) * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_base + half * 8;
    if (row >= m) continue;
    const float s = scale_of(__int_as_float(amax_h[row]));
    const RT* rrow = res + (size_t)row * h;
    OutT* orow = out + (size_t)row * h;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = col_base + j * 8;
      if (col >= h) continue;  // h % 8 == 0: col + 1 < h too
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

// The ring's shared memory, asked for once a process (a static's
// initializer runs once, thread-safely; the port drives one card a
// process).
template <typename Kernel>
cudaError_t ring_smem(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

cudaError_t first_error(cudaError_t a, cudaError_t b) {
  return a != cudaSuccess ? a : b;
}

// GEMM1, h_quant and GEMM2 on st: amax_h must be zero on entry.
template <typename RT, typename OutT>
cudaError_t launch_gemms(const int8_t* x_q, const int8_t* w1t,
                         const float* sx, const float* s1, const float* b1,
                         float* hbuf, int* amax_h, int8_t* h_q,
                         const int8_t* w2t, const float* s2, const float* b2,
                         const RT* res, OutT* out, int m, int h, int inter,
                         cudaStream_t st) {
  const int row_tiles = (m + kWgBM - 1) / kWgBM;
  // GEMM1's K is h: 16-byte copies where h % 16 == 0
  auto gemm1 = h % 16 == 0 ? ffn_gemm1<true> : ffn_gemm1<false>;
  static const cudaError_t ready1 =
      first_error(ring_smem(ffn_gemm1<true>), ring_smem(ffn_gemm1<false>));
  if (ready1 != cudaSuccess) return ready1;
  gemm1<<<dim3((inter + kBN - 1) / kBN, row_tiles), Tile::kThreads,
          Tile::kSmem, st>>>(x_q, w1t, sx, s1, b1, hbuf, amax_h, m, inter, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t groups = (size_t)m * inter / 8;
  h_quant<<<(unsigned)((groups + 255) / 256), 256, 0, st>>>(hbuf, amax_h, h_q,
                                                            groups, inter);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // GEMM2's K is inter: 16-byte copies where inter % 16 == 0
  auto gemm2 = inter % 16 == 0 ? ffn_gemm2<true, RT, OutT>
                               : ffn_gemm2<false, RT, OutT>;
  static const cudaError_t ready2 =
      first_error(ring_smem(ffn_gemm2<true, RT, OutT>),
                  ring_smem(ffn_gemm2<false, RT, OutT>));
  if (ready2 != cudaSuccess) return ready2;
  gemm2<<<dim3((h + kBN - 1) / kBN, row_tiles), Tile::kThreads, Tile::kSmem,
          st>>>(h_q, w2t, amax_h, s2, b2, res, out, m, h, inter);
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

// The widths both exports take.
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

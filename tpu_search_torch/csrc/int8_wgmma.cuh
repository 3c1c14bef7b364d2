// The wgmma main loop of the int8 GEMMs (int8_gemm.cu, and the products
// of int8_ffn_ln.cu, whose ffn_out_cq writes the A operand from its
// consumers): one CTA computes
// a [128, BN] tile (BN 128 or 256) of x [M, K] . w [N, K]^T (int8 rows,
// exact int32 sums) with wgmma.mma_async m64nBNk32 s8 x s8 -> s32
// (sm_90a).
//
// Roles: warpgroups 0 and 1 consume (each owns 64 rows of the tile and all
// BN columns: BN / 2 int32 accumulators a thread); the P threads from 256
// on produce.  Operands pass through a ring of 128-deep K chunks in shared
// memory, in the 128-byte swizzled K-major layout the wgmma descriptors
// read: row r of a tile occupies bytes r*128 .. r*128+127, its 16-byte
// chunk c at position c ^ (r % 8), tiles 1024-byte aligned.  The producer
// copies with cp.async (16 bytes where K % 16 == 0, else 8: the contract
// takes K = 312, whose 312-byte rows TMA's 16-byte stride rule refuses),
// zero-filling rows past M or N and columns past K, and each of its
// threads signals the stage's "full" mbarrier with
// cp.async.mbarrier.arrive.noinc when its copies land.  A consumer waits
// on "full", fences the generic-proxy writes for the async proxy, issues
// the chunk's four wgmmas, keeps one batch in flight (wait_group 1) and
// releases the previous stage on its "empty" mbarrier.  A wait that never
// ends traps instead of hanging the card.
// Only helpers live here; the kernel and its epilogue stay in the .cu.

#pragma once

#include "int8_mma.cuh"

namespace {

constexpr int kWgBM = 128;  // tile rows (two consumer warpgroups of 64)
constexpr int kWgBK = 128;  // K bytes per chunk: one 128-byte swizzle row
constexpr int kWgABytes = kWgBM * kWgBK;

// A [128, BN] tile's ring depth, CTAs a multiprocessor, producer threads
// (P: 64, or a warpgroup of 128 whose registers setmaxnreg hands to the
// consumers) and shared memory.  BN 256 takes 4 stages of 48 KB (one CTA);
// BN 128 3 of 32 KB, so that two CTAs share a multiprocessor and one's
// epilogue overlaps the other's products.  The shared memory adds 2 *
// stages mbarriers and the slack that aligns the ring to 1024 bytes.
template <int BN, int P>
struct WgTile {
  static constexpr int kStages = BN == 256 ? 4 : 3;
  static constexpr int kCtas = BN == 256 ? 1 : 2;
  static constexpr int kThreads = 256 + P;
  static constexpr int kBBytes = BN * kWgBK;
  static constexpr int kSmem = kStages * (kWgABytes + kBBytes) +
                               2 * kStages * 8 + 1024;
  // registers a thread at launch (65,536 over the CTAs' threads, a
  // multiple of 8), and after setmaxnreg for a producer warpgroup: the
  // producer returns what the consumers take
  static constexpr int kLaunchRegs = (65536 / (kCtas * kThreads)) & ~7;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs =
      (kLaunchRegs + (kLaunchRegs - kProducerRegs) / 2) & ~7;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The barrier counts one arrival when every cp.async this thread issued so
// far has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A pipeline that
// never completes it traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spins == (1u << 24)) __trap();
  }
}

// -- wgmma ----------------------------------------------------------------------

// Descriptor of a K-major operand in the 128-byte swizzled layout: start
// address >> 4, leading offset 1 (unused by this layout), stride 1024
// bytes between 8-row groups, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_addr(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Make the generic-proxy writes of the ring (cp.async) visible to the
// async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x n] += a[64 x 32] . b[n x 32]^T (n = 2 * the size of d), both
// K-major s8 in shared memory.  d[4 j + e] of thread (warp w, lane 4 g + t)
// is row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2, as m16n8
// accumulators.
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// -- the producer and the consumers -------------------------------------------

// Copy rows row0 .. row0 + ROWS - 1, K bytes k0 .. k0 + 127, of a row-major
// [n_rows, k] int8 array into one swizzled tile (zeros past n_rows and k),
// the P producer threads sharing the copies.
template <bool kVec16, int ROWS, int P>
__device__ __forceinline__ void stage_sw128(uint8_t* tile,
                                            const int8_t* __restrict__ src,
                                            int n_rows, int k, int row0,
                                            int k0, int ptid) {
#pragma unroll 8
  for (int it = 0; it < ROWS * 8 / P; ++it) {
    const int i = ptid + it * P;
    const int r = i >> 3, c = i & 7, row = row0 + r, kc = k0 + c * 16;
    uint8_t* dst = tile + r * 128 + ((c ^ (r & 7)) << 4);
    const int8_t* from = src + (size_t)row * k + kc;
    if constexpr (kVec16) {
      const bool ok = row < n_rows && kc < k;
      cp_async<16>(dst, ok ? from : src, ok ? 16 : 0);
    } else {
      const bool live = row < n_rows;
      const bool ok0 = live && kc < k, ok1 = live && kc + 8 < k;
      cp_async<8>(dst, ok0 ? from : src, ok0 ? 8 : 0);
      cp_async<8>(dst + 8, ok1 ? from + 8 : src, ok1 ? 8 : 0);
    }
  }
}

// The producer (ptid 0 .. P - 1): every K chunk into the ring.
template <bool kVec16, int BN, int P>
__device__ __forceinline__ void wgmma_produce(uint8_t* sa, uint8_t* sb,
                                              uint64_t* full, uint64_t* empty,
                                              const int8_t* __restrict__ x,
                                              int m, const int8_t* __restrict__ w,
                                              int n, int k, int m0, int n0,
                                              int ptid) {
  using T = WgTile<BN, P>;
  const int nk = (k + kWgBK - 1) / kWgBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::kStages;
    // the first round finds every stage free (parity of the phase before 0)
    mbar_wait(&empty[s], ((kt / T::kStages) & 1) ^ 1);
    stage_sw128<kVec16, kWgBM, P>(sa + s * kWgABytes, x, m, k, m0,
                                  kt * kWgBK, ptid);
    stage_sw128<kVec16, BN, P>(sb + s * T::kBBytes, w, n, k, n0, kt * kWgBK,
                               ptid);
    mbar_arrive_cp_async(&full[s]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Consumer warpgroup wg (0 or 1): rows 64 wg .. 64 wg + 63 of the tile.
template <int BN, int P>
__device__ __forceinline__ void wgmma_consume(int (&acc)[BN / 2],
                                              const uint8_t* sa,
                                              const uint8_t* sb,
                                              uint64_t* full, uint64_t* empty,
                                              int k, int wg) {
  using T = WgTile<BN, P>;
  const int nk = (k + kWgBK - 1) / kWgBK;
  const bool elected = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % T::kStages;
    mbar_wait(&full[s], (kt / T::kStages) & 1);
    fence_proxy_async();
    const uint64_t da = sw128_desc(sa + s * kWgABytes + wg * 64 * kWgBK);
    const uint64_t db = sw128_desc(sb + s * T::kBBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 32; ++kk)  // 32 bytes: 2 descriptor units
      wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done
    if (kt > 0 && elected) mbar_arrive(&empty[(kt - 1) % T::kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

}  // namespace

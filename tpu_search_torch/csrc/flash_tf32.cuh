// Hopper building blocks of the flash mode's tf32 kernels: the f32 forward
// (flash_attention_f32.cu) and the f32 backward's row and column passes
// (flash_attention_bwd.cu, which also runs them on bf16 operands above hd
// 256): operand planes in shared memory, split once as they are staged,
// and 3xTF32 products on wgmma.
//
// A plane is a tile of R rows (a multiple of 8) of tf32 values, K-major
// (the product's depth along the row), in blocks of 32 columns: block i is
// [R][128 bytes] at byte i R 128, and 16-byte chunk c of row r of a block
// sits at chunk c ^ (r % 8), the 128-byte swizzled layout wgmma reads
// (flash_wgmma.cuh's Tile, with 32 f32 columns where it has 64 bf16).  An
// f32 operand x goes in as two planes, hi = tf32(x) and lo = tf32(x - hi);
// a product a b^T is lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), three wgmma
// into one f32 sum (the lost lo lo term is 2^-22 of the product).  A bf16
// operand is exact in tf32: its lo plane is zero and its products are one
// wgmma each (kSplit false).
//
// tf32 wgmma reads both shared-memory operands K-major only, so an operand
// whose depth runs down its rows in global memory (V for P V, K for dS K,
// Q and dO for dS^T Q and P^T dO) is staged transposed: plane row n is
// column n of the operand, its depth the operand's rows.  Those planes are
// the B of a product whose A comes from registers: accumulator tiles (P,
// dS) in the layout of flash_wgmma.cuh, where a thread holds columns 2t,
// 2t + 1 of each n8 tile, while the tf32 A fragment holds k positions t, t
// + 4 of a k8 step.  So k position t of a step is the operand's row 2t and
// position t + 4 its row 2t + 1 (kperm), on both sides: the A of n8 tile j
// is {d[j][0], d[j][2], d[j][1], d[j][3]}.

#pragma once

#include "flash_wgmma.cuh"

namespace ftf {

using attn2::smem_u32;

constexpr int kBlk = 32;  // f32 columns of a 128-byte block

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Byte offset of element (r, c) of a plane of `rows` rows.
__device__ __forceinline__ int plane_at(int rows, int r, int c) {
  return (c >> 5) * rows * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) +
         (c & 3) * 4;
}

__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float(tcattn::to_tf32(x));
}

// hi and lo of four values (lo zero without kSplit: bf16 operands).
template <bool kSplit>
__device__ __forceinline__ void split4(const float (&x)[4], float4& hi,
                                       float4& lo) {
  float h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = tf32_round(x[i]);
    l[i] = kSplit ? tf32_round(x[i] - h[i]) : 0.f;
  }
  hi = make_float4(h[0], h[1], h[2], h[3]);
  lo = make_float4(l[0], l[1], l[2], l[3]);
}

// Four consecutive elements of T as floats, n of them valid (zeros past
// them): one 16-byte (f32) or 8-byte (bf16) load where `vec` and n >= 4.
__device__ __forceinline__ void load4(float (&x)[4], const float* p, int n,
                                      bool vec) {
  if (vec && n >= 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = i < n ? __ldg(p + i) : 0.f;
}
__device__ __forceinline__ void load4(float (&x)[4], const __nv_bfloat16* p,
                                      int n, bool vec) {
  if (vec && n >= 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = i < n ? __bfloat162float(p[i]) : 0.f;
}

// One element of T as a float (global or shared memory).
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

// Stage rows 0 .. R - 1 of an operand (src: its row 0 at the chunk's first
// column, rows ld elements apart) into planes hi and lo of nb blocks:
// columns 0 .. w - 1 of the chunk, zeros from w on.  `vec`: ld and src
// allow 4-element loads (a multiple of 4 and aligned).  Each thread issues
// kBatch loads before it stores any (a store between two loads would make
// each wait for the one before: the compiler cannot tell the planes from
// the operand).
constexpr int kBatch = 8;
template <typename T, bool kSplit, int R>
__device__ __forceinline__ void stage_plane(unsigned char* hi,
                                            unsigned char* lo, const T* src,
                                            int ld, int w, int nb, bool vec,
                                            int tid, int nthreads) {
  const int per = nb * 8, total = R * per;  // 4-column chunks
  for (int i0 = tid; i0 < total; i0 += kBatch * nthreads) {
    float x[kBatch][4];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nthreads;
      const int r = i / per, c = (i - r * per) * 4;
      if (i < total) load4(x[u], src + (long long)r * ld + c, w - c, vec);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nthreads;
      const int r = i / per, c = (i - r * per) * 4;
      if (i >= total) break;
      float4 h, l;
      split4<kSplit>(x[u], h, l);
      const int at = plane_at(R, r, c);
      *reinterpret_cast<float4*>(hi + at) = h;
      *reinterpret_cast<float4*>(lo + at) = l;
    }
  }
}

// Stage an operand transposed: plane row n (of `rows`, the plane's row
// count; n < fill written) is the operand's column n (src: its row 0 at
// that slice's first column, rows ld elements apart; columns at or past wn
// zero), its K positions the operand's rows 0 .. K - 1 in kperm order (a
// k8 step's position t is row 2t, position t + 4 row 2t + 1).  Loads in
// batches, as stage_plane.
template <typename T, bool kSplit, int K>
__device__ __forceinline__ void stage_trans(unsigned char* hi,
                                            unsigned char* lo, const T* src,
                                            int ld, int wn, int fill,
                                            int rows, int tid, int nthreads) {
  constexpr int U = kBatch / 2;
  const int total = fill * (K / 4);
  for (int i0 = tid; i0 < total; i0 += U * nthreads) {
    float x[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nthreads;
      const int n = i % fill, ch = i / fill;
      // positions 4 ch .. 4 ch + 3: rows 8 (ch / 2) + ch % 2 + {0, 2, 4, 6}
      const int row0 = 8 * (ch >> 1) + (ch & 1);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[u][e] = i < total && n < wn
                      ? load1(src + (long long)(row0 + 2 * e) * ld + n)
                      : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * nthreads;
      const int n = i % fill, ch = i / fill;
      if (i >= total) break;
      float4 h, l;
      split4<kSplit>(x[u], h, l);
      const int at = plane_at(rows, n, 4 * ch);
      *reinterpret_cast<float4*>(hi + at) = h;
      *reinterpret_cast<float4*>(lo + at) = l;
    }
  }
}

// -- planes from raw f32 tiles in shared memory ------------------------------
// Where the head is at most two blocks (hd <= 64), the kernels copy each
// tile's streamed f32 rows into shared memory by cp.async a tile or two
// ahead (rows raw_ld(nb) floats apart; the columns past hd zero) and split
// them there: the loads' latency off the critical path, and shapes known
// at compile time.

__host__ __device__ constexpr int raw_ld(int nb) { return 32 * nb + 4; }

// Planes hi, lo of R rows and NB blocks from a raw tile.
template <int R, int NB>
__device__ __forceinline__ void split_plane(unsigned char* hi,
                                            unsigned char* lo,
                                            const float* raw, int tid,
                                            int nthreads = 128) {
  constexpr int per = NB * 8, ldr = raw_ld(NB);
#pragma unroll 4
  for (int i = tid; i < R * per; i += nthreads) {
    const int r = i / per, c = (i % per) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * ldr + c);
    const float x[4] = {v.x, v.y, v.z, v.w};
    float4 h, l;
    split4<true>(x, h, l);
    const int at = plane_at(R, r, c);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// The transposed planes (32 NB rows, K positions in kperm order) of a raw
// tile of K rows, as stage_trans.
template <int K, int NB>
__device__ __forceinline__ void split_trans(unsigned char* hi,
                                            unsigned char* lo,
                                            const float* raw, int tid,
                                            int nthreads = 128) {
  constexpr int fill = 32 * NB, ldr = raw_ld(NB);
#pragma unroll 4
  for (int i = tid; i < fill * (K / 4); i += nthreads) {
    const int n = i % fill, ch = i / fill;
    const int row0 = 8 * (ch >> 1) + (ch & 1);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = raw[(row0 + 2 * e) * ldr + n];
    float4 h, l;
    split4<true>(x, h, l);
    const int at = plane_at(fill, n, 4 * ch);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// Issue the cp.async copies of rows 0 .. R - 1 of an f32 operand (rows ld
// apart, hd columns; `chunk` bytes a copy: 16, 8 or 4) into a raw tile.
template <int R, int NB>
__device__ __forceinline__ void copy_raw(float* raw, const float* src,
                                         int ld, int hd, int chunk,
                                         int tid) {
  tcattn::stage_rows<float, R>(raw, raw_ld(NB), src, ld, R, hd, chunk, tid);
}

// The descriptor of k8 step kk (columns 8 kk .. 8 kk + 7) of a plane of
// `rows` rows, from row row0 (a multiple of 8) on.
__device__ __forceinline__ uint64_t kdesc(const unsigned char* plane,
                                          int rows, int kk, int row0 = 0) {
  return fwg::desc(plane + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32,
                   16, 1024, 1);
}

// -- wgmma, tf32 operands, f32 sums -------------------------------------------

// d[64 x 32] += a . b^T: a and b K-major planes (descriptors da, db).
__device__ __forceinline__ void mma_ss(float (&d)[4][4], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += a . b^T: a and b K-major planes (descriptors da, db).
__device__ __forceinline__ void mma_ss(float (&d)[8][4], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 32] += a . b: a from registers (a k8 step's tf32 A fragment), b a
// K-major plane (descriptor db).
__device__ __forceinline__ void mma_rs(float (&d)[4][4],
                                       const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b^T over nk k8 steps of K-major planes: a (64 rows from row a0
// of a plane of ar rows) and b (br rows), each as hi and lo, three
// products a step (one without kSplit).
template <bool kSplit, int NT>
__device__ __forceinline__ void mma_planes(float (&d)[NT][4],
                                           const unsigned char* ah,
                                           const unsigned char* al,
                                           const unsigned char* bh,
                                           const unsigned char* bl, int br,
                                           int nk, int ar = 64, int a0 = 0) {
#pragma unroll 1
  for (int kk = 0; kk < nk; ++kk) {
    const uint64_t dah = kdesc(ah, ar, kk, a0), dbh = kdesc(bh, br, kk);
    if constexpr (kSplit) {
      mma_ss(d, kdesc(al, ar, kk, a0), dbh);
      mma_ss(d, dah, kdesc(bl, br, kk));
    }
    mma_ss(d, dah, dbh);
  }
}

// The tf32 A fragments of the accumulator tiles x (k8 step j: n8 tile j),
// hi and lo (lo zero without kSplit).
template <bool kSplit, int NT>
__device__ __forceinline__ void frag_a(uint32_t (&hi)[NT][4],
                                       uint32_t (&lo)[NT][4],
                                       const float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = x[j][(i & 1) * 2 + (i >> 1)];  // 0, 2, 1, 3
      hi[j][i] = tcattn::to_tf32(v);
      lo[j][i] = kSplit ? tcattn::to_tf32(v - __uint_as_float(hi[j][i])) : 0u;
    }
}

// d[nb] += a . b for the output blocks nb < ob: a the A fragments of NT k8
// steps (hi, lo), b the transposed planes hi, lo (br rows; block nb its
// rows 32 nb on).
template <bool kSplit, int NT, int OB>
__device__ __forceinline__ void mma_frags(float (&d)[OB][4][4],
                                          const uint32_t (&hi)[NT][4],
                                          const uint32_t (&lo)[NT][4],
                                          const unsigned char* bh,
                                          const unsigned char* bl, int br,
                                          int ob) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int nb = 0; nb < OB; ++nb) {
      if (nb >= ob) continue;
      const uint64_t dbh = kdesc(bh, br, j, 32 * nb);
      if constexpr (kSplit) {
        mma_rs(d[nb], lo[j], dbh);
        mma_rs(d[nb], hi[j], kdesc(bl, br, j, 32 * nb));
      }
      mma_rs(d[nb], hi[j], dbh);
    }
}

// total[nb] += d[nb] for the output blocks nb < ob, one correctly rounded
// add each.  A total over many tiles sums each tile's products in a fresh
// accumulator and adds it here: the tensor cores' own sums truncate, and a
// total carried through them over a thousand keys drifts past 1e-5 of the
// plain version.
template <int OB>
__device__ __forceinline__ void add_out(float (&total)[OB][4][4],
                                        const float (&d)[OB][4][4], int ob) {
#pragma unroll
  for (int nb = 0; nb < OB; ++nb) {
    if (nb >= ob) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        total[nb][n][e] = __fadd_rn(total[nb][n][e], d[nb][n][e]);
  }
}

// total += d, one correctly rounded add each (a score product over head
// chunks: each chunk's sum in a fresh accumulator, as add_out).
template <int NT>
__device__ __forceinline__ void add_acc(float (&total)[NT][4],
                                        const float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      total[n][e] = __fadd_rn(total[n][e], d[n][e]);
}

template <int OB>
__device__ __forceinline__ void fence_out(float (&d)[OB][4][4]) {
#pragma unroll
  for (int nb = 0; nb < OB; ++nb) fwg::fence_acc(d[nb]);
}

template <int OB>
__device__ __forceinline__ void zero_out(float (&d)[OB][4][4]) {
#pragma unroll
  for (int nb = 0; nb < OB; ++nb) fwg::zero_acc(d[nb]);
}

// f32 x as T and back: the rounding site of a bf16 operand (p, dS), none
// in f32.
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return round_to(x, static_cast<T*>(nullptr));
}

// Store columns col, col + 1 of a row of hd elements of T (pairs where hd
// is even).
__device__ __forceinline__ void store_pair(float* row, int col, int hd,
                                           float x, float y) {
  if (col < hd) row[col] = x;
  if (col + 1 < hd) row[col + 1] = y;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col,
                                           int hd, float x, float y) {
  if ((hd & 1) == 0) {
    if (col < hd) flash::store2(row + col, x, y);
  } else {
    if (col < hd) row[col] = __float2bfloat16_rn(x);
    if (col + 1 < hd) row[col + 1] = __float2bfloat16_rn(y);
  }
}

}  // namespace ftf

// What the fp32 attention kernels share (attention_tf32.cu, the forward;
// attention_bwd_tf32.cu, the backward): products of fp32 values on Hopper's
// tensor cores from split TF32 operands, on mma.sync and on wgmma, fragment
// loads from device memory and from fp32 rows in shared memory, cp.async
// staging of a head's [T, 64] fp32 slice, and split copies for wgmma (sm_90a).
//
// The tensor cores take TF32 operands: 10 mantissa bits, so one pass is off by
// ~1e-3 relative on a D=64 score, far outside fp32's 1e-5 tolerance. A value x
// is split into hi = rna(x) and lo = rna(x - hi), where rna rounds to the
// nearest TF32 value, ties away from zero (cvt.rna.tf32.f32: add 0x1000 to the
// fp32 bits and clear the 13 low ones; x - hi is exact in fp32):
//   * 3xTF32 (the long kernels): a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the
//     small cross products first (the order of CUTLASS's "fast F32"). What is
//     left out, a_lo.b_lo and the rounding of lo, is below ~2^-21 of each term.
//   * six products (the short kernels): a third part rna(x - hi - mid) and
//     every term down to 2^-22 of hi.hi, as accurate as an fp32 product.
// The tensor core's sums do not round to nearest: their error is relative to
// the largest addend, so where registers allow, the products of a step go to a
// fresh accumulator added in fp32, or the small products are summed first.
//
// Fragment layouts of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (and of a
// warp's 16 rows of wgmma m64nNk8), for lane = 4 g + t: A (16 x 8) a0 = (g, t),
// a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4); B (8 x 8, k x n)
// b0 = (t, g), b1 = (t + 4, g); C (16 x 8) c0 = (g, 2t), c1 = (g, 2t + 1),
// c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1). An accumulator tile becomes the A
// operand of the next product over its columns without a shuffle by
// relabelling the depth: depth position t is column 2t and t + 4 is column
// 2t + 1 (a = {c0, c2, c1, c3}), and the B rows are read in the same order
// (`ldb_cols`, `ldg_cols`, `split_sw_cols`).

#pragma once

#include "attention_mma.cuh"

namespace {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The same rounding by integer operations on the fp32 bits: cvt.rna.tf32.f32
// issues at a quarter of the rate of an integer add, and a kernel that splits
// every streamed chunk is bound by it (INT below).
__device__ __forceinline__ uint32_t tf32_rna_int(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// x -> (hi, lo) as TF32 operands
template <bool INT = false>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = INT ? tf32_rna_int(x) : tf32_rna(x);
  lo = INT ? tf32_rna_int(x - __uint_as_float(hi)) : tf32_rna(x - __uint_as_float(hi));
}

struct SplitA {
  uint32_t hi[4], lo[4];
};

// x -> (hi, mid, lo): a third TF32 part, rna(x - hi - mid), for the short
// kernels' six-product form
struct Split3A {
  uint32_t hi[4], mid[4], lo[4];
};

template <bool INT = false>
__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2, float a3) {
  SplitA s;
  split<INT>(a0, s.hi[0], s.lo[0]);
  split<INT>(a1, s.hi[1], s.lo[1]);
  split<INT>(a2, s.hi[2], s.lo[2]);
  split<INT>(a3, s.hi[3], s.lo[3]);
  return s;
}

__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  split(x, hi, mid);
  lo = tf32_rna(x - __uint_as_float(hi) - __uint_as_float(mid));  // both subtractions exact
}

__device__ __forceinline__ Split3A split3_a(float a0, float a1, float a2, float a3) {
  Split3A s;
  const float x[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(x[i], s.hi[i], s.mid[i], s.lo[i]);
  return s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32, b given as its two fp32 values, the cross products
// first (the long backward, whose registers are full: its 3xTF32 sums chain
// in the accumulator)
__device__ __forceinline__ void mma3(float (&d)[4], const SplitA& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

// d += a . b with a three-way split of both (six products: every term down to
// 2^-22 of hi.hi, the smallest first), b given as its two fp32 values, into a
// fresh fragment added to d in fp32: the tensor core's own sums do not round
// to nearest, and chained over a row their error grows with the running sum.
// The short kernels, bound by bytes, take the products to fp32's accuracy
// this way.
__device__ __forceinline__ void mma6(float (&d)[4], const Split3A& a, float b0, float b1) {
  uint32_t h0, m0, l0, h1, m1, l1;
  split3(b0, h0, m0, l0);
  split3(b1, h1, m1, l1);
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, a.hi, l0, l1);
  mma_tf32(p, a.lo, h0, h1);
  mma_tf32(p, a.mid, m0, m1);
  mma_tf32(p, a.hi, m0, m1);
  mma_tf32(p, a.mid, h0, h1);
  mma_tf32(p, a.hi, h0, h1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}

// The A operand of depth step k0 (8 of the 64 head dimensions) from rows g
// and g + 8 of a row-major fp32 matrix in device memory (row stride
// `stride`), split three ways for the short kernels; rows >= n_valid read as 0.
__device__ __forceinline__ Split3A lda_global(const float* __restrict__ rows, int n_valid, size_t stride, int k0,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  if (g < n_valid) {
    const float* p = rows + static_cast<size_t>(g) * stride + k0 + t;
    x[0] = __ldg(p);
    x[2] = __ldg(p + 4);
  }
  if (g + 8 < n_valid) {
    const float* p = rows + static_cast<size_t>(g + 8) * stride + k0 + t;
    x[1] = __ldg(p);
    x[3] = __ldg(p + 4);
  }
  return split3_a(x[0], x[1], x[2], x[3]);
}

// An accumulator tile (the columns of one 8-wide tile) as the A operand of a
// product over those columns (depth order 2t, 2t + 1: see the header).
template <bool INT = false>
__device__ __forceinline__ SplitA acc_as_a(const float (&c)[4]) { return split_a<INT>(c[0], c[2], c[1], c[3]); }
__device__ __forceinline__ Split3A acc_as_a3(const float (&c)[4]) { return split3_a(c[0], c[2], c[1], c[3]); }

// The same two operands read from device memory (row stride `stride`) for a
// warp that has no shared-memory copy; rows >= n_valid read as 0.
__device__ __forceinline__ void ldg_rows(const float* __restrict__ m, size_t stride, int n_valid, int n0, int k0,
                                         int lane, float& b0, float& b1) {
  const int r = n0 + (lane >> 2);
  b0 = b1 = 0.f;
  if (r < n_valid) {
    const float* p = m + static_cast<size_t>(r) * stride + k0 + (lane & 3);
    b0 = __ldg(p);
    b1 = __ldg(p + 4);
  }
}

__device__ __forceinline__ void ldg_cols(const float* __restrict__ m, size_t stride, int n_valid, int k0, int n0,
                                         int lane, float& b0, float& b1) {
  const int r = k0 + 2 * (lane & 3);
  const float* p = m + static_cast<size_t>(r) * stride + n0 + (lane >> 2);
  b0 = r < n_valid ? __ldg(p) : 0.f;
  b1 = r + 1 < n_valid ? __ldg(p + stride) : 0.f;
}

// v = s * scale * log2(e) (+ mask * log2(e)) for the thread's four entries of
// an 8-key tile (rows ra, ra + 8; columns c, c + 1); columns >= t get -inf.
__device__ __forceinline__ void scores_to_log2(float (&s)[4], const float* __restrict__ mask, int t, int ra,
                                               int c, float sc) {
  const int rb = ra + 8;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = c + e;
    float ma = 0.f, mb = 0.f;
    if (mask != nullptr && col < t) {
      if (ra < t) ma = __ldg(mask + static_cast<size_t>(ra) * t + col);
      if (rb < t) mb = __ldg(mask + static_cast<size_t>(rb) * t + col);
    }
    s[e] = col < t ? fmaf(ma, kLog2e, s[e] * sc) : -INFINITY;
    s[2 + e] = col < t ? fmaf(mb, kLog2e, s[2 + e] * sc) : -INFINITY;
  }
}

// ---- whole slices in shared memory (the long backward)

constexpr int kRow = kD + 4;  // floats a padded shared-memory row: every fragment load below is free of bank conflicts

// B operand from a padded shared-memory tile whose rows are the product's
// columns and whose row elements are its depth (S = Q.K^T with K's rows):
// b0 = tile[n0 + g][k0 + t], b1 = tile[n0 + g][k0 + t + 4].
__device__ __forceinline__ void ldb_rows(const float* tile, int n0, int k0, int lane, float& b0, float& b1) {
  const float* p = tile + (n0 + (lane >> 2)) * kRow + k0 + (lane & 3);
  b0 = p[0];
  b1 = p[4];
}

// B operand from a padded shared-memory tile whose rows are the product's
// depth, in the order of `acc_as_a` (dq = dS.K with K's rows):
// b0 = tile[k0 + 2t][n0 + g], b1 = tile[k0 + 2t + 1][n0 + g].
__device__ __forceinline__ void ldb_cols(const float* tile, int k0, int n0, int lane, float& b0, float& b1) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * kRow + n0 + (lane >> 2);
  b0 = p[0];
  b1 = p[kRow];
}

// Rows [0, n_rows) x 64 columns of a row-major fp32 matrix in device memory
// (row stride `stride`) into padded shared-memory rows by cp.async; rows >=
// n_valid are zero-filled and never read from device memory.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int n_rows, int n_valid, size_t stride,
                                          int tid, int nthreads) {
  for (int idx = tid; idx < n_rows * 16; idx += nthreads) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    float* d = dst + r * kRow + c;
    if (r < n_valid) {
      cp_async16(smem_u32(d), src + static_cast<size_t>(r) * stride + c);
    } else {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}


// The A operands of 16 rows over the 64 head dimensions, from device memory
// (rows >= n_valid read as 0), split in the long kernels' 3xTF32 form.
__device__ __forceinline__ void load_rows_a(SplitA (&a)[8], const float* __restrict__ rows, int n_valid,
                                            size_t stride, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* p = rows + static_cast<size_t>(g) * stride + 8 * k + t;
    a[k] = split_a(g < n_valid ? __ldg(p) : 0.f, g + 8 < n_valid ? __ldg(p + 8 * stride) : 0.f,
                   g < n_valid ? __ldg(p + 4) : 0.f, g + 8 < n_valid ? __ldg(p + 8 * stride + 4) : 0.f);
  }
}

// ---- warpgroup products (wgmma) on split tiles in shared memory
//
// wgmma takes TF32 B operands from shared memory K-major only. A chunk of 64
// rows of a head's slice is split once per CTA into a hi and a lo copy, each
// in 128-byte rows with the 128-byte swizzle of attention_mma.cuh (so that
// `wgmma_desc` describes them), two tiles of 8 KB a copy:
//   rows layout (the slice's rows are the product's columns, the head
//   dimensions its depth; S = Q.K^T with K): tile h holds head dimensions
//   32h .. 32h + 31 of the 64 rows;
//   columns layout (the rows are the product's depth; O = P.V with V):
//   tile h holds rows 32h .. 32h + 31 for each of the 64 head dimensions, in
//   the depth order of `acc_as_a` within each group of 8 (positions 0-3 the
//   even rows, 4-7 the odd ones).
constexpr int kSwHalf = 64 * kRowBytes;   // one tile: 64 rows of 128 bytes
constexpr int kSwCopy = 2 * kSwHalf;      // a hi or a lo copy of a chunk

template <bool INT = false>
__device__ __forceinline__ void split4(const float (&x)[4], uint4& hi, uint4& lo) {
  split<INT>(x[0], hi.x, lo.x);
  split<INT>(x[1], hi.y, lo.y);
  split<INT>(x[2], hi.z, lo.z);
  split<INT>(x[3], hi.w, lo.w);
}

// ROWS raw rows (kRow floats each) -> hi / lo copies in the rows layout (a
// tile of ROWS rows of 128 bytes for each half of the head dimensions)
template <int ROWS = 64, bool INT = false>
__device__ __forceinline__ void split_sw_rows(unsigned char* hi, unsigned char* lo, const float* raw, int tid,
                                              int nthreads) {
  for (int idx = tid; idx < ROWS * 16; idx += nthreads) {
    const int r = idx >> 4, c = idx & 15;
    const float4 v = *reinterpret_cast<const float4*>(raw + r * kRow + 4 * c);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint4 h, l;
    split4<INT>(x, h, l);
    const int off = (c >> 3) * (ROWS * kRowBytes) + tile_off(r, c & 7);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// 64 rows of a row-major fp32 matrix in device memory (row stride `stride`;
// rows >= n_valid read as 0) -> hi / lo copies in the rows layout, with no
// staging: the operands a CTA keeps for its whole run
__device__ __forceinline__ void split_sw_rows_global(unsigned char* hi, unsigned char* lo,
                                                     const float* __restrict__ src, int n_valid, size_t stride,
                                                     int tid, int nthreads) {
  for (int idx = tid; idx < 64 * 16; idx += nthreads) {
    const int r = idx >> 4, c = idx & 15;
    const float4 v = r < n_valid ? __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * stride + 4 * c))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint4 h, l;
    split4<true>(x, h, l);
    const int off = (c >> 3) * kSwHalf + tile_off(r, c & 7);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// ROWS raw rows -> hi / lo copies in the columns layout (ROWS / 32 tiles)
template <int ROWS = 64, bool INT = false>
__device__ __forceinline__ void split_sw_cols(unsigned char* hi, unsigned char* lo, const float* raw, int tid,
                                              int nthreads) {
  for (int idx = tid; idx < 64 * (ROWS / 4); idx += nthreads) {
    const int d = idx & 63, j = idx >> 6;  // 16-byte piece j of row d: positions 4 (j & 1) .. of row group j / 2
    const float* src = raw + (8 * (j >> 1) + (j & 1)) * kRow + d;
    const float x[4] = {src[0], src[2 * kRow], src[4 * kRow], src[6 * kRow]};
    uint4 h, l;
    split4<INT>(x, h, l);
    const int off = (j >> 3) * kSwHalf + tile_off(d, j & 7);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// Descriptor of depth step k (8 of the 64) of a split copy whose halves (32
// depth positions each) are `half` bytes apart: a rows-layout copy of R rows
// has R * 128, a columns-layout copy kSwHalf
__device__ __forceinline__ uint64_t sw_desc(uint32_t copy, int k, int half = kSwHalf) {
  return wgmma_desc(copy + (k >> 2) * half + (k & 3) * 32);
}

// d[64 x N] (+)= a[64 x 8] . b[8 x N], TF32 in, fp32 out, N = 16, 32 or 64; a
// thread's N / 2 accumulators are N / 8 tiles of 8 columns in the layout of
// mma.sync's.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t (&a)[4], uint64_t desc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float* d, const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : RLCF_ACC8(d, 0), RLCF_ACC8(d, 8), RLCF_ACC8(d, 16), RLCF_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float* d, const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : RLCF_ACC8(d, 0), RLCF_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float* d, const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : RLCF_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d = a . b over K depth steps of 8 in 3xTF32, N columns: every a_lo.b_hi and
// a_hi.b_lo first, then the a_hi.b_hi, so that only the last K of the 3K
// products are added to a sum of their own size (the tensor core's sums do
// not round to nearest; their error is relative to the largest addend). With
// `chain` the products add to d, else d starts at 0.
template <int N, int K>
__device__ __forceinline__ void wgmma3(float* d, const SplitA* a, uint32_t bhi, uint32_t blo, bool chain = false) {
#pragma unroll
  for (int k = 0; k < K; ++k) wgmma_tf32<N>(d, a[k].lo, sw_desc(bhi, k), chain || k > 0);
#pragma unroll
  for (int k = 0; k < K; ++k) wgmma_tf32<N>(d, a[k].hi, sw_desc(blo, k), 1);
#pragma unroll
  for (int k = 0; k < K; ++k) wgmma_tf32<N>(d, a[k].hi, sw_desc(bhi, k), 1);
}

// d[64 x N] (+)= a[64 x 8] . b[8 x N] with both operands read from split
// copies in shared memory (a: 64 rows in the rows layout, K-major as b; TF32
// takes no transpose), N = 32.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t adesc, uint64_t bdesc, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float* d, uint64_t adesc, uint64_t bdesc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : RLCF_ACC8(d, 0), RLCF_ACC8(d, 8)
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// An A operand in shared memory: a 64-row split copy pair in the rows layout
// (halves kSwHalf apart), K-major as b.
struct SmemA {
  uint32_t hi, lo;
};

// One wgmma of depth step k with the hi (HI) or lo part of A, from registers
// or from shared memory.
template <int N, bool HI>
__device__ __forceinline__ void wgmma_part(float* d, const SplitA* a, int k, uint64_t bdesc, int accumulate) {
  wgmma_tf32<N>(d, HI ? a[k].hi : a[k].lo, bdesc, accumulate);
}

template <int N, bool HI>
__device__ __forceinline__ void wgmma_part(float* d, SmemA a, int k, uint64_t bdesc, int accumulate) {
  wgmma_tf32_ss<N>(d, sw_desc(HI ? a.hi : a.lo, k), bdesc, accumulate);
}

// Two independent 3xTF32 products over K depth steps, each in wgmma3's order,
// their wgmma issued in turn. b's halves are `bhalf` bytes apart; with
// `chain` the products add to d0 / d1, else they start at 0.
template <int N, int K, typename A0, typename A1>
__device__ __forceinline__ void wgmma3_pair(float* d0, A0 a0, uint32_t b0hi, uint32_t b0lo, float* d1, A1 a1,
                                            uint32_t b1hi, uint32_t b1lo, int bhalf, bool chain = false) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wgmma_part<N, false>(d0, a0, k, sw_desc(b0hi, k, bhalf), chain || k > 0);
    wgmma_part<N, false>(d1, a1, k, sw_desc(b1hi, k, bhalf), chain || k > 0);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wgmma_part<N, true>(d0, a0, k, sw_desc(b0lo, k, bhalf), 1);
    wgmma_part<N, true>(d1, a1, k, sw_desc(b1lo, k, bhalf), 1);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wgmma_part<N, true>(d0, a0, k, sw_desc(b0hi, k, bhalf), 1);
    wgmma_part<N, true>(d1, a1, k, sw_desc(b1hi, k, bhalf), 1);
  }
}

// A 16 x 64 accumulator block (8 tiles of 8 columns) times `factor` to rows
// r0 + g and r0 + g + 8 of a row-major fp32 matrix (row stride `stride`) as
// 8-byte pieces; rows >= n_valid are not stored.
__device__ __forceinline__ void store_rows(const float (&o)[8][4], float* __restrict__ rows, int n_valid,
                                           size_t stride, float fa, float fb, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (g < n_valid) {
      *reinterpret_cast<float2*>(rows + static_cast<size_t>(g) * stride + nt * 8 + 2 * t) =
          make_float2(o[nt][0] * fa, o[nt][1] * fa);
    }
    if (g + 8 < n_valid) {
      *reinterpret_cast<float2*>(rows + static_cast<size_t>(g + 8) * stride + nt * 8 + 2 * t) =
          make_float2(o[nt][2] * fb, o[nt][3] * fb);
    }
  }
}

}  // namespace

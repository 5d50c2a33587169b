// Fused AugMix view generation for Hopper (sm_90a): u8 source images to u8
// views, every stage on chip.
//
// Replaces the TPU kernel `_augmix_kernel` of rlcf_tpu/ops/pallas_augmix.py
// (with `_apply_op`, `_warp_pass`, `_equalize_plane`, `_resize_weights`;
// `_fused_call` / `fused_views`).
//
//   in : src [N, 3, S, S] u8, basew [R, S] f32 (bicubic, view 0), per view
//        (rows n*V + v): rrc [4] f32 (top, left, h, w), flip, depth [3],
//        ops [9], ip0 [9] i32, p0 [9], p1 [9], wm [3], m f32
//   out: views [N, V, 3, R, R] u8
//
// View 0 is basew @ src @ basew^T. Views 1.. are a RandomResizedCrop with a
// free horizontal flip (triangle-kernel weights built from the 4 box
// scalars), then 3 AugMix chains of depth 0-3 over 9 PIL ops (0
// autocontrast, 1 equalize, 2 posterize, 3 rotate as three shears, 4
// solarize, 5/6 shear x/y, 7/8 translate x/y), each op rounding its output,
// then m*orig + (1-m)*mix, mix = w0*c0 + w1*c1 + w2*c2 summed in that order,
// rounded to u8. Rounding is rintf (half to even, as jnp.round); the file is
// built with -fmad=false, so a product and a sum round separately unless the
// code calls fmaf, which it does exactly where the reference output fuses
// them (the warp's tap pair, see pair_sum). The crop's dot products are summed
// in float64 (exact for their few nonzero terms, and in a fixed order) and
// rounded once to float32, as in the plain version.
//
// What bounds it: the bytes it must move are only the u8 sources and views
// (N*3*S*S + N*V*3*R*R, 39.3 MB for a flagship group: 0.012 ms at 3.35 TB/s);
// the arithmetic (crop taps, a few operations per pixel and op) is 1.7 GFLOP
// of fp32 CUDA-core work per group, 0.025 ms at 67 TFLOP/s: the card's floor
// is set by operations. What holds this kernel far above that floor is
// instruction issue and latency per pixel with 32 warps an SM: the crop's
// exact float64 sums (double-precision multiply-adds and conversions, two
// passes with a barrier between them), the rotate's three passes, and a
// barrier before each warp op.
//
// Design: one CTA of 512 threads per (image, view, channel), every stage of
// the TPU kernel being per channel. In the chains each thread owns 4 adjacent
// pixels (a 32-bit word of a plane whose rows are padded to a multiple of 4)
// of a fixed column on a run of consecutive rows, so that pointwise work
// needs no barrier.
// - Two u8 planes in shared memory (the working plane and the one a warp op
//   writes), 2 x 49 KB at R = 224, plus 8.4 KB of tables: two CTAs share an
//   SM (32 warps). The cropped original is kept in the output view (device
//   memory, read back through L2 at each chain start and in the final blend,
//   8 words in flight a thread); the first two chains' results are kept as
//   u8 in a device scratch buffer, and the f32 mix is formed once, at the
//   end, in the reference's order.
// - Views above ~330 px (the 336, 384 and 448 px towers): two planes no
//   longer fit a CTA's 227 KB (2 x 113 KB at R = 336, 2 x 196 KB at 448).
//   One plane stays in shared memory, with the crop's strip behind its tables;
//   the other (the one a warp op writes every other time) goes to the device
//   scratch as a third plane a CTA, reached through L1 and L2 by the same
//   code (generic pointers; the instance is a template argument, so the
//   smaller views' code is what it was). One CTA an SM there.
// - The crop: its tables (support and float64 weights of every output row
//   and column) are built once per CTA in the first plane, so no tap
//   recomputes a weight. The row pass reads source rows 2 bytes at a time,
//   all of a sum's loads in flight at once, into a float64 strip of up to 32
//   rows in the second plane; the column pass keeps a column's weights in
//   registers, a warp covering 32 adjacent columns.
// - Ops work on words: posterize and solarize are byte-parallel integer
//   operations; autocontrast builds a 256-entry table once (the division per
//   pixel goes), equalize its histogram with shared atomics; both then map
//   bytes through the table. Bytes become floats exactly with a byte permute
//   and a subtraction, and floats in [0, 2^22) become rounded bytes with one
//   addition of 1.5 * 2^23.
// - Warps: a shift along W is one per row, along H one per column (computed
//   once per op in registers). The rotate reads its per-row and per-column
//   shifts from tables built once per op and shares its intermediate passes
//   among a thread's 4 pixels and down its rows: per row, 5 first-pass values
//   (10 source reads) for 4 output pixels, against 32 reads in the first
//   version, bit-identical to materialising the unrounded passes.
// - Balance: the CTAs of the costliest views start first (view_of), so that
//   the last wave is light.
// - A barrier only where a thread reads what another wrote: before a warp op,
//   and inside autocontrast's and equalize's block reductions.
//
// Plain C interface (bound with ctypes): rlcf_augmix_views returns
// cudaGetLastError() after the launch, or kBadArgs for shapes it refuses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;       // most output rows per pass of the crop
constexpr int kTaps = 6;         // crop weights kept per output index (more are recomputed)
constexpr int kAhead = 4;        // crop taps held in registers (more are read as they come)
constexpr int kBatch = 8;        // device-memory words a thread has in flight at once
constexpr int kBins = 256;
constexpr int kChains = 3;
constexpr int kDepth = 3;
constexpr int kSteps = kChains * kDepth;
constexpr int kBadArgs = 9001;
constexpr size_t kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

struct Axis {     // per output index: the crop's source support and weight recipe
  float center;   // triangle: sample center in source coordinates
  float inv;      // triangle: 1 / max(scale, 1)
  float denom;    // triangle: max(sum of the weights, 1e-12)
  int lo_cnt;     // (first source index with a nonzero weight) | (count up to the last) << 16
};

struct Shift {    // one warp shift: taps d, d+1 with weights wa = 1 - f, wb = f
  int d;          // floor(shift) clipped to the window
  float wa, wb;
  int mode;       // bits 0-1: how pair_sum adds the pair; bit 2: tap d+1 is inside the window
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline size_t max_sz(size_t a, size_t b) { return a > b ? a : b; }

// Shared memory, in one of two layouts. Where two planes fit (R up to ~330):
// plane A (the crop's tables, then a working plane), plane B (the crop's
// float64 strip, then the other working plane), the rotate's shift tables,
// the histogram, the byte table and the reduction slots. Above (`large`: R =
// 331 .. 464, the towers at 336, 384 and 448 px): plane A holds the tables
// and, behind them, the strip during the crop, then a working plane; plane B
// lives in the device scratch beside the kept chains (`keep`, three planes a
// CTA), read and written through the same generic pointers.
struct Layout {
  size_t a, b, strip, total;   // b = 0 where plane B is in device memory; strip: its offset in shared memory
  int strip_rows;
  bool large;
};

// the strip's rows that fit in `room` bytes, 1 to kStrip
__host__ __device__ inline int strip_rows_in(size_t room, size_t sp) {
  const size_t rows = room / (8 * sp);
  return static_cast<int>(rows < 1 ? 1 : (rows > kStrip ? kStrip : rows));
}

__host__ __device__ inline Layout layout(int r, int s) {
  const size_t rp = (static_cast<size_t>(r) + 3) & ~static_cast<size_t>(3);
  const size_t sp = (static_cast<size_t>(s) + 3) & ~static_cast<size_t>(3);
  const size_t plane = static_cast<size_t>(r) * rp;
  const size_t tables = 2 * align16(8 * static_cast<size_t>(r) * kTaps) +
                        2 * sizeof(Axis) * r + sizeof(int) * r;
  const size_t rest = 2 * sizeof(Shift) * r + kBins * sizeof(int) + kBins + 2 * kWarps * sizeof(int) + 16;
  Layout L;
  L.strip_rows = strip_rows_in(plane, sp);
  L.a = align16(max_sz(plane, tables));
  L.b = align16(max_sz(plane, 8 * sp * L.strip_rows));
  L.strip = L.a;
  L.total = L.a + L.b + rest;
  L.large = L.total > kMaxSmem;
  if (L.large) {
    const size_t t16 = align16(tables);
    L.strip_rows = strip_rows_in(plane > t16 ? plane - t16 : 0, sp);
    L.a = align16(max_sz(plane, t16 + 8 * sp * L.strip_rows));
    L.b = 0;
    L.strip = t16;
    L.total = L.a + rest;
  }
  return L;
}

struct Params {
  const uint8_t* src;
  const float* basew;
  const float* rrc;
  const int* flip;
  const int* depth;
  const int* ops;
  const float* p0;
  const float* p1;
  const int* ip0;
  const float* wm;
  const float* m;
  uint8_t* out;
  uint8_t* keep;    // [N*V*3, 2 or 3, R, Rp]: the first two chains' results (and plane B where it is large)
  int v, r, s;
  int ms_ra, ms_rb, ms_sh, ms_tr;   // tap windows: rotate alpha / beta passes, shear, translate
};

__device__ __forceinline__ float clamp_round(float x) { return fminf(fmaxf(rintf(x), 0.0f), 255.0f); }

// exact float of a byte: 2^23 + v built from its bits, less 2^23
__device__ __forceinline__ float byte_f(uint32_t v) { return __uint_as_float(0x4B000000u | v) - 8388608.0f; }
__device__ __forceinline__ float word_byte_f(uint32_t w, int t) {
  return __uint_as_float(__byte_perm(w, 0x4B00u, 0x5440u | t)) - 8388608.0f;
}
// exact float64 of a byte
__device__ __forceinline__ double byte_d(uint32_t v) { return __hiloint2double(0x43300000, v) - 4503599627370496.0; }
// rintf(x) as a byte for 0 <= x < 2^22: x + 1.5 * 2^23 rounds to an integer
// (half to even) whose low mantissa bits are rintf(x)
__device__ __forceinline__ uint32_t round_byte(float x) { return __float_as_uint(x + 12582912.0f) & 0xFFu; }
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}

// ---- crop weights (_resize_weights) ----------------------------------------

__device__ __forceinline__ float tri_raw(int j, float center, float inv) {
  const float d = ((static_cast<float>(j) + 0.5f) - center) * inv;
  return fmaxf(0.0f, 1.0f - fabsf(d));
}

// one output index of a triangle axis: scale = length / R, center = start +
// (o' + 0.5) * scale with o' = R-1-o when flipped, weights
// max(0, 1 - |(j + 0.5 - center) * inv|) / max(sum, 1e-12), the sum exact
// and rounded once to float32
__device__ Axis tri_axis(float start, float length, int flip, int o, int r, int s) {
  const float scale = length / static_cast<float>(r);
  const float oo = flip ? static_cast<float>(r - 1) - static_cast<float>(o) : static_cast<float>(o);
  Axis a;
  a.center = start + (oo + 0.5f) * scale;
  a.inv = 1.0f / fmaxf(scale, 1.0f);
  const float half = fmaxf(scale, 1.0f);
  const int j0 = max(0, static_cast<int>(floorf(fminf(fmaxf(a.center - half - 0.5f, -2.0f), 1e6f))) - 1);
  const int j1 = min(s - 1, static_cast<int>(ceilf(fminf(fmaxf(a.center + half, -2.0f), 1e6f))) + 1);
  int lo = -1, hi = -1;
  double sum = 0.0;  // exact for these few terms: the normalizer does not depend on the order
  for (int j = j0; j <= j1; ++j) {
    const float w = tri_raw(j, a.center, a.inv);
    if (w > 0.0f) {
      if (lo < 0) lo = j;
      hi = j;
      sum += static_cast<double>(w);
    }
  }
  a.denom = fmaxf(static_cast<float>(sum), 1e-12f);
  a.lo_cnt = lo < 0 ? 0 : (lo | ((hi - lo + 1) << 16));
  return a;
}

// the base view: the nonzero support of basew's row o, by one warp
__device__ Axis base_axis(const float* basew, int o, int s) {
  int lo = s, hi = -1;
  for (int j = threadIdx.x & 31; j < s; j += 32) {
    if (basew[static_cast<size_t>(o) * s + j] != 0.0f) {
      lo = min(lo, j);
      hi = max(hi, j);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  Axis a;
  a.center = a.inv = a.denom = 0.0f;
  a.lo_cnt = hi < 0 ? 0 : (lo | ((hi - lo + 1) << 16));
  return a;
}

__device__ __forceinline__ float axis_weight(const Axis& a, bool base, const float* basew, int o, int j, int s) {
  return base ? basew[static_cast<size_t>(o) * s + j] : tri_raw(j, a.center, a.inv) / a.denom;
}

// ---- warps (_warp_pass) ------------------------------------------------------

__device__ __forceinline__ Shift make_shift(float shift, int ms) {
  const float d0 = floorf(shift);
  const float f = shift - d0;
  Shift sh;
  sh.d = static_cast<int>(fminf(fmaxf(d0, static_cast<float>(-ms)), static_cast<float>(ms)));
  sh.wa = 1.0f - f;
  sh.wb = f;
  const int tap = sh.d + ms;   // position of tap d among the window's 2*ms+1 taps
  const bool single_last = (2 * ms + 1) % 5 == 1 && tap + 1 == 2 * ms;
  const int kind = (tap % 5 == 4 && !single_last) ? 0 : (tap % 5 == 0 ? 1 : 2);
  sh.mode = kind | (sh.d < ms ? 4 : 0);
  return sh;
}

__device__ __forceinline__ bool has_b(const Shift& sh) { return (sh.mode & 4) != 0; }

// (1-f)*x[i+d] + f*x[i+d+1], summed as the reference output sums it:
// `_warp_pass` adds its taps in chunks of 5 and XLA contracts each product
// into the running sum as a fused multiply-add. The first two terms of a
// chunk fuse the first product (kind 1 or 2); a tap that starts a chunk of
// more than one tap starts a new partial sum (kind 0); a chunk of one tap
// fuses into the total.
__device__ __forceinline__ float pair_sum(const Shift& sh, float xa, float xb) {
  const float pa = sh.wa * xa;
  const float pb = sh.wb * xb;
  const int kind = sh.mode & 3;
  return kind == 0 ? pa + pb : (kind == 1 ? fmaf(sh.wa, xa, pb) : fmaf(sh.wb, xb, pa));
}

// a byte of plane x at (row, col), 0 outside the plane
__device__ __forceinline__ float pix(const uint8_t* x, int rp, int r, int row, int col) {
  return (row >= 0 && row < r && col >= 0 && col < r) ? byte_f(x[row * rp + col]) : 0.0f;
}

// the rotate's first pass (along W, row shift sa) at (row, col)
__device__ __forceinline__ float rot_pass1(const uint8_t* x, const Shift* rt, int rp, int r, int row, int col) {
  if (row < 0 || row >= r) return 0.0f;
  const Shift sa = rt[row];
  const int ia = col + sa.d;
  const float xa = pix(x, rp, r, row, ia);
  const float xb = has_b(sa) ? pix(x, rp, r, row, ia + 1) : 0.0f;
  return pair_sum(sa, xa, xb);
}

// ---- block helpers -----------------------------------------------------------

// one value per warp into red[slot * kWarps + warp]; after the barrier every
// thread reads the kWarps values
__device__ __forceinline__ void warp_min_max(int& mn, int& mx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(kFull, mn, off));
    mx = max(mx, __shfl_xor_sync(kFull, mx, off));
  }
}

// PIL ImageOps.equalize's table from the integer histogram: step = (total -
// count of the last nonzero bin) / 255, lut[b] = (step / 2 + cum[b]) / step
// (exclusive cum); the identity when at most one bin is used or step is 0.
// One warp; it clears the histogram for the next equalize.
__device__ void equalize_table(int* hist, uint8_t* lut) {
  const int lane = threadIdx.x;
  int h[8];
  int own = 0, nnz = 0, last = -1;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    h[e] = hist[lane * 8 + e];
    own += h[e];
    if (h[e] > 0) {
      ++nnz;
      last = lane * 8 + e;
    }
  }
  int incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    nnz += __shfl_xor_sync(kFull, nnz, off);
    last = max(last, __shfl_xor_sync(kFull, last, off));
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int h_last = hist[max(last, 0)];
  __syncwarp();   // every lane has read hist before any clears it
  const int step = (total - h_last) / 255;
  const bool ident = nnz <= 1 || step == 0;
  int cum = incl - own;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int b = lane * 8 + e;
    lut[b] = static_cast<uint8_t>(ident ? b : min(255, (step / 2 + cum) / max(step, 1)));
    cum += h[e];
    hist[b] = 0;
  }
}

__device__ __forceinline__ uint32_t map_word(const uint8_t* lut, uint32_t w) {
  return pack4(lut[w & 0xFF], lut[(w >> 8) & 0xFF], lut[(w >> 16) & 0xFF], lut[w >> 24]);
}

// ---- work order ---------------------------------------------------------------

// relative cost of a view's CTA: 0 for a crop alone (m = 1), else the chains'
// fixed part and each step's op, in units of ~0.01 ms per step of a flagship
// group (the AUGMIX_PHASES line of chip_smoke.py)
__device__ int view_cost(const Params& P, int u) {
  constexpr int kOpCost[9] = {3, 4, 1, 17, 2, 6, 9, 6, 5};
  if (P.m[u] == 1.0f) return 0;
  int cost = 10;
  for (int chain = 0; chain < kChains; ++chain) {
    const int depth = min(P.depth[u * kChains + chain], kDepth);
    for (int st = 0; st < depth; ++st) {
      const int op = P.ops[u * kSteps + chain * kDepth + st];
      cost += (op >= 0 && op < 9) ? kOpCost[op] : 0;
    }
  }
  return cost;
}

// The view CTA group k works on: the k-th costliest of the nv views (ties in
// index order), so that the heaviest CTAs start first and the last wave is
// light. Every CTA ranks all views itself (nv costs in the scratch it is
// given, then one view's rank per thread); above kRanked views the order is
// the grid's. The output does not depend on the order.
constexpr int kRanked = 2048;
__device__ int view_of(const Params& P, int k, int nv, int* cost, size_t scratch, int* slot) {
  if (nv > kRanked || sizeof(int) * static_cast<size_t>(nv) > scratch) return k;
  for (int u = threadIdx.x; u < nv; u += kThreads) cost[u] = view_cost(P, u);
  __syncthreads();
  for (int u = threadIdx.x; u < nv; u += kThreads) {
    const int cu = cost[u];
    int rank = 0;
    for (int w = 0; w < nv; ++w) {
      const int cw = cost[w];
      rank += (cw > cu || (cw == cu && w < u)) ? 1 : 0;
    }
    if (rank == k) *slot = u;
  }
  __syncthreads();
  return *slot;
}

// ---- the kernel --------------------------------------------------------------

// LARGE: plane B in device memory (`Layout`)
template <bool LARGE>
__global__ void __launch_bounds__(kThreads, 2) augmix_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = P.r, s = P.s;
  const int rp = (r + 3) & ~3, wq = rp >> 2;
  const Layout L = layout(r, s);
  const int c = blockIdx.x % 3;
  const int tid = threadIdx.x;
  const int kept = LARGE ? 3 : 2;   // planes a CTA has in the scratch: the first two chains' results (and plane B)
  unsigned char* plane_a = smem;
  unsigned char* plane_b = LARGE ? P.keep + (static_cast<size_t>(blockIdx.x) * kept + 2) * r * rp : smem + L.a;
  Shift* rt = reinterpret_cast<Shift*>(smem + L.a + L.b);   // rotate: alpha shift per row
  Shift* ct = rt + r;                                     // rotate: beta shift per column
  int* hist = reinterpret_cast<int*>(ct + r);
  uint8_t* lut = reinterpret_cast<uint8_t*>(hist + kBins);
  int* red = reinterpret_cast<int*>(lut + kBins);
  int* span = red + 2 * kWarps;   // [0] first, [1] last source column of the x supports, [2] the view
  const int idx = view_of(P, blockIdx.x / 3, gridDim.x / 3, reinterpret_cast<int*>(plane_a), L.a, span + 2);
  const int n = idx / P.v;
  const bool base = (idx % P.v) == 0;
  // this thread's words: column word q of a run of consecutive rows [ib, ie)
  // (threads beyond di * wq own none)
  const int q = tid % wq, di = kThreads / wq, g = tid / wq;
  const int rb = (r + di - 1) / di;
  const int ib = g < di ? min(r, g * rb) : r, ie = g < di ? min(r, ib + rb) : r;

  // crop tables in plane A, the weights in float64: the columns' k-major (a
  // warp reads 32 adjacent columns), the rows' row-major (a warp reads one
  // row's); both axes' recipes, and the columns' supports
  double* wx = reinterpret_cast<double*>(plane_a);
  double* wy = reinterpret_cast<double*>(plane_a + align16(8 * static_cast<size_t>(r) * kTaps));
  Axis* ay = reinterpret_cast<Axis*>(reinterpret_cast<unsigned char*>(wy) + align16(8 * static_cast<size_t>(r) * kTaps));
  Axis* ax = ay + r;
  int* xsup = reinterpret_cast<int*>(ax + r);
  double* strip = reinterpret_cast<double*>(smem + L.strip);

  // ---- 1. crop tables ----
  if (tid == 0) {
    span[0] = s;
    span[1] = -1;
  }
  for (int b = tid; b < kBins; b += kThreads) hist[b] = 0;
  __syncthreads();
  const float* box = P.rrc + static_cast<size_t>(idx) * 4;
  if (base) {   // one warp per output index: both axes are basew's rows
    const int lane = tid & 31;
    for (int o = tid >> 5; o < r; o += kWarps) {
      const Axis a = base_axis(P.basew, o, s);
      const int lo = a.lo_cnt & 0xffff, cnt = a.lo_cnt >> 16;
      if (lane < min(cnt, kTaps)) {
        const float w = P.basew[static_cast<size_t>(o) * s + lo + lane];
        wy[o * kTaps + lane] = static_cast<double>(w);
        wx[lane * r + o] = static_cast<double>(w);
      }
      if (lane == 0) {
        ay[o] = ax[o] = a;
        xsup[o] = a.lo_cnt;
        if (cnt > 0) {
          atomicMin(&span[0], lo);
          atomicMax(&span[1], lo + cnt - 1);
        }
      }
    }
  } else {
    int jmin = s, jmax = -1;
    for (int o = tid; o < r; o += kThreads) {
      const Axis y = tri_axis(box[0], box[2], 0, o, r, s);
      const Axis x = tri_axis(box[1], box[3], P.flip[idx], o, r, s);
      ay[o] = y;
      ax[o] = x;
      xsup[o] = x.lo_cnt;
      const int ylo = y.lo_cnt & 0xffff, ycnt = min(y.lo_cnt >> 16, kTaps);
      const int xlo = x.lo_cnt & 0xffff, xcnt = min(x.lo_cnt >> 16, kTaps);
      for (int k = 0; k < ycnt; ++k) wy[o * kTaps + k] = static_cast<double>(axis_weight(y, false, P.basew, o, ylo + k, s));
      for (int k = 0; k < xcnt; ++k) wx[k * r + o] = static_cast<double>(axis_weight(x, false, P.basew, o, xlo + k, s));
      if ((x.lo_cnt >> 16) > 0) {
        jmin = min(jmin, xlo);
        jmax = max(jmax, xlo + (x.lo_cnt >> 16) - 1);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {   // one shared atomic per warp
      jmin = min(jmin, __shfl_xor_sync(kFull, jmin, off));
      jmax = max(jmax, __shfl_xor_sync(kFull, jmax, off));
    }
    if ((tid & 31) == 0 && jmax >= 0) {
      atomicMin(&span[0], jmin);
      atomicMax(&span[1], jmax);
    }
  }
  __syncthreads();
  const int jlo2 = span[0] & ~1;
  const int np = span[1] < span[0] ? 0 : (span[1] - jlo2 + 2) >> 1;   // source column pairs of the strip
  const int sw = 2 * np;

  // ---- 2. crop: over source rows into a strip (float64), then over source columns ----
  const uint8_t* src = P.src + (static_cast<size_t>(n) * 3 + c) * s * s;
  uint8_t* out = P.out + (static_cast<size_t>(idx) * 3 + c) * r * r;
  const bool src_pairs = (s & 1) == 0, out_words = (r & 3) == 0;
  const int npr = max(1, min(np, kThreads)), pr = kThreads / npr;   // row pass: pairs, rows at once
  const int ncr = min(r, kThreads), cr = kThreads / ncr;             // column pass: columns, rows at once
  for (int r0 = 0; r0 < r; r0 += L.strip_rows) {
    const int rows = min(L.strip_rows, r - r0);
    // a thread sums 2 adjacent source columns (2-byte loads, 16-byte stores)
    // down every pr-th row of the strip
    for (int pp = tid % npr; pp < np; pp += npr) {
      const int j = jlo2 + 2 * pp;
#pragma unroll 2
      for (int i = tid / npr; i < (tid / npr < pr ? rows : 0); i += pr) {
        const int row = r0 + i;
        const int lc = ay[row].lo_cnt;
        const int lo = lc & 0xffff, cnt = lc >> 16;
        auto source_pair = [&](int k) -> uint32_t {   // source row lo + k, columns j and j+1
          const uint8_t* sp = src + static_cast<size_t>(lo + k) * s + j;
          if (src_pairs) return __ldg(reinterpret_cast<const unsigned short*>(sp));
          return static_cast<uint32_t>(__ldg(sp)) | (j + 1 < s ? static_cast<uint32_t>(__ldg(sp + 1)) << 8 : 0u);
        };
        uint32_t pairs[kAhead];   // all loads in flight before the first sum
#pragma unroll
        for (int k = 0; k < kAhead; ++k) pairs[k] = k < cnt ? source_pair(k) : 0u;
        double acc0 = 0.0, acc1 = 0.0;
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
          if (k < cnt) {
            const double w = wy[row * kTaps + k];
            acc0 = fma(w, byte_d(pairs[k] & 0xFF), acc0);
            acc1 = fma(w, byte_d(pairs[k] >> 8), acc1);
          }
        }
        for (int k = kAhead; k < cnt; ++k) {
          const double w = k < kTaps ? wy[row * kTaps + k]
                                     : static_cast<double>(axis_weight(ay[row], base, P.basew, row, lo + k, s));
          const uint32_t pr2 = source_pair(k);
          acc0 = fma(w, byte_d(pr2 & 0xFF), acc0);
          acc1 = fma(w, byte_d(pr2 >> 8), acc1);
        }
        *reinterpret_cast<double2*>(strip + i * sw + 2 * pp) =
            make_double2(static_cast<double>(static_cast<float>(acc0)), static_cast<double>(static_cast<float>(acc1)));
      }
    }
    __syncthreads();
    // a thread sums one output column (a warp 32 adjacent ones) down every
    // cr-th row of the strip, its support and first weights in registers
    for (int col = tid % ncr; col < r; col += ncr) {
      const int lc = xsup[col];
      const int lo = (lc & 0xffff) - jlo2, cnt = lc >> 16;
      double w[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) w[k] = k < cnt ? wx[k * r + col] : 0.0;
      for (int i = tid / ncr; i < (tid / ncr < cr ? rows : 0); i += cr) {
        const double* t = strip + i * sw + lo;
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k < kAhead; ++k)
          if (k < cnt) acc = fma(w[k], t[k], acc);
        for (int k = kAhead; k < cnt; ++k) {
          const double wk = k < kTaps ? wx[k * r + col]
                                      : static_cast<double>(axis_weight(ax[col], base, P.basew, col, lo + jlo2 + k, s));
          acc = fma(wk, t[k], acc);
        }
        out[static_cast<size_t>(r0 + i) * r + col] = static_cast<uint8_t>(round_byte(clamp_round(static_cast<float>(acc))));
      }
    }
    __syncthreads();   // the strip is rewritten by the next pass; at the end, the tables and the views are done
  }

  const float mv = P.m[idx];
  // m = 1 (the base view, augmix off): 1*orig + 0*mix is orig exactly, and
  // orig is already in the output
  if (mv == 1.0f) return;

  // ---- 3. AugMix chains ----
  // each thread reads and writes only its own words, except a warp op (which
  // reads any word of the plane: a barrier before it) and the block reductions
  uint8_t* cur = plane_a;
  uint8_t* alt = plane_b;
  uint8_t* keep = P.keep + static_cast<size_t>(blockIdx.x) * kept * r * rp;
  const float cxy = static_cast<float>(r) * 0.5f;
  // padding bytes of this thread's column word (rows padded to a multiple of 4)
  const int valid = min(4, r - 4 * q);
  const uint32_t pad = valid == 4 ? 0u : (0xFFFFFFFFu << (8 * valid));

  auto load_orig = [&](int i) -> uint32_t {
    const uint8_t* o = out + static_cast<size_t>(i) * r + 4 * q;
    if (out_words) return *reinterpret_cast<const uint32_t*>(o);
    uint32_t w = 0;
    for (int t = 0; t < valid; ++t) w |= static_cast<uint32_t>(o[t]) << (8 * t);
    return w;
  };

  for (int chain = 0; chain < kChains; ++chain) {
    for (int i = ib; i < ie; i += kBatch) {   // kBatch loads in flight, then the stores
      uint32_t w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) w[u] = i + u < ie ? load_orig(i + u) : 0u;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i + u < ie) reinterpret_cast<uint32_t*>(cur)[(i + u) * wq + q] = w[u];
    }
    const int depth = min(P.depth[idx * kChains + chain], kDepth);
    for (int st = 0; st < depth; ++st) {
      const int k = idx * kSteps + chain * kDepth + st;
      const int op = P.ops[k];
      const float a0 = P.p0[k], a1 = P.p1[k];
      const int qi = P.ip0[k];
      uint32_t* cw = reinterpret_cast<uint32_t*>(cur);
      uint32_t* aw = reinterpret_cast<uint32_t*>(alt);
      bool warped = false;
      if (op == 0) {  // autocontrast (cutoff 0): floor((x - lo) * 255 / max(hi - lo, 1) + 1e-3)
        uint32_t mn4 = 0xFFFFFFFFu, mx4 = 0u;
        for (int i = ib; i < ie; ++i) {
          const uint32_t w = cw[i * wq + q];
          mn4 = __vminu4(mn4, w | pad);
          mx4 = __vmaxu4(mx4, w & ~pad);
        }
        int mn = min(min(mn4 & 0xFF, (mn4 >> 8) & 0xFF), min((mn4 >> 16) & 0xFF, mn4 >> 24));
        int mx = max(max(mx4 & 0xFF, (mx4 >> 8) & 0xFF), max((mx4 >> 16) & 0xFF, mx4 >> 24));
        warp_min_max(mn, mx);
        if ((tid & 31) == 0) {
          red[tid >> 5] = mn;
          red[kWarps + (tid >> 5)] = mx;
        }
        __syncthreads();
        int lo = 255, hi = 0;
        for (int w = 0; w < kWarps; ++w) {
          lo = min(lo, red[w]);
          hi = max(hi, red[kWarps + w]);
        }
        if (hi > lo) {
          if (tid < kBins) {
            const float flo = static_cast<float>(lo);
            const float den = fmaxf(static_cast<float>(hi) - flo, 1.0f);
            const float v = floorf((static_cast<float>(tid) - flo) * 255.0f / den + 1e-3f);
            lut[tid] = static_cast<uint8_t>(fminf(fmaxf(v, 0.0f), 255.0f));
          }
          __syncthreads();
          for (int i = ib; i < ie; ++i) cw[i * wq + q] = map_word(lut, cw[i * wq + q]);
        }
        __syncthreads();   // red and lut are rewritten by the next table op
      } else if (op == 1) {  // equalize
        for (int i = ib; i < ie; ++i) {
          const uint32_t w = cw[i * wq + q];
          for (int t = 0; t < valid; ++t) atomicAdd(&hist[(w >> (8 * t)) & 0xFF], 1);
        }
        __syncthreads();
        if (tid < 32) equalize_table(hist, lut);
        __syncthreads();
        for (int i = ib; i < ie; ++i) cw[i * wq + q] = map_word(lut, cw[i * wq + q]);
        __syncthreads();   // lut is rewritten by the next table op
      } else if (op == 2) {  // posterize: keep the top bits
        const uint32_t mask = static_cast<uint32_t>(qi & 0xFF) * 0x01010101u;
        for (int i = ib; i < ie; ++i) cw[i * wq + q] &= mask;
      } else if (op == 4) {  // solarize: v >= a0 -> 255 - v; for an integer v that is v >= ceil(a0)
        uint32_t thr = 0;
        bool none = !(a0 <= 255.0f), all = a0 <= 0.0f;
        if (!none && !all) thr = static_cast<uint32_t>(ceilf(a0)) * 0x01010101u;
        for (int i = ib; i < ie; ++i) {
          const uint32_t w = cw[i * wq + q];
          const uint32_t flip = none ? 0u : (all ? 0xFFFFFFFFu : __vcmpgeu4(w, thr));
          cw[i * wq + q] = w ^ flip;
        }
      } else if (op == 3) {  // rotate: ShX(alpha) ShY(beta) ShX(alpha), unrounded between passes
        __syncthreads();
        for (int o = tid; o < r; o += kThreads) {
          rt[o] = make_shift(a0 * ((static_cast<float>(o) + 0.5f) - cxy), P.ms_ra);
          ct[o] = make_shift(a1 * ((static_cast<float>(o) + 0.5f) - cxy), P.ms_rb);
        }
        __syncthreads();
        // this thread's rows are consecutive, so that the first pass's value
        // one row below a column's support is the next row's first tap
        int prev = -0x7fffffff;   // the previous row's first column
        float p1b[5];             // its first pass at (row + shift + 1, column)
        for (int i = ib; i < ie; ++i) {
          const Shift s3 = rt[i];
          const int c0 = 4 * q + s3.d;
          float p2[5];
#pragma unroll
          for (int u = 0; u < 5; ++u) {
            const int col = c0 + u;
            if (col < 0 || col >= r) {
              p2[u] = 0.0f;
              continue;
            }
            const Shift sb = ct[col];
            const int ia = i + sb.d;
            const float xa = c0 == prev ? p1b[u] : rot_pass1(cur, rt, rp, r, ia, col);
            p1b[u] = rot_pass1(cur, rt, rp, r, ia + 1, col);
            p2[u] = pair_sum(sb, xa, has_b(sb) ? p1b[u] : 0.0f);
          }
          prev = c0;
          uint32_t b[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) b[t] = round_byte(pair_sum(s3, p2[t], has_b(s3) ? p2[t + 1] : 0.0f));
          aw[i * wq + q] = pack4(b[0], b[1], b[2], b[3]);
        }
        warped = true;
      } else if (op == 5 || op == 7) {  // along W, one shift per row
        __syncthreads();
        const int ms = op == 5 ? P.ms_sh : P.ms_tr;
        const Shift translate = make_shift(a0, ms);
        for (int i = ib; i < ie; ++i) {
          const Shift sh = op == 5 ? make_shift(a0 * (static_cast<float>(i) + 0.5f), ms) : translate;
          const int b0 = 4 * q + sh.d;   // the first pixel read
          const uint8_t* row = cur + i * rp;
          float x[5];
          if (b0 >= 0 && b0 + 4 < r) {
            const uint32_t* rw = reinterpret_cast<const uint32_t*>(row) + (b0 >> 2);
            const uint64_t v = ((static_cast<uint64_t>(rw[1]) << 32) | rw[0]) >> (8 * (b0 & 3));
#pragma unroll
            for (int u = 0; u < 5; ++u) x[u] = byte_f(static_cast<uint32_t>(v >> (8 * u)) & 0xFF);
          } else {
#pragma unroll
            for (int u = 0; u < 5; ++u) x[u] = (b0 + u >= 0 && b0 + u < r) ? byte_f(row[b0 + u]) : 0.0f;
          }
          uint32_t b[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) b[t] = round_byte(pair_sum(sh, x[t], has_b(sh) ? x[t + 1] : 0.0f));
          aw[i * wq + q] = pack4(b[0], b[1], b[2], b[3]);
        }
        warped = true;
      } else if (op == 6 || op == 8) {  // along H, one shift per column
        __syncthreads();
        const int ms = op == 6 ? P.ms_sh : P.ms_tr;
        Shift sh[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          sh[t] = make_shift(op == 6 ? a0 * (static_cast<float>(4 * q + t) + 0.5f) : a0, ms);
        const bool same = sh[0].d == sh[1].d && sh[0].d == sh[2].d && sh[0].d == sh[3].d;
        for (int i = ib; i < ie; ++i) {
          float xa[4], xb[4];
          const int ia = i + sh[0].d;
          if (same && ia >= 0 && ia + 1 < r) {
            const uint32_t wa = cw[ia * wq + q], wb = cw[(ia + 1) * wq + q];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              xa[t] = word_byte_f(wa, t);
              xb[t] = has_b(sh[t]) ? word_byte_f(wb, t) : 0.0f;
            }
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int rr = i + sh[t].d, col = 4 * q + t;
              xa[t] = pix(cur, rp, r, rr, col);
              xb[t] = has_b(sh[t]) ? pix(cur, rp, r, rr + 1, col) : 0.0f;
            }
          }
          uint32_t b[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) b[t] = round_byte(pair_sum(sh[t], xa[t], xb[t]));
          aw[i * wq + q] = pack4(b[0], b[1], b[2], b[3]);
        }
        warped = true;
      }
      if (warped) {
        uint8_t* t = cur;
        cur = alt;
        alt = t;
      }
    }
    if (chain < kChains - 1) {   // keep this chain's result for the final mix
      uint32_t* kw = reinterpret_cast<uint32_t*>(keep + static_cast<size_t>(chain) * r * rp);
      for (int i = ib; i < ie; ++i) kw[i * wq + q] = reinterpret_cast<const uint32_t*>(cur)[i * wq + q];
    }
  }

  // ---- 4. the mix, in the reference's order, then with the original ----
  const float w0 = P.wm[idx * kChains], w1 = P.wm[idx * kChains + 1], w2 = P.wm[idx * kChains + 2];
  const float mo = 1.0f - mv;
  const uint32_t* k0 = reinterpret_cast<const uint32_t*>(keep);
  const uint32_t* k1 = reinterpret_cast<const uint32_t*>(keep + static_cast<size_t>(r) * rp);
  constexpr int kHalf = kBatch / 2;
  for (int i0 = ib; i0 < ie; i0 += kHalf) {   // 3 * kHalf loads in flight, then the blends and stores
    uint32_t x[kHalf], c0[kHalf], c1[kHalf];
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      const int i = i0 + u < ie ? i0 + u : ib;
      x[u] = load_orig(i);
      c0[u] = k0[i * wq + q];
      c1[u] = k1[i * wq + q];
    }
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      const int i = i0 + u;
      if (i >= ie) break;
      const uint32_t c2 = reinterpret_cast<const uint32_t*>(cur)[i * wq + q];
      uint32_t b[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float mix = w0 * word_byte_f(c0[u], t);
        mix = mix + w1 * word_byte_f(c1[u], t);
        mix = mix + w2 * word_byte_f(c2, t);
        b[t] = round_byte(clamp_round(mv * word_byte_f(x[u], t) + mo * mix));
      }
      uint8_t* o = out + static_cast<size_t>(i) * r + 4 * q;
      if (out_words) {
        *reinterpret_cast<uint32_t*>(o) = pack4(b[0], b[1], b[2], b[3]);
      } else {
        for (int t = 0; t < valid; ++t) o[t] = static_cast<uint8_t>(b[t]);
      }
    }
  }
}

template <bool LARGE>
cudaError_t launch_augmix(const Params& P, int ctas, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(augmix_kernel<LARGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(augmix_kernel<LARGE>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  augmix_kernel<LARGE><<<ctas, kThreads, smem, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dynamic shared memory of one CTA at (r, s): the wrapper checks it against
// the card's limit before it launches
size_t rlcf_augmix_shared_bytes(int r, int s) { return layout(r, s).total; }

// u8 planes of R x round4(R) a CTA keeps in the device scratch at (r, s): 2,
// or 3 where plane B lives there too
int rlcf_augmix_keep_planes(int r, int s) { return layout(r, s).large ? 3 : 2; }

int rlcf_augmix_views(const void* src, const void* basew, const void* rrc, const void* flip, const void* depth,
                      const void* ops, const void* p0, const void* p1, const void* ip0, const void* wm, const void* m,
                      void* out, void* keep, int n, int v, int r, int s, int ms_ra, int ms_rb, int ms_sh, int ms_tr,
                      void* stream) {
  if (n < 1 || v < 1 || r < 1 || s < 1 || s > 0xffff || ms_ra < 0 || ms_rb < 0 || ms_sh < 0 || ms_tr < 0 ||
      static_cast<long long>(n) * v * 3 > 0x7fffffffLL || (r + 3) / 4 > kThreads)
    return kBadArgs;
  const Layout L = layout(r, s);
  if (L.total > kMaxSmem) return kBadArgs;
  Params P{static_cast<const uint8_t*>(src), static_cast<const float*>(basew), static_cast<const float*>(rrc),
           static_cast<const int*>(flip), static_cast<const int*>(depth), static_cast<const int*>(ops),
           static_cast<const float*>(p0), static_cast<const float*>(p1), static_cast<const int*>(ip0),
           static_cast<const float*>(wm), static_cast<const float*>(m), static_cast<uint8_t*>(out),
           static_cast<uint8_t*>(keep), v, r, s, ms_ra, ms_rb, ms_sh, ms_tr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(L.large ? launch_augmix<true>(P, n * v * 3, L.total, st)
                                  : launch_augmix<false>(P, n * v * 3, L.total, st));
}

}  // extern "C"

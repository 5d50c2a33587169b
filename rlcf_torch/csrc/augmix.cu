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
// then m*orig + (1-m)*mix, rounded to u8. Rounding is rintf (half to even,
// as jnp.round); the file is built with -fmad=false, so a product and a sum
// round separately unless the code calls fmaf, which it does exactly where
// the reference output fuses them (the warp's tap pair, see pair_sum). The
// crop's dot products are summed in float64, exact for their few nonzero
// terms, and rounded once to float32, as in the plain version: the result
// does not depend on the order of summation.
//
// Design: one CTA per (image, view, channel): every stage of the TPU kernel
// is per channel. Every op output is integer-valued, so the planes live in
// shared memory as u8: the cropped original, the working plane and a second
// plane that a warp writes while it reads the first (3 x 49 KB at R = 224).
// Nothing unrounded is kept as a plane: the rotate's two intermediate shear
// passes are recomputed per output pixel from the u8 plane (each pass is a
// two-tap blend, so an output pixel needs 2 values of the second pass, 4 of
// the first, 8 source pixels), bit-identical to materializing them; the
// mix accumulator (f32) lives in a device scratch buffer that the wrapper
// allocates, each thread touching only its own pixels. The crop is separable:
// strips of 16 output rows sum over source rows into shared memory, then
// over source columns; its weights are recomputed from per-row tables
// (support start, length, center, normalizer), the bicubic ones read from
// basew. Equalize builds its 256-bin histogram with shared-memory atomics
// (exact on integers) and its LUT with one warp's prefix sum; autocontrast's
// min and max are a block reduction. The 64 views of an image read its source
// planes from global memory and share them through L2. No chunking: one
// launch per group of images.
//
// What bounds it: the bytes it must move are only the u8 sources and views
// (N*3*S*S + N*V*3*R*R, 39.3 MB for a flagship group: 0.012 ms at 3.35 TB/s);
// the arithmetic (crop taps, ~6-20 operations per pixel and op) is about a
// GFLOP of fp32 CUDA-core work per group, so the card's floor is set by
// operations, at a few hundredths of a millisecond. This first version is
// far above it: one CTA of 512 threads per SM (176 KB of shared memory at
// R = 224), byte-wide shared-memory traffic, a barrier between every op, the
// crop's weights recomputed (with a division) at every tap, and the rotate's
// passes recomputed per pixel.
//
// Plain C interface (bound with ctypes): rlcf_augmix_views returns
// cudaGetLastError() after the launch, or kBadArgs for shapes it refuses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 16;       // output rows per pass of the crop
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

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

__host__ __device__ inline size_t smem_bytes(int r, int s) {
  return 3 * align16(static_cast<size_t>(r) * r) + 2 * align16(sizeof(Axis) * r) +
         align16(sizeof(float) * kStrip * s) + 2 * kBins * sizeof(int) + 2 * kWarps * sizeof(int) + 16;
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
  float* mix;
  int v, r, s;
  int ms_ra, ms_rb, ms_sh, ms_tr;   // tap windows: rotate alpha / beta passes, shear, translate
};

__device__ __forceinline__ uint8_t to_u8(float x) { return static_cast<uint8_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f)); }

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

// the base view: the nonzero support of basew's row o
__device__ Axis base_axis(const float* basew, int o, int s) {
  int lo = -1, hi = -1;
  for (int j = 0; j < s; ++j) {
    if (basew[static_cast<size_t>(o) * s + j] != 0.0f) {
      if (lo < 0) lo = j;
      hi = j;
    }
  }
  Axis a;
  a.center = a.inv = a.denom = 0.0f;
  a.lo_cnt = lo < 0 ? 0 : (lo | ((hi - lo + 1) << 16));
  return a;
}

__device__ __forceinline__ float axis_weight(const Axis& a, bool base, const float* basew, int o, int j, int s) {
  return base ? basew[static_cast<size_t>(o) * s + j] : tri_raw(j, a.center, a.inv) / a.denom;
}

// ---- warps (_warp_pass) ------------------------------------------------------

struct Shift {
  int d;          // floor(shift) clipped to the window
  float wa, wb;   // 1 - f and f
  int tap;        // position of tap d among the window's 2*ms+1 taps
  bool has_b;     // tap d+1 is inside the window
};

__device__ __forceinline__ Shift make_shift(float shift, int ms) {
  const float d0 = floorf(shift);
  const float f = shift - d0;
  Shift sh;
  sh.d = static_cast<int>(fminf(fmaxf(d0, static_cast<float>(-ms)), static_cast<float>(ms)));
  sh.wa = 1.0f - f;
  sh.wb = f;
  sh.tap = sh.d + ms;
  sh.has_b = sh.d < ms;
  return sh;
}

// (1-f)*x[i+d] + f*x[i+d+1], summed as the reference output sums it:
// `_warp_pass` adds its taps in chunks of 5 and XLA contracts each product
// into the running sum as a fused multiply-add. The first two terms of a
// chunk fuse the first product; a tap that starts a chunk of more than one
// tap starts a new partial sum; a chunk of one tap fuses into the total.
__device__ __forceinline__ float pair_sum(const Shift& sh, int ms, float xa, float xb) {
  const float pa = sh.wa * xa;
  const float pb = sh.wb * xb;
  const bool single_last = (2 * ms + 1) % 5 == 1 && sh.tap + 1 == 2 * ms;
  if (sh.tap % 5 == 4 && !single_last) return pa + pb;
  if (sh.tap % 5 == 0) return fmaf(sh.wa, xa, pb);
  return fmaf(sh.wb, xb, pa);
}

// blend at index i along an axis of length r; get(j) reads index j
template <class Get>
__device__ __forceinline__ float blend(const Shift& sh, int ms, int i, int r, Get get) {
  const int ia = i + sh.d;
  const float xa = (ia >= 0 && ia < r) ? get(ia) : 0.0f;
  const float xb = (sh.has_b && ia + 1 >= 0 && ia + 1 < r) ? get(ia + 1) : 0.0f;
  return pair_sum(sh, ms, xa, xb);
}

// ---- block helpers -----------------------------------------------------------

__device__ void block_min_max(const uint8_t* x, int n, int* red, int& lo, int& hi) {
  int mn = 255, mx = 0;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int v = x[p];
    mn = min(mn, v);
    mx = max(mx, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(kFull, mn, off));
    mx = max(mx, __shfl_xor_sync(kFull, mx, off));
  }
  __syncthreads();  // red[] is free
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = mn;
    red[kWarps + (threadIdx.x >> 5)] = mx;
  }
  __syncthreads();
  lo = 255;
  hi = 0;
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[kWarps + w]);
  }
}

// PIL ImageOps.autocontrast (cutoff 0): floor((x - lo) * 255 / max(hi - lo, 1) + 1e-3)
__device__ void autocontrast(uint8_t* x, int n, int* red) {
  int lo, hi;
  block_min_max(x, n, red, lo, hi);
  if (hi <= lo) return;
  const float flo = static_cast<float>(lo);
  const float den = fmaxf(static_cast<float>(hi) - flo, 1.0f);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const float v = floorf((static_cast<float>(x[p]) - flo) * 255.0f / den + 1e-3f);
    x[p] = static_cast<uint8_t>(fminf(fmaxf(v, 0.0f), 255.0f));
  }
}

// PIL ImageOps.equalize: integer histogram, step = (total - count of the last
// nonzero bin) / 255, lut[b] = (step / 2 + cum[b]) / step (exclusive cum);
// the identity when at most one bin is used or step is 0
__device__ void equalize(uint8_t* x, int n, int* hist, int* lut) {
  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += kThreads) atomicAdd(&hist[x[p]], 1);
  __syncthreads();
  if (threadIdx.x < 32) {
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
    const int step = (total - hist[max(last, 0)]) / 255;
    const bool ident = nnz <= 1 || step == 0;
    int cum = incl - own;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int b = lane * 8 + e;
      lut[b] = ident ? b : min(255, (step / 2 + cum) / max(step, 1));
      cum += h[e];
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n; p += kThreads) x[p] = static_cast<uint8_t>(lut[x[p]]);
}

// ---- the kernel --------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) augmix_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = P.r, s = P.s, rr = r * r;
  const int c = blockIdx.x % 3;
  const int idx = blockIdx.x / 3;   // n * V + v
  const int n = idx / P.v;
  const bool base = (idx % P.v) == 0;

  uint8_t* xorig = smem;
  uint8_t* cur = xorig + align16(rr);
  uint8_t* alt = cur + align16(rr);
  Axis* ay = reinterpret_cast<Axis*>(alt + align16(rr));
  Axis* ax = reinterpret_cast<Axis*>(reinterpret_cast<unsigned char*>(ay) + align16(sizeof(Axis) * r));
  float* strip = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ax) + align16(sizeof(Axis) * r));
  int* hist = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(strip) + align16(sizeof(float) * kStrip * s));
  int* lut = hist + kBins;
  int* red = lut + kBins;
  int* span = red + 2 * kWarps;   // [0] first, [1] last source column of the x supports

  // ---- 1. crop tables ----
  if (threadIdx.x == 0) {
    span[0] = s;
    span[1] = -1;
  }
  __syncthreads();
  const float* box = P.rrc + static_cast<size_t>(idx) * 4;
  for (int o = threadIdx.x; o < r; o += kThreads) {
    if (base) {
      ay[o] = ax[o] = base_axis(P.basew, o, s);
    } else {
      ay[o] = tri_axis(box[0], box[2], 0, o, r, s);
      ax[o] = tri_axis(box[1], box[3], P.flip[idx], o, r, s);
    }
    const int cnt = ax[o].lo_cnt >> 16;
    if (cnt > 0) {
      atomicMin(&span[0], ax[o].lo_cnt & 0xffff);
      atomicMax(&span[1], (ax[o].lo_cnt & 0xffff) + cnt - 1);
    }
  }
  __syncthreads();
  const int jlo = span[0];
  const int width = max(0, span[1] - jlo + 1);

  // ---- 2. crop: over source rows into a strip, then over source columns ----
  const uint8_t* src = P.src + (static_cast<size_t>(n) * 3 + c) * s * s;
  for (int r0 = 0; r0 < r; r0 += kStrip) {
    const int rows = min(kStrip, r - r0);
    for (int e = threadIdx.x; e < rows * width; e += kThreads) {
      const int row = r0 + e / width, j = jlo + e % width;
      const Axis a = ay[row];
      const int lo = a.lo_cnt & 0xffff, cnt = a.lo_cnt >> 16;
      double acc = 0.0;
      for (int k = 0; k < cnt; ++k) {
        const float w = axis_weight(a, base, P.basew, row, lo + k, s);
        acc = fma(static_cast<double>(w), static_cast<double>(src[static_cast<size_t>(lo + k) * s + j]), acc);
      }
      strip[e] = static_cast<float>(acc);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * r; e += kThreads) {
      const int i = e / r, col = e % r;
      const Axis a = ax[col];
      const int lo = a.lo_cnt & 0xffff, cnt = a.lo_cnt >> 16;
      double acc = 0.0;
      for (int k = 0; k < cnt; ++k) {
        const float w = axis_weight(a, base, P.basew, col, lo + k, s);
        acc = fma(static_cast<double>(w), static_cast<double>(strip[i * width + (lo + k - jlo)]), acc);
      }
      xorig[(r0 + i) * r + col] = to_u8(static_cast<float>(acc));
    }
    __syncthreads();
  }

  uint8_t* out = P.out + static_cast<size_t>(blockIdx.x) * rr;
  const float mv = P.m[idx];
  if (mv == 1.0f) {  // m = 1 (the base view, augmix off): 1*orig + 0*mix is orig exactly
    for (int p = threadIdx.x; p < rr; p += kThreads) out[p] = xorig[p];
    return;
  }

  // ---- 3. AugMix chains ----
  float* mix = P.mix + static_cast<size_t>(blockIdx.x) * rr;
  const float cxy = static_cast<float>(r) * 0.5f;
  for (int chain = 0; chain < kChains; ++chain) {
    for (int p = threadIdx.x; p < rr; p += kThreads) cur[p] = xorig[p];
    __syncthreads();
    const int depth = min(P.depth[idx * kChains + chain], kDepth);
    for (int st = 0; st < depth; ++st) {
      const int k = idx * kSteps + chain * kDepth + st;
      const int op = P.ops[k];
      const float q0 = P.p0[k], q1 = P.p1[k];
      const int qi = P.ip0[k];
      bool warped = true;
      switch (op) {
        case 0:
          autocontrast(cur, rr, red);
          warped = false;
          break;
        case 1:
          equalize(cur, rr, hist, lut);
          warped = false;
          break;
        case 2:
          for (int p = threadIdx.x; p < rr; p += kThreads) cur[p] = static_cast<uint8_t>(cur[p] & qi);
          warped = false;
          break;
        case 4:
          for (int p = threadIdx.x; p < rr; p += kThreads) {
            const uint8_t v = cur[p];
            cur[p] = static_cast<float>(v) >= q0 ? static_cast<uint8_t>(255 - v) : v;
          }
          warped = false;
          break;
        case 3: {  // ShX(alpha) ShY(beta) ShX(alpha), unrounded between passes
          const int ma = P.ms_ra, mb = P.ms_rb;
          const uint8_t* x = cur;
          auto pass1 = [&](int i, int j) {  // along W, shift by row i
            const Shift sh = make_shift(q0 * ((static_cast<float>(i) + 0.5f) - cxy), ma);
            return blend(sh, ma, j, r, [&](int t) { return static_cast<float>(x[i * r + t]); });
          };
          auto pass2 = [&](int i, int j) {  // along H, shift by column j
            const Shift sh = make_shift(q1 * ((static_cast<float>(j) + 0.5f) - cxy), mb);
            return blend(sh, mb, i, r, [&](int t) { return pass1(t, j); });
          };
          for (int p = threadIdx.x; p < rr; p += kThreads) {
            const int i = p / r, j = p % r;
            const Shift sh = make_shift(q0 * ((static_cast<float>(i) + 0.5f) - cxy), ma);
            alt[p] = static_cast<uint8_t>(rintf(blend(sh, ma, j, r, [&](int t) { return pass2(i, t); })));
          }
          break;
        }
        case 5:
        case 7:
          for (int p = threadIdx.x; p < rr; p += kThreads) {  // along W, shift by row
            const int i = p / r, j = p % r;
            const int ms = op == 5 ? P.ms_sh : P.ms_tr;
            const Shift sh = make_shift(op == 5 ? q0 * (static_cast<float>(i) + 0.5f) : q0, ms);
            alt[p] = static_cast<uint8_t>(
                rintf(blend(sh, ms, j, r, [&](int t) { return static_cast<float>(cur[i * r + t]); })));
          }
          break;
        case 6:
        case 8:
          for (int p = threadIdx.x; p < rr; p += kThreads) {  // along H, shift by column
            const int i = p / r, j = p % r;
            const int ms = op == 6 ? P.ms_sh : P.ms_tr;
            const Shift sh = make_shift(op == 6 ? q0 * (static_cast<float>(j) + 0.5f) : q0, ms);
            alt[p] = static_cast<uint8_t>(
                rintf(blend(sh, ms, i, r, [&](int t) { return static_cast<float>(cur[t * r + j]); })));
          }
          break;
        default:
          warped = false;
          break;
      }
      __syncthreads();
      if (warped) {
        uint8_t* t = cur;
        cur = alt;
        alt = t;
      }
    }
    const float w = P.wm[idx * kChains + chain];
    for (int p = threadIdx.x; p < rr; p += kThreads) {
      const float t = w * static_cast<float>(cur[p]);
      mix[p] = chain == 0 ? t : mix[p] + t;
    }
    __syncthreads();  // cur is rewritten by the next chain
  }

  // ---- 4. mix with the original ----
  const float mo = 1.0f - mv;
  for (int p = threadIdx.x; p < rr; p += kThreads) out[p] = to_u8(mv * static_cast<float>(xorig[p]) + mo * mix[p]);
}

}  // namespace

extern "C" {

int rlcf_augmix_views(const void* src, const void* basew, const void* rrc, const void* flip, const void* depth,
                      const void* ops, const void* p0, const void* p1, const void* ip0, const void* wm, const void* m,
                      void* out, void* mix, int n, int v, int r, int s, int ms_ra, int ms_rb, int ms_sh, int ms_tr,
                      void* stream) {
  if (n < 1 || v < 1 || r < 1 || s < 1 || s > 0xffff || ms_ra < 0 || ms_rb < 0 || ms_sh < 0 || ms_tr < 0 ||
      static_cast<long long>(n) * v * 3 > 0x7fffffffLL)
    return kBadArgs;
  const size_t smem = smem_bytes(r, s);
  if (smem > kMaxSmem) return kBadArgs;
  cudaError_t err = cudaFuncSetAttribute(augmix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params P{static_cast<const uint8_t*>(src), static_cast<const float*>(basew), static_cast<const float*>(rrc),
           static_cast<const int*>(flip), static_cast<const int*>(depth), static_cast<const int*>(ops),
           static_cast<const float*>(p0), static_cast<const float*>(p1), static_cast<const int*>(ip0),
           static_cast<const float*>(wm), static_cast<const float*>(m), static_cast<uint8_t*>(out),
           static_cast<float*>(mix), v, r, s, ms_ra, ms_rb, ms_sh, ms_tr};
  augmix_kernel<<<n * v * 3, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Fused multi-head attention backward from the unsplit QKV projection in
// bf16, on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel `_mha_bwd_kernel` of
// rlcf_tpu/ops/pallas_attention.py:89 for bf16 inputs (fp32 inputs run the
// 3xTF32 kernel of attention_bwd_tf32.cu), and is the backward of the `ATTN_IMPL = "flash"` switch of
// rlcf_tpu/models/layers.py:48.
//
//   (qkv [B, T, 3*H*64], g [B, T, H*64]) bf16 (+ additive mask [T, T] fp32)
//     -> dqkv [B, T, 3*H*64] bf16 in the fused layout
//   P = softmax(q.k * scale + mask) recomputed in fp32, dv = P^T g,
//   dp = g v^T, ds = P * (dp - rowsum(dp * P)), dq = ds k * scale,
//   dk = ds^T q * scale; fp32 accumulation, one rounding to bf16 at the store.
//
// The function multiplies fp32 P and dS with the bf16 inputs. The tensor cores
// take bf16 operands, so P and dS are split into a bf16 value and the bf16
// value of what that rounding lost (hi + lo, ~16 mantissa bits) and each of
// dq, dk and dv is two products: a single rounding does not hold the
// function's tolerance.
//
// What bounds it, and what the design does about it.
//
// Short sequences (T <= 16, the text tower's prompts; B=800, H=8 moves 92 MB
// for 0.6 GFLOP): bytes, and before them per-CTA overhead. A head's whole
// backward is five 16 x 16 x 64 products. One warp per head, 4 heads a CTA,
// no CTA-wide barrier: the warp stages its head's Q, K, V and G slices once
// (cp.async, whole 128-byte rows, swizzled), reads its 8 mask entries a lane
// once while they arrive, keeps S and dP as mma.sync accumulators, takes row
// max, row sum and rowsum(dp * P) by quad shuffles, and feeds dS to dq = dS.K
// straight from the accumulator layout. dv = P^T.G and dk = dS^T.Q contract
// over the query row: P and dS are transposed on chip, one movmatrix per 8 x 8
// block. K, G and Q enter those products through ldmatrix.trans. Each output
// tile leaves through a tile of shared memory that is no longer needed, as
// 16-byte pieces.
//
// Long sequences (17 <= T <= 257, the vision towers and ATTN_IMPL="flash"):
// bytes by the count (B=24, T=257, H=16: 88 MB, 0.026 ms, against 0.016 ms of
// tensor-core time for 16 GFLOP), in practice the recomputation and the fp32
// work on every score. One CTA of two warpgroups per (sequence, head) holds
// the head's Q, K, V and G in shared memory (each read from device memory
// once) and runs three sweeps on wgmma (A from registers, B read from shared
// memory by the tensor cores, so that a fetch is shared by 64 rows), keys and
// queries tiled by 64 because the S and dP of a whole row block do not fit in
// registers:
//   1. per block of 64 query rows (a warp owns 16): S and dP tile by tile,
//      row max, row sum and rowsum(dp * P) accumulated online with one rescale
//      (they are statistics only), each thread over its own columns, merged
//      across the quad at the end;
//   2. the same tiles again with the final statistics: P = exp(s - m) / l in
//      fp32, dS, and dq += dS.K with dS from the accumulator layout;
//   3. after a CTA-wide barrier, per block of 64 keys: S^T = K.Q^T and
//      dP^T = V.G^T tile by tile, P^T and dS^T from the stored statistics,
//      dv += P^T.G and dk += dS^T.Q. Nothing is transposed and nothing is
//      summed by atomics: two launches give the same bits.
// A tile that holds no mask entry but 0 and no row or column >= T takes a
// fast path (the scale folded into the exponent's multiply-add, nothing
// predicated, no mask read); the others a general one. A first small kernel
// classifies the mask's 64 x 64 tiles: a tile at the floor everywhere has
// P = 0 exactly and is skipped (a causal T=256 visits 10 of 16), a tile of
// zeros is a fast one. The kernel is built with and without a mask, so that
// without one the loops around the wgmma are uniform to the compiler (a
// branch it cannot prove uniform serialises them).
// The ragged edge: rows >= T of the tiles are zero and never read from device
// memory, key columns >= T get probability 0, rows >= T are not stored. wgmma
// takes 64 rows at a time, so a fifth block for the one row of T = 257 would
// cost a warpgroup a whole round (T=256: 0.11 ms, T=257 that way: 0.18 ms on an
// H100 80GB HBM3 at 700 W). For T = 64 n + (1 to 16) the warpgroups take the
// n whole blocks, with the tail's 16 columns as a narrow wgmma step, and the
// four warps of the second warpgroup take the tail's rows on mma.sync, a
// quarter of the columns each, their partial sums added in shared memory in
// the order of the warps.
//
// Longer sequences (258 <= T <= 577: ViT-L/14 at 336 px, T = 24 * 24 + 1,
// under encoder TTA; ATTN_IMPL="flash" at T = 384 and 512): the long kernel's
// design would hold Q, K, V and G of a head in shared memory, 295 KB at
// T = 577 against a CTA's 227 KB. What bounds it: its 12 products of T^2 x 64
// (P and dS enter as hi + lo, and the rows' statistics must precede dS), at
// the rate that the waits between dependent steps leave them. An earlier
// design streamed the other slices through a ring with a CTA-wide
// barrier a chunk and read K and V from L2 twice (0.2521 ms at B=6 T=577
// H=16 on an H100 80GB HBM3 at 700 W). So the long kernel's sweeps are cut at
// its barrier into two launches, each holding whole the two slices it sweeps
// over:
//   (a) `mha_bwd_mma_xlong_rows`: CTA = (sequence, head, two blocks of 64 query
//       rows), a warpgroup each, with those rows' Q and G and the head's whole
//       K and V (203 KB at T = 577): sweep 1 (the rows' statistics, online)
//       and sweep 2 (dq = dS.K) on the long kernel's steps; the statistics go
//       to a [B * H, 3, 64 ceil(T / 64)] fp32 scratch for (b);
//   (b) `mha_bwd_mma_xlong_keys`: CTA = (sequence, head, two blocks of 64 keys)
//       with those keys' K and V, the head's whole Q and G and every row's
//       statistics (226 KB): sweep 3 (dv += P^T.G, dk += dS^T.Q).
// Each launch loads its slices once by cp.async, each chunk of 64 rows counted
// by an mbarrier: a warpgroup starts on the first chunk, and no CTA-wide
// barrier separates its tiles. The tails and masks are the long kernel's: a
// block of at most 16 rows (T = 577: one) goes to its warpgroup's four warps on
// mma.sync, the 16 columns past the whole blocks to a narrow wgmma step outside
// the loop over tiles; under a mask the first small kernel classifies the
// 64 x 64 tiles and both launches skip the dead ones (a causal T = 512 visits
// 36 of 64) and take the plain ones on the fast path. No atomics: two
// launches give the same bits. Rows past T read row T - 1 (finite values that
// get weight 0 or are not stored).
//
// The mask is a general additive [T, T] fp32 tensor (already clamped to a
// finite floor by the wrapper).
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after the launch, or kBadArgs for shapes it refuses.

#include "attention_mma.cuh"

namespace {

constexpr int kBwdShortWarps = 4;   // heads per CTA in the short regime
constexpr int kLongThreads = 256;   // two warpgroups
constexpr float kMaskFloor = -1e9f; // the wrapper clamps the mask's -inf to this

// A 16 x 16 fp32 block in the accumulator layout (two column tiles of 8) as
// the A operand of the next product: hi = the values rounded to bf16, lo =
// what the rounding lost, rounded to bf16.
__device__ __forceinline__ void to_operand(const float (&x)[2][4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = x[i >> 1][2 * (i & 1)], x1 = x[i >> 1][2 * (i & 1) + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    lo[i] = pack_bf16(x0 - f.x, x1 - f.y);
  }
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// The A operand of a 16 x 16 block -> the A operand of its transpose.
__device__ __forceinline__ void transpose_operand(uint32_t (&a)[4]) {
  const uint32_t a1 = movmatrix_trans(a[2]), a2 = movmatrix_trans(a[1]);
  a[0] = movmatrix_trans(a[0]);
  a[1] = a1;
  a[2] = a2;
  a[3] = movmatrix_trans(a[3]);
}

// o[16 x 64] = (hi + lo)[16 x 16] . tile[16 x 64] * factor
__device__ __forceinline__ void product_rows(float (&o)[8][4], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                             uint32_t tile, float factor, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  mma_rows(o, hi, tile, lane);
  mma_rows(o, lo, tile, lane);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= factor;
  }
}

// Short regime (T <= 16): CTA = (sequence, group of 4 heads), warp = head.
__global__ void __launch_bounds__(kBwdShortWarps * 32)
mha_bwd_mma_short(const bf16* __restrict__ qkv, const bf16* __restrict__ g, const float* __restrict__ mask,
                  bf16* __restrict__ dqkv, int t, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x, h = blockIdx.y * kBwdShortWarps + warp;
  if (h >= heads) return;  // no CTA-wide barrier below
  const int hd = heads * kD, stride = 3 * hd;

  unsigned char* qs = smem + warp * 4 * kTileBytes;
  unsigned char* ks = qs + kTileBytes;
  unsigned char* vs = ks + kTileBytes;
  unsigned char* gs = vs + kTileBytes;
  const bf16* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  stage_rows(qs, base, 16, t, stride, lane, 32);
  stage_rows(ks, base + hd, 16, t, stride, lane, 32);
  stage_rows(vs, base + 2 * hd, 16, t, stride, lane, 32);
  stage_rows(gs, g + static_cast<size_t>(b) * t * hd + h * kD, 16, t, hd, lane, 32);
  cp_async_commit();

  // a thread holds score rows ra and rb and, in each tile of 8 keys, the
  // columns c0 and c0 + 1; its mask entries (in base 2) arrive with the tiles
  const int ra = lane >> 2, rb = ra + 8, c0 = 2 * (lane & 3);
  float mk[2][4] = {};
  if (mask != nullptr) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nt + c0 + e;
        if (col < t && ra < t) mk[nt][e] = __ldg(mask + ra * t + col) * kLog2e;
        if (col < t && rb < t) mk[nt][2 + e] = __ldg(mask + rb * t + col) * kLog2e;
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  uint32_t a[4][4];
  float s[2][4] = {}, dp[2][4] = {};
  load_q(a, qs, lane);
  mma_scores(s, a, smem_u32(ks), lane);   // S = Q.K^T
  load_q(a, gs, lane);
  mma_scores(dp, a, smem_u32(vs), lane);  // dP = G.V^T

  // P = softmax(S * scale + mask) in base 2, key columns >= t at exactly 0
  const float c = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = 8 * nt + c0 + (e & 1) < t ? fmaf(s[nt][e], c, mk[nt][e]) : -INFINITY;
      m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e >> 1] += s[nt][e] = fast_exp2(s[nt][e] - m[e >> 1]);
  }
  l[0] = 1.f / quad_sum(l[0]);
  l[1] = 1.f / quad_sum(l[1]);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] *= l[e >> 1];
      dd[e >> 1] = fmaf(s[nt][e], dp[nt][e], dd[e >> 1]);
    }
  }
  dd[0] = quad_sum(dd[0]);
  dd[1] = quad_sum(dd[1]);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - dd[e >> 1]);  // dS
  }

  uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
  to_operand(s, p_hi, p_lo);
  to_operand(dp, ds_hi, ds_lo);

  float o[8][4];
  bf16* out = dqkv + static_cast<size_t>(b) * t * stride + h * kD;
  product_rows(o, ds_hi, ds_lo, smem_u32(ks), scale, lane);  // dq = dS.K * scale
  store_tile(o, vs, out, t, stride, lane);

  transpose_operand(p_hi);
  transpose_operand(p_lo);
  transpose_operand(ds_hi);
  transpose_operand(ds_lo);
  product_rows(o, p_hi, p_lo, smem_u32(gs), 1.f, lane);      // dv = P^T.G
  store_tile(o, gs, out + 2 * hd, t, stride, lane);
  product_rows(o, ds_hi, ds_lo, smem_u32(qs), scale, lane);  // dk = dS^T.Q * scale
  store_tile(o, qs, out + hd, t, stride, lane);
}

// ---- long regime

// x[64 x 16 NJ] = a[64 x 64 dims] . tile[16 NJ x 64 dims]^T on wgmma, a warp's
// 16 rows in `a`: NJ = 4, a whole tile of 64 rows, or NJ = 1, a tail of 16.
// Where it can be helped not under a branch that the compiler cannot see to
// be uniform (without a mask, nowhere): that serialises the warpgroup's
// products. To be fenced, committed and waited for by the caller.
template <int NJ>
__device__ __forceinline__ void tile_scores(float (&x)[NJ][2][4], const uint32_t (&a)[4][4], uint32_t tile) {
  static_assert(NJ == 4 || NJ == 1, "a tile of 64 or a tail of 16");
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (NJ == 4) {
      wgmma_n64<0>(&x[0][0][0], a[k], wgmma_desc(tile + k * 32), k > 0);
    } else {
      wgmma_n16(&x[0][0][0], a[k], wgmma_desc(tile + k * 32), k > 0);
    }
  }
}

// acc[64 x 64 dims] += (hi + lo)[64 x 16 NJ] . tile[16 NJ x 64 dims]
template <int NJ>
__device__ __forceinline__ void tile_accumulate(float (&acc)[8][4], const uint32_t (&hi)[NJ][4],
                                                const uint32_t (&lo)[NJ][4], uint32_t tile) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint64_t desc = wgmma_desc(tile + j * kTileBytes);
    wgmma_n64<1>(&acc[0][0], hi[j], desc, 1);
    wgmma_n64<1>(&acc[0][0], lo[j], desc, 1);
  }
}

// The same two products for one warp alone, on mma.sync (16 rows in `a`, the
// tile's rows through ldmatrix); the 16-column blocks innermost, so that
// consecutive mma.sync are independent.
template <int NJ>
__device__ __forceinline__ void warp_scores(float (&x)[NJ][2][4], const uint32_t (&a)[4][4], uint32_t tile, int lane) {
  const int r = (lane & 7) + (lane >> 4) * 8, c = (lane >> 3) & 1;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) x[j][nt][0] = x[j][nt][1] = x[j][nt][2] = x[j][nt][3] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t f[4];
      ldmatrix_x4(f, tile + j * kTileBytes + tile_off(r, 2 * k + c));
      mma_bf16(x[j][0], a[k], f[0], f[1]);
      mma_bf16(x[j][1], a[k], f[2], f[3]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void warp_accumulate(float (&acc)[8][4], const uint32_t (&hi)[NJ][4],
                                                const uint32_t (&lo)[NJ][4], uint32_t tile, int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mma_rows(acc, hi[j], tile + j * kTileBytes, lane);
    mma_rows(acc, lo[j], tile + j * kTileBytes, lane);
  }
}

// x = a1 . tile1^T and y = a2 . tile2^T, by the warpgroup (wgmma, started and
// waited for here) or by this warp alone (mma.sync).
template <int NJ, bool WARPGROUP>
__device__ __forceinline__ void two_scores(float (&x)[NJ][2][4], float (&y)[NJ][2][4], const uint32_t (&a1)[4][4],
                                           const uint32_t (&a2)[4][4], uint32_t tile1, uint32_t tile2, int lane) {
  if (WARPGROUP) {
    wgmma_fence();
    tile_scores<NJ>(x, a1, tile1);
    tile_scores<NJ>(y, a2, tile2);
    wgmma_commit();
    wgmma_wait();
  } else {
    warp_scores<NJ>(x, a1, tile1, lane);
    warp_scores<NJ>(y, a2, tile2, lane);
  }
}

// ---- tile classes of the mask

// What the mask does to one 64 x 64 tile of the score matrix.
constexpr int kTileDead = 0;   // every entry at the floor: P = 0 exactly, the tile is skipped
constexpr int kTilePlain = 1;  // no mask entry but 0 and no row or column >= t: the fast path
constexpr int kTileMixed = 2;  // anything else: the general path
constexpr int kMaxBlocks = (kMaxTFwd + 63) / 64;  // blocks of 64 along either axis, up to T = 577

// classes[i * nblk + j] for query block i (one CTA each) and key block j. A
// block with a row that has no entry above the floor keeps all its tiles (its
// softmax is uniform over the floor entries).
__global__ void __launch_bounds__(256)
mask_tile_classes(const float* __restrict__ mask, int t, int nblk, unsigned char* __restrict__ classes) {
  __shared__ int dead[kMaxBlocks], zero[kMaxBlocks], dead_row;
  const int i = blockIdx.x, row = i * 64 + (threadIdx.x >> 2), part = threadIdx.x & 3;
  if (threadIdx.x < kMaxBlocks) dead[threadIdx.x] = zero[threadIdx.x] = 1;
  if (threadIdx.x == 0) dead_row = 0;
  __syncthreads();
  int live = 0;
  if (row < t) {
    for (int col = part; col < t; col += 4) {
      const float x = __ldg(mask + static_cast<size_t>(row) * t + col);
      if (x > kMaskFloor) {
        live = 1;
        dead[col >> 6] = 0;
      }
      if (x != 0.f) zero[col >> 6] = 0;
    }
  }
  live |= __shfl_xor_sync(kFull, live, 1);  // the four threads of a row
  live |= __shfl_xor_sync(kFull, live, 2);
  if (row < t && !live) dead_row = 1;
  __syncthreads();
  if (threadIdx.x < nblk) {
    const int j = threadIdx.x;
    const bool inside = (i + 1) * 64 <= t && (j + 1) * 64 <= t;
    classes[i * nblk + j] = dead[j] && !dead_row ? kTileDead : zero[j] && inside ? kTilePlain : kTileMixed;
  }
}

// The i-th whole tile that a block of 64 query rows or of 64 keys visits:
// `tile` its index along the other axis, `plain` whether it takes the fast
// path. Under a mask from the block's list in shared memory (a count, then
// index | class << 4 per tile that is not dead); without one every tile in
// order, plain unless it holds a row or column >= t, all from kernel
// parameters, so that the loops around the wgmma stay uniform to the compiler.
template <bool MASKED>
__device__ __forceinline__ void visited_tile(const unsigned char* list, int i, bool own_inside, int t, int& tile,
                                             bool& plain) {
  if (MASKED) {
    tile = list[i + 1] & 15;
    plain = list[i + 1] >> 4 == kTilePlain;
  } else {
    tile = i;
    plain = own_inside && (i + 1) * 64 <= t;
  }
}

// ---- the three sweeps on one tile in registers (NJ blocks of 16 columns)

// A query-row block's raw scores -> base 2: x * c + mask * log2(e), key
// columns >= t at -inf. Rows ra, rb (mask rows only where < t), columns
// col0 + 16 j + 8 nt + {0, 1}, the first nb blocks j. The general path of
// sweeps 1 and 2: a tile under a mask or at the ragged edge.
template <int NJ>
__device__ __forceinline__ void scale_and_mask(float (&x)[NJ][2][4], const float* __restrict__ mask, int t, int ra,
                                               int rb, int col0, int nb, float c) {
  const bool in_a = ra < t, in_b = rb < t, pairs = (t & 1) == 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = col0 + 16 * j + 8 * nt;
        float2 xa = make_float2(0.f, 0.f), xb = xa;
        if (mask != nullptr) {
          const float* mrow_a = mask + static_cast<size_t>(ra) * t;
          const float* mrow_b = mask + static_cast<size_t>(rb) * t;
          // a thread's two columns are neighbours: one 8-byte load where the
          // mask's rows keep them aligned (t even), else two 4-byte loads
          if (pairs) {
            if (col < t) {
              if (in_a) xa = __ldg(reinterpret_cast<const float2*>(mrow_a + col));
              if (in_b) xb = __ldg(reinterpret_cast<const float2*>(mrow_b + col));
            }
          } else {
            if (in_a && col < t) xa.x = __ldg(mrow_a + col);
            if (in_a && col + 1 < t) xa.y = __ldg(mrow_a + col + 1);
            if (in_b && col < t) xb.x = __ldg(mrow_b + col);
            if (in_b && col + 1 < t) xb.y = __ldg(mrow_b + col + 1);
          }
        }
        x[j][nt][0] = col < t ? fmaf(xa.x, kLog2e, x[j][nt][0] * c) : -INFINITY;
        x[j][nt][1] = col + 1 < t ? fmaf(xa.y, kLog2e, x[j][nt][1] * c) : -INFINITY;
        x[j][nt][2] = col < t ? fmaf(xb.x, kLog2e, x[j][nt][2] * c) : -INFINITY;
        x[j][nt][3] = col + 1 < t ? fmaf(xb.y, kLog2e, x[j][nt][3] * c) : -INFINITY;
      }
    }
  }
}

// Sweep 1: a thread's running max m (base 2) over its own columns, and
// l = sum 2^(v - m), dd = sum 2^(v - m) * dp relative to it. FAST (a plain
// tile): the mask adds nothing and no column is >= t, so the scale folds into
// the exponent's multiply-add and nothing is predicated.
template <bool FAST, int NJ>
__device__ __forceinline__ void sweep1_tile(float (&s)[NJ][2][4], const float (&dp)[NJ][2][4], float (&m)[2],
                                            float (&l)[2], float (&dd)[2], const float* __restrict__ mask, int t,
                                            int ra, int rb, int col0, int nb, float c) {
  if (!FAST) scale_and_mask(s, mask, t, ra, rb, col0, nb, c);
  float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (FAST || j < nb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) tm[e >> 1] = fmaxf(tm[e >> 1], s[j][nt][e]);
      }
    }
  }
  float base[2];  // the max to subtract: 0 while the thread has seen nothing but columns >= t
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tm[r] = fmaxf(m[r], FAST ? tm[r] * c : tm[r]);
    base[r] = tm[r] == -INFINITY ? 0.f : tm[r];
    const float corr = fast_exp2(m[r] - base[r]);
    l[r] *= corr;
    dd[r] *= corr;
    m[r] = tm[r];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (FAST || j < nb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = fast_exp2(FAST ? fmaf(s[j][nt][e], c, -base[e >> 1]) : s[j][nt][e] - base[e >> 1]);
          l[e >> 1] += ex;
          dd[e >> 1] = fmaf(ex, dp[j][nt][e], dd[e >> 1]);
        }
      }
    }
  }
}

// The end of sweep 1: the quad's threads merge their statistics; the rows'
// final m, 1 / l and dd stay in registers and go to shared memory for sweep 3.
__device__ __forceinline__ void merge_statistics(float (&m)[2], float (&l)[2], float (&dd)[2], float* stat_m,
                                                 float* stat_i, float* stat_d, int ra, int rb, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mx = quad_max(m[r]), f = fast_exp2(m[r] - mx);
    l[r] = 1.f / quad_sum(l[r] * f);
    dd[r] = quad_sum(dd[r] * f) * l[r];
    m[r] = mx;
  }
  if ((lane & 3) == 0) {
    stat_m[ra] = m[0]; stat_i[ra] = l[0]; stat_d[ra] = dd[0];
    stat_m[rb] = m[1]; stat_i[rb] = l[1]; stat_d[rb] = dd[1];
  }
}

// Sweep 2: dS = P * (dp - dd) with the rows' final statistics (m base 2,
// inv = 1 / row sum), as the A operands of dq += dS.K.
template <bool FAST, int NJ>
__device__ __forceinline__ void sweep2_tile(float (&s)[NJ][2][4], float (&dp)[NJ][2][4], uint32_t (&hi)[NJ][4],
                                            uint32_t (&lo)[NJ][4], const float (&m)[2], const float (&inv)[2],
                                            const float (&dd)[2], const float* __restrict__ mask, int t, int ra,
                                            int rb, int col0, int nb, float c) {
  if (!FAST) scale_and_mask(s, mask, t, ra, rb, col0, nb, c);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (FAST || j < nb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              fast_exp2(FAST ? fmaf(s[j][nt][e], c, -m[e >> 1]) : s[j][nt][e] - m[e >> 1]) * inv[e >> 1];
          dp[j][nt][e] = p * (dp[j][nt][e] - dd[e >> 1]);
        }
      }
      to_operand(dp[j], hi[j], lo[j]);
    }
  }
}

// Sweep 3 on a transposed tile (rows: keys ka and kb8, columns: queries
// q00 + 16 j + 8 nt + {0, 1}): P^T and dS^T from the queries' statistics in
// shared memory, as the A operands of dv += P^T.G and dk += dS^T.Q. FAST: a
// plain tile.
template <bool FAST, int NJ>
__device__ __forceinline__ void sweep3_tile(float (&st)[NJ][2][4], float (&dpt)[NJ][2][4], uint32_t (&p_hi)[NJ][4],
                                            uint32_t (&p_lo)[NJ][4], uint32_t (&ds_hi)[NJ][4],
                                            uint32_t (&ds_lo)[NJ][4], const float* stat_m, const float* stat_i,
                                            const float* stat_d, const float* __restrict__ mask, int t, int ka,
                                            int kb8, int q00, int nb, float c) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (FAST || j < nb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int q0 = q00 + 16 * j + 8 * nt;  // even: this query and the next
        const float2 qm = *reinterpret_cast<const float2*>(stat_m + q0);
        const float2 qi = *reinterpret_cast<const float2*>(stat_i + q0);
        const float2 qd = *reinterpret_cast<const float2*>(stat_d + q0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sm = e & 1 ? qm.y : qm.x, si = e & 1 ? qi.y : qi.x, sd = e & 1 ? qd.y : qd.x;
          float p;
          if (FAST) {
            p = fast_exp2(fmaf(st[j][nt][e], c, -sm)) * si;
          } else {
            const int q = q0 + (e & 1), key = e < 2 ? ka : kb8;
            p = 0.f;
            if (q < t && key < t) {
              float v = st[j][nt][e] * c;
              if (mask != nullptr) v = fmaf(__ldg(mask + static_cast<size_t>(q) * t + key), kLog2e, v);
              p = fast_exp2(v - sm) * si;
            }
          }
          st[j][nt][e] = p;
          dpt[j][nt][e] = p * (dpt[j][nt][e] - sd);
        }
      }
      to_operand(st[j], p_hi[j], p_lo[j]);
      to_operand(dpt[j], ds_hi[j], ds_lo[j]);
    }
  }
}

// ---- one step of a warpgroup's sweep: products, the sweep on the tile, products

struct LongArgs {
  const float* mask;
  float* stat_m;
  float* stat_i;
  float* stat_d;
  int t;
  float c;
  int lane;
};

// Sweep 1 of a block of 64 query rows on one key tile (at `ktile`, `vtile`).
template <int NJ, bool WARPGROUP>
__device__ __forceinline__ void rows_step1(const LongArgs& a, const uint32_t (&qa)[4][4], const uint32_t (&ga)[4][4],
                                           uint32_t ktile, uint32_t vtile, bool active, bool plain, float (&m)[2],
                                           float (&l)[2], float (&dd)[2], int ra, int rb, int col0, int nb) {
  float s[NJ][2][4], dp[NJ][2][4];
  two_scores<NJ, WARPGROUP>(s, dp, qa, ga, ktile, vtile, a.lane);
  if (active) {
    if (plain) {
      sweep1_tile<true, NJ>(s, dp, m, l, dd, a.mask, a.t, ra, rb, col0, NJ, a.c);
    } else {
      sweep1_tile<false, NJ>(s, dp, m, l, dd, a.mask, a.t, ra, rb, col0, nb, a.c);
    }
  }
}

// Sweep 2 of a block of 64 query rows on one key tile: dq += dS.K
template <int NJ, bool WARPGROUP>
__device__ __forceinline__ void rows_step2(const LongArgs& a, const uint32_t (&qa)[4][4], const uint32_t (&ga)[4][4],
                                           uint32_t ktile, uint32_t vtile, bool active, bool plain,
                                           const float (&m)[2], const float (&l)[2], const float (&dd)[2],
                                           float (&dq)[8][4], int ra, int rb, int col0, int nb) {
  float s[NJ][2][4], dp[NJ][2][4];
  two_scores<NJ, WARPGROUP>(s, dp, qa, ga, ktile, vtile, a.lane);
  uint32_t hi[NJ][4] = {}, lo[NJ][4] = {};
  if (active) {
    if (plain) {
      sweep2_tile<true, NJ>(s, dp, hi, lo, m, l, dd, a.mask, a.t, ra, rb, col0, NJ, a.c);
    } else {
      sweep2_tile<false, NJ>(s, dp, hi, lo, m, l, dd, a.mask, a.t, ra, rb, col0, nb, a.c);
    }
  }
  if (WARPGROUP) {
    wgmma_fence();
    tile_accumulate<NJ>(dq, hi, lo, ktile);
    wgmma_commit();
    wgmma_wait();
  } else {
    warp_accumulate<NJ>(dq, hi, lo, ktile, a.lane);
  }
}

// Sweep 3 of a block of 64 keys on one query tile (at `qtile`, `gtile`):
// dv += P^T.G, dk += dS^T.Q
template <int NJ, bool WARPGROUP>
__device__ __forceinline__ void keys_step(const LongArgs& a, const uint32_t (&kf)[4][4], const uint32_t (&vf)[4][4],
                                          uint32_t qtile, uint32_t gtile, bool active, bool plain, float (&dv)[8][4],
                                          float (&dk)[8][4], int ka, int kb8, int q00, int nb) {
  float st[NJ][2][4], dpt[NJ][2][4];
  two_scores<NJ, WARPGROUP>(st, dpt, kf, vf, qtile, gtile, a.lane);
  uint32_t p_hi[NJ][4] = {}, p_lo[NJ][4] = {}, ds_hi[NJ][4] = {}, ds_lo[NJ][4] = {};
  if (active) {
    if (plain) {
      sweep3_tile<true, NJ>(st, dpt, p_hi, p_lo, ds_hi, ds_lo, a.stat_m, a.stat_i, a.stat_d, a.mask, a.t, ka,
                            kb8, q00, NJ, a.c);
    } else {
      sweep3_tile<false, NJ>(st, dpt, p_hi, p_lo, ds_hi, ds_lo, a.stat_m, a.stat_i, a.stat_d, a.mask, a.t, ka,
                             kb8, q00, nb, a.c);
    }
  }
  if (WARPGROUP) {
    wgmma_fence();
    tile_accumulate<NJ>(dv, p_hi, p_lo, gtile);
    tile_accumulate<NJ>(dk, ds_hi, ds_lo, qtile);
    wgmma_commit();
    wgmma_wait();
  } else {
    warp_accumulate<NJ>(dv, p_hi, p_lo, gtile, a.lane);
    warp_accumulate<NJ>(dk, ds_hi, ds_lo, qtile, a.lane);
  }
}

__device__ __forceinline__ void scale_tile(float (&o)[8][4], float factor) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] *= factor;
  }
}

// ---- a tail of at most 16 rows behind the whole blocks of 64 (a fifth block
// of 64 for one row of T = 257 would cost a warpgroup a whole round): the four
// warps of the second warpgroup on mma.sync, the same steps. Warp w takes the
// tiles w, w + 4, ... along the other axis (the last one is the tail's own 16
// columns); the warps' partial results meet in shared memory and are summed
// in the order of the warps.

__device__ __forceinline__ void tail_barrier() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// A warp's 16 x 64 fp32 accumulators into its partial tile, rows of 64 floats.
__device__ __forceinline__ void put_partial(const float (&o)[8][4], float* part, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(part + g * 64 + 8 * nt + 2 * tq) = make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(part + (g + 8) * 64 + 8 * nt + 2 * tq) = make_float2(o[nt][2], o[nt][3]);
  }
}

// The four partial tiles summed, scaled and stored: warp w takes the columns
// 16 w .., a lane 8 of them in one row. `orow` points at the output row of tile
// row 0, `rows` is how many of the 16 rows exist.
__device__ __forceinline__ void sum_partials(const float* parts, float factor, bf16* __restrict__ orow, int rows,
                                             int stride, int w, int lane) {
  const int row = lane >> 1, col = 16 * w + 8 * (lane & 1);
  float acc[8] = {};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float4 lo = *reinterpret_cast<const float4*>(parts + p * 1024 + row * 64 + col);
    const float4 hi = *reinterpret_cast<const float4*>(parts + p * 1024 + row * 64 + col + 4);
    acc[0] += lo.x; acc[1] += lo.y; acc[2] += lo.z; acc[3] += lo.w;
    acc[4] += hi.x; acc[5] += hi.y; acc[6] += hi.z; acc[7] += hi.w;
  }
  if (row < rows) {
    uint4 v;
    v.x = pack_bf16(acc[0] * factor, acc[1] * factor);
    v.y = pack_bf16(acc[2] * factor, acc[3] * factor);
    v.z = pack_bf16(acc[4] * factor, acc[5] * factor);
    v.w = pack_bf16(acc[6] * factor, acc[7] * factor);
    *reinterpret_cast<uint4*>(orow + static_cast<size_t>(row) * stride + col) = v;
  }
}

// Sweeps 1 and 2 of the tail's query rows (from row0 = 64 nwhole, staged in
// `qtile` and `gtile`) against the whole key tiles and the tail's own: their
// statistics and dq. `parts`: four partial tiles and, behind them, the warps'
// partial statistics.
template <bool MASKED>
__device__ __forceinline__ void tail_rows(const LongArgs& a, const unsigned char* __restrict__ classes, int nwhole,
                                          const unsigned char* qtile, const unsigned char* gtile, uint32_t kaddr,
                                          uint32_t vaddr, float* parts, bf16* out, int stride, float scale, int w) {
  const int g8 = a.lane >> 2, row0 = nwhole * 64, ra = row0 + g8, rb = ra + 8, c0 = 2 * (a.lane & 3);
  const unsigned char* cls = MASKED ? classes + nwhole * (nwhole + 1) : nullptr;  // the tail's row of tile classes
  float* pstat = parts + 4 * 1024;  // [warp][m | l | dd][16 rows], in the half that sweep 3 will use
  uint32_t qa[4][4], ga[4][4];
  load_q(qa, qtile, a.lane);
  load_q(ga, gtile, a.lane);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  for (int kt = w; kt <= nwhole; kt += 4) {
    if (MASKED && cls[kt] == kTileDead) continue;
    const uint32_t off = kt * 4 * kTileBytes;
    if (kt < nwhole) {
      rows_step1<4, false>(a, qa, ga, kaddr + off, vaddr + off, true, !MASKED, m, l, dd, ra, rb, kt * 64 + c0, 4);
    } else {
      rows_step1<1, false>(a, qa, ga, kaddr + off, vaddr + off, true, false, m, l, dd, ra, rb, kt * 64 + c0, 1);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the quad's threads, then the warps; a warp without a tile brings (-inf, 0, 0)
    const float mx = quad_max(m[r]), f = fast_exp2(m[r] - (mx == -INFINITY ? 0.f : mx));
    l[r] = quad_sum(l[r] * f);
    dd[r] = quad_sum(dd[r] * f);
    if ((a.lane & 3) == 0) {
      pstat[w * 48 + g8 + 8 * r] = mx;
      pstat[w * 48 + 16 + g8 + 8 * r] = l[r];
      pstat[w * 48 + 32 + g8 + 8 * r] = dd[r];
    }
  }
  tail_barrier();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int p = 0; p < 4; ++p) mx = fmaxf(mx, pstat[p * 48 + g8 + 8 * r]);
    float lsum = 0.f, dsum = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float f = fast_exp2(pstat[p * 48 + g8 + 8 * r] - mx);
      lsum = fmaf(pstat[p * 48 + 16 + g8 + 8 * r], f, lsum);
      dsum = fmaf(pstat[p * 48 + 32 + g8 + 8 * r], f, dsum);
    }
    m[r] = mx;
    l[r] = 1.f / lsum;
    dd[r] = dsum * l[r];
  }
  if (w == 0 && (a.lane & 3) == 0) {
    a.stat_m[ra] = m[0]; a.stat_i[ra] = l[0]; a.stat_d[ra] = dd[0];
    a.stat_m[rb] = m[1]; a.stat_i[rb] = l[1]; a.stat_d[rb] = dd[1];
  }

  float dq[8][4] = {};
  for (int kt = w; kt <= nwhole; kt += 4) {
    if (MASKED && cls[kt] == kTileDead) continue;
    const uint32_t off = kt * 4 * kTileBytes;
    if (kt < nwhole) {
      rows_step2<4, false>(a, qa, ga, kaddr + off, vaddr + off, true, !MASKED, m, l, dd, dq, ra, rb,
                           kt * 64 + c0, 4);
    } else {
      rows_step2<1, false>(a, qa, ga, kaddr + off, vaddr + off, true, false, m, l, dd, dq, ra, rb,
                           kt * 64 + c0, 1);
    }
  }
  put_partial(dq, parts + w * 1024, a.lane);
  tail_barrier();
  sum_partials(parts, scale, out + static_cast<size_t>(row0) * stride, a.t - row0, stride, w, a.lane);
}

// Sweep 3 of the tail's keys (from row0 = 64 nwhole, staged in `ktile` and
// `vtile`) against the whole query tiles and the tail's own: dv and dk.
// `parts`: twice four partial tiles.
template <bool MASKED>
__device__ __forceinline__ void tail_keys(const LongArgs& a, const unsigned char* __restrict__ classes, int nwhole,
                                          const unsigned char* ktile, const unsigned char* vtile, uint32_t qaddr,
                                          uint32_t gaddr, float* parts, bf16* out, int stride, int hd, float scale,
                                          int w) {
  const int row0 = nwhole * 64, ka = row0 + (a.lane >> 2), kb8 = ka + 8, c0 = 2 * (a.lane & 3);
  uint32_t kf[4][4], vf[4][4];
  load_q(kf, ktile, a.lane);
  load_q(vf, vtile, a.lane);
  float dv[8][4] = {}, dk[8][4] = {};
  for (int qt = w; qt <= nwhole; qt += 4) {
    if (MASKED && classes[qt * (nwhole + 1) + nwhole] == kTileDead) continue;
    const uint32_t off = qt * 4 * kTileBytes;
    if (qt < nwhole) {
      keys_step<4, false>(a, kf, vf, qaddr + off, gaddr + off, true, false, dv, dk, ka, kb8, qt * 64 + c0, 4);
    } else {
      keys_step<1, false>(a, kf, vf, qaddr + off, gaddr + off, true, false, dv, dk, ka, kb8, qt * 64 + c0, 1);
    }
  }
  put_partial(dv, parts + w * 1024, a.lane);
  put_partial(dk, parts + (4 + w) * 1024, a.lane);
  tail_barrier();
  bf16* orow = out + static_cast<size_t>(row0) * stride;
  sum_partials(parts, 1.f, orow + 2 * hd, a.t - row0, stride, w, a.lane);
  sum_partials(parts + 4 * 1024, scale, orow + hd, a.t - row0, stride, w, a.lane);
}

// Long regime: CTA = (sequence, head), two warpgroups; a warpgroup takes every
// other block of 64 query rows (sweeps 1 and 2) and of 64 keys (sweep 3), a
// warp 16 rows of the block. MASKED: `mask` and its tiles' `classes` are
// given. TAIL: T = 64 n + (1 to 16): the warpgroups take the n whole blocks,
// with the last 16 columns as a narrow step, and the second warpgroup's warps
// the tail's rows.
template <bool MASKED, bool TAIL>
__global__ void __launch_bounds__(kLongThreads, 1)
mha_bwd_mma_long(const bf16* __restrict__ qkv, const bf16* __restrict__ g, const float* __restrict__ mask,
                 const unsigned char* __restrict__ classes, bf16* __restrict__ dqkv, int t, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, w = warp & 3;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int hd = heads * kD, stride = 3 * hd;
  const int nblk = (t + 63) / 64, rows = nblk * 64, n16 = (t + 15) / 16;
  const int nwhole = TAIL ? nblk - 1 : nblk;  // blocks of 64 that the warpgroups take

  unsigned char* qs = smem;
  unsigned char* ks = qs + rows * kRowBytes;
  unsigned char* vs = ks + rows * kRowBytes;
  unsigned char* gs = vs + rows * kRowBytes;
  float* stat_m = reinterpret_cast<float*>(gs + rows * kRowBytes);  // row max (base 2) | 1 / row sum | rowsum(dp * P)
  float* stat_i = stat_m + rows;
  float* stat_d = stat_i + rows;
  unsigned char* otile = reinterpret_cast<unsigned char*>(stat_d + rows) + warp * kTileBytes;
  // under a mask, per block of query rows (and, behind them, per block of
  // keys): [0] how many whole tiles to visit, [1..5] tile index | class << 4,
  // [6] whether to visit the tail's columns
  unsigned char(*visit)[8] = reinterpret_cast<unsigned char(*)[8]>(otile + (kLongThreads / 32 - warp) * kTileBytes);
  float* parts = reinterpret_cast<float*>(visit + 16);  // TAIL: the tail warps' partial tiles

  const bf16* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  stage_rows(qs, base, rows, t, stride, threadIdx.x, kLongThreads);
  stage_rows(ks, base + hd, rows, t, stride, threadIdx.x, kLongThreads);
  stage_rows(vs, base + 2 * hd, rows, t, stride, threadIdx.x, kLongThreads);
  stage_rows(gs, g + static_cast<size_t>(b) * t * hd + h * kD, rows, t, hd, threadIdx.x, kLongThreads);
  cp_async_commit();
  if (MASKED && threadIdx.x < 2 * nwhole) {
    const bool by_key = threadIdx.x >= nwhole;
    const int own = threadIdx.x - (by_key ? nwhole : 0);
    int n = 0;
    for (int other = 0; other < nblk; ++other) {
      const int cls = by_key ? classes[other * nblk + own] : classes[own * nblk + other];
      if (other == nwhole) {
        visit[threadIdx.x][6] = cls != kTileDead;
      } else if (cls != kTileDead) {
        visit[threadIdx.x][++n] = static_cast<unsigned char>(other | cls << 4);
      }
    }
    visit[threadIdx.x][0] = static_cast<unsigned char>(n);
  }
  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();

  const uint32_t qaddr = smem_u32(qs), kaddr = smem_u32(ks), vaddr = smem_u32(vs), gaddr = smem_u32(gs);
  const LongArgs a = {mask, stat_m, stat_i, stat_d, t, scale * kLog2e, lane};
  const int g8 = lane >> 2, c0 = 2 * (lane & 3);
  const uint32_t tail_off = nwhole * 4 * kTileBytes;  // the tail's 16 rows in a staged matrix
  bf16* out = dqkv + static_cast<size_t>(b) * t * stride + h * kD;

  // ---- sweeps 1 and 2: a block of 64 query rows against every key tile
  for (int qb = wg; qb < nwhole; qb += 2) {
    const int row0 = qb * 64 + w * 16, ra = row0 + g8, rb = ra + 8;
    const bool active = row0 < t;  // uniform over the warp; the wgmma are the whole warpgroup's
    const bool tail_too = TAIL && (!MASKED || visit[qb][6]);
    uint32_t qa[4][4], ga[4][4];
    load_q(qa, qs + (qb * 4 + w) * kTileBytes, lane);
    load_q(ga, gs + (qb * 4 + w) * kTileBytes, lane);

    // sweep 1: a thread's own columns give it a running max m, and l and dd
    // relative to it; the quad merges them once at the end
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    const int ntiles = MASKED ? visit[qb][0] : nwhole;
    for (int i = 0; i < ntiles; ++i) {
      int kt;
      bool plain;
      visited_tile<MASKED>(visit[qb], i, true, t, kt, plain);
      const uint32_t off = kt * 4 * kTileBytes;
      rows_step1<4, true>(a, qa, ga, kaddr + off, vaddr + off, active, plain, m, l, dd, ra, rb, kt * 64 + c0,
                          min(4, n16 - 4 * kt));
    }
    if (tail_too) {
      rows_step1<1, true>(a, qa, ga, kaddr + tail_off, vaddr + tail_off, active, false, m, l, dd, ra, rb,
                          nwhole * 64 + c0, 1);
    }
    if (active) merge_statistics(m, l, dd, stat_m, stat_i, stat_d, ra, rb, lane);

    // sweep 2: dq = dS.K * scale
    float dq[8][4] = {};
    for (int i = 0; i < ntiles; ++i) {
      int kt;
      bool plain;
      visited_tile<MASKED>(visit[qb], i, true, t, kt, plain);
      const uint32_t off = kt * 4 * kTileBytes;
      rows_step2<4, true>(a, qa, ga, kaddr + off, vaddr + off, active, plain, m, l, dd, dq, ra, rb,
                          kt * 64 + c0, min(4, n16 - 4 * kt));
    }
    if (tail_too) {
      rows_step2<1, true>(a, qa, ga, kaddr + tail_off, vaddr + tail_off, active, false, m, l, dd, dq, ra, rb,
                          nwhole * 64 + c0, 1);
    }
    if (active) {
      scale_tile(dq, scale);
      store_tile(dq, otile, out + static_cast<size_t>(row0) * stride, t - row0, stride, lane);
    }
  }
  if (TAIL && wg == 1) {
    tail_rows<MASKED>(a, classes, nwhole, qs + tail_off, gs + tail_off, kaddr, vaddr, parts, out, stride, scale, w);
  }
  __syncthreads();  // every row's statistics are in shared memory

  // ---- sweep 3: a block of 64 keys against every query tile, transposed
  for (int kb = wg; kb < nwhole; kb += 2) {
    const int row0 = kb * 64 + w * 16, ka = row0 + g8, kb8 = ka + 8;
    const bool active = row0 < t;
    const unsigned char* list = visit[nwhole + kb];
    uint32_t kf[4][4], vf[4][4];
    load_q(kf, ks + (kb * 4 + w) * kTileBytes, lane);
    load_q(vf, vs + (kb * 4 + w) * kTileBytes, lane);
    float dv[8][4] = {}, dk[8][4] = {};
    const int ntiles = MASKED ? list[0] : nwhole;
    for (int i = 0; i < ntiles; ++i) {
      int qt;
      bool plain;
      visited_tile<MASKED>(list, i, row0 + 16 <= t, t, qt, plain);
      const uint32_t off = qt * 4 * kTileBytes;
      keys_step<4, true>(a, kf, vf, qaddr + off, gaddr + off, active, plain, dv, dk, ka, kb8, qt * 64 + c0,
                         min(4, n16 - 4 * qt));
    }
    if (TAIL && (!MASKED || list[6])) {
      keys_step<1, true>(a, kf, vf, qaddr + tail_off, gaddr + tail_off, active, false, dv, dk, ka, kb8,
                         nwhole * 64 + c0, 1);
    }
    if (active) {
      scale_tile(dk, scale);
      store_tile(dv, otile, out + static_cast<size_t>(row0) * stride + 2 * hd, t - row0, stride, lane);
      store_tile(dk, otile, out + static_cast<size_t>(row0) * stride + hd, t - row0, stride, lane);
    }
  }
  if (TAIL && wg == 1) {
    tail_keys<MASKED>(a, classes, nwhole, ks + tail_off, vs + tail_off, qaddr, gaddr, parts, out, stride, hd, scale,
                      w);
  }
}

size_t long_smem_bytes(int t, bool tail) {
  const size_t rows = static_cast<size_t>((t + 63) / 64) * 64;
  // Q, K, V, G | three statistics a row | an output tile a warp | the tiles to visit | with a tail: twice four
  // partial tiles of 16 x 64 floats | room to align to 1024 bytes
  return 4 * rows * kRowBytes + 3 * rows * sizeof(float) + (kLongThreads / 32) * kTileBytes + 128 +
         (tail ? 8 * 4096 : 0) + 1024;
}

template <bool MASKED, bool TAIL>
int launch_long(const bf16* qkv, const bf16* g, const float* mask, const unsigned char* classes, bf16* dqkv, int batch,
                int t, int heads, float scale, cudaStream_t stream) {
  static const cudaError_t attr =  // once per kernel and process
      cudaFuncSetAttribute(mha_bwd_mma_long<MASKED, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(long_smem_bytes(kMaxT, TAIL)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mha_bwd_mma_long<MASKED, TAIL><<<batch * heads, kLongThreads, long_smem_bytes(t, TAIL), stream>>>(
      qkv, g, mask, classes, dqkv, t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the longest regime (258 <= T <= 577): the long kernel's sweeps in two launches
//
// A head's Q, K, V and G no longer fit a CTA's shared memory (295 KB at T = 577), so the long kernel's three
// sweeps are cut at its barrier: launch (a) holds two blocks of query rows' Q and G and the head's whole K
// and V (sweeps 1 and 2: the rows' statistics, which go to a device scratch, and dq), launch (b) two blocks
// of keys' K and V and the head's whole Q and G with every row's statistics (sweep 3: dk and dv). Each
// launch loads the slices it holds whole once, by cp.async, each chunk of 64 rows counted by an mbarrier,
// so that a warpgroup starts on the first chunk while the others arrive and no CTA-wide barrier separates
// its tiles; the steps on a tile, the tile classes of a mask, the narrow step and the tail block on mma.sync
// are the long kernel's.

constexpr int kXlStatRows = kMaxBlocks * 64;  // rows of a head's statistics, in the scratch and in shared memory
constexpr int kXlOwnBar = kMaxBlocks;         // the mbarrier of the CTA's own two blocks (after one a chunk)

// rows of a slice held whole: the whole blocks of 64, then the tail's 16 rows
__host__ __device__ __forceinline__ int xl_rows_held(int t, bool tail) {
  return tail ? t / 64 * 64 + 16 : (t + 63) / 64 * 64;
}

// Launch (a) (`rows`) or (b): two own blocks | the other two slices whole | (b) the statistics | the tail's
// partial tiles | the visit lists | the mbarriers | room to align to 1024 bytes
__host__ __device__ __forceinline__ int xl_smem_bytes(int t, bool tail, bool rows) {
  return 2 * 128 * kRowBytes + 2 * xl_rows_held(t, tail) * kRowBytes + (rows ? 0 : 3 * kXlStatRows * 4) +
         (tail ? (rows ? 4 * 1024 + 4 * 48 : 8 * 1024) * 4 : 0) + 32 + 8 * (kMaxBlocks + 1) + 1024;
}

// The CTA's two own blocks (slice bases `a_src`, `b_src` with row strides `sa`, `sb`, from row 128 pair) and
// the other two slices (`c_src`, `d_src`, strides `sc`, `sd`) chunk by chunk, each chunk's arrival on its own
// mbarrier, all issued at once (issuing each chunk just before its first use was slower: 0.1843 against
// 0.1613 ms at B=6, the loads then on the sweeps' path); rows past t read row t - 1 (finite values that take
// weight 0 or are not stored).
__device__ __forceinline__ void xl_load(unsigned char* own_a, unsigned char* own_b, unsigned char* all_c,
                                        unsigned char* all_d, const bf16* a_src, size_t sa, const bf16* b_src,
                                        size_t sb, const bf16* c_src, size_t sc, const bf16* d_src, size_t sd, int t,
                                        int pair, int held, uint32_t bars) {
  const int tid = threadIdx.x, r0 = 128 * pair;
  copy_rows(own_a, a_src + static_cast<size_t>(r0) * sa, 0, 128, t - 1 - r0, sa, tid, kLongThreads);
  copy_rows(own_b, b_src + static_cast<size_t>(r0) * sb, 0, 128, t - 1 - r0, sb, tid, kLongThreads);
  cp_async_arrive(bars + 8 * kXlOwnBar);
  for (int j = 0; 64 * j < held; ++j) {
    const int r1 = min(64 * j + 64, held);
    copy_rows(all_c, c_src, 64 * j, r1, t - 1, sc, tid, kLongThreads);
    copy_rows(all_d, d_src, 64 * j, r1, t - 1, sd, tid, kLongThreads);
    cp_async_arrive(bars + 8 * j);
  }
}

// the chunk of the held slices at `bar` is in, for the tensor cores
__device__ __forceinline__ void xl_wait(uint32_t bar) {
  mbar_wait(bar, 0);
  fence_async_proxy();
}

// Under a mask, the list of tiles a block visits (the long kernel's: [0] how many whole tiles, [1..] tile
// index | class << 4), [11] whether it visits the tail; `by_key`: the block is one of keys.
__device__ __forceinline__ void xl_visit_list(unsigned char* list, const unsigned char* __restrict__ classes, int own,
                                              int nwhole, int nblk, bool by_key) {
  int n = 0;
  for (int other = 0; other < nblk; ++other) {
    const int cls = by_key ? classes[other * nblk + own] : classes[own * nblk + other];
    if (other == nwhole) {
      list[11] = cls != kTileDead;
    } else if (cls != kTileDead) {
      list[++n] = static_cast<unsigned char>(other | cls << 4);
    }
  }
  list[0] = static_cast<unsigned char>(n);
}

// Launch (a): CTA = (sequence, head, pair of query blocks), warpgroup wg the block 2 pair + wg (a warp 16 of
// its rows), or the tail block on its four warps. The statistics (row max in base 2, 1 / row sum,
// rowsum(dp * P)) go to `stats` [B * H, 3, 64 nblk] for launch (b).
template <bool MASKED, bool TAIL>
__global__ void __launch_bounds__(kLongThreads, 1)
mha_bwd_mma_xlong_rows(const bf16* __restrict__ qkv, const bf16* __restrict__ g, const float* __restrict__ mask,
                       const unsigned char* __restrict__ classes, float* __restrict__ stats,
                       bf16* __restrict__ dqkv, int t, int heads, int npairs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, w = warp & 3;
  const int bh = blockIdx.x / npairs, pair = blockIdx.x % npairs;
  const int b = bh / heads, h = bh % heads;
  const int hd = heads * kD, stride = 3 * hd;
  const int nblk = (t + 63) / 64, nwhole = TAIL ? nblk - 1 : nblk, held = xl_rows_held(t, TAIL), n16 = (t + 15) / 16;
  const int qb = 2 * pair + wg;  // this warpgroup's block of query rows

  unsigned char* qs = smem;
  unsigned char* gs = qs + 128 * kRowBytes;
  unsigned char* ks = gs + 128 * kRowBytes;
  unsigned char* vs = ks + held * kRowBytes;
  float* parts = reinterpret_cast<float*>(vs + held * kRowBytes);
  unsigned char(*visit)[12] =
      reinterpret_cast<unsigned char(*)[12]>(reinterpret_cast<unsigned char*>(parts) + (TAIL ? 4288 * 4 : 0));
  const uint32_t bars = smem_u32(visit + 2) + 8;  // 8-byte aligned behind the two 12-byte lists
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kXlOwnBar; ++i) mbar_init(bars + 8 * i, kLongThreads);
  }
  if (MASKED && threadIdx.x < 2 && 2 * pair + threadIdx.x < nwhole) {
    xl_visit_list(visit[threadIdx.x], classes, 2 * pair + threadIdx.x, nwhole, nblk, false);
  }
  __syncthreads();

  const bf16* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  xl_load(qs, gs, ks, vs, base, stride, g + static_cast<size_t>(b) * t * hd + h * kD, hd, base + hd, stride,
          base + 2 * hd, stride, t, pair, held, bars);

  const uint32_t kaddr = smem_u32(ks), vaddr = smem_u32(vs);
  float* stat_m = stats + static_cast<size_t>(bh) * 3 * nblk * 64;
  const LongArgs a = {mask, stat_m, stat_m + nblk * 64, stat_m + 2 * nblk * 64, t, scale * kLog2e, lane};
  const int g8 = lane >> 2, c0 = 2 * (lane & 3);
  const uint32_t tail_off = nwhole * 4 * kTileBytes;  // the tail's 16 key rows
  bf16* out = dqkv + static_cast<size_t>(b) * t * stride + h * kD;
  unsigned char* own = qs + (wg * 4 + w) * kTileBytes;  // the warp's Q tile (then its output's staging)
  mbar_wait(bars + 8 * kXlOwnBar, 0);

  if (qb < nwhole) {
    const int row0 = qb * 64 + w * 16, ra = row0 + g8, rb = ra + 8;
    const bool active = row0 < t;  // uniform over the warp; the wgmma are the whole warpgroup's
    const unsigned char* list = visit[wg];
    const bool tail_too = TAIL && (!MASKED || list[11]);
    uint32_t qa[4][4], ga[4][4];
    load_q(qa, own, lane);
    load_q(ga, gs + (wg * 4 + w) * kTileBytes, lane);

    // sweep 1: a thread's own columns give it a running max m, and l and dd relative to it; the quad merges
    // them once at the end. Each key chunk is waited for before its first use.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
    const int ntiles = MASKED ? list[0] : nwhole;
    for (int i = 0; i < ntiles; ++i) {
      int kt;
      bool plain;
      visited_tile<MASKED>(list, i, true, t, kt, plain);
      xl_wait(bars + 8 * kt);
      const uint32_t off = kt * 4 * kTileBytes;
      rows_step1<4, true>(a, qa, ga, kaddr + off, vaddr + off, active, plain, m, l, dd, ra, rb, kt * 64 + c0,
                          min(4, n16 - 4 * kt));
    }
    if (tail_too) {
      xl_wait(bars + 8 * nwhole);
      rows_step1<1, true>(a, qa, ga, kaddr + tail_off, vaddr + tail_off, active, false, m, l, dd, ra, rb,
                          nwhole * 64 + c0, 1);
    }
    if (active) merge_statistics(m, l, dd, a.stat_m, a.stat_i, a.stat_d, ra, rb, lane);

    // sweep 2: dq = dS.K * scale
    float dq[8][4] = {};
    for (int i = 0; i < ntiles; ++i) {
      int kt;
      bool plain;
      visited_tile<MASKED>(list, i, true, t, kt, plain);
      const uint32_t off = kt * 4 * kTileBytes;
      rows_step2<4, true>(a, qa, ga, kaddr + off, vaddr + off, active, plain, m, l, dd, dq, ra, rb, kt * 64 + c0,
                          min(4, n16 - 4 * kt));
    }
    if (tail_too) {
      rows_step2<1, true>(a, qa, ga, kaddr + tail_off, vaddr + tail_off, active, false, m, l, dd, dq, ra, rb,
                          nwhole * 64 + c0, 1);
    }
    if (active) {
      scale_tile(dq, scale);
      store_tile(dq, own, out + static_cast<size_t>(row0) * stride, t - row0, stride, lane);
    }
  } else if (TAIL && qb == nwhole) {  // the tail's rows: this warpgroup's four warps on mma.sync
    for (int j = 0; j <= nwhole; ++j) mbar_wait(bars + 8 * j, 0);
    tail_rows<MASKED>(a, classes, nwhole, qs + wg * 4 * kTileBytes, gs + wg * 4 * kTileBytes, kaddr, vaddr, parts,
                      out, stride, scale, w);
  }
}

// Launch (b): CTA = (sequence, head, pair of key blocks), warpgroup wg the block 2 pair + wg, or the tail
// block. S^T = K.Q^T and dP^T = V.G^T, P^T and dS^T from launch (a)'s statistics (rows >= t read as 0),
// dv += P^T.G and dk += dS^T.Q. Nothing is summed by atomics: two launches give the same bits.
template <bool MASKED, bool TAIL>
__global__ void __launch_bounds__(kLongThreads, 1)
mha_bwd_mma_xlong_keys(const bf16* __restrict__ qkv, const bf16* __restrict__ g, const float* __restrict__ mask,
                       const unsigned char* __restrict__ classes, const float* __restrict__ stats,
                       bf16* __restrict__ dqkv, int t, int heads, int npairs, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2, w = warp & 3;
  const int bh = blockIdx.x / npairs, pair = blockIdx.x % npairs;
  const int b = bh / heads, h = bh % heads;
  const int hd = heads * kD, stride = 3 * hd;
  const int nblk = (t + 63) / 64, nwhole = TAIL ? nblk - 1 : nblk, held = xl_rows_held(t, TAIL), n16 = (t + 15) / 16;
  const int kb = 2 * pair + wg;  // this warpgroup's block of keys

  unsigned char* ks = smem;
  unsigned char* vs = ks + 128 * kRowBytes;
  unsigned char* qs = vs + 128 * kRowBytes;
  unsigned char* gs = qs + held * kRowBytes;
  float* stat_m = reinterpret_cast<float*>(gs + held * kRowBytes);
  float* parts = stat_m + 3 * kXlStatRows;
  unsigned char(*visit)[12] =
      reinterpret_cast<unsigned char(*)[12]>(reinterpret_cast<unsigned char*>(parts) + (TAIL ? 8 * 1024 * 4 : 0));
  const uint32_t bars = smem_u32(visit + 2) + 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kXlOwnBar; ++i) mbar_init(bars + 8 * i, kLongThreads);
  }
  if (MASKED && threadIdx.x < 2 && 2 * pair + threadIdx.x < nwhole) {
    xl_visit_list(visit[threadIdx.x], classes, 2 * pair + threadIdx.x, nwhole, nblk, true);
  }
  const float* src = stats + static_cast<size_t>(bh) * 3 * nblk * 64;
  for (int i = threadIdx.x; i < 3 * nblk * 64; i += kLongThreads) {
    const int row = i % (nblk * 64);
    stat_m[(i / (nblk * 64)) * kXlStatRows + row] = row < t ? src[i] : 0.f;
  }
  __syncthreads();

  const bf16* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  const bf16* gbase = g + static_cast<size_t>(b) * t * hd + h * kD;
  xl_load(ks, vs, qs, gs, base + hd, stride, base + 2 * hd, stride, base, stride, gbase, hd, t, pair, held, bars);

  const uint32_t qaddr = smem_u32(qs), gaddr = smem_u32(gs);
  const LongArgs a = {mask, stat_m, stat_m + kXlStatRows, stat_m + 2 * kXlStatRows, t, scale * kLog2e, lane};
  const int g8 = lane >> 2, c0 = 2 * (lane & 3);
  const uint32_t tail_off = nwhole * 4 * kTileBytes;  // the tail's 16 query rows
  bf16* out = dqkv + static_cast<size_t>(b) * t * stride + h * kD;
  unsigned char* own = ks + (wg * 4 + w) * kTileBytes;  // the warp's K tile (then its outputs' staging)
  mbar_wait(bars + 8 * kXlOwnBar, 0);

  if (kb < nwhole) {
    const int row0 = kb * 64 + w * 16, ka = row0 + g8, kb8 = ka + 8;
    const bool active = row0 < t;
    const unsigned char* list = visit[wg];
    uint32_t kf[4][4], vf[4][4];
    load_q(kf, own, lane);
    load_q(vf, vs + (wg * 4 + w) * kTileBytes, lane);
    float dv[8][4] = {}, dk[8][4] = {};
    const int ntiles = MASKED ? list[0] : nwhole;
    for (int i = 0; i < ntiles; ++i) {
      int qt;
      bool plain;
      visited_tile<MASKED>(list, i, row0 + 16 <= t, t, qt, plain);
      xl_wait(bars + 8 * qt);
      const uint32_t off = qt * 4 * kTileBytes;
      keys_step<4, true>(a, kf, vf, qaddr + off, gaddr + off, active, plain, dv, dk, ka, kb8, qt * 64 + c0,
                         min(4, n16 - 4 * qt));
    }
    if (TAIL && (!MASKED || list[11])) {
      xl_wait(bars + 8 * nwhole);
      keys_step<1, true>(a, kf, vf, qaddr + tail_off, gaddr + tail_off, active, false, dv, dk, ka, kb8,
                         nwhole * 64 + c0, 1);
    }
    if (active) {
      scale_tile(dk, scale);
      store_tile(dv, own, out + static_cast<size_t>(row0) * stride + 2 * hd, t - row0, stride, lane);
      store_tile(dk, own, out + static_cast<size_t>(row0) * stride + hd, t - row0, stride, lane);
    }
  } else if (TAIL && kb == nwhole) {  // the tail's keys: this warpgroup's four warps on mma.sync
    for (int j = 0; j <= nwhole; ++j) mbar_wait(bars + 8 * j, 0);
    tail_keys<MASKED>(a, classes, nwhole, ks + wg * 4 * kTileBytes, vs + wg * 4 * kTileBytes, qaddr, gaddr, parts,
                      out, stride, hd, scale, w);
  }
}

template <bool MASKED, bool TAIL>
int launch_xlong(const bf16* qkv, const bf16* g, const float* mask, const unsigned char* classes, float* stats,
                 bf16* dqkv, int batch, int t, int heads, float scale, cudaStream_t stream) {
  static const cudaError_t attr_rows =  // once per kernel and process, at the largest T
      cudaFuncSetAttribute(mha_bwd_mma_xlong_rows<MASKED, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           xl_smem_bytes(kMaxTFwd, true, true));
  static const cudaError_t attr_keys =
      cudaFuncSetAttribute(mha_bwd_mma_xlong_keys<MASKED, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           xl_smem_bytes(kMaxTFwd, true, false));
  if (attr_rows != cudaSuccess) return static_cast<int>(attr_rows);
  if (attr_keys != cudaSuccess) return static_cast<int>(attr_keys);
  const int units = (TAIL ? t / 64 : (t + 63) / 64) + (TAIL ? 1 : 0);
  const int npairs = (units + 1) / 2;
  const long long ctas = static_cast<long long>(batch) * heads * npairs;
  if (ctas > 0x7fffffffLL) return kBadArgs;
  mha_bwd_mma_xlong_rows<MASKED, TAIL><<<static_cast<unsigned>(ctas), kLongThreads, xl_smem_bytes(t, TAIL, true),
                                         stream>>>(qkv, g, mask, classes, stats, dqkv, t, heads, npairs, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_mma_xlong_keys<MASKED, TAIL><<<static_cast<unsigned>(ctas), kLongThreads, xl_smem_bytes(t, TAIL, false),
                                         stream>>>(qkv, g, mask, classes, stats, dqkv, t, heads, npairs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 only. mask may be null. 1 <= T <= 16.
int rlcf_mha_bwd_mma_short(const void* qkv, const void* g, const void* mask, void* dqkv, int batch, int t, int heads,
                           float scale, void* stream) {
  if (bad_args(batch, t, heads) || t > kShortT) return kBadArgs;
  static const cudaError_t attr =  // once per kernel and process
      cudaFuncSetAttribute(mha_bwd_mma_short, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kBwdShortWarps * 4 * kTileBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int warps = heads < kBwdShortWarps ? heads : kBwdShortWarps;
  const dim3 grid(batch, (heads + kBwdShortWarps - 1) / kBwdShortWarps);
  if (grid.y > 65535u) return kBadArgs;
  mha_bwd_mma_short<<<grid, warps * 32, warps * 4 * kTileBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<const float*>(mask),
      static_cast<bf16*>(dqkv), t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 only. 17 <= T <= 257. mask may be null; with a mask, tile_classes is
// scratch of ceil(T / 64)^2 bytes that a first small kernel fills.
int rlcf_mha_bwd_mma_long(const void* qkv, const void* g, const void* mask, void* tile_classes, void* dqkv, int batch,
                          int t, int heads, float scale, void* stream) {
  if (bad_args(batch, t, heads) || t <= kShortT || (mask != nullptr && tile_classes == nullptr)) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* cot = static_cast<const bf16*>(g);
  const float* m = static_cast<const float*>(mask);
  unsigned char* classes = static_cast<unsigned char*>(tile_classes);
  bf16* out = static_cast<bf16*>(dqkv);
  const bool tail = t > 64 && t % 64 >= 1 && t % 64 <= 16;
  if (m != nullptr) {
    const int nblk = (t + 63) / 64;
    mask_tile_classes<<<nblk, 256, 0, s>>>(m, t, nblk, classes);
    return tail ? launch_long<true, true>(x, cot, m, classes, out, batch, t, heads, scale, s)
                : launch_long<true, false>(x, cot, m, classes, out, batch, t, heads, scale, s);
  }
  return tail ? launch_long<false, true>(x, cot, nullptr, nullptr, out, batch, t, heads, scale, s)
              : launch_long<false, false>(x, cot, nullptr, nullptr, out, batch, t, heads, scale, s);
}

// bf16 only. 258 <= T <= 577. mask may be null; with a mask, tile_classes is scratch of ceil(T / 64)^2
// bytes that a first small kernel fills. stats: scratch of B * H * 3 * 64 * ceil(T / 64) floats, written by
// the first launch and read by the second.
int rlcf_mha_bwd_mma_xlong(const void* qkv, const void* g, const void* mask, void* tile_classes, void* stats,
                           void* dqkv, int batch, int t, int heads, float scale, void* stream) {
  if (bad_args(batch, t, heads, kMaxTFwd) || t <= kMaxT || stats == nullptr ||
      (mask != nullptr && tile_classes == nullptr)) {
    return kBadArgs;
  }
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* cot = static_cast<const bf16*>(g);
  const float* m = static_cast<const float*>(mask);
  unsigned char* classes = static_cast<unsigned char*>(tile_classes);
  float* st = static_cast<float*>(stats);
  bf16* out = static_cast<bf16*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tail = t % 64 >= 1 && t % 64 <= 16;
  if (m != nullptr) {
    const int nblk = (t + 63) / 64;
    mask_tile_classes<<<nblk, 256, 0, s>>>(m, t, nblk, classes);
    return tail ? launch_xlong<true, true>(x, cot, m, classes, st, out, batch, t, heads, scale, s)
                : launch_xlong<true, false>(x, cot, m, classes, st, out, batch, t, heads, scale, s);
  }
  return tail ? launch_xlong<false, true>(x, cot, nullptr, nullptr, st, out, batch, t, heads, scale, s)
              : launch_xlong<false, false>(x, cot, nullptr, nullptr, st, out, batch, t, heads, scale, s);
}

}  // extern "C"

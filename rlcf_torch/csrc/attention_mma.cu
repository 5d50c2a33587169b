// Fused multi-head attention forward from the unsplit QKV projection in bf16,
// on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel `_mha_fwd_kernel` of
// rlcf_tpu/ops/pallas_attention.py:65 for bf16 inputs (fp32 inputs run the
// 3xTF32 kernel of attention_tf32.cu), and serves the `ATTN_IMPL = "flash"` switch of rlcf_tpu/models/layers.py:48.
//
//   qkv [B, T, 3*H*64] bf16 (+ additive mask [T, T] fp32) -> out [B, T, H*64]
//   s = q.k * scale (+ mask) in fp32; p = exp(s - rowmax) / rowsum in fp32,
//   rounded to bf16; out = P.V accumulated in fp32 and rounded once.
//
// What bounds it, and what the design does about it.
//
// Long sequences (17 <= T <= 257, the vision towers): bytes. At the policy
// tower's shape (B=256, T=197, H=12) qkv and out are ~310 MB, 0.09 ms of
// device memory time, against 0.03 ms of tensor-core time for the 30 GFLOP.
// So the kernel reads every qkv element from device memory once and keeps
// everything else on the SM:
//   * one CTA of one warpgroup per (sequence, head, block of 64 query rows);
//     a warp owns 16 of the rows. The blocks of one (sequence, head) have
//     neighbouring CTA indices, so they run together and all but the first
//     find K and V in L2. Two or three CTAs share an SM, so that one's loads
//     and softmax overlap another's matrix products;
//   * Q, K and V head slices go from the unsplit layout to shared memory by
//     cp.async in 16-byte pieces, Q and K as one group and V as a second, so
//     that V arrives while the scores are computed. Rows are 128 bytes; the
//     16-byte chunk c of row r is stored at chunk c ^ (r & 7): the 128-byte
//     swizzle of wgmma's shared-memory operands, which also makes every
//     ldmatrix and every staging store conflict-free without padding;
//   * S = Q.K^T and O = P.V run as wgmma (m64n64k16 and m64n16k16, bf16 in,
//     fp32 out) with A from registers (Q by ldmatrix, P straight from the
//     softmax) and B read from shared memory by the tensor cores: K as it
//     lies, V through the transpose flag. A first version on mma.sync with 16
//     query rows a warp was bound by its ldmatrix traffic (every K and V
//     fragment fetched from shared memory fed one 16-row product: 0.31 ms at
//     the policy shape on an H100 80GB HBM3 at 700 W); wgmma shares each fetch
//     among 64 rows (0.17 ms);
//   * the function rounds the NORMALISED P to bf16 before P.V, which an online
//     softmax cannot reproduce. A warp therefore holds its whole score row
//     block in registers (at most 17 blocks of 16 keys: 136 fp32 a thread),
//     takes the exact row max and sum with two shuffles each (in base 2:
//     scale * log2(e) and the max folded into one fused multiply-add a score,
//     ex2.approx), and packs P = exp(s - max) / sum straight into the
//     A-operand layout of P.V (the accumulator layout of S is that layout).
//     Q.K^T is computed once. The kernel is instantiated for 2, 5, 9, 13 and
//     17 key blocks so that each sequence length pays only for the registers
//     it needs; an instance multiplies all its key blocks;
//   * the ragged edge: key columns >= T get -inf before the max, the padding
//     rows of Q, K and V in shared memory are zero-filled (never read from
//     device memory), query rows >= T are not stored;
//   * the output tile goes through the warp's Q tile in shared memory and
//     leaves as 16-byte pieces, 128 contiguous bytes a row.
//
// Longer sequences (258 <= T <= 577: ViT-L/14 at 336 px, T = 24 * 24 + 1, the
// first tower of the reward ensemble): a warp's whole score rows no longer fit
// in registers (37 blocks of 16 keys, 296 fp32 a thread), and an online softmax
// would round the unnormalised P, another function. So two sweeps over the
// keys per block of 128 query rows (`mha_fwd_mma_xlong`):
//   * sweep 1 computes S chunk by chunk (64 keys a chunk, wgmma as above) and
//     keeps only each row's running max and sum (the sum rescaled when the max
//     grows); sweep 2 computes S again, forms P = 2^(v - max) / sum with the
//     final max and sum, rounds it to bf16 and accumulates P.V in fp32. The
//     function is the long kernel's; the second Q.K^T adds half again to the
//     products;
//   * a CTA is two warpgroups, 128 query rows, that share each chunk of K
//     and V: half the traffic from L2 into shared memory of one warpgroup a
//     CTA, which was slower at the ensemble's shape (PERF.md, PR 8);
//   * K and V stream through a ring of three shared-memory slots fed by
//     cp.async, each slot one chunk of K (sweep 1) or of K and V (sweep 2),
//     two chunks in flight while one is multiplied: 65 KB a CTA, so that
//     two CTAs share an SM whatever T is (one head's whole K and V at T = 577
//     would take 144 KB and leave one CTA an SM);
//   * the last chunk multiplies only the blocks of 16 keys it holds.
//
// Short sequences (T <= 16, the text tower's prompts): per-CTA and per-launch
// overhead, not arithmetic: a head's whole attention is one m16 tile, 8
// mma.sync for S and 8 for P.V. One CTA per sequence (per 16 heads of it), one warp
// per head; a warp stages its own head's three [T, 64] slices (whole 128-byte
// rows), needs no CTA-wide barrier, and keeps softmax in the accumulator
// registers.
//
// The mask is a general additive [T, T] fp32 tensor (already clamped to a
// finite floor by the wrapper); no key tile is skipped.
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after the launch, or kBadArgs for shapes it refuses.

#include "attention_mma.cuh"

namespace {

constexpr int kShortWarps = 16;    // heads per CTA in the short regime

// Exact fp32 softmax over the warp's whole score rows in registers (global
// query rows row0 .., KB blocks of 16 keys), P normalised and rounded to bf16,
// left in `p` as the A operands of P.V, one per key block. Works in base 2:
// p = 2^(v - max) / sum with v = s * scale * log2(e) (+ mask * log2(e));
// without a mask the multiply and the subtraction are one fused multiply-add
// per score. A thread holds rows ra = row0 + lane / 4 and rb = ra + 8 and, in
// each 8-key tile, the columns 2 * (lane % 4) and the next. Columns >= t get
// -inf, hence probability exactly 0.
template <int KB>
__device__ __forceinline__ void softmax_pack(float (&s)[KB][2][4], uint32_t (&p)[KB][4],
                                             const float* __restrict__ mask, int t, int row0, float scale,
                                             int lane) {
  const float c = scale * kLog2e;
  const int ra = row0 + (lane >> 2), rb = ra + 8, c0 = 2 * (lane & 3);
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;

#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    if (16 * kb + 16 > t) {  // uniform: a block that holds columns >= t
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (16 * kb + 8 * nt + c0 + e >= t) s[kb][nt][e] = s[kb][nt][2 + e] = -INFINITY;
        }
      }
    }
  }

  if (mask == nullptr) {
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        ma = fmaxf(ma, fmaxf(s[kb][nt][0], s[kb][nt][1]));
        mb = fmaxf(mb, fmaxf(s[kb][nt][2], s[kb][nt][3]));
      }
    }
    ma = -quad_max(ma) * c;
    mb = -quad_max(mb) * c;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          la += s[kb][nt][e] = fast_exp2(fmaf(s[kb][nt][e], c, ma));
          lb += s[kb][nt][2 + e] = fast_exp2(fmaf(s[kb][nt][2 + e], c, mb));
        }
      }
    }
  } else {
    // a thread's two columns of a tile are neighbours: one 8-byte load where
    // the mask's rows keep them aligned (t even), else two 4-byte loads
    const bool in_a = ra < t, in_b = rb < t, pairs = (t & 1) == 0;
    const float* mrow_a = mask + static_cast<size_t>(ra) * t;
    const float* mrow_b = mask + static_cast<size_t>(rb) * t;
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = 16 * kb + 8 * nt + c0;
        float2 xa = make_float2(0.f, 0.f), xb = xa;
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
        s[kb][nt][0] = fmaf(xa.x, kLog2e, s[kb][nt][0] * c);
        s[kb][nt][1] = fmaf(xa.y, kLog2e, s[kb][nt][1] * c);
        s[kb][nt][2] = fmaf(xb.x, kLog2e, s[kb][nt][2] * c);
        s[kb][nt][3] = fmaf(xb.y, kLog2e, s[kb][nt][3] * c);
        ma = fmaxf(ma, fmaxf(s[kb][nt][0], s[kb][nt][1]));
        mb = fmaxf(mb, fmaxf(s[kb][nt][2], s[kb][nt][3]));
      }
    }
    ma = quad_max(ma);
    mb = quad_max(mb);
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          la += s[kb][nt][e] = fast_exp2(s[kb][nt][e] - ma);
          lb += s[kb][nt][2 + e] = fast_exp2(s[kb][nt][2 + e] - mb);
        }
      }
    }
  }
  const float ia = 1.f / quad_sum(la), ib = 1.f / quad_sum(lb);

#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    p[kb][0] = pack_bf16(s[kb][0][0] * ia, s[kb][0][1] * ia);
    p[kb][1] = pack_bf16(s[kb][0][2] * ib, s[kb][0][3] * ib);
    p[kb][2] = pack_bf16(s[kb][1][0] * ia, s[kb][1][1] * ia);
    p[kb][3] = pack_bf16(s[kb][1][2] * ib, s[kb][1][3] * ib);
  }
}

// Long regime: CTA = one warpgroup = (sequence, head, block of 64 query rows),
// a warp owns 16 of the rows. All KB * 16 key rows of the shared-memory tiles
// take part: rows >= T are zero and get probability 0.
template <int KB, int MINB>
__global__ void __launch_bounds__(128, MINB)
mha_fwd_mma_long(const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ out, int t,
                 int heads, int nqb, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x / nqb, qrow0 = (blockIdx.x % nqb) * 64;
  const int b = bh / heads, h = bh % heads;
  const int hd = heads * kD;
  const size_t stride = 3 * static_cast<size_t>(hd);

  unsigned char* qs = smem;
  unsigned char* ks = qs + 4 * kTileBytes;
  unsigned char* vs = ks + KB * kTileBytes;

  // two cp.async groups: V arrives while the scores and the softmax run
  const bf16* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  stage_rows(qs, base + static_cast<size_t>(qrow0) * stride, 64, t - qrow0, stride, threadIdx.x, 128);
  stage_rows(ks, base + hd, KB * 16, t, stride, threadIdx.x, 128);
  cp_async_commit();
  stage_rows(vs, base + 2 * hd, KB * 16, t, stride, threadIdx.x, 128);
  cp_async_commit();

  const int row0 = qrow0 + warp * 16;
  const bool active = row0 < t;  // uniform over the warp; the wgmma are the whole warpgroup's
  unsigned char* qtile = qs + warp * kTileBytes;
  uint32_t qa[4][4];
  float s[KB][2][4];
  uint32_t p[KB][4];
  float o[8][4];

  cp_async_wait<1>();
  fence_async_proxy();
  __syncthreads();  // Q and K are in
  load_q(qa, qtile, lane);
  const uint32_t kaddr = smem_u32(ks);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // 16 head dimensions a step: 32 bytes along the rows
#pragma unroll
    for (int g = 0; g < KB / 4; ++g) {
      wgmma_n64<0>(&s[4 * g][0][0], qa[k], wgmma_desc(kaddr + g * 4 * kTileBytes + k * 32), k > 0);
    }
#pragma unroll
    for (int kb = KB / 4 * 4; kb < KB; ++kb) {
      wgmma_n16(&s[kb][0][0], qa[k], wgmma_desc(kaddr + kb * kTileBytes + k * 32), k > 0);
    }
  }
  wgmma_commit();
  wgmma_wait();
  if (active) softmax_pack<KB>(s, p, mask, t, row0, scale, lane);

  cp_async_wait<0>();
  fence_async_proxy();
  __syncthreads();  // V is in
  const uint32_t vaddr = smem_u32(vs);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) wgmma_n64<1>(&o[0][0], p[kb], wgmma_desc(vaddr + kb * kTileBytes), kb > 0);
  wgmma_commit();
  wgmma_wait();
  if (active) store_tile(o, qtile, out + (static_cast<size_t>(b) * t + row0) * hd + h * kD, t - row0, hd, lane);
}

// Short regime (T <= 16): CTA = (sequence, group of 16 heads), warp = head;
// one m16 tile a head on mma.sync.
__global__ void __launch_bounds__(kShortWarps * 32)
mha_fwd_mma_short(const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ out, int t,
                  int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x, h = blockIdx.y * kShortWarps + warp;
  if (h >= heads) return;  // no CTA-wide barrier below
  const int hd = heads * kD;
  const size_t stride = 3 * static_cast<size_t>(hd);

  unsigned char* qs = smem + warp * 3 * kTileBytes;
  unsigned char* ks = qs + kTileBytes;
  unsigned char* vs = ks + kTileBytes;
  const bf16* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  stage_rows(qs, base, 16, t, stride, lane, 32);
  stage_rows(ks, base + hd, 16, t, stride, lane, 32);
  stage_rows(vs, base + 2 * hd, 16, t, stride, lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  uint32_t qa[4][4];
  float s[1][2][4] = {};
  uint32_t p[1][4];
  float o[8][4] = {};
  load_q(qa, qs, lane);
  mma_scores(s[0], qa, smem_u32(ks), lane);  // S = Q.K^T
  softmax_pack<1>(s, p, mask, t, 0, scale, lane);
  mma_rows(o, p[0], smem_u32(vs), lane);  // O = P.V
  store_tile(o, qs, out + static_cast<size_t>(b) * t * hd + h * kD, t, hd, lane);
}

// ---- the longer regime (258 <= T <= 577): two sweeps over chunks of 64 keys

constexpr int kXlWarpgroups = 2;  // a CTA's warpgroups, 64 query rows each, sharing each K and V chunk
constexpr int kXlMinBlocks = 2;   // CTAs an SM should hold
constexpr int kXlThreads = 128 * kXlWarpgroups;
constexpr int kXlRows = 64 * kXlWarpgroups;
constexpr int kXlChunkBytes = 4 * kTileBytes;  // 64 key rows
constexpr int kXlStages = 3;                     // ring slots, each a K chunk and a V chunk
// Q, the ring, room to align to 1024 bytes
constexpr int kXlSmem = (4 * kXlWarpgroups + 2 * kXlStages * 4) * kTileBytes + 1024;

// S = Q.K^T for the chunk's KB blocks of 16 keys (one m64n64 product a depth
// step for a whole chunk, else KB m64n16 ones), then v = s * scale * log2(e)
// (+ mask * log2(e)); columns >= t get -inf. Rows ra = row0 + lane / 4 and
// ra + 8, columns k0 + 16 kb + 8 nt + 2 (lane % 4) and the next.
template <int KB>
__device__ __forceinline__ void xl_scores(float (&s)[4][2][4], const uint32_t (&qa)[4][4], uint32_t kaddr,
                                          const float* __restrict__ mask, int t, int ra, int k0, float c, int lane) {
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (KB == 4) {
      wgmma_n64<0>(&s[0][0][0], qa[k], wgmma_desc(kaddr + k * 32), k > 0);
    } else {
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        wgmma_n16(&s[kb][0][0], qa[k], wgmma_desc(kaddr + kb * kTileBytes + k * 32), k > 0);
      }
    }
  }
  wgmma_commit();
  wgmma_wait();
  const int rb = ra + 8;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 16 * kb + 8 * nt + 2 * (lane & 3) + e;
        float xa = 0.f, xb = 0.f;
        if (mask != nullptr && col < t) {
          if (ra < t) xa = __ldg(mask + static_cast<size_t>(ra) * t + col);
          if (rb < t) xb = __ldg(mask + static_cast<size_t>(rb) * t + col);
        }
        s[kb][nt][e] = col < t ? fmaf(xa, kLog2e, s[kb][nt][e] * c) : -INFINITY;
        s[kb][nt][2 + e] = col < t ? fmaf(xb, kLog2e, s[kb][nt][2 + e] * c) : -INFINITY;
      }
    }
  }
}

// Sweep 1: the rows' running max m and sum l (the thread's own columns; the
// quad's four partial sums share one max).
template <int KB>
__device__ __forceinline__ void xl_stats(const float (&s)[4][2][4], float (&m)[2], float (&l)[2]) {
  float cm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      cm[0] = fmaxf(cm[0], fmaxf(s[kb][nt][0], s[kb][nt][1]));
      cm[1] = fmaxf(cm[1], fmaxf(s[kb][nt][2], s[kb][nt][3]));
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // key 0 is in chunk 0, so m is finite from there on
    const float nm = fmaxf(m[r], quad_max(cm[r]));
    l[r] *= fast_exp2(m[r] - nm);
    m[r] = nm;
  }
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[0] += fast_exp2(s[kb][nt][e] - m[0]);
        l[1] += fast_exp2(s[kb][nt][2 + e] - m[1]);
      }
    }
  }
}

// Sweep 2: P = 2^(v - m) / l rounded to bf16 as the A operands of P.V, and
// O += P.V over the chunk's KB blocks of keys.
template <int KB>
__device__ __forceinline__ void xl_pv(float (&o)[8][4], const float (&s)[4][2][4], const float (&m)[2],
                                      const float (&il)[2], uint32_t vaddr) {
  uint32_t p[4][4];
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      p[kb][2 * nt] = pack_bf16(fast_exp2(s[kb][nt][0] - m[0]) * il[0], fast_exp2(s[kb][nt][1] - m[0]) * il[0]);
      p[kb][2 * nt + 1] = pack_bf16(fast_exp2(s[kb][nt][2] - m[1]) * il[1], fast_exp2(s[kb][nt][3] - m[1]) * il[1]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) wgmma_n64<1>(&o[0][0], p[kb], wgmma_desc(vaddr + kb * kTileBytes), 1);
  wgmma_commit();
  wgmma_wait();
}

// CTA = kXlWarpgroups warpgroups = (sequence, head, block of kXlRows query
// rows), a warp owns 16 of the rows; the warpgroups share the ring. Stage j of
// the ring is K chunk j for j < nc (sweep 1) and K and V chunk j - nc after
// (sweep 2); Q joins stage 0's cp.async group.
__global__ void __launch_bounds__(kXlThreads, kXlMinBlocks)
mha_fwd_mma_xlong(const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ out, int t,
                  int heads, int nqb, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x / nqb, qrow0 = (blockIdx.x % nqb) * kXlRows;
  const int b = bh / heads, h = bh % heads;
  const int hd = heads * kD;
  const size_t stride = 3 * static_cast<size_t>(hd);
  const bf16* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  unsigned char* qs = smem;
  unsigned char* ring = qs + 4 * kXlWarpgroups * kTileBytes;
  const int nc = (t + 63) / 64;

  auto issue = [&](int j) {  // one cp.async group a stage, empty past the last
    if (j < 2 * nc) {
      unsigned char* slot = ring + (j % kXlStages) * 2 * kXlChunkBytes;
      const int k0 = 64 * (j < nc ? j : j - nc);
      stage_rows(slot, base + hd + static_cast<size_t>(k0) * stride, 64, t - k0, stride, threadIdx.x, kXlThreads);
      if (j >= nc) {
        stage_rows(slot + kXlChunkBytes, base + 2 * hd + static_cast<size_t>(k0) * stride, 64, t - k0, stride,
                   threadIdx.x, kXlThreads);
      }
    }
    cp_async_commit();
  };
  stage_rows(qs, base + static_cast<size_t>(qrow0) * stride, kXlRows, t - qrow0, stride, threadIdx.x, kXlThreads);
  issue(0);
  issue(1);

  const int row0 = qrow0 + warp * 16, ra = row0 + (lane >> 2);
  const float c = scale * kLog2e;
  uint32_t qa[4][4];
  float s[4][2][4];
  float o[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, il[2];
  for (int j = 0; j < 2 * nc; ++j) {
    cp_async_wait<1>();
    fence_async_proxy();
    __syncthreads();  // stage j is in, and every warp is done with stage j - 1, whose slot stage j + 2 takes
    issue(j + 2);
    if (j == 0) load_q(qa, qs + warp * kTileBytes, lane);
    const uint32_t slot = smem_u32(ring + (j % kXlStages) * 2 * kXlChunkBytes);
    const int k0 = 64 * (j < nc ? j : j - nc);
    const int nkb = min(4, (t - k0 + 15) / 16);  // blocks of 16 keys the chunk holds (uniform)
    if (j == nc) {
      il[0] = 1.f / quad_sum(l[0]);
      il[1] = 1.f / quad_sum(l[1]);
    }
#define RLCF_XL_CHUNK(KB)                                       \
  xl_scores<KB>(s, qa, slot, mask, t, ra, k0, c, lane);         \
  if (j < nc) {                                                 \
    xl_stats<KB>(s, m, l);                                      \
  } else {                                                      \
    xl_pv<KB>(o, s, m, il, slot + kXlChunkBytes);               \
  }
    if (nkb == 4) {
      RLCF_XL_CHUNK(4)
    } else if (nkb == 3) {
      RLCF_XL_CHUNK(3)
    } else if (nkb == 2) {
      RLCF_XL_CHUNK(2)
    } else {
      RLCF_XL_CHUNK(1)
    }
#undef RLCF_XL_CHUNK
  }
  if (row0 < t) {
    store_tile(o, qs + warp * kTileBytes, out + (static_cast<size_t>(b) * t + row0) * hd + h * kD, t - row0, hd,
               lane);
  }
}

template <int KB, int MINB>
int launch_long(const bf16* qkv, const float* mask, bf16* out, int batch, int t, int heads, float scale,
                cudaStream_t stream) {
  constexpr int kSmem = (4 + 2 * KB) * kTileBytes + 1024;  // + room to align the tiles to 1024 bytes
  static const cudaError_t attr =  // once per kernel and process
      cudaFuncSetAttribute(mha_fwd_mma_long<KB, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nqb = (t + 63) / 64;
  const long long ctas = static_cast<long long>(batch) * heads * nqb;
  if (ctas > 0x7fffffffLL) return kBadArgs;
  mha_fwd_mma_long<KB, MINB><<<static_cast<unsigned>(ctas), 128, kSmem, stream>>>(qkv, mask, out, t, heads, nqb,
                                                                                    scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// bf16 only. mask may be null. 1 <= T <= 257 (the wrapper sends 17 <= T <= 257 here).
int rlcf_mha_fwd_mma_long(const void* qkv, const void* mask, void* out, int batch, int t, int heads, float scale,
                          void* stream) {
  if (bad_args(batch, t, heads)) return kBadArgs;
  const bf16* x = static_cast<const bf16*>(qkv);
  const float* m = static_cast<const float*>(mask);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkb = (t + 15) / 16;  // the smallest instance that holds the keys; MINB: CTAs an SM should hold
  if (nkb <= 2) return launch_long<2, 6>(x, m, o, batch, t, heads, scale, s);
  if (nkb <= 5) return launch_long<5, 4>(x, m, o, batch, t, heads, scale, s);
  if (nkb <= 9) return launch_long<9, 3>(x, m, o, batch, t, heads, scale, s);
  if (nkb <= 13) return launch_long<13, 3>(x, m, o, batch, t, heads, scale, s);
  return launch_long<17, 2>(x, m, o, batch, t, heads, scale, s);
}

// bf16 only. mask may be null. 1 <= T <= 577 (the wrapper sends 258 <= T <= 577 here).
int rlcf_mha_fwd_mma_xlong(const void* qkv, const void* mask, void* out, int batch, int t, int heads, float scale,
                           void* stream) {
  if (bad_args(batch, t, heads, kMaxTFwd)) return kBadArgs;
  static const cudaError_t attr =  // once per process
      cudaFuncSetAttribute(mha_fwd_mma_xlong, cudaFuncAttributeMaxDynamicSharedMemorySize, kXlSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nqb = (t + kXlRows - 1) / kXlRows;
  const long long ctas = static_cast<long long>(batch) * heads * nqb;
  if (ctas > 0x7fffffffLL) return kBadArgs;
  mha_fwd_mma_xlong<<<static_cast<unsigned>(ctas), kXlThreads, kXlSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask), static_cast<bf16*>(out), t, heads, nqb, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 only. mask may be null. 1 <= T <= 16.
int rlcf_mha_fwd_mma_short(const void* qkv, const void* mask, void* out, int batch, int t, int heads, float scale,
                           void* stream) {
  if (bad_args(batch, t, heads) || t > kShortT) return kBadArgs;
  static const cudaError_t attr =  // once per kernel and process
      cudaFuncSetAttribute(mha_fwd_mma_short, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kShortWarps * 3 * kTileBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int warps = heads < kShortWarps ? heads : kShortWarps;
  const dim3 grid(batch, (heads + kShortWarps - 1) / kShortWarps);
  if (grid.y > 65535u) return kBadArgs;
  mha_fwd_mma_short<<<grid, warps * 32, warps * 3 * kTileBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(mask), static_cast<bf16*>(out), t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

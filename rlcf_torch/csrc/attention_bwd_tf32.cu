// Fused multi-head attention backward from the unsplit QKV projection in
// fp32, on Hopper's tensor cores from split TF32 operands (sm_90a, mma.sync).
//
// Replaces the TPU kernel `_mha_bwd_kernel` of
// rlcf_tpu/ops/pallas_attention.py:89 for fp32 inputs (bf16 inputs run
// attention_bwd_mma.cu), and is the backward of the fp32 `ATTN_IMPL = "flash"`
// route of rlcf_tpu/models/layers.py:48.
//
//   (qkv [B, T, 3*H*64], g [B, T, H*64]) fp32 (+ additive mask [T, T] fp32)
//     -> dqkv [B, T, 3*H*64] fp32 in the fused layout
//   P = softmax(q.k * scale + mask) recomputed, dv = P^T g, dp = g v^T,
//   ds = P * (dp - rowsum(dp * P)), dq = ds k * scale, dk = ds^T q * scale.
//
// Every product runs on the tensor cores from split TF32 operands
// (attention_tf32.cuh: 3xTF32 above T = 16, six products up to it); P, dS and
// the row statistics are fp32 on the accumulators.
//
// What bounds it, and what the design does about it.
//
// Long sequences (17 <= T <= 257; the vision towers' lengths and
// ATTN_IMPL="flash"): operations (B=24, T=257, H=16: 16 GFLOP, 0.098 ms at the
// 3xTF32 rate, against 0.053 ms for its 177 MB). The kernel recomputes: a row's
// S and dP do not fit in registers, and dq (a sum over keys) and dk, dv (sums
// over queries) need both orders without atomics. One CTA of 8 warps per
// (sequence, head), two phases, each with two of the head's slices whole in
// shared memory (cp.async, padded fp32 rows, zero-filled to a multiple of 16;
// 151 KB at T=257, one CTA an SM):
//   A. K and V staged; a warp owns 16 query rows at a time with Q and G as
//      split A operands in registers. Sweep 1 over the keys, 16 at a time: S
//      and dP, the row max (across the quad), the row sum and rowsum(dp * P)
//      online, rescaled with the max. Sweep 2: S and dP again, P = 2^(s - max)
//      / sum and dS in fp32, dq += dS.K with dS as the A operand in the
//      accumulator layout. dq leaves scaled; the statistics (max, 1 / sum,
//      rowsum(dp * P)) go to shared memory.
//   B. After a barrier, Q and G staged over K and V; a warp owns 16 keys at a
//      time with K and V as split A operands. Over the queries, 16 at a time:
//      S^T = K.Q^T and dP^T = V.G^T, P^T and dS^T from the stored statistics,
//      dv += P^T.G and dk += dS^T.Q. Two launches give the same bits.
// The B operands are split into TF32 pairs at each use, by every warp that
// reads them. Splitting each staged row once for the whole CTA instead (16-byte
// loads of hi and lo, streamed in chunks of 32 rows, two launches) was slower:
// the split copies double the shared-memory reads of every warp's fragments,
// which bound these 16-row mma.sync products.
// Rows >= T of Q and G are zero, so a padding row adds nothing to dk or dv
// (its dP and rowsum(dp * P) are 0); key columns >= T get probability 0;
// rows >= T are not stored.
//
// Longer sequences (258 <= T <= 577: ViT-L/14 at 336 px under encoder TTA,
// ATTN_IMPL="flash" at T = 384 and 512): two whole padded slices take 322 KB
// at T = 577, above a CTA's 227 KB. The two phases become two launches with
// the same arithmetic (3xTF32 on every product, the statistics online in
// fp32, no atomics, bit-identical repeats):
//   (a) `mha_bwd_tf32x3_xlong_rows`: CTA = (sequence, head, 128 query rows),
//       8 warps of 16 rows, Q and G as split A operands in registers; K and
//       V stream in chunks of 64 rows through a ring of three slots
//       (cp.async, padded fp32 rows, two chunks in flight), once for the
//       statistics and once for dq. The statistics go to a [B * H, 3, T] fp32
//       scratch in device memory.
//   (b) `mha_bwd_tf32x3_xlong_keys`: CTA = (sequence, head, 128 keys), K and
//       V in registers, every row's statistics in shared memory; Q and G
//       stream through the ring once for dv and dk.
// 104 KB and 112 KB of shared memory a CTA; the registers keep one CTA an SM,
// as the long kernel's.
//
// Short sequences (T <= 16, the text tower's prompts; B=800, H=8 moves 184 MB
// for 0.6 GFLOP): bytes and per-warp latency. One warp per (sequence, head), 4
// heads a CTA, no barrier: the warp reads its operand fragments straight from
// device memory, keeps S and dP as accumulators with the whole softmax row,
// feeds dS to dq = dS.K from the accumulator layout, and turns P and dS over
// through 2.5 KB of its own shared memory for dv = P^T.G and dk = dS^T.Q.
// Each product takes six passes of a three-way split, as accurate as fp32.
//
// The mask is a general additive [T, T] fp32 tensor (already clamped to a
// finite floor by the wrapper).
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after the launch, or kBadArgs for shapes it refuses.

#include "attention_tf32.cuh"

namespace {

constexpr int kLongWarps = 8;
constexpr int kShortHeads = 4;  // warps (heads) per CTA in the short regime
constexpr int kTrRow = 20;      // row stride of a warp's 16 x 16 transpose buffer: conflict-free reads

// S and dP of 16 rows (A operands qa, ga) against the 16 rows n0.. of two
// shared-memory tiles (kt: the rows of S's columns, vt: the rows of dP's).
__device__ __forceinline__ void scores_and_dp(float (&s)[2][4], float (&dp)[2][4], const SplitA (&qa)[8],
                                              const SplitA (&ga)[8], const float* kt, const float* vt, int n0,
                                              int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float b0, b1;
      ldb_rows(kt, n0 + 8 * nt, 8 * kk, lane, b0, b1);
      mma3(s[nt], qa[kk], b0, b1);
      ldb_rows(vt, n0 + 8 * nt, 8 * kk, lane, b0, b1);
      mma3(dp[nt], ga[kk], b0, b1);
    }
  }
}

// Long regime: CTA = (sequence, head), 8 warps.
__global__ void __launch_bounds__(kLongWarps * 32, 1)
mha_bwd_tf32x3_long(const float* __restrict__ qkv, const float* __restrict__ g, const float* __restrict__ mask,
                    float* __restrict__ dqkv, int t, int heads, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int hd = heads * kD, tp = (t + 15) & ~15;
  const size_t stride = 3 * static_cast<size_t>(hd);
  float* sa = smem_f;           // phase A: K, phase B: Q
  float* sb = sa + tp * kRow;   // phase A: V, phase B: G
  float* st_m = sb + tp * kRow; // per query row: max of s * scale * log2(e) (+ mask * log2(e))
  float* st_il = st_m + tp;     // 1 / row sum
  float* st_d = st_il + tp;     // rowsum(dp * P)

  const float* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  const float* gbase = g + static_cast<size_t>(b) * t * hd + h * kD;
  float* dbase = dqkv + static_cast<size_t>(b) * t * stride + h * kD;
  const float sc = scale * kLog2e;
  const int gr = lane >> 2, c0 = 2 * (lane & 3);

  stage_f32(sa, base + hd, tp, t, stride, threadIdx.x, kLongWarps * 32);
  stage_f32(sb, base + 2 * hd, tp, t, stride, threadIdx.x, kLongWarps * 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ---- phase A: warp per 16 query rows -> dq and the row statistics
  for (int row0 = warp * 16; row0 < t; row0 += kLongWarps * 16) {
    SplitA qa[8], ga[8];
    load_rows_a(qa, base + static_cast<size_t>(row0) * stride, t - row0, stride, lane);
    load_rows_a(ga, gbase + static_cast<size_t>(row0) * hd, t - row0, hd, lane);
    float s[2][4], dp[2][4];
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f, da = 0.f, db = 0.f;
    for (int k0 = 0; k0 < tp; k0 += 16) {  // sweep 1: statistics
      scores_and_dp(s, dp, qa, ga, sa, sb, k0, lane);
      float bma = -INFINITY, bmb = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        scores_to_log2(s[nt], mask, t, row0 + gr, k0 + 8 * nt + c0, sc);
        bma = fmaxf(bma, fmaxf(s[nt][0], s[nt][1]));
        bmb = fmaxf(bmb, fmaxf(s[nt][2], s[nt][3]));
      }
      const float na = fmaxf(ma, quad_max(bma)), nb = fmaxf(mb, quad_max(bmb));
      const float aa = fast_exp2(ma - na), ab = fast_exp2(mb - nb);
      ma = na;
      mb = nb;
      la *= aa;
      lb *= ab;
      da *= aa;
      db *= ab;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pa = fast_exp2(s[nt][e] - ma), pb = fast_exp2(s[nt][2 + e] - mb);
          la += pa;
          lb += pb;
          da += pa * dp[nt][e];
          db += pb * dp[nt][2 + e];
        }
      }
    }
    const float ila = 1.f / quad_sum(la), ilb = 1.f / quad_sum(lb);
    const float dda = quad_sum(da) * ila, ddb = quad_sum(db) * ilb;

    float dq[8][4] = {};
    for (int k0 = 0; k0 < tp; k0 += 16) {  // sweep 2: dS and dq
      scores_and_dp(s, dp, qa, ga, sa, sb, k0, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        scores_to_log2(s[nt], mask, t, row0 + gr, k0 + 8 * nt + c0, sc);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = fast_exp2(s[nt][e] - ma) * ila * (dp[nt][e] - dda);
          s[nt][2 + e] = fast_exp2(s[nt][2 + e] - mb) * ilb * (dp[nt][2 + e] - ddb);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const SplitA dsa = acc_as_a(s[kk]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float b0, b1;
          ldb_cols(sa, k0 + 8 * kk, 8 * nt, lane, b0, b1);
          mma3(dq[nt], dsa, b0, b1);
        }
      }
    }
    store_rows(dq, dbase + static_cast<size_t>(row0) * stride, t - row0, stride, scale, scale, lane);
    if ((lane & 3) == 0) {
      st_m[row0 + gr] = ma;
      st_m[row0 + gr + 8] = mb;
      st_il[row0 + gr] = ila;
      st_il[row0 + gr + 8] = ilb;
      st_d[row0 + gr] = dda;
      st_d[row0 + gr + 8] = ddb;
    }
  }
  __syncthreads();

  // ---- phase B: warp per 16 keys -> dk, dv (P^T and dS^T from the statistics)
  stage_f32(sa, base, tp, t, stride, threadIdx.x, kLongWarps * 32);
  stage_f32(sb, gbase, tp, t, hd, threadIdx.x, kLongWarps * 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int key0 = warp * 16; key0 < t; key0 += kLongWarps * 16) {
    SplitA ka[8], va[8];
    load_rows_a(ka, base + hd + static_cast<size_t>(key0) * stride, t - key0, stride, lane);
    load_rows_a(va, base + 2 * hd + static_cast<size_t>(key0) * stride, t - key0, stride, lane);
    float dk[8][4] = {}, dv[8][4] = {};
    for (int q0 = 0; q0 < tp; q0 += 16) {
      float st[2][4], dpt[2][4];  // S^T and dP^T: rows key0 + gr (+ 8), columns the queries
      scores_and_dp(st, dpt, ka, va, sa, sb, q0, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + 8 * nt + c0 + (e & 1), key = key0 + gr + 8 * (e >> 1);
          const float mv = mask != nullptr && q < t && key < t ? __ldg(mask + static_cast<size_t>(q) * t + key) : 0.f;
          const float p = fast_exp2(fmaf(mv, kLog2e, st[nt][e] * sc) - st_m[q]) * st_il[q];
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - st_d[q]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const SplitA pa = acc_as_a(st[kk]), dsa = acc_as_a(dpt[kk]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float b0, b1;
          ldb_cols(sb, q0 + 8 * kk, 8 * nt, lane, b0, b1);
          mma3(dv[nt], pa, b0, b1);
          ldb_cols(sa, q0 + 8 * kk, 8 * nt, lane, b0, b1);
          mma3(dk[nt], dsa, b0, b1);
        }
      }
    }
    store_rows(dk, dbase + hd + static_cast<size_t>(key0) * stride, t - key0, stride, scale, scale, lane);
    store_rows(dv, dbase + 2 * hd + static_cast<size_t>(key0) * stride, t - key0, stride, 1.f, 1.f, lane);
  }
}

// ---- the longest regime (258 <= T <= 577): the slices streamed, two launches
//
// Two whole padded fp32 slices take 161 KB at T = 577 each, so a CTA holds
// none: its own 16-row A operands come from device memory into registers (as
// the long kernel's), and the other two slices stream through a ring of three
// slots of 64 rows each (cp.async, padded rows), shared by the CTA's 8 warps.
// The steps on each 16-row block are the long kernel's.

constexpr int kXlWarps = 8;
constexpr int kXlRows = 16 * kXlWarps;            // a CTA's own rows: queries in launch (a), keys in (b)
constexpr int kXlChunk = 64;                      // rows of a streamed chunk
constexpr int kXlSlot = 2 * kXlChunk * kRow;      // floats of a ring slot: two slices' chunks
constexpr int kXlStages = 3;
constexpr int kXlStatRows = (kMaxTFwd + 63) / 64 * 64;
constexpr int kXlSmemRows = kXlStages * kXlSlot * static_cast<int>(sizeof(float));
constexpr int kXlSmemKeys = kXlSmemRows + 3 * kXlStatRows * static_cast<int>(sizeof(float));

// Launch (a): CTA = (sequence, head, 128 query rows), warp = 16 of them.
// Stage j of the ring is K and V chunk j mod nc: sweep 1 (j < nc) the rows'
// statistics online, sweep 2 dq = dS.K. The statistics (max, 1 / sum,
// rowsum(dp * P)) go to `stats` [B * H, 3, 64 nc] for launch (b).
__global__ void __launch_bounds__(kXlWarps * 32, 1)
mha_bwd_tf32x3_xlong_rows(const float* __restrict__ qkv, const float* __restrict__ g, const float* __restrict__ mask,
                          float* __restrict__ stats, float* __restrict__ dqkv, int t, int heads, int nqb,
                          float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x / nqb, row0 = (blockIdx.x % nqb) * kXlRows + warp * 16;
  const int b = bh / heads, h = bh % heads;
  const int hd = heads * kD, nc = (t + 63) / 64;
  const size_t stride = 3 * static_cast<size_t>(hd);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  const float sc = scale * kLog2e;
  const int gr = lane >> 2, c0 = 2 * (lane & 3);
  const bool active = row0 < t;  // uniform over the warp; no product spans warps

  auto issue = [&](int j) {  // one cp.async group a stage, empty past the last
    if (j < 2 * nc) {
      float* slot = smem_f + (j % kXlStages) * kXlSlot;
      const int k0 = kXlChunk * (j % nc);
      stage_f32(slot, base + hd + k0 * stride, kXlChunk, t - k0, stride, threadIdx.x, kXlWarps * 32);
      stage_f32(slot + kXlChunk * kRow, base + 2 * hd + k0 * stride, kXlChunk, t - k0, stride, threadIdx.x,
                kXlWarps * 32);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  SplitA qa[8], ga[8];
  if (active) {
    load_rows_a(qa, base + static_cast<size_t>(row0) * stride, t - row0, stride, lane);
    load_rows_a(ga, g + (static_cast<size_t>(b) * t + row0) * hd + h * kD, t - row0, hd, lane);
  }
  float s[2][4], dp[2][4], dq[8][4] = {};
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f, da = 0.f, db = 0.f, ila = 0.f, ilb = 0.f, dda = 0.f,
        ddb = 0.f;
  for (int j = 0; j < 2 * nc; ++j) {
    cp_async_wait<1>();
    __syncthreads();  // stage j is in, and every warp is done with stage j - 1, whose slot stage j + 2 takes
    issue(j + 2);
    if (!active) continue;
    const float* kt = smem_f + (j % kXlStages) * kXlSlot;
    const float* vt = kt + kXlChunk * kRow;
    const int kbase = kXlChunk * (j % nc), kend = min(kXlChunk, t - kbase);
    if (j == nc) {
      ila = 1.f / quad_sum(la);
      ilb = 1.f / quad_sum(lb);
      dda = quad_sum(da) * ila;
      ddb = quad_sum(db) * ilb;
    }
    for (int k0 = 0; k0 < kend; k0 += 16) {
      scores_and_dp(s, dp, qa, ga, kt, vt, k0, lane);
      if (j < nc) {  // sweep 1: statistics
        float bma = -INFINITY, bmb = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          scores_to_log2(s[nt], mask, t, row0 + gr, kbase + k0 + 8 * nt + c0, sc);
          bma = fmaxf(bma, fmaxf(s[nt][0], s[nt][1]));
          bmb = fmaxf(bmb, fmaxf(s[nt][2], s[nt][3]));
        }
        const float na = fmaxf(ma, quad_max(bma)), nb = fmaxf(mb, quad_max(bmb));
        const float aa = fast_exp2(ma - na), ab = fast_exp2(mb - nb);
        ma = na;
        mb = nb;
        la *= aa;
        lb *= ab;
        da *= aa;
        db *= ab;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pa = fast_exp2(s[nt][e] - ma), pb = fast_exp2(s[nt][2 + e] - mb);
            la += pa;
            lb += pb;
            da += pa * dp[nt][e];
            db += pb * dp[nt][2 + e];
          }
        }
      } else {  // sweep 2: dS and dq
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          scores_to_log2(s[nt], mask, t, row0 + gr, kbase + k0 + 8 * nt + c0, sc);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[nt][e] = fast_exp2(s[nt][e] - ma) * ila * (dp[nt][e] - dda);
            s[nt][2 + e] = fast_exp2(s[nt][2 + e] - mb) * ilb * (dp[nt][2 + e] - ddb);
          }
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const SplitA dsa = acc_as_a(s[kk]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            float b0, b1;
            ldb_cols(kt, k0 + 8 * kk, 8 * nt, lane, b0, b1);
            mma3(dq[nt], dsa, b0, b1);
          }
        }
      }
    }
  }
  if (active) {
    store_rows(dq, dqkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(row0) * stride + h * kD, t - row0,
               stride, scale, scale, lane);
    if ((lane & 3) == 0) {
      float* st = stats + static_cast<size_t>(bh) * 3 * nc * 64;
      st[row0 + gr] = ma;
      st[row0 + gr + 8] = mb;
      st[nc * 64 + row0 + gr] = ila;
      st[nc * 64 + row0 + gr + 8] = ilb;
      st[2 * nc * 64 + row0 + gr] = dda;
      st[2 * nc * 64 + row0 + gr + 8] = ddb;
    }
  }
}

// Launch (b): CTA = (sequence, head, 128 keys), warp = 16 of them. Stage j of
// the ring is Q and G chunk j: S^T = K.Q^T and dP^T = V.G^T, P^T and dS^T from
// launch (a)'s statistics (queries >= t give P = 0), dv += P^T.G and
// dk += dS^T.Q. Two launches give the same bits.
__global__ void __launch_bounds__(kXlWarps * 32, 1)
mha_bwd_tf32x3_xlong_keys(const float* __restrict__ qkv, const float* __restrict__ g, const float* __restrict__ mask,
                          const float* __restrict__ stats, float* __restrict__ dqkv, int t, int heads, int nkb,
                          float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x / nkb, key0 = (blockIdx.x % nkb) * kXlRows + warp * 16;
  const int b = bh / heads, h = bh % heads;
  const int hd = heads * kD, nc = (t + 63) / 64;
  const size_t stride = 3 * static_cast<size_t>(hd);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  const float* gbase = g + static_cast<size_t>(b) * t * hd + h * kD;
  const float sc = scale * kLog2e;
  const int gr = lane >> 2, c0 = 2 * (lane & 3);
  const bool active = key0 < t;
  float* st_m = smem_f + kXlStages * kXlSlot;
  float* st_il = st_m + kXlStatRows;
  float* st_d = st_il + kXlStatRows;

  auto issue = [&](int j) {
    if (j < nc) {
      float* slot = smem_f + (j % kXlStages) * kXlSlot;
      const int q0 = kXlChunk * j;
      stage_f32(slot, base + q0 * stride, kXlChunk, t - q0, stride, threadIdx.x, kXlWarps * 32);
      stage_f32(slot + kXlChunk * kRow, gbase + static_cast<size_t>(q0) * hd, kXlChunk, t - q0, hd, threadIdx.x,
                kXlWarps * 32);
    }
    cp_async_commit();
  };
  const float* src = stats + static_cast<size_t>(bh) * 3 * nc * 64;
  for (int i = threadIdx.x; i < 3 * nc * 64; i += kXlWarps * 32) {
    const int row = i % (nc * 64);
    st_m[(i / (nc * 64)) * kXlStatRows + row] = row < t ? src[i] : 0.f;
  }
  issue(0);
  issue(1);

  SplitA ka[8], va[8];
  if (active) {
    load_rows_a(ka, base + hd + static_cast<size_t>(key0) * stride, t - key0, stride, lane);
    load_rows_a(va, base + 2 * hd + static_cast<size_t>(key0) * stride, t - key0, stride, lane);
  }
  float dk[8][4] = {}, dv[8][4] = {};
  for (int j = 0; j < nc; ++j) {
    cp_async_wait<1>();
    __syncthreads();  // as launch (a); at j = 0 the statistics are in too
    issue(j + 2);
    if (!active) continue;
    const float* qt = smem_f + (j % kXlStages) * kXlSlot;
    const float* gt = qt + kXlChunk * kRow;
    const int qbase = kXlChunk * j, qend = min(kXlChunk, t - qbase);
    for (int q0 = 0; q0 < qend; q0 += 16) {
      float s[2][4], dpt[2][4];  // S^T and dP^T: rows key0 + gr (+ 8), columns the queries
      scores_and_dp(s, dpt, ka, va, qt, gt, q0, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = qbase + q0 + 8 * nt + c0 + (e & 1), key = key0 + gr + 8 * (e >> 1);
          const float mv = mask != nullptr && q < t && key < t ? __ldg(mask + static_cast<size_t>(q) * t + key) : 0.f;
          const float p = q < t ? fast_exp2(fmaf(mv, kLog2e, s[nt][e] * sc) - st_m[q]) * st_il[q] : 0.f;
          s[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - st_d[q]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const SplitA pa = acc_as_a(s[kk]), dsa = acc_as_a(dpt[kk]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float b0, b1;
          ldb_cols(gt, q0 + 8 * kk, 8 * nt, lane, b0, b1);
          mma3(dv[nt], pa, b0, b1);
          ldb_cols(qt, q0 + 8 * kk, 8 * nt, lane, b0, b1);
          mma3(dk[nt], dsa, b0, b1);
        }
      }
    }
  }
  if (active) {
    float* dbase = dqkv + static_cast<size_t>(b) * t * stride + static_cast<size_t>(key0) * stride + h * kD;
    store_rows(dk, dbase + hd, t - key0, stride, scale, scale, lane);
    store_rows(dv, dbase + 2 * hd, t - key0, stride, 1.f, 1.f, lane);
  }
}

// Short regime (T <= 16): CTA = (sequence, group of 4 heads), warp = head.
__global__ void __launch_bounds__(kShortHeads * 32)
mha_bwd_tf32x6_short(const float* __restrict__ qkv, const float* __restrict__ g, const float* __restrict__ mask,
                     float* __restrict__ dqkv, int t, int heads, float scale) {
  __shared__ __align__(16) float tr[kShortHeads][2][16 * kTrRow];  // a warp's P and dS, [query][key]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x, h = blockIdx.y * kShortHeads + warp;
  if (h >= heads) return;  // no CTA-wide barrier below
  const int hd = heads * kD;
  const size_t stride = 3 * static_cast<size_t>(hd);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  const float* gbase = g + static_cast<size_t>(b) * t * hd + h * kD;
  float* dbase = dqkv + static_cast<size_t>(b) * t * stride + h * kD;
  const int gr = lane >> 2, tq = lane & 3, c0 = 2 * tq;

  float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const Split3A qa = lda_global(base, t, stride, 8 * kk, lane);
    const Split3A ga = lda_global(gbase, t, hd, 8 * kk, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float b0, b1;
      ldg_rows(base + hd, stride, t, 8 * nt, 8 * kk, lane, b0, b1);
      mma6(s[nt], qa, b0, b1);
      ldg_rows(base + 2 * hd, stride, t, 8 * nt, 8 * kk, lane, b0, b1);
      mma6(dp[nt], ga, b0, b1);
    }
  }
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    scores_to_log2(s[nt], mask, t, gr, 8 * nt + c0, scale * kLog2e);
    ma = fmaxf(ma, fmaxf(s[nt][0], s[nt][1]));
    mb = fmaxf(mb, fmaxf(s[nt][2], s[nt][3]));
  }
  ma = quad_max(ma);
  mb = quad_max(mb);
  float la = 0.f, lb = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      la += s[nt][e] = fast_exp2(s[nt][e] - ma);
      lb += s[nt][2 + e] = fast_exp2(s[nt][2 + e] - mb);
    }
  }
  const float ila = 1.f / quad_sum(la), ilb = 1.f / quad_sum(lb);
  float da = 0.f, db = 0.f;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] *= ila;
      s[nt][2 + e] *= ilb;
      da += s[nt][e] * dp[nt][e];
      db += s[nt][2 + e] * dp[nt][2 + e];
    }
  }
  da = quad_sum(da);
  db = quad_sum(db);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      dp[nt][e] = s[nt][e] * (dp[nt][e] - da);  // dS
      dp[nt][2 + e] = s[nt][2 + e] * (dp[nt][2 + e] - db);
    }
  }

  float acc[8][4] = {};  // dq = dS.K
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const Split3A dsa = acc_as_a3(dp[kk]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float b0, b1;
      ldg_cols(base + hd, stride, t, 8 * kk, 8 * nt, lane, b0, b1);
      mma6(acc[nt], dsa, b0, b1);
    }
  }
  store_rows(acc, dbase, t, stride, scale, scale, lane);

  // P and dS turned over in shared memory: the A operands of P^T and dS^T
  // over the queries, in the depth order of ldg_cols (query 2t, then 2t + 1)
  float* sp = tr[warp][0];
  float* sd = tr[warp][1];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    *reinterpret_cast<float2*>(sp + gr * kTrRow + 8 * nt + c0) = make_float2(s[nt][0], s[nt][1]);
    *reinterpret_cast<float2*>(sp + (gr + 8) * kTrRow + 8 * nt + c0) = make_float2(s[nt][2], s[nt][3]);
    *reinterpret_cast<float2*>(sd + gr * kTrRow + 8 * nt + c0) = make_float2(dp[nt][0], dp[nt][1]);
    *reinterpret_cast<float2*>(sd + (gr + 8) * kTrRow + 8 * nt + c0) = make_float2(dp[nt][2], dp[nt][3]);
  }
  __syncwarp();
  float dv[8][4] = {};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;  // dk
#pragma unroll
  for (int kq = 0; kq < 2; ++kq) {
    const float* p0 = sp + (8 * kq + c0) * kTrRow + gr;
    const float* d0 = sd + (8 * kq + c0) * kTrRow + gr;
    const Split3A pa = split3_a(p0[0], p0[8], p0[kTrRow], p0[kTrRow + 8]);
    const Split3A dsa = split3_a(d0[0], d0[8], d0[kTrRow], d0[kTrRow + 8]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float b0, b1;
      ldg_cols(gbase, hd, t, 8 * kq, 8 * nt, lane, b0, b1);
      mma6(dv[nt], pa, b0, b1);
      ldg_cols(base, stride, t, 8 * kq, 8 * nt, lane, b0, b1);
      mma6(acc[nt], dsa, b0, b1);
    }
  }
  store_rows(acc, dbase + hd, t, stride, scale, scale, lane);
  store_rows(dv, dbase + 2 * hd, t, stride, 1.f, 1.f, lane);
}

}  // namespace

extern "C" {

// fp32 only. mask may be null. 1 <= T <= 257 (the wrapper sends T <= 16 to the short kernel).
int rlcf_mha_bwd_tf32x3_long(const void* qkv, const void* g, const void* mask, void* dqkv, int batch, int t,
                             int heads, float scale, void* stream) {
  if (bad_args(batch, t, heads)) return kBadArgs;
  const int row_bytes = kRow * static_cast<int>(sizeof(float));
  const int smem = ((t + 15) & ~15) * (2 * row_bytes + 12);  // two slices, three statistics a row
  static const cudaError_t attr =  // once per process: room for the longest T
      cudaFuncSetAttribute(mha_bwd_tf32x3_long, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           ((kMaxT + 15) & ~15) * (2 * row_bytes + 12));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mha_bwd_tf32x3_long<<<batch * heads, kLongWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), static_cast<const float*>(mask),
      static_cast<float*>(dqkv), t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

// fp32 only. mask may be null. 1 <= T <= 577 (the wrapper sends 258 <= T <= 577
// here). stats: scratch of B * H * 3 * 64 * ceil(T / 64) floats, written by the
// first launch and read by the second.
int rlcf_mha_bwd_tf32x3_xlong(const void* qkv, const void* g, const void* mask, void* stats, void* dqkv, int batch,
                              int t, int heads, float scale, void* stream) {
  if (bad_args(batch, t, heads, kMaxTFwd) || stats == nullptr) return kBadArgs;
  static const cudaError_t attr_rows =  // once per kernel and process
      cudaFuncSetAttribute(mha_bwd_tf32x3_xlong_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, kXlSmemRows);
  static const cudaError_t attr_keys =
      cudaFuncSetAttribute(mha_bwd_tf32x3_xlong_keys, cudaFuncAttributeMaxDynamicSharedMemorySize, kXlSmemKeys);
  if (attr_rows != cudaSuccess) return static_cast<int>(attr_rows);
  if (attr_keys != cudaSuccess) return static_cast<int>(attr_keys);
  const int nblk = (t + kXlRows - 1) / kXlRows;
  const long long ctas = static_cast<long long>(batch) * heads * nblk;
  if (ctas > 0x7fffffffLL) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(qkv);
  const float* cot = static_cast<const float*>(g);
  const float* m = static_cast<const float*>(mask);
  float* st = static_cast<float*>(stats);
  float* out = static_cast<float*>(dqkv);
  mha_bwd_tf32x3_xlong_rows<<<static_cast<unsigned>(ctas), kXlWarps * 32, kXlSmemRows, s>>>(x, cot, m, st, out, t,
                                                                                          heads, nblk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_tf32x3_xlong_keys<<<static_cast<unsigned>(ctas), kXlWarps * 32, kXlSmemKeys, s>>>(x, cot, m, st, out, t,
                                                                                          heads, nblk, scale);
  return static_cast<int>(cudaGetLastError());
}

// fp32 only. mask may be null. 1 <= T <= 16.
int rlcf_mha_bwd_tf32x6_short(const void* qkv, const void* g, const void* mask, void* dqkv, int batch, int t,
                              int heads, float scale, void* stream) {
  if (bad_args(batch, t, heads) || t > kShortT) return kBadArgs;
  const int warps = heads < kShortHeads ? heads : kShortHeads;
  const dim3 grid(batch, (heads + kShortHeads - 1) / kShortHeads);
  if (grid.y > 65535u) return kBadArgs;
  mha_bwd_tf32x6_short<<<grid, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), static_cast<const float*>(mask),
      static_cast<float*>(dqkv), t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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

// Fused multi-head attention backward from the unsplit QKV projection in
// fp32, on Hopper's tensor cores from split TF32 operands (sm_90a: mma.sync and wgmma).
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
// at T = 577, above a CTA's 227 KB, so the two phases are two launches with
// the rows' statistics passed between them in a [B * H, 3, 64 ceil(T / 64)]
// fp32 scratch (no atomics: two launches give the same bits). Every product
// is wgmma m64nNk8 in TF32, 3xTF32 in the forward's order:
//   (a) `mha_bwd_tf32x3_xlong_rows`: CTA = (sequence, head, 128 query rows).
//       Sweep 1 over the keys: S = Q.K^T, dP = G.V^T, the statistics
//       online; sweep 2: S and dP again, dS, dq += dS.K.
//   (b) `mha_bwd_tf32x3_xlong_keys`: CTA = (sequence, head, 128 keys). Over
//       the queries: S^T = K.Q^T, dP^T = V.G^T, P^T and dS^T from the
//       statistics, dv += P^T.G, dk += dS^T.Q.
// What bounds it: 9 products of T^2 x 64 at 3 TF32 passes (the bound counts
// 5: 0.1240 ms at B=6 T=577 H=16 on an H100), and, more, the work between
// them. A first design on mma.sync had every warp read and split its own B
// fragments (1.1068 ms there on an H100 80GB HBM3 at 700 W). Here the other
// two slices stream past in chunks of 32 rows (cp.async into padded raw
// rows) and are split once per CTA into hi / lo copies with the 128-byte
// swizzle that wgmma reads: TF32 wgmma reads B, and A from shared memory,
// K-major only, so the rows layout serves S and dP and the chunk turned over
// (the columns layout, as the forward's V) serves dq (over keys), dv and dk
// (over queries). Each fetch by the tensor cores then serves 64 rows.
// Measured on the card, in that order (clock64 stamps at the phase edges):
// cvt.rna.tf32.f32 issues at a quarter rate, and the splits were bound by
// it: they round by integer operations instead (add 0x1000, clear the 13 low
// bits; tf32_rna_int), the same bits at full rate. The TF32 wgmma themselves run at 340-480
// TFLOP/s in isolation (N = 32 and 64, one or two warpgroups an SM, A from
// registers; A from shared memory at N = 32 reads 3 KB for 32 KFLOP and is
// held to 2/3 of that), and chains on one accumulator cost nothing; but a
// warpgroup that issues a batch of wgmma stalls until the tensor cores have
// taken most of it, so the split of the next chunk, written after the issue,
// barely overlaps it. So:
//   (a) two consumer warpgroups of 64 rows (a warp owns 16) and a producer
//       warpgroup: the producer loads each key chunk and splits it into one
//       of two buffers, handed over and released on full / empty mbarriers,
//       while the consumers multiply. Three warpgroups leave a thread 168
//       registers (an SM sub-partition's 16K for three warps): Q stays split
//       in registers as the A operand of S, G is split once into shared memory
//       as the A operand of dP (164 registers, no spills);
//   (b) two warpgroups of 64 keys that split the chunks themselves into two
//       buffers: chunk c + 1 is split while S^T and dP^T of chunk c run. K is
//       split in registers (A of S^T), V in shared memory (A of dP^T); dk, dv,
//       and the split P^T and dS^T take the rest of 234 registers, more than a
//       third warpgroup would leave.
// Tried and dropped (same card; PERF.md has the times): the cross terms of
// S^T and dP^T in accumulators of their own (no change: the chains on one
// accumulator were not the limit); (a) as one warpgroup a CTA,
// two CTAs an SM, splitting its own chunks (slower); a producer in (b) (at
// 168 registers it spills, and setmaxnreg did not lift ptxas's budget); one
// consumer warpgroup a CTA; the consumers issuing in turn on named barriers.
// Shared memory: (a) both warpgroups' G hi / lo 64 KB, two buffers of K and V
// rows and K columns copies hi / lo 96 KB, two raw slices 17 KB, four
// mbarriers, 1 KB to align: 182,304 bytes; (b) V 64 KB, two buffers of Q and G
// rows and columns copies 128 KB, raw 17 KB, every row's statistics 7.5 KB,
// 1 KB: 222,720 bytes. One CTA an SM.
// Filling the card (T = 577, H = 16): ceil(577 / 128) = 5 CTAs a head and
// launch, 480 at B=6 (3.6 rounds of the 132 SMs) and 1920 at B=24 (14.5).
// The ragged edges: rows >= T of a chunk are zero-filled and never read from
// device memory, key columns >= T get probability 0 in (a), queries >= T
// probability 0 in (b), own rows >= T read as 0 and are not stored.
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

// ---- the longest regime (258 <= T <= 577): two launches on wgmma (see the
// head note)

constexpr int kXrThreads = 384;                          // launch (a): two consumer warpgroups and a producer
constexpr int kXkThreads = 256;                          // launch (b): two warpgroups
constexpr int kXlConsumers = 256;
constexpr int kXlRows = 128;                             // a CTA's own rows, 64 a (consumer) warpgroup
constexpr int kXlChunk = 32;                             // rows of a streamed chunk
constexpr int kXlCopy = kXlChunk * kD * 4;               // a hi or lo copy of a chunk: 8 KB in either layout
constexpr int kXlRaw = kXlChunk * kRow * 4;              // one slice's chunk as it arrives (padded rows)
constexpr int kXlOwn = 2 * 2 * kSwCopy;                  // both warpgroups' G (a) or V (b), hi and lo: 64 KB
constexpr int kXlStatRows = (kMaxTFwd + 63) / 64 * 64;   // 640
constexpr int kXlBars = 4 * 8;                           // full and empty mbarriers of the two buffers
// (a): two buffers of K and V rows and K columns copies; (b): V, two buffers of Q and G rows and columns copies
constexpr int kXlSmemRows = kXlOwn + 2 * 6 * kXlCopy + 2 * kXlRaw + kXlBars + 1024;
constexpr int kXlSmemKeys = kXlOwn + 2 * 8 * kXlCopy + 2 * kXlRaw + 3 * kXlStatRows * 4 + 1024;
static_assert(kXlSmemKeys <= 232448, "a CTA's shared memory");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// the thread's warpgroup, uniform over the warp to the compiler
__device__ __forceinline__ int warpgroup() { return __shfl_sync(kFull, static_cast<int>(threadIdx.x) >> 7, 0); }

// Launch (a): CTA = (sequence, head, 128 query rows): two consumer warpgroups
// of 64 rows, a warp owning 16 with Q as split A operands in registers and G
// split once into shared memory, and a producer warpgroup that loads and
// splits the key chunks. Iteration j
// takes key chunk j mod nc: sweep 1 (j < nc) S and dP, the rows' statistics
// online (max across the quad, sum and rowsum(dp * P) rescaled with it),
// which go to `stats` [B * H, 3, 64 ceil(T / 64)] for launch (b); sweep 2 S
// and dP again, dS = P (dP - D) in fp32, dq += dS.K with dS from the
// accumulators.
__global__ void __launch_bounds__(kXrThreads, 1)
mha_bwd_tf32x3_xlong_rows(const float* __restrict__ qkv, const float* __restrict__ g, const float* __restrict__ mask,
                          float* __restrict__ stats, float* __restrict__ dqkv, int t, int heads, int nqb,
                          float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);  // both warpgroups' G hi, lo
  // two buffers of: K rows hi, lo; V rows hi, lo; K columns hi, lo
  unsigned char* chunk = smem + kXlOwn;
  float* raw = reinterpret_cast<float*>(chunk + 12 * kXlCopy);  // the next chunk's K, then V
  const uint32_t bars = smem_u32(raw + 2 * kXlChunk * kRow);    // full[2], empty[2]
  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.x / nqb, b = bh / heads, h = bh % heads;
  const int hd = heads * kD, nc = (t + kXlChunk - 1) / kXlChunk;
  const size_t stride = 3 * static_cast<size_t>(hd);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  const int cta0 = (blockIdx.x % nqb) * kXlRows;
  if (tid == 0) {
    mbar_init(bars, 128);
    mbar_init(bars + 8, 128);
    mbar_init(bars + 16, kXlConsumers);
    mbar_init(bars + 24, kXlConsumers);
  }
  for (int w = 0; w < 2; ++w) {  // both warpgroups' G, split once
    const int r0 = cta0 + 64 * w;
    split_sw_rows_global(smem + w * 2 * kSwCopy, smem + (w * 2 + 1) * kSwCopy,
                         g + (static_cast<size_t>(b) * t + r0) * hd + h * kD, t - r0, hd, tid, kXrThreads);
  }
  fence_async_proxy();
  __syncthreads();

  // The producer: iteration i's chunk arrives in raw by cp.async, is split
  // into buffer i & 1 once the consumers have released that buffer's use two
  // iterations back, and is handed over on the buffer's `full` mbarrier; the
  // load of iteration i + 1 starts as soon as raw has been read.
  if (warpgroup() == 2) {
    const int ptid = tid - kXlConsumers;
    auto stage = [&](int i) {
      const int k0 = kXlChunk * (i % nc);
      stage_f32(raw, base + hd + k0 * stride, kXlChunk, t - k0, stride, ptid, 128);
      stage_f32(raw + kXlChunk * kRow, base + 2 * hd + k0 * stride, kXlChunk, t - k0, stride, ptid, 128);
      cp_async_commit();
    };
    stage(0);
    for (int i = 0; i < 2 * nc; ++i) {
      const int b = i & 1;
      unsigned char* buf = chunk + b * 6 * kXlCopy;
      if (i >= 2) mbar_wait(bars + 8 * (2 + b), ((i >> 1) - 1) & 1);  // the consumers are done with use i - 2
      cp_async_wait<0>();
      producer_sync();  // every producer thread's part of the chunk has arrived
      split_sw_rows<kXlChunk, true>(buf, buf + kXlCopy, raw, ptid, 128);
      split_sw_rows<kXlChunk, true>(buf + 2 * kXlCopy, buf + 3 * kXlCopy, raw + kXlChunk * kRow, ptid, 128);
      if (i >= nc) split_sw_cols<kXlChunk, true>(buf + 4 * kXlCopy, buf + 5 * kXlCopy, raw, ptid, 128);
      fence_async_proxy();  // the copies' generic-proxy writes, visible to wgmma
      producer_sync();      // raw has been read
      if (i + 1 < 2 * nc) stage(i + 1);
      mbar_arrive(bars + 8 * b);
    }
    return;
  }
  const int wg = tid >> 7, row0 = cta0 + 16 * (tid >> 5);  // the warp's rows
  const float sc = scale * kLog2e;
  const int gr = lane >> 2, c0 = 2 * (lane & 3);
  SplitA qa[8];  // rows >= T read as 0
  load_rows_a(qa, base + static_cast<size_t>(row0) * stride, t - row0, stride, lane);
  const SmemA ga{smem_u32(smem + wg * 2 * kSwCopy), smem_u32(smem + wg * 2 * kSwCopy) + kSwCopy};

  constexpr int kHalf = kXlChunk * kRowBytes;  // the halves of a chunk's rows copies
  // S = Q.K^T and dP = G.V^T of iteration j, once the producer has handed its buffer over
  float s[4][4], dp[4][4];
  auto scores = [&](int j) {
    const uint32_t krh = smem_u32(chunk + (j & 1) * 6 * kXlCopy), krl = krh + kXlCopy, vrh = krl + kXlCopy,
                   vrl = vrh + kXlCopy;
    mbar_wait(bars + 8 * (j & 1), (j >> 1) & 1);
    wgmma_fence();
    wgmma3_pair<kXlChunk, 8>(&s[0][0], qa, krh, krl, &dp[0][0], ga, vrh, vrl, kHalf);
    wgmma_commit();
    wgmma_wait();
  };
  auto release = [&](int j) { mbar_arrive(bars + 8 * (2 + (j & 1))); };

  // sweep 1: the statistics of rows gr and gr + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  for (int j = 0; j < nc; ++j) {
    scores(j);
    release(j);
    const int k0 = kXlChunk * j;
    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      scores_to_log2(s[nt], mask, t, row0 + gr, k0 + 8 * nt + c0, sc);
      bm[0] = fmaxf(bm[0], fmaxf(s[nt][0], s[nt][1]));
      bm[1] = fmaxf(bm[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // key 0 is in the first chunk: the running max is finite from there on
      const float nm = fmaxf(m[r], quad_max(bm[r]));
      const float alpha = fast_exp2(m[r] - nm);
      m[r] = nm;
      l[r] *= alpha;
      dd[r] *= alpha;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pa = fast_exp2(s[nt][e] - m[0]), pb = fast_exp2(s[nt][2 + e] - m[1]);
        l[0] += pa;
        l[1] += pb;
        dd[0] += pa * dp[nt][e];
        dd[1] += pb * dp[nt][2 + e];
      }
    }
  }
  const float il[2] = {1.f / quad_sum(l[0]), 1.f / quad_sum(l[1])};
  const float dstat[2] = {quad_sum(dd[0]) * il[0], quad_sum(dd[1]) * il[1]};
  if ((lane & 3) == 0) {
    const int n64 = (t + 63) / 64 * 64;
    float* st = stats + static_cast<size_t>(bh) * 3 * n64;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + gr + 8 * r;
      if (row < t) {
        st[row] = m[r];
        st[n64 + row] = il[r];
        st[2 * n64 + row] = dstat[r];
      }
    }
  }

  // sweep 2: dS and dq (the chunks' products chained in the accumulators)
  float dq[8][4] = {};
  for (int j = nc; j < 2 * nc; ++j) {
    scores(j);
    const int k0 = kXlChunk * (j - nc);
    SplitA dsa[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      scores_to_log2(s[nt], mask, t, row0 + gr, k0 + 8 * nt + c0, sc);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = fast_exp2(s[nt][e] - m[0]) * il[0] * (dp[nt][e] - dstat[0]);
        s[nt][2 + e] = fast_exp2(s[nt][2 + e] - m[1]) * il[1] * (dp[nt][2 + e] - dstat[1]);
      }
      dsa[nt] = acc_as_a<true>(s[nt]);
    }
    const uint32_t kch = smem_u32(chunk + (j & 1) * 6 * kXlCopy + 4 * kXlCopy), kcl = kch + kXlCopy;
    wgmma_fence();
    wgmma3<64, 4>(&dq[0][0], dsa, kch, kcl, true);  // dq += dS.K
    wgmma_commit();
    wgmma_wait();
    release(j);
  }
  if (row0 < t) {
    store_rows(dq, dqkv + (static_cast<size_t>(b) * t + row0) * stride + h * kD, t - row0, stride, scale, scale,
               lane);
  }
}

// Launch (b): CTA = (sequence, head, 128 keys), two warpgroups of 64 keys; a
// warp owns 16 with K as split A operands in registers, V split once into
// hi / lo copies in shared memory (the A operand of dP^T). Over the query
// chunks: S^T = K.Q^T and dP^T = V.G^T, P^T and dS^T from launch (a)'s
// statistics (queries >= T give P = 0), dv += P^T.G and dk += dS^T.Q with
// P^T and dS^T from the accumulators. While S^T and dP^T of chunk c run, the
// CTA splits chunk c + 1 into the other buffer of copies and starts loading
// chunk c + 2. Two launches give the same bits.
__global__ void __launch_bounds__(kXkThreads, 1)
mha_bwd_tf32x3_xlong_keys(const float* __restrict__ qkv, const float* __restrict__ g, const float* __restrict__ mask,
                          const float* __restrict__ stats, float* __restrict__ dqkv, int t, int heads, int nkb,
                          float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);  // both warpgroups' V hi, lo
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int bh = blockIdx.x / nkb, b = bh / heads, h = bh % heads;
  const int cta0 = (blockIdx.x % nkb) * kXlRows, key0 = cta0 + 64 * wg + 16 * ((tid >> 5) & 3);  // the warp's keys
  const int hd = heads * kD, nc = (t + kXlChunk - 1) / kXlChunk, n64 = (t + 63) / 64 * 64;
  const size_t stride = 3 * static_cast<size_t>(hd);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  const float* gbase = g + static_cast<size_t>(b) * t * hd + h * kD;
  // two buffers of: Q rows hi, lo; G rows hi, lo; Q columns hi, lo; G columns hi, lo
  unsigned char* chunk = smem + kXlOwn;
  float* raw = reinterpret_cast<float*>(chunk + 16 * kXlCopy);  // the next chunk's Q, then G
  float* st_m = raw + 2 * kXlChunk * kRow;
  float* st_il = st_m + kXlStatRows;
  float* st_d = st_il + kXlStatRows;
  const float sc = scale * kLog2e;
  const int gr = lane >> 2, c0 = 2 * (lane & 3);

  auto stage = [&](int c) {
    const int q0 = kXlChunk * c;
    stage_f32(raw, base + q0 * stride, kXlChunk, t - q0, stride, tid, kXkThreads);
    stage_f32(raw + kXlChunk * kRow, gbase + static_cast<size_t>(q0) * hd, kXlChunk, t - q0, hd, tid, kXkThreads);
    cp_async_commit();
  };
  // chunk c, which has arrived in raw, into buffer c & 1 (every warp is past
  // the products of chunk c - 2, which read it); then the load of chunk c + 1
  auto prepare = [&](int c) {
    unsigned char* buf = chunk + (c & 1) * 8 * kXlCopy;
    const float* graw = raw + kXlChunk * kRow;
    cp_async_wait<0>();
    __syncthreads();
    split_sw_rows<kXlChunk, true>(buf, buf + kXlCopy, raw, tid, kXkThreads);
    split_sw_rows<kXlChunk, true>(buf + 2 * kXlCopy, buf + 3 * kXlCopy, graw, tid, kXkThreads);
    split_sw_cols<kXlChunk, true>(buf + 4 * kXlCopy, buf + 5 * kXlCopy, raw, tid, kXkThreads);
    split_sw_cols<kXlChunk, true>(buf + 6 * kXlCopy, buf + 7 * kXlCopy, graw, tid, kXkThreads);
    fence_async_proxy();  // the copies' generic-proxy writes, visible to wgmma
    __syncthreads();      // raw is free
    if (c + 1 < nc) stage(c + 1);
  };

  const float* src = stats + static_cast<size_t>(bh) * 3 * n64;
  for (int i = tid; i < 3 * n64; i += kXkThreads) {
    const int row = i % n64;
    st_m[(i / n64) * kXlStatRows + row] = row < t ? src[i] : 0.f;
  }
  stage(0);
  for (int w = 0; w < 2; ++w) {  // both warpgroups' V, split once
    const int r0 = cta0 + 64 * w;
    split_sw_rows_global(smem + w * 2 * kSwCopy, smem + (w * 2 + 1) * kSwCopy,
                         base + 2 * hd + static_cast<size_t>(r0) * stride, t - r0, stride, tid, kXkThreads);
  }
  SplitA ka[8];  // keys >= T read as 0
  load_rows_a(ka, base + hd + static_cast<size_t>(key0) * stride, t - key0, stride, lane);
  prepare(0);

  const uint32_t vh = smem_u32(smem + wg * 2 * kSwCopy), vl = vh + kSwCopy;
  constexpr int kHalf = kXlChunk * kRowBytes;
  float dk[8][4] = {}, dv[8][4] = {};
  for (int c = 0; c < nc; ++c) {
    const uint32_t qrh = smem_u32(chunk + (c & 1) * 8 * kXlCopy), qrl = qrh + kXlCopy, grh = qrl + kXlCopy,
                   grl = grh + kXlCopy, qch = grl + kXlCopy, qcl = qch + kXlCopy, gch = qcl + kXlCopy,
                   gcl = gch + kXlCopy;
    float s[4][4], dpt[4][4];  // S^T and dP^T: rows key0 + gr (+ 8), columns the chunk's queries
    wgmma_fence();  // S^T = K.Q^T, dP^T = V.G^T
    wgmma3_pair<kXlChunk, 8>(&s[0][0], ka, qrh, qrl, &dpt[0][0], SmemA{vh, vl}, grh, grl, kHalf);
    wgmma_commit();
    if (c + 1 < nc) prepare(c + 1);
    wgmma_wait();
    const int q0 = kXlChunk * c;
    SplitA pa[4], dsa[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + 8 * nt + c0 + (e & 1), key = key0 + gr + 8 * (e >> 1);
        const float mv = mask != nullptr && q < t && key < t ? __ldg(mask + static_cast<size_t>(q) * t + key) : 0.f;
        const float p = q < t ? fast_exp2(fmaf(mv, kLog2e, s[nt][e] * sc) - st_m[q]) * st_il[q] : 0.f;
        s[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - st_d[q]);
      }
      pa[nt] = acc_as_a<true>(s[nt]);
      dsa[nt] = acc_as_a<true>(dpt[nt]);
    }
    wgmma_fence();  // dv += P^T.G, dk += dS^T.Q
    wgmma3_pair<64, 4>(&dv[0][0], pa, gch, gcl, &dk[0][0], dsa, qch, qcl, kSwHalf, true);
    wgmma_commit();
    wgmma_wait();
  }
  if (key0 < t) {
    float* dbase = dqkv + (static_cast<size_t>(b) * t + key0) * stride + h * kD;
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
  mha_bwd_tf32x3_xlong_rows<<<static_cast<unsigned>(ctas), kXrThreads, kXlSmemRows, s>>>(x, cot, m, st, out, t,
                                                                                       heads, nblk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_bwd_tf32x3_xlong_keys<<<static_cast<unsigned>(ctas), kXkThreads, kXlSmemKeys, s>>>(x, cot, m, st, out, t,
                                                                                       heads, nblk, scale);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the xlong launches, (a) the rows' (keys = 0) and
// (b) the keys' (keys = 1): for the wrapper's sizing to be held to.
int rlcf_mha_bwd_tf32x3_xlong_smem(int keys) { return keys ? kXlSmemKeys : kXlSmemRows; }

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

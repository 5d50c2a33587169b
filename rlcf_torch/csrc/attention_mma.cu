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
// first tower of the reward ensemble and of zero-shot, encoder TTA of it; U1 at
// T = 384 and 512): a warp's whole score rows would take 296 fp32 registers a
// thread, and an online softmax would round the unnormalised P, another
// function. What bounds it on this card: one exp2 a score (128 M at the
// ensemble's B=24 H=16: ~35 us of the SMs' exp2 units) and two products (33
// GFLOP: ~35 us of tensor cores), in steps that depend on each other with one
// CTA of 8 warps an SM. Per block of 64 query rows (clock64 stamps, H100 80GB
// HBM3 at 700 W, PERF.md §6): issuing Q.K^T ~1600 cycles (the warps stall
// on the tensor cores' queue), the exp2 and sums ~4200 (the exp2 units' floor
// is ~2400), the row statistics' exchange ~750, P.V ~1800, the output ~500.
// The design (`mha_fwd_mma_xlong`):
//   * one sweep over the keys: a CTA's two warpgroups take the same 64 query
//     rows and each half the key blocks (19 + 19 at T = 577), so that a thread
//     keeps its part of the score rows in registers (152 fp32; 254 registers).
//     S = Q.K^T is issued 64 keys at a time, one commit group each, and each
//     chunk's max, exp2 and sum start as soon as its products are in
//     (e = 2^(v - m_c) against the thread's running max m_c at that chunk).
//     The two warps that hold the same rows exchange their row max and sum in
//     shared memory behind a named barrier of their own; P = e 2^(m_c - m) / l
//     is normalised, then rounded to bf16, and P.V runs in two halves (the
//     second half's P formed while the first half's products run). Two
//     products and one exp2 a score, where two sweeps took three and two. The
//     two partial P.V meet in shared memory, handed over from one warp to the
//     other on a second named barrier, and are added in one order, o0 + o1: no
//     atomics, repeats give the same bits. Tried and slower: three warpgroups
//     of 13 blocks (168 registers a thread spilled), each chunk's products
//     issued just before the chunk before it is worked on (the issue stalls in
//     the exp2 work), the warpgroups issuing in turn (the exp2 units are
//     shared: the wait adds, nothing overlaps);
//   * a CTA loads the head's whole K and V once (156 KB at T = 577: one CTA an
//     SM) by cp.async, each chunk of 64 keys of both warpgroups counted by its
//     own mbarrier, so that the first products start on the first chunk, and
//     takes several consecutive blocks of 64 query rows of the head (as many as
//     make the fewest rounds of CTAs over the SMs: the whole head at B=24, two
//     blocks at B=1), each block's Q loaded while the block before runs. Rows
//     past T read row T - 1: finite values that get weight 0 (key columns >= T
//     get -inf) or are not stored (query rows), so no tile row is written by a
//     plain store that the tensor cores would have to be fenced against;
//   * the ragged edge: T = 64 n + (1 to 16) (577 = 9 * 64 + 1) ends in a block
//     of at most 16 query rows that a 64-row wgmma would pay for in full; the
//     CTA's 8 warps take it on mma.sync, each a fifth of the key blocks with no
//     branch between them, their rows' max and sum and their partial P.V summed
//     in shared memory in the order of the warps (~4600 cycles, half a block).
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

// ---- the longer regime (258 <= T <= 577): one sweep, the keys split between two warpgroups

constexpr int kXlThreads = 256;      // two warpgroups on the same 64 query rows, each with its own key blocks
constexpr int kXlWarps = 8;
constexpr int kXlTailBlocks = 5;     // key blocks of 16 a warp takes in a tail block (8 warps, up to 40 blocks)
constexpr int kXlPartStride = 72;    // floats a row of a warp's partial P.V rows (64, padded against bank conflicts)
constexpr int kXlExchange = 8192;    // floats: four warps' partial rows, or eight 16 x 64 tail partials
constexpr int kXlStats = 512;        // floats: two blocks' row max and sum, [block & 1][wg][max | sum][64 rows]
constexpr int kXlBars = 8;           // mbarriers: up to 5 steps of K, V, two Q buffers
constexpr int kXlVBar = 5, kXlQBar = 6;

// K and V (2 KBW blocks of 16 rows each) | two Q buffers of 64 rows | the exchange | row statistics | the
// mbarriers | room to align to 1024 bytes
constexpr int xl_smem_bytes(int kbw) {
  return 2 * (2 * kbw) * kTileBytes + 2 * 4 * kTileBytes + kXlExchange * 4 + kXlStats * 4 + kXlBars * 8 + 1024;
}

// until at most n (0..4) committed groups are in flight; n a constant once the caller's loop is unrolled
__device__ __forceinline__ void wgmma_wait_upto(int n) {
  switch (n) {
    case 0: asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); break;
    case 1: asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); break;
    case 2: asm volatile("wgmma.wait_group.sync.aligned 2;\n" ::: "memory"); break;
    case 3: asm volatile("wgmma.wait_group.sync.aligned 3;\n" ::: "memory"); break;
    default: asm volatile("wgmma.wait_group.sync.aligned 4;\n" ::: "memory"); break;
  }
}

// pins accumulators behind the wait above: the compiler may not move their use before it
__device__ __forceinline__ void fence_regs(float* x, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Warp w of one warpgroup and warp w of the other, which hold the same 16 query rows, meet on named
// barriers of their own: 1 + w where both wait (the rows' statistics), 5 + w where one hands its partial
// P.V over and the other waits. Each barrier's uses alternate between the same two warps in one order.
constexpr int kXlStatsBar = 1, kXlPartBar = 5;
__device__ __forceinline__ void pair_sync(int id) { asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void pair_arrive(int id) { asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory"); }

// S = Q.K^T for chunk `ch` of the warpgroup's key blocks (4 blocks of 16, or the last chunk's `nb`), once
// its keys are in: one commit group
template <int KBW>
__device__ __forceinline__ void xl_issue(float (&s)[KBW][2][4], const uint32_t (&qa)[4][4], uint32_t kaddr,
                                         uint32_t kbar, int ch, int nb) {
  mbar_wait(kbar, 0);  // at once after the CTA's first block
  fence_async_proxy();
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (nb == 4) {
      wgmma_n64<0>(&s[4 * ch][0][0], qa[k], wgmma_desc(kaddr + 4 * ch * kTileBytes + k * 32), k > 0);
    } else {
#pragma unroll
      for (int j = 0; j < nb; ++j) {
        wgmma_n16(&s[4 * ch + j][0][0], qa[k], wgmma_desc(kaddr + (4 * ch + j) * kTileBytes + k * 32), k > 0);
      }
    }
  }
  wgmma_commit();
}

// One block of 64 query rows (`qa`: this warp's 16 rows) against all keys: the warpgroup's KBW key blocks
// from `kb0` (at `kaddr`, `vaddr`), its partial O = P.V left in `o` (for rows row0 + 16 w ..). S = Q.K^T is
// issued chunk by chunk (64 keys, one commit group each) and each chunk's max, exp2 and sum start once its
// products are in: e = 2^(v - m_c) with m_c the thread's running max at chunk c, and l = sum 2^(v - m) kept
// online. After the two warps of the rows meet in `rst`, P = e 2^(m_c - m) / l: normalised, then rounded to
// bf16.
template <int KBW, bool MASKED>
__device__ __forceinline__ void xl_rows(float (&o)[8][4], const uint32_t (&qa)[4][4], uint32_t kaddr, uint32_t vaddr,
                                        uint32_t kbars, uint32_t vbar, const float* __restrict__ mask, float* rst,
                                        int t, int nkb, int kb0, int row0, int wg, int w, float c, int lane) {
  constexpr int NC = (KBW + 3) / 4;  // chunks of up to 4 blocks of 16 keys
  float s[KBW][2][4];
  constexpr int kLast = KBW - 4 * (NC - 1);
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) xl_issue<KBW>(s, qa, kaddr, kbars + 8 * ch, ch, ch < NC - 1 ? 4 : kLast);
  const int ra = row0 + w * 16 + (lane >> 2), rb = ra + 8;
  float mrun[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mc[NC][2];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int nb = ch < NC - 1 ? 4 : kLast;
    wgmma_wait_upto(NC - 1 - ch);
    fence_regs(&s[4 * ch][0][0], 8 * nb);
    const int kbc = kb0 + 4 * ch;  // the chunk's first key block
    // fast: no mask and no key column >= t in the chunk (uniform over the warpgroup)
    const bool fast = !MASKED && 16 * (kbc + nb) <= t;
    float cm[2] = {-INFINITY, -INFINITY};
    if (fast) {
#pragma unroll
      for (int j = 0; j < nb; ++j) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          cm[0] = fmaxf(cm[0], fmaxf(s[4 * ch + j][nt][0], s[4 * ch + j][nt][1]));
          cm[1] = fmaxf(cm[1], fmaxf(s[4 * ch + j][nt][2], s[4 * ch + j][nt][3]));
        }
      }
      cm[0] *= c;
      cm[1] *= c;
    } else {
#pragma unroll
      for (int j = 0; j < nb; ++j) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 16 * (kbc + j) + 8 * nt + 2 * (lane & 3) + e;
            float xa = 0.f, xb = 0.f;
            if (MASKED && col < t) {
              if (ra < t) xa = __ldg(mask + static_cast<size_t>(ra) * t + col);
              if (rb < t) xb = __ldg(mask + static_cast<size_t>(rb) * t + col);
            }
            float& va = s[4 * ch + j][nt][e];
            float& vb = s[4 * ch + j][nt][2 + e];
            va = col < t ? fmaf(xa, kLog2e, va * c) : -INFINITY;
            vb = col < t ? fmaf(xb, kLog2e, vb * c) : -INFINITY;
            cm[0] = fmaxf(cm[0], va);
            cm[1] = fmaxf(cm[1], vb);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // every thread has a key < t in its first chunk, so m is finite from there on
      const float nm = fmaxf(mrun[r], cm[r]);
      l[r] *= fast_exp2(mrun[r] - nm);
      mrun[r] = mc[ch][r] = nm;
    }
#pragma unroll
    for (int j = 0; j < nb; ++j) {
      if (kbc + j < nkb) {  // uniform: a block past the keys has e = 0
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[4 * ch + j][nt][e];
            x = fast_exp2(fast ? fmaf(x, c, -mrun[e >> 1]) : x - mrun[e >> 1]);
            l[e >> 1] += x;
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) s[4 * ch + j][nt][0] = s[4 * ch + j][nt][1] = s[4 * ch + j][nt][2] =
            s[4 * ch + j][nt][3] = 0.f;
      }
    }
  }

  // the rows' max and sum: the quad's threads, then the two warps of the rows through `rst`
  // ([wg][max | sum][64 rows], this block's half)
  const int la = w * 16 + (lane >> 2), lb = la + 8;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mq = quad_max(mrun[r]);
    l[r] = quad_sum(l[r] * fast_exp2(mrun[r] - mq));
    mrun[r] = mq;
  }
  if ((lane & 3) == 0) {
    rst[wg * 128 + la] = mrun[0];
    rst[wg * 128 + 64 + la] = l[0];
    rst[wg * 128 + lb] = mrun[1];
    rst[wg * 128 + 64 + lb] = l[1];
  }
  pair_sync(kXlStatsBar + w);
  float f[NC][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? lb : la;
    const float m0 = rst[row], l0 = rst[64 + row], m1 = rst[128 + row], l1 = rst[192 + row];
    const float m = fmaxf(m0, m1);  // the same operations in both warpgroups: the same bits
    const float inv = fast_rcp(fmaf(l1, fast_exp2(m1 - m), l0 * fast_exp2(m0 - m)));
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) f[ch][r] = fast_exp2(mc[ch][r] - m) * inv;
  }

  // P.V in two halves: the second half's P is formed while the first half's products run
  uint32_t p[KBW][4];
  mbar_wait(vbar, 0);
  fence_async_proxy();
  constexpr int kHalf = KBW / 2;
#pragma unroll
  for (int kb = 0; kb < kHalf; ++kb) {
    const float fa = f[kb / 4][0], fb = f[kb / 4][1];
    p[kb][0] = pack_bf16(s[kb][0][0] * fa, s[kb][0][1] * fa);
    p[kb][1] = pack_bf16(s[kb][0][2] * fb, s[kb][0][3] * fb);
    p[kb][2] = pack_bf16(s[kb][1][0] * fa, s[kb][1][1] * fa);
    p[kb][3] = pack_bf16(s[kb][1][2] * fb, s[kb][1][3] * fb);
  }
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < kHalf; ++kb) wgmma_n64<1>(&o[0][0], p[kb], wgmma_desc(vaddr + kb * kTileBytes), kb > 0);
  wgmma_commit();
#pragma unroll
  for (int kb = kHalf; kb < KBW; ++kb) {
    const float fa = f[kb / 4][0], fb = f[kb / 4][1];
    p[kb][0] = pack_bf16(s[kb][0][0] * fa, s[kb][0][1] * fa);
    p[kb][1] = pack_bf16(s[kb][0][2] * fb, s[kb][0][3] * fb);
    p[kb][2] = pack_bf16(s[kb][1][0] * fa, s[kb][1][1] * fa);
    p[kb][3] = pack_bf16(s[kb][1][2] * fb, s[kb][1][3] * fb);
  }
  wgmma_fence();
#pragma unroll
  for (int kb = kHalf; kb < KBW; ++kb) wgmma_n64<1>(&o[0][0], p[kb], wgmma_desc(vaddr + kb * kTileBytes), 1);
  wgmma_commit();
  wgmma_wait();
}

// A block of at most 16 query rows (T = 64 n + 1 .. 16: at T = 577 one row), which a block of 64 on wgmma
// would pay for in full: the CTA's 8 warps on mma.sync, warp W with the key blocks W, W + 8, .. (at most
// 5; a block past the keys reads the last one and gives it weight 0, so that no branch separates the
// blocks' products). Each warp's rows' max and sum meet in `rst` ([warp][max | sum][16]), its partial P.V
// in `xch` (16 x 64 a warp); the partials are summed in the order of the warps.
template <bool MASKED>
__device__ __forceinline__ void xl_tail(const uint32_t (&qa)[4][4], uint32_t kaddr, uint32_t vaddr,
                                        const float* __restrict__ mask, float* rst, float* xch, bf16* __restrict__ orow,
                                        int t, int nkb, int row0, int hd, float c, int warp, int lane) {
  const int la = lane >> 2, ra = row0 + la, rb = ra + 8;
  float s[kXlTailBlocks][2][4];
  __syncthreads();  // every warp is done with the whole blocks' statistics and partials
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kXlTailBlocks; ++j) {
    const int kb = warp + kXlWarps * j;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[j][nt][0] = s[j][nt][1] = s[j][nt][2] = s[j][nt][3] = 0.f;
    mma_scores(s[j], qa, kaddr + min(kb, nkb - 1) * kTileBytes, lane);
  }
#pragma unroll
  for (int j = 0; j < kXlTailBlocks; ++j) {
    const int kb = warp + kXlWarps * j;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 16 * kb + 8 * nt + 2 * (lane & 3) + e;
        float xa = 0.f, xb = 0.f;
        if (MASKED && col < t) {
          if (ra < t) xa = __ldg(mask + static_cast<size_t>(ra) * t + col);
          if (rb < t) xb = __ldg(mask + static_cast<size_t>(rb) * t + col);
        }
        s[j][nt][e] = col < t ? fmaf(xa, kLog2e, s[j][nt][e] * c) : -INFINITY;
        s[j][nt][2 + e] = col < t ? fmaf(xb, kLog2e, s[j][nt][2 + e] * c) : -INFINITY;
        m[0] = fmaxf(m[0], s[j][nt][e]);
        m[1] = fmaxf(m[1], s[j][nt][2 + e]);
      }
    }
  }
  float l[2] = {0.f, 0.f};
  m[0] = quad_max(m[0]);  // finite: key block `warp` < 8 holds keys < t
  m[1] = quad_max(m[1]);
#pragma unroll
  for (int j = 0; j < kXlTailBlocks; ++j) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += s[j][nt][e] = fast_exp2(s[j][nt][e] - m[e >> 1]);
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  if ((lane & 3) == 0) {
    rst[warp * 32 + la] = m[0];
    rst[warp * 32 + 16 + la] = l[0];
    rst[warp * 32 + la + 8] = m[1];
    rst[warp * 32 + 16 + la + 8] = l[1];
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = la + 8 * r;
    float mx = -INFINITY, sum = 0.f;
#pragma unroll
    for (int x = 0; x < kXlWarps; ++x) mx = fmaxf(mx, rst[x * 32 + row]);
#pragma unroll
    for (int x = 0; x < kXlWarps; ++x) sum = fmaf(rst[x * 32 + 16 + row], fast_exp2(rst[x * 32 + row] - mx), sum);
    f[r] = fast_exp2(m[r] - mx) * fast_rcp(sum);
  }
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int j = 0; j < kXlTailBlocks; ++j) {
    const int kb = warp + kXlWarps * j;
    uint32_t p[4];
    p[0] = pack_bf16(s[j][0][0] * f[0], s[j][0][1] * f[0]);
    p[1] = pack_bf16(s[j][0][2] * f[1], s[j][0][3] * f[1]);
    p[2] = pack_bf16(s[j][1][0] * f[0], s[j][1][1] * f[0]);
    p[3] = pack_bf16(s[j][1][2] * f[1], s[j][1][3] * f[1]);
    mma_rows(o, p, vaddr + min(kb, nkb - 1) * kTileBytes, lane);
  }
  float* part = xch + warp * 1024;
  const int tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(part + la * 64 + 8 * nt + 2 * tq) = make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(part + (la + 8) * 64 + 8 * nt + 2 * tq) = make_float2(o[nt][2], o[nt][3]);
  }
  __syncthreads();
  const int tid = warp * 32 + lane, row = tid >> 4, col = (tid & 15) * 4;  // a thread 4 of the 16 x 64 outputs
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int x = 0; x < kXlWarps; ++x) {
    const float4 v = *reinterpret_cast<const float4*>(xch + x * 1024 + row * 64 + col);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  if (row0 + row < t) {
    *reinterpret_cast<uint2*>(orow + static_cast<size_t>(row) * hd + col) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

// CTA = (sequence, head, `per_cta` consecutive units), a unit a block of 64 query rows or the tail block of
// at most 16; `units` per (sequence, head). The head's whole K and V are loaded once (cp.async, each chunk of
// both warpgroups counted by its own mbarrier, V by one) and stay while the CTA's units run; each unit's Q is
// loaded into one of two buffers while the unit before runs.
template <int KBW, bool MASKED>
__global__ void __launch_bounds__(kXlThreads, 1)
mha_fwd_mma_xlong(const bf16* __restrict__ qkv, const float* __restrict__ mask, bf16* __restrict__ out, int t,
                  int heads, int units, int per_cta, int ctas_per_head, float scale) {
  constexpr int NC = (KBW + 3) / 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2, w = warp & 3;
  const int bh = blockIdx.x / ctas_per_head, u0 = (blockIdx.x % ctas_per_head) * per_cta;
  const int u1 = min(u0 + per_cta, units);
  const int b = bh / heads, h = bh % heads;
  const int hd = heads * kD, nkb = (t + 15) / 16;
  const bool tail = t % 64 >= 1 && t % 64 <= 16;
  const int nwhole = units - (tail ? 1 : 0);
  const size_t stride = 3 * static_cast<size_t>(hd);
  const bf16* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;

  unsigned char* ks = smem;
  unsigned char* vs = ks + 2 * KBW * kTileBytes;
  unsigned char* qbuf = vs + 2 * KBW * kTileBytes;
  float* xch = reinterpret_cast<float*>(qbuf + 8 * kTileBytes);
  float* rst = xch + kXlExchange;
  const uint32_t bars = smem_u32(rst + kXlStats);
  if (tid == 0) {
    for (int i = 0; i < kXlBars; ++i) mbar_init(bars + 8 * i, kXlThreads);
  }
  __syncthreads();

  // the first unit's Q, then K chunk by chunk for both warpgroups, then V; every thread arrives on every barrier
  auto load_q_rows = [&](int u, int buf) {
    copy_rows(qbuf + buf * 4 * kTileBytes, base + static_cast<size_t>(64 * u) * stride, 0, 64, t - 1 - 64 * u, stride,
              tid, kXlThreads);
    cp_async_arrive(bars + 8 * (kXlQBar + buf));
  };
  load_q_rows(u0, 0);
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
    const int r1 = 16 * min(4 * ch + 4, KBW);
    copy_rows(ks, base + hd, 64 * ch, r1, t - 1, stride, tid, kXlThreads);  // the first warpgroup's keys
    copy_rows(ks, base + hd, 16 * KBW + 64 * ch, 16 * KBW + r1, t - 1, stride, tid, kXlThreads);  // the second's
    cp_async_arrive(bars + 8 * ch);
  }
  for (int ch = NC; ch < kXlVBar; ++ch) cp_async_arrive(bars + 8 * ch);  // steps this KBW does not have
  copy_rows(vs, base + 2 * hd, 0, 32 * KBW, t - 1, stride, tid, kXlThreads);
  cp_async_arrive(bars + 8 * kXlVBar);

  const float c = scale * kLog2e;
  const uint32_t kaddr = smem_u32(ks) + wg * KBW * kTileBytes, vaddr = smem_u32(vs) + wg * KBW * kTileBytes;
  for (int i = 0; u0 + i < u1; ++i) {
    const int u = u0 + i, buf = i & 1;
    mbar_wait(bars + 8 * (kXlQBar + buf), (i >> 1) & 1);
    uint32_t qa[4][4];  // the tail's 16 rows for every warp, else the warp's own 16
    load_q(qa, qbuf + buf * 4 * kTileBytes + (u == nwhole ? 0 : w * kTileBytes), lane);
    // the next block's Q into the other buffer: every thread has read it for the block before, since this
    // block's Q completed only once every thread had issued it, after its own reading
    if (u + 1 < u1) load_q_rows(u + 1, buf ^ 1);
    bf16* orow = out + (static_cast<size_t>(b) * t + 64 * u) * hd + h * kD;
    if (u == nwhole) {  // the tail block (uniform)
      for (int ch = 0; ch <= kXlVBar; ++ch) mbar_wait(bars + 8 * ch, 0);
      xl_tail<MASKED>(qa, smem_u32(ks), smem_u32(vs), mask, rst, xch, orow, t, nkb, 64 * u, hd, c, warp, lane);
    } else {
      float o[8][4];
      xl_rows<KBW, MASKED>(o, qa, kaddr, vaddr, bars, bars + 8 * kXlVBar, mask,
                           rst + (i & 1) * 256, t, nkb, wg * KBW, 64 * u, wg, w, c, lane);
      // rows of warps 0 and 1 are finished by warpgroup 0, of warps 2 and 3 by warpgroup 1: the other
      // warpgroup's warp of the same rows hands its partial over through `xch` (and does not wait);
      // o0 + o1 either way, the same bits
      float* part = xch + w * 16 * kXlPartStride;
      const int g = lane >> 2, tq = lane & 3;
      const bool give = (w >> 1) != wg;
      if (give) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          *reinterpret_cast<float2*>(part + g * kXlPartStride + 8 * nt + 2 * tq) = make_float2(o[nt][0], o[nt][1]);
          *reinterpret_cast<float2*>(part + (g + 8) * kXlPartStride + 8 * nt + 2 * tq) =
              make_float2(o[nt][2], o[nt][3]);
        }
        pair_arrive(kXlPartBar + w);
      } else {
        pair_sync(kXlPartBar + w);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 x = *reinterpret_cast<const float2*>(part + g * kXlPartStride + 8 * nt + 2 * tq);
          const float2 y = *reinterpret_cast<const float2*>(part + (g + 8) * kXlPartStride + 8 * nt + 2 * tq);
          o[nt][0] += x.x;
          o[nt][1] += x.y;
          o[nt][2] += y.x;
          o[nt][3] += y.y;
        }
        const int row0 = 64 * u + 16 * w;
        store_tile(o, reinterpret_cast<unsigned char*>(part), orow + static_cast<size_t>(16 * w) * hd, t - row0,
                   hd, lane);
      }
    }
  }
}

// units of 64 query rows a CTA takes: the fewest rounds of CTAs over the SMs, a round costing its CTAs'
// units plus one for loading K and V
int xl_units_per_cta(long long heads_total, int units) {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
                                                  cudaSuccess) {
      n = 132;
    }
    return n;
  }();
  int best = 1;
  long long best_cost = -1;
  for (int g = 1; g <= units; ++g) {
    const long long ctas = heads_total * ((units + g - 1) / g);
    const long long cost = (ctas + sms - 1) / sms * (g + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = g;
      best_cost = cost;
    }
  }
  return best;
}

template <int KBW, bool MASKED>
int launch_xlong(const bf16* qkv, const float* mask, bf16* out, int batch, int t, int heads, float scale,
                 cudaStream_t stream) {
  constexpr int kSmem = xl_smem_bytes(KBW);
  static const cudaError_t attr =  // once per kernel and process
      cudaFuncSetAttribute(mha_fwd_mma_xlong<KBW, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tail = t % 64 >= 1 && t % 64 <= 16 ? 1 : 0;
  const int units = (tail ? t / 64 : (t + 63) / 64) + tail;
  const long long bh = static_cast<long long>(batch) * heads;
  const int per_cta = xl_units_per_cta(bh, units);
  const int ctas_per_head = (units + per_cta - 1) / per_cta;
  const long long ctas = bh * ctas_per_head;
  if (ctas > 0x7fffffffLL) return kBadArgs;
  mha_fwd_mma_xlong<KBW, MASKED><<<static_cast<unsigned>(ctas), kXlThreads, kSmem, stream>>>(
      qkv, mask, out, t, heads, units, per_cta, ctas_per_head, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool MASKED>
int launch_xlong_for(const bf16* qkv, const float* mask, bf16* out, int batch, int t, int heads, float scale,
                     cudaStream_t stream) {
  // key blocks a warpgroup holds: 2 KBW >= ceil(T / 16), the second warpgroup's first block inside T
  if (t <= 384) return launch_xlong<12, MASKED>(qkv, mask, out, batch, t, heads, scale, stream);
  if (t <= 512) return launch_xlong<16, MASKED>(qkv, mask, out, batch, t, heads, scale, stream);
  return launch_xlong<19, MASKED>(qkv, mask, out, batch, t, heads, scale, stream);
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

// bf16 only. mask may be null. 258 <= T <= 577.
int rlcf_mha_fwd_mma_xlong(const void* qkv, const void* mask, void* out, int batch, int t, int heads, float scale,
                           void* stream) {
  if (bad_args(batch, t, heads, kMaxTFwd) || t <= kMaxT) return kBadArgs;
  const bf16* x = static_cast<const bf16*>(qkv);
  const float* m = static_cast<const float*>(mask);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m != nullptr ? launch_xlong_for<true>(x, m, o, batch, t, heads, scale, s)
                      : launch_xlong_for<false>(x, m, o, batch, t, heads, scale, s);
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

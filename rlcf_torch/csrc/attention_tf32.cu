// Fused multi-head attention forward from the unsplit QKV projection in fp32,
// on Hopper's tensor cores from split TF32 operands (sm_90a).
//
// Replaces the TPU kernel `_mha_fwd_kernel` of
// rlcf_tpu/ops/pallas_attention.py:65 for fp32 inputs (bf16 inputs run
// attention_mma.cu), and serves the fp32 `ATTN_IMPL = "flash"` route of
// rlcf_tpu/models/layers.py:48.
//
//   qkv [B, T, 3*H*64] fp32 (+ additive mask [T, T] fp32) -> out [B, T, H*64]
//   s = q.k * scale (+ mask), max-subtracted softmax, out = P.V, all in fp32.
//
// The products S = Q.K^T and O = P.V run on the tensor cores with each fp32
// operand split into TF32 parts (attention_tf32.cuh), which holds fp32's 1e-5
// tolerance where one TF32 pass does not. The softmax runs in fp32 on the
// accumulators.
//
// What bounds it, and what the design does about it.
//
// Long sequences (17 <= T <= 577, the vision towers up to ViT-L/14 at 336 px,
// T = 577): operations. At the
// policy tower's shape (B=256, T=197, H=12) qkv and out are 620 MB, 0.185 ms
// of device memory time, and the 30.5 GFLOP of fp32 products are 0.185 ms at
// the 3xTF32 rate (a third of the 495 TFLOP/s of TF32). A first design on
// mma.sync (16 query rows a warp, K and V whole in shared memory, split at
// every use) had every warp fetch and split its own B fragments for 16 rows:
// shared-memory traffic, not the tensor cores, set its pace. So:
//   * one CTA of one warpgroup per (sequence, head, block of 64 query rows);
//     a warp owns 16 of the rows and holds Q as split A operands in registers
//     (read from device memory once);
//   * K and V stream through shared memory in chunks of 64 keys: the next
//     chunk arrives by cp.async while this one is multiplied, and is split
//     once per CTA into hi and lo copies in the 128-byte-swizzled layout that
//     wgmma reads K-major (V turned over, its keys in the depth order of the
//     accumulator layout); its K while this chunk's P.V runs;
//   * S = Q.K^T and O = P.V run as wgmma m64n64k8 (TF32 in, fp32 out) with A
//     from registers and B read by the tensor cores from the copies, so that
//     each fetch serves 64 rows: 24 wgmma a product, every cross product
//     before the hi.hi ones;
//   * an online softmax per chunk: the row max across the quad, P = 2^(s *
//     scale * log2(e) - max) in fp32 straight from the accumulators into the
//     A operands of P.V, whose chunk sum lands in fresh accumulators and is
//     added to the rescaled output in fp32. The function casts P to fp32
//     before P.V, the identity, so normalising at the end is the same
//     function, at any T: the chunks stream, so shared memory does not grow
//     with T and the kernel serves 258 <= T <= 577 as it is (one head's K and
//     V at T = 577 would take 144 KB each). 100 KB of shared memory and 255
//     registers: two CTAs an SM;
//   * the ragged edge: key columns >= T get -inf (probability 0), rows >= T of
//     a chunk are zero-filled and never read from device memory, query rows
//     >= T read as 0 and are not stored.
//
// Short sequences (T <= 16, the text tower's prompts): per-warp latency and
// bytes (B=800, H=8: 105 MB, 0.031 ms, for 0.2 GFLOP). One warp per (sequence,
// head), 8 heads a CTA, no shared memory and no barrier: the warp reads its
// Q, K and V fragments straight from device memory (all loads independent and
// in flight together), one m16 tile of S and of O on mma.sync, the whole
// softmax row in the accumulators. The products cost nothing next to the
// bytes, so each takes six passes of a three-way split, as accurate as fp32.
//
// The mask is a general additive [T, T] fp32 tensor (already clamped to a
// finite floor by the wrapper).
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after the launch, or kBadArgs for shapes it refuses.

#include "attention_tf32.cuh"

namespace {

constexpr int kChunk = 64;  // keys a chunk of the long regime
// two split copies (hi, lo) of K and of V, the raw rows of the next chunk, room to align the copies to 1024 bytes
constexpr int kLongSmem = 4 * kSwCopy + 2 * kChunk * kRow * static_cast<int>(sizeof(float)) + 1024;
constexpr int kShortHeads = 8;  // warps (heads) per CTA in the short regime

// One chunk of NT tiles of 8 keys (keys k0 ..) for a warp's rows row0 + g and
// row0 + g + 8: S = Q.K^T, the online softmax, O = O * 2^(old max - new max) +
// P.V. While P.V runs, `split_k` (if `more`) splits the next chunk's K.
template <int NT, typename SplitK>
__device__ __forceinline__ void fwd_chunk(const SplitA (&qa)[8], float (&o)[8][4], float (&m)[2], float (&l)[2],
                                          uint32_t khi, uint32_t klo, uint32_t vhi, uint32_t vlo,
                                          const float* __restrict__ mask, int t, int row0, int k0, float sc, int lane,
                                          bool more, SplitK&& split_k) {
  const int g = lane >> 2, c0 = 2 * (lane & 3);
  float s[8][4];  // S of the chunk's NT tiles; then this chunk's P.V (all 8 tiles of head dimensions)
  wgmma_fence();
  wgmma3<8 * NT, 8>(&s[0][0], qa, khi, klo);  // S = Q.K^T
  wgmma_commit();
  wgmma_wait();
  float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    scores_to_log2(s[nt], mask, t, row0 + g, k0 + 8 * nt + c0, sc);
    bm[0] = fmaxf(bm[0], fmaxf(s[nt][0], s[nt][1]));
    bm[1] = fmaxf(bm[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // key 0 is in the first chunk, so the running max is finite from there on
    const float nm = fmaxf(m[r], quad_max(bm[r]));
    alpha[r] = fast_exp2(m[r] - nm);
    m[r] = nm;
    l[r] *= alpha[r];
  }
  SplitA pa[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[0] += s[nt][e] = fast_exp2(s[nt][e] - m[0]);
      l[1] += s[nt][2 + e] = fast_exp2(s[nt][2 + e] - m[1]);
    }
    pa[nt] = acc_as_a(s[nt]);
  }
  wgmma_fence();
  wgmma3<64, NT>(&s[0][0], pa, vhi, vlo);  // this chunk's P.V, in S's registers
  wgmma_commit();
  if (more) split_k();
  wgmma_wait();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {  // in fp32
    o[nt][0] = fmaf(o[nt][0], alpha[0], s[nt][0]);
    o[nt][1] = fmaf(o[nt][1], alpha[0], s[nt][1]);
    o[nt][2] = fmaf(o[nt][2], alpha[1], s[nt][2]);
    o[nt][3] = fmaf(o[nt][3], alpha[1], s[nt][3]);
  }
}

// Long regime: CTA = one warpgroup = (sequence, head, block of 64 query
// rows), a warp owns 16 of the rows; K and V stream through shared memory in
// chunks of 64 keys.
__global__ void __launch_bounds__(128, 2)
mha_fwd_tf32x3_long(const float* __restrict__ qkv, const float* __restrict__ mask, float* __restrict__ out, int t,
                    int heads, int nqb, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* khi = smem;
  unsigned char* klo = khi + kSwCopy;
  unsigned char* vhi = klo + kSwCopy;
  unsigned char* vlo = vhi + kSwCopy;
  float* raw = reinterpret_cast<float*>(vlo + kSwCopy);  // the next chunk's K and V rows as they arrive
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x / nqb, row0 = (blockIdx.x % nqb) * 64 + warp * 16;
  const int b = bh / heads, h = bh % heads;
  const int hd = heads * kD;
  const size_t stride = 3 * static_cast<size_t>(hd);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;

  auto stage = [&](int k0) {
    for (int idx = threadIdx.x; idx < 2 * kChunk * 16; idx += 128) {
      const int m = idx / (kChunk * 16), r = (idx >> 4) % kChunk, c = (idx & 15) * 4;
      float* d = raw + (m * kChunk + r) * kRow + c;
      if (k0 + r < t) {
        cp_async16(smem_u32(d), base + (1 + m) * hd + static_cast<size_t>(k0 + r) * stride + c);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };
  // the next chunk's K copies are split while this chunk's P.V runs, its V
  // copies after that: each waits for the wgmma reading the copies it overwrites
  auto split_k = [&]() {
    cp_async_wait<0>();
    __syncthreads();  // the chunk has arrived, and every warp is past S = Q.K^T
    split_sw_rows(khi, klo, raw, threadIdx.x, 128);
  };
  auto split_v = [&]() {
    __syncthreads();  // every warp is past P.V
    split_sw_cols(vhi, vlo, raw + kChunk * kRow, threadIdx.x, 128);
    fence_async_proxy();  // the copies' generic-proxy writes, visible to wgmma
    __syncthreads();
  };

  stage(0);
  SplitA qa[8];  // Q's A operands (rows >= T read as 0), split once
  load_rows_a(qa, base + static_cast<size_t>(row0) * stride, t - row0, stride, lane);
  split_k();
  split_v();

  const float sc = scale * kLog2e;
  const uint32_t khi_a = smem_u32(khi), klo_a = smem_u32(klo), vhi_a = smem_u32(vhi), vlo_a = smem_u32(vlo);
  float o[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8: running max, partial sum
  for (int k0 = 0; k0 < t; k0 += kChunk) {
    const bool more = k0 + kChunk < t;
    if (more) stage(k0 + kChunk);  // in flight while this chunk is multiplied
    // the last chunk multiplies only the key tiles it holds
    if (t - k0 > 32) {
      fwd_chunk<8>(qa, o, m, l, khi_a, klo_a, vhi_a, vlo_a, mask, t, row0, k0, sc, lane, more, split_k);
    } else if (t - k0 > 16) {
      fwd_chunk<4>(qa, o, m, l, khi_a, klo_a, vhi_a, vlo_a, mask, t, row0, k0, sc, lane, more, split_k);
    } else {
      fwd_chunk<2>(qa, o, m, l, khi_a, klo_a, vhi_a, vlo_a, mask, t, row0, k0, sc, lane, more, split_k);
    }
    if (more) split_v();
  }
  if (row0 < t) {
    store_rows(o, out + (static_cast<size_t>(b) * t + row0) * hd + h * kD, t - row0, hd, 1.f / quad_sum(l[0]),
               1.f / quad_sum(l[1]), lane);
  }
}

// Short regime (T <= 16): CTA = (sequence, group of 8 heads), warp = head;
// one m16 tile a head, operands straight from device memory.
__global__ void __launch_bounds__(kShortHeads * 32)
mha_fwd_tf32x6_short(const float* __restrict__ qkv, const float* __restrict__ mask, float* __restrict__ out, int t,
                     int heads, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x, h = blockIdx.y * kShortHeads + warp;
  if (h >= heads) return;  // no barrier below
  const int hd = heads * kD;
  const size_t stride = 3 * static_cast<size_t>(hd);
  const float* base = qkv + static_cast<size_t>(b) * t * stride + h * kD;
  const int g = lane >> 2, c0 = 2 * (lane & 3);

  float s[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const Split3A qa = lda_global(base, t, stride, 8 * kk, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float b0, b1;
      ldg_rows(base + hd, stride, t, 8 * nt, 8 * kk, lane, b0, b1);
      mma6(s[nt], qa, b0, b1);
    }
  }
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    scores_to_log2(s[nt], mask, t, g, 8 * nt + c0, scale * kLog2e);
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
  float o[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const Split3A pa = acc_as_a3(s[kk]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float b0, b1;
      ldg_cols(base + 2 * hd, stride, t, 8 * kk, 8 * nt, lane, b0, b1);
      mma6(o[nt], pa, b0, b1);
    }
  }
  store_rows(o, out + static_cast<size_t>(b) * t * hd + h * kD, t, hd, 1.f / quad_sum(la), 1.f / quad_sum(lb), lane);
}

}  // namespace

extern "C" {

// fp32 only. mask may be null. 1 <= T <= 577 (the wrapper sends T <= 16 to the short kernel).
int rlcf_mha_fwd_tf32x3_long(const void* qkv, const void* mask, void* out, int batch, int t, int heads, float scale,
                             void* stream) {
  if (bad_args(batch, t, heads, kMaxTFwd)) return kBadArgs;
  static const cudaError_t attr =  // once per process
      cudaFuncSetAttribute(mha_fwd_tf32x3_long, cudaFuncAttributeMaxDynamicSharedMemorySize, kLongSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int nqb = (t + 63) / 64;
  const long long ctas = static_cast<long long>(batch) * heads * nqb;
  if (ctas > 0x7fffffffLL) return kBadArgs;
  mha_fwd_tf32x3_long<<<static_cast<unsigned>(ctas), 128, kLongSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(mask), static_cast<float*>(out), t, heads, nqb, scale);
  return static_cast<int>(cudaGetLastError());
}

// fp32 only. mask may be null. 1 <= T <= 16.
int rlcf_mha_fwd_tf32x6_short(const void* qkv, const void* mask, void* out, int batch, int t, int heads, float scale,
                              void* stream) {
  if (bad_args(batch, t, heads) || t > kShortT) return kBadArgs;
  const int warps = heads < kShortHeads ? heads : kShortHeads;
  const dim3 grid(batch, (heads + kShortHeads - 1) / kShortHeads);
  if (grid.y > 65535u) return kBadArgs;
  mha_fwd_tf32x6_short<<<grid, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(mask), static_cast<float*>(out), t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

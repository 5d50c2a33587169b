// What the tensor-core attention kernels share (attention_mma.cu, the bf16
// forward; attention_bwd_mma.cu, the bf16 backward; through
// attention_tf32.cuh the fp32 ones): the swizzled tile of 128-byte head rows
// in shared memory, cp.async staging out of the unsplit QKV layout, the
// softmax's quad reductions and exp2, and the ldmatrix / mma.sync / wgmma
// wrappers (sm_90a).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;             // head dimension
constexpr int kRowBytes = 128;     // one head row in bf16
constexpr int kTileBytes = 2048;   // 16 rows
constexpr int kMaxT = 257;         // longest sequence of the long backward kernels (ViT-L/14 at 224 px)
constexpr int kMaxTFwd = 577;      // of the forward kernels and the xlong backward (ViT-L/14 at 336 px)
constexpr int kShortT = 16;        // longest sequence of the short regime
constexpr int kBadArgs = 9001;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

inline bool bad_args(int batch, int t, int heads, int max_t = kMaxT) {
  return batch < 1 || heads < 1 || t < 1 || t > max_t || static_cast<long long>(batch) * heads > 0x7fffffffLL;
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of 128-byte rows
__device__ __forceinline__ int tile_off(int r, int c) { return r * kRowBytes + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row-major) . b (16x8, column-major), bf16 in, fp32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The first n_rows rows of a swizzled tile of 128-byte rows from a row-major
// global matrix (64 columns from `src`, row stride `stride` elements); rows
// >= n_valid are zero-filled and never read from device memory.
__device__ __forceinline__ void stage_rows(unsigned char* dst, const bf16* src, int n_rows, int n_valid,
                                           size_t stride, int tid, int nthreads) {
  for (int idx = tid; idx < n_rows * 8; idx += nthreads) {
    const int r = idx >> 3, c = idx & 7;
    unsigned char* d = dst + tile_off(r, c);
    if (r < n_valid) {
      cp_async16(smem_u32(d), src + static_cast<size_t>(r) * stride + c * 8);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Rows [r0, r1) of a swizzled tile of 128-byte rows by cp.async from a
// row-major global matrix (64 columns from `src`, row stride `stride`
// elements), rows past `last` read as row `last`: the xlong kernels' padding
// rows hold finite values that the kernels give weight 0 (key columns >= T)
// or never store (query rows >= T), so no tile row is written by a plain
// store that the tensor cores would have to be fenced against.
__device__ __forceinline__ void copy_rows(unsigned char* dst, const bf16* src, int r0, int r1, int last,
                                          size_t stride, int tid, int nthreads) {
  for (int idx = r0 * 8 + tid; idx < r1 * 8; idx += nthreads) {
    const int r = idx >> 3, c = idx & 7;
    cp_async16(smem_u32(dst + tile_off(r, c)), src + static_cast<size_t>(min(r, last)) * stride + c * 8);
  }
}

// ---- mbarriers that count cp.async copies: a thread's arrival lands when all
// of its earlier copies have, so that a warp waits for the rows it needs and
// not for a CTA-wide barrier

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// 16 rows of a tile as the A operands of a product over the 64 head
// dimensions (4 steps of 16 dims).
__device__ __forceinline__ void load_q(uint32_t (&qa)[4][4], const unsigned char* qs, int lane) {
  const uint32_t qaddr = smem_u32(qs);
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8, c = lane >> 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) ldmatrix_x4(qa[k], qaddr + tile_off(r, 2 * k + c));
}

// x[16 x 16] += a[16 x 64] . tile[16 x 64]^T on mma.sync: the tile's 16 rows
// as two column tiles of 8, 4 steps of 16 dims.
__device__ __forceinline__ void mma_scores(float (&x)[2][4], const uint32_t (&a)[4][4], uint32_t tile, int lane) {
  const int r = (lane & 7) + (lane >> 4) * 8, c = (lane >> 3) & 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t f[4];
    ldmatrix_x4(f, tile + tile_off(r, 2 * k + c));
    mma_bf16(x[0], a[k], f[0], f[1]);
    mma_bf16(x[1], a[k], f[2], f[3]);
  }
}

// o[16 x 64] += a[16 x 16] . tile[16 x 64] on mma.sync: the 64 columns as 4
// pairs of tiles of 8, the tile transposed on the way in.
__device__ __forceinline__ void mma_rows(float (&o)[8][4], const uint32_t (&a)[4], uint32_t tile, int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8, c = lane >> 4;
#pragma unroll
  for (int dp = 0; dp < 4; ++dp) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, tile + tile_off(r, 2 * dp + c));
    mma_bf16(o[2 * dp], a, f[0], f[1]);
    mma_bf16(o[2 * dp + 1], a, f[2], f[3]);
  }
}

// A warp's 16 x 64 output tile leaves through `otile` (16 rows of shared
// memory that the warp owns and no longer needs) as whole 16-byte pieces.
// `orow` points at the output row of tile row 0, `rows` is how many of the 16
// rows exist, `stride` the output's row stride in elements.
__device__ __forceinline__ void store_tile(const float (&o)[8][4], unsigned char* otile, bf16* __restrict__ orow,
                                           int rows, int stride, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<uint32_t*>(otile + tile_off(g, nt) + tq * 4) = pack_bf16(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(otile + tile_off(g + 8, nt) + tq * 4) = pack_bf16(o[nt][2], o[nt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + 32 * i, row = idx >> 3, ch = idx & 7;
    if (row < rows) {
      *reinterpret_cast<uint4*>(orow + static_cast<size_t>(row) * stride + ch * 8) =
          *reinterpret_cast<const uint4*>(otile + tile_off(row, ch));
    }
  }
}

// ---- warpgroup matrix multiply (wgmma), A from registers, B from shared memory

// Descriptor of a B operand in a tile of 128-byte rows with the 128-byte
// swizzle (chunk c of row r at c ^ (r & 7); the tile is 1024-byte aligned):
// 8-row groups are 1024 bytes apart in both roles the operand takes here.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) | (uint64_t{64} << 16) | (uint64_t{64} << 32) |
         (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// writes of the generic proxy (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

#define RLCF_ACC8(d, o)                                                                           \
  "+f"((d)[(o)]), "+f"((d)[(o) + 1]), "+f"((d)[(o) + 2]), "+f"((d)[(o) + 3]), "+f"((d)[(o) + 4]), \
      "+f"((d)[(o) + 5]), "+f"((d)[(o) + 6]), "+f"((d)[(o) + 7])

// d[64 x 64] (+)= a[64 x 16] . b[16 x 64]; a thread's 32 accumulators are 8
// tiles of 8 columns in the layout of mma.sync's. TRANS: b's 64 columns are
// contiguous in shared memory (rows of the tile are the product's depth), else
// its 16 depth elements are (rows of the tile are the product's columns).
template <int TRANS>
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : RLCF_ACC8(d, 0), RLCF_ACC8(d, 8), RLCF_ACC8(d, 16), RLCF_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS), "r"(accumulate));
}

// d[64 x 16] (+)= a[64 x 16] . b[16 x 16], the tile's rows are the product's columns.
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : RLCF_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

}  // namespace

// Fused multi-head attention from the unsplit QKV projection for Hopper
// (sm_90a) on the CUDA cores, for fp32 inputs: forward and backward. bf16
// inputs run on the tensor cores (attention_mma.cu, attention_bwd_mma.cu).
//
// Replaces the TPU kernels `_mha_fwd_kernel` and `_mha_bwd_kernel` of
// rlcf_tpu/ops/pallas_attention.py (the custom-VJP `fused_attention`).
//
//   forward : qkv [B, T, 3*H*64] (+ additive mask [T, T] fp32) -> out [B, T, H*64]
//             s = q.k * scale (+ mask) in fp32, max-subtracted fp32 softmax,
//             P rounded to the input dtype, P.V accumulated in fp32.
//   backward: (qkv, g [B, T, H*64]) -> dqkv [B, T, 3*H*64] in the fused layout,
//             all fp32: P recomputed, dv = P^T g, dp = g v^T,
//             ds = P * (dp - rowsum(dp * P)), dq = ds k * scale, dk = ds^T q * scale.
//
// Design: one CTA per (sequence, head), 8 warps. The CTA copies the head's
// [T, 64] slices straight out of the unsplit layout into shared memory
// (rows padded by 16 bytes so that lanes reading different rows hit
// different banks); scores and probabilities never leave the SM. One warp
// per query row: lanes split the keys for the scores (q held in registers),
// warp shuffles reduce max and sum, and for P.V each lane owns 8 columns of
// one of 4 key strides, reduced by shuffles at the end. The backward runs
// two passes without atomics: pass A (warp per query row, K and V in shared
// memory) writes dq and keeps each row's max, sum and rowsum(dp * P); pass B
// (warp per key row, Q and G in shared memory) recomputes P and dS
// column-wise bit-identically from those statistics and writes dk and dv.
//
// What bounds it: bytes. At the policy tower's shape (B=256, T=197, H=12,
// bf16) one forward moves ~310 MB (qkv read once, out written once) for
// ~30 GFLOP of attention, ~100 FLOP/byte, below the H100's bf16 ridge of
// ~295 FLOP/byte; at the text tower's T=16 it is ~8 FLOP/byte. The design
// reads every qkv element once from device memory and writes every output
// once; nothing of size [T, T] goes to device memory. The products run on
// the fp32 CUDA cores, which makes these kernels compute-bound in practice at
// T=197/257: fp32 stays here because TF32 would not hold its tolerances (1e-5
// forward, 1e-4 backward).
//
// Plain C interface (bound with ctypes); each entry point returns
// cudaGetLastError() after the launch, or kBadArgs for shapes it refuses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dimension
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 257;
constexpr int kBadArgs = 9001;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;  // elements per 16-byte chunk
  __device__ __forceinline__ static void chunk(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ __forceinline__ static void load2(const float* p, float& a, float& b) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x; b = v.y;
  }
  __device__ __forceinline__ static void store8(float* p, const float* x) {
    reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
  __device__ __forceinline__ static float round(float x) { return x; }
};

// shared-memory row stride in elements: 64 + 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int srow() { return kD + 16 / static_cast<int>(sizeof(T)); }

__host__ __device__ constexpr int pad4(int t) { return (t + 3) & ~3; }

template <typename T>
__host__ constexpr size_t fwd_smem_bytes(int t) {
  return 2 * static_cast<size_t>(t) * srow<T>() * sizeof(T) + kWarps * static_cast<size_t>(kD + pad4(t)) * 4;
}

template <typename T>
__host__ constexpr size_t bwd_smem_bytes(int t) {
  return 2 * static_cast<size_t>(t) * srow<T>() * sizeof(T) + 3 * static_cast<size_t>(pad4(t)) * 4 +
         kWarps * static_cast<size_t>(2 * kD + 2 * pad4(t)) * 4;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Copy rows [0, t) x columns [col, col + 64) of a row-major global matrix
// (row stride `stride` elements) into padded shared-memory rows.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int t, int stride, int col) {
  constexpr int kChunks = kD / Io<T>::kVec;
  for (int idx = threadIdx.x; idx < t * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * Io<T>::kVec;
    *reinterpret_cast<uint4*>(dst + r * srow<T>() + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * stride + col + c);
  }
}

// Warp-cooperative: global row of 64 elements -> per-warp float buffer -> registers.
template <typename T>
__device__ __forceinline__ void row_to_regs(const T* src, float* buf, float (&v)[kD], int lane) {
  float a, b;
  Io<T>::load2(src + 2 * lane, a, b);
  buf[2 * lane] = a;
  buf[2 * lane + 1] = b;
  __syncwarp();
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    const float4 f = *reinterpret_cast<const float4*>(buf + d);
    v[d] = f.x; v[d + 1] = f.y; v[d + 2] = f.z; v[d + 3] = f.w;
  }
}

// One padded shared-memory row . a register vector, summed in d order.
template <typename T>
__device__ __forceinline__ float dot_row(const T* row, const float (&v)[kD]) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kD; c += Io<T>::kVec) {
    float x[Io<T>::kVec];
    Io<T>::chunk(row + c, x);
#pragma unroll
    for (int e = 0; e < Io<T>::kVec; ++e) acc = fmaf(x[e], v[c + e], acc);
  }
  return acc;
}

// acc = sum_j w[j] * M[j, cg*8 .. cg*8+8) for lane = jg*8 + cg; the full sum
// ends in lanes 0..7 (columns lane*8 .. lane*8+8).
template <typename T>
__device__ __forceinline__ void weighted_rows(const float* w, const T* m, int t, int lane, float (&acc)[8]) {
  const int cg = lane & 7, jg = lane >> 3;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int j = jg; j < t; j += 4) {
    const float wj = w[j];
    float x[8];
    const T* p = m + j * srow<T>() + cg * 8;
#pragma unroll
    for (int c = 0; c < 8; c += Io<T>::kVec) Io<T>::chunk(p + c, x + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(wj, x[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc[e] += __shfl_xor_sync(kFull, acc[e], 8);
    acc[e] += __shfl_xor_sync(kFull, acc[e], 16);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ mask, T* __restrict__ out,
               int t, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = srow<T>();
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int hd = heads * kD, stride = 3 * hd, tp = pad4(t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + t * R;
  float* vecbuf = reinterpret_cast<float*>(vs + t * R) + warp * (kD + tp);
  float* pbuf = vecbuf + kD;

  const T* base = qkv + static_cast<size_t>(b) * t * stride;
  stage(ks, base, t, stride, hd + h * kD);
  stage(vs, base, t, stride, 2 * hd + h * kD);
  __syncthreads();

  for (int i = warp; i < t; i += kWarps) {
    float q[kD];
    row_to_regs(base + static_cast<size_t>(i) * stride + h * kD, vecbuf, q, lane);
    float mloc = -INFINITY;
    for (int j = lane; j < t; j += 32) {
      float s = dot_row(ks + j * R, q) * scale;
      if (mask) s += mask[static_cast<size_t>(i) * t + j];
      pbuf[j] = s;
      mloc = fmaxf(mloc, s);
    }
    const float m = warp_max(mloc);
    float lsum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(pbuf[j] - m);
      pbuf[j] = e;
      lsum += e;
    }
    const float l = warp_sum(lsum);
    for (int j = lane; j < t; j += 32) pbuf[j] = Io<T>::round(pbuf[j] / l);
    __syncwarp();
    float acc[8];
    weighted_rows(pbuf, vs, t, lane, acc);
    if (lane < 8) Io<T>::store8(out + (static_cast<size_t>(b) * t + i) * hd + h * kD + lane * 8, acc);
    __syncwarp();  // vecbuf / pbuf are rewritten by the next row
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g, const float* __restrict__ mask,
               T* __restrict__ dqkv, int t, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = srow<T>();
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int hd = heads * kD, stride = 3 * hd, tp = pad4(t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  T* sa = reinterpret_cast<T*>(smem);  // pass A: K, pass B: Q
  T* sb = sa + t * R;                  // pass A: V, pass B: G
  float* stats = reinterpret_cast<float*>(sb + t * R);  // row max | row sum | rowsum(dp * P)
  float* vec1 = stats + 3 * tp + warp * (2 * kD + 2 * tp);
  float* vec2 = vec1 + kD;
  float* buf1 = vec2 + kD;
  float* buf2 = buf1 + tp;

  const T* base = qkv + static_cast<size_t>(b) * t * stride;
  const T* gbase = g + static_cast<size_t>(b) * t * hd;
  T* dbase = dqkv + static_cast<size_t>(b) * t * stride;

  // ---- pass A: warp per query row i -> dq_i and the row statistics
  stage(sa, base, t, stride, hd + h * kD);
  stage(sb, base, t, stride, 2 * hd + h * kD);
  __syncthreads();
  for (int i = warp; i < t; i += kWarps) {
    float qv[kD], gv[kD];
    row_to_regs(base + static_cast<size_t>(i) * stride + h * kD, vec1, qv, lane);
    row_to_regs(gbase + static_cast<size_t>(i) * hd + h * kD, vec2, gv, lane);
    float mloc = -INFINITY;
    for (int j = lane; j < t; j += 32) {
      float s = dot_row(sa + j * R, qv) * scale;
      if (mask) s += mask[static_cast<size_t>(i) * t + j];
      buf1[j] = s;
      buf2[j] = dot_row(sb + j * R, gv);
      mloc = fmaxf(mloc, s);
    }
    const float m = warp_max(mloc);
    float lsum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(buf1[j] - m);
      buf1[j] = e;
      lsum += e;
    }
    const float l = warp_sum(lsum);
    float dsum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float p = buf1[j] / l;
      buf1[j] = p;
      dsum += p * buf2[j];
    }
    const float dd = warp_sum(dsum);
    for (int j = lane; j < t; j += 32) buf2[j] = buf1[j] * (buf2[j] - dd);
    if (lane == 0) {
      stats[i] = m;
      stats[tp + i] = l;
      stats[2 * tp + i] = dd;
    }
    __syncwarp();
    float acc[8];
    weighted_rows(buf2, sa, t, lane, acc);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= scale;
    if (lane < 8) Io<T>::store8(dbase + static_cast<size_t>(i) * stride + h * kD + lane * 8, acc);
    __syncwarp();
  }
  __syncthreads();

  // ---- pass B: warp per key row j -> dk_j, dv_j (P and dS recomputed column-wise)
  stage(sa, base, t, stride, h * kD);
  stage(sb, gbase, t, hd, h * kD);
  __syncthreads();
  for (int j = warp; j < t; j += kWarps) {
    float kv[kD], vv[kD];
    row_to_regs(base + static_cast<size_t>(j) * stride + hd + h * kD, vec1, kv, lane);
    row_to_regs(base + static_cast<size_t>(j) * stride + 2 * hd + h * kD, vec2, vv, lane);
    for (int i = lane; i < t; i += 32) {
      float s = dot_row(sa + i * R, kv) * scale;
      if (mask) s += mask[static_cast<size_t>(i) * t + j];
      const float dp = dot_row(sb + i * R, vv);
      const float p = expf(s - stats[i]) / stats[tp + i];
      buf1[i] = p;
      buf2[i] = p * (dp - stats[2 * tp + i]);
    }
    __syncwarp();
    float acc[8];
    weighted_rows(buf1, sb, t, lane, acc);
    if (lane < 8) Io<T>::store8(dbase + static_cast<size_t>(j) * stride + 2 * hd + h * kD + lane * 8, acc);
    weighted_rows(buf2, sa, t, lane, acc);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= scale;
    if (lane < 8) Io<T>::store8(dbase + static_cast<size_t>(j) * stride + hd + h * kD + lane * 8, acc);
    __syncwarp();
  }
}

template <typename T>
int launch_fwd(const void* qkv, const void* mask, void* out, int batch, int t, int heads, float scale,
               cudaStream_t stream) {
  static const cudaError_t attr =  // once per kernel and process
      cudaFuncSetAttribute(mha_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(fwd_smem_bytes<T>(kMaxT)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mha_fwd_kernel<T><<<batch * heads, kThreads, fwd_smem_bytes<T>(t), stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(mask), static_cast<T*>(out), t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* qkv, const void* g, const void* mask, void* dqkv, int batch, int t, int heads,
               float scale, cudaStream_t stream) {
  static const cudaError_t attr =  // once per kernel and process
      cudaFuncSetAttribute(mha_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bwd_smem_bytes<T>(kMaxT)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mha_bwd_kernel<T><<<batch * heads, kThreads, bwd_smem_bytes<T>(t), stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<const float*>(mask),
      static_cast<T*>(dqkv), t, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int batch, int t, int heads) {
  return batch < 1 || heads < 1 || t < 1 || t > kMaxT || static_cast<long long>(batch) * heads > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 only (bf16 is attention_mma.cu's). mask may be null.
int rlcf_mha_fwd(const void* qkv, const void* mask, void* out, int batch, int t, int heads, float scale,
                 int dtype, void* stream) {
  if (bad_args(batch, t, heads)) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(qkv, mask, out, batch, t, heads, scale, s);
  return kBadArgs;
}

// dtype: 0 = float32 only (bf16 is attention_bwd_mma.cu's). mask may be null.
int rlcf_mha_bwd(const void* qkv, const void* g, const void* mask, void* dqkv, int batch, int t, int heads,
                 float scale, int dtype, void* stream) {
  if (bad_args(batch, t, heads)) return kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(qkv, g, mask, dqkv, batch, t, heads, scale, s);
  return kBadArgs;
}

}  // extern "C"

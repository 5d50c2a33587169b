// The CLIP residual block's pointwise work for Hopper (sm_90a), forward and
// backward: LayerNorm (alone, or after a bias and a residual add), bias +
// QuickGELU, bias + residual, and the column sums their weight gradients need.
//
// Replaces no TPU kernel: the JAX package writes this work as plain jnp code
// and XLA fuses it into the neighbouring matrix products on the TPU. The port
// ran it as PyTorch's own elementwise kernels, about 30 launches a block
// forward and 45 backward, most of them fp32 passes over the activation; on
// the H100 they took more of a prompt-TTA group's device time than the GEMMs
// and the attention together (PERF.md §5).
//
//   ln_fwd    x [rows, d] (+ a [rows, d] + bias) -> y = x + a + bias (rounded
//             to the activation's type), out = LN(y); per row mean and rstd (fp32)
//   ln_bwd    (y, g_out, g_y) -> dx = LN'(g_out) + g_y
//   ln_fwd_wide, ln_bwd_wide  the same for rows wider than 2048
//   ln_wgrad  per-CTA partial column sums of g_out * xhat, g_out (and dx)
//   bias_act  out = QuickGELU(a + bias) or x + a + bias
//   gelu_bwd  da = g * QuickGELU'(a + bias) (+ partial column sums of da)
//   colsum    partial column sums of g (the residual's bias gradient)
//   reduce_parts the partials summed in a fixed order into [N or 1, d] (no atomics)
//
// All arithmetic is fp32 (statistics, population variance, eps as given,
// weights read in their own type and widened) and each output is rounded once
// to its type. A weight or bias is a row of `d` elements at `ep * stride`,
// `ep = row / rows_per_ep`: a weight shared by every row has stride 0, a
// per-episode one [N, d] stride d (a shared one expanded to [N, d] again 0).
//
// What bounds it: bytes. A LayerNorm reads and writes 2 bytes an element in
// bf16 and does ~8 operations an element, ~2 operations a byte against the
// H100's ~20 fp32 operations a byte at 3.35 TB/s: every kernel here is bound
// by device memory, and the only gain is to move fewer bytes and launch fewer
// kernels. Design: each kernel reads each input once and writes each output
// once, with 16-byte vector accesses where the width and the pointers allow
// (8 bf16 or 4 fp32 elements a thread; otherwise one element).
// - Row kernels (ln_fwd, ln_bwd): one warp a row, the row held in registers
//   (d <= 1024: up to 32 floats a lane; d <= 2048: 64), statistics by warp
//   shuffles. The mean and the variance take two passes over the registers,
//   not one over memory. Wider rows (OPT's hidden 2560 to 9216, or any other)
//   take ln_fwd_wide and ln_bwd_wide: one CTA a row, statistics by warp
//   shuffles and then across the CTA's warps in shared memory, each pass
//   reading the row again (from L2: a CTA's row is at most tens of KB).
// - Column kernels (the others): a CTA covers up to 256 vectors of columns
//   and a run of rows of one episode; a thread keeps its bias vector and its
//   column sums in registers over the rows, and the CTA's threads over rows
//   sum theirs in shared memory. Partial sums go to a [N, ctas, k, d] scratch
//   and `reduce` adds them in order: deterministic, no atomics, and only
//   launched where a weight needs its gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBadArgs = 9001;  // a shape or type the kernels refuse
constexpr int kRowWarps = 8;    // rows (one a warp) a CTA of the row kernels
constexpr int kColThreads = 256;  // threads a CTA of the column kernels
constexpr int kFloat = 0, kBf16 = 1;  // type codes of the C interface

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
template <typename X> __device__ __forceinline__ X narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 narrow<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to X's precision, as an fp32 value
template <typename X> __device__ __forceinline__ float rounded(float v) { return widen(narrow<X>(v)); }

// V elements of X, aligned as one vector access (at most 16 bytes a load)
template <typename X, int V>
struct alignas(sizeof(X) * V < 16 ? sizeof(X) * V : 16) Pack { X v[V]; };

template <typename X, int V>
__device__ __forceinline__ void load(const X* p, float (&f)[V]) {
  const Pack<X, V> r = *reinterpret_cast<const Pack<X, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = widen(r.v[i]);
}

template <typename X, int V>
__device__ __forceinline__ void store(X* p, const float (&f)[V]) {
  Pack<X, V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) r.v[i] = narrow<X>(f[i]);
  *reinterpret_cast<Pack<X, V>*>(p) = r;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// the sum of s over the CTA's threads, in every thread and in a fixed order
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float red[kRowWarps];
  s = warp_sum(s);
  __syncthreads();  // the last call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kRowWarps; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float sigmoid_qg(float u) { return 1.f / (1.f + expf(-1.702f * u)); }

// ---------------------------------------------------------------------------
// Row kernels: one warp a row, E floats a lane at most (J vectors of V)
// ---------------------------------------------------------------------------

template <typename T, typename TW, int V, int E, bool RES>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_fwd(const T* __restrict__ x, const T* __restrict__ a, const TW* __restrict__ abias, long long s_abias,
       const TW* __restrict__ w, long long s_w, const TW* __restrict__ b, long long s_b, T* __restrict__ y,
       T* __restrict__ out, float* __restrict__ mean, float* __restrict__ rstd, int rows, int d, int rpe, float eps) {
  constexpr int J = E / V;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long ep = row / rpe, base = static_cast<long long>(row) * d;
  float v[J][V];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < d) {
      load<T, V>(x + base + c, v[j]);
      if constexpr (RES) {  // y = x + (a + bias), as the plain block adds the projection's bias first
        float av[V], bv[V];
        load<T, V>(a + base + c, av);
        load<TW, V>(abias + ep * s_abias + c, bv);
#pragma unroll
        for (int i = 0; i < V; ++i) v[j][i] = rounded<T>(v[j][i] + (av[i] + bv[i]));
        store<T, V>(y + base + c, v[j]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) s += v[j][i];
    }
  }
  const float mu = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if ((j * 32 + lane) * V < d) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float t = v[j][i] - mu;
        q += t * t;
      }
    }
  }
  const float rs = rsqrtf(warp_sum(q) / d + eps);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < d) {
      float wv[V], bv[V];
      load<TW, V>(w + ep * s_w + c, wv);
      load<TW, V>(b + ep * s_b + c, bv);
#pragma unroll
      for (int i = 0; i < V; ++i) v[j][i] = (v[j][i] - mu) * rs * wv[i] + bv[i];
      store<T, V>(out + base + c, v[j]);
    }
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// dx = rstd * (g w - mean(g w) - xhat * mean(g w xhat)) (+ g_y), xhat = (y - mean) * rstd
template <typename T, typename TW, int V, int E, bool GRES>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_bwd(const T* __restrict__ y, const T* __restrict__ g, const T* __restrict__ gy, const float* __restrict__ mean,
       const float* __restrict__ rstd, const TW* __restrict__ w, long long s_w, T* __restrict__ dx, int rows, int d,
       int rpe) {
  constexpr int J = E / V;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long ep = row / rpe, base = static_cast<long long>(row) * d;
  const float mu = mean[row], rs = rstd[row];
  float xh[J][V], gw[J][V];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < d) {
      float gv[V], wv[V];
      load<T, V>(y + base + c, xh[j]);
      load<T, V>(g + base + c, gv);
      load<TW, V>(w + ep * s_w + c, wv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        xh[j][i] = (xh[j][i] - mu) * rs;
        gw[j][i] = gv[i] * wv[i];
        s1 += gw[j][i];
        s2 += gw[j][i] * xh[j][i];
      }
    }
  }
  s1 = warp_sum(s1) / d;
  s2 = warp_sum(s2) / d;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < d) {
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = rs * (gw[j][i] - s1 - xh[j][i] * s2);
      if constexpr (GRES) {
        float r[V];
        load<T, V>(gy + base + c, r);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] += r[i];
      }
      store<T, V>(dx + base + c, o);
    }
  }
}

// ---------------------------------------------------------------------------
// Wide row kernels: one CTA (kRowWarps warps) a row of any width, V a vector
// ---------------------------------------------------------------------------

// the row's V elements at column c as ln_fwd normalises them: x, or y = x + (a + bias) rounded
template <typename T, typename TW, int V, bool RES>
__device__ __forceinline__ void wide_row(const T* __restrict__ x, const T* __restrict__ a, const TW* __restrict__ abias,
                                         long long c, int col, float (&v)[V]) {
  load<T, V>(x + c, v);
  if constexpr (RES) {
    float av[V], bv[V];
    load<T, V>(a + c, av);
    load<TW, V>(abias + col, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = rounded<T>(v[i] + (av[i] + bv[i]));
  }
}

// ln_fwd for any d in three passes over the row (sum, squared deviations, output),
// y recomputed in each and written in the last
template <typename T, typename TW, int V, bool RES>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_fwd_wide(const T* __restrict__ x, const T* __restrict__ a, const TW* __restrict__ abias, long long s_abias,
            const TW* __restrict__ w, long long s_w, const TW* __restrict__ b, long long s_b, T* __restrict__ y,
            T* __restrict__ out, float* __restrict__ mean, float* __restrict__ rstd, int rows, int d, int rpe,
            float eps) {
  const int row = blockIdx.x;
  const long long ep = row / rpe, base = static_cast<long long>(row) * d;
  const TW* ab = RES ? abias + ep * s_abias : nullptr;
  const int step = kRowWarps * 32 * V;
  float s = 0.f;
  for (int c = threadIdx.x * V; c < d; c += step) {
    float v[V];
    wide_row<T, TW, V, RES>(x, a, ab, base + c, c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) s += v[i];
  }
  const float mu = block_sum(s) / d;
  float q = 0.f;
  for (int c = threadIdx.x * V; c < d; c += step) {
    float v[V];
    wide_row<T, TW, V, RES>(x, a, ab, base + c, c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float t = v[i] - mu;
      q += t * t;
    }
  }
  const float rs = rsqrtf(block_sum(q) / d + eps);
  for (int c = threadIdx.x * V; c < d; c += step) {
    float v[V], wv[V], bv[V];
    wide_row<T, TW, V, RES>(x, a, ab, base + c, c, v);
    if constexpr (RES) store<T, V>(y + base + c, v);
    load<TW, V>(w + ep * s_w + c, wv);
    load<TW, V>(b + ep * s_b + c, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = (v[i] - mu) * rs * wv[i] + bv[i];
    store<T, V>(out + base + c, v);
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// ln_bwd for any d in two passes over the row (the two sums, then dx)
template <typename T, typename TW, int V, bool GRES>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_bwd_wide(const T* __restrict__ y, const T* __restrict__ g, const T* __restrict__ gy, const float* __restrict__ mean,
            const float* __restrict__ rstd, const TW* __restrict__ w, long long s_w, T* __restrict__ dx, int rows,
            int d, int rpe) {
  const int row = blockIdx.x;
  const long long ep = row / rpe, base = static_cast<long long>(row) * d;
  const TW* wr = w + ep * s_w;
  const float mu = mean[row], rs = rstd[row];
  const int step = kRowWarps * 32 * V;
  float s1 = 0.f, s2 = 0.f;
  for (int c = threadIdx.x * V; c < d; c += step) {
    float yv[V], gv[V], wv[V];
    load<T, V>(y + base + c, yv);
    load<T, V>(g + base + c, gv);
    load<TW, V>(wr + c, wv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float gw = gv[i] * wv[i];
      s1 += gw;
      s2 += gw * ((yv[i] - mu) * rs);
    }
  }
  s1 = block_sum(s1) / d;
  s2 = block_sum(s2) / d;
  for (int c = threadIdx.x * V; c < d; c += step) {
    float yv[V], gv[V], wv[V], o[V];
    load<T, V>(y + base + c, yv);
    load<T, V>(g + base + c, gv);
    load<TW, V>(wr + c, wv);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = rs * (gv[i] * wv[i] - s1 - ((yv[i] - mu) * rs) * s2);
    if constexpr (GRES) {
      float r[V];
      load<T, V>(gy + base + c, r);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] += r[i];
    }
    store<T, V>(dx + base + c, o);
  }
}

// ---------------------------------------------------------------------------
// Column kernels: grid (column tiles, CTAs an episode, episodes), block
// (blockDim.x threads over column vectors, blockDim.y over rows)
// ---------------------------------------------------------------------------

struct Cols {
  int c;       // the thread's first column (>= d: no column)
  long long r;  // the thread's first row
  long long end;  // one past the CTA's last row
};

__device__ __forceinline__ Cols cols(int V, int rpe, int chunk) {
  Cols t;
  t.c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const long long first = static_cast<long long>(blockIdx.z) * rpe;
  t.r = first + static_cast<long long>(blockIdx.y) * chunk + threadIdx.y;
  t.end = first + min(static_cast<long long>(blockIdx.y + 1) * chunk, static_cast<long long>(rpe));
  return t;
}

// K column sums of the CTA's threads summed over threadIdx.y in shared memory
// and written to part[(ep * gridDim.y + cta) * K + k][d]
template <int V, int K>
__device__ __forceinline__ void write_partials(float (&acc)[K][V], const Cols& t, float* __restrict__ part, int d) {
  extern __shared__ float red[];  // [K][blockDim.y][blockDim.x * V]
  const int width = blockDim.x * V, x = threadIdx.x * V;
  if (blockDim.y > 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) red[(k * blockDim.y + threadIdx.y) * width + x + i] = acc[k][i];
    __syncthreads();
    if (threadIdx.y != 0) return;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float s = 0.f;
        for (int r = 0; r < static_cast<int>(blockDim.y); ++r) s += red[(k * blockDim.y + r) * width + x + i];
        acc[k][i] = s;
      }
  }
  if (t.c >= d) return;
  const long long slot = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) part[(slot * K + k) * d + t.c + i] = acc[k][i];
}

// out = QuickGELU(a + bias) (GELU) or x + (a + bias)
template <typename T, typename TW, int V, bool GELU>
__global__ void __launch_bounds__(kColThreads)
bias_act(const T* __restrict__ x, const T* __restrict__ a, const TW* __restrict__ bias, long long s_bias,
         T* __restrict__ out, int d, int rpe, int chunk) {
  const Cols t = cols(V, rpe, chunk);
  if (t.c >= d) return;
  float bv[V];
  load<TW, V>(bias + blockIdx.z * s_bias + t.c, bv);
#pragma unroll 4
  for (long long r = t.r; r < t.end; r += blockDim.y) {
    const long long o = r * d + t.c;
    float av[V];
    load<T, V>(a + o, av);
    if constexpr (GELU) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float u = av[i] + bv[i];
        av[i] = u * sigmoid_qg(u);
      }
    } else {
      float xv[V];
      load<T, V>(x + o, xv);
#pragma unroll
      for (int i = 0; i < V; ++i) av[i] = xv[i] + (av[i] + bv[i]);
    }
    store<T, V>(out + o, av);
  }
}

// da = g * (s + 1.702 u s (1 - s)), u = a + bias, s = sigmoid(1.702 u); with
// DBIAS the column sums of da as stored
template <typename T, typename TW, int V, bool DBIAS>
__global__ void __launch_bounds__(kColThreads)
gelu_bwd(const T* __restrict__ a, const TW* __restrict__ bias, long long s_bias, const T* __restrict__ g,
         T* __restrict__ da, float* __restrict__ part, int d, int rpe, int chunk) {
  const Cols t = cols(V, rpe, chunk);
  float acc[1][V] = {};
  if (t.c < d) {
    float bv[V];
    load<TW, V>(bias + blockIdx.z * s_bias + t.c, bv);
#pragma unroll 4
    for (long long r = t.r; r < t.end; r += blockDim.y) {
      const long long o = r * d + t.c;
      float av[V], gv[V];
      load<T, V>(a + o, av);
      load<T, V>(g + o, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float u = av[i] + bv[i], s = sigmoid_qg(u);
        av[i] = rounded<T>(gv[i] * (s + 1.702f * u * s * (1.f - s)));
        if constexpr (DBIAS) acc[0][i] += av[i];
      }
      store<T, V>(da + o, av);
    }
  }
  if constexpr (DBIAS) write_partials<V, 1>(acc, t, part, d);
}

// the column sums of g
template <typename T, int V>
__global__ void __launch_bounds__(kColThreads)
colsum(const T* __restrict__ g, float* __restrict__ part, int d, int rpe, int chunk) {
  const Cols t = cols(V, rpe, chunk);
  float acc[1][V] = {};
  if (t.c < d) {
#pragma unroll 4
    for (long long r = t.r; r < t.end; r += blockDim.y) {
      float gv[V];
      load<T, V>(g + r * d + t.c, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[0][i] += gv[i];
    }
  }
  write_partials<V, 1>(acc, t, part, d);
}

// the column sums of g * xhat and g (LayerNorm's weight and bias), and with
// DSUM of dx (the bias added before it)
template <typename T, int V, bool DSUM>
__global__ void __launch_bounds__(kColThreads)
ln_wgrad(const T* __restrict__ y, const T* __restrict__ g, const T* __restrict__ dx, const float* __restrict__ mean,
         const float* __restrict__ rstd, float* __restrict__ part, int d, int rpe, int chunk) {
  constexpr int K = DSUM ? 3 : 2;
  const Cols t = cols(V, rpe, chunk);
  float acc[K][V] = {};
  if (t.c < d) {
#pragma unroll 2
    for (long long r = t.r; r < t.end; r += blockDim.y) {
      const long long o = r * d + t.c;
      const float mu = mean[r], rs = rstd[r];
      float yv[V], gv[V];
      load<T, V>(y + o, yv);
      load<T, V>(g + o, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        acc[0][i] += gv[i] * ((yv[i] - mu) * rs);
        acc[1][i] += gv[i];
      }
      if constexpr (DSUM) {
        float dv[V];
        load<T, V>(dx + o, dv);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[2][i] += dv[i];
      }
    }
  }
  write_partials<V, K>(acc, t, part, d);
}

// o_z[n][col] = sum over m in [n * cred, (n + 1) * cred) of part[(m * k + q0 + z) * d + col], in order
template <typename TW>
__global__ void __launch_bounds__(256)
reduce_parts(const float* __restrict__ part, TW* __restrict__ o0, TW* __restrict__ o1, TW* __restrict__ o2, int d,
             int k, int q0, int cred) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col >= d) return;
  const int n = blockIdx.y, z = blockIdx.z;
  float s = 0.f;
  for (long long m = static_cast<long long>(n) * cred; m < static_cast<long long>(n + 1) * cred; ++m)
    s += part[(m * k + q0 + z) * d + col];
  TW* o = z == 0 ? o0 : z == 1 ? o1 : o2;
  o[static_cast<long long>(n) * d + col] = narrow<TW>(s);
}

// ---------------------------------------------------------------------------
// Dispatch on the C interface's type codes, vector width and row capacity
// ---------------------------------------------------------------------------

template <typename X> struct Tag { using type = X; };

template <typename F>
int with_type(int code, F f) {
  if (code == kBf16) return f(Tag<bf16>{});
  if (code == kFloat) return f(Tag<float>{});
  return kBadArgs;
}

constexpr int kWide = 0;  // E of a row wider than a warp holds: the wide row kernels

// V: 16 bytes of T where `vec`, else 1; E: floats a lane of the row kernels
// (kWide above 2048)
template <typename T, typename F>
int with_width(int vec, int d, F f) {
  constexpr int V16 = 16 / sizeof(T);
  auto with_e = [&](auto ee) {
    return vec ? f(std::integral_constant<int, V16>{}, ee) : f(std::integral_constant<int, 1>{}, ee);
  };
  if (d <= 1024) return with_e(std::integral_constant<int, 32>{});
  if (d <= 2048) return with_e(std::integral_constant<int, 64>{});
  return with_e(std::integral_constant<int, kWide>{});
}

// CTAs of a row kernel: kRowWarps rows a CTA, or one of a wide row
int row_blocks(int rows, int e) { return e == kWide ? rows : (rows + kRowWarps - 1) / kRowWarps; }

bool bad_rows(int rows, int d, int rpe) { return rows < 1 || d < 1 || rpe < 1 || rows % rpe != 0; }

bool bad_cols(int d, int rpe, int n, int bx, int by, int tiles, int ctas, int chunk, int vec, int v16) {
  const int V = vec ? v16 : 1;
  return d < 1 || rpe < 1 || n < 1 || n > 65535 || bx < 1 || by < 1 || bx * by > kColThreads || tiles < 1 ||
         static_cast<long long>(tiles) * bx * V < d || ctas < 1 || ctas > 65535 || chunk < 1 ||
         static_cast<long long>(ctas) * chunk < rpe || (vec && d % v16 != 0);
}

}  // namespace

extern "C" {

// out = LN(x) or, with `a`, y = x + (a + abias) and out = LN(y); mean, rstd [rows] fp32
int rlcf_block_ln_fwd(const void* x, const void* a, const void* abias, long long s_abias, const void* w,
                      long long s_w, const void* b, long long s_b, void* y, void* out, void* mean, void* rstd,
                      int rows, int d, int rpe, float eps, int dt, int wt, int vec, void* stream) {
  if (bad_rows(rows, d, rpe) || (a && (!abias || !y))) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dt, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_type(wt, [&](auto tw) {
      using TW = typename decltype(tw)::type;
      return with_width<T>(vec, d, [&](auto vv, auto ee) {
        constexpr int V = decltype(vv)::value, E = decltype(ee)::value;
        auto args = [&](auto kernel) {
          kernel<<<row_blocks(rows, E), kRowWarps * 32, 0, st>>>(
              static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const TW*>(abias), s_abias,
              static_cast<const TW*>(w), s_w, static_cast<const TW*>(b), s_b, static_cast<T*>(y), static_cast<T*>(out),
              static_cast<float*>(mean), static_cast<float*>(rstd), rows, d, rpe, eps);
        };
        if constexpr (E == kWide) {
          if (a) args(ln_fwd_wide<T, TW, V, true>);
          else args(ln_fwd_wide<T, TW, V, false>);
        } else {
          if (a) args(ln_fwd<T, TW, V, E, true>);
          else args(ln_fwd<T, TW, V, E, false>);
        }
        return static_cast<int>(cudaGetLastError());
      });
    });
  });
}

// dx = LN'(g) (+ gy)
int rlcf_block_ln_bwd(const void* y, const void* g, const void* gy, const void* mean, const void* rstd, const void* w,
                      long long s_w, void* dx, int rows, int d, int rpe, int dt, int wt, int vec, void* stream) {
  if (bad_rows(rows, d, rpe)) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dt, [&](auto tt) {
    using T = typename decltype(tt)::type;
    return with_type(wt, [&](auto tw) {
      using TW = typename decltype(tw)::type;
      return with_width<T>(vec, d, [&](auto vv, auto ee) {
        constexpr int V = decltype(vv)::value, E = decltype(ee)::value;
        auto args = [&](auto kernel) {
          kernel<<<row_blocks(rows, E), kRowWarps * 32, 0, st>>>(
              static_cast<const T*>(y), static_cast<const T*>(g), static_cast<const T*>(gy),
              static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<const TW*>(w), s_w,
              static_cast<T*>(dx), rows, d, rpe);
        };
        if constexpr (E == kWide) {
          if (gy) args(ln_bwd_wide<T, TW, V, true>);
          else args(ln_bwd_wide<T, TW, V, false>);
        } else {
          if (gy) args(ln_bwd<T, TW, V, E, true>);
          else args(ln_bwd<T, TW, V, E, false>);
        }
        return static_cast<int>(cudaGetLastError());
      });
    });
  });
}

// kind 0: out = QuickGELU(a + bias); kind 1: out = x + (a + bias)
int rlcf_block_bias_act(int kind, const void* x, const void* a, const void* bias, long long s_bias, void* out, int d,
                        int rpe, int n, int bx, int by, int tiles, int ctas, int chunk, int dt, int wt, int vec,
                        void* stream) {
  if ((kind != 0 && kind != 1) || (kind == 1 && !x)) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dt, [&](auto tt) {
    using T = typename decltype(tt)::type;
    if (bad_cols(d, rpe, n, bx, by, tiles, ctas, chunk, vec, 16 / sizeof(T))) return kBadArgs;
    return with_type(wt, [&](auto tw) {
      using TW = typename decltype(tw)::type;
      return with_width<T>(vec, 0, [&](auto vv, auto) {
        constexpr int V = decltype(vv)::value;
        auto kernel = kind == 0 ? bias_act<T, TW, V, true> : bias_act<T, TW, V, false>;
        kernel<<<dim3(tiles, ctas, n), dim3(bx, by), 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(a),
                                                              static_cast<const TW*>(bias), s_bias,
                                                              static_cast<T*>(out), d, rpe, chunk);
        return static_cast<int>(cudaGetLastError());
      });
    });
  });
}

// da = g * QuickGELU'(a + bias); with `part`, its column sums [n, ctas, 1, d]
int rlcf_block_gelu_bwd(const void* a, const void* bias, long long s_bias, const void* g, void* da, void* part, int d,
                        int rpe, int n, int bx, int by, int tiles, int ctas, int chunk, int dt, int wt, int vec,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dt, [&](auto tt) {
    using T = typename decltype(tt)::type;
    if (bad_cols(d, rpe, n, bx, by, tiles, ctas, chunk, vec, 16 / sizeof(T))) return kBadArgs;
    return with_type(wt, [&](auto tw) {
      using TW = typename decltype(tw)::type;
      return with_width<T>(vec, 0, [&](auto vv, auto) {
        constexpr int V = decltype(vv)::value;
        const size_t smem = part && by > 1 ? sizeof(float) * by * bx * V : 0;
        auto kernel = part ? gelu_bwd<T, TW, V, true> : gelu_bwd<T, TW, V, false>;
        kernel<<<dim3(tiles, ctas, n), dim3(bx, by), smem, st>>>(
            static_cast<const T*>(a), static_cast<const TW*>(bias), s_bias, static_cast<const T*>(g),
            static_cast<T*>(da), static_cast<float*>(part), d, rpe, chunk);
        return static_cast<int>(cudaGetLastError());
      });
    });
  });
}

// kind 0: the column sums of g [n, ctas, 1, d]; kind 1: of g * xhat and g
// [n, ctas, 2, d]; kind 2: of g * xhat, g and dx [n, ctas, 3, d]
int rlcf_block_col_sums(int kind, const void* g, const void* y, const void* dx, const void* mean, const void* rstd,
                        void* part, int d, int rpe, int n, int bx, int by, int tiles, int ctas, int chunk, int dt,
                        int vec, void* stream) {
  if (kind < 0 || kind > 2 || (kind > 0 && (!y || !mean || !rstd)) || (kind == 2 && !dx)) return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dt, [&](auto tt) {
    using T = typename decltype(tt)::type;
    if (bad_cols(d, rpe, n, bx, by, tiles, ctas, chunk, vec, 16 / sizeof(T))) return kBadArgs;
    return with_width<T>(vec, 0, [&](auto vv, auto) {
      constexpr int V = decltype(vv)::value;
      const dim3 grid(tiles, ctas, n), block(bx, by);
      const size_t smem = by > 1 ? sizeof(float) * (kind + 1) * by * bx * V : 0;
      if (kind == 0) {
        colsum<T, V><<<grid, block, smem, st>>>(static_cast<const T*>(g), static_cast<float*>(part), d, rpe, chunk);
      } else {
        auto kernel = kind == 1 ? ln_wgrad<T, V, false> : ln_wgrad<T, V, true>;
        kernel<<<grid, block, smem, st>>>(static_cast<const T*>(y), static_cast<const T*>(g),
                                          static_cast<const T*>(dx), static_cast<const float*>(mean),
                                          static_cast<const float*>(rstd), static_cast<float*>(part), d, rpe, chunk);
      }
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// o_z [nout, d] (z < nq) = the partials [nout * cred, k, d] of quantity q0 + z summed over cred in order
int rlcf_block_reduce(const void* part, void* o0, void* o1, void* o2, int d, int k, int q0, int nq, int nout,
                      int cred, int wt, void* stream) {
  if (d < 1 || k < 1 || k > 3 || q0 < 0 || nq < 1 || q0 + nq > k || nout < 1 || nout > 65535 || cred < 1 || !o0 ||
      (nq > 1 && !o1) || (nq > 2 && !o2))
    return kBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(wt, [&](auto tw) {
    using TW = typename decltype(tw)::type;
    reduce_parts<TW><<<dim3((d + 255) / 256, nout, nq), 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<TW*>(o0), static_cast<TW*>(o1), static_cast<TW*>(o2), d, k, q0,
        cred);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"

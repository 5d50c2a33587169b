#!/usr/bin/env python3
"""The rate of the TF32 ``wgmma`` shapes the fp32 attention kernels issue, on
one NVIDIA GPU, in isolation: m64nNk8 with A from registers (N = 32, 64) or
from shared memory (N = 32), one or two warpgroups a CTA, one CTA an SM,
batches of 24 on one or two accumulators (a wait after each batch).

    python3 tools/tf32_wgmma_rates.py

Builds a small benchmark kernel on ``rlcf_torch/csrc/attention_tf32.cuh``'s
wrappers into the package's build directory and prints one ``WGMMA`` line a
case: clock cycles a wgmma takes a warpgroup (``clock64``), and TFLOP/s over
the card's 132 SMs (CUDA events).
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from rlcf_torch.ops import cuda_build  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rlcf_torch", "csrc")
CASES = [(32, 1, 0, 1), (32, 2, 0, 1), (64, 1, 0, 1), (64, 2, 0, 1), (32, 1, 0, 2), (32, 2, 0, 2), (64, 1, 0, 2),
         (64, 2, 0, 2), (32, 1, 1, 1), (32, 2, 1, 1), (32, 1, 1, 2), (32, 2, 1, 2)]   # N, chains, A in smem, warpgroups
SOURCE = r'''
#include <cstdio>
#include "attention_tf32.cuh"

template <int N, int CH, int SS, int WG>
__global__ void __launch_bounds__(128 * WG, 1) bench(long long* cycles, int rounds) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(smem)[i] = 0x3f800000u;
  fence_async_proxy();
  __syncthreads();
  SplitA a[8];
  for (int k = 0; k < 8; ++k)
    for (int e = 0; e < 4; ++e) a[k].hi[e] = a[k].lo[e] = 0x3f800000u + threadIdx.x;
  float d[CH][N / 2];
  for (int c = 0; c < CH; ++c)
    for (int e = 0; e < N / 2; ++e) d[c][e] = 0.f;
  const uint32_t b = smem_u32(smem), am = smem_u32(smem + 32768);
  const long long t0 = clock64();
  for (int r = 0; r < rounds; ++r) {
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 24; i += CH) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (SS) wgmma_tf32_ss<32>(d[c], sw_desc(am, i & 7), sw_desc(b, i & 7), 1);
        else wgmma_tf32<N>(d[c], a[i & 7].hi, sw_desc(b, i & 7), 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
  }
  const long long t1 = clock64();
  float acc = 0.f;
  for (int c = 0; c < CH; ++c)
    for (int e = 0; e < N / 2; ++e) acc += d[c][e];
  if (threadIdx.x == 0) cycles[blockIdx.x] = (t1 - t0) + (acc == 12345.f);
}

template <int N, int CH, int SS, int WG>
void run(int sms) {
  long long* cycles;
  cudaMalloc(&cycles, sms * sizeof(long long));
  const int smem = 65536 + 1024, rounds = 2000;
  cudaFuncSetAttribute(bench<N, CH, SS, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bench<N, CH, SS, WG><<<sms, 128 * WG, smem>>>(cycles, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<N, CH, SS, WG><<<sms, 128 * WG, smem>>>(cycles, rounds);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c0;
  cudaMemcpy(&c0, cycles, sizeof(c0), cudaMemcpyDeviceToHost);
  const double flops = double(sms) * WG * rounds * 24.0 * 64 * N * 8 * 2;
  printf("WGMMA m64n%dk8 tf32 A from %s, %d warpgroup(s) a CTA, %d accumulator chain(s): %.2f cycles a wgmma "
         "a warpgroup, %.1f TFLOP/s over %d SMs (%s)\n", N, SS ? "shared memory" : "registers", WG, CH,
         double(c0) / (rounds * 24.0), flops / ms / 1e9, sms, cudaGetErrorString(cudaGetLastError()));
  cudaFree(cycles);
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
CASES
  return 0;
}
'''


def main():
    build = os.path.join(cuda_build.BUILD_DIR, "wgmma_rates")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "wgmma_rates.cu")
    with open(src, "w") as f:
        f.write(SOURCE.replace("CASES", "\n".join(f"  run<{n}, {ch}, {ss}, {wg}>(sms);" for n, ch, ss, wg in CASES)))
    exe = os.path.join(build, "wgmma_rates")
    subprocess.run([cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I", CSRC,
                    "-o", exe, src], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())

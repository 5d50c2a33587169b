#!/usr/bin/env python3
"""Where the fp32 attention backward above T = 257 (``tf32x3_xlong``) spends
its cycles, on one NVIDIA GPU: ``clock64()`` stamps at the phase edges of a
copy of ``rlcf_torch/csrc/attention_bwd_tf32.cu``.

    python3 tools/fp32_xlong_phase_stamps.py

Writes the copy into the package's build directory with a stamp after each
phase of the xlong kernels (for thread 0 of each CTA, and in launch (a) also
for thread 0 of the producer warpgroup), builds it for sm_90a, runs it at
B=6 and B=24 (T=577 H=16, fp32, no mask) and prints one ``STAMPS`` line a
launch and thread: cycles a CTA by phase, summed over the chunks, and their
sum. The stamps cost a few percent of the time; the shares are what they
show. The copy's results are held to the tree's kernel bit for bit.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402
from rlcf_torch.ops import attention as A  # noqa: E402
from rlcf_torch.ops import cuda_build  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "rlcf_torch", "csrc")
STAMP = "{ const long long _t = clock64(); ph[%d] += static_cast<unsigned>(_t - last); last = _t; }"
DECLARE = "unsigned ph[8] = {}; long long last = clock64();"

# (launch, thread, [(anchor in the source, phase name)]): a stamp goes right after each anchor
PHASES = {
    ("a", "consumer"): [
        ("    mbar_wait(bars + 8 * (j & 1), (j >> 1) & 1);\n", "wait for the chunk"),
        ("    wgmma3_pair<kXlChunk, 8>(&s[0][0], qa, krh, krl, &dp[0][0], ga, vrh, vrl, kHalf);\n"
         "    wgmma_commit();\n    wgmma_wait();\n", "S and dP"),
        ("        dd[1] += pb * dp[nt][2 + e];\n      }\n    }\n", "statistics (sweep 1)"),
        ("      dsa[nt] = acc_as_a<true>(s[nt]);\n    }\n", "dS (sweep 2)"),
        ("    wgmma3<64, 4>(&dq[0][0], dsa, kch, kcl, true);  // dq += dS.K\n"
         "    wgmma_commit();\n    wgmma_wait();\n", "dq"),
    ],
    ("a", "producer"): [
        ("      if (i >= 2) mbar_wait(bars + 8 * (2 + b), ((i >> 1) - 1) & 1);  // the consumers are done with use "
         "i - 2\n", "wait for a free buffer"),
        ("      producer_sync();  // every producer thread's part of the chunk has arrived\n", "wait for the chunk"),
        ("      if (i >= nc) split_sw_cols<kXlChunk, true>(buf + 4 * kXlCopy, buf + 5 * kXlCopy, raw, ptid, 128);\n",
         "split"),
        ("      mbar_arrive(bars + 8 * b);\n", "fence, load the next"),
    ],
    ("b", "thread 0"): [
        ("    wgmma3_pair<kXlChunk, 8>(&s[0][0], ka, qrh, qrl, &dpt[0][0], SmemA{vh, vl}, grh, grl, kHalf);\n"
         "    wgmma_commit();\n", "issue S^T and dP^T"),
        ("    split_sw_cols<kXlChunk, true>(buf + 6 * kXlCopy, buf + 7 * kXlCopy, graw, tid, kXkThreads);\n",
         "wait for the chunk, split"),
        ("    if (c + 1 < nc) stage(c + 1);\n", "fence, load the next"),
        ("    wgmma_wait();\n    const int q0 = kXlChunk * c;\n", "wait for S^T and dP^T"),
        ("      dsa[nt] = acc_as_a<true>(dpt[nt]);\n    }\n", "P^T and dS^T"),
        ("    wgmma3_pair<64, 4>(&dv[0][0], pa, gch, gcl, &dk[0][0], dsa, qch, qcl, kSwHalf, true);\n"
         "    wgmma_commit();\n    wgmma_wait();\n", "dv and dk"),
    ],
}


def stamped_source():
    """The tree's source with the stamps, a global of sums and a reader."""
    with open(os.path.join(CSRC, "attention_bwd_tf32.cu")) as f:
        src = f.read()

    def insert(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the source: {anchor!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    src = src.replace('#include "attention_tf32.cuh"\n',
                      '#include "attention_tf32.cuh"\n__device__ unsigned long long g_stamps[3][9];\n', 1)
    for (launch, who), phases in PHASES.items():
        for i, (anchor, name) in enumerate(phases):
            insert(anchor, "    " + STAMP % i + "\n")
    slot = {("a", "consumer"): 0, ("a", "producer"): 1, ("b", "thread 0"): 2}

    def flush(key, cond):
        n = len(PHASES[key])
        return (f"  if ({cond}) {{ for (int i = 0; i < {n}; ++i) atomicAdd(&g_stamps[{slot[key]}][i], ph[i]); "
                f"atomicAdd(&g_stamps[{slot[key]}][8], 1ull); }}\n")

    insert("  const int wg = tid >> 7, row0 = cta0 + 16 * (tid >> 5);  // the warp's rows\n", "  " + DECLARE + "\n")
    insert("  if (row0 < t) {\n    store_rows(dq,", flush(("a", "consumer"), "tid == 0"), after=False)
    insert("    stage(0);\n    for (int i = 0; i < 2 * nc; ++i) {\n", "    " + DECLARE + "\n", after=False)
    insert("      mbar_arrive(bars + 8 * b);\n" + "    " + STAMP % 3 + "\n    }\n",
           flush(("a", "producer"), "ptid == 0"))
    insert("  auto stage = [&](int c) {\n    const int q0 = kXlChunk * c;\n", "  " + DECLARE + "\n", after=False)
    insert("  if (key0 < t) {\n    float* dbase", flush(("b", "thread 0"), "tid == 0"), after=False)
    src = src.replace('extern "C" {', 'extern "C" {\nint rlcf_read_stamps(void* host) {\n'
                      '  cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n'
                      '  unsigned long long z[27] = {};\n  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, z, '
                      'sizeof(z)));\n}\n', 1)
    return src


def main():
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    build = os.path.join(cuda_build.BUILD_DIR, "phase_stamps")
    os.makedirs(build, exist_ok=True)
    for header in ("attention_tf32.cuh", "attention_mma.cuh"):
        with open(os.path.join(CSRC, header)) as f, open(os.path.join(build, header), "w") as g:
            g.write(f.read())
    with open(os.path.join(build, "attention_bwd_tf32.cu"), "w") as f:
        f.write(stamped_source())
    lib_path = os.path.join(build, "libstamps.so")
    subprocess.run([cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, os.path.join(build, "attention_bwd_tf32.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    C.log(smi.stdout.strip())
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.rlcf_mha_bwd_tf32x3_xlong
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cf, vp]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    sums = (ctypes.c_ulonglong * 27)()
    dev = torch.device("cuda")
    for B in (6, 24):
        gen = torch.Generator(device=dev).manual_seed(B)
        qkv = torch.randn(B, 577, 3 * 16 * 64, device=dev, generator=gen)
        g = torch.randn(B, 577, 16 * 64, device=dev, generator=gen)
        out = torch.empty_like(qkv)
        stats = torch.empty(A.xlong_stats_floats(B, 577, 16), device=dev)
        run = lambda: fn(ptr(qkv), ptr(g), vp(0), ptr(stats), ptr(out), B, 577, 16, 0.125,
                         vp(torch.cuda.current_stream().cuda_stream))
        if run() != 0:
            raise RuntimeError("the stamped kernel failed to launch")
        torch.cuda.synchronize()
        if not torch.equal(out, A.launch_bwd(qkv, g, None, 16, 0.125)):
            raise AssertionError("the stamped copy's result differs from the tree's kernel")
        lib.rlcf_read_stamps(sums)
        ms = C.time_ms(run, 5)
        lib.rlcf_read_stamps(sums)
        vals = list(sums)
        for (launch, who), slot in ((("a", "consumer"), 0), (("a", "producer"), 1), (("b", "thread 0"), 2)):
            n = max(vals[slot * 9 + 8], 1)
            named = [(name, vals[slot * 9 + i] / n) for i, (_, name) in enumerate(PHASES[(launch, who)])]
            C.log(f"STAMPS B={B} T=577 H=16 launch ({launch}) {who}: cycles a CTA "
                  + "; ".join(f"{name} {c:.0f}" for name, c in named)
                  + f"; sum {sum(c for _, c in named):.0f} (stamped copy {ms:.4f} ms a call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

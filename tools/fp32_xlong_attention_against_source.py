#!/usr/bin/env python3
"""The port's fp32 attention backward above T = 257 (``tf32x3_xlong``) against
another source of it, timed in turns on one NVIDIA GPU.

    mkdir -p build/other_tf32
    for f in attention_bwd_tf32.cu attention_tf32.cuh attention_mma.cuh; do
        git show <rev>:rlcf_torch/csrc/$f > build/other_tf32/$f; done
    python3 tools/fp32_xlong_attention_against_source.py build/other_tf32

Builds the other directory's ``attention_bwd_tf32.cu`` for sm_90a (with the
headers beside it), holds both sides to the plain version (and each to its
own bits on a second launch), then times each shape other, tree, tree, other
with CUDA events (``chip_smoke.time_ms``): encoder TTA of ViT-L/14@336px's
step (B=6 T=577 H=16), B=24 at T=577, and U1's causal B=24 H=16 at T=384 and
512, all fp32. Then one fp32 encoder-336 episode (ViT-L/14@336px at 336 px,
one image's views built beforehand) on each side in the same order: ms/img
over two episodes and one episode's device busy time. The kernels below
T = 258 and the forward stay the tree's on both sides. Prints one
``AB_FP32_XLONG`` line a side and shape.
"""

import concurrent.futures
import ctypes
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402
from rlcf_torch.models.layers import causal_mask  # noqa: E402
from rlcf_torch.ops import attention as A  # noqa: E402
from rlcf_torch.ops import cuda_build  # noqa: E402

SHAPES = (("encoder 336 step", 6, 577, False), ("T577", 24, 577, False), ("U1", 24, 384, True),
          ("U1", 24, 512, True))
HEADS = 16


def build_other(src_dir):
    """``src_dir/attention_bwd_tf32.cu`` into ``_build/libother_attention_bwd_tf32.so``."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(cuda_build.BUILD_DIR, "libother_attention_bwd_tf32.so")
    subprocess.run([cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, os.path.join(src_dir, "attention_bwd_tf32.cu")], check=True)
    return ctypes.CDLL(lib)


def other_launch(lib):
    """A launch_bwd replacement that runs the other source's fp32 xlong
    kernel (the same C interface and statistics scratch) above T = 257 and
    the tree's kernels elsewhere."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.rlcf_mha_bwd_tf32x3_xlong
    fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cf, vp]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    tree_bwd = A.launch_bwd

    def bwd(qkv, g, mask, heads, scale):
        if qkv.dtype != torch.float32 or A.backward_variant(qkv.shape[1], qkv.dtype) != "tf32x3_xlong":
            return tree_bwd(qkv, g, mask, heads, scale)
        qkv, g, mask = qkv.contiguous(), g.contiguous(), A.prep_mask(mask)
        B, T, _ = qkv.shape
        out = torch.empty_like(qkv)
        stats = torch.empty(A.xlong_stats_floats(B, T, heads), device=qkv.device)
        rc = fn(ptr(qkv), ptr(g), ptr(mask), ptr(stats), ptr(out), B, T, heads, scale,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"the other backward kernel failed to launch ({rc})")
        return out

    return bwd


def ab_kernel(sides, label, B, T, causal):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B * 1000 + T)
    qkv = torch.randn(B, T, 3 * HEADS * 64, device=dev, generator=gen)
    g = torch.randn(B, T, HEADS * 64, device=dev, generator=gen)
    mask = causal_mask(T, dev) if causal else None
    scale = 1.0 / math.sqrt(64)
    want = A.fused_attention_reference_bwd(qkv, g, mask, HEADS, scale)
    calls = {side: (lambda f=f: f(qkv, g, mask, HEADS, scale)) for side, f in sides.items()}
    what = f"bwd {label} B={B} T={T} H={HEADS} fp32 {'causal' if causal else 'unmasked'}"
    errs = {}
    for side, call in calls.items():
        got, again = call(), call()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{side} {what}: two launches differ")
        errs[side] = C.assert_close(got, want, torch.float32, "bwd", f"{side} {what}")[0]
    ms = {side: [] for side in sides}
    for side in ("other", "tree", "tree", "other"):
        ms[side].append(C.time_ms(calls[side], 5, rounds=3))
    for side in sides:
        C.log(f"AB_FP32_XLONG {side} {what}: ms {', '.join(f'{x:.4f}' for x in ms[side])} "
              f"(mean {sum(ms[side]) / 2:.4f}); max_abs_err {errs[side]:.3e} against the plain version")


def ab_episode(sides):
    from torch.profiler import ProfilerActivity, profile

    from rlcf_torch.cli import tune_cls
    from rlcf_torch.data.class_names import get_classnames

    out_dir = os.path.join(cuda_build.BUILD_DIR, "fp32_xlong_attention_against_source")
    argv = C.encoder_argv(out_dir, precision="fp32", arch=C.POLICY336, res=C.RES336)
    clf, _, _ = tune_cls.build(tune_cls.get_args(argv))
    clf.setup(get_classnames("A"))
    views = C.encoder_views(C.RES336)
    episode = lambda: clf.adapt(views)[0].float().cpu()
    results = {side: {"ms": [], "busy": []} for side in sides}
    try:
        for side in ("other", "tree", "tree", "other"):
            A.launch_bwd = sides[side]
            episode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                episode()
            results[side]["ms"].append((time.perf_counter() - t0) / 2 * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                episode()
            results[side]["busy"].append(sum(e.device_time for e in C.device_events(prof)) / 1e3)
    finally:
        A.launch_bwd = sides["tree"]
    for side, r in results.items():
        C.log(f"AB_FP32_XLONG {side} encoder 336 episode (fp32, views pre-built): ms/img "
              f"{', '.join(f'{x:.1f}' for x in r['ms'])}; device busy ms {', '.join(f'{x:.1f}' for x in r['busy'])}")


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    src_dir = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    C.log(smi.stdout.strip())
    with concurrent.futures.ThreadPoolExecutor(2) as pool:   # both sides' nvcc together
        tree = pool.submit(A.build_bwd_tf32, force=True)
        lib = build_other(src_dir)
        tree.result()
    for line in cuda_build.PTXAS["rlcf_attention_bwd_tf32"].splitlines():
        if "registers" in line or "spill" in line or "Performance" in line or "Compiling entry" in line:
            C.log("PTXAS rlcf_attention_bwd_tf32: " + line.strip())
    sides = {"other": other_launch(lib), "tree": A.launch_bwd}
    for shape in SHAPES:
        ab_kernel(sides, *shape)
    ab_episode(sides)
    return 0


if __name__ == "__main__":
    sys.exit(main())

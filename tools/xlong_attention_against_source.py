#!/usr/bin/env python3
"""The port's bf16 attention kernels against another source of them, timed in
turns on one NVIDIA GPU.

    mkdir -p build/other_attention
    for f in attention_mma.cu attention_bwd_mma.cu attention_mma.cuh; do
        git show <rev>:rlcf_torch/csrc/$f > build/other_attention/$f; done
    python3 tools/xlong_attention_against_source.py build/other_attention

Builds the other directory's ``attention_mma.cu`` and ``attention_bwd_mma.cu``
for sm_90a (each with the header beside it), holds both sides to the plain
version on every shape, then times each shape other, tree, tree, other with
CUDA events (``chip_smoke.time_ms``): the forward above T = 257 at the main
paths' shapes (the reward ensemble's and zero-shot's ViT-L/14@336px, encoder
TTA of it: B=64, 6, 1; T=577 H=16) and U1's (causal, B=24 H=16, T=384 and
512), the backward at B=6 and 24 (T=577 H=16) and U1's, and the T <= 257
kernels at their main-path shapes. Then one encoder-336 episode (ViT-L/14@336px
at 336 px, one image's views built beforehand) on each side in the same order:
ms/img over three episodes and one episode's device busy time. Prints one
``AB_XLONG`` line a side and shape.
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

SOURCES = ("attention_mma", "attention_bwd_mma")


def build_other(src_dir):
    """Both sources of ``src_dir`` into ``_build/libother_*.so``, one nvcc each, together."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)

    def one(name):
        lib = os.path.join(cuda_build.BUILD_DIR, f"libother_{name}.so")
        subprocess.run([cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", lib, os.path.join(src_dir, f"{name}.cu")], check=True)
        return ctypes.CDLL(lib)

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(zip(SOURCES, pool.map(one, SOURCES)))


def other_launches(libs, src_dir):
    """launch_fwd / launch_bwd replacements that run the other source's bf16
    kernels (the same routing by T); fp32 stays on the tree's."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd_lib, bwd_lib = libs["attention_mma"], libs["attention_bwd_mma"]
    with open(os.path.join(src_dir, "attention_bwd_mma.cu")) as f:   # which C interface the xlong backward has
        xlong_classes = "void* tile_classes, void* stats" in f.read()
    for v in ("short", "long", "xlong"):
        getattr(fwd_lib, f"rlcf_mha_fwd_mma_{v}").argtypes = [vp, vp, vp, ci, ci, ci, cf, vp]
    bwd_scratch = {"short": 0, "long": 1, "xlong": 2 if xlong_classes else 1}
    for v, n in bwd_scratch.items():
        getattr(bwd_lib, f"rlcf_mha_bwd_mma_{v}").argtypes = [vp, vp, vp, *[vp] * n, vp, ci, ci, ci, cf, vp]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    tree_fwd, tree_bwd = A.launch_fwd, A.launch_bwd

    def fwd(qkv, mask, heads, scale):
        if qkv.dtype != torch.bfloat16:
            return tree_fwd(qkv, mask, heads, scale)
        qkv, mask = qkv.contiguous(), A.prep_mask(mask)
        B, T, _ = qkv.shape
        out = torch.empty(B, T, qkv.shape[2] // 3, dtype=qkv.dtype, device=qkv.device)
        fn = getattr(fwd_lib, f"rlcf_mha_fwd_{A.forward_variant(T, qkv.dtype)}")
        if fn(ptr(qkv), ptr(mask), ptr(out), B, T, heads, scale, stream()) != 0:
            raise RuntimeError("the other forward kernel failed to launch")
        return out

    def bwd(qkv, g, mask, heads, scale):
        if qkv.dtype != torch.bfloat16:
            return tree_bwd(qkv, g, mask, heads, scale)
        qkv, g, mask = qkv.contiguous(), g.to(qkv.dtype).contiguous(), A.prep_mask(mask)
        B, T, _ = qkv.shape
        out = torch.empty_like(qkv)
        variant = A.backward_variant(T, qkv.dtype)
        scratch = []
        if variant == "mma_long" or (variant == "mma_xlong" and xlong_classes):
            scratch.append(None if mask is None else torch.empty(A.tile_classes_bytes(T), dtype=torch.uint8,
                                                                 device=qkv.device))
        if variant == "mma_xlong":
            scratch.append(torch.empty(A.xlong_stats_floats(B, T, heads), device=qkv.device))
        fn = getattr(bwd_lib, f"rlcf_mha_bwd_{variant}")
        if fn(ptr(qkv), ptr(g), ptr(mask), *map(ptr, scratch), ptr(out), B, T, heads, scale, stream()) != 0:
            raise RuntimeError("the other backward kernel failed to launch")
        return out

    return fwd, bwd


def shapes(t_text):
    """(direction, label, B, T, H, causal): the xlong kernels' shapes, then the T <= 257 kernels'."""
    return [("fwd", "ensemble reward 336", 24, 577, 16, False), ("fwd", "zero-shot 336", 16, 577, 16, False),
            ("fwd", "encoder 336 select", 64, 577, 16, False), ("fwd", "encoder 336 step", 6, 577, 16, False),
            ("fwd", "encoder 336 final", 1, 577, 16, False), ("fwd", "U1", 24, 384, 16, True),
            ("fwd", "U1", 24, 512, 16, True),
            ("bwd", "encoder 336 step", 6, 577, 16, False), ("bwd", "T577", 24, 577, 16, False),
            ("bwd", "U1", 24, 384, 16, True), ("bwd", "U1", 24, 512, 16, True),
            ("fwd", "policy", 256, 197, 12, False), ("fwd", "reward", 24, 257, 16, False),
            ("fwd", "text", 800, t_text, 8, True),
            ("bwd", "T257", 24, 257, 16, False), ("bwd", "T197", 24, 197, 12, False),
            ("bwd", "encoder step", 6, 197, 12, False), ("bwd", "U1", 24, 256, 16, True),
            ("bwd", "text", 800, t_text, 8, True)]


def ab_kernel(sides, direction, label, B, T, H, causal):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B * 1000 + T)
    qkv = torch.randn(B, T, 3 * H * 64, device=dev, generator=gen).to(torch.bfloat16)
    g = torch.randn(B, T, H * 64, device=dev, generator=gen).to(torch.bfloat16)
    mask = causal_mask(T, dev) if causal else None
    scale = 1.0 / math.sqrt(64)
    if direction == "fwd":
        want = A.fused_attention_reference(qkv, mask, H, scale)
        calls = {side: (lambda f=f: f(qkv, mask, H, scale)) for side, (f, _) in sides.items()}
    else:
        want = A.fused_attention_reference_bwd(qkv, g, mask, H, scale)
        calls = {side: (lambda f=f: f(qkv, g, mask, H, scale)) for side, (_, f) in sides.items()}
    what = f"{direction} {label} B={B} T={T} H={H} {'causal' if causal else 'unmasked'}"
    errs = {}
    for side, call in calls.items():
        got, again = call(), call()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{side} {what}: two launches differ")
        errs[side] = C.assert_close(got, want, torch.bfloat16, direction, f"{side} {what}")[0]
    reps = 5 if B * T * T > 5_000_000 else 20
    ms = {side: [] for side in sides}
    for side in ("other", "tree", "tree", "other"):
        ms[side].append(C.time_ms(calls[side], reps, rounds=3))
    for side in sides:
        C.log(f"AB_XLONG {side} {what}: ms {', '.join(f'{x:.4f}' for x in ms[side])} "
              f"(mean {sum(ms[side]) / 2:.4f}); max_abs_err {errs[side]:.3e} against the plain version")


def ab_episode(sides):
    from rlcf_torch.cli import tune_cls
    from rlcf_torch.data.class_names import get_classnames

    out_dir = os.path.join(cuda_build.BUILD_DIR, "xlong_attention_against_source")
    clf, _, _ = tune_cls.build(tune_cls.get_args(C.encoder_argv(out_dir, arch=C.POLICY336, res=C.RES336)))
    clf.setup(get_classnames("A"))
    views = C.encoder_views(C.RES336)
    episode = lambda: clf.adapt(views)[0].float().cpu()
    from torch.profiler import ProfilerActivity, profile

    results = {side: {"ms": [], "busy": []} for side in sides}
    try:
        for side in ("other", "tree", "tree", "other"):
            A.launch_fwd, A.launch_bwd = sides[side]
            episode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                episode()
            results[side]["ms"].append((time.perf_counter() - t0) / 3 * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                episode()
            results[side]["busy"].append(sum(e.device_time for e in C.device_events(prof)) / 1e3)
    finally:
        A.launch_fwd, A.launch_bwd = sides["tree"]
    for side, r in results.items():
        C.log(f"AB_XLONG {side} encoder 336 episode (bf16, views pre-built): ms/img "
              f"{', '.join(f'{x:.1f}' for x in r['ms'])}; device busy ms {', '.join(f'{x:.1f}' for x in r['busy'])}")


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from rlcf_torch.data.class_names import get_classnames

    src_dir = sys.argv[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    C.log(smi.stdout.strip())
    with concurrent.futures.ThreadPoolExecutor(3) as pool:   # the tree's two sources beside the other's
        tree = [pool.submit(A.build_mma, force=True), pool.submit(A.build_bwd_mma, force=True)]
        libs = build_other(src_dir)
        for f in tree:
            f.result()
    for name in ("rlcf_attention_mma", "rlcf_attention_bwd_mma"):
        for line in cuda_build.PTXAS[name].splitlines():
            if "registers" in line or "spill" in line or "Performance" in line or "Compiling entry" in line:
                C.log(f"PTXAS {name}: " + line.strip())
    sides = {"other": other_launches(libs, src_dir), "tree": (A.launch_fwd, A.launch_bwd)}
    for shape in shapes(C.text_seq_len(get_classnames("A"))):
        ab_kernel(sides, *shape)
    ab_episode(sides)
    return 0


if __name__ == "__main__":
    sys.exit(main())

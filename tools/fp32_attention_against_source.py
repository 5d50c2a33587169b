#!/usr/bin/env python3
"""The fp32 flagship end to end with the port's fp32 attention kernels against
an fp32 attention source with the C interface of the CUDA-core kernels
(``rlcf_mha_fwd`` / ``rlcf_mha_bwd`` with a dtype code, as
``rlcf_torch/csrc/attention.cu`` had it before the split-TF32 kernels), timed
in turns on one NVIDIA GPU.

    git show <rev>:rlcf_torch/csrc/attention.cu > build/other_attention.cu
    python3 tools/fp32_attention_against_source.py build/other_attention.cu

Builds the other source for sm_90a, then, other, tree, tree, other: the fp32
episode on one pre-built group (ms/img over three episodes) and the fp32
``--viewgen fused`` CLI over 12 images (img/s of the two groups after the
first), at the widths and seed of ``chip_smoke.py``. Prints one
``AB_FLAGSHIP`` line for each side.
"""

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402
from rlcf_torch.cli import tta_cls  # noqa: E402
from rlcf_torch.data.class_names import get_classnames  # noqa: E402
from rlcf_torch.data.datasets import SyntheticDataset  # noqa: E402
from rlcf_torch.ops import attention as A  # noqa: E402
from rlcf_torch.ops import cuda_build  # noqa: E402
from rlcf_torch.ops.augmix import fused_views  # noqa: E402


def load_other(src):
    lib_path = os.path.join(cuda_build.BUILD_DIR, "libother_attention.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    subprocess.run([cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rlcf_mha_fwd.argtypes = [vp, vp, vp, ci, ci, ci, cf, ci, vp]
    lib.rlcf_mha_bwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, cf, ci, vp]
    return lib


def other_launches(lib):
    """launch_fwd / launch_bwd replacements running the other source (fp32 only)."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def fwd(qkv, mask, heads, scale):
        qkv, mask = qkv.contiguous(), A.prep_mask(mask)
        out = torch.empty(*qkv.shape[:2], qkv.shape[2] // 3, device=qkv.device)
        rc = lib.rlcf_mha_fwd(ptr(qkv), ptr(mask), ptr(out), qkv.shape[0], qkv.shape[1], heads, scale, 0, stream())
        if rc != 0:
            raise RuntimeError(f"the other forward kernel failed to launch ({rc})")
        return out

    def bwd(qkv, g, mask, heads, scale):
        qkv, g, mask = qkv.contiguous(), g.contiguous().float(), A.prep_mask(mask)
        out = torch.empty_like(qkv)
        rc = lib.rlcf_mha_bwd(ptr(qkv), ptr(g), ptr(mask), ptr(out), qkv.shape[0], qkv.shape[1], heads, scale, 0,
                              stream())
        if rc != 0:
            raise RuntimeError(f"the other backward kernel failed to launch ({rc})")
        return out

    return fwd, bwd


def main():
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sides = {"other": other_launches(load_other(sys.argv[1])), "tree": (A.launch_fwd, A.launch_bwd)}
    imgs = np.stack([SyntheticDataset(n=C.GROUP, n_classes=200)[i][0] for i in range(C.GROUP)])
    planar = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()).cuda()
    toks = fused_views(planar, torch.Generator(device="cuda").manual_seed(0), n_views=C.VIEWS, resolution=C.RES,
                       src_size=C.SRC_SIZE, p_policy=16, p_reward=14)
    out_dir = os.path.join(cuda_build.BUILD_DIR, "fp32_attention_against_source")
    clf, _, _ = tta_cls.build(tta_cls.get_args(C.flagship_argv(out_dir, precision="fp32")))
    clf.setup(get_classnames("A"))
    episode = lambda: clf.adapt_tokens(*toks)[0].float().cpu()
    results = {side: {"episode_ms_per_img": [], "img_per_s": []} for side in sides}
    try:
        for side in ("other", "tree", "tree", "other"):
            A.launch_fwd, A.launch_bwd = sides[side]
            episode()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                episode()
            results[side]["episode_ms_per_img"].append((time.perf_counter() - t0) / 3 / C.GROUP * 1e3)
            secs = tta_cls.main(C.flagship_argv(out_dir, precision="fp32", limit=12))["synthetic"]["group_seconds"][1:]
            results[side]["img_per_s"].append(C.GROUP * len(secs) / sum(secs))
    finally:
        A.launch_fwd, A.launch_bwd = sides["tree"]
    for side, r in results.items():
        print(f"AB_FLAGSHIP fp32 {side} attention kernels: episode ms/img "
              f"{', '.join(f'{x:.2f}' for x in r['episode_ms_per_img'])}; --viewgen fused img/s (12 images, 2 timed "
              f"groups) {', '.join(f'{x:.3f}' for x in r['img_per_s'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

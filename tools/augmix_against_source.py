#!/usr/bin/env python3
"""The port's AugMix kernel against another build of the same C interface,
bit for bit and timed in turns, on one NVIDIA GPU.

    git show <rev>:rlcf_torch/csrc/augmix.cu > build/other_augmix.cu
    python3 tools/augmix_against_source.py build/other_augmix.cu

Builds the other source as ``rlcf_torch/ops/cuda_build.py`` builds the tree's
(sm_90a, ``-fmad=false``), then on flagship groups (N=4, V=64, S=256, R=224,
four seeds, augmix on and off), every op alone at the identity crop (R=64
and 224, severities 1 and 2), the shapes of ``tests/test_torch_cuda.py`` and
rotate at every step, prints the count of pixels where the two kernels
differ, and where each differs from the plain version (``CMP`` lines); then
times both at a flagship group, other, tree, tree, other (``TIME`` lines: the
sampled mix and the crop alone), and prints the tree's ``AUGMIX_PHASES``
line. The other kernel is given a scratch buffer of N*V*3*R*R float32 (what
the first design needed; larger than the present one needs). Exits 1 if any
pixel differs.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from rlcf_torch.ops import augmix as X  # noqa: E402
from rlcf_torch.ops import cuda_build  # noqa: E402


def build_other(src):
    so = os.path.join(cuda_build.BUILD_DIR, "lib" + os.path.basename(src).removesuffix(".cu") + "_other.so")
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    res = subprocess.run([cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                          "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v", "-o", so, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src}:\n{res.stderr[-4000:]}")
    print("PTXAS other:", " ".join(l.strip() for l in res.stderr.splitlines() if "registers" in l or "spill" in l))
    lib = ctypes.CDLL(os.path.abspath(so))
    lib.rlcf_augmix_views.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def launch_other(lib, imgs, params, basew, R, S, V, shifts):
    N = imgs.shape[0]
    out = torch.empty((N, V, 3, R, R), dtype=torch.uint8, device=imgs.device)
    scratch = torch.empty((N * V * 3, R * R), dtype=torch.float32, device=imgs.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = lib.rlcf_augmix_views(ptr(imgs), ptr(basew), *(ptr(params[k]) for k in X.PARAM_FIELDS), ptr(out),
                               ptr(scratch), N, V, R, S, *(int(s) for s in shifts),
                               ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    return out if rc == 0 else None   # None: the other kernel refuses the shape


def cases(dev):
    for seed in range(4):
        imgs = torch.randint(0, 256, (4, 3, 256, 256), generator=torch.Generator(device=dev).manual_seed(100 + seed),
                             device=dev, dtype=torch.uint8)
        for augmix in (True, False):
            p = X.sample_view_params(torch.Generator(device=dev).manual_seed(seed), 4, 64, 256, 224, augmix=augmix,
                                     device=dev)
            yield (f"flagship seed {seed} augmix {augmix}", imgs, X.flatten_params(p), 256, 224, 64, 1.0)
    for R in (64, 224):
        for severity in (1.0, 2.0):
            ops = [op for op in range(9) for _ in range(4)]
            p = X.single_op_params(torch.Generator(device=dev).manual_seed(int(severity)), ops, R, severity, device=dev)
            imgs = torch.randint(0, 256, (1, 3, R, R), device=dev, dtype=torch.uint8)
            yield (f"single ops R={R} severity {severity:g}", imgs, p, R, R, len(ops) + 1, severity)
    for N, V, S, R, severity in ((1, 8, 256, 224, 1.0), (2, 4, 64, 32, 1.0), (2, 8, 255, 223, 1.0),
                                 (2, 8, 48, 32, 2.0), (3, 5, 320, 300, 1.0)):
        imgs = torch.randint(0, 256, (N, 3, S, S), device=dev, dtype=torch.uint8)
        p = X.sample_view_params(torch.Generator(device=dev).manual_seed(7), N, V, S, R, severity=severity, device=dev)
        yield (f"N={N} V={V} S={S} R={R} severity {severity:g}", imgs, X.flatten_params(p), S, R, V, severity)
    for severity in (1.0, 2.0):
        r = X.draw_view_randoms(torch.Generator(device=dev).manual_seed(3), 2, 16, device=dev)
        r["op_idx"][:] = 3
        r["depths"][:] = 3
        p = X.derive_view_params(r, src_size=64, resolution=64, severity=severity)
        p["rrc"][:, 1:] = torch.tensor([0.0, 0.0, 64.0, 64.0], device=dev)
        p["flip"][:, 1:] = 0
        imgs = torch.randint(0, 256, (2, 3, 64, 64), device=dev, dtype=torch.uint8)
        yield (f"rotate at every step R=S=64 severity {severity:g}", imgs, X.flatten_params(p), 64, 64, 16, severity)


def main():
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    other = build_other(sys.argv[1])
    X.build(force=True)
    print("PTXAS tree:", " ".join(l.strip() for l in cuda_build.PTXAS["rlcf_augmix"].splitlines()
                                  if "registers" in l or "spill" in l))
    differ = 0
    for label, imgs, p, S, R, V, severity in cases(dev):
        basew, shifts = X.bicubic_matrix(S, R, device=dev), X.op_shift_bounds(severity, R)
        tree, again = X.launch_views(imgs, p, basew, R, S, V, shifts), X.launch_views(imgs, p, basew, R, S, V, shifts)
        theirs = launch_other(other, imgs, p, basew, R, S, V, shifts)
        torch.cuda.synchronize()
        plain = X.augmix_views_reference(imgs, p, basew, R, S, V, shifts)
        count = lambda a, b: "refused" if a is None or b is None else int((a != b).sum())
        n = count(tree, theirs)
        differ += n if isinstance(n, int) else 0
        print(f"CMP {label}: tree vs other {n}, tree vs plain {count(tree, plain)}, other vs plain "
              f"{count(theirs, plain)} unequal pixels of {tree.numel()}; tree repeats equal {torch.equal(tree, again)}",
              flush=True)
        differ += 0 if torch.equal(tree, again) else 1
    print(f"CMP total unequal pixels, tree vs other: {differ}")

    imgs = torch.randint(0, 256, (4, 3, 256, 256), generator=torch.Generator(device=dev).manual_seed(1234),
                         device=dev, dtype=torch.uint8)
    basew, shifts = X.bicubic_matrix(256, 224, device=dev), X.op_shift_bounds(1.0, 224)
    sampled = {aug: X.flatten_params(X.sample_view_params(torch.Generator(device=dev).manual_seed(0), 4, 64, 256, 224,
                                                          augmix=aug, device=dev)) for aug in (True, False)}
    for who in ("other", "tree", "tree", "other"):
        ms = {}
        for aug, p in sampled.items():
            if who == "tree":
                fn = lambda: X.launch_views(imgs, p, basew, 224, 256, 64, shifts)
            else:
                fn = lambda: launch_other(other, imgs, p, basew, 224, 256, 64, shifts)
            ms[aug] = chip_smoke.time_ms(fn, reps=20, rounds=3)
        print(f"TIME {who}: sampled mix {ms[True]:.4f} ms, crop only {ms[False]:.4f} ms per flagship group", flush=True)
    chip_smoke.augmix_phases(imgs, basew, shifts)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

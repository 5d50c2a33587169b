#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # every phase; exits 0 only if all pass

Phases, each fatal:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from the checkout (nvcc, sm_90a) and the
     host view pipeline (g++);
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes, bf16 and fp32, and time kernel, plain version and the PyTorch
     library call (scaled_dot_product_attention) with CUDA events;
  4. drive the flagship RLCF prompt TTA through the port's CLI at full width
     (ViT-B/16 policy, ViT-L/14 reward, random weights from a seed, ImageNet-A's
     200 class names on synthetic images, 64 views, group 4, 3 steps), with the
     launch counters set to 0 just before and read just after; then time the
     episode with views pre-built and hold the fused-attention episode to the
     dense one in fp32 on one group;
  5. print the kernels line, then the device line last.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                                       # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense bf16 tensor cores; fp32 CUDA cores
POLICY, REWARD = "ViT-B/16", "ViT-L/14"
GROUP, VIEWS, STEPS = 4, 64, 3
TOL = {  # |kernel - plain| <= atol + rtol * |plain|: fp32 = summation order; bf16 = one output rounding
    (torch.float32, "fwd"): (1e-5, 1e-5), (torch.float32, "bwd"): (1e-4, 1e-4),
    (torch.bfloat16, "fwd"): (1e-2, 2**-7), (torch.bfloat16, "bwd"): (1e-2, 2**-7),
}
REPLACES = {"fwd": "rlcf_tpu/ops/pallas_attention.py:65", "bwd": "rlcf_tpu/ops/pallas_attention.py:89"}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Mean ms per call by CUDA events over ``reps`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def text_seq_len(classnames):
    """The text tower's sequence length on the main path (prompt truncation)."""
    from rlcf_torch.tokenizer import tokenize
    from rlcf_torch.data.class_names import assemble_prompts

    eot = tokenize(assemble_prompts(classnames)).argmax(axis=-1)
    return min(77, -(-(int(eot.max()) + 1) // 8) * 8)


def check_kernel(direction, B, T, H, dtype, masked, label):
    """Kernel vs plain version on one shape; returns the kernels-line entry."""
    from rlcf_torch.models.layers import causal_mask
    from rlcf_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B * 1000 + T)
    D, scale = A.HEAD_DIM, 1.0 / math.sqrt(A.HEAD_DIM)
    qkv = torch.randn(B, T, 3 * H * D, device=dev, generator=gen).to(dtype)
    g = torch.randn(B, T, H * D, device=dev, generator=gen).to(dtype)
    mask = causal_mask(T, dev) if masked else None
    if direction == "fwd":
        kernel = lambda: A.launch_fwd(qkv, mask, H, scale)
        plain = lambda: A.fused_attention_reference(qkv, mask, H, scale)
    else:
        kernel = lambda: A.launch_bwd(qkv, g, mask, H, scale)
        plain = lambda: A.fused_attention_reference_bwd(qkv, g, mask, H, scale)
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = (got.float() - want.float()).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.float().abs().clamp_min(1e-6)).max())
    atol, rtol = TOL[(dtype, direction)]
    if not bool(torch.isfinite(got).all()) or bool((err > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"{label}: kernel disagrees with its plain version (max abs {max_abs:.3e}, "
                             f"tolerance {atol} + {rtol}*|plain|)")

    # the library yardstick: one scaled_dot_product_attention call (backward:
    # one autograd call through it) on the same q, k, v and mask
    split = lambda t: t.reshape(B, T, H, D).transpose(1, 2).contiguous()
    q, k, v = (split(t) for t in qkv.split(H * D, dim=-1))
    lib_mask = A.prep_mask(mask).to(dtype) if masked else None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if direction == "fwd":
        library = lambda: sdpa(q, k, v, attn_mask=lib_mask, scale=scale)
    else:
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        out = sdpa(q, k, v, attn_mask=lib_mask, scale=scale)
        gh = split(g)
        library = lambda: torch.autograd.grad(out, (q, k, v), gh, retain_graph=True)
    reps = 5 if B * T * T > 5_000_000 else 20
    ms, plain_ms, library_ms = time_ms(kernel, reps), time_ms(plain, reps), time_ms(library, reps)

    # least time for the same work: each input read once, each output written
    # once; the operations this data needs (score entries the mask keeps)
    size = torch.finfo(dtype).bits // 8
    kept = T * T if mask is None else int((A.prep_mask(mask) > A.NEG_BIG).sum())
    mask_bytes = 0 if mask is None else T * T * 4
    if direction == "fwd":
        nbytes = B * T * 3 * H * D * size + B * T * H * D * size + mask_bytes
        flops = 4 * B * H * D * kept            # S = QK^T, O = PV
    else:
        nbytes = B * T * 3 * H * D * size * 2 + B * T * H * D * size + mask_bytes
        flops = 10 * B * H * D * kept           # S, dP, dV, dQ, dK
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    log(f"KERNEL mha_{direction}[{label}]: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(tolerance {atol} + {rtol:.3g}*|plain|) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
        f"(bytes {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, ops {flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms)")
    return {"name": f"mha_{direction}[{label}]", "route": "cuda", "source": "rlcf_torch/csrc/attention.cu",
            "replaces": REPLACES[direction], "shape": [direction, B, T, H, str(dtype)], "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def flagship_argv(out_dir, precision="bf16", limit=16):
    return [".", "--test_sets", "synthetic", "--synthetic_classes", "A", "--limit", str(limit),
            "--arch", POLICY, "--reward_arch", REWARD, "--precision", precision, "--device", "cuda",
            "--viewgen", "native", "--batch_size", str(VIEWS), "--selection_p", "0.1", "--sample_k", "3",
            "--tta_steps", str(STEPS), "--lr", "7e-3", "--ctx_init", "a_photo_of_a",
            "--episode_group", str(GROUP), "--seed", "0", "--output", out_dir]


def run_flagship(out_dir):
    """Phase 4a: the main path through the CLI; returns its numbers."""
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.ops import attention as A
    from rlcf_torch.tasks.classification import PromptTTAClassifier

    seen = []
    adapt = PromptTTAClassifier.adapt_tokens

    def recording(self, tokens):
        logits, aux = adapt(self, tokens)
        seen.append((logits.detach(), aux["losses"].detach()))
        return logits, aux

    PromptTTAClassifier.adapt_tokens = recording
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()                 # counts start at 0 just before the main path
    try:
        t0 = time.perf_counter()
        results = tta_cls.main(flagship_argv(out_dir))
        wall = time.perf_counter() - t0
    finally:
        PromptTTAClassifier.adapt_tokens = adapt
    launches, by_shape = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES)  # read just after
    for logits, losses in seen:
        if tuple(logits.shape) != (GROUP, 200) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"flagship logits {tuple(logits.shape)} not finite [{GROUP}, 200]")
        if tuple(losses.shape) != (GROUP, STEPS) or not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"flagship losses {tuple(losses.shape)} not finite [{GROUP}, {STEPS}]")
    if len(seen) < 2 or launches["fwd"] == 0 or launches["bwd"] == 0:
        raise AssertionError(f"main path did not go through the kernels: groups={len(seen)} launches={launches}")
    secs = results["synthetic"]["group_seconds"]
    timed = secs[1:]  # the first group warms up
    return {"groups": len(secs), "group_seconds": secs, "img_per_s": GROUP * len(timed) / sum(timed),
            "wall_s": wall, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()},
            "top1": results["synthetic"]["top1"]}


def profile_episode(ep):
    """Device busy share of one episode group and its costliest kernels
    (torch.profiler; CUPTI sees the ctypes-launched kernels too)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ep()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"PROFILE {t:9.3f} ms {n:5d} launches  {name[:110]}")
    log(f"PROFILE episode group: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"{len(kernels)} kernels, idle share {1 - busy_ms / wall_ms:.3f}")
    return {"profile_wall_ms": wall_ms, "profile_device_busy_ms": busy_ms, "profile_kernels": len(kernels),
            "profile_idle_share": 1 - busy_ms / wall_ms}


def episode_timing_and_reference(out_dir):
    """Phase 4b: episode ms/img with views pre-built (bf16), and the fused
    episode held to the dense one in fp32 at full width on one group."""
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.data import native
    from rlcf_torch.data.class_names import get_classnames
    from rlcf_torch.data.datasets import SyntheticDataset

    names = get_classnames("A")
    imgs = np.stack([SyntheticDataset(n=GROUP, n_classes=200)[i][0] for i in range(GROUP)])
    make_views = lambda: native.generate_views_native_patch_u8(imgs, n_views=VIEWS, p_policy=16, resolution=224,
                                                                seed=0)
    views = make_views()
    t0 = time.perf_counter()
    for _ in range(3):
        make_views()
    out = {"host_views_ms_per_group": (time.perf_counter() - t0) / 3 * 1e3}
    clf, _, _ = tta_cls.build(tta_cls.get_args(flagship_argv(out_dir)))
    clf.setup(names)
    ep = lambda: clf.adapt_tokens(views)[0].float().cpu()
    ep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        ep()
    out["episode_ms_per_img"] = (time.perf_counter() - t0) / 3 / GROUP * 1e3
    out.update(profile_episode(ep))
    del clf
    torch.cuda.empty_cache()

    clf, _, _ = tta_cls.build(tta_cls.get_args(flagship_argv(out_dir, precision="fp32")))
    clf.setup(names)
    fused_logits, fused_aux = clf.adapt_tokens(views)
    clf.attn = clf.reward_attn = "dense"
    clf.setup(names)
    dense_logits, dense_aux = clf.adapt_tokens(views)
    same_sel = bool(torch.equal(fused_aux["selected"], dense_aux["selected"]))
    d_logits = float((fused_logits - dense_logits).abs().max())
    d_losses = float((fused_aux["losses"] - dense_aux["losses"]).abs().max())
    scale = float(dense_logits.abs().max())
    log(f"REFERENCE fp32 full width, fused vs dense attention: selections equal={same_sel} "
        f"max|d logits|={d_logits:.3e} (of max {scale:.3e}) max|d losses|={d_losses:.3e}")
    if not same_sel or d_logits > 1e-3 * max(scale, 1.0) or d_losses > 1e-3:
        raise AssertionError("fused-attention episode disagrees with the dense episode in fp32")
    out.update(fp32_selected_equal=same_sel, fp32_max_abs_logit_diff=d_logits, fp32_max_abs_loss_diff=d_losses)
    del clf
    torch.cuda.empty_cache()
    return out


def main():
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    import rlcf_torch  # noqa: F401  (fails outside a checkout of the repo)
    from rlcf_torch.data import native
    from rlcf_torch.data.class_names import get_classnames
    from rlcf_torch.ops import attention as A

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # phase 2
    t0 = time.perf_counter()
    A.build(force=True)
    t_nvcc = time.perf_counter() - t0
    for line in A.BUILD_LOG["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("PTXAS " + line.strip())
    if not native.available():
        raise RuntimeError("the host view pipeline (native/rlcf_host.cpp) did not build")
    log(f"BUILD nvcc {t_nvcc:.1f} s, host pipeline {time.perf_counter() - t0 - t_nvcc:.1f} s")

    # phase 3: the main path's shapes (group 4: 256 policy views, 24 selected
    # reward views, 4 x 200 text prompts), plus a backward at T=257
    t_text = text_seq_len(get_classnames("A"))
    shapes = [("fwd", 256, 197, 12, False, "policy"), ("fwd", 24, 257, 16, False, "reward"),
              ("fwd", 200, t_text, 8, True, "text-setup"), ("fwd", GROUP * 200, t_text, 8, True, "text"),
              ("bwd", GROUP * 200, t_text, 8, True, "text"), ("bwd", 24, 257, 16, False, "T257")]
    entries = []
    for dtype in (torch.bfloat16, torch.float32):
        for direction, B, T, H, masked, what in shapes:
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            entries.append(check_kernel(direction, B, T, H, dtype, masked, f"{what} B={B} T={T} H={H} {tag}"))
    # phase 4
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_flagship")
    flag = run_flagship(out_dir)
    log("FLAGSHIP " + json.dumps(flag))
    ep = episode_timing_and_reference(out_dir)
    log("EPISODE " + json.dumps(ep))

    # phase 5: every shape the main path launched was checked in phase 3; the
    # kernels line lists those checks with their main-path launch counts
    checked = {" ".join(map(str, e.pop("shape"))): e for e in entries}
    missing = sorted(set(flag["launches_by_shape"]) - set(checked))
    if missing:
        raise AssertionError(f"main-path kernel shapes without a check: {missing}")
    line = []
    for key, count in sorted(flag["launches_by_shape"].items()):
        line.append(dict(checked[key], launches=count))
    for direction in ("fwd", "bwd"):
        if not any(e["name"].startswith(f"mha_{direction}") for e in line):
            raise AssertionError(f"mha_{direction} was launched no time on the main path")
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

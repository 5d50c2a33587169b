#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py            # every phase; exits 0 only if all pass

Phases, each fatal:
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from the checkout (one nvcc per source,
     sm_90a, all started together) and the host view pipeline (g++);
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes and time kernel, plain version and, where one exists, the PyTorch
     library call with CUDA events: the attention kernels in bf16 and fp32
     (against scaled_dot_product_attention, forward and backward, the
     library's own kernels named); the tensor-core forward and backward, bf16
     and fp32 (split TF32 operands), over the edges of their regimes (T from 1
     to 577 both directions, 8/12/16 heads, masked and not, general masks)
     and for bit-identical repeats, with the error the operand precisions
     they could have would give (PRECISION); the forward at the reward
     ensemble's ViT-L/14@336px (B=24 T=577 H=16), at zero-shot's shapes and at
     encoder TTA of ViT-L/14@336px (B=64, 6, 1), the backward there (B=6 and
     24, T=577, H=16: the xlong kernels); Stanford Cars' text at T = 24
     (B=784 both ways, the policy's B=196 at setup) and Bongard-HOI's
     shapes (vision B=56, text B=8 T=8 both ways); the ATTN_IMPL="flash"
     switch of models/layers.py at T=128, 256 and 384, with the backward it takes, and
     differentiated at T=384 and 512 (causal), both directions timed there;
     the AugMix kernel at a flagship group (4 images x 64 views, 256 -> 224
     px) with augmix on and off, on a second seed, and op by op at the
     identity crop at severities 1 and 2, and at 336 and 448 px (the layout
     with one plane on chip) the same way;
  4. drive the flagship RLCF prompt TTA through the port's CLI at full width
     (ViT-B/16 policy, ViT-L/14 reward, random weights from a seed, ImageNet-A's
     200 class names on synthetic images, 64 views, group 4, 3 steps): first
     with --viewgen fused (every view built on the card), then with --viewgen
     native (views built on the host) at a smaller depth, then --viewgen fused
     with --precision fp32 (the split-TF32 kernels) at that depth, the launch
     counters set to 0 just before each run and read just after; then time
     device views, host views and the episode on one group (bf16 and fp32),
     hold the gradient of one step's loss in the context through the kernel
     backward to the one through the plain backward (bf16, same forward), and
     hold the fused-attention episode to the dense one in fp32; then drive
     encoder TTA through rlcf_torch.cli.tune_cls as scripts/rlcf-tune.sh sets
     it (the ViT-B/16 visual tower tuned against a ViT-L/14 reward, one image a
     group, 64 views built by the AugMix kernel, 3 steps at lr 1e-5, momentum
     EMA, full remat) in bf16 and, at a smaller depth, fp32, counters set to 0
     just before each and read just after; time its episode on views built
     beforehand, count the visual weights one bf16 episode changed, hold the
     gradient of one step's loss in the visual weights through the kernel
     backward to the plain backward's (GRAD), and the fused-attention
     episode to the dense one in fp32 (REFERENCE); print the ENCODER line;
     then encoder TTA of a ViT-L/14@336px policy at 336 px (bf16 and fp32:
     the xlong attention backward; GRAD encoder 336, REFERENCE encoder 336,
     the fp32 episode timed on views built beforehand with its device busy,
     the ENCODER336 line) and of an RN50 policy (bf16, without and with
     --prior_strength 0.5: the BN prior);
     then prompt TTA with the reference's 3-CLIP reward ensemble
     (--multiple_reward_models 1: ViT-L/14@336px, RN50x64, ViT-L/14, each at
     its own resolution; NHWC views built on the host, --viewgen native), prompt
     TTA with the single ViT-L/14@336px reward on views built on the card
     (resized to 336 px), and zero-shot over the ensemble ViT-B/16, RN50x64,
     ViT-L/14@336px, counters set to 0 just before each and read just after;
     time host views and one ensemble group (device busy, idle share), and
     hold the fused-attention ensemble episode to the dense one in fp32
     (REFERENCE ensemble); print the ENSEMBLE line; then the rest of the
     classification application: Stanford Cars as scripts/rlcf-prompt-fine.sh
     runs it (a synthetic Zhou-split tree of 8 images and the 196 class
     names; 5 steps at lr 7e-3, --viewgen fused: its prompts truncate to
     T = 24, so the text tower's forward and backward run the long kernels),
     CoCoOp as scripts/tpt-prompt.sh with --cocoop (1 step at lr 5e-3, views
     built on the host, 8 images; REFERENCE cocoop holds its fp32
     fused-attention episode to the dense one) and Bongard-HOI (a synthetic
     tree of 8 tasks, the learnable class token, 4 tasks a group), counters
     set to 0 just before each and read just after; each path's last group
     profiled on its inputs built beforehand; the FINE, COCOOP and BONGARD
     lines;
  5. print the run's total seconds, the kernels line (phase 5 also holds
     that Stanford Cars' text ran mma_long at T = 24 both ways on its path),
     then the device line last.

It imports nothing of JAX and nothing of the JAX package.

    python3 chip_smoke.py --kernels-only   # phases 1-3, then exit 3 (no device line)
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                                       # H100 SXM
# dense bf16 tensor cores; fp32 attention products at the 3xTF32 rate: a third of the 494.7 TFLOP/s of TF32
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3}
CUDA_CORE_FP32_FLOPS = 67e12   # fp32 outside the tensor cores: the AugMix kernel, and the fp32 attention bound before 3xTF32
POLICY, REWARD = "ViT-B/16", "ViT-L/14"
GROUP, VIEWS, STEPS = 4, 64, 3
TOL = {  # |kernel - plain| <= atol + rtol * |plain|: fp32 = summation order; bf16 = one output rounding
    (torch.float32, "fwd"): (1e-5, 1e-5), (torch.float32, "bwd"): (1e-4, 1e-4),
    (torch.bfloat16, "fwd"): (1e-2, 2**-7), (torch.bfloat16, "bwd"): (1e-2, 2**-7),
}
REPLACES = {"fwd": "rlcf_tpu/ops/pallas_attention.py:65", "bwd": "rlcf_tpu/ops/pallas_attention.py:89",
            "augmix": "rlcf_tpu/ops/pallas_augmix.py:284", "flash": "rlcf_tpu/models/layers.py:48"}
ATTENTION_SOURCE = {  # by the key of ops/attention.py::LAUNCH_VARIANTS that a launch counts under
    "mma_short": "rlcf_torch/csrc/attention_mma.cu", "mma_long": "rlcf_torch/csrc/attention_mma.cu",
    "mma_xlong": "rlcf_torch/csrc/attention_mma.cu",
    "bwd_mma_short": "rlcf_torch/csrc/attention_bwd_mma.cu", "bwd_mma_long": "rlcf_torch/csrc/attention_bwd_mma.cu",
    "tf32x6_short": "rlcf_torch/csrc/attention_tf32.cu", "tf32x3_long": "rlcf_torch/csrc/attention_tf32.cu",
    "bwd_tf32x6_short": "rlcf_torch/csrc/attention_bwd_tf32.cu",
    "bwd_tf32x3_long": "rlcf_torch/csrc/attention_bwd_tf32.cu",
    "bwd_mma_xlong": "rlcf_torch/csrc/attention_bwd_mma.cu",
    "bwd_tf32x3_xlong": "rlcf_torch/csrc/attention_bwd_tf32.cu"}
# Relative L2 errors of the full-width bf16 gradient check, kernel against plain backward. What the check can
# resolve is each launch on its own inputs: there the two differ by the bf16 steps that different fp32 sums leave,
# and GRAD_LAUNCH_LIMIT holds every launch. Down the 12 layers any such difference flips roundings in every later
# bf16 operation, and the two gradients end a noise floor apart that hardly depends on its size. The run measures
# that floor itself (the plain backward against itself with its fp32 result moved by 2^-12 at random before the
# rounding) and holds the gradients in the prompts and in the context to GRAD_FLOOR_RATIO times it.
GRAD_LAUNCH_LIMIT, GRAD_FLOOR_RATIO = 1e-3, 2.0
SWEEP_T = (1, 7, 8, 15, 16, 17, 24, 32, 33, 50, 64, 65, 77, 80, 81, 128, 196, 197, 256, 257)
# above the long kernels: the edges of the chunks of 64 (keys, and in the backward queries) up to ViT-L/14@336px's T
SWEEP_T_FWD = SWEEP_T + (258, 271, 272, 288, 320, 321, 384, 449, 512, 513, 576, 577)
SWEEP_T_BWD = SWEEP_T + (258, 321, 385, 448, 513, 576, 577)
SWEEP_H = (8, 12, 16)
FLASH_SHAPE = (24, 256, 16)   # B, T, H at which the ATTN_IMPL="flash" route is timed
SRC_SIZE, RES = 256, 224
FLAGSHIP_IMAGES, NATIVE_IMAGES, FP32_IMAGES = 16, 8, 8
ENCODER_IMAGES, ENCODER_FP32_IMAGES = 8, 2   # encoder TTA runs one image a group
POLICY336, RES336, ENCODER336_IMAGES, ENCODER336_FP32_IMAGES = "ViT-L/14@336px", 336, 3, 1
RESNET_POLICY, RESNET_IMAGES, BN_PRIOR = "RN50", 4, 0.5
ENSEMBLE_IMAGES, REWARD336_IMAGES, ZERO_SHOT_IMAGES = 8, 4, 16
REWARD336 = "ViT-L/14@336px"
ZERO_SHOT_ARCHS = ("ViT-B/16", "RN50x64", "ViT-L/14@336px")
# fp32 operations per pixel of one plane, read off csrc/augmix.cu: each op's
# arithmetic, compares and rounding (rotate: three two-tap passes), the mix
# per chain and the final blend
AUGMIX_OP_COST = {0: 7, 1: 2, 2: 1, 3: 12, 4: 2, 5: 4, 6: 4, 7: 4, 8: 4}
AUGMIX_MIX_COST, AUGMIX_FINAL_COST = 2, 4
# pixels unequal to the plain version in the checks with augmix on: the
# flagship's as the first design of the AugMix kernel gave them on these
# inputs, and the encoder's group of one image held to the same 0
AUGMIX_UNEQUAL = {"flagship augmix on": 0, "flagship augmix on, seed 1": 0, "encoder group augmix on": 0}
LARGE_RES = (336, 448)   # the AugMix kernel's layout with one plane on chip: ViT-L/14@336px's views, RN50x64's
# the rest of the classification application: Stanford Cars as scripts/rlcf-prompt-fine.sh runs it (its prompts
# truncate to T = 24: the text tower on the long kernels), CoCoOp as scripts/tpt-prompt.sh, Bongard-HOI's tasks
FINE_SET, FINE_IMAGES, FINE_STEPS = "cars", 8, 5
COCOOP_IMAGES, COCOOP_STEPS = 8, 1
BONGARD_TASKS, BONGARD_SIZE = 8, (200, 260)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20, warmup=3, rounds=1):
    """Mean ms per call by CUDA events over ``reps`` calls after warm-up; the
    median of ``rounds`` such means. In each round the card is first held busy
    while the host queues the calls, for half again as long as the host took
    to queue them in a first, untimed round (at least ~2 ms), so that a call
    shorter than the host's enqueue (~0.03 ms through a wrapper, ~0.5 ms for
    an autograd call into a library on a slow host) is timed on the device and
    not on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    means = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(max(4_000_000, int(1.5 * host_s * 2e9)))   # cycles; the clock stays below 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return sorted(means)[rounds // 2]


def device_events(prof):
    """The device's own events of a torch.profiler profile: not the spans of
    annotations on its timeline (``Optimizer.step#AdamW.step``), which overlap
    the kernels they cover."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs, costliest first
    (torch.profiler): tells which backend a library call took."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_events(prof)
    names = {}
    for e in kernels:
        names[e.name] = names.get(e.name, 0.0) + e.device_time
    return [n for n, _ in sorted(names.items(), key=lambda kv: -kv[1])]


def text_seq_len(classnames):
    """The text tower's sequence length on the main path (prompt truncation)."""
    from rlcf_torch.tokenizer import tokenize
    from rlcf_torch.data.class_names import assemble_prompts

    eot = tokenize(assemble_prompts(classnames)).argmax(axis=-1)
    return min(77, -(-(int(eot.max()) + 1) // 8) * 8)


def assert_close(got, want, dtype, direction, label):
    """|got - want| <= atol + rtol * |want| with TOL's numbers; returns the
    largest absolute and relative difference."""
    err = (got.float() - want.float()).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.float().abs().clamp_min(1e-6)).max())
    atol, rtol = TOL[(dtype, direction)]
    if not bool(torch.isfinite(got).all()) or bool((err > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"{label}: kernel disagrees with its plain version (max abs {max_abs:.3e}, "
                             f"tolerance {atol} + {rtol}*|plain|)")
    return max_abs, max_rel


def check_kernel(direction, B, T, H, dtype, masked, label, kind=None):
    """Kernel vs plain version on one shape; returns the kernels-line entry
    (``kind``: the entry's name and REPLACES key where it is not the
    direction's)."""
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
    before = dict(A.LAUNCH_VARIANTS)
    got = kernel()
    torch.cuda.synchronize()
    (ran,) = [v for v, n in A.LAUNCH_VARIANTS.items() if n != before.get(v, 0)]   # the variant that ran
    want = plain()
    max_abs, max_rel = assert_close(got, want, dtype, direction, label)
    rel_l2 = float((got.float() - want.float()).norm() / want.float().norm())
    atol, rtol = TOL[(dtype, direction)]

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
    ms, plain_ms, library_ms = time_ms(kernel, reps, rounds=3), time_ms(plain, reps), time_ms(library, reps, rounds=3)
    library_kernels = device_kernels(library)

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
    name = f"{kind or 'mha_' + direction}[{label}]"
    variant = ran.removeprefix("bwd_")
    cuda_core = ("" if dtype != torch.float32 else   # the yardstick of the CUDA-core kernels that 3xTF32 replaced
                 f", bound at 67 TFLOP/s fp32 {max(t_bytes, flops / CUDA_CORE_FP32_FLOPS * 1e3):.4f} ms")
    log(f"KERNEL {name}: variant={variant} max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} rel_l2_err={rel_l2:.3e} "
        f"(tolerance {atol} + {rtol:.3g}*|plain|) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={max(t_bytes, t_ops):.4f} "
        f"(bytes {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, ops {flops / 1e9:.2f} GFLOP -> {t_ops:.4f} ms{cuda_core}) "
        f"library kernels: {' + '.join(n[:48] for n in library_kernels[:3])}")
    return {"name": name, "route": "cuda", "source": ATTENTION_SOURCE[ran], "variant": variant,
            "replaces": REPLACES[kind or direction], "shape": [direction, B, T, H, str(dtype)],
            "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


GENERAL_MASKS = (("key_out", (16, 197, 577)), ("dead_row", (16, 197, 257, 577)), ("block_diagonal", (197, 257, 577)),
                 ("block_diagonal_dead_row", (197, 257, 577)), ("dead_tail", (197, 257, 577)))


def general_mask(kind, T, dev, gen):
    """An additive [T, T] mask that is not causal: random, with -inf on one key
    for every query (``key_out``), on two whole query rows, one of them the
    last (``dead_row``: their softmax is uniform), on every 64 x 64 tile off
    the diagonal (``block_diagonal``: a row's live keys lie in one tile), on
    both, or on the keys behind the last whole 64 (``dead_tail``)."""
    mask = torch.randn(T, T, device=dev, generator=gen)
    block = torch.arange(T, device=dev) // 64
    if kind == "key_out":
        mask[:, 3] = float("-inf")
    if kind.startswith("block_diagonal"):
        mask[block[:, None] != block[None, :]] = float("-inf")
    if kind.endswith("dead_row"):
        mask[[T // 3, T - 1]] = float("-inf")
    if kind == "dead_tail":
        mask[:, T // 64 * 64:] = float("-inf")
    return mask


# the operand precisions of PRECISION's fp32 lines: one TF32 pass, the long kernels' 3xTF32, the short ones' six products
TF32_PASSES = (("one TF32 pass", 1), ("3xTF32", 3), ("six products", 6))


def check_sweep(direction, dtype):
    """Phase 3, correctness only: the forward or backward kernel of one dtype
    against its plain version over the edges of both regimes (small B), and
    two launches on the same input bit for bit. Then the worst error as a
    share of the tolerance, per regime, of the kernel and of the operand
    precisions it could have: bf16 backward, P and dS rounded once or split
    into hi + lo (``ops/attention.py::bf16_operand_reference_bwd``); fp32, both directions, one TF32
    pass, 3xTF32 or six products of a three-way split
    (``ops/attention.py::tf32_reference``)."""
    from rlcf_torch.models.layers import causal_mask
    from rlcf_torch.ops import attention as A

    dev, scale, fp32 = torch.device("cuda"), 1.0 / math.sqrt(64), dtype == torch.float32
    atol, rtol = TOL[(dtype, direction)]
    shares = {}   # (what, variant) -> worst |x - plain| / (atol + rtol * |plain|)

    def case(T, H, mask, seed, label):
        gen = torch.Generator(device=dev).manual_seed(seed)
        qkv = torch.randn(3, T, 3 * H * 64, device=dev, generator=gen).to(dtype)
        g = torch.randn(3, T, H * 64, device=dev, generator=gen).to(dtype)
        if isinstance(mask, str):
            mask = general_mask(mask, T, dev, gen)
        if direction == "fwd":
            want = A.fused_attention_reference(qkv, mask, H, scale)
            got, again = A.launch_fwd(qkv, mask, H, scale), A.launch_fwd(qkv, mask, H, scale)
            variant, others = A.forward_variant(T, dtype), {}
            if fp32:
                others = {name: A.tf32_reference(qkv, mask, H, scale, passes=n) for name, n in TF32_PASSES}
        else:
            want = A.fused_attention_reference_bwd(qkv, g, mask, H, scale)
            got, again = A.launch_bwd(qkv, g, mask, H, scale), A.launch_bwd(qkv, g, mask, H, scale)
            variant = A.backward_variant(T, dtype)
            if fp32:
                others = {name: A.tf32_reference_bwd(qkv, g, mask, H, scale, passes=n) for name, n in TF32_PASSES}
            else:
                others = {"one rounding": A.bf16_operand_reference_bwd(qkv, g, mask, H, scale, split=False),
                          "hi + lo split": A.bf16_operand_reference_bwd(qkv, g, mask, H, scale, split=True)}
        torch.cuda.synchronize()
        label = f"sweep {direction} {tag} {label} variant={variant}"
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two launches on the same input differ")
        for what, x in {"kernel": got, **others}.items():
            share = float(((x.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())
            shares[(what, variant)] = max(shares.get((what, variant), 0.0), share)
        return assert_close(got, want, dtype, direction, label)[0]

    tag = "fp32" if fp32 else "bf16"
    t_values = SWEEP_T_FWD if direction == "fwd" else SWEEP_T_BWD
    errs = [case(T, H, causal_mask(T, dev) if masked else None, T * 100 + H, f"T={T} H={H} masked={masked}")
            for T in t_values for H in SWEEP_H for masked in (False, True)]
    errs += [case(T, 12, kind, 5, f"T={T} H=12 general mask {kind}")
             for kind, lengths in GENERAL_MASKS for T in lengths]
    log(f"SWEEP mha_{direction} {tag}: {len(errs)} cases (T in {list(t_values)}, H in {list(SWEEP_H)}, masked and "
        f"not, general masks {dict(GENERAL_MASKS)}) within tolerance, worst max_abs_err {max(errs):.3e}; "
        f"repeats bit-identical")
    if fp32 or direction == "bwd":
        log(f"PRECISION mha_{direction} {tag}, worst error / tolerance over the sweep: "
            + "; ".join(f"{what} {variant} {share:.3f}" for (what, variant), share in sorted(shares.items())))


def check_flash_switch():
    """Phase 3, ATTN_IMPL="flash": ``layers.multi_head_attention`` at T=128,
    256 and 384, masked and not, bf16 and fp32, against its dense branch, the
    launch counter showing that the kernel ran; a differentiated call at
    T=384 and 512, causal, whose gradient (through the xlong backward) equals
    the dense branch's; the switch is set back. Returns the kernels-line
    entries of the timed shapes, forward and the backward that the switch's
    autograd function takes (T=256, and 384 and 512 causal both ways, bf16 and
    fp32)."""
    from rlcf_torch.models import layers as L
    from rlcf_torch.ops import attention as A

    dev, H = torch.device("cuda"), 4
    D = H * 64
    try:
        for dtype in (torch.bfloat16, torch.float32):
            for T in (128, 256, 384):
                gen = torch.Generator(device=dev).manual_seed(T)
                x = torch.randn(2, T, D, device=dev, generator=gen).to(dtype)
                w = [(torch.randn(s, device=dev, generator=gen) * D ** -0.5).to(dtype)
                     for s in ((D, 3 * D), (3 * D,), (D, D), (D,))]
                for masked in (False, True):
                    mask = L.causal_mask(T, dev) if masked else None
                    L.ATTN_IMPL = "dense"
                    want = L.multi_head_attention(x, *w, H, mask)
                    L.ATTN_IMPL = "flash"
                    before = A.LAUNCHES["fwd"]
                    got = L.multi_head_attention(x, *w, H, mask)
                    torch.cuda.synchronize()
                    if A.LAUNCHES["fwd"] != before + 1:
                        raise AssertionError('ATTN_IMPL="flash" did not launch the attention kernel')
                    label = f"flash switch T={T} {dtype} masked={masked}"
                    max_abs, _ = assert_close(got, want, dtype, "fwd", label)
                    log(f"FLASH {label}: equals the dense branch, max_abs_err={max_abs:.3e}")
            for T in (384, 512):   # differentiated, causal: the xlong backward
                gen = torch.Generator(device=dev).manual_seed(T + 1)
                x = torch.randn(2, T, D, device=dev, generator=gen).to(dtype)
                w = [(torch.randn(s, device=dev, generator=gen) * D ** -0.5).to(dtype)
                     for s in ((D, 3 * D), (3 * D,), (D, D), (D,))]
                mask, grads = L.causal_mask(T, dev), {}
                for impl in ("dense", "flash"):
                    L.ATTN_IMPL = impl
                    xi = x.clone().requires_grad_(True)
                    A.reset_launch_counts()
                    L.multi_head_attention(xi, *w, H, mask).float().sin().sum().backward()
                    torch.cuda.synchronize()
                    grads[impl] = (xi.grad, dict(A.LAUNCH_VARIANTS))
                (got, ran), (want, _) = grads["flash"], grads["dense"]
                xlong = "bwd_" + A.backward_variant(T, dtype)
                if not ran.get(xlong):
                    raise AssertionError(f'ATTN_IMPL="flash" at T={T} did not launch {xlong}: {ran}')
                rel = rel_l2(got, want)
                limit = 1e-5 if dtype == torch.float32 else 2**-7
                log(f"FLASH backward T={T} {dtype} causal through {xlong}: d/dx relative L2 error {rel:.3e} against "
                    f"the dense branch (limit {limit:g})")
                if not bool(torch.isfinite(got).all()) or rel > limit:
                    raise AssertionError(f'ATTN_IMPL="flash" gradient at T={T} disagrees with the dense branch')
    finally:
        L.ATTN_IMPL = "dense"
    B, T, H = FLASH_SHAPE
    entries = [check_kernel("fwd", B, T, H, torch.bfloat16, masked,
                            f"B={B} T={T} H={H} bf16 {'causal' if masked else 'unmasked'}", kind="flash")
               for masked in (True, False)]
    entries += [check_kernel("bwd", B, T, H, dtype, True, f"backward B={B} T={T} H={H} {tag} causal", kind="flash")
                for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32"))]
    entries += [check_kernel("fwd", B, t, H, dtype, True, f"B={B} T={t} H={H} {tag} causal", kind="flash")
                for t in (384, 512) for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32"))]
    return entries + [check_kernel("bwd", B, t, H, torch.bfloat16, True, f"backward B={B} T={t} H={H} bf16 causal",
                                   kind="flash") for t in (384, 512)]


def augmix_ops(params, R, S):
    """fp32 operations this run's views need in the AugMix kernel: the crop's
    taps over the rows and columns each view's weights cover, then, where
    m < 1, each sampled op, the mix and the final blend, per pixel of each of
    the 3 planes."""
    from rlcf_torch.ops import augmix as X

    host = {k: v.cpu() for k, v in params.items()}
    V = host["m"].shape[0]
    basew = X.bicubic_matrix(S, R)
    total = 0
    for i in range(V):
        box = host["rrc"][i]
        base = i % VIEWS == 0
        wy = basew if base else X.resize_weights(box[0], box[2], 0, R, S)
        wx = basew if base else X.resize_weights(box[1], box[3], int(host["flip"][i]), R, S)
        cols = torch.nonzero(wx.abs().sum(0)).flatten()
        width = int(cols.max() - cols.min() + 1) if cols.numel() else 0
        total += 2 * int((wy != 0).sum()) * width + 2 * int((wx != 0).sum()) * R
        if float(host["m"][i]) != 1.0:
            steps = [int(host["ops"][i, c * 3 + t]) for c in range(3) for t in range(int(host["depth"][i, c]))]
            total += R * R * (sum(AUGMIX_OP_COST.get(op, 0) for op in steps) + 3 * AUGMIX_MIX_COST + AUGMIX_FINAL_COST)
    return 3 * total


def augmix_compare(label, got, want, max_unequal=None, max_gray=None):
    """Log the kernel's views against the plain version's; raise past the limits."""
    d = (got.int() - want.int()).abs()
    share, worst, unequal = float((d == 0).float().mean()), int(d.max()), int((d != 0).sum())
    log(f"AUGMIX {label}: unequal pixels {unequal} of {d.numel()}, equal share {share:.6f}, max |d| {worst} gray")
    if (max_unequal is not None and unequal > max_unequal) or (max_gray is not None and worst > max_gray):
        raise AssertionError(f"AugMix kernel disagrees with its plain version: {label}")
    return worst


def check_augmix():
    """Phase 3, AugMix: the kernel against its plain version on the same
    sampled parameters. Both sum the crop in float64 in one order and round
    every step alike (the plain version's float64 stand-in for a fused
    multiply-add could still round twice in rare cases). At R=224: augmix off
    at most 1 gray; augmix on at most AUGMIX_UNEQUAL pixels unequal, the count
    the first kernel gave on these inputs. At R = 336 and 448 (LARGE_RES, the
    kernel's layout with one plane on chip and the other in the device
    scratch), encoder TTA's group of one image: augmix on and off on two
    seeds each, 0 unequal. Two launches alike everywhere; single ops exact at
    every R; then the AUGMIX_PHASES line. Returns the kernels-line entries of
    the flagship's group of 4 images and encoder TTA's group of 1 at each R."""
    from rlcf_torch.ops import augmix as X

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    imgs = torch.randint(0, 256, (GROUP, 3, SRC_SIZE, SRC_SIZE), generator=g, device=dev, dtype=torch.uint8)
    cases = [(RES, "flagship augmix on", GROUP, 0, True, AUGMIX_UNEQUAL["flagship augmix on"], None, True),
             (RES, "flagship augmix off", GROUP, 0, False, None, 1, False),
             (RES, "flagship augmix on, seed 1", GROUP, 1, True, AUGMIX_UNEQUAL["flagship augmix on, seed 1"], None,
              False),
             (RES, "encoder group augmix on", 1, 2, True, AUGMIX_UNEQUAL["encoder group augmix on"], None, True)]
    for R in LARGE_RES:
        if not X.large_layout(R, SRC_SIZE):
            raise AssertionError(f"R={R} was meant to take the AugMix kernel's large layout")
        cases += [(R, f"encoder group R={R} seed {seed} augmix {'on' if augmix else 'off'}", 1, seed, augmix, 0, None,
                   augmix and seed == 10 + R) for augmix in (True, False) for seed in (10 + R, 11 + R)]
    entries = []
    for R, label, n, seed, augmix, max_unequal, max_gray, timed in cases:
        basew, shifts = X.bicubic_matrix(SRC_SIZE, R, device=dev), X.op_shift_bounds(1.0, R)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = X.flatten_params(X.sample_view_params(gen, n, VIEWS, SRC_SIZE, R, augmix=augmix, device=dev))
        kernel = lambda: X.launch_views(imgs[:n], params, basew, R, SRC_SIZE, VIEWS, shifts)
        plain = lambda: X.augmix_views_reference(imgs[:n], params, basew, R, SRC_SIZE, VIEWS, shifts)
        got = kernel()
        torch.cuda.synchronize()
        again = kernel()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"AugMix kernel: two launches on the same input differ ({label})")
        worst = augmix_compare(label, got, plain(), max_unequal=max_unequal, max_gray=max_gray)
        if timed:   # the flagship's group of 4 and the encoder's group of 1 at each R
            ms, plain_ms = time_ms(kernel, reps=20), time_ms(plain, reps=2, warmup=1)
            nbytes = n * 3 * SRC_SIZE ** 2 + n * VIEWS * 3 * R ** 2
            flops = augmix_ops(params, R, SRC_SIZE)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / CUDA_CORE_FP32_FLOPS * 1e3
            name = f"augmix[group N={n} V={VIEWS} S={SRC_SIZE} R={R}]"
            log(f"KERNEL {name}: max_abs_err={worst} gray "
                f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=null (no single PyTorch call computes AugMix views) "
                f"bound_ms={max(t_bytes, t_ops):.4f} (bytes {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, "
                f"ops {flops / 1e9:.3f} GFLOP fp32 -> {t_ops:.4f} ms) shared bytes {X.shared_bytes(R, SRC_SIZE)}")
            entries.append({"name": name, "route": "cuda", "source": "rlcf_torch/csrc/augmix.cu",
                            "replaces": REPLACES["augmix"], "shape": ["augmix", n, VIEWS, SRC_SIZE, R],
                            "max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                            "library_ms": None})

    # one view per op at the identity crop (source = view size), severities 1 and 2
    ops = [op for op in range(9) for _ in range(4)]
    for R in (RES, *LARGE_RES):
        src = torch.nn.functional.interpolate(imgs[:1].float(), size=(R, R), mode="area").round().to(torch.uint8)
        for severity in (1.0, 2.0):
            gen = torch.Generator(device=dev).manual_seed(int(severity))
            params = X.single_op_params(gen, ops, R, severity, device=dev)
            eye, sh = X.bicubic_matrix(R, R, device=dev), X.op_shift_bounds(severity, R)
            got = X.launch_views(src, params, eye, R, R, len(ops) + 1, sh)
            torch.cuda.synchronize()
            augmix_compare(f"single ops at severity {severity:g} R={R} (36 views, 4 per op)", got,
                           X.augmix_views_reference(src, params, eye, R, R, len(ops) + 1, sh), max_unequal=0)
    augmix_phases(imgs, X.bicubic_matrix(SRC_SIZE, RES, device=dev), X.op_shift_bounds(1.0, RES))
    return entries


AUGMIX_OP_NAMES = ("autocontrast", "equalize", "posterize", "rotate", "solarize", "shear_x", "shear_y",
                   "translate_x", "translate_y")


def augmix_phases(imgs, basew, shifts):
    """Phase 3, the AUGMIX_PHASES line: the kernel's ms at the flagship group
    on parameter sets built here from one set of draws: augmix off (the crop
    alone, since m = 1 skips the chains); for each op, every augmented view
    running that op at all 9 steps (3 chains of depth 3, the crops as
    sampled), less the crop-only time, over 9 (ms per step of a group); and
    the sampled mix."""
    from rlcf_torch.ops import augmix as X

    dev = torch.device("cuda")
    randoms = X.draw_view_randoms(torch.Generator(device=dev).manual_seed(0), GROUP, VIEWS, device=dev)

    def params(augmix=True, op=None):
        r = dict(randoms)
        if op is not None:
            r["op_idx"], r["depths"] = torch.full_like(r["op_idx"], op), torch.full_like(r["depths"], 3)
        return X.flatten_params(X.derive_view_params(r, src_size=SRC_SIZE, resolution=RES, augmix=augmix))

    def ms(p):
        return time_ms(lambda: X.launch_views(imgs, p, basew, RES, SRC_SIZE, VIEWS, shifts), reps=10, rounds=3)

    crop, mix = ms(params(augmix=False)), ms(params())
    per_step = {name: (ms(params(op=op)) - crop) / 9 for op, name in enumerate(AUGMIX_OP_NAMES)}
    log(f"AUGMIX_PHASES group N={GROUP} V={VIEWS} S={SRC_SIZE} R={RES}, ms per launch (median of 3): "
        f"crop only {crop:.4f}; sampled mix {mix:.4f}; per step with every augmented view running one op "
        f"at all 9 steps, less the crop: " + ", ".join(f"{k} {v:.4f}" for k, v in per_step.items()))
    return {"crop_ms": crop, "mix_ms": mix, "per_step_ms": per_step}


def flagship_argv(out_dir, precision="bf16", limit=FLAGSHIP_IMAGES, viewgen="fused", reward=REWARD, extra=()):
    return [".", "--test_sets", "synthetic", "--synthetic_classes", "A", "--limit", str(limit),
            "--arch", POLICY, "--reward_arch", reward, "--precision", precision, "--device", "cuda",
            "--viewgen", viewgen, "--batch_size", str(VIEWS), "--selection_p", "0.1", "--sample_k", "3",
            "--tta_steps", str(STEPS), "--lr", "7e-3", "--ctx_init", "a_photo_of_a",
            "--episode_group", str(GROUP), "--seed", "0", "--output", out_dir, *extra]


ENSEMBLE_ARGS = ("--multiple_reward_models", "1")


def run_flagship(out_dir, viewgen, limit, precision="bf16", reward=REWARD, extra=(), path=None):
    """Phase 4a: one prompt-TTA path through the CLI (``extra`` flags; the
    reward ensemble's groups go through the NHWC ``adapt``, the others through
    ``adapt_tokens``); returns its numbers. img/s leaves the first group out
    (none with one group)."""
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.ops import attention as A
    from rlcf_torch.ops import augmix as X
    from rlcf_torch.tasks.classification import PromptTTAClassifier

    entry = "adapt" if ENSEMBLE_ARGS[0] in extra else "adapt_tokens"
    seen = []
    adapt = getattr(PromptTTAClassifier, entry)

    def recording(self, *views):
        logits, aux = adapt(self, *views)
        seen.append((logits.detach(), aux["losses"].detach()))
        return logits, aux

    setattr(PromptTTAClassifier, entry, recording)
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()                 # counts start at 0 just before the path
    X.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        results = tta_cls.main(flagship_argv(out_dir, precision=precision, limit=limit, viewgen=viewgen,
                                             reward=reward, extra=extra))
        wall = time.perf_counter() - t0
    finally:
        setattr(PromptTTAClassifier, entry, adapt)
    launches = {**A.LAUNCHES, **X.LAUNCHES}     # read just after
    by_shape = {**A.LAUNCH_SHAPES, **X.LAUNCH_SHAPES}
    path = path or (viewgen if precision == "bf16" else f"{viewgen} {precision}")
    for logits, losses in seen:
        if tuple(logits.shape) != (GROUP, 200) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{path} logits {tuple(logits.shape)} not finite [{GROUP}, 200]")
        if tuple(losses.shape) != (GROUP, STEPS) or not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{path} losses {tuple(losses.shape)} not finite [{GROUP}, {STEPS}]")
    groups = limit // GROUP
    kernels = ("fwd", "bwd", "augmix") if viewgen == "fused" else ("fwd", "bwd")
    if len(seen) != groups or any(launches[k] == 0 for k in kernels) or \
            (viewgen == "fused" and launches["augmix"] != groups):
        raise AssertionError(f"{path} (--viewgen {viewgen} --precision {precision}) did not go through the "
                             f"kernels: groups={len(seen)} launches={launches}")
    secs = results["synthetic"]["group_seconds"]
    timed = secs[1:]  # the first group warms up
    return {"path": path, "viewgen": viewgen, "precision": precision, "reward": "ensemble" if extra else reward,
            "groups": len(secs), "group_seconds": secs,
            "img_per_s": GROUP * len(timed) / sum(timed) if timed else None, "wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
            "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()},
            "top1": results["synthetic"]["top1"]}


def profile_episode(ep, what="fused group (views + episode)"):
    """Device busy share of one group and its costliest kernels
    (torch.profiler; CUPTI sees the ctypes-launched kernels too)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ep()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_events(prof)
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.device_time / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"PROFILE {t:9.3f} ms {n:5d} launches  {name[:110]}")
    log(f"PROFILE {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"{len(kernels)} kernels, idle share {1 - busy_ms / wall_ms:.3f}")
    return {"profile_wall_ms": wall_ms, "profile_device_busy_ms": busy_ms, "profile_kernels": len(kernels),
            "profile_idle_share": 1 - busy_ms / wall_ms}


def grads_through_backwards(loss, wrt):
    """The gradients of ``loss`` in ``wrt`` three times over one forward: with
    the kernel backward (each launch also held to the plain backward on its
    own inputs), with the plain backward, and with the plain backward's fp32
    result moved within its rounding (the noise floor, see GRAD_LAUNCH_LIMIT).
    Returns (grads by pass, per-launch relative L2 errors, variants launched)."""
    from rlcf_torch.ops import attention as A

    launch, per_launch = A.launch_bwd, []
    plain_bwd = lambda qkv, g, mask, heads, scale: A.fused_attention_reference_bwd(qkv, g.to(qkv.dtype), mask, heads,
                                                                                   scale)

    def kernel_bwd(*args):   # the kernel's result, held to the plain version on this layer's own inputs
        got, want = launch(*args), plain_bwd(*args).float()
        per_launch.append(float((got.float() - want).norm() / want.norm()))
        return got

    def jittered_bwd(qkv, g, mask, heads, scale):   # another rounding of the same fp32 result: the noise floor
        out = A.fused_attention_reference_bwd(qkv.float(), g.float(), mask, heads, scale)
        return (out * (1 + 2**-12 * (2 * torch.rand_like(out) - 1))).to(qkv.dtype)

    grads = {}
    A.reset_launch_counts()
    try:
        for name, bwd in (("kernel", kernel_bwd), ("plain", plain_bwd), ("jittered", jittered_bwd)):
            A.launch_bwd = bwd
            grads[name] = torch.autograd.grad(loss, wrt, retain_graph=True)
    finally:
        A.launch_bwd = launch
    return grads, per_launch, dict(A.LAUNCH_VARIANTS)


def rel_l2(a, b):
    return float((a - b).float().norm() / b.float().norm())


def gradient_check(clf, toks):
    """Phase 4b, bf16 at full width: the gradient of the first episode step's
    loss through the whole text tower, once with the kernel backward and once
    with the plain backward on the same forward: in the prompts' embeddings
    (what the tower hands back) and in the context (their sum over classes
    and positions, which cancels most of it); a third pass, with the plain
    backward's result moved within its rounding, measures the noise floor
    that the two are held to (see GRAD_LAUNCH_LIMIT)."""
    from rlcf_torch.core import prompt as P
    from rlcf_torch.core.episode import step_loss
    from rlcf_torch.models import clip as clip_model

    img_feats, sel, r_sim = clf.prepare_tokens(*toks)
    sel_feats = torch.gather(img_feats, 1, sel[:, :, None].expand(-1, -1, img_feats.shape[-1]))
    pt = clf.prompt_state
    ctx = pt.ctx0.detach()[None].expand(GROUP, *pt.ctx0.shape).clone().requires_grad_(True)
    prompts = P.splice_arrays(ctx, pt.fixed_embed, pt.ctx_map)   # [N, C, T, D], as text_features builds them
    N, C, T, D = prompts.shape
    feats = clip_model.encode_text_embeds(clf.clip_params, clf.clip_cfg, prompts.reshape(N * C, T, D),
                                          pt.eot_idx.repeat(N), attn=clf.attn)
    text = clip_model.normalize(feats.float()).reshape(N, C, -1)
    logits = clf._logit_scale() * torch.einsum("nse,nce->nsc", sel_feats, text)
    loss = step_loss(logits, r_sim, clf.ecfg, clf.reward.score_samples,
                     clf.reward.params["logit_scale"].exp().float()).sum()
    grads, per_launch, launched = grads_through_backwards(loss, (ctx, prompts))
    (rel_ctx, rel_prompts), (floor_ctx, floor_prompts) = ([rel_l2(x, p) for x, p in zip(grads[name], grads["plain"])]
                                                          for name in ("kernel", "jittered"))
    max_abs = float((grads["kernel"][0] - grads["plain"][0]).abs().max())
    log(f"GRAD bf16 full width through the text tower ([{N * C}, {T}, {D}], {launched}), kernel backward against "
        f"plain backward: per launch on its own inputs, relative L2 error {min(per_launch):.3e} to "
        f"{max(per_launch):.3e} (limit {GRAD_LAUNCH_LIMIT}); d loss / d prompts relative L2 error {rel_prompts:.3e} "
        f"(noise floor {floor_prompts:.3e}, limit {GRAD_FLOOR_RATIO:g} x the floor); d loss / d ctx {list(ctx.shape)} "
        f"relative L2 error {rel_ctx:.3e} (noise floor {floor_ctx:.3e}, limit {GRAD_FLOOR_RATIO:g} x the floor), "
        f"max abs diff {max_abs:.3e} of max |grad| {float(grads['plain'][0].abs().max()):.3e}")
    finite = all(bool(torch.isfinite(x).all()) for x in grads["kernel"])
    within = (max(per_launch) <= GRAD_LAUNCH_LIMIT and rel_prompts <= GRAD_FLOOR_RATIO * floor_prompts
              and rel_ctx <= GRAD_FLOOR_RATIO * floor_ctx)
    if not finite or not launched.get("bwd_mma_short") or not within:
        raise AssertionError("the gradient through the kernel backward disagrees with the plain backward")
    return {"grad_launch_rel_l2_max": max(per_launch), "grad_prompts_rel_l2": rel_prompts, "grad_ctx_rel_l2": rel_ctx,
            "grad_prompts_noise_floor": floor_prompts, "grad_ctx_noise_floor": floor_ctx,
            "grad_ctx_max_abs_diff": max_abs}


def episode_timing_and_reference(out_dir):
    """Phase 4b: on one group, views built on the card (the AugMix kernel,
    sampling and patchify) against the host pipeline; the episode ms/img on
    the card-built tokens (bf16) and the device's busy share over a whole
    fused group; the fused-attention episode held to the dense one in fp32."""
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.data import native
    from rlcf_torch.data.class_names import get_classnames
    from rlcf_torch.data.datasets import SyntheticDataset
    from rlcf_torch.ops.augmix import fused_views

    names = get_classnames("A")
    imgs = np.stack([SyntheticDataset(n=GROUP, n_classes=200)[i][0] for i in range(GROUP)])
    make_views = lambda: native.generate_views_native_patch_u8(imgs, n_views=VIEWS, p_policy=16, resolution=RES,
                                                                seed=0)
    make_views()
    t0 = time.perf_counter()
    for _ in range(3):
        make_views()
    out = {"host_views_ms_per_group": (time.perf_counter() - t0) / 3 * 1e3}
    planar = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()).cuda()
    device_views = lambda: fused_views(planar, torch.Generator(device="cuda").manual_seed(0), n_views=VIEWS,
                                       resolution=RES, src_size=SRC_SIZE, p_policy=16, p_reward=14)
    out["device_views_ms_per_group"] = time_ms(device_views, reps=10)
    log(f"VIEWS per group of {GROUP}x{VIEWS}: on the card {out['device_views_ms_per_group']:.3f} ms "
        f"(sampling + AugMix kernel + patchify), on the host {out['host_views_ms_per_group']:.1f} ms")
    toks = device_views()
    clf, _, _ = tta_cls.build(tta_cls.get_args(flagship_argv(out_dir)))
    clf.setup(names)
    ep = lambda: clf.adapt_tokens(*toks)[0].float().cpu()
    ep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        ep()
    out["episode_ms_per_img"] = (time.perf_counter() - t0) / 3 / GROUP * 1e3
    out.update(profile_episode(lambda: clf.adapt_tokens(*device_views())[0].float().cpu()))
    out.update(gradient_check(clf, toks))
    del clf
    torch.cuda.empty_cache()

    clf, _, _ = tta_cls.build(tta_cls.get_args(flagship_argv(out_dir, precision="fp32")))
    clf.setup(names)
    fused_logits, fused_aux = clf.adapt_tokens(*toks)
    ep = lambda: clf.adapt_tokens(*toks)[0].float().cpu()   # fp32: the 3xTF32 attention kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        ep()
    out["fp32_episode_ms_per_img"] = (time.perf_counter() - t0) / 2 / GROUP * 1e3
    out.update({f"fp32_{k}": v for k, v in profile_episode(ep, "fp32 episode (views pre-built)").items()})
    clf.attn = clf.reward_attn = "dense"
    clf.setup(names)
    dense_logits, dense_aux = clf.adapt_tokens(*toks)
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


def encoder_argv(out_dir, precision="bf16", limit=ENCODER_IMAGES, arch=POLICY, res=RES, extra=()):
    """``scripts/rlcf-tune.sh``'s settings: a policy (ViT-B/16 there) tuned
    against a ViT-L/14 reward, 64 views, selection 0.1, sample_k 3, 3 steps
    at lr 1e-5, momentum EMA re-anchored every 256 images, one image a group,
    full remat; views at ``res``."""
    return [".", "--test_sets", "synthetic", "--synthetic_classes", "A", "--limit", str(limit),
            "--arch", arch, "--resolution", str(res), "--reward_arch", REWARD, "--precision", precision,
            "--device", "cuda", "--batch_size", str(VIEWS), "--selection_p", "0.1", "--sample_k", "3",
            "--tta_steps", str(STEPS), "--lr", "1e-5", "--momentum_update", "1", "--update_freq", "256",
            "--episode_group", "1", "--remat", "full", "--seed", "0", "--output", out_dir, *extra]


def run_encoder(out_dir, limit, precision="bf16", arch=POLICY, res=RES, path=None, extra=()):
    """Phase 4c: encoder TTA through ``rlcf_torch.cli.tune_cls``; returns its
    numbers (the kernels' launches by shape over the whole run, setup's
    class features included). A ViT policy must launch the attention
    backward its T takes; a ResNet policy has none (its attention pool is
    dense), and its reward's forward goes through the kernel."""
    from rlcf_torch.cli import tune_cls
    from rlcf_torch.models.clip import get_config
    from rlcf_torch.ops import attention as A
    from rlcf_torch.ops import augmix as X
    from rlcf_torch.tasks.classification import EncoderTTAClassifier

    seen = []
    adapt = EncoderTTAClassifier.adapt

    def recording(self, views, **kw):
        logits, aux = adapt(self, views, **kw)
        seen.append((tuple(views.shape), logits.detach(), aux["losses"].detach()))
        return logits, aux

    EncoderTTAClassifier.adapt = recording
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()                 # counts start at 0 just before the path
    X.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        results = tune_cls.main(encoder_argv(out_dir, precision=precision, limit=limit, arch=arch, res=res,
                                             extra=extra))
        wall = time.perf_counter() - t0
    finally:
        EncoderTTAClassifier.adapt = adapt
    launches = {**A.LAUNCHES, **X.LAUNCHES}     # read just after
    by_shape = {**A.LAUNCH_SHAPES, **X.LAUNCH_SHAPES}
    variants = dict(A.LAUNCH_VARIANTS)
    for shape, logits, losses in seen:
        if shape != (1, VIEWS, res, res, 3) or tuple(logits.shape) != (1, 200) or tuple(losses.shape) != (1, STEPS) \
                or not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"encoder views {shape}, logits {tuple(logits.shape)}, losses {tuple(losses.shape)}: "
                                 f"not finite [1, 200] and [1, {STEPS}] from [1, {VIEWS}, {res}, {res}, 3] views")
    cfg = get_config(arch)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    bwd = "bwd_" + A.backward_variant(cfg.grid_size ** 2 + 1, dtype) if cfg.is_vit else None
    if len(seen) != limit or launches["augmix"] != limit or not launches["fwd"] or (bwd and not variants.get(bwd)):
        raise AssertionError(f"encoder {arch} --precision {precision} did not go through the kernels: "
                             f"images={len(seen)} launches={launches} variants={variants}")
    secs = results["synthetic"]["group_seconds"]
    timed = secs[1:]  # the first image warms up
    path = path or ("encoder" if precision == "bf16" else f"encoder {precision}")
    return {"path": path, "arch": arch, "resolution": res, "precision": precision, "extra": list(extra),
            "images": len(secs), "group_seconds": secs, "img_per_s": len(timed) / sum(timed) if timed else None,
            "wall_s": wall, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
            "launch_variants": variants, "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()},
            "top1": results["synthetic"]["top1"]}


def encoder_gradient_check(clf, views, label="encoder"):
    """Phase 4c, bf16 at full width: the gradient of one step's loss in the
    visual tower's weights (all of them, one vector) through its layers on
    the 6 selected views, the kernel backward against the plain backward on
    one forward, held to the noise floor as ``gradient_check``."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.core.episode import step_loss, take_rows
    from rlcf_torch.core.losses import entropy_per_sample, select_confident_entropy
    from rlcf_torch.ops import attention as A
    from rlcf_torch.tasks.classification import maybe_normalize_u8

    remat, clf.remat = clf.remat, False   # one stored forward whose graph is differentiated three times
    try:
        cache = {"views": maybe_normalize_u8(views)}
        t = Po.tree_map(lambda v: v.detach()[None].clone().requires_grad_(True), clf.trainable0)
        with torch.no_grad():
            n_keep = max(1, int(VIEWS * clf.ecfg.selection_p))
            all_idx = torch.arange(VIEWS, device=views.device)[None]
            sel = select_confident_entropy(entropy_per_sample(clf.policy_logits(t, cache, all_idx)), n_keep)
            r_sim = clf.reward_image_sim(take_rows(cache["views"], sel))
        loss = step_loss(clf.policy_logits(t, cache, sel), r_sim, clf.ecfg, clf.reward.score_samples,
                         clf.reward.params["logit_scale"].exp().float()).sum()
        leaves = Po.tree_leaves(t)
        grads, per_launch, launched = grads_through_backwards(loss, leaves)
    finally:
        clf.remat = remat
    T = clf.clip_cfg.grid_size ** 2 + 1
    variant = "bwd_" + A.backward_variant(T, torch.bfloat16)
    flat = {name: torch.cat([g.float().flatten() for g in gs]) for name, gs in grads.items()}
    rel, floor = rel_l2(flat["kernel"], flat["plain"]), rel_l2(flat["jittered"], flat["plain"])
    log(f"GRAD {label} bf16 full width, d loss / d visual weights ({flat['plain'].numel()} of them, {len(leaves)} "
        f"tensors) through {clf.clip_cfg.vision_layers} layers at B={n_keep} T={T} "
        f"({launched}), kernel backward against plain backward: per launch on its own inputs, relative L2 error "
        f"{min(per_launch):.3e} to {max(per_launch):.3e} (limit {GRAD_LAUNCH_LIMIT}); relative L2 error {rel:.3e} "
        f"(noise floor {floor:.3e}, limit {GRAD_FLOOR_RATIO:g} x the floor)")
    if not bool(torch.isfinite(flat["kernel"]).all()) or not launched.get(variant) \
            or max(per_launch) > GRAD_LAUNCH_LIMIT or rel > GRAD_FLOOR_RATIO * floor:
        raise AssertionError(f"the {label} gradient through the kernel backward disagrees with the plain backward")
    return {"grad_launch_rel_l2_max": max(per_launch), "grad_visual_rel_l2": rel, "grad_visual_noise_floor": floor}


def encoder_timing_and_reference(out_dir, arch=POLICY, res=RES, label="encoder", by_remat=True, time_fp32=False):
    """Phase 4c: on one image's views built beforehand, the bf16 encoder
    episode's ms/img and its device busy share (torch.profiler), with
    ``by_remat`` the same for each --remat and the share of visual-tower
    weights one bf16 episode changed, the GRAD check, with ``time_fp32`` the
    fp32 episode's ms/img and device busy (under ``fp32``), and the
    fused-attention episode held to the dense one in fp32 at full width
    (REFERENCE: selections equal, logits and losses within 1e-3 x
    max(|logits|, 1) and 1e-3, the flagship REFERENCE's tolerance). Episodes
    start from the momentum state's anchor, which the timed episodes do not
    move (it re-anchors every 256 images)."""
    from rlcf_torch.cli import tune_cls
    from rlcf_torch.core import policy as Po
    from rlcf_torch.data.class_names import get_classnames

    names = get_classnames("A")
    views = encoder_views(res)
    clf, _, _ = tune_cls.build(tune_cls.get_args(encoder_argv(out_dir, arch=arch, res=res)))
    clf.setup(names)
    out = time_encoder_episode(clf, views, f"{label} episode (views pre-built, bf16)")
    ep = lambda: clf.adapt(views)[0].float().cpu()
    if by_remat:
        out["by_remat"] = {}
        for remat, setting in (("save_attn", "save_attn"), ("none", False), ("full", True)):   # the CLI's --remat
            clf.remat = setting
            torch.cuda.reset_peak_memory_stats()
            ep()
            t0 = time.perf_counter()
            for _ in range(2):
                ep()
            out["by_remat"][remat] = {"episode_ms_per_img": (time.perf_counter() - t0) / 2 * 1e3,
                                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"ENCODER bf16 episode by --remat (views pre-built): {json.dumps(out['by_remat'])}")
        anchor = Po.tree_leaves(clf.momentum_state.reset_params)
        _, aux = clf.adapt(views, return_adapted=True)
        adapted = [a[0] for a in Po.tree_leaves(aux["adapted"])]
        changed = sum(int((a != b).sum()) for a, b in zip(adapted, anchor))
        total = sum(a.numel() for a in anchor)
        out.update(weights_changed=changed, weights_total=total, weights_changed_share=changed / total)
        log(f"ENCODER bf16 weights one episode changed (lr 1e-5, 3 AdamW steps, bf16 weights): {changed} of {total}, "
            f"share {changed / total:.4f}")
        del aux, adapted, anchor
    out.update(encoder_gradient_check(clf, views, label))
    del clf
    torch.cuda.empty_cache()

    clf, _, _ = tune_cls.build(tune_cls.get_args(encoder_argv(out_dir, precision="fp32", arch=arch, res=res)))
    clf.setup(names)
    if time_fp32:
        out["fp32"] = time_encoder_episode(clf, views, f"{label} episode (views pre-built, fp32)")
    fused_logits, fused_aux = clf.adapt(views)   # the momentum fold moves the EMA only: the next starts alike
    clf.attn = clf.reward_attn = "dense"
    clf.setup(names)
    dense_logits, dense_aux = clf.adapt(views)
    same_sel = bool(torch.equal(fused_aux["selected"], dense_aux["selected"]))
    d_logits = float((fused_logits - dense_logits).abs().max())
    d_losses = float((fused_aux["losses"] - dense_aux["losses"]).abs().max())
    scale = float(dense_logits.abs().max())
    log(f"REFERENCE {label} fp32 full width, fused vs dense attention: selections equal={same_sel} "
        f"max|d logits|={d_logits:.3e} (of max {scale:.3e}) max|d losses|={d_losses:.3e}")
    if not same_sel or d_logits > 1e-3 * max(scale, 1.0) or d_losses > 1e-3:
        raise AssertionError(f"fused-attention {label} episode disagrees with the dense episode in fp32")
    out.update(fp32_selected_equal=same_sel, fp32_max_abs_logit_diff=d_logits, fp32_max_abs_loss_diff=d_losses)
    del clf
    torch.cuda.empty_cache()
    return out


def encoder_views(res):
    """One synthetic image's VIEWS views at ``res``, built beforehand by the
    AugMix kernel: NHWC u8 ``[1, VIEWS, res, res, 3]``."""
    from rlcf_torch.data.datasets import SyntheticDataset
    from rlcf_torch.ops.augmix import fused_views

    img = SyntheticDataset(n=1, n_classes=200)[0][0]
    planar = torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).cuda()
    return fused_views(planar, torch.Generator(device="cuda").manual_seed(0), n_views=VIEWS, resolution=res,
                       src_size=SRC_SIZE).permute(0, 1, 3, 4, 2)


def time_encoder_episode(clf, views, what):
    """An encoder episode on views built beforehand: ms/img over three after a
    warm-up, their peak memory, and one episode's device busy share."""
    ep = lambda: clf.adapt(views)[0].float().cpu()
    ep()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(3):
        ep()
    out = {"episode_ms_per_img": (time.perf_counter() - t0) / 3 * 1e3,
           "episode_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    out.update(profile_episode(ep, what))
    return out


def resnet_encoder_episode(out_dir, prior):
    """Phase 4c, an RN50 policy (bf16): the episode on one image's views
    built beforehand (``time_encoder_episode``), with ``--prior_strength
    prior`` (None: without)."""
    from rlcf_torch.cli import tune_cls
    from rlcf_torch.data.class_names import get_classnames

    extra = () if prior is None else ("--prior_strength", str(prior))
    clf, _, _ = tune_cls.build(tune_cls.get_args(encoder_argv(out_dir, arch=RESNET_POLICY, extra=extra)))
    clf.setup(get_classnames("A"))
    out = {"bn_prior": prior, **time_encoder_episode(
        clf, encoder_views(RES), f"encoder {RESNET_POLICY} episode, bn_prior {prior} (views pre-built, bf16)")}
    del clf
    torch.cuda.empty_cache()
    return out


def run_zero_shot(out_dir):
    """Phase 4d: zero-shot through ``rlcf_torch.cli.zero_shot`` over the
    ensemble ZERO_SHOT_ARCHS (each taking the batch resized to its own
    resolution) on ZERO_SHOT_IMAGES synthetic images in one batch; the
    ensemble's logits read where the accuracy meter takes them."""
    from rlcf_torch.cli import zero_shot
    from rlcf_torch.metrics.classification import AccuracyMeter
    from rlcf_torch.ops import attention as A

    seen = []
    update = AccuracyMeter.update

    def recording(self, logits, labels):
        seen.append(np.asarray(logits))
        return update(self, logits, labels)

    AccuracyMeter.update = recording
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()                 # counts start at 0 just before the path
    try:
        t0 = time.perf_counter()
        results = zero_shot.main([".", "--test_sets", "synthetic", "--synthetic_classes", "A", "--limit",
                                  str(ZERO_SHOT_IMAGES), "--device", "cuda", "--precision", "bf16", "--seed", "0",
                                  "--ensemble_archs", *ZERO_SHOT_ARCHS, "--output", out_dir])
        wall = time.perf_counter() - t0
    finally:
        AccuracyMeter.update = update
    launches, by_shape = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES)   # read just after
    if [x.shape for x in seen] != [(ZERO_SHOT_IMAGES, 200)] or not np.isfinite(seen[0]).all() \
            or not by_shape.get(("fwd", ZERO_SHOT_IMAGES, 577, 16, str(torch.bfloat16))):
        raise AssertionError(f"zero-shot logits {[x.shape for x in seen]} not finite [{ZERO_SHOT_IMAGES}, 200], or "
                             f"the ViT-L/14@336px tower did not go through the kernel: {by_shape}")
    return {"path": "zero-shot", "archs": list(ZERO_SHOT_ARCHS), "images": ZERO_SHOT_IMAGES, "wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
            "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()},
            **results["synthetic"]}


def ensemble_timing_and_reference(out_dir):
    """Phase 4d: on one group of NHWC views built on the host, the host
    views' ms, the bf16 ensemble episode's ms/img and device busy share
    (torch.profiler, views pre-built), and the fused-attention episode held
    to the dense one in fp32 (REFERENCE ensemble: selections equal, logits
    and losses within the flagship REFERENCE's tolerance), whose launches are
    the path "ensemble reference fp32"."""
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.data import native
    from rlcf_torch.data.class_names import get_classnames
    from rlcf_torch.data.datasets import SyntheticDataset
    from rlcf_torch.ops import attention as A

    names = get_classnames("A")
    imgs = np.stack([SyntheticDataset(n=GROUP, n_classes=200)[i][0] for i in range(GROUP)])
    make_views = lambda: native.generate_views_native_u8(imgs, n_views=VIEWS, resolution=RES, seed=0)
    views = make_views()
    t0 = time.perf_counter()
    for _ in range(3):
        make_views()
    out = {"host_views_ms_per_group": (time.perf_counter() - t0) / 3 * 1e3}
    clf, _, _ = tta_cls.build(tta_cls.get_args(flagship_argv(out_dir, viewgen="native", extra=ENSEMBLE_ARGS)))
    clf.setup(names)
    ep = lambda: clf.adapt(views)[0].float().cpu()
    ep()
    t0 = time.perf_counter()
    for _ in range(2):
        ep()
    out["episode_ms_per_img"] = (time.perf_counter() - t0) / 2 / GROUP * 1e3
    out.update(profile_episode(ep, "ensemble episode (host views pre-built, bf16)"))
    del clf
    torch.cuda.empty_cache()

    clf, _, _ = tta_cls.build(tta_cls.get_args(flagship_argv(out_dir, "fp32", viewgen="native", extra=ENSEMBLE_ARGS)))
    clf.setup(names)
    A.reset_launch_counts()                 # the fused fp32 episode's launches, read just after
    fused_logits, fused_aux = clf.adapt(views)
    torch.cuda.synchronize()
    out["reference_launches_by_shape"] = {" ".join(map(str, k)): v for k, v in A.LAUNCH_SHAPES.items()}
    clf.attn = clf.reward_attn = "dense"
    clf.setup(names)
    dense_logits, dense_aux = clf.adapt(views)
    same_sel = bool(torch.equal(fused_aux["selected"], dense_aux["selected"]))
    d_logits = float((fused_logits - dense_logits).abs().max())
    d_losses = float((fused_aux["losses"] - dense_aux["losses"]).abs().max())
    scale = float(dense_logits.abs().max())
    log(f"REFERENCE ensemble fp32 full width, fused vs dense attention: selections equal={same_sel} "
        f"max|d logits|={d_logits:.3e} (of max {scale:.3e}) max|d losses|={d_losses:.3e}")
    if not same_sel or d_logits > 1e-3 * max(scale, 1.0) or d_losses > 1e-3:
        raise AssertionError("fused-attention ensemble episode disagrees with the dense episode in fp32")
    out.update(fp32_selected_equal=same_sel, fp32_max_abs_logit_diff=d_logits, fp32_max_abs_loss_diff=d_losses)
    del clf
    torch.cuda.empty_cache()
    return out


def write_fine_grained_tree(root, set_id, labels, names=None, size=(40, 56), seed=0):
    """A synthetic tree of the fine-grained set ``set_id`` under the data root
    ``root``, in the layout its loader reads. For a Zhou-split set: the images
    under the set's subdirectory and the split JSON ({split: [[path, label,
    name], ...]}). For ``aircraft``: ``variants.txt`` (the names in file
    order) and ``images_variant_{split}.txt`` over ``images/<id>.jpg``.
    ``labels`` maps each split to its images' labels in listing order;
    ``names`` are the class names (``class_<c>`` / ``variant-<c>`` without).
    The images are random pixels of ``size``, PNG for odd labels and JPEG
    for even ones (aircraft's all JPEG), drawn in listing order from
    ``seed``. Returns ``root``."""
    from PIL import Image

    from rlcf_torch.data.datasets import ID_TO_DIRNAME, JSON_SPLITS

    rng = np.random.default_rng(seed)
    base = os.path.join(str(root), ID_TO_DIRNAME[set_id])
    n_classes = 1 + max(max(ls, default=0) for ls in labels.values())

    def image(rel):
        os.makedirs(os.path.dirname(os.path.join(base, rel)), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, size=tuple(size) + (3,), dtype=np.uint8)).save(os.path.join(base, rel))

    if set_id == "aircraft":
        names = names or [f"variant-{c:03d}" for c in range(n_classes)]
        os.makedirs(base, exist_ok=True)
        with open(os.path.join(base, "variants.txt"), "w") as fh:
            fh.write("\n".join(names) + "\n")
        for s, (split, ls) in enumerate(labels.items()):
            lines = []
            for k, c in enumerate(ls):
                img_id = f"{1000000 + 10000 * s + k}"
                image(os.path.join("images", f"{img_id}.jpg"))
                lines.append(f"{img_id} {names[c]}")
            with open(os.path.join(base, f"images_variant_{split}.txt"), "w") as fh:
                fh.write("\n".join(lines) + "\n")
        return str(root)
    names = names or [f"class_{c:03d}" for c in range(n_classes)]
    subdir, split_json = JSON_SPLITS[set_id]
    split = {}
    for name, ls in labels.items():
        split[name] = []
        for k, c in enumerate(ls):
            rel = f"class_{c:03d}/{name}_{k}.{'png' if c % 2 else 'jpg'}"
            image(os.path.join(subdir, rel))
            split[name].append([rel, c, names[c]])
    with open(os.path.join(base, split_json), "w") as fh:
        json.dump(split, fh)
    return str(root)


def write_cars_tree(root, n_images):
    """The smoke's Stanford Cars tree (``write_fine_grained_tree``): a test
    split of ``n_images`` 240x360 images, labels spread over the 196 classes
    and their names."""
    from rlcf_torch.data.class_names import get_classnames

    names = get_classnames(FINE_SET)
    return write_fine_grained_tree(root, FINE_SET, {"train": [], "val": [],
                                                    "test": [(37 * i) % len(names) for i in range(n_images)]},
                                   names=names, size=(240, 360))


def write_bongard_tree(root, n_tasks, size=(48, 56), swap_split=False, seed=0):
    """A synthetic Bongard-HOI tree under ``root``: ``data/bongard_splits/
    bongard_hoi_test_unseen_obj_unseen_act.json`` over 7 + 7 JPEGs of ``size``
    a task (bright positives, dark negatives). With ``swap_split`` the list
    names the first image of each task under ``pic/image/val`` while the file
    lies under ``pic/image/train``: the loader's train/val swap finds it."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    tasks = []
    for t in range(n_tasks):
        neg, pos = [], []
        for i in range(7):
            for polarity, items in (("neg", neg), ("pos", pos)):
                folder = "pic/image/train" if swap_split and i == 0 else "imgs"
                rel = f"{folder}/{polarity}_{t}_{i}.jpg"
                mean = 40 if polarity == "neg" else 210
                arr = np.clip(rng.normal(mean, 20, size=tuple(size) + (3,)), 0, 255).astype(np.uint8)
                os.makedirs(os.path.join(str(root), folder), exist_ok=True)
                Image.fromarray(arr).save(os.path.join(str(root), rel))
                items.append({"im_path": "./" + rel.replace("pic/image/train", "pic/image/val")})
        tasks.append([neg, pos, f"ride++horse_{t}"])
    split_dir = os.path.join(str(root), "data", "bongard_splits")
    os.makedirs(split_dir, exist_ok=True)
    with open(os.path.join(split_dir, "bongard_hoi_test_unseen_obj_unseen_act.json"), "w") as fh:
        json.dump(tasks, fh)
    return str(root)


def fine_argv(data_root, out_dir):
    """``scripts/rlcf-prompt-fine.sh`` on Stanford Cars: ViT-B/16 policy,
    ViT-L/14 reward, 5 steps at lr 7e-3, 64 views, selection 0.1, sample_k 3,
    views built on the card, bf16, group 4."""
    return [data_root, "--test_sets", FINE_SET, "--limit", str(FINE_IMAGES), "--arch", POLICY, "--reward_arch", REWARD,
            "--resolution", str(RES), "--precision", "bf16", "--device", "cuda", "--viewgen", "fused", "--loss", "rlcf", "--batch_size",
            str(VIEWS), "--selection_p", "0.1", "--sample_k", "3", "--tta_steps", str(FINE_STEPS), "--lr", "7e-3",
            "--ctx_init", "a_photo_of_a", "--episode_group", str(GROUP), "--seed", "0", "--output", out_dir]


def cocoop_argv(out_dir, precision="bf16"):
    """``scripts/tpt-prompt.sh`` with ``--cocoop``: the ViT-B/16 policy, the
    TPT loss, 1 step at lr 5e-3, 64 views built on the host (NHWC), selection
    0.1, group 4, ImageNet-A's 200 class names on synthetic images."""
    return [".", "--test_sets", "synthetic", "--synthetic_classes", "A", "--limit", str(COCOOP_IMAGES), "--arch",
            POLICY, "--resolution", str(RES), "--precision", precision, "--device", "cuda", "--cocoop", "--loss", "tpt", "--viewgen", "native",
            "--batch_size", str(VIEWS), "--selection_p", "0.1", "--tta_steps", str(COCOOP_STEPS), "--lr", "5e-3",
            "--ctx_init", "a_photo_of_a", "--episode_group", str(GROUP), "--seed", "0", "--output", out_dir]


def bongard_argv(data_root, out_dir):
    """Bongard-HOI through ``tta_cls``: the ViT-B/16 policy at 224 px, the
    learnable class token, four tasks a group, the CLI's other defaults
    (random fp32 context, 1 step at lr 5e-3), bf16 towers."""
    return [data_root, "--test_sets", "bongard", "--learned_cls", "1", "--resolution", str(RES), "--episode_group",
            str(GROUP), "--limit", str(BONGARD_TASKS), "--arch", POLICY, "--precision", "bf16", "--device", "cuda",
            "--seed", "0", "--output", out_dir]


def run_tta_cls_path(path, argv, owner, attr, check):
    """Phase 4e: one ``tta_cls`` path, ``owner.attr`` (the classifier's entry
    point) wrapped to record each group's call and what it returns, the launch
    counters set to 0 just before the run and read just after;
    ``check(outputs, launches)`` raises where the outputs or the launches are
    wrong. Items a second leave the first group out. Returns the path's
    numbers and the last group's (classifier, arguments)."""
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.ops import attention as A
    from rlcf_torch.ops import augmix as X

    seen, original = [], getattr(owner, attr)

    def recording(self, *args):
        out = original(self, *args)
        seen.append((self, args, out))
        return out

    setattr(owner, attr, recording)
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()                 # counts start at 0 just before the path
    X.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        (result,) = tta_cls.main(argv).values()
        wall = time.perf_counter() - t0
    finally:
        setattr(owner, attr, original)
    launches = {**A.LAUNCHES, **X.LAUNCHES}     # read just after
    by_shape, variants = {**A.LAUNCH_SHAPES, **X.LAUNCH_SHAPES}, dict(A.LAUNCH_VARIANTS)
    check([out for _, _, out in seen], launches)
    secs = result["group_seconds"]
    timed = secs[1:]
    n_items = result["n"] if "n" in result else result["n_tasks"]
    return {"path": path, "groups": len(secs), "items": n_items, "group_seconds": secs,
            "items_per_s": GROUP * len(timed) / sum(timed) if timed else None, "wall_s": wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
            "launch_variants": variants, "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()},
            "launches_per_item_by_shape": {" ".join(map(str, k)): v / n_items for k, v in by_shape.items()},
            "top1": result["top1"]}, seen[-1][:2]


def expect_groups(path, n_groups, shapes, need):
    """A ``check`` for ``run_tta_cls_path``: ``n_groups`` groups ran, each
    output (the logits and an aux dict of losses) has the shapes ``shapes``
    and is finite, and every counter of ``need`` is ``need``'s value or,
    where that is None, above 0."""
    def check(outputs, counts):
        for logits, aux in outputs:
            got = (tuple(logits.shape), tuple(aux["losses"].shape))
            if got != shapes or not bool(torch.isfinite(logits).all()) or not bool(torch.isfinite(aux["losses"]).all()):
                raise AssertionError(f"{path}: logits and losses {got}, not finite {shapes}")
        wrong = {k: counts[k] for k, v in need.items() if (counts[k] == 0 if v is None else counts[k] != v)}
        if len(outputs) != n_groups or wrong:
            raise AssertionError(f"{path} did not go through the kernels: groups={len(outputs)} launches={counts}")
    return check


def classification_rest(out_dir):
    """Phase 4e: the rest of the classification application at full width:
    Stanford Cars (FINE), CoCoOp (COCOOP, with REFERENCE cocoop: the fp32
    fused-attention episode held to the dense one on a group, selections
    equal, logits and losses within 2e-4 + 2e-4 x |dense|) and Bongard-HOI
    (BONGARD); each path's last group profiled again on its inputs built
    beforehand (views, or preprocessed task images)."""
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.data.class_names import get_classnames
    from rlcf_torch.tasks.bongard import BongardTTA
    from rlcf_torch.tasks.classification import CoCoOpTTAClassifier, PromptTTAClassifier

    root = os.path.dirname(out_dir)
    cars = write_cars_tree(os.path.join(root, "chip_smoke_cars"), FINE_IMAGES)
    fine, (clf, toks) = run_tta_cls_path("fine cars", fine_argv(cars, out_dir), PromptTTAClassifier, "adapt_tokens",
                                         expect_groups("fine cars", FINE_IMAGES // GROUP,
                                                       ((GROUP, len(get_classnames(FINE_SET))), (GROUP, FINE_STEPS)),
                                                       {"fwd": None, "bwd": None, "augmix": FINE_IMAGES // GROUP}))
    fine.update(profile_episode(lambda: clf.adapt_tokens(*toks)[0].float().cpu(), "fine cars episode (views pre-built)"))
    del clf, toks
    log("FINE " + json.dumps({k: fine[k] for k in (
        "items_per_s", "group_seconds", "wall_s", "peak_mem_gib", "profile_device_busy_ms", "profile_idle_share",
        "profile_kernels", "launches_per_item_by_shape", "top1")}))

    cocoop, (clf, (views,)) = run_tta_cls_path(
        "cocoop", cocoop_argv(out_dir), CoCoOpTTAClassifier, "adapt",
        expect_groups("cocoop", COCOOP_IMAGES // GROUP, ((GROUP, 200), (GROUP, COCOOP_STEPS)),
                      {"fwd": None, "bwd": None, "augmix": 0}))
    cocoop.update(profile_episode(lambda: clf.adapt(views)[0].float().cpu(), "cocoop episode (views pre-built, bf16)"))
    del clf
    torch.cuda.empty_cache()
    clf, _, _ = tta_cls.build(tta_cls.get_args(cocoop_argv(out_dir, "fp32")))
    clf.setup(get_classnames("A"))
    fused_logits, fused_aux = clf.adapt(views)
    clf.attn = "dense"
    dense_logits, dense_aux = clf.adapt(views)
    same_sel = bool(torch.equal(fused_aux["selected"], dense_aux["selected"]))
    share = max(float(((a - b).abs() / (2e-4 + 2e-4 * b.abs())).max())
                for a, b in ((fused_logits, dense_logits), (fused_aux["losses"], dense_aux["losses"])))
    log(f"REFERENCE cocoop fp32 full width, fused vs dense attention: selections equal={same_sel} "
        f"max|d logits|={float((fused_logits - dense_logits).abs().max()):.3e} (of max "
        f"{float(dense_logits.abs().max()):.3e}) max|d losses|="
        f"{float((fused_aux['losses'] - dense_aux['losses']).abs().max()):.3e}; worst / (2e-4 + 2e-4 |dense|) "
        f"{share:.3f}")
    if not same_sel or share > 1:
        raise AssertionError("fused-attention CoCoOp episode disagrees with the dense episode in fp32")
    cocoop.update(fp32_selected_equal=same_sel, fp32_worst_share_of_tolerance=share)
    del clf
    torch.cuda.empty_cache()
    log("COCOOP " + json.dumps({k: cocoop[k] for k in (
        "items_per_s", "group_seconds", "wall_s", "peak_mem_gib", "profile_device_busy_ms", "profile_idle_share",
        "profile_kernels", "launches_per_item_by_shape", "fp32_selected_equal", "fp32_worst_share_of_tolerance")}))

    hoi = write_bongard_tree(os.path.join(root, "chip_smoke_bongard"), BONGARD_TASKS, size=BONGARD_SIZE)
    bongard, (tta, (imgs, labels)) = run_tta_cls_path(
        "bongard", bongard_argv(hoi, out_dir), BongardTTA, "adapt_tasks",
        expect_groups("bongard", BONGARD_TASKS // GROUP, ((GROUP, 2, 2), (GROUP, 1)), {"fwd": None, "bwd": None}))
    if imgs.dtype != np.float32:   # host-normalised float NHWC, not u8
        raise AssertionError(f"Bongard task images reached the classifier as {imgs.dtype}, not float32")
    bongard.update(profile_episode(lambda: tta.adapt_tasks(imgs, labels)[0].float().cpu(),
                                   "bongard group of tasks (images preprocessed beforehand)"))
    del tta
    torch.cuda.empty_cache()
    log("BONGARD " + json.dumps({"tasks_per_s": bongard["items_per_s"], **{k: bongard[k] for k in (
        "group_seconds", "wall_s", "peak_mem_gib", "profile_device_busy_ms", "profile_idle_share", "profile_kernels",
        "launches_per_item_by_shape", "top1")}, "launch_note": "launches per task; group seconds: a whole group, "
        "the host's image decoding and preprocessing included"}))
    return [fine, cocoop, bongard]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3 (kernel checks) with exit code 3 and no device line")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    start = time.perf_counter()
    import rlcf_torch  # noqa: F401  (fails outside a checkout of the repo)
    from rlcf_torch.data import native
    from rlcf_torch.data.class_names import get_classnames
    from rlcf_torch.ops import attention as A
    from rlcf_torch.ops import augmix as X
    from rlcf_torch.ops import cuda_build
    from rlcf_torch.tokenizer import tokenize

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # phase 2: one nvcc per source, all started together, beside the host pipeline's g++
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        builds = [pool.submit(A.build_mma, force=True), pool.submit(A.build_bwd_mma, force=True),
                  pool.submit(A.build_tf32, force=True), pool.submit(A.build_bwd_tf32, force=True),
                  pool.submit(X.build, force=True), pool.submit(native.available)]
        results = [b.result() for b in builds]
    for name in ("rlcf_attention_mma", "rlcf_attention_bwd_mma", "rlcf_attention_tf32", "rlcf_attention_bwd_tf32",
                 "rlcf_augmix"):
        for line in cuda_build.PTXAS[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"PTXAS {name}: " + line.strip()[:200])
            elif "Performance" in line:   # the whole line: it names the function at its end
                log(f"PTXAS {name}: " + line.strip())
    if not results[-1]:
        raise RuntimeError("the host view pipeline (native/rlcf_host.cpp) did not build")
    log(f"BUILD nvcc x5 and g++ in parallel: {time.perf_counter() - t0:.1f} s")

    # phase 3: the main path's shapes (group 4: 256 policy views, 24 selected
    # reward views, 4 x 200 text prompts), plus the backward at the vision
    # towers' lengths (T=257, and T=197 as training the policy tower would run it)
    t_text = text_seq_len(get_classnames("A"))
    # Stanford Cars' prompts (T = 24: the long kernels over 64-row tiles) for 4 images and at setup (the policy's
    # text tower; the reward's class features take the dense attention, as in the JAX package); Bongard-HOI's
    # group of 4 tasks (14 images each; two prompts "X X X X X." each, T = 8)
    n_cars, t_cars = len(get_classnames(FINE_SET)), text_seq_len(get_classnames(FINE_SET))
    t_bongard = -(-(int(tokenize(["X X X X X."]).argmax()) + 1) // 8) * 8
    # encoder TTA's (one image: 64 views to select from, 6 selected views
    # through the steps and the reward, view 0 for the prediction)
    n_sel = int(VIEWS * 0.1)
    shapes = [("fwd", 256, 197, 12, False, "policy"), ("fwd", 24, 257, 16, False, "reward"),
              ("fwd", 200, t_text, 8, True, "text-setup"), ("fwd", GROUP * 200, t_text, 8, True, "text"),
              ("bwd", GROUP * 200, t_text, 8, True, "text"), ("bwd", 24, 257, 16, False, "T257"),
              ("bwd", 24, 197, 12, False, "T197"),
              ("fwd", VIEWS, 197, 12, False, "encoder select"), ("fwd", n_sel, 197, 12, False, "encoder step"),
              ("fwd", 1, 197, 12, False, "encoder final"), ("fwd", n_sel, 257, 16, False, "encoder reward"),
              ("bwd", n_sel, 197, 12, False, "encoder step"),
              # the reward ensemble's ViT-L/14@336px on a group's selected views, and zero-shot's batch
              ("fwd", GROUP * n_sel, 577, 16, False, "ensemble reward 336"),
              ("fwd", ZERO_SHOT_IMAGES, 577, 16, False, "zero-shot 336"),
              ("fwd", ZERO_SHOT_IMAGES, 197, 12, False, "zero-shot B/16"),
              ("fwd", 200, t_text, 16, True, "zero-shot RN50x64 text-setup"),
              ("fwd", 200, t_text, 12, True, "zero-shot 336 text-setup"),
              # encoder TTA of ViT-L/14@336px: 64 views selected from, 6 through the steps, view 0 predicted; the
              # xlong backward at its steps' shape and at the ensemble's batch
              ("fwd", VIEWS, 577, 16, False, "encoder 336 select"), ("fwd", n_sel, 577, 16, False, "encoder 336 step"),
              ("fwd", 1, 577, 16, False, "encoder 336 final"), ("bwd", n_sel, 577, 16, False, "encoder 336 step"),
              ("bwd", GROUP * n_sel, 577, 16, False, "T577"),
              ("fwd", GROUP * n_cars, t_cars, 8, True, "cars text"), ("bwd", GROUP * n_cars, t_cars, 8, True,
                                                                         "cars text"),
              ("fwd", n_cars, t_cars, 8, True, "cars text-setup"),
              ("fwd", 14 * GROUP, 197, 12, False, "bongard vision"),
              ("fwd", 2 * GROUP, t_bongard, 8, True, "bongard text"),
              ("bwd", 2 * GROUP, t_bongard, 8, True, "bongard text")]
    entries = []
    for dtype in (torch.bfloat16, torch.float32):
        for direction, B, T, H, masked, what in shapes:
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            entries.append(check_kernel(direction, B, T, H, dtype, masked, f"{what} B={B} T={T} H={H} {tag}"))
    for dtype in (torch.bfloat16, torch.float32):
        check_sweep("fwd", dtype)
        check_sweep("bwd", dtype)
    flash_entries = check_flash_switch()
    entries += check_augmix()
    if args.kernels_only:
        return 3

    # phase 4: each path with its counters set to 0 just before and read just after
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_flagship")
    paths = [run_flagship(out_dir, "fused", FLAGSHIP_IMAGES), run_flagship(out_dir, "native", NATIVE_IMAGES),
             run_flagship(out_dir, "fused", FP32_IMAGES, precision="fp32")]
    for flag in paths:
        log("FLAGSHIP " + json.dumps(flag))
    ep = episode_timing_and_reference(out_dir)
    log("EPISODE " + json.dumps(ep))
    encoder = [run_encoder(out_dir, ENCODER_IMAGES), run_encoder(out_dir, ENCODER_FP32_IMAGES, precision="fp32")]
    enc = encoder_timing_and_reference(out_dir)
    bf16 = encoder[0]
    log("ENCODER " + json.dumps({
        "img_per_s": bf16["img_per_s"], "fp32_img_per_s": encoder[1]["img_per_s"],
        "episode_ms_per_img": enc["episode_ms_per_img"], "device_busy_ms": enc["profile_device_busy_ms"],
        "idle_share": enc["profile_idle_share"], "kernels_per_episode": enc["profile_kernels"],
        "peak_mem_gib": bf16["peak_mem_gib"], "fp32_peak_mem_gib": encoder[1]["peak_mem_gib"],
        "weights_changed_share": enc["weights_changed_share"], "by_remat": enc["by_remat"],
        "launches_per_image_by_shape": {k: v / bf16["images"] for k, v in bf16["launches_by_shape"].items()},
        "fp32_launches_per_image_by_shape": {k: v / encoder[1]["images"]
                                             for k, v in encoder[1]["launches_by_shape"].items()},
        "launch_note": "per image over the whole run (the class features' text-setup launch once per run); "
                       "with --remat full each step's backward runs the attention forward again, so the B=6 T=197 "
                       "forward counts 36 step forwards and 36 recomputed ones an image",
        **{k: enc[k] for k in ("grad_visual_rel_l2", "grad_visual_noise_floor", "grad_launch_rel_l2_max",
                               "fp32_selected_equal", "fp32_max_abs_logit_diff", "fp32_max_abs_loss_diff")}}))
    for e in encoder:
        log("ENCODER_PATH " + json.dumps(e))
    paths += encoder
    encoder336 = [run_encoder(out_dir, ENCODER336_IMAGES, arch=POLICY336, res=RES336, path="encoder 336"),
                  run_encoder(out_dir, ENCODER336_FP32_IMAGES, "fp32", arch=POLICY336, res=RES336,
                              path="encoder 336 fp32")]
    for e in encoder336:
        log("ENCODER_PATH " + json.dumps(e))
    enc336 = encoder_timing_and_reference(out_dir, POLICY336, RES336, "encoder 336", by_remat=False, time_fp32=True)
    e336 = encoder336[0]
    log("ENCODER336 " + json.dumps({
        "img_per_s": e336["img_per_s"], "fp32_seconds_first_image": encoder336[1]["group_seconds"][0],
        "fp32_episode_ms_per_img": enc336["fp32"]["episode_ms_per_img"],
        "fp32_device_busy_ms": enc336["fp32"]["profile_device_busy_ms"],
        "fp32_idle_share": enc336["fp32"]["profile_idle_share"],
        "fp32_kernels_per_episode": enc336["fp32"]["profile_kernels"],
        "episode_ms_per_img": enc336["episode_ms_per_img"], "device_busy_ms": enc336["profile_device_busy_ms"],
        "idle_share": enc336["profile_idle_share"], "kernels_per_episode": enc336["profile_kernels"],
        "peak_mem_gib": e336["peak_mem_gib"], "episode_peak_mem_gib": enc336["episode_peak_mem_gib"],
        "fp32_peak_mem_gib": encoder336[1]["peak_mem_gib"],
        "launches_per_image_by_shape": {k: v / e336["images"] for k, v in e336["launches_by_shape"].items()},
        "fp32_launches_per_image_by_shape": {k: v / encoder336[1]["images"]
                                             for k, v in encoder336[1]["launches_by_shape"].items()},
        "launch_note": "per image over the whole run (the class features' text-setup launch once per run); "
                       "with --remat full each step's backward runs the attention forward again, so the B=6 T=577 "
                       "forward counts 72 step forwards and 72 recomputed ones an image, the backward 72",
        **{k: enc336[k] for k in ("grad_visual_rel_l2", "grad_visual_noise_floor", "grad_launch_rel_l2_max",
                                  "fp32_selected_equal", "fp32_max_abs_logit_diff", "fp32_max_abs_loss_diff")}}))
    resnet = [run_encoder(out_dir, RESNET_IMAGES, arch=RESNET_POLICY, path=f"encoder {RESNET_POLICY}"),
              run_encoder(out_dir, RESNET_IMAGES, arch=RESNET_POLICY, path=f"encoder {RESNET_POLICY} bn_prior",
                          extra=("--prior_strength", str(BN_PRIOR)))]
    for e in resnet:
        log("ENCODER_PATH " + json.dumps(e))
    rn_eps = [resnet_encoder_episode(out_dir, prior) for prior in (None, BN_PRIOR)]
    log("ENCODER_RN50 " + json.dumps([
        {"path": e["path"], "img_per_s": e["img_per_s"], "peak_mem_gib": e["peak_mem_gib"], "top1": e["top1"],
         "launches_per_image_by_shape": {k: v / e["images"] for k, v in e["launches_by_shape"].items()}, **ep}
        for e, ep in zip(resnet, rn_eps)]))
    paths += encoder336 + resnet
    ensemble = [run_flagship(out_dir, "native", ENSEMBLE_IMAGES, extra=ENSEMBLE_ARGS, path="ensemble"),
                run_flagship(out_dir, "fused", REWARD336_IMAGES, reward=REWARD336, path="fused reward 336"),
                run_zero_shot(out_dir)]
    for e in ensemble:
        log("ENSEMBLE_PATH " + json.dumps(e))
    ens, ens_ep = ensemble[0], ensemble_timing_and_reference(out_dir)
    key336 = {dtype: " ".join(map(str, ("fwd", GROUP * n_sel, 577, 16, str(dtype))))
              for dtype in (torch.bfloat16, torch.float32)}
    log("ENSEMBLE " + json.dumps({
        "img_per_s": ens["img_per_s"], "ms_per_group": 1e3 * sum(ens["group_seconds"][1:]) / (ens["groups"] - 1),
        "host_views_ms_per_group": ens_ep["host_views_ms_per_group"],
        "episode_ms_per_img": ens_ep["episode_ms_per_img"], "device_busy_ms": ens_ep["profile_device_busy_ms"],
        "idle_share": ens_ep["profile_idle_share"], "kernels_per_group": ens_ep["profile_kernels"],
        "peak_mem_gib": ens["peak_mem_gib"],
        "launches_per_image_by_shape": {k: v / (ens["groups"] * GROUP) for k, v in ens["launches_by_shape"].items()},
        "reward336_group_seconds": ensemble[1]["group_seconds"], "zero_shot_wall_s": ensemble[2]["wall_s"],
        "zero_shot_top1": ensemble[2]["top1"], "zero_shot_peak_mem_gib": ensemble[2]["peak_mem_gib"],
        **{k: ens_ep[k] for k in ("fp32_selected_equal", "fp32_max_abs_logit_diff", "fp32_max_abs_loss_diff")},
        "launch_note": "per image over the whole run, the class features' text-setup launch once a run; device busy, "
                       "idle share and kernels over one group's episode on views built beforehand"}))
    reference = {"path": "ensemble reference fp32", "launches_by_shape": ens_ep["reference_launches_by_shape"]}
    paths += ensemble + [reference]
    paths += classification_rest(out_dir)

    # phase 5: every shape a path launched was checked in phase 3; the
    # kernels line lists those checks with the paths' launch counts
    checked = {" ".join(map(str, e.pop("shape"))): e for e in entries}
    launched = {}
    for flag in paths:
        for key, count in flag["launches_by_shape"].items():
            launched.setdefault(key, {})[flag["path"]] = count
    missing = sorted(set(launched) - set(checked))
    if missing:
        raise AssertionError(f"main-path kernel shapes without a check: {missing}")
    line = [dict(checked[key], launches=sum(by_path.values()), launches_by_path=by_path)
            for key, by_path in sorted(launched.items())]
    for kind in ("mha_fwd", "mha_bwd", "augmix"):
        if not any(e["name"].startswith(kind) for e in line):
            raise AssertionError(f"{kind} was launched no time on the main path")
    for variant in ("mma_long", "tf32x3_long"):   # the long backward: encoder TTA's
        if not any(e["name"].startswith("mha_bwd") and e["variant"] == variant and e["launches"] for e in line):
            raise AssertionError(f"the long backward {variant} was launched no time on a path")
    # the xlong backward: encoder TTA of ViT-L/14@336px, bf16 and fp32
    for variant, path in (("mma_xlong", "encoder 336"), ("tf32x3_xlong", "encoder 336 fp32")):
        if not any(e["name"].startswith("mha_bwd") and e["variant"] == variant and e["launches_by_path"].get(path)
                   for e in line):
            raise AssertionError(f"the xlong backward {variant} was launched no time on the path {path}")
    # the forward above T = 257: the ensemble's ViT-L/14@336px, bf16 on the ensemble path, fp32 in its REFERENCE
    for dtype, path in ((torch.bfloat16, "ensemble"), (torch.float32, "ensemble reference fp32")):
        if not launched.get(key336[dtype], {}).get(path):
            raise AssertionError(f"the forward at T=577 ({dtype}) was launched no time on the path {path}")
    # Stanford Cars' text tower at T = 24 on the long kernels, both directions, on its own path
    for direction in ("fwd", "bwd"):
        key = " ".join(map(str, (direction, GROUP * n_cars, t_cars, 8, str(torch.bfloat16))))
        if t_cars != 24 or checked[key]["variant"] != "mma_long" or not launched.get(key, {}).get("fine cars"):
            raise AssertionError(f"the text {direction} at T={t_cars} did not run mma_long on the path fine cars")
    # the ATTN_IMPL="flash" route: no tower of the main path has a sequence
    # length that is a multiple of 128, so its launches there are 0
    for e in flash_entries:
        key = " ".join(map(str, e.pop("shape")))
        line.append(dict(e, launches=sum(launched.get(key, {}).values()), launches_by_path=launched.get(key, {})))
    log(f"TOTAL chip_smoke.py ran {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

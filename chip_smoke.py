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
     shapes (vision B=56, text B=8 T=8 both ways); retrieval's (the
     episodes' towers at a group of 8 queries: the ViT-B/16 policy at T=197
     and its text at T=77 causal, both ways, the ViT-L/14 reward's vision and
     text forward; the COCO-size galleries' batches and ragged tails at the
     captions' truncated T; the CLI trees' galleries); captioning's (the
     ViT-B/16 feature tower on a group of 16 images and on the fp32 runs' 4,
     the ViT-L/14 reward's image tower and its text on 6 captions an image at
     T=77 causal, clipscore_eval's ViT-B/32: images at T=50, candidates and
     references at T=77); caption training's extraction (the ViT-B/16
     images in batches of 32 and the tails, the captions' text at T=77 in
     batches of 256 and of the shards' 160, and the tails); the ATTN_IMPL="flash"
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
     lines; then retrieval TTA as scripts/tta_coco_ret.sh runs it (ViT-B/16
     policy, ViT-L/14 reward, 8 steps at lr 1e-6, sample_k 12, groups of 8):
     rlcf_torch.cli.tta_retrieval on a synthetic karpathy-format tree (16
     images x 5 captions) in each direction, bf16, and on one of 8 images x 1
     caption in fp32 (paths "retrieval i2t", "retrieval t2i" and their
     "fp32"), counters set to 0 just before each and read just after; the
     engine at the COCO Karpathy test split's size (5,000 images drawn on the
     card, 25,000 templated captions): gallery setup seconds, a warm-up and
     two timed groups per direction, a group profiled, the share of weights
     one group changed, the peak memory of groups of 1 and 2, the KD
     variant's i2t episode; REFERENCE retrieval (fp32, fused against dense,
     one group a direction) and GRAD t2i; the RETRIEVAL line; then caption
     TTA as scripts/tta_capdec_c2f.sh runs it (ViT-B/16 feature CLIP,
     ViT-L/14 reward, OPT-125m, the transformer mapper, 4 steps at lr 5e-6,
     sample_k 6, groups of 16, random weights from seeds, a synthetic
     50,265-entry BPE vocabulary): rlcf_torch.cli.tta_caption on a synthetic
     COCO-caption tree of 32 images in bf16 (path "caption"; stages timed,
     decode steps counted), one group profiled, the early exit's host check
     timed; the CLI in fp32 on 4 images and 1 step ("caption fp32"),
     REFERENCE caption (fp32, fused against dense, one group of 4,
     "caption reference fp32"), rlcf_torch.cli.clipscore_eval on the bf16
     run's captions with the tree's references ("clipscore"); the CAPTION
     line; then caption training (A12b): rlcf_torch.cli.extract_features as
     scripts/extract_coco.sh runs it (ViT-B/16, bf16, prefix 40, token_len
     40) on a synthetic COCO-caption tree of 70 images x 5 captions at
     480x640, after one untimed warm-up run, to one npz ("extract") and to
     shards of 160 captions ("extract sharded"), each run split by stage;
     rlcf_torch.cli.train_caption as scripts/train_capdec_coco.sh ("train
     capdec", the npz's text embeddings) and train_clipcap_coco.sh ("train
     clipcap", the shards' image embeddings) run it (a random OPT-125m in
     fp32, the transformer mapper, batch 40, 2 epochs), each step timed and
     one profiled; the GPT-2 ClipCap predictor (random GPT-2 124 M, a
     synthetic 50,257-entry vocabulary in GPT-2's layout) on 4 images, beam 5
     and greedy over 67 tokens ("clipcap gpt2"); one train step on the card
     against the CPU; the TRAIN_CAPTION line; then serving and infrastructure
     (A15, phase 4i): the flagship exported by rlcf_torch.cli.export_serving
     (--input tokens, bf16 and fp32) and served by a fresh process that
     imports no model code ("serve bf16", "serve fp32": both rlcf:: ops in
     the graph, both kernels launched, fp32 logits and selections against
     the eager episode), tta_cls --resume against one run ("resume"),
     extraction with --decode native beside PIL ("extract pil", "extract
     native"; one line instead where the machine has no libjpeg or libpng),
     the runner on the card against the CPU, and the flagship's TFLOP an
     image; the SERVE, RESUME, DECODE, RUNNER, FLOPS and SERVING lines; then
     parallelism (A14, phase 4j): the sharded CLIs under torchrun, every rank
     a process on this one card, the ranks sharing it over gloo: one launch of
     4 ranks (dp 2 x tp 2) runs tta_cls --tp 2 at the flagship's width in bf16
     (2 groups of 4) and fp32 (1 group), tta_retrieval --tp 2 both ways in fp32
     on the 8 x 1 tree and tta_caption --dp 2 --tp 2 (OPT-125m, fp32, 4
     images, 1 step), one of 2 ranks tune_cls --dp 2 in bf16 and fp32 (a group
     of 2 images), each rank's counters set to 0 just before its CLI's main and
     read just after; the fp32 runs held to the same flags in this process
     (logits and scores within 2e-4 + 2e-4 relative; selections equal or a
     near-tie of the one-process entropies, reported; captions equal or a
     beam tie); a world-1 NCCL group running dp_gather and all_reduce_grads;
     the attention shapes the ranks launched that phase 3 did not check,
     checked and timed here; the PARALLEL line;
  5. print each phase's wall seconds (the PHASES line), the run's total
     seconds, the kernels line (phase 5 also holds
     that Stanford Cars' text ran mma_long at T = 24 both ways on its path,
     that the retrieval paths ran the long backward at T = 77 and at B=8
     T=197, mma_long in bf16 and tf32x3_long in fp32, that the reward's
     class features took the fused forward on the flagship path, that the
     caption reward's text ran mma_long at B=96 T=77 and that the fp32
     caption paths and clipscore_eval ran tf32x3_long, and that the
     extraction ran mma_long on its images at T = 197 and its captions at
     T = 77, that each served program launched both attention kernels, and
     that every rank of every sharded run launched the attention forward and
     backward, the caption run the forward, and the fused runs the AugMix
     kernel), then the device line last.

It imports nothing of JAX and nothing of the JAX package.

    python3 chip_smoke.py --kernels-only   # phases 1-3, then exit 3 (no device line)
    python3 chip_smoke.py --serving-only   # phases 1-2 and 4i, then exit 3 (no device line)
    python3 chip_smoke.py --parallel-only  # phases 1-2, the AugMix checks and 4j, then exit 3 (no device line)
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

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
# phase 4k (A16): the flagship on the device view generator (2 groups), --hard_aug 1 and --viewgen auto --hard_aug 1
# (1 group each); the generator on the card against the CPU on the same draws within the CPU tests' tolerance:
# at most this share of values beyond 1e-4 (normalised units) and none beyond 3 gray levels
VIEWGEN_DEVICE_IMAGES, VIEWGEN_HARD_IMAGES = 8, 4
VIEWGEN_VALUE_TOL, VIEWGEN_MAX_SHARE, VIEWGEN_MAX_GRAY = 1e-4, 1e-3, 3.0
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
AUGMIX_UNEQUAL = {"flagship augmix on": 0, "flagship augmix on, seed 1": 0, "encoder group augmix on": 0,
                  "dp slice augmix on": 0}
LARGE_RES = (336, 448)   # the AugMix kernel's layout with one plane on chip: ViT-L/14@336px's views, RN50x64's
# the rest of the classification application: Stanford Cars as scripts/rlcf-prompt-fine.sh runs it (its prompts
# truncate to T = 24: the text tower on the long kernels), CoCoOp as scripts/tpt-prompt.sh, Bongard-HOI's tasks
FINE_SET, FINE_IMAGES, FINE_STEPS = "cars", 8, 5
COCOOP_IMAGES, COCOOP_STEPS = 8, 1
BONGARD_TASKS, BONGARD_SIZE = 8, (200, 260)
# retrieval (A11) as scripts/tta_coco_ret.sh runs it: ViT-B/16 policy, ViT-L/14 reward, 8 steps at lr 1e-6,
# sample_k 12, groups of 8 queries; the CLI on synthetic karpathy-format trees (images x captions each), the
# engine at the COCO Karpathy test split's size (5,000 images, 25,000 captions), its galleries batched as the
# CLI batches them (policy text 256, reward text 512, images 32); KD: --loss kd, 3 steps, sample_k_i2t 20
RET_STEPS, RET_LR, RET_SAMPLE_K, RET_GROUP = 8, "1e-6", 12, 8
RET_TREE, RET_FP32_TREE, RET_TREE_SIZE = (16, 5), (8, 1), (240, 320)
COCO_IMAGES, COCO_CAPTIONS_PER_IMAGE = 5000, 5
RET_TEXT_BATCH, RET_REWARD_TEXT_BATCH, RET_IMAGE_BATCH = 256, 512, 32
RET_TIMED_GROUPS, RET_KD_STEPS, RET_KD_SAMPLE_K = 2, 3, 20
# captioning (A12) as scripts/tta_capdec_c2f.sh runs it: ViT-B/16 feature CLIP, ViT-L/14 reward, OPT-125m, the
# transformer mapper (prefix 40, clip length 40, 8 layers), 4 steps at lr 5e-6, weight decay 0, sample_k 6, groups of
# 16, the segmented beam cache; a warm-up and a timed group; the fp32 run and REFERENCE caption at a smaller depth;
# clipscore_eval (A13) with its default ViT-B/32 in fp32, images in batches of 32, texts of up to 256
CAP_GROUP, CAP_STEPS, CAP_LR, CAP_SAMPLE_K, CAP_SEG_LEN = 16, 4, "5e-6", 6, 16
CAP_IMAGES, CAP_FP32_IMAGES, CAP_FP32_STEPS, CAP_REF_IMAGES, CAP_REFS = 32, 4, 1, 4, 5
CLIPSCORE_ARCH, CLIPSCORE_IMAGE_BATCH = "ViT-B/32", 32
EXIT_CHECK_ROUNDS = 3
# caption training (A12b) as scripts/extract_coco.sh, train_capdec_coco.sh and train_clipcap_coco.sh run it: ViT-B/16
# bf16 features (prefix 40, token_len 40) of a synthetic COCO-caption tree of 70 images x 5 captions at COCO's
# 480x640 (two full image batches of 32 and a tail of 6; a full text batch of 256 and a tail of 94; shards of 160
# captions, 32 images each), after one untimed warm-up extraction of the same tree;
# the transformer mapper (prefix 40, clip length 40) against a random OPT-125m in fp32, batch 40, lr 2e-5, warm-up
# 5000, two epochs (8 steps each); the ClipCap predictor on a random GPT-2 (124 M) with a transformer mapper at its
# width, on 4 images' embeddings, beam 5 and greedy over 67 tokens
TRAIN_IMAGES, TRAIN_CAPS, TRAIN_SHARD, TRAIN_EPOCHS, TRAIN_BATCH = 70, 5, 160, 2, 40
TRAIN_TREE_SIZE = (480, 640)
GPT2_IMAGES, GPT2_ENTRY, GPT2_BEAM = 4, 67, 5


def host_pipeline_error():
    """Build and load the host pipeline (``native/rlcf_host.cpp``, with its
    codecs where the machine has them): None, or why it failed."""
    from rlcf_torch.data import native

    try:
        native._load()
    except Exception as exc:   # reported by phase 2
        return repr(exc)
    return None


def log(msg):
    print(msg, flush=True)


PHASE_SECONDS = {}   # wall seconds each part of the run took, in its order (the PHASES line)
_phase_mark = [time.perf_counter()]


def phase_done(name):
    """Record the seconds since the last mark under ``name``."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = round(now - _phase_mark[0], 1)
    _phase_mark[0] = now


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
    """The device's own events of a torch.profiler profile, each with its
    ``name`` and ``device_time`` (us), read off the profiler's raw results
    (``prof.events()`` first builds an event object for every op and kernel,
    ~60 us each: two minutes for a caption group's ~190k kernels and their
    ops); not the spans of annotations on its timeline
    (``Optimizer.step#AdamW.step``), which overlap the kernels they cover,
    nor the events the profiler hides."""
    cuda = torch.autograd.DeviceType.CUDA
    return [types.SimpleNamespace(name=e.name(), device_time=e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()
            and not getattr(e, "is_hidden_event", lambda: False)()]


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
    from rlcf_torch.data.class_names import assemble_prompts

    return text_tokens_len(assemble_prompts(classnames))


def text_tokens_len(texts):
    """The text tower's T for ``texts`` after the padded tail is dropped (``truncate_tokens``)."""
    from rlcf_torch.tokenizer import tokenize

    return min(77, -(-(int(tokenize(list(texts), truncate=True).argmax(axis=-1).max()) + 1) // 8) * 8)


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
             (RES, "encoder group augmix on", 1, 2, True, AUGMIX_UNEQUAL["encoder group augmix on"], None, True),
             (RES, "dp slice augmix on", GROUP // 2, 3, True, AUGMIX_UNEQUAL["dp slice augmix on"], None, True)]
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

    device_views = viewgen == "device" or (viewgen == "auto" and "--hard_aug" in extra)   # the generator's floats
    entry = "adapt" if ENSEMBLE_ARGS[0] in extra or device_views else "adapt_tokens"
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
            (viewgen == "fused" and launches["augmix"] != groups) or (device_views and launches["augmix"]):
        raise AssertionError(f"{path} (--viewgen {viewgen} --precision {precision}) did not go through the "
                             f"kernels: groups={len(seen)} launches={launches}")
    secs = results["synthetic"]["group_seconds"]
    timed = secs[1:]  # the first group warms up
    return {"path": path, "viewgen": viewgen, "precision": precision,
            "reward": "ensemble" if ENSEMBLE_ARGS[0] in extra else reward,
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


def use_dense_attention(clf):
    """Every tower of a classifier and of its reward (each member of an
    ensemble), vision and text, on the plain attention: a REFERENCE check's
    dense side."""
    for name in ("attn", "text_attn", "reward_attn"):
        if hasattr(clf, name):
            setattr(clf, name, "dense")
    reward = getattr(clf, "reward", None)
    for member in getattr(reward, "members", [reward] if reward is not None else []):
        member.text_attn = "dense"


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
    from rlcf_torch.tasks.classification import logit_scale

    img_feats, sel, r_sim = clf.prepare_tokens(*toks)
    sel_feats = torch.gather(img_feats, 1, sel[:, :, None].expand(-1, -1, img_feats.shape[-1]))
    pt = clf.prompt_state
    ctx = pt.ctx0.detach()[None].expand(GROUP, *pt.ctx0.shape).clone().requires_grad_(True)
    prompts = P.splice_arrays(ctx, pt.fixed_embed, pt.ctx_map)   # [N, C, T, D], as text_features builds them
    N, C, T, D = prompts.shape
    feats = clip_model.encode_text_embeds(clf.clip_params, clf.clip_cfg, prompts.reshape(N * C, T, D),
                                          pt.eot_idx.repeat(N), attn=clf.text_attn)
    text = clip_model.normalize(feats.float()).reshape(N, C, -1)
    logits = logit_scale(clf.clip_params) * torch.einsum("nse,nce->nsc", sel_feats, text)
    loss = step_loss(logits, r_sim, clf.ecfg, clf.reward.score_samples, logit_scale(clf.reward.params)).sum()
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
    use_dense_attention(clf)
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
    dense), and its reward's forward goes through the kernel. Its views come
    from the device generator (``data/augment.py``): no AugMix launch."""
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
    if len(seen) != limit or launches["augmix"] or not launches["fwd"] or (bwd and not variants.get(bwd)):
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
    use_dense_attention(clf)
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
    device generator as ``tune_cls`` builds them: float ``[1, VIEWS, res, res, 3]``."""
    from rlcf_torch.data.augment import make_view_generator
    from rlcf_torch.data.datasets import SyntheticDataset

    img = torch.from_numpy(SyntheticDataset(n=1, n_classes=200)[0][0][None].copy()).cuda()
    return make_view_generator(VIEWS, res)(img, torch.Generator(device="cuda").manual_seed(0))


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
    use_dense_attention(clf)
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


CAPTION_WORDS = {
    "subject": ("a man", "a woman", "two dogs", "a small child", "a group of people", "a brown horse", "a red bus",
                "an old truck", "a black cat", "a young boy", "three zebras", "a large airplane", "a giraffe",
                "a plate of food", "a skateboarder", "a baseball player", "a tennis player", "a flock of birds"),
    "verb": ("riding", "standing next to", "walking along", "sitting on", "looking at", "playing with",
             "parked near", "flying over", "eating", "holding", "jumping over", "lying on"),
    "object": ("a wave", "a wooden bench", "a busy street", "a green field", "a kitchen counter", "the beach",
               "a snowy hill", "a frisbee", "a cake", "a fence", "a river", "a clock tower", "an umbrella"),
    "tail": ("", "", " on a sunny day", " in the city", " while people watch", " near a tall building with many "
             "windows and a large sign on the front of it", " at night", " in front of a crowd of spectators "
             "wearing hats and holding flags",
             # long enough to reach the tokenizer's 77 under any head: the galleries run at T = 77
             ", with a well-dressed man in a black-and-white shirt, a middle-aged woman in a red-and-blue dress, "
             "two three-year-old children, a brown-and-white dog, a ten-speed bicycle, a cooler, an umbrella, a kite "
             "and a picnic blanket spread out on the grass"),
}


def retrieval_captions(n, seed=0):
    """``n`` COCO-like captions from seeded templates: a subject, a verb, an
    object and now and then a long tail, capitalised and with a full stop
    (what the annotation loader's BLIP cleaning takes off). A caption gallery
    runs at the T of its longest caption; one tail reaches the truncation
    limit, so a gallery of more than a few captions runs at T = 77, the most
    any caption set can cost."""
    rng = np.random.default_rng(seed)
    pick = {k: rng.integers(0, len(v), size=n) for k, v in CAPTION_WORDS.items()}
    return [(f"{CAPTION_WORDS['subject'][pick['subject'][i]]} {CAPTION_WORDS['verb'][pick['verb'][i]]} "
             f"{CAPTION_WORDS['object'][pick['object'][i]]}{CAPTION_WORDS['tail'][pick['tail'][i]]}.").capitalize()
            for i in range(n)]


def retrieval_tree_captions(n_images, caps_per_image=5, seed=0):
    """The captions ``write_retrieval_tree`` writes, as the annotation loader
    hands them over (through the BLIP cleaning)."""
    from rlcf_torch.tasks.retrieval import blip_caption_process

    return [blip_caption_process(c) for c in retrieval_captions(n_images * caps_per_image, seed)]


def write_retrieval_tree(root, n_images, caps_per_image=5, size=(48, 64), seed=0):
    """A synthetic karpathy-format retrieval set under ``root``: ``images/``
    with ``n_images`` random images of ``size`` (JPEG, every third PNG) and
    ``annotations.json`` ([{"image": rel, "caption": [...]}], the layout of
    LAVIS's COCO test annotations) with ``caps_per_image`` templated captions
    each. Returns (annotation path, image root)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    caps = retrieval_captions(n_images * caps_per_image, seed)
    os.makedirs(os.path.join(str(root), "images"), exist_ok=True)
    annotations = []
    for i in range(n_images):
        rel = f"images/val_{i:05d}.{'png' if i % 3 == 2 else 'jpg'}"
        Image.fromarray(rng.integers(0, 256, size=tuple(size) + (3,), dtype=np.uint8)).save(os.path.join(str(root), rel))
        annotations.append({"image": rel, "caption": caps[i * caps_per_image : (i + 1) * caps_per_image]})
    path = os.path.join(str(root), "annotations.json")
    with open(path, "w") as fh:
        json.dump(annotations, fh)
    return path, str(root)


def write_caption_tree(root, n_images, caps_per_image=5, size=(48, 64), seed=0):
    """A synthetic COCO-caption eval set under ``root``: random JPEG images
    at ``val2014/COCO_val2014_<id>.jpg`` and ``annotations.json`` ([{"image":
    rel, "image_id": id, "caption": [...]}]: ``--dataset_mode 0`` parses the
    id from the name, 2 reads ``image_id``) with ``caps_per_image`` templated
    captions each, and ``references.json`` ({image path: captions}, keyed as
    the caption CLI keys ``results_clipscore.json`` under the default
    ``--dataset_mode``, for ``clipscore_eval`` on the tree's root). Returns
    (annotation path, image root)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    caps = retrieval_captions(n_images * caps_per_image, seed)
    os.makedirs(os.path.join(str(root), "val2014"), exist_ok=True)
    annotations, references = [], {}
    for i in range(n_images):
        image_id = 1000 + 7 * i
        rel = f"val2014/COCO_val2014_{image_id:012d}.jpg"
        Image.fromarray(rng.integers(0, 256, size=tuple(size) + (3,), dtype=np.uint8)).save(os.path.join(str(root), rel))
        refs = caps[i * caps_per_image : (i + 1) * caps_per_image]
        annotations.append({"image": rel, "image_id": image_id, "caption": refs})
        references[rel] = refs
    path = os.path.join(str(root), "annotations.json")
    for name, payload in ((path, annotations), (os.path.join(str(root), "references.json"), references)):
        with open(name, "w") as fh:
            json.dump(payload, fh)
    return path, str(root)


def bpe_words(n, seed=0):
    """``n`` lowercase ASCII words drawn from ``seed`` for a synthetic
    byte-level BPE vocabulary, each the end of a chain of merges left to
    right, with the leading ``Ġ`` and without -> (words, merges): the ``Ġ``
    chains ranked first, so that a spaced word re-tokenizes to its one id."""
    from rlcf_torch.tokenizer_gpt2 import _byte_to_unicode

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words, merges, seen = [], {"Ġ": [], "": []}, set(_byte_to_unicode().values())
    while len(words) < n:
        lead = "Ġ" if len(words) % 2 == 0 else ""
        s = lead + "".join(rng.choice(letters, size=int(rng.integers(2, 9))))
        cur = s[0]
        for ch in s[1:]:
            if cur + ch not in seen and len(words) < n:
                seen.add(cur + ch)
                words.append(cur + ch)
                merges[lead].append(f"{cur} {ch}")
            cur += ch
    return words, merges["Ġ"] + merges[""]


def write_vocab(root, tokens, merges):
    """``vocab.json`` (token -> its index in ``tokens``) and ``merges.txt``
    under ``root`` -> their paths."""
    os.makedirs(str(root), exist_ok=True)
    vocab, merges_path = os.path.join(str(root), "vocab.json"), os.path.join(str(root), "merges.txt")
    with open(vocab, "w") as fh:
        json.dump({t: i for i, t in enumerate(tokens)}, fh)
    with open(merges_path, "w") as fh:
        fh.write("#version: synthetic\n" + "\n".join(merges) + "\n")
    return vocab, merges_path


def write_opt_vocab(root, size=50265, newline_id=50118, seed=0):
    """A synthetic byte-level BPE vocabulary in OPT's layout under ``root``
    (``vocab.json``, ``merges.txt``) -> their paths: ``<s>`` 0, ``<pad>`` 1,
    ``</s>`` 2, ``<unk>`` 3, then the words of ``bpe_words``, and the 256
    byte symbols in the last 256 ids with the newline's ``Ċ`` at
    ``newline_id`` (OPT's ``eos_newline_id``; None leaves the byte order).
    Every id decodes to text."""
    from rlcf_torch.tokenizer_gpt2 import _byte_to_unicode

    b2u = _byte_to_unicode()
    words, merges = bpe_words(size - 4 - 256, seed)
    byte_syms = list(b2u.values())
    if newline_id is not None:   # Ċ swaps places with the byte symbol at newline_id
        at, nl = newline_id - (size - 256), byte_syms.index(b2u[10])
        byte_syms[at], byte_syms[nl] = byte_syms[nl], byte_syms[at]
    return write_vocab(root, ["<s>", "<pad>", "</s>", "<unk>"] + words + byte_syms, merges)


def write_gpt2_vocab(root, size=50257, seed=0):
    """A synthetic byte-level BPE vocabulary in GPT-2's layout under ``root``
    -> the paths of ``vocab.json`` and ``merges.txt``: the 256 byte symbols
    first (``.`` at 13, as in GPT-2's), the words of ``bpe_words``, and
    ``<|endoftext|>`` last (GPT-2's 50256 at the default size)."""
    from rlcf_torch.tokenizer_gpt2 import _byte_to_unicode

    words, merges = bpe_words(size - 256 - 1, seed)
    return write_vocab(root, list(_byte_to_unicode().values()) + words + ["<|endoftext|>"], merges)


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
    use_dense_attention(clf)
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


def retrieval_argv(out_dir, task, precision="bf16", tree=None, extra=()):
    """``scripts/tta_coco_ret.sh``'s settings for ``task`` (image2text or
    text2image) on the annotation tree ``tree`` = (annotation file, image
    root), or the JAX CLI's synthetic gallery without one."""
    data = ["--annotations", tree[0], "--vis_root", tree[1]] if tree else ["--synthetic"]
    return [*data, "--arch", POLICY, "--reward_arch", REWARD, "--retrieval_task", task, "--tta_steps",
            str(RET_STEPS), "--lr", RET_LR, "--sample_k", str(RET_SAMPLE_K), "--group_size", str(RET_GROUP),
            "--precision", precision, "--device", "cuda", "--seed", "0", "--output", out_dir, *extra]


def coco_captions():
    """The COCO-size caption gallery as the annotation loader hands it over:
    seeded templates through the BLIP cleaning."""
    from rlcf_torch.tasks.retrieval import blip_caption_process

    return [blip_caption_process(c) for c in retrieval_captions(COCO_IMAGES * COCO_CAPTIONS_PER_IMAGE, seed=1)]


def coco_image_batches():
    """The COCO-size image gallery, drawn on the card from a seed per batch of
    RET_IMAGE_BATCH: CLIP-normalised NHWC float images at 224 px."""
    for b0 in range(0, COCO_IMAGES, RET_IMAGE_BATCH):
        gen = torch.Generator(device="cuda").manual_seed(1000 + b0)
        yield torch.randn(min(RET_IMAGE_BATCH, COCO_IMAGES - b0), RES, RES, 3, device="cuda", generator=gen)


def run_retrieval_cli(path, argv, direction, n_queries, gallery_size, precision):
    """Phase 4f (a): one direction of ``tta_retrieval`` through its entry
    point, each group's score rows recorded, the launch counters set to 0
    just before and read just after. The differentiated tower must run the
    attention backward its T takes (``backward_variant``)."""
    from rlcf_torch.cli import tta_retrieval
    from rlcf_torch.ops import attention as A
    from rlcf_torch.tasks.retrieval import RetrievalTTA

    seen, adapt = [], RetrievalTTA.adapt_queries

    def recording(self, queries, **kw):
        out = adapt(self, queries, **kw)
        seen.append(out)
        return out

    RetrievalTTA.adapt_queries = recording
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()                 # counts start at 0 just before the path
    try:
        t0 = time.perf_counter()
        result = tta_retrieval.main(argv)
        wall = time.perf_counter() - t0
    finally:
        RetrievalTTA.adapt_queries = adapt
    launches, by_shape, variants = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES), dict(A.LAUNCH_VARIANTS)   # read just after
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    T = 197 if direction == "i2t" else 77
    bwd = "bwd_" + A.backward_variant(T, dtype)
    groups = -(-n_queries // RET_GROUP)
    scores = np.concatenate(seen) if seen else np.zeros((0, gallery_size))
    if len(seen) != groups or scores.shape != (n_queries, gallery_size) or not np.isfinite(scores).all() \
            or not launches["fwd"] or not variants.get(bwd):
        raise AssertionError(f"{path}: groups={len(seen)} scores {scores.shape} (want {(n_queries, gallery_size)}, "
                             f"finite) or it did not go through the kernels: launches={launches} variants={variants}")
    secs = result["group_seconds"][direction]
    timed = secs[1:]
    return {"path": path, "precision": precision, "groups": len(secs), "group_seconds": secs,
            "queries_per_s": (n_queries - RET_GROUP) / sum(timed) if timed else None, "wall_s": wall, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "launch_variants": variants,
            "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()}}, scores


@contextlib.contextmanager
def top_k_records():
    """Each episode step's RLCF top-k (logits, indices), as ``step_loss`` takes them."""
    from rlcf_torch.core import losses as Lo

    records, top_k = [], Lo.top_k_indices

    def recording(x, k):
        idx = top_k(x, k)
        records.append((x.detach().float().cpu(), idx.cpu()))
        return idx

    Lo.top_k_indices = recording
    try:
        yield records
    finally:
        Lo.top_k_indices = top_k


def retrieval_reference(tta, queries, label):
    """Phase 4f (c): the fp32 fused-attention group against the dense one on
    the same queries: step 0's top-k index sets equal, per-step losses and
    final score rows within 2e-4 + 2e-4 |dense|; where a later step's top-k
    differs, the dense logits' gap of each pair that swapped is printed."""
    out = {}
    for attn in ("fused", "dense"):
        tta.attn = tta.reward_attn = tta.reward.text_attn = attn
        start, cache, views, per_episode = tta.episode_inputs(queries)
        with top_k_records() as records:
            logits, aux = tta._episode(start, cache, views, per_episode=per_episode)
        out[attn] = logits[:, 0].float().cpu(), aux["losses"].float().cpu(), records
    tta.attn = tta.reward_attn = tta.reward.text_attn = "fused"
    (fs, fl, frec), (ds, dl, drec) = out["fused"], out["dense"]
    same0 = bool(torch.equal(frec[0][1].sort(dim=-1).values, drec[0][1].sort(dim=-1).values))
    flips = []
    for step, ((_, fi), (dlog, di)) in enumerate(zip(frec, drec)):
        for n in range(fi.shape[0]):
            a, b = set(fi[n].flatten().tolist()), set(di[n].flatten().tolist())
            for x, y in zip(sorted(a - b), sorted(b - a)):
                flips.append({"step": step, "episode": n, "fused_only": x, "dense_only": y,
                              "dense_gap": float(dlog[n].flatten()[y] - dlog[n].flatten()[x])})
    share = max(float(((f - d).abs() / (2e-4 + 2e-4 * d.abs())).max()) for f, d in ((fs, ds), (fl, dl)))
    log(f"REFERENCE retrieval {label} fp32 full width, fused vs dense attention, one group of {len(queries)}: step 0 "
        f"top-k sets equal={same0}; later top-k flips {flips}; max|d scores|={float((fs - ds).abs().max()):.3e} "
        f"(of max {float(ds.abs().max()):.3e}) max|d losses|={float((fl - dl).abs().max()):.3e}; worst / "
        f"(2e-4 + 2e-4 |dense|) {share:.3f}")
    if not same0 or share > 1:
        raise AssertionError(f"the fused-attention retrieval {label} episode disagrees with the dense one in fp32")
    return {"step0_topk_equal": same0, "topk_flips": flips, "worst_share_of_tolerance": share,
            "max_abs_score_diff": float((fs - ds).abs().max())}


def retrieval_gradient_check(tta, queries):
    """Phase 4f (d), bf16 at full width: the gradient of step 0's loss in the
    t2i episodes' text weights (the tower and the queries' embedding rows, one
    vector) through the kernel backward against the plain backward on one
    forward, held to the noise floor as ``gradient_check``."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.core.episode import step_loss
    from rlcf_torch.ops import attention as A

    start, cache, views, _ = tta.episode_inputs(queries)
    t = Po.tree_map(lambda v: v.detach().clone().requires_grad_(True), start)
    idx = torch.zeros(views.shape[0], 1, dtype=torch.long, device=views.device)
    with torch.no_grad():
        r_sim = tta.reward_sim(views)
    loss = step_loss(tta.policy_logits(t, cache, idx), r_sim, tta.ecfg, tta.reward.score_samples,
                     tta.reward.params["logit_scale"].exp().float()).sum()
    leaves = Po.tree_leaves(t)
    grads, per_launch, launched = grads_through_backwards(loss, leaves)
    flat = {name: torch.cat([g.float().flatten() for g in gs]) for name, gs in grads.items()}
    rel, floor = rel_l2(flat["kernel"], flat["plain"]), rel_l2(flat["jittered"], flat["plain"])
    variant = "bwd_" + A.backward_variant(77, torch.bfloat16)
    log(f"GRAD t2i bf16 full width, d loss / d text weights ({flat['plain'].numel()} of them, {len(leaves)} tensors, "
        f"{len(queries)} episodes) through 12 layers at B={len(queries)} T=77 causal ({launched}), kernel backward "
        f"against plain backward: per launch on its own inputs, relative L2 error {min(per_launch):.3e} to "
        f"{max(per_launch):.3e} (limit {GRAD_LAUNCH_LIMIT}); relative L2 error {rel:.3e} (noise floor {floor:.3e}, "
        f"limit {GRAD_FLOOR_RATIO:g} x the floor)")
    if not bool(torch.isfinite(flat["kernel"]).all()) or not launched.get(variant) \
            or max(per_launch) > GRAD_LAUNCH_LIMIT or rel > GRAD_FLOOR_RATIO * floor:
        raise AssertionError("the t2i gradient through the kernel backward disagrees with the plain backward")
    return {"grad_launch_rel_l2_max": max(per_launch), "grad_text_rel_l2": rel, "grad_text_noise_floor": floor}


def weights_changed_share(tta, queries):
    """The share of the trainable elements one bf16 group's episodes changed."""
    from rlcf_torch.core import policy as Po

    start = tta.episode_inputs(queries)[0]
    _, adapted = tta.adapt_queries(queries, return_adapted=True)
    pairs = list(zip(Po.tree_leaves(adapted), Po.tree_leaves(start)))   # [N, ...] against [N, ...] or [...]
    return sum(int((a != s0).sum()) for a, s0 in pairs) / sum(a.numel() for a, _ in pairs)


def per_episode_memory(tta, queries):
    """The peak memory allocated and reserved by groups of 1 and of all
    ``queries``, above what was allocated before each: the growth of the
    allocated peak per episode over the trainable bytes is
    ``RetrievalTTA.PER_EPISODE_FACTOR``."""
    peaks = {}
    for n in (1, len(queries)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tta.adapt_queries(queries[:n])
        peaks[n] = (torch.cuda.max_memory_allocated() - base, torch.cuda.max_memory_reserved() - base)
    n = len(queries)
    per_episode = (peaks[n][0] - peaks[1][0]) / (n - 1)
    return {"group_peak_allocated_bytes": {str(k): v[0] for k, v in peaks.items()},
            "group_peak_reserved_bytes": {str(k): v[1] for k, v in peaks.items()},
            "trainable_bytes": tta.trainable_bytes(), "per_episode_factor": per_episode / tta.trainable_bytes()}


def group_at_cap(tta, make_queries):
    """One group of ``hbm_group_cap()`` queries, which must fit the card: its
    seconds, and the peak memory allocated and reserved against the card's."""
    cap = tta.hbm_group_cap()
    queries = make_queries(cap)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = tta.adapt_queries(queries)
    secs = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    if not np.isfinite(scores).all() or scores.shape[0] != cap:
        raise AssertionError(f"a group at the memory cap ({cap}) gave scores {scores.shape}, not finite [{cap}, ...]")
    return {"hbm_group_cap": cap, "cap_group_seconds": secs, "cap_group_queries_per_s": cap / secs,
            "cap_group_peak_allocated_share": torch.cuda.max_memory_allocated() / total,
            "cap_group_peak_reserved_share": torch.cuda.max_memory_reserved() / total, "total_memory_bytes": total}


def coco_direction(path, tta, gallery_setup, queries, make_queries):
    """Phase 4f (b): one direction of the engine at COCO size: the gallery
    setup's seconds, one warm-up and RET_TIMED_GROUPS timed groups of
    RET_GROUP queries (counters set to 0 just before the setup, read after
    the timed groups), then one group profiled, the share of weights one group
    changed, the peak memory of groups of 1 and RET_GROUP
    (``per_episode_memory``), and one group at ``hbm_group_cap`` of
    ``make_queries(cap)`` (outside the path's counts: a check of memory)."""
    from rlcf_torch.ops import attention as A

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()                 # counts start at 0 just before the path
    t0 = time.perf_counter()
    gallery_setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    secs = []
    for g in range(1 + RET_TIMED_GROUPS):
        t0 = time.perf_counter()
        scores = tta.adapt_queries(queries[g * RET_GROUP:(g + 1) * RET_GROUP])
        secs.append(time.perf_counter() - t0)
        if not np.isfinite(scores).all() or scores.shape != (RET_GROUP, tta.gallery_feats.shape[0]):
            raise AssertionError(f"{path}: scores {scores.shape} not finite [{RET_GROUP}, "
                                 f"{tta.gallery_feats.shape[0]}]")
    launches, by_shape, variants = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES), dict(A.LAUNCH_VARIANTS)   # read just after
    out = {"path": path, "gallery_setup_s": setup_s, "group_seconds": secs,
           "queries_per_s": RET_GROUP * RET_TIMED_GROUPS / sum(secs[1:]),
           "episode_ms_per_query": 1e3 * sum(secs[1:]) / (RET_GROUP * RET_TIMED_GROUPS),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
           "launch_variants": variants, "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()}}
    group = queries[:RET_GROUP]
    out.update(profile_episode(lambda: tta.adapt_queries(group), f"{path} group of {RET_GROUP}"))
    out["weights_changed_share"] = weights_changed_share(tta, group)
    out.update(per_episode_memory(tta, group))
    out.update(group_at_cap(tta, make_queries))
    return out


def retrieval(out_dir):
    """Phase 4f: retrieval TTA at full width (ViT-B/16 policy, ViT-L/14
    reward, random weights from seeds): (a) the CLI end to end on synthetic
    karpathy-format trees, each direction in bf16 and fp32; (b) the engine at
    the COCO Karpathy test split's size per direction, and the KD variant's
    i2t episode; (c) REFERENCE retrieval (fp32, fused against dense); (d)
    GRAD t2i. Returns the paths and the RETRIEVAL line's numbers."""
    import dataclasses

    from rlcf_torch.cli import common, tta_retrieval
    from rlcf_torch.core.episode import EpisodeConfig
    from rlcf_torch.metrics.retrieval import retrieval_metrics
    from rlcf_torch.ops import attention as A
    from rlcf_torch.tasks.retrieval import RetrievalTTA, load_karpathy_annotations
    from rlcf_torch.tokenizer import tokenize

    gc.collect()   # the earlier paths' engines (their episodes close over them) go before the peaks are read
    torch.cuda.empty_cache()
    root = os.path.dirname(out_dir)
    paths, line, scores = [], {}, {}
    for tree_shape, precision, suffix in ((RET_TREE, "bf16", ""), (RET_FP32_TREE, "fp32", " fp32")):
        tree = write_retrieval_tree(os.path.join(root, "chip_smoke_retrieval" + suffix.replace(" ", "_")),
                                    *tree_shape, size=RET_TREE_SIZE)
        gallery = load_karpathy_annotations(*tree)
        n_img, n_txt = len(gallery.image_paths), len(gallery.texts)
        for direction, task, n_q, n_g in (("i2t", "image2text", n_img, n_txt), ("t2i", "text2image", n_txt, n_img)):
            path, s = run_retrieval_cli(f"retrieval {direction}{suffix}", retrieval_argv(out_dir, task, precision, tree),
                                        direction, n_q, n_g, precision)
            paths.append(path)
            scores[(direction, precision)] = s
            log("RETRIEVAL_PATH " + json.dumps(path))
        if precision == "bf16":
            line["cli_metrics"] = retrieval_metrics(scores[("i2t", "bf16")], scores[("t2i", "bf16")], gallery.txt2img,
                                                    gallery.img2txt)
    line["cli"] = {p["path"]: {k: p[k] for k in ("queries_per_s", "group_seconds", "wall_s", "peak_mem_gib")}
                   for p in paths}

    args = tta_retrieval.get_args(retrieval_argv(out_dir, "both"))
    dev = torch.device("cuda")
    params, cfg = common.load_policy(args, dev)
    reward = common.build_reward(args, dev)
    ecfg = EpisodeConfig(tta_steps=RET_STEPS, lr=float(RET_LR), sample_k=RET_SAMPLE_K, adam_eps=1e-6)
    captions = coco_captions()
    n_q = RET_GROUP * (1 + RET_TIMED_GROUPS)
    images_q = next(coco_image_batches())[:n_q]
    tokens_q = tokenize(captions[:n_q], truncate=True)
    i2t = RetrievalTTA(params, cfg, reward, ecfg, direction="i2t")
    coco = {"i2t": coco_direction("retrieval coco i2t", i2t, lambda: i2t.set_text_gallery(captions), images_q,
                                  lambda n: torch.randn(n, RES, RES, 3, device="cuda",
                                                        generator=torch.Generator(device="cuda").manual_seed(2)))}
    A.reset_launch_counts()                 # the KD variant's path: counts from 0
    kd = RetrievalTTA(params, cfg, reward, dataclasses.replace(ecfg, loss="kd", tta_steps=RET_KD_STEPS,
                                                               sample_k=RET_KD_SAMPLE_K), direction="i2t")
    kd.gallery_feats, kd.reward_gallery_feats = i2t.gallery_feats, i2t.reward_gallery_feats
    kd.adapt_queries(images_q[:RET_GROUP])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in range(1, 1 + RET_TIMED_GROUPS):
        kd.adapt_queries(images_q[g * RET_GROUP:(g + 1) * RET_GROUP])
    coco["i2t kd"] = {"path": "retrieval coco i2t kd", "episode_ms_per_query": 1e3 * (time.perf_counter() - t0) /
                      (RET_GROUP * RET_TIMED_GROUPS),
                      "launches_by_shape": {" ".join(map(str, k)): v for k, v in A.LAUNCH_SHAPES.items()}}
    text_gallery = (i2t.gallery_feats, i2t.reward_gallery_feats)
    del kd, i2t
    torch.cuda.empty_cache()
    t2i = RetrievalTTA(params, cfg, reward, ecfg, direction="t2i")
    coco["t2i"] = coco_direction("retrieval coco t2i", t2i,
                                 lambda: t2i.set_image_gallery(coco_image_batches(), coco_image_batches()), tokens_q,
                                 lambda n: tokenize(captions[:n], truncate=True))
    coco["t2i"].update(retrieval_gradient_check(t2i, tokens_q[:RET_GROUP]))
    image_gallery = (t2i.gallery_feats, t2i.reward_gallery_feats)
    del t2i, params, reward
    torch.cuda.empty_cache()
    for c in coco.values():
        log("RETRIEVAL_COCO " + json.dumps(c))
    paths += list(coco.values())

    # (c) fp32 at full width, the same queries, the bf16 galleries' features as the fp32 engines' galleries
    args = tta_retrieval.get_args(retrieval_argv(out_dir, "both", "fp32"))
    params, cfg = common.load_policy(args, dev)
    reward = common.build_reward(args, dev)
    reference = {}
    A.reset_launch_counts()                 # the REFERENCE path: counts from 0
    engines = {}
    for direction, feats, queries in (("i2t", text_gallery, images_q), ("t2i", image_gallery, tokens_q)):
        engines[direction] = tta = RetrievalTTA(params, cfg, reward, ecfg, direction=direction)
        tta.gallery_feats, tta.reward_gallery_feats = feats
        reference[direction] = retrieval_reference(tta, queries[:RET_GROUP], direction)
    paths.append({"path": "retrieval reference fp32",
                  "launches_by_shape": {" ".join(map(str, k)): v for k, v in A.LAUNCH_SHAPES.items()}})
    for direction, queries in (("i2t", images_q), ("t2i", tokens_q)):   # the per-episode factor in fp32
        reference[direction]["fp32_memory"] = per_episode_memory(engines[direction], queries[:RET_GROUP])
    del params, reward, tta, engines
    torch.cuda.empty_cache()
    line.update(coco={k: {m: v for m, v in c.items() if m not in ("launches", "launch_variants", "launches_by_shape")}
                      for k, c in coco.items()}, reference=reference)
    return paths, line


def caption_argv(out_dir, tree, vocab, precision="bf16", limit=CAP_IMAGES, steps=CAP_STEPS):
    """``scripts/tta_capdec_c2f.sh``'s settings on the annotation tree ``tree``
    = (annotation file, image root) with the synthetic vocabulary ``vocab``:
    random OPT-125m and mapper weights from the seed (no checkpoints exist)."""
    return ["--annotations", tree[0], "--images_root", tree[1], "--opt_vocab", vocab[0], "--opt_merges", vocab[1],
            "--clip_model_type", POLICY, "--reward_arch", REWARD, "--normalize_prefix", "1", "--tta_steps", str(steps),
            "--tta_lr", CAP_LR, "--weight_decay", "0.0", "--sample_k", str(CAP_SAMPLE_K), "--episode_group",
            str(CAP_GROUP), "--decode_seg_len", str(CAP_SEG_LEN), "--limit", str(limit), "--precision", precision,
            "--device", "cuda", "--seed", "0", "--output", out_dir]


@contextlib.contextmanager
def caption_stage_timer():
    """Times each stage of ``CaptionTTA`` (synchronised at its edges) and
    counts the decode steps each generate runs; records the last group's
    engine and inputs. Yields ``{"ms": {stage: [ms, ...]}, "steps":
    {stage: [n, ...]}, "last": (tta, images, embs)}``."""
    from rlcf_torch.models import opt as O
    from rlcf_torch.tasks.caption import CaptionTTA

    rec = {"ms": {}, "steps": {}, "last": None}
    stages = {"_generate_k": "generate", "_decode_and_retokenize": "host round trip", "_rewards": "reward",
              "_update_step": "update", "_generate_final": "final beam", "reward_image_feats": "reward image"}
    saved = {name: getattr(CaptionTTA, name) for name in list(stages) + ["adapt_batch"]}
    decode_step, count = O._decode_step, [0]

    def counting(*a, **k):
        count[0] += 1
        return decode_step(*a, **k)

    def timed(name):
        def run(self, *a, **k):
            torch.cuda.synchronize()
            count[0], t0 = 0, time.perf_counter()
            out = saved[name](self, *a, **k)
            torch.cuda.synchronize()
            rec["ms"].setdefault(stages[name], []).append(1e3 * (time.perf_counter() - t0))
            if name in ("_generate_k", "_generate_final"):
                rec["steps"].setdefault(stages[name], []).append(count[0])
            if name == "_decode_and_retokenize":   # the update's padded caption length
                rec["steps"].setdefault("update tokens", []).append(out[1].shape[1])
            return out
        return run

    def recording(self, images, embs, trace=None):
        rec["last"] = (self, images, embs)
        return saved["adapt_batch"](self, images, embs, trace=trace)

    for name in stages:
        setattr(CaptionTTA, name, timed(name))
    CaptionTTA.adapt_batch = recording
    O._decode_step = counting
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(CaptionTTA, name, fn)
        O._decode_step = decode_step


def run_caption_cli(path, argv, n_images, precision):
    """Phase 4g (a): ``tta_caption`` through its entry point, its stages timed
    (``caption_stage_timer``), the launch counters set to 0 just before and
    read just after; every caption a string, every trace reward finite."""
    from rlcf_torch.cli import tta_caption
    from rlcf_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    with caption_stage_timer() as rec:
        A.reset_launch_counts()                 # counts start at 0 just before the path
        t0 = time.perf_counter()
        result = tta_caption.main(argv)
        wall = time.perf_counter() - t0
        launches, by_shape, variants = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES), dict(A.LAUNCH_VARIANTS)   # read just after
    out_dir = argv[argv.index("--output") + 1]
    with open(os.path.join(out_dir, "results_clipscore.json")) as fh:
        per_image = json.load(fh)
    with open(os.path.join(out_dir, "caption_trace.txt")) as fh:
        rewards = [float(line.split("]")[0].strip().lstrip("[")) for line in fh if line.startswith("  [")]
    groups = -(-n_images // CAP_GROUP)
    captions = [r["caption"] for r in result["results"]]
    if len(captions) != n_images or len(per_image) != n_images or not all(isinstance(c, str) for c in captions) \
            or not rewards or not np.isfinite(rewards).all() or not launches["fwd"]:
        raise AssertionError(f"{path}: {len(captions)} captions of {n_images}, {len(rewards)} rewards (finite?), "
                             f"or it did not go through the kernels: launches={launches}")
    secs = result["group_seconds"]
    return {"path": path, "precision": precision, "groups": groups, "group_seconds": secs,
            "img_per_s": CAP_GROUP * (len(secs) - 1) / sum(secs[1:]) if len(secs) > 1 else None,
            "wall_s": wall, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
            "launch_variants": variants, "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()},
            "stage_ms": rec["ms"], "decode_steps": rec["steps"], "captions": captions[:4],
            "distinct_captions": len(set(captions))}, rec["last"], out_dir


def exit_check_cost(tta, images, embs):
    """The early exit's host check (``models/opt.py::_all_finished``, a sync
    each token): one group's K-beam generate timed with it and without it
    (every step run), EXIT_CHECK_ROUNDS times each in turns (medians). With
    random weights no beam ends early, so both run every step and give the
    same sequences."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.models import opt as O

    dev = tta.device
    embs = torch.as_tensor(embs, dtype=torch.float32, device=dev)
    mappers = Po.tree_map(lambda a: a.detach()[None].expand(embs.shape[0], *a.shape), tta.params["mapper"])
    gen = lambda: tta._generate_k(mappers, embs, None)
    check, out = O._all_finished, {}
    try:
        for rnd in range(EXIT_CHECK_ROUNDS):   # in turns: host-bound times drift within a call
            for label, fn in (("checked", check), ("unchecked", lambda f: False)):
                O._all_finished = fn
                if rnd == 0:
                    gen()   # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                seqs = gen()
                torch.cuda.synchronize()
                out.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))
                if not torch.equal(seqs, out.setdefault("seqs", seqs)):
                    raise AssertionError("the generate without the early exit's check gave other sequences")
    finally:
        O._all_finished = check
    ms = {label: float(np.median(out[label])) for label in ("checked", "unchecked")}
    return {"generate_ms_checked": ms["checked"], "generate_ms_unchecked": ms["unchecked"],
            "exit_check_rounds": EXIT_CHECK_ROUNDS,
            "exit_check_ms_per_token": (ms["checked"] - ms["unchecked"]) / tta.max_new_tokens}


def caption_reference(args_fp32, tree_images, n_images=CAP_REF_IMAGES):
    """Phase 4g (c), REFERENCE caption: one fp32 group of CAP_REF_IMAGES images
    through ``adapt_batch`` with every CLIP tower on the fused attention, then
    on the plain (dense) one (the CLI's ``args_fp32``), the same OPT and mapper: step 0's sampled
    captions equal, its rewards within 2e-4 + 2e-4 |dense|; later steps'
    differing captions printed with the rewards' gap."""

    from rlcf_torch.cli import common, tta_caption
    from rlcf_torch.models import clip as clip_model
    from rlcf_torch.models import mappers as M
    from rlcf_torch.models import opt as O
    from rlcf_torch.ops import attention as A
    from rlcf_torch.tasks import caption as Cap
    from rlcf_torch.tokenizer_gpt2 import load_gpt2_tokenizer

    args = tta_caption.get_args(args_fp32)
    dev = torch.device(args.device)
    clip_params, clip_cfg = common.load_policy(argparse.Namespace(**{**vars(args), "arch": args.clip_model_type}), dev)
    reward = common.build_reward(args, dev)
    ocfg = O.OPT_CONFIGS[args.llm]
    mcfg = M.MapperConfig(args.mapping_type, clip_dim=clip_cfg.embed_dim, llm_dim=ocfg.embed_dim,
                          prefix_length=args.prefix_length, clip_length=args.clip_length)
    ccfg = Cap.CaptionModelConfig(mapper=mcfg, opt=ocfg, normalize_prefix=True)
    tta = Cap.CaptionTTA(Cap.init_caption_params(args.seed, ccfg, device=dev), ccfg, reward,
                         load_gpt2_tokenizer(args.opt_vocab, args.opt_merges), tta_steps=args.tta_steps,
                         lr=args.tta_lr, weight_decay=args.weight_decay, sample_k=args.sample_k,
                         decode_seg_len=args.decode_seg_len, seed=args.seed)
    images = torch.as_tensor(np.stack(tree_images[:n_images]), device=dev)
    out = {}
    A.reset_launch_counts()                 # the REFERENCE path: counts from 0
    for attn in ("fused", "dense"):
        tta.reward_attn = reward.text_attn = attn
        with torch.no_grad():
            embs = clip_model.encode_image(clip_params, clip_cfg, images, attn=attn).float().cpu().numpy()
        embs = embs / np.linalg.norm(embs, axis=-1, keepdims=True)
        trace = []
        captions = tta.adapt_batch(images, embs, trace=trace)
        out[attn] = captions, trace
        if attn == "fused":
            by_shape = {" ".join(map(str, k)): v for k, v in A.LAUNCH_SHAPES.items()}   # read just after the fused run
    (fc, ftr), (dc, dtr) = out["fused"], out["dense"]
    same0 = [t for t, _ in ftr[0]] == [t for t, _ in dtr[0]]
    r0 = np.array([[r for _, r in ftr[0]], [r for _, r in dtr[0]]])
    share = float((np.abs(r0[0] - r0[1]) / (2e-4 + 2e-4 * np.abs(r0[1]))).max())
    flips = [{"step": s, "index": i, "fused": ft, "dense": dt, "reward_gap": fr - dr}
             for s in range(1, len(ftr)) for i, ((ft, fr), (dt, dr)) in enumerate(zip(ftr[s], dtr[s])) if ft != dt]
    log(f"REFERENCE caption fp32 full width, fused vs dense attention in every CLIP tower, one group of "
        f"{n_images}: step 0 sampled captions equal={same0}; step 0 rewards worst / (2e-4 + 2e-4 |dense|) "
        f"{share:.3f} (max |d reward| {float(np.abs(r0[0] - r0[1]).max()):.3e}); final captions equal={fc == dc}; "
        f"later flips {flips[:6]} ({len(flips)} in all)")
    if not same0 or share > 1:
        raise AssertionError("the fused-attention caption group disagrees with the dense one in fp32")
    return {"path": "caption reference fp32", "launches_by_shape": by_shape}, {
        "step0_captions_equal": same0, "step0_reward_worst_share_of_tolerance": share,
        "final_captions_equal": fc == dc, "later_flips": len(flips)}


def run_clipscore(path, results_json, image_root, references, extra=("--arch", CLIPSCORE_ARCH, "--device", "cuda")):
    """Phase 4g (d): ``clipscore_eval`` (ViT-B/32, fp32, its default) on a
    caption run's ``results_clipscore.json`` with the tree's references, the
    counters set to 0 just before and read just after: finite scores, every
    image scored, the fused forward launched."""
    from rlcf_torch.cli import clipscore_eval
    from rlcf_torch.ops import attention as A

    A.reset_launch_counts()                 # counts start at 0 just before the path
    t0 = time.perf_counter()
    out = clipscore_eval.main([results_json, image_root, "--references_json", references, "--seed", "0", *extra])
    secs = time.perf_counter() - t0
    launches, by_shape = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES)   # read just after
    n = len(out["per_instance"])
    if not (np.isfinite(out["clipscore"]) and np.isfinite(out["ref_clipscore"])) or not launches["fwd"]:
        raise AssertionError(f"{path}: clipscore {out['clipscore']} ref {out.get('ref_clipscore')} or it did not "
                             f"go through the kernel: launches={launches}")
    return {"path": path, "seconds": secs, "img_per_s": n / secs, "images": n, "clipscore": out["clipscore"],
            "ref_clipscore": out["ref_clipscore"], "bleu4": out["bleu"][3], "cider": out["cider"],
            "meteor_mode": out["meteor_mode"], "launches": launches,
            "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()}}


def captioning(out_dir):
    """Phase 4g: caption TTA as scripts/tta_capdec_c2f.sh runs it, at full
    width (ViT-B/16 feature CLIP, ViT-L/14 reward, OPT-125m, the transformer
    mapper, random weights from seeds, the synthetic 50,265-entry vocabulary):
    (a) the CLI on a synthetic COCO-caption tree of CAP_IMAGES images, bf16,
    a warm-up and a timed group, stages timed, then one group profiled and the
    early exit's host check timed; (b) the CLI in fp32 at a smaller depth;
    (c) REFERENCE caption; (d) clipscore_eval on (a)'s captions. Returns the
    paths and the CAPTION line's numbers."""
    from rlcf_torch.data.transforms import preprocess_many

    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(out_dir), "chip_smoke_caption")
    tree = write_caption_tree(os.path.join(root, "coco"), CAP_IMAGES, size=RET_TREE_SIZE)
    vocab = write_opt_vocab(os.path.join(root, "vocab"))
    path, (tta, images, embs), run_dir = run_caption_cli(
        "caption", caption_argv(os.path.join(root, "bf16"), tree, vocab), CAP_IMAGES, "bf16")
    log("CAPTION_PATH " + json.dumps(path))
    phase_done("4h caption CLI bf16")
    prof = profile_episode(lambda: tta.adapt_batch(images, embs), f"caption group of {CAP_GROUP}")
    phase_done("4h caption profile")
    sync = exit_check_cost(tta, images, embs)
    phase_done("4h caption exit check")
    del tta, images, embs
    gc.collect()
    torch.cuda.empty_cache()
    fp32, _, _ = run_caption_cli("caption fp32", caption_argv(os.path.join(root, "fp32"), tree, vocab, "fp32",
                                                               CAP_FP32_IMAGES, CAP_FP32_STEPS),
                                 CAP_FP32_IMAGES, "fp32")
    log("CAPTION_PATH " + json.dumps(fp32))
    phase_done("4h caption CLI fp32")
    with open(tree[0]) as fh:
        ann = json.load(fh)
    ref_images = preprocess_many([os.path.join(tree[1], a["image"]) for a in ann[:CAP_REF_IMAGES]], RES)
    ref_path, reference = caption_reference(caption_argv(os.path.join(root, "ref"), tree, vocab, "fp32"), ref_images)
    phase_done("4h caption REFERENCE")
    gc.collect()
    torch.cuda.empty_cache()
    clip = run_clipscore("clipscore", os.path.join(run_dir, "results_clipscore.json"), tree[1],
                         os.path.join(root, "coco", "references.json"))
    log("CLIPSCORE_PATH " + json.dumps(clip))
    timed = lambda stage: path["stage_ms"].get(stage, [])
    per_group = lambda stage: sum(timed(stage)[len(timed(stage)) // path["groups"]:]) if timed(stage) else 0.0
    steps = path["decode_steps"]
    gen_steps = sum(steps["generate"][len(steps["generate"]) // path["groups"]:])
    line = {"img_per_s": path["img_per_s"], "ms_per_group": 1e3 * sum(path["group_seconds"][1:]) /
            (len(path["group_seconds"]) - 1),
            "stage_ms_per_group": {s: per_group(s) for s in ("generate", "host round trip", "reward", "update",
                                                             "final beam", "reward image")},
            "decode_steps_per_group": {"generate": gen_steps,
                                       "final beam": sum(steps["final beam"][len(steps["final beam"]) // path["groups"]:])},
            "ms_per_decode_token": per_group("generate") / max(gen_steps, 1),
            "update_caption_tokens": steps["update tokens"][len(steps["update tokens"]) // path["groups"]:],
            "group_note": "the timed group is the second (the first warms up); the stage split sums the timed "
                          "group's calls; random weights: no beam ends early, so every generate runs all 50 tokens "
                          "(the worst case)",
            **sync, **prof, "peak_mem_gib": path["peak_mem_gib"], "distinct_captions": path["distinct_captions"],
            "fp32_group_seconds": fp32["group_seconds"], "fp32_peak_mem_gib": fp32["peak_mem_gib"],
            "reference": reference, "clipscore_eval_s": clip["seconds"], "clipscore_img_per_s": clip["img_per_s"],
            "clipscore": clip["clipscore"], "ref_clipscore": clip["ref_clipscore"],
            "launches_per_image_by_shape": {k: v / CAP_IMAGES for k, v in path["launches_by_shape"].items()}}
    return [path, fp32, ref_path, clip], line


def extract_argv(out, tree, vocab, shard_size=0):
    """``scripts/extract_coco.sh``'s settings (ViT-B/16, bf16, prefix 40,
    token_len 40, the images' embeddings too) on the annotation tree
    ``tree`` with the synthetic vocabulary ``vocab``; random CLIP weights
    from the seed."""
    argv = ["--annotations", tree[0], "--images_root", tree[1], "--arch", POLICY, "--precision", "bf16",
            "--opt_vocab", vocab[0], "--opt_merges", vocab[1], "--prefix_length", "40", "--token_len", "40",
            "--out", out, "--seed", "0", "--device", "cuda"]
    return argv + ["--shard_size", str(shard_size)] if shard_size else argv


@contextlib.contextmanager
def extract_timer():
    """Splits an ``extract_features`` run into its stages by timing the
    functions it calls: set-up (``common.load_policy``: the random tower
    built and moved to the card; the BPE tokenizer's files read), the host's
    image decode (``preprocess_many``: PIL decode, resize, crop), the host's
    tokenizers (CLIP's for the text tower, OPT's BPE for the trainer's
    ids) and the two towers (each call synchronised at its edges, so it
    holds the host's launches and the card's work). Yields ``{stage: s}``."""
    from rlcf_torch.cli import common, extract_features
    from rlcf_torch.data import transforms
    from rlcf_torch.models import clip
    from rlcf_torch.tasks import caption as Cap
    from rlcf_torch import tokenizer_gpt2

    rec = {}

    def timed(stage, fn, sync=False):
        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            rec[stage] = rec.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return run

    patches = [(common, "load_policy", "setup_s", False), (tokenizer_gpt2, "load_gpt2_tokenizer", "setup_s", False),
               (transforms, "preprocess_many", "image_decode_s", False), (Cap, "clip_tokenize", "clip_tokenize_s", False),
               (extract_features, "_tokens_and_mask", "bpe_s", False), (clip, "encode_image", "image_tower_s", True),
               (clip, "encode_text", "text_tower_s", True)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in patches]
    for mod, name, stage, sync in patches:
        setattr(mod, name, timed(stage, getattr(mod, name), sync))
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_extract(path, argv):
    """Phase 4h (a): ``extract_features`` through its entry point, the
    counters set to 0 just before and read just after; every embedding
    float32 and finite, one row a caption, the fused forward launched. The
    rates count the run without its set-up (``extract_timer``)."""
    from rlcf_torch.cli import extract_features
    from rlcf_torch.data.sharded_embeddings import ShardedEmbeddings, is_sharded
    from rlcf_torch.ops import attention as A

    with extract_timer() as stages:
        A.reset_launch_counts()                 # counts start at 0 just before the path
        t0 = time.perf_counter()
        result = extract_features.main(argv)
        secs = time.perf_counter() - t0
        launches, by_shape = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES)   # read just after
    keys = ("text_embeddings", "image_embeddings", "tokens")
    if is_sharded(result["out"]):
        store = ShardedEmbeddings(result["out"])
        cols = {k: store.column(k) for k in keys}
    else:
        data = np.load(result["out"])
        cols = {k: data[k] for k in keys}
    n = result["captions"]
    bad = [k for k in ("text_embeddings", "image_embeddings")
           if cols[k].dtype != np.float32 or cols[k].shape[0] != n or not np.isfinite(cols[k]).all()]
    if bad or cols["tokens"].shape != (n, 40) or not launches["fwd"]:
        raise AssertionError(f"{path}: bad columns {bad}, tokens {cols['tokens'].shape} of {n} captions, or it did not "
                             f"go through the kernel: launches={launches}")
    encode = secs - stages.get("setup_s", 0.0)
    stages["other_s"] = secs - sum(stages.values())       # annotations, gathers, the npz or shard writes
    host = stages.get("image_decode_s", 0.0) + stages.get("clip_tokenize_s", 0.0) + stages.get("bpe_s", 0.0)
    return {"path": path, "seconds": secs, "encode_seconds": encode, "captions": n, "images": result["images"],
            "captions_per_s": n / encode, "images_per_s": result["images"] / encode, "stages_s": stages,
            "host_share_of_encode": host / encode,
            "tower_share_of_encode": (stages.get("image_tower_s", 0.0) + stages.get("text_tower_s", 0.0)) / encode,
            "launches": launches, "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()}}


def train_argv(out, embeddings, cap_model):
    """``scripts/train_capdec_coco.sh`` (CapDec, noise 0.016, text embeddings)
    or ``train_clipcap_coco.sh`` (ClipCap, image embeddings, --normalize_prefix
    1): the transformer mapper, prefix 40, clip length 40, batch 40, lr 2e-5,
    warm-up 5000, OPT-125m with random weights from the seed."""
    argv = ["--embeddings", embeddings, "--cap_model", cap_model, "--epochs", str(TRAIN_EPOCHS), "--train_lr", "2e-5",
            "--train_batch_size", str(TRAIN_BATCH), "--warmup_steps", "5000", "--mapping_type", "transformer",
            "--prefix_length", "40", "--clip_length", "40", "--llm", "opt-125m", "--seed", "0", "--device", "cuda",
            "--output", out]
    return argv + (["--noise_variance", "0.016"] if cap_model == "CapDec" else ["--normalize_prefix", "1"])


@contextlib.contextmanager
def train_step_timer():
    """Times each ``train_step`` of ``tasks/caption.py::make_caption_trainer``
    (synchronised at its edges) and keeps the last call's arguments. Yields
    ``{"ms": [...], "last": args}``."""
    from rlcf_torch.tasks import caption as Cap

    rec = {"ms": [], "last": None}
    make = Cap.make_caption_trainer

    def timed_trainer(ccfg, tcfg):
        init_opt, step = make(ccfg, tcfg)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(*args)
            torch.cuda.synchronize()
            rec["ms"].append(1e3 * (time.perf_counter() - t0))
            rec["last"] = (step, args)
            return loss
        return init_opt, timed

    Cap.make_caption_trainer = timed_trainer
    try:
        yield rec
    finally:
        Cap.make_caption_trainer = make


def run_train(path, argv, n_samples):
    """Phase 4h (b): ``train_caption`` through its entry point, each step
    timed, the counters set to 0 just before and read just after (OPT and
    the mapper are dense math: no kernel of the port); finite losses, the
    checkpoints written; one more step profiled on the last step's inputs."""
    from rlcf_torch.cli import train_caption
    from rlcf_torch.ops import attention as A

    torch.cuda.reset_peak_memory_stats()
    with train_step_timer() as rec:
        A.reset_launch_counts()                 # counts start at 0 just before the path
        t0 = time.perf_counter()
        losses = train_caption.main(argv)
        wall = time.perf_counter() - t0
        launches, by_shape = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES)   # read just after
    out_dir = argv[argv.index("--output") + 1]
    steps = n_samples // TRAIN_BATCH * TRAIN_EPOCHS
    if len(losses) != TRAIN_EPOCHS or not np.isfinite(losses).all() or len(rec["ms"]) != steps or \
            not os.path.exists(os.path.join(out_dir, "ckpt-latest.npz")):
        raise AssertionError(f"{path}: losses {losses}, {len(rec['ms'])} steps of {steps}, or no checkpoint")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step, args = rec["last"]
    prof = profile_episode(lambda: (step(*args), torch.cuda.synchronize()), f"{path} step")
    ms = float(np.median(rec["ms"][1:]))
    # the profiler slows the host, so the idle share of a step is read against the timed steps' median
    return {"path": path, "wall_s": wall, "steps": steps, "first_step_ms": rec["ms"][0], "ms_per_step": ms,
            "step_ms": rec["ms"], "samples_per_s": 1e3 * TRAIN_BATCH / ms, "peak_mem_gib": peak, "losses": losses,
            **prof, "idle_share_of_timed_step": 1 - prof.get("profile_device_busy_ms", 0.0) / ms,
            "launches": launches, "launches_by_shape": {" ".join(map(str, k)): v for k, v in by_shape.items()}}


def run_clipcap_gpt2(path, tree, vocab, n_images=GPT2_IMAGES, gpt2="gpt2", clip_arch=POLICY, mapper_kw=None,
                     device="cuda"):
    """Phase 4h (c): ClipCap captions through GPT-2 (``clipcap_predict``)
    with random weights from seeds: ``n_images`` images of the tree through
    the bf16 ViT-B/16 feature tower (the fused kernel), a transformer mapper
    at GPT-2's width (prefix 40, clip length 40), then beam search (beam 5)
    and the greedy loop over 67 tokens, decode steps counted; the counters
    set to 0 just before and read just after. Every caption a string."""
    from rlcf_torch.data.transforms import preprocess_many
    from rlcf_torch.models import clip as clip_model
    from rlcf_torch.models import gpt2 as G
    from rlcf_torch.models import mappers as M
    from rlcf_torch.ops import attention as A
    from rlcf_torch.tasks import caption as Cap
    from rlcf_torch.tokenizer_gpt2 import Gpt2Tokenizer

    dev = torch.device(device)
    gcfg = G.GPT2_CONFIGS[gpt2]
    ccfg_clip = clip_model.get_config(clip_arch)
    clip_params = clip_model.init_clip_params(ccfg_clip, seed=0, dtype=torch.bfloat16, device=dev)
    mcfg = M.MapperConfig("transformer", clip_dim=ccfg_clip.embed_dim, llm_dim=gcfg.n_embd,
                          **(mapper_kw or dict(prefix_length=40, clip_length=40)))
    ccfg = Cap.CaptionModelConfig(mapper=mcfg, llm="gpt2", gpt2=gcfg)
    params = Cap.init_caption_params(0, ccfg, device=dev)
    with open(vocab[0]) as fh:
        eot = json.load(fh)["<|endoftext|>"]
    tok = Gpt2Tokenizer(*vocab, bos_id=eot, pad_id=eot)
    with open(tree[0]) as fh:
        ann = json.load(fh)[:n_images]
    images = np.stack(preprocess_many([os.path.join(tree[1], a["image"]) for a in ann], ccfg_clip.image_resolution))
    decode_step, count = G._decode_step, [0]

    def counting(*a, **k):
        count[0] += 1
        return decode_step(*a, **k)

    out = {"path": path}
    G._decode_step = counting
    try:
        A.reset_launch_counts()                 # counts start at 0 just before the path
        t0 = time.perf_counter()
        with torch.no_grad():
            embs = clip_model.encode_image(clip_params, ccfg_clip, torch.as_tensor(images, device=dev),
                                           attn=clip_model.best_attn(ccfg_clip, dev)).float()
        torch.cuda.synchronize()
        out["encode_ms"] = 1e3 * (time.perf_counter() - t0)
        for mode, beam in (("beam", True), ("greedy", False)):
            count[0] = 0
            t0 = time.perf_counter()
            captions = Cap.clipcap_predict(params, ccfg, embs, tok, use_beam=beam, beam_size=GPT2_BEAM,
                                           entry_length=GPT2_ENTRY)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            if len(captions) != n_images or not all(isinstance(c, str) for c in captions):
                raise AssertionError(f"{path} {mode}: captions {captions}")
            out[mode] = {"ms_per_image": ms / n_images, "decode_steps": count[0],
                         "ms_per_decode_token": ms / max(count[0], 1), "captions": captions[:2]}
        launches, by_shape = dict(A.LAUNCHES), dict(A.LAUNCH_SHAPES)   # read just after
    finally:
        G._decode_step = decode_step
    if not launches["fwd"]:
        raise AssertionError(f"{path}: the feature tower did not go through the kernel: launches={launches}")
    return dict(out, launches=launches, launches_by_shape={" ".join(map(str, k)): v for k, v in by_shape.items()})


def train_step_on_card_vs_cpu():
    """Phase 4h (d): one ``train_step`` (CapDec, the tiny OPT, a transformer
    mapper of 1 layer, lr 1e-3 with no warm-up) on the card and on the CPU
    from the same weights, batch and noise: the loss within rtol 1e-5, the
    mapper's leaves within 3e-5 (the CPU trainer tests' tolerances)."""
    from rlcf_torch.core import policy as Po
    from rlcf_torch.models import mappers as M
    from rlcf_torch.models import opt as O
    from rlcf_torch.tasks import caption as Cap

    ccfg = Cap.CaptionModelConfig(mapper=M.MapperConfig("transformer", clip_dim=16, llm_dim=32, prefix_length=4,
                                                         clip_length=2, num_layers=1, n_heads=2),
                                  opt=O.OPT_CONFIGS["test-tiny-opt"])
    tcfg = Cap.TrainConfig(lr=1e-3, warmup_steps=0, total_steps=4, cap_model="CapDec")
    params = Cap.init_caption_params(0, ccfg)
    rng = np.random.default_rng(0)
    batch = [rng.normal(size=(4, 16)).astype(np.float32), rng.integers(3, 256, size=(4, 6)),
             np.ones((4, 10), np.int64), rng.normal(size=(4, 16)).astype(np.float32)]
    out = {}
    for dev in ("cpu", "cuda"):
        init_opt, step = Cap.make_caption_trainer(ccfg, tcfg)
        mapper = Po.tree_map(lambda a: a.detach().to(dev).clone().requires_grad_(True), params["mapper"])
        llm = Po.tree_map(lambda a: a.to(dev), params["opt"])
        prefix, tokens, mask, noise = (torch.as_tensor(a, device=dev) for a in batch)
        loss = step(mapper, llm, init_opt(mapper), prefix, tokens, mask, noise)
        out[dev] = float(loss), [a.detach().cpu() for a in Po.tree_leaves(mapper)]
    moved = max(float((a - b).abs().max()) for a, b in zip(out["cpu"][1], Po.tree_leaves(params["mapper"])))
    worst = max(float((a - b).abs().max()) for a, b in zip(out["cuda"][1], out["cpu"][1]))
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    log(f"TRAIN_STEP card vs cpu: loss {out['cuda'][0]:.7f} vs {out['cpu'][0]:.7f} (rel {loss_rel:.2e}), "
        f"leaves max |d| {worst:.2e} (the step moved them up to {moved:.2e})")
    if loss_rel > 1e-5 or worst > 3e-5:
        raise AssertionError("the train step on the card disagrees with the CPU's")
    return {"loss_rel_diff": loss_rel, "leaves_max_abs_diff": worst, "step_moved_max": moved}


def caption_training(out_dir):
    """Phase 4h: caption training and the rest of captioning at full width:
    (a) ``extract_features`` on a synthetic COCO-caption tree, once untimed,
    then to one npz ("extract") and to shards ("extract sharded"); (b) ``train_caption``
    CapDec on the npz ("train capdec") and ClipCap on the shards ("train
    clipcap"); (c) the GPT-2 ClipCap predictor ("clipcap gpt2"); (d) one
    train step on the card against the CPU. Returns the paths and the
    TRAIN_CAPTION line's numbers."""
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.join(os.path.dirname(out_dir), "chip_smoke_train_caption")
    tree = write_caption_tree(os.path.join(root, "coco"), TRAIN_IMAGES, caps_per_image=TRAIN_CAPS, size=TRAIN_TREE_SIZE)
    vocab = write_opt_vocab(os.path.join(root, "vocab"))
    npz, shards = os.path.join(root, "feats.npz"), os.path.join(root, "feats_sharded.npz")
    from rlcf_torch.cli import extract_features
    extract_features.main(extract_argv(os.path.join(root, "warm.npz"), tree, vocab))   # first calls, not timed
    ext = [run_extract("extract", extract_argv(npz, tree, vocab)),
           run_extract("extract sharded", extract_argv(shards, tree, vocab, TRAIN_SHARD))]
    n = TRAIN_IMAGES * TRAIN_CAPS
    train = [run_train("train capdec", train_argv(os.path.join(root, "capdec"), npz, "CapDec"), n),
             run_train("train clipcap", train_argv(os.path.join(root, "clipcap"), shards, "ClipCap"), n)]
    gc.collect()
    torch.cuda.empty_cache()
    gpt2 = run_clipcap_gpt2("clipcap gpt2", tree, write_gpt2_vocab(os.path.join(root, "gpt2_vocab")))
    check = train_step_on_card_vs_cpu()
    for p in ext + train + [gpt2]:
        log("TRAIN_CAPTION_PATH " + json.dumps(p))
    line = {**{p["path"]: {k: p[k] for k in ("seconds", "encode_seconds", "captions_per_s", "images_per_s", "stages_s",
                                             "host_share_of_encode", "tower_share_of_encode")} for p in ext},
            **{p["path"]: {k: p[k] for k in ("ms_per_step", "first_step_ms", "samples_per_s", "peak_mem_gib",
                                             "losses", "profile_device_busy_ms", "idle_share_of_timed_step",
                                             "profile_kernels")} for p in train},
            "clipcap gpt2": {k: gpt2[k] for k in ("encode_ms", "beam", "greedy")},
            "train_step_card_vs_cpu": check,
            "extract_launches_per_caption_by_shape": {k: v / n for k, v in ext[0]["launches_by_shape"].items()},
            "note": "ms a step: the median of the steps after the first, each synchronised; the profile is one more "
                    "step on the last step's inputs; extraction after a warm-up run, its rates over the run without "
                    "its set-up (the random ViT-B/16 built and moved to the card, the tokenizer read)"}
    return ext + train + [gpt2], line


# serving and infrastructure (A15): the flagship's episode exported (tokens in, bf16 and fp32) and served in a fresh
# process; tta_cls --resume against one run; extraction with the native decoder beside PIL; the runner on the card
# against the CPU; the flagship's TFLOP an image. SERVE_TOL is the prompt-TTA parity tolerance on logits (fp32);
# DECODE_MIN_COS bounds the cosine of an image's embedding decoded natively against PIL's (the native resize is
# within ~+-2 gray of PIL's on ~0.03% of pixels); RUNNER_RTOL holds the runner's card run to its CPU run
SERVE_PRECISIONS, SERVE_TOL, SERVE_TIMED = ("bf16", "fp32"), 2e-4, 3
RESUME_LIMITS = (8, 16)
DECODE_WORKERS, DECODE_MIN_COS = 8, 0.999
RUNNER_EPOCHS, RUNNER_STEPS, RUNNER_RTOL = 2, 4, 1e-5
# the serving process: it imports torch and, of the port, the attention ops (which utils/export.py imports) and the
# profiling helpers, no model code; loads the artifact and the saved call arguments, serves one group with the
# launch counters set to 0 just before and read just after, records the selection (the first stable sort of the
# graph: the views' entropies) on a node-by-node run of the same program, and times SERVE_TIMED groups
SERVE_CODE = r"""
import time
stage, mark = {}, [time.perf_counter()]
def done(name):
    stage[name], mark[0] = time.perf_counter() - mark[0], time.perf_counter()
import json, sys, torch
from rlcf_torch.ops import attention as A
from rlcf_torch.utils.export import deserialize_program
from rlcf_torch.utils.profiling import EpisodeTimer, device_memory_stats
done("import_s")
artifact, inputs, out, device, timed = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5])
with open(artifact, "rb") as fh:
    program = deserialize_program(fh.read(), device)
call = program.module()
saved = torch.load(inputs, map_location=device, weights_only=True)
args = (*saved["weights"], saved["tokens"])
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
done("load_s")
A.reset_launch_counts()
logits = call(*args)
sync()
done("first_call_s")
launches = {"launches": dict(A.LAUNCHES), "variants": dict(A.LAUNCH_VARIANTS),
            "launches_by_shape": {" ".join(map(str, k)): v for k, v in A.LAUNCH_SHAPES.items()}}
first_sort = {}

class Recorder(torch.fx.Interpreter):
    def run_node(self, n):
        result = super().run_node(n)
        if n.target is torch.ops.aten.sort.stable and not first_sort:
            first_sort["indices"] = result[1]
        return result

Recorder(call).run(*torch.utils._pytree.tree_leaves(args))
done("record_s")
timer = EpisodeTimer()
for _ in range(timed):
    timer.start()
    timer.stop(1, call(*args))
targets = sorted({str(n.target) for n in program.graph.nodes if str(n.target).startswith("rlcf.")})
torch.save({"logits": logits.cpu(), "sorted": first_sort["indices"].cpu()}, out + ".pt")
port = sorted(m for m in sys.modules if m.startswith("rlcf_torch"))
with open(out + ".json", "w") as fh:
    json.dump({**launches, "group_ms": 1e3 * timer.seconds / max(timed, 1), "memory": device_memory_stats(),
               "rlcf_nodes": targets, "port_modules": port, "stage_s": stage}, fh)
"""
SERVE_MODULES = {"rlcf_torch", "rlcf_torch.ops", "rlcf_torch.ops.attention", "rlcf_torch.ops.cuda_build",
                 "rlcf_torch.utils", "rlcf_torch.utils.export", "rlcf_torch.utils.profiling"}


def export_argv(out, precision, input_="tokens"):
    """The flagship's settings (``flagship_argv``) for ``export_serving``."""
    return [".", "--test_sets", "synthetic", "--synthetic_classes", "A", "--arch", POLICY, "--reward_arch", REWARD,
            "--precision", precision, "--device", "cuda", "--batch_size", str(VIEWS), "--selection_p", "0.1",
            "--sample_k", "3", "--tta_steps", str(STEPS), "--lr", "7e-3", "--ctx_init", "a_photo_of_a",
            "--episode_group", str(GROUP), "--seed", "0", "--input", input_, "--out", out]


def serve_in_fresh_process(artifact, clf, toks, path, device="cuda", timed=SERVE_TIMED):
    """Serve one group of ``toks`` from ``artifact`` in a new Python process
    (``SERVE_CODE``) with ``clf``'s weights, saved beside it; returns its
    record with the served logits and selection."""
    inputs = artifact + ".inputs.pt"
    torch.save({"weights": clf.weights(), "tokens": toks}, inputs)
    res = subprocess.run([sys.executable, "-c", SERVE_CODE, artifact, inputs, artifact + ".served", device, str(timed)],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True, timeout=900)
    os.unlink(inputs)
    if res.returncode != 0:
        raise AssertionError(f"{path}: the serving process failed:\n{res.stderr[-4000:]}")
    with open(artifact + ".served.json") as fh:
        rec = json.load(fh)
    rec.update(torch.load(artifact + ".served.pt"))
    extra = sorted(set(rec["port_modules"]) - SERVE_MODULES)
    if extra:
        raise AssertionError(f"{path}: the serving process imported more of the port than the ops: {extra}")
    return rec


def serving_export(out_dir, names, device="cuda"):
    """Phase 4i (a): ``export_serving --input tokens`` at the flagship's full
    width in bf16 and fp32, each artifact served in a fresh process against
    the eager ``adapt_tokens`` on the same tokens and weights; the served
    program's graph holds both ``rlcf::`` ops and its launches count both
    kernels. fp32: logits within SERVE_TOL and equal selections; bf16: the
    served and eager group ms (EpisodeTimer), no claim. Returns (paths, line)."""
    from rlcf_torch.cli import export_serving
    from rlcf_torch.data.datasets import SyntheticDataset
    from rlcf_torch.ops.augmix import fused_views
    from rlcf_torch.utils.profiling import EpisodeTimer, device_memory_stats

    imgs = np.stack([SyntheticDataset(n=GROUP, n_classes=200)[i][0] for i in range(GROUP)])
    planar = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()).to(device)
    toks = fused_views(planar, torch.Generator(device=device).manual_seed(0), n_views=VIEWS, resolution=RES,
                       src_size=SRC_SIZE, p_policy=16)
    paths, line = [], {}
    for precision in SERVE_PRECISIONS:
        artifact = os.path.join(out_dir, f"episode_{precision}.rlcfx")
        exported = export_serving.main(export_argv(artifact, precision))
        phase_done(f"4i export {precision}")
        clf = exported.pop("classifier")   # the traced classifier, set up for the flagship's classes
        eager_logits, aux = clf.adapt_tokens(toks)
        timer = EpisodeTimer()
        for _ in range(SERVE_TIMED):
            timer.start()
            timer.stop(1, clf.adapt_tokens(toks)[0])
        path = f"serve {precision}"
        phase_done(f"4i eager {precision}")
        served = serve_in_fresh_process(artifact, clf, toks, path, device)
        phase_done(f"4i serve {precision}")
        S = aux["selected"].shape[1]
        same_sel = bool(torch.equal(served["sorted"][:, :S], aux["selected"].cpu()))
        d_logits = float((served["logits"].float() - eager_logits.float().cpu()).abs().max())
        ops = ["rlcf.fused_attention.default", "rlcf.fused_attention_bwd.default"]
        rec = {"artifact_mb": exported["bytes"] / 1e6, "trace_seconds": exported["trace_seconds"],
               "served_ms_per_group": served["group_ms"], "eager_ms_per_group": 1e3 * timer.seconds / SERVE_TIMED,
               "served_memory": served["memory"], "eager_memory": device_memory_stats(), "selected_equal": same_sel,
               "max_abs_logit_diff": d_logits, "max_abs_logit": float(eager_logits.float().abs().max()),
               "served_launches": served["launches"], "served_variants": served["variants"],
               "rlcf_nodes": served["rlcf_nodes"], "serving_process_port_modules": served["port_modules"],
               "serving_process_stage_s": served["stage_s"]}
        log(f"SERVE {precision} " + json.dumps(rec))
        launched = served["launches"]["fwd"] and served["launches"]["bwd"]
        if not all(op in served["rlcf_nodes"] for op in ops) or (device == "cuda" and not launched):
            raise AssertionError(f"{path}: the served program did not go through both kernels: {rec}")
        if tuple(served["logits"].shape) != (GROUP, len(names)) or not bool(torch.isfinite(served["logits"]).all()):
            raise AssertionError(f"{path}: served logits {tuple(served['logits'].shape)} not finite [{GROUP}, 200]")
        if precision == "fp32" and (not same_sel or d_logits > SERVE_TOL):
            raise AssertionError(f"{path}: served logits differ from the eager episode by {d_logits:.3e} "
                                 f"(tolerance {SERVE_TOL}) or the selections differ ({same_sel})")
        line[precision] = rec
        paths.append({"path": path, "launches_by_shape": served["launches_by_shape"]})
        del clf, exported
        gc.collect()
        torch.cuda.empty_cache()
    return paths, line


def _journal(out):
    with open(os.path.join(out, "progress_synthetic.jsonl")) as fh:
        return [json.loads(x) for x in fh]


def serving_resume(out_dir):
    """Phase 4i (b): ``tta_cls`` at the flagship's settings with --limit 8,
    then --limit 16 --resume into the same output, against one --limit 16 run,
    each from an empty output directory (``tta_cls`` appends to its journal):
    the journals and the final counts are equal, and the resumed groups'
    logits equal the same groups' in the one run bit for bit (random weights
    score ~0 right, so the counts alone say little). Where they differ, the
    uninterrupted run is repeated: a difference is a fault unless the repeat
    differs from it too (run-to-run nondeterminism, reported). Either way the
    resumed journal keeps the first run's lines and has one run's samples a
    line, and the resumed run runs only the groups left."""
    from rlcf_torch.cli import tta_cls
    from rlcf_torch.ops import attention as A
    from rlcf_torch.ops import augmix as X
    from rlcf_torch.tasks.classification import PromptTTAClassifier

    first, full = RESUME_LIMITS
    resumed, one = os.path.join(out_dir, "resume"), os.path.join(out_dir, "resume_one_run")
    repeat = os.path.join(out_dir, "resume_repeat")
    for d in (resumed, one, repeat):
        shutil.rmtree(d, ignore_errors=True)
    adapt, logits = PromptTTAClassifier.adapt_tokens, []

    def run(out, limit, *extra):   # each group's logits recorded
        logits.clear()
        result = tta_cls.main(flagship_argv(out, limit=limit, extra=extra))["synthetic"]
        return result, [lg.cpu() for lg in logits]

    def recording(self, *toks):
        out = adapt(self, *toks)
        logits.append(out[0])
        return out

    PromptTTAClassifier.adapt_tokens = recording
    try:
        run(resumed, first)
        first_journal = _journal(resumed)
        A.reset_launch_counts()                 # counts start at 0 just before the resumed run
        X.reset_launch_counts()
        r, r_logits = run(resumed, full, "--resume")
        by_shape = {" ".join(map(str, k)): v for k, v in {**A.LAUNCH_SHAPES, **X.LAUNCH_SHAPES}.items()}   # read after
        o, o_logits = run(one, full)
        counts = lambda res: {k: res[k] for k in ("n", "c1", "c5")}
        # the resumed run's groups against the same groups of one run, bit for bit (their views' seeds went on)
        same = len(r_logits) == (full - first) // GROUP and all(
            torch.equal(a, b) for a, b in zip(r_logits, o_logits[len(o_logits) - len(r_logits):]))
        sizes = lambda journal: [x["n"] for x in journal]
        rec = {"resumed_groups_run": len(r["group_seconds"]), "resumed": counts(r), "one_run": counts(o),
               "journal_equal": _journal(resumed) == _journal(one), "logits_equal": same,
               "first_run_lines_kept": _journal(resumed)[:len(first_journal)] == first_journal,
               "journal_sizes_equal": sizes(_journal(resumed)) == sizes(_journal(one)), "journal": _journal(one)}
        if not (rec["journal_equal"] and same) or counts(r) != counts(o):
            _, p_logits = run(repeat, full)
            rec["repeat_equal_to_one_run"] = _journal(repeat) == _journal(one) and all(
                torch.equal(a, b) for a, b in zip(p_logits, o_logits))
    finally:
        PromptTTAClassifier.adapt_tokens = adapt
    if not (rec["journal_equal"] and rec["logits_equal"]) or counts(r) != counts(o):
        if rec["repeat_equal_to_one_run"]:
            raise AssertionError(f"resume: the resumed run differs from one run, which repeats itself: {rec}")
        log("RESUME the uninterrupted run differs from its own repeat: run-to-run nondeterminism, not a resume fault")
    if rec["resumed_groups_run"] != (full - first) // GROUP or not rec["first_run_lines_kept"] or \
            not rec["journal_sizes_equal"] or r["n"] != o["n"]:
        raise AssertionError(f"resume: the resumed run did not go on from the first run's journal: {rec}")
    log("RESUME " + json.dumps(rec))
    return {"path": "resume", "launches_by_shape": by_shape}, rec


def serving_decode(out_dir):
    """Phase 4i (c): phase 4h's extraction (``extract_argv``: 70 images x 5
    captions at 480x640, ViT-B/16 bf16) with PIL and with ``--decode native
    --decode_workers 8``, each split by stage; the image embeddings held to
    each other by their cosine. Where the card's machine lacks the codec
    headers or libraries, one line says so and nothing runs under the name."""
    from rlcf_torch.data import native

    if not native.decode_available():
        log(f"decode native: unavailable on this machine ({native._load()[1]})")
        return [], {"unavailable": native._load()[1]}
    root = os.path.join(out_dir, "decode")
    tree = write_caption_tree(os.path.join(root, "coco"), TRAIN_IMAGES, caps_per_image=TRAIN_CAPS,
                              size=TRAIN_TREE_SIZE)
    vocab = write_opt_vocab(os.path.join(root, "vocab"))
    native_flags = ["--decode", "native", "--decode_workers", str(DECODE_WORKERS)]
    runs = [run_extract("extract pil", extract_argv(os.path.join(root, "pil.npz"), tree, vocab)),
            run_extract("extract native", extract_argv(os.path.join(root, "native.npz"), tree, vocab) + native_flags)]
    emb = [np.load(os.path.join(root, f"{k}.npz"))["image_embeddings"] for k in ("pil", "native")]
    cos = (emb[0] * emb[1]).sum(-1) / np.linalg.norm(emb[0], axis=-1) / np.linalg.norm(emb[1], axis=-1)
    rec = {p["path"]: {k: p[k] for k in ("seconds", "encode_seconds", "captions_per_s", "images_per_s", "stages_s",
                                         "host_share_of_encode")} for p in runs}
    rec.update(min_image_cosine=float(cos.min()), mean_image_cosine=float(cos.mean()), workers=DECODE_WORKERS,
               cpu_count=os.cpu_count())
    log("DECODE " + json.dumps(rec))
    if not cos.min() >= DECODE_MIN_COS:
        raise AssertionError(f"decode native: image embeddings differ from PIL's (min cosine {cos.min():.6f}, "
                             f"bound {DECODE_MIN_COS})")
    return [{"path": p["path"], "launches_by_shape": p["launches_by_shape"]} for p in runs], rec


def runner_problem(device):
    """A small two-layer model and its batches, from seeds (``core/runner.py``'s check)."""
    rng = np.random.default_rng(0)
    params = {"l1": {"w": rng.normal(size=(64, 256)) / 8, "b": np.zeros(256)},
              "l2": {"w": rng.normal(size=(256, 10)) / 16, "b": np.zeros(10)}, "ln": {"g": np.ones(256)}}
    params = {k: {n: torch.tensor(v, dtype=torch.float32, device=device) for n, v in d.items()}
              for k, d in params.items()}
    batches = [(rng.normal(size=(32, 64)).astype(np.float32), rng.integers(0, 10, 32)) for _ in range(RUNNER_STEPS)]

    def step(p, batch, gen):
        x, y = (torch.as_tensor(b, device=device) for b in batch)
        h = torch.relu(x @ p["l1"]["w"] + p["l1"]["b"]) * p["ln"]["g"]
        return torch.nn.functional.cross_entropy(h @ p["l2"]["w"] + p["l2"]["b"], y)
    return params, (lambda: batches), step


def serving_runner(out_dir, device="cuda"):
    """Phase 4i (d): ``core/runner.py`` trains a small model RUNNER_EPOCHS
    epochs on the card and on the CPU (within RUNNER_RTOL); a fresh runner
    resumed from epoch 0's checkpoint ends on the uninterrupted parameters;
    ``utils/profiling.py::trace`` writes the card run's trace under build/."""
    from rlcf_torch.core.runner import Runner, RunnerConfig, _flatten
    from rlcf_torch.utils.profiling import trace

    cfg = lambda name: RunnerConfig(max_epoch=RUNNER_EPOCHS, steps_per_epoch=RUNNER_STEPS, init_lr=1e-2,
                                    warmup_steps=2, output_dir=os.path.join(out_dir, name))
    runs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        params, loader, step = runner_problem(dev)
        runs[name] = Runner(cfg(name), params, step)
        with trace(os.path.join(out_dir, "trace") if name == "card" else None):
            runs[name].train(loader)
    params, loader, step = runner_problem(device)
    resumed = Runner(cfg("resumed"), params, step)
    resumed.load_checkpoint(os.path.join(out_dir, "card", "checkpoint_0.npz"))
    resumed.train(loader)
    rel = lambda a, b: max(float((x.detach().cpu() - y.detach().cpu()).abs().max() / y.detach().cpu().abs().max())
                           for x, y in zip(_flatten(a.params).values(), _flatten(b.params).values()))
    trace_file = os.path.join(out_dir, "trace", "trace.json")
    rec = {"card_vs_cpu_max_rel": rel(runs["card"], runs["cpu"]), "resumed_vs_one_run_max_rel": rel(resumed, runs["card"]),
           "trace_bytes": os.path.getsize(trace_file) if os.path.exists(trace_file) else 0}
    log("RUNNER " + json.dumps(rec))
    if rec["card_vs_cpu_max_rel"] > RUNNER_RTOL or rec["resumed_vs_one_run_max_rel"] > RUNNER_RTOL or \
            not rec["trace_bytes"]:
        raise AssertionError(f"runner: {rec}")
    return rec


def serving_and_infrastructure(out_dir):
    """Phase 4i: serving and infrastructure (A15): (a) the export, (b) the
    resume, (c) the native decoder, (d) the runner, (e) the flagship's TFLOP
    an image (``utils/flops.py``, ``bench.py``'s accounting) and its rate at
    the eager bf16 group's ms. Returns (paths, the SERVING line's numbers)."""
    from rlcf_torch.data.class_names import get_classnames
    from rlcf_torch.models.clip import get_config
    from rlcf_torch.utils.flops import H100_SXM_BF16_PEAK, prompt_tta_flops_per_image

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(os.path.dirname(out_dir), "chip_smoke_serving")
    os.makedirs(out_dir, exist_ok=True)
    names = get_classnames("A")
    paths, export = serving_export(out_dir, names)
    resume_path, resume = serving_resume(out_dir)
    phase_done("4i resume")
    decode_paths, decode = serving_decode(out_dir)
    phase_done("4i decode")
    runner = serving_runner(out_dir)
    phase_done("4i runner")
    tflop = prompt_tta_flops_per_image(get_config(POLICY), get_config(REWARD), VIEWS, 0.1, STEPS, len(names),
                                       text_seq_len(names)) / 1e12
    eager_s = export["bf16"]["eager_ms_per_group"] / 1e3
    line = {"export": export, "resume": {k: v for k, v in resume.items() if k != "journal"}, "decode": decode,
            "runner": runner, "tflop_per_image": tflop, "eager_bf16_tflop_per_s": tflop * GROUP / eager_s,
            "eager_bf16_share_of_dense_peak": tflop * GROUP / eager_s / (H100_SXM_BF16_PEAK / 1e12)}
    log(f"FLOPS flagship {tflop:.4f} TFLOP an image (bench.py's accounting); the eager bf16 group at "
        f"{export['bf16']['eager_ms_per_group']:.1f} ms: {line['eager_bf16_tflop_per_s']:.1f} TFLOP/s")
    return paths + [resume_path] + decode_paths, line


# parallelism (A14, phase 4j): the sharded CLIs under torchrun on the one card, every rank a process and all of
# them sharing the card over gloo (NCCL refuses two ranks on one device): 4 ranks (dp 2 x tp 2) run tta_cls --tp 2
# (the flagship in bf16, 2 groups of 4; and in fp32, one group), tta_retrieval --tp 2 (both directions, fp32, the
# 8 x 1 tree) and tta_caption --dp 2 --tp 2 (OPT-125m, fp32, 4 images, 1 step); 2 ranks run tune_cls --dp 2 (one
# group of 2 images, bf16 and fp32); each fp32 run against the same flags in this process
PAR_CLS_IMAGES, PAR_CLS_FP32_IMAGES, PAR_ENC_IMAGES, PAR_CAP_IMAGES, PAR_CAP_STEPS = 8, 4, 2, 4, 1
PAR_FP32_TOL = 2e-4   # logits and scores: |sharded - one process| <= tol + tol * |one process|; entropies' near-tie
PAR_BEAM_TIE = 1e-5   # ROADMAP's beam-tie rule
# the kernels every rank of each run must launch (the caption path has no attention backward: its update
# differentiates OPT and the mapper, not a CLIP tower)
PAR_NEEDS = {"tp cls bf16": ("fwd", "bwd", "augmix"), "tp cls fp32": ("fwd", "bwd", "augmix"),
             "tp retrieval fp32": ("fwd", "bwd"), "dp tp caption fp32": ("fwd",),
             "dp encoder bf16": ("fwd", "bwd"), "dp encoder fp32": ("fwd", "bwd")}
# each rank: the runs of a JSON list in turn, the engine entry point of each recorded (rank 0 saves what it
# returned), the launch counters set to 0 just before the CLI's main and read just after, one JSON a rank
RANK_CODE = r"""
import gc, importlib, json, os, sys, time
import torch
runs = json.load(open(sys.argv[1]))
from rlcf_torch.ops import attention as A
from rlcf_torch.ops import augmix as X
from rlcf_torch.parallel import mesh as M

cuda = torch.cuda.is_available()   # the ranks of the CPU tests run this too
sync = torch.cuda.synchronize if cuda else (lambda: None)

def to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x

stdout = sys.stdout
for run in runs:
    module, name, attr = run["record"]
    owner = getattr(importlib.import_module(module), name)
    original, seen = getattr(owner, attr), []
    def recording(self, *a, _original=original, _seen=seen, **k):
        out = _original(self, *a, **k)
        _seen.append(to_cpu(out))
        return out
    setattr(owner, attr, recording)
    cli = importlib.import_module(run["module"])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    X.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        cli.main(run["argv"])
        sync()
    finally:
        setattr(owner, attr, original)
        sys.stdout = stdout
    rank = M.rank()
    rec = {"rank": rank, "world": M.world_size(), "backend": M.backend(), "ranks_per_device": M.ranks_per_device(),
           "wall_s": time.perf_counter() - t0,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
           "launches": {**A.LAUNCHES, **X.LAUNCHES}, "variants": dict(A.LAUNCH_VARIANTS),
           "launches_by_shape": {" ".join(map(str, k)): v for k, v in {**A.LAUNCH_SHAPES, **X.LAUNCH_SHAPES}.items()}}
    with open(os.path.join(run["out"], f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    if rank == 0:
        torch.save(seen, os.path.join(run["out"], "recorded.pt"))
    del seen
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    M.barrier()
"""


def launch_ranks(out_dir, nproc, runs, timeout=900):
    """Every run of ``runs`` ({"name", "module", "argv", "record"}) in turn on
    ``nproc`` ranks of one ``torchrun --standalone`` launch (``RANK_CODE``);
    returns {name: (per-rank records, rank 0's recorded outputs)} and the
    launch's wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    script, spec = os.path.join(out_dir, "rank_main.py"), os.path.join(out_dir, f"runs_{nproc}.json")
    for run in runs:
        run["out"] = os.path.join(out_dir, run["name"].replace(" ", "_"))
        shutil.rmtree(run["out"], ignore_errors=True)
        os.makedirs(run["out"])
    with open(script, "w") as fh:
        fh.write(RANK_CODE)
    with open(spec, "w") as fh:
        json.dump(runs, fh)
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                          str(nproc), script, spec], cwd=root, env=env, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"torchrun_{nproc}.log"), "w") as fh:
        fh.write(res.stdout + "\n--- stderr ---\n" + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"torchrun of {nproc} ranks failed (rc {res.returncode}):\n{res.stderr[-5000:]}")
    out = {}
    for run in runs:
        ranks = []
        for r in range(nproc):
            with open(os.path.join(run["out"], f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        out[run["name"]] = (ranks, torch.load(os.path.join(run["out"], "recorded.pt"), weights_only=False))
    return out, wall


@contextlib.contextmanager
def recorded_calls(owner, attr):
    """The values ``owner.attr`` returns while inside, moved to the CPU."""
    original, seen = getattr(owner, attr), []

    def recording(*a, **k):
        out = original(*a, **k)
        seen.append(out)
        return out

    setattr(owner, attr, recording)
    try:
        yield seen
    finally:
        setattr(owner, attr, original)


def one_process(cli, args, owner, attr, forced=None):
    """``cli`` on ``args`` in this process: what ``owner.attr`` returned and
    the entropies each selection saw. With ``forced`` (one selection a
    group, in group order) each selection returns the group's instead."""
    from rlcf_torch.core import losses as Lo

    entropies = []
    select = Lo.select_confident_entropy

    def recording_select(ent, n):
        entropies.append(ent.detach().cpu())
        sel = select(ent, n)
        if forced is None:
            return sel
        want = forced[len(entropies) - 1]
        if tuple(want.shape) != tuple(sel.shape):
            raise AssertionError(f"forced selection {tuple(want.shape)}, selected {tuple(sel.shape)}")
        return want.to(sel.device, sel.dtype)

    Lo.select_confident_entropy = recording_select
    try:
        with recorded_calls(owner, attr) as seen:
            cli.main(args)
    finally:
        Lo.select_confident_entropy = select
    return seen, entropies


def swaps_at_boundary(entropies, n_keep, got, want, tol=PAR_FP32_TOL):
    """How many views one row's two selections swap (``got`` and ``want``,
    the kept views' indices), or None if a swapped view's entropy (of
    ``entropies`` [B], the one-process run's) lies more than ``tol`` from
    the selection boundary: a swap may only cross the boundary between the
    n_keep-th and the next lowest entropy, and only where the two lie
    within ``tol``."""
    e = entropies.float()
    ranked = e.sort().values
    lo, hi = float(ranked[n_keep - 1]), float(ranked[n_keep])
    swapped = sorted(set(got.tolist()) ^ set(want.tolist()))
    if all(hi - tol <= float(e[v]) <= lo + tol for v in swapped):
        return len(swapped) // 2
    return None


def compare_group_logits(label, got, want, n_keep, want_entropies, rerun=None):
    """Sharded against one process, group by group and row by row:
    selections equal, or differing only by views swapped across a near-tie of
    the one-process entropies at the selection boundary (reported with the
    count of swapped views, not re-seeded); then every row's logits within
    the fp32 tolerance. Where a selection swapped and ``rerun`` is given, the
    logits are held against ``rerun(selections)``: the one-process run made
    again with each group's selection forced to the sharded run's, so a
    swapped row is held to an episode on the views it adapted on."""
    ties, swaps = [], 0
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} groups sharded, {len(want)} in one process")
    for g, ((_, gaux), (_, waux), ent) in enumerate(zip(got, want, want_entropies)):
        gsel, wsel, ent = gaux["selected"].cpu(), waux["selected"].cpu(), ent.cpu()
        for row in range(gsel.shape[0]):
            n = swaps_at_boundary(ent[row], n_keep, gsel[row], wsel[row])
            if n is None:
                raise AssertionError(f"{label} group {g} row {row}: selections differ off a near-tie at the "
                                     f"selection boundary")
            if n:
                swaps += n
                ties.append(g)
    held = want
    if ties and rerun is not None:
        held = rerun([gaux["selected"].cpu() for _, gaux in got])
        if len(held) != len(got) or not all(torch.equal(haux["selected"].cpu(), gaux["selected"].cpu())
                                            for (_, haux), (_, gaux) in zip(held, got)):
            raise AssertionError(f"{label}: the rerun on the sharded selections did not select them")
    worst = 0.0
    for g, ((gl, _), (hl, _)) in enumerate(zip(got, held)):
        gl, hl = gl.float().cpu(), hl.float().cpu()
        d = float((gl - hl).abs().max())
        worst = max(worst, d)
        if not bool(((gl - hl).abs() <= PAR_FP32_TOL + PAR_FP32_TOL * hl.abs()).all()):
            raise AssertionError(f"{label} group {g}: logits differ by {d:.3e}")
    ties = sorted(set(ties))
    return {"max_abs_logit_diff": worst, "selections_equal": not ties, "near_tie_groups": ties,
            "views_swapped": swaps, "logits_held_on": "the sharded selections" if held is not want
            else "one process's selections"}


def parallelism(out_dir, entries):
    """Phase 4j: parallelism (A14). The sharded CLIs under torchrun, ranks
    sharing the one card over gloo, each rank's launches counted from 0 just
    before its CLI's main and read just after: every rank of every run must
    launch the attention forward and backward (the caption path has no
    attention backward: its update differentiates OPT and the mapper) and,
    where views are fused, the AugMix kernel. The fp32 runs against the same
    flags in this process. Then a world-1 NCCL group runs dp_gather and
    all_reduce_grads through the port's helpers. New attention shapes are
    checked against the plain version here (appended to ``entries``).
    Returns (paths, the PARALLEL line's numbers)."""
    from rlcf_torch.cli import tta_caption, tta_cls, tta_retrieval, tune_cls
    from rlcf_torch.models import opt as O
    from rlcf_torch.tasks.caption import CaptionTTA
    from rlcf_torch.tasks.classification import EncoderTTAClassifier, PromptTTAClassifier
    from rlcf_torch.tasks.retrieval import RetrievalTTA

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(os.path.dirname(out_dir), "chip_smoke_parallel")
    os.makedirs(out_dir, exist_ok=True)
    ret_tree = write_retrieval_tree(os.path.join(out_dir, "retrieval_tree"), *RET_FP32_TREE, size=RET_TREE_SIZE)
    cap_tree = write_caption_tree(os.path.join(out_dir, "caption_tree"), PAR_CAP_IMAGES, size=RET_TREE_SIZE)
    vocab = write_opt_vocab(os.path.join(out_dir, "vocab"))
    o = lambda name: os.path.join(out_dir, name)
    # the engines' group runs: what a group's episodes return, gathered in episode order (a dp rank whose
    # slice of the views it built itself runs them there, not through adapt_tokens / adapt)
    cls_rec = ("rlcf_torch.tasks.classification", "PromptTTAClassifier", "_run_group")
    argv = {
        "tp cls bf16": flagship_argv(o("cls_bf16"), limit=PAR_CLS_IMAGES, extra=("--tp", "2")),
        "tp cls fp32": flagship_argv(o("cls_fp32"), "fp32", limit=PAR_CLS_FP32_IMAGES, extra=("--tp", "2")),
        "tp retrieval fp32": retrieval_argv(o("ret_fp32"), "both", "fp32", tree=ret_tree, extra=("--tp", "2")),
        "dp tp caption fp32": caption_argv(o("cap_fp32"), cap_tree, vocab, "fp32", limit=PAR_CAP_IMAGES,
                                           steps=PAR_CAP_STEPS) + ["--dp", "2", "--tp", "2"],
        "dp encoder bf16": encoder_argv(o("enc_bf16"), limit=PAR_ENC_IMAGES, extra=("--dp", "2")),
        "dp encoder fp32": encoder_argv(o("enc_fp32"), "fp32", limit=PAR_ENC_IMAGES, extra=("--dp", "2")),
    }
    four = [{"name": n, "module": m, "argv": argv[n], "record": r} for n, m, r in (
        ("tp cls bf16", "rlcf_torch.cli.tta_cls", cls_rec), ("tp cls fp32", "rlcf_torch.cli.tta_cls", cls_rec),
        ("tp retrieval fp32", "rlcf_torch.cli.tta_retrieval",
         ("rlcf_torch.tasks.retrieval", "RetrievalTTA", "adapt_queries")),
        ("dp tp caption fp32", "rlcf_torch.cli.tta_caption", ("rlcf_torch.tasks.caption", "CaptionTTA", "adapt_batch")))]
    enc_rec = ("rlcf_torch.tasks.classification", "EncoderTTAClassifier", "_run_group")
    two = [{"name": n, "module": "rlcf_torch.cli.tune_cls", "argv": argv[n], "record": enc_rec}
           for n in ("dp encoder bf16", "dp encoder fp32")]
    runs, wall4 = launch_ranks(out_dir, 4, four)
    phase_done("4j torchrun 4 ranks")
    more, wall2 = launch_ranks(out_dir, 2, two)
    runs.update(more)
    phase_done("4j torchrun 2 ranks")

    paths, line = [], {"launch_wall_s": {"4 ranks": wall4, "2 ranks": wall2}, "runs": {}}
    for name, (ranks, _) in runs.items():
        for rec in ranks:
            if rec["backend"] != "gloo" or rec["ranks_per_device"] != len(ranks):
                raise AssertionError(f"{name} rank {rec['rank']}: backend {rec['backend']}, "
                                     f"{rec['ranks_per_device']} ranks a card; expected gloo, {len(ranks)}")
            paths.append({"path": f"{name} rank{rec['rank']}", "launches_by_shape": rec["launches_by_shape"]})
        line["runs"][name] = {"ranks": len(ranks), "wall_s": [r["wall_s"] for r in ranks],
                              "peak_mem_gib": [r["peak_mem_gib"] for r in ranks],
                              "launches": [r["launches"] for r in ranks]}

    # the flagship in bf16: finite logits of every group on the whole class axis
    for logits, aux in runs["tp cls bf16"][1]:
        if tuple(logits.shape) != (GROUP, 200) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"tp cls bf16: logits {tuple(logits.shape)} not finite [{GROUP}, 200]")
    if len(runs["tp cls bf16"][1]) != PAR_CLS_IMAGES // GROUP:
        raise AssertionError("tp cls bf16: not every group ran")
    for logits, aux in runs["dp encoder bf16"][1]:
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("dp encoder bf16: logits not finite")

    # the fp32 runs against one process
    n_keep = int(VIEWS * 0.1)
    cls_args = lambda name: flagship_argv(o(name), "fp32", limit=PAR_CLS_FP32_IMAGES)
    want, ent = one_process(tta_cls, cls_args("cls_fp32_one"), PromptTTAClassifier, "_run_group")
    line["cls_fp32"] = compare_group_logits(
        "tp cls fp32", runs["tp cls fp32"][1], want, n_keep, ent,
        rerun=lambda sel: one_process(tta_cls, cls_args("cls_fp32_forced"), PromptTTAClassifier, "_run_group",
                                      sel)[0])
    enc_args = lambda name: encoder_argv(o(name), "fp32", limit=PAR_ENC_IMAGES, extra=("--episode_group", "2"))
    want, ent = one_process(tune_cls, enc_args("enc_fp32_one"), EncoderTTAClassifier, "_run_group")
    line["encoder_fp32"] = compare_group_logits(
        "dp encoder fp32", runs["dp encoder fp32"][1], want, n_keep, ent,
        rerun=lambda sel: one_process(tune_cls, enc_args("enc_fp32_forced"), EncoderTTAClassifier, "_run_group",
                                      sel)[0])
    want, _ = one_process(tta_retrieval, retrieval_argv(o("ret_fp32_one"), "both", "fp32", tree=ret_tree),
                          RetrievalTTA, "adapt_queries")
    got = runs["tp retrieval fp32"][1]
    worst = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    if len(got) != len(want) or not all(np.all(np.abs(g - w) <= PAR_FP32_TOL + PAR_FP32_TOL * np.abs(w))
                                        for g, w in zip(got, want)):
        raise AssertionError(f"tp retrieval fp32: score rows differ from one process by {worst:.3e}")
    line["retrieval_fp32"] = {"groups": len(got), "max_abs_score_diff": worst}
    with recorded_calls(O, "beam_generate") as beams:
        want, _ = one_process(tta_caption, caption_argv(o("cap_fp32_one"), cap_tree, vocab, "fp32",
                                                        limit=PAR_CAP_IMAGES, steps=PAR_CAP_STEPS),
                              CaptionTTA, "adapt_batch")
    got = runs["dp tp caption fp32"][1]
    line["caption_fp32"] = {"groups": len(got), "captions_equal": got == want, "captions": got[0][:2]}
    if got != want:   # a beam may differ only on a near-tie of its candidates' scores
        line["caption_fp32"]["one_process_beam_score_gaps"] = [
            float((s[:, 0] - s[:, 1]).abs().min()) for _, s in beams if s.shape[1] > 1]
        log("PARALLEL caption fp32: captions differ from one process: " + json.dumps(line["caption_fp32"]))
        if not any(gap <= PAR_BEAM_TIE for gap in line["caption_fp32"]["one_process_beam_score_gaps"]):
            raise AssertionError("dp tp caption fp32: captions differ from one process off a beam tie")
    phase_done("4j one-process references")

    # a world-1 NCCL group on the card through the port's helpers
    line["nccl_world_1"] = nccl_world_one(out_dir)

    # the shapes the ranks launched that phase 3 did not check
    checked = {" ".join(map(str, e["shape"])) for e in entries}
    new = sorted({k for p in paths for k in p["launches_by_shape"]} - checked)
    for key in new:
        kind, *dims = key.split(" ")
        if kind not in ("fwd", "bwd"):
            raise AssertionError(f"a sharded path launched {key}, which phase 3 did not check")
        B, T, H = (int(d) for d in dims[:3])
        dtype = torch.bfloat16 if dims[3] == str(torch.bfloat16) else torch.float32
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        entries.append(check_kernel(kind, B, T, H, dtype, T <= 77, f"sharded rank B={B} T={T} H={H} {tag}"))
    line["shapes_checked_here"] = new
    return paths, line


def check_rank_launches(runs):
    """Phase 5 for the sharded runs of phase 4j (the PARALLEL line's "runs"):
    every rank of every run launched the kernels ``PAR_NEEDS`` names."""
    for name, run in runs.items():
        for rank, launches in enumerate(run["launches"]):
            missing = [kind for kind in PAR_NEEDS[name] if not launches.get(kind)]
            if missing:
                raise AssertionError(f"{name} rank {rank} launched no {missing}: {launches}")


def nccl_world_one(out_dir):
    """A world-1 process group on the card, the backend the port picks for a
    card of its own (NCCL), running ``dp_gather`` and ``all_reduce_grads``."""
    import torch.distributed as dist
    from rlcf_torch.parallel import mesh as M
    from rlcf_torch.parallel.collectives import all_reduce_grads

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    store = os.path.join(out_dir, "nccl_rendezvous")
    if os.path.exists(store):
        os.unlink(store)
    os.environ.update(env)
    try:
        M.init_distributed("cuda", init_method=f"file://{store}", timeout_s=60)
        mesh = M.Mesh(1, 1, dp_group=dist.group.WORLD)
        x = torch.arange(12.0, device="cuda").reshape(4, 3)
        gathered = M.dp_gather(mesh, x)
        grads = all_reduce_grads([torch.ones(5, device="cuda"), torch.full((2,), 2.0, device="cuda")],
                                 dist.group.WORLD)
        torch.cuda.synchronize()
        ok = torch.equal(gathered, x) and all(torch.equal(g, w) for g, w in zip(
            grads, (torch.ones(5, device="cuda"), torch.full((2,), 2.0, device="cuda"))))
        rec = {"backend": M.backend(), "dp_gather_and_all_reduce_grads_ok": ok}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rec["backend"] != "nccl" or not ok:
        raise AssertionError(f"the world-1 NCCL group failed: {rec}")
    log("NCCL world-1 group on the card: dp_gather and all_reduce_grads ran through the port's helpers")
    return rec


# ---------------------------------------------------------------------------
# Phase 4k: the device view generator (A16)
# ---------------------------------------------------------------------------


def viewgen_sources(n, seed):
    """``n`` canonical u8 sources ``[n, SRC_SIZE, SRC_SIZE, 3]`` (the
    synthetic set's images, as the CLI paths take them), on the CPU."""
    from rlcf_torch.data.datasets import SyntheticDataset

    data = SyntheticDataset(n=n + seed, n_classes=200)
    return torch.from_numpy(np.stack([data[seed + i][0] for i in range(n)]))


def viewgen_check(label, n, R, augmix, hard_aug, seed):
    """The VIEWS check: the generator on the card against the CPU from the
    same draws (made on the CPU) on ``n`` images of VIEWS views at ``R`` px:
    the largest difference in gray levels and the share of values beyond
    VIEWGEN_VALUE_TOL in normalised units, held to the CPU tests' tolerance."""
    from rlcf_torch.data import augment as TA
    from rlcf_torch.data.transforms import CLIP_STD

    imgs = viewgen_sources(n, seed)
    draws = TA.draw_generator_randoms(torch.Generator().manual_seed(seed), n, VIEWS, hard_aug=hard_aug)
    kw = dict(resolution=R, augmix=augmix, hard_aug=hard_aug)
    t0 = time.perf_counter()
    cpu = TA.views_from_draws(imgs, draws, **kw)
    cpu_s = time.perf_counter() - t0
    card = TA.views_from_draws(imgs.cuda(), {k: v.cuda() for k, v in draws.items()}, **kw).cpu()
    diff = (card - cpu).abs()
    gray = float((diff * torch.as_tensor(CLIP_STD) * 255.0).max())
    share = float((diff > VIEWGEN_VALUE_TOL).double().mean())
    out = {"label": label, "images": n, "views": VIEWS, "resolution": R, "augmix": augmix, "hard_aug": hard_aug,
           "max_gray_diff": gray, "share_beyond_tol": share, "values": diff.numel(), "cpu_s": cpu_s}
    log(f"VIEWS_CHECK {label}: card vs CPU on the same draws, max {gray:.4g} gray, {share:.3g} of {diff.numel()} "
        f"values beyond {VIEWGEN_VALUE_TOL} (limits {VIEWGEN_MAX_SHARE}, {VIEWGEN_MAX_GRAY} gray); CPU {cpu_s:.1f} s")
    if tuple(card.shape) != (n, VIEWS, R, R, 3) or not bool(torch.isfinite(card).all()) \
            or share > VIEWGEN_MAX_SHARE or gray > VIEWGEN_MAX_GRAY:
        raise AssertionError(f"the device view generator on the card disagrees with the CPU: {out}")
    return out


def viewgen_timing(n, R):
    """The generator's ms per group of ``n`` images (CUDA events, each call
    with its host syncs), its peak memory above what was allocated, its
    kernels a group, against the AugMix kernel's ms on the same group
    (``fused_views``: sampling and the kernel)."""
    from rlcf_torch.data.augment import make_view_generator
    from rlcf_torch.ops.augmix import fused_views
    from torch.profiler import ProfilerActivity, profile

    imgs = viewgen_sources(n, 0).cuda()
    gen = make_view_generator(VIEWS, R)
    run = lambda: gen(imgs, torch.Generator(device="cuda").manual_seed(0))
    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    ms = time_ms(run, reps=3, warmup=1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = len(device_events(prof))
    planar = imgs.permute(0, 3, 1, 2).contiguous()
    b2_ms = time_ms(lambda: fused_views(planar, torch.Generator(device="cuda").manual_seed(0), n_views=VIEWS,
                                        resolution=R, src_size=SRC_SIZE), reps=10)
    out = {"images": n, "views": VIEWS, "resolution": R, "ms_per_group": ms, "peak_mem_gib": peak,
           "kernels_per_group": kernels, "augmix_kernel_ms_per_group": b2_ms}
    log(f"VIEWGEN_TIME group {n}x{VIEWS} at {R} px: generator {ms:.2f} ms ({kernels} kernels, peak {peak:.3f} GiB) "
        f"against the AugMix kernel's {b2_ms:.3f} ms")
    return out


def viewgen_a16(out_dir):
    """Phase 4k: the device view generator (A16). The flagship through the
    CLI with --viewgen device (2 groups), with --hard_aug 1 (1 group), and
    with --viewgen auto --hard_aug 1 (which must pick device), counters set
    to 0 just before each and read just after: each launches both attention
    kernels and no AugMix kernel (``run_flagship``). Then the VIEWS check at
    a flagship group (augmix on, off, hard_aug) and at one image at 336 px,
    and the generator timed against the AugMix kernel. Returns (paths, the
    VIEWGEN line's numbers)."""
    paths = [run_flagship(out_dir, "device", VIEWGEN_DEVICE_IMAGES, path="device"),
             run_flagship(out_dir, "device", VIEWGEN_HARD_IMAGES, extra=("--hard_aug", "1"), path="device hard_aug")]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        paths.append(run_flagship(out_dir, "auto", VIEWGEN_HARD_IMAGES, extra=("--hard_aug", "1"),
                                  path="auto hard_aug"))
    sys.stdout.write(printed.getvalue())
    if "viewgen: auto -> device" not in printed.getvalue():
        raise AssertionError("--viewgen auto --hard_aug 1 did not pick the device generator")
    for flag in paths:
        log("VIEWGEN_PATH " + json.dumps(flag))
    phase_done("4k views paths")
    checks = [viewgen_check("flagship augmix on", GROUP, RES, True, False, 1),
              viewgen_check("flagship augmix off", GROUP, RES, False, False, 2),
              viewgen_check("flagship hard_aug", GROUP, RES, True, True, 3),
              viewgen_check("336 px", 1, RES336, True, False, 4)]
    timing = [viewgen_timing(GROUP, RES), viewgen_timing(1, RES336)]
    line = {"img_per_s": {f["path"]: f["img_per_s"] for f in paths},
            "group_seconds": {f["path"]: f["group_seconds"] for f in paths},
            "peak_mem_gib": {f["path"]: f["peak_mem_gib"] for f in paths},
            "launches": {f["path"]: f["launches"] for f in paths}, "checks": checks, "timing": timing}
    return paths, line


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 3 (kernel checks) with exit code 3 and no device line")
    parser.add_argument("--serving-only", action="store_true",
                        help="run phases 1-2, then only the serving phase (4i), and exit with code 3 and no device line")
    parser.add_argument("--parallel-only", action="store_true",
                        help="run phases 1-2, the AugMix checks, then only the parallelism phase (4j), and exit with "
                        "code 3 and no device line")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    start = _phase_mark[0] = time.perf_counter()
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
                  pool.submit(X.build, force=True), pool.submit(host_pipeline_error)]
        results = [b.result() for b in builds]
    for name in ("rlcf_attention_mma", "rlcf_attention_bwd_mma", "rlcf_attention_tf32", "rlcf_attention_bwd_tf32",
                 "rlcf_augmix"):
        for line in cuda_build.PTXAS[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"PTXAS {name}: " + line.strip()[:200])
            elif "Performance" in line:   # the whole line: it names the function at its end
                log(f"PTXAS {name}: " + line.strip())
    if results[-1]:
        raise RuntimeError(f"the host view pipeline (native/rlcf_host.cpp) did not build: {results[-1]}")
    log(f"BUILD host pipeline with the JPEG/PNG decoder: {native.decode_available()} "
        f"({native._load()[1] or 'the codec build'})")
    log(f"BUILD nvcc x5 and g++ in parallel: {time.perf_counter() - t0:.1f} s")
    phase_done("1-2 device, build")

    if args.serving_only:
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_flagship")
        log("SERVING " + json.dumps(serving_and_infrastructure(out)[1]))
        return 3
    if args.parallel_only:
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_flagship")
        par = parallelism(out, check_augmix())[1]
        log("PARALLEL " + json.dumps(par))
        check_rank_launches(par["runs"])
        log("PHASES " + json.dumps(PHASE_SECONDS))
        return 3
    # phase 3: the main path's shapes (group 4: 256 policy views, 24 selected
    # reward views, 4 x 200 text prompts), plus the backward at the vision
    # towers' lengths (T=257, and T=197 as training the policy tower would run it)
    t_text = text_seq_len(get_classnames("A"))
    # Stanford Cars' prompts (T = 24: the long kernels over 64-row tiles) for 4 images and at setup (the policy's
    # text tower, H=8, and the reward's, H=12); Bongard-HOI's group of 4 tasks (14 images each; two prompts
    # "X X X X X." each, T = 8)
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
              ("fwd", 200, t_text, 16, True, "RN50x64 text-setup (zero-shot, ensemble reward)"),
              ("fwd", 200, t_text, 12, True, "ViT-L/14 and 336 px text-setup (rewards, zero-shot)"),
              # encoder TTA of ViT-L/14@336px: 64 views selected from, 6 through the steps, view 0 predicted; the
              # xlong backward at its steps' shape and at the ensemble's batch
              ("fwd", VIEWS, 577, 16, False, "encoder 336 select"), ("fwd", n_sel, 577, 16, False, "encoder 336 step"),
              ("fwd", 1, 577, 16, False, "encoder 336 final"), ("bwd", n_sel, 577, 16, False, "encoder 336 step"),
              ("bwd", GROUP * n_sel, 577, 16, False, "T577"),
              ("fwd", GROUP * n_cars, t_cars, 8, True, "cars text"), ("bwd", GROUP * n_cars, t_cars, 8, True,
                                                                         "cars text"),
              ("fwd", n_cars, t_cars, 8, True, "cars text-setup"), ("fwd", n_cars, t_cars, 12, True,
                                                                      "cars reward text-setup"),
              ("fwd", 14 * GROUP, 197, 12, False, "bongard vision"),
              ("fwd", 2 * GROUP, t_bongard, 8, True, "bongard text"),
              ("bwd", 2 * GROUP, t_bongard, 8, True, "bongard text")]
    # retrieval: the episodes' towers at a group of 8 queries (i2t: the policy's ViT both ways, the reward's ViT
    # on the queries; t2i: the policy's text at T = 77 both ways, the reward's text), the COCO-size galleries as
    # the CLI batches them (the captions at their truncated T, with the ragged last batches), the CLI trees'
    # galleries (each in one batch)
    t_coco = text_tokens_len(coco_captions())
    n_coco = COCO_IMAGES * COCO_CAPTIONS_PER_IMAGE
    shapes += [("fwd", RET_GROUP, 197, 12, False, "retrieval i2t policy, image gallery tail"),
               ("bwd", RET_GROUP, 197, 12, False, "retrieval i2t policy"),
               ("fwd", RET_GROUP, 257, 16, False, "retrieval i2t reward, image gallery tail"),
               ("fwd", RET_GROUP, 77, 8, True, "retrieval t2i policy"), ("bwd", RET_GROUP, 77, 8, True,
                                                                           "retrieval t2i policy"),
               ("fwd", RET_GROUP, 77, 12, True, "retrieval t2i reward"),
               ("fwd", RET_TEXT_BATCH, t_coco, 8, True, "retrieval policy text gallery"),
               ("fwd", n_coco % RET_TEXT_BATCH, t_coco, 8, True, "retrieval policy text gallery tail"),
               ("fwd", RET_REWARD_TEXT_BATCH, t_coco, 12, True, "retrieval reward text gallery"),
               ("fwd", n_coco % RET_REWARD_TEXT_BATCH, t_coco, 12, True, "retrieval reward text gallery tail"),
               ("fwd", RET_IMAGE_BATCH, 197, 12, False, "retrieval policy image gallery"),
               ("fwd", RET_IMAGE_BATCH, 257, 16, False, "retrieval reward image gallery")]
    for n_img, n_caps in (RET_TREE, RET_FP32_TREE):
        t_tree = text_tokens_len(retrieval_tree_captions(n_img, n_caps))
        shapes += [("fwd", n_img * n_caps, t_tree, 8, True, "retrieval CLI policy text gallery"),
                   ("fwd", n_img * n_caps, t_tree, 12, True, "retrieval CLI reward text gallery"),
                   ("fwd", n_img, 197, 12, False, "retrieval CLI policy image gallery"),
                   ("fwd", n_img, 257, 16, False, "retrieval CLI reward image gallery")]
    # captioning: the feature CLIP on a group (and on the fp32 runs' group), the reward's image tower once a group
    # and its text on the group's sample_k captions every step (T = 77, causal), clipscore_eval's ViT-B/32 (image
    # batches at T = 50, the candidates and the references at T = 77)
    for n in (CAP_GROUP, CAP_FP32_IMAGES):
        shapes += [("fwd", n, 197, 12, False, "caption feature"), ("fwd", n, 257, 16, False, "caption reward image"),
                   ("fwd", n * CAP_SAMPLE_K, 77, 12, True, "caption reward text")]
    shapes += [("fwd", CLIPSCORE_IMAGE_BATCH, 50, 12, False, "clipscore image"),
               ("fwd", CAP_IMAGES, 77, 8, True, "clipscore candidates"),
               ("fwd", CAP_IMAGES * CAP_REFS, 77, 8, True, "clipscore references")]
    # caption training's extraction: the ViT-B/16 images in batches of 32 and their tail, the captions' text (T = 77,
    # causal) in batches of 256 and their tail; the sharded run's chunks of TRAIN_SHARD captions (TRAIN_SHARD /
    # TRAIN_CAPS images each) and their tail
    n_train = TRAIN_IMAGES * TRAIN_CAPS
    for B in (32, TRAIN_IMAGES % 32, TRAIN_SHARD // TRAIN_CAPS, (n_train % TRAIN_SHARD) // TRAIN_CAPS):
        shapes.append(("fwd", B, 197, 12, False, "extract image"))
    for B in (256, n_train % 256, TRAIN_SHARD, n_train % TRAIN_SHARD):
        shapes.append(("fwd", B, 77, 8, True, "extract text"))
    entries, seen_shapes = [], set()
    for dtype in (torch.bfloat16, torch.float32):
        for direction, B, T, H, masked, what in shapes:
            if (direction, B, T, H, masked, dtype) in seen_shapes:   # a shape two paths share is checked once
                continue
            seen_shapes.add((direction, B, T, H, masked, dtype))
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            entries.append(check_kernel(direction, B, T, H, dtype, masked, f"{what} B={B} T={T} H={H} {tag}"))
    for dtype in (torch.bfloat16, torch.float32):
        check_sweep("fwd", dtype)
        check_sweep("bwd", dtype)
    flash_entries = check_flash_switch()
    entries += check_augmix()
    phase_done("3 kernel checks")
    if args.kernels_only:
        return 3

    # phase 4: each path with its counters set to 0 just before and read just after
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_flagship")
    paths = [run_flagship(out_dir, "fused", FLAGSHIP_IMAGES), run_flagship(out_dir, "native", NATIVE_IMAGES),
             run_flagship(out_dir, "fused", FP32_IMAGES, precision="fp32")]
    for flag in paths:
        log("FLAGSHIP " + json.dumps(flag))
    phase_done("4 flagship paths")
    ep = episode_timing_and_reference(out_dir)
    log("EPISODE " + json.dumps(ep))
    phase_done("4 flagship episode, REFERENCE")
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
    phase_done("4b encoder")
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
    phase_done("4c encoder 336")
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
    phase_done("4d encoder RN50")
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
    phase_done("4e ensemble, zero-shot")
    paths += classification_rest(out_dir)
    phase_done("4f cars, CoCoOp, Bongard")
    ret_paths, ret = retrieval(out_dir)
    paths += ret_paths
    log("RETRIEVAL " + json.dumps(ret))
    phase_done("4g retrieval")
    cap_paths, cap = captioning(out_dir)
    paths += cap_paths
    log("CAPTION " + json.dumps(cap))
    phase_done("4h clipscore")
    train_paths, train = caption_training(out_dir)
    paths += train_paths
    log("TRAIN_CAPTION " + json.dumps(train))
    phase_done("4h caption training")
    serve_paths, serve = serving_and_infrastructure(out_dir)
    paths += serve_paths
    log("SERVING " + json.dumps(serve))
    phase_done("4i flops")
    par_paths, par = parallelism(out_dir, entries)
    paths += par_paths
    log("PARALLEL " + json.dumps(par))
    phase_done("4j parallelism")
    views_paths, views = viewgen_a16(out_dir)
    paths += views_paths
    log("VIEWGEN " + json.dumps(views))
    phase_done("4k views (A16)")

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
    # retrieval: the long backward at T = 77 (t2i, causal) and at B=8 T=197 (i2t) on their CLI paths, bf16 and fp32;
    # the reward's class features through the fused forward on the flagship path
    for direction, path, key in (("t2i", "retrieval t2i", (RET_GROUP, 77, 8)),
                                 ("i2t", "retrieval i2t", (RET_GROUP, 197, 12))):
        for dtype, variant, suffix in ((torch.bfloat16, "mma_long", ""), (torch.float32, "tf32x3_long", " fp32")):
            k = " ".join(map(str, ("bwd", *key, str(dtype))))
            if checked[k]["variant"] != variant or not launched.get(k, {}).get(path + suffix):
                raise AssertionError(f"the {direction} backward {k} did not run {variant} on the path {path + suffix}")
    k = " ".join(map(str, ("fwd", 200, t_text, 12, str(torch.bfloat16))))
    if not launched.get(k, {}).get("fused"):
        raise AssertionError(f"the reward's class features ({k}) did not take the fused forward on the flagship path")
    # captioning: the reward's text on mma_long at B = 96, T = 77 every step; the fp32 paths and clipscore_eval on
    # the fused forward's tf32x3_long
    k = " ".join(map(str, ("fwd", CAP_GROUP * CAP_SAMPLE_K, 77, 12, str(torch.bfloat16))))
    if checked[k]["variant"] != "mma_long" or not launched.get(k, {}).get("caption"):
        raise AssertionError(f"the caption reward's text ({k}) did not run mma_long on the path caption")
    for path in ("caption fp32", "caption reference fp32", "clipscore"):
        if not any(by_path.get(path) and checked[key]["variant"] == "tf32x3_long" for key, by_path in launched.items()):
            raise AssertionError(f"the path {path} launched no tf32x3_long forward")
    # caption training's extraction: the image tower at T = 197 and the captions' text at T = 77 on mma_long
    for what, key in (("image", ("fwd", 32, 197, 12)), ("text", ("fwd", 256, 77, 8))):
        k = " ".join(map(str, (*key, str(torch.bfloat16))))
        if checked[k]["variant"] != "mma_long" or not launched.get(k, {}).get("extract"):
            raise AssertionError(f"the extraction's {what} tower ({k}) did not run mma_long on the path extract")
    # serving: the exported program, served in a fresh process, launched the forward and the backward kernels
    for precision in SERVE_PRECISIONS:
        for direction in ("fwd", "bwd"):
            if not any(key.startswith(direction) and by_path.get(f"serve {precision}") for key, by_path in launched.items()):
                raise AssertionError(f"the served {precision} program launched no {direction} kernel")
    check_rank_launches(par["runs"])
    # the ATTN_IMPL="flash" route: no tower of the main path has a sequence
    # length that is a multiple of 128, so its launches there are 0
    for e in flash_entries:
        key = " ".join(map(str, e.pop("shape")))
        line.append(dict(e, launches=sum(launched.get(key, {}).values()), launches_by_path=launched.get(key, {})))
    phase_done("5 kernels line")
    log("PHASES " + json.dumps(PHASE_SECONDS))
    log(f"TOTAL chip_smoke.py ran {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

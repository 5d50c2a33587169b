"""A cell at a size a test run holds on the CPU: tiny towers (full CLIP
vocabulary, one 64-wide head), 8 views of 32 px, 10 classes, groups of 2,
float32, and limits far below what a fault reads."""

import copy
import json
import os
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
TRAFFIC = os.path.join(os.path.dirname(HERE), "traffic", "prompt-g4.json")


def tower(arch, embed, res, layers, width, patch, confidence=1):
    t = {"arch": arch, "embed_dim": embed, "image_resolution": res, "vision_layers": layers, "vision_width": width,
         "text_width": 64, "text_layers": 2, "context_length": 77, "vocab_size": 49408, "logit_scale": 100.0,
         "confidence": confidence, "feature_offset": [0.5 * embed ** 0.5, 0.5 * embed ** 0.5]}
    if patch:
        t["vision_patch_size"] = patch
    return t


def config(ensemble: bool = False, precision: str = "fp32"):
    """A tiny configuration: a ViT policy and a ViT reward at the views'
    resolution, or an ensemble of a ViT at another resolution, a ResNet and a
    ViT (confidences 1: the program weighs members it does not know alike)."""
    rewards = ([tower("tiny-a", 32, 48, 2, 64, 8), tower("tiny-rn", 32, 64, [1, 1, 1, 1], 16, None),
                tower("tiny-c", 32, 32, 2, 64, 4)] if ensemble else [tower("tiny-r", 32, 32, 2, 64, 4)])
    argv = ["--arch", "tiny-pol"] + (["--multiple_reward_models", "1"] if ensemble else ["--reward_arch", "tiny-r"])
    return {"precision": precision, "argv": argv, "policy": tower("tiny-pol", 32, 32, 2, 64, 8), "rewards": rewards}


def traffic():
    with open(TRAFFIC) as fh:
        t = json.load(fh)
    t = copy.deepcopy(t)
    t.update(classes=t["classes"][:10], group=2, source_size=48, pool=4, warmup_groups=1, trace_groups=2,
             check_groups=2)
    t["episode"].update(n_views=8, resolution=32, selection_p=0.25)
    t["argv"] += ["--batch_size", "8", "--resolution", "32", "--selection_p", "0.25", "--episode_group", "2"]
    return t


LIMITS = {"views": 0, "text_gap": 1e-4, "feature_gap": 1e-4, "select_gap": 1e-4, "reward_gap": 1e-4, "topk_gap": 1e-3,
          "grad_dev": 1e-3, "step_gap": 1e-3, "answer_gap": 1e-3}


def run(ensemble=False, seed=2**33 + 5, seconds=0.5, trace=0, metrics=None, limits=LIMITS, device="cpu"):
    """One run of the tiny cell through the driver, the look for a card
    skipped (on the CPU unless ``device``): (result, checks)."""
    import importlib

    from bench_h100.drivers import prompt_tta

    metrics = metrics or ([{"name": "items_per_s", "unit": "items/s"}, {"name": "item_ms_p90", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}])
    readers = {m["name"]: importlib.import_module(f"bench_h100.metrics.{m['name']}").read for m in metrics} \
        if trace else {}
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return prompt_tta.run({"args": args, "config": config(ensemble), "traffic": traffic(), "limits": limits,
                           "metrics": metrics, "readers": readers, "t_start": time.perf_counter()}, device=device)

"""Shared CLI plumbing: the flag surface of ``rlcf_tpu/cli/common.py`` plus
``--device``, and model/reward construction on that device.

Without checkpoints, models get random weights from ``--seed`` (with a loud
warning), which still drives the full pipeline at full width.
"""

from __future__ import annotations

import argparse
import json
import sys


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--arch", "-a", default="ViT-B/16", help="policy CLIP architecture")
    p.add_argument("--clip_checkpoint", default=None, help="OpenAI CLIP .pt for the policy")
    p.add_argument("--resolution", default=224, type=int)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the models run; 'cuda' fails when there is no card")
    p.add_argument("--verify_checkpoint", type=int, default=1,
                   help="check --clip_checkpoint's SHA256 against the stock OpenAI releases first: the stock file "
                   "of another arch is refused, an unknown digest loads with a note; 0 skips the check. Unlike "
                   "the JAX package, which initializes randomly when the file does not exist, a missing file raises")
    p.add_argument("--download", type=int, default=0, help="not ported yet (refused when 1)")


def add_reward_args(p: argparse.ArgumentParser):
    p.add_argument("--reward_arch", default="ViT-L/14")
    p.add_argument("--reward_checkpoint", default=None)
    p.add_argument("--multiple_reward_models", type=int, default=0,
                   help="the reference's 3-CLIP reward ensemble: ViT-L/14@336px, RN50x64, ViT-L/14")
    p.add_argument("--reward_checkpoints", nargs="*", default=None, help="ckpts for the ensemble archs")
    p.add_argument("--sample_k", type=int, default=5)
    p.add_argument("--reward_process", type=int, default=1)
    p.add_argument("--process_batch", type=int, default=0)
    p.add_argument("--reward_amplify", type=int, default=0)
    p.add_argument("--weighted_scores", type=int, default=1)


def add_tta_args(p: argparse.ArgumentParser):
    p.add_argument("--tta_steps", type=int, default=1)
    p.add_argument("--selection_p", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=64, help="views per sample (1 base + N-1 augmented)")
    p.add_argument("--n_ctx", type=int, default=4)
    p.add_argument("--ctx_init", default=None, type=str)
    p.add_argument("--load", default=None, type=str, help="pretrained CoOp prompt checkpoint")
    p.add_argument("--augmix", type=int, default=1)
    p.add_argument("--hard_aug", type=int, default=0)
    p.add_argument("--min_entropy_reg", type=int, default=0)
    p.add_argument("--min_entropy_w", type=float, default=0.1)
    # encoder-TTA flags (tune_cls), accepted by tta_cls too so that scripts carry over
    p.add_argument("--momentum_update", type=int, default=0)
    p.add_argument("--update_freq", type=int, default=256)
    p.add_argument("--update_w", type=float, default=1.0)
    p.add_argument("--tta_momentum", type=float, default=0.9999)
    p.add_argument("--tune_norm", type=int, default=0)
    p.add_argument("--prior_strength", type=float, default=-1)
    p.add_argument("--kd_loss", default="KD", choices=["KD", "DKD", "ATKD"])
    p.add_argument("--episode_group", type=int, default=4, help="episodes run together per device batch")


def add_run_args(p: argparse.ArgumentParser):
    p.add_argument("data", metavar="DIR", nargs="?", default=".", help="dataset root")
    p.add_argument("--test_sets", default="A", help="slash-separated dataset ids; 'synthetic' works without data")
    p.add_argument("--synthetic_classes", default="10",
                   help="classes of the 'synthetic' set: a count (names class_0, class_1, ...) or a dataset id "
                   "whose class names it takes (e.g. A: ImageNet-A's 200)")
    p.add_argument("--dataset_mode", default="test")
    p.add_argument("--output", default="exp_01")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=None, help="cap on evaluated samples")
    p.add_argument("--corruption", default="defocus_blur")
    p.add_argument("--level", default="5")
    p.add_argument("--print_freq", "-p", type=int, default=500)
    p.add_argument("--decode", default="pil", choices=["pil", "native"],
                   help="image loader; only 'pil' is ported yet")
    p.add_argument("--decode_workers", type=int, default=0)
    p.add_argument("--dry_run", action="store_true",
                   help="validate the command line and exit before loading models or data")


def finish_dry_run(args) -> bool:
    if not getattr(args, "dry_run", False):
        return False
    print("DRY RUN OK: " + json.dumps({k: v for k, v in sorted(vars(args).items())}, default=str))
    return True


def check_policy_digest(args):
    """The JAX package's integrity gate (`rlcf_tpu/cli/common.py:132-149`):
    a ``--clip_checkpoint`` that is the stock release of another arch raises,
    an unknown digest (a fine-tuned or converted file) is noted and loads."""
    from ..models.convert import CLIP_CHECKPOINT_SHA256, check_checkpoint_digest

    if not getattr(args, "verify_checkpoint", 1) or args.arch not in CLIP_CHECKPOINT_SHA256:
        return
    status, detail = check_checkpoint_digest(args.clip_checkpoint, args.arch)
    if status == "wrong-arch":
        raise RuntimeError(f"{args.clip_checkpoint} is the stock OpenAI {detail} checkpoint, "
                           f"not {args.arch}; pass the right file or --verify_checkpoint 0")
    if status == "unknown":
        print(f"NOTE: {args.clip_checkpoint} is not a stock OpenAI release (sha256 {detail[:12]}…); "
              f"loading as a fine-tuned/converted {args.arch}", file=sys.stderr)


def load_policy(args, device):
    from ..models import clip as clip_model
    from ..models.convert import load_clip_checkpoint
    from ..utils.runtime import torch_dtype

    dtype = torch_dtype(args.precision)
    if args.clip_checkpoint:
        check_policy_digest(args)
        return load_clip_checkpoint(args.clip_checkpoint, dtype=dtype, device=device)
    print(f"WARNING: no --clip_checkpoint; initializing {args.arch} randomly "
          "(throughput-realistic, accuracy-meaningless)", file=sys.stderr)
    cfg = clip_model.get_config(args.arch)
    return clip_model.init_clip_params(cfg, seed=args.seed, dtype=dtype, device=device), cfg


# the members of --multiple_reward_models, in the JAX package's order (`rlcf_tpu/cli/common.py:177`)
ENSEMBLE_ARCHS = ["ViT-L/14@336px", "RN50x64", "ViT-L/14"]


def build_reward(args, device):
    """The reward: one CLIP (random weights from ``--seed`` + 1 without a
    checkpoint), or with ``--multiple_reward_models`` the ensemble of
    ``ENSEMBLE_ARCHS``, member i from ``--reward_checkpoints`` or seed
    ``--seed`` + i + 1, confidence-weighted unless ``--weighted_scores 0``."""
    from ..core.reward import ClipRewardEnsemble, RewardConfig, build_reward_model
    from ..utils.runtime import torch_dtype

    rcfg = RewardConfig(
        sample_k=args.sample_k,
        reward_process=bool(args.reward_process),
        process_batch=bool(args.process_batch),
        amplify=bool(args.reward_amplify),
        default_resolution=args.resolution,
    )
    dtype = torch_dtype(args.precision)
    if args.multiple_reward_models:
        ckpts = args.reward_checkpoints or [None] * len(ENSEMBLE_ARCHS)
        if len(ckpts) != len(ENSEMBLE_ARCHS):
            raise SystemExit(f"--reward_checkpoints takes one checkpoint per ensemble member ({ENSEMBLE_ARCHS})")
        if not all(ckpts):
            print("WARNING: initializing the ensemble members without a checkpoint randomly", file=sys.stderr)
        members = [build_reward_model(a, rcfg, checkpoint=c, rng_seed=args.seed + i + 1, dtype=dtype, device=device)
                   for i, (a, c) in enumerate(zip(ENSEMBLE_ARCHS, ckpts))]
        return ClipRewardEnsemble(members, rcfg, weighted=bool(args.weighted_scores))
    if not args.reward_checkpoint:
        print(f"WARNING: no --reward_checkpoint; initializing {args.reward_arch} randomly", file=sys.stderr)
    return build_reward_model(args.reward_arch, rcfg, checkpoint=args.reward_checkpoint, rng_seed=args.seed + 1,
                              dtype=dtype, device=device)

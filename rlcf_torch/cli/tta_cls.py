"""RLCF / TPT / KD prompt test-time adaptation for classification, on the card.

The port of ``rlcf_tpu/cli/tta_cls.py``: per group of ``--episode_group``
test images, ``--batch_size`` views each are built either on the device by
the CUDA AugMix kernel (``--viewgen fused``, the default on the card in token
mode) or on the host by the C++ pipeline (``--viewgen native``), and the
classifier runs one batched episode group on the device. Token mode (a ViT
policy whose patch size tiles ``--resolution`` and a single reward) ships
patch-major u8 tokens; otherwise (``--cocoop``, a ResNet policy, or the
reward ensemble of ``--multiple_reward_models``) the host builds NHWC u8
views for the classifier's ``adapt``, as the JAX package does. ``bongard``
in ``--test_sets`` runs Bongard-HOI's few-shot tasks (``tasks/bongard.py``);
the ten fine-grained sets (``flower102``, ..., ``cars``, ``aircraft``) read
their Zhou-split and FGVC-Aircraft trees under DIR.

Example (random weights, no data):
  python -m rlcf_torch.cli.tta_cls --test_sets synthetic --limit 8 \\
      --arch ViT-B/16 --reward_arch ViT-L/14 --tta_steps 3 --lr 7e-3 \\
      --sample_k 3 --ctx_init a_photo_of_a --loss rlcf --viewgen fused
Add ``--device cpu`` to run on the CPU; ``--multiple_reward_models 1`` for
the 3-CLIP reward (``--viewgen native``); ``--cocoop --loss tpt`` for CoCoOp;
``DIR --test_sets bongard --learned_cls 1`` for Bongard-HOI.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import common


def get_args(argv=None):
    p = argparse.ArgumentParser(description="RLCF prompt TTA (PyTorch, CUDA)")
    common.add_run_args(p)
    common.add_model_args(p)
    common.add_reward_args(p)
    common.add_tta_args(p)
    p.add_argument("--loss", default="rlcf", choices=["rlcf", "tpt", "kd", "dkd", "atkd"])
    p.add_argument("--tpt", action="store_true", help="compat flag: TPT entropy loss")
    p.add_argument("--cocoop", action="store_true", help="CoCoOp image-conditioned prompts (entropy TTA)")
    p.add_argument("--resume", action="store_true", help="not ported yet (refused)")
    p.add_argument(
        "--bongard_split", default="unseen_obj_unseen_act",
        help="Bongard-HOI split name (used when 'bongard' is in --test_sets)",
    )
    p.add_argument(
        "--learned_cls", type=int, default=1,
        help="Bongard mode: 1 = learnable class token with ['X','X'] names "
        "(`custom_clip.py:350-355`), 0 = fixed ['True','False'] prompts",
    )
    p.add_argument("--tp", type=int, default=1, help="class-axis tensor parallelism; not ported yet (refused when > 1)")
    p.add_argument(
        "--viewgen", default="auto", choices=["auto", "fused", "device", "native"],
        help="view generator: 'fused' = the CUDA AugMix kernel builds every view on the device "
        "(its plain version on the CPU; token mode only); 'native' = the repo's C++ host pipeline, emitting "
        "patch-major u8 tokens in token mode and NHWC u8 views otherwise; 'auto' = fused on cuda in token mode "
        "(a ViT policy whose patch size tiles --resolution, a single reward), else native. 'device' is not "
        "ported yet",
    )
    return p.parse_args(argv)


# what the port runs outside token mode, and what it does not run yet
NON_TOKEN_RUNS = ("outside token mode (CoCoOp, a ResNet policy, a patch size that does not tile --resolution, or the "
                  "reward ensemble of --multiple_reward_models) the port runs --viewgen native, NHWC views through "
                  "the classifier's adapt, as the JAX package does; --viewgen device comes with the torch AugMix "
                  "pipeline (ROADMAP A16)")


def refuse_unported(args):
    """Exit with a message for options this slice of the port does not run."""
    waits = {
        "--viewgen device": (args.viewgen == "device", "the torch AugMix pipeline (ROADMAP A16); the port "
                             "runs --viewgen fused and --viewgen native"),
        "--tp > 1": (args.tp > 1, "class-axis tensor parallelism (ROADMAP A14)"),
        "--hard_aug": (bool(args.hard_aug), "the BYOL hard augmentation (ROADMAP A16)"),
        "--resume": (args.resume, "the progress journal (ROADMAP A15)"),
        "--download": (bool(args.download), "checkpoint download (ROADMAP A15)"),
        "--decode native": (args.decode == "native", "the native decoder binding (ROADMAP A15)"),
    }
    for flag, (used, item) in waits.items():
        if used:
            raise SystemExit(f"rlcf_torch: {flag} is not ported yet; it comes with {item}")


def build(args):
    """(classifier, policy config, device) for parsed args: with --cocoop a
    CoCoOp classifier under the TPT loss (it takes no reward), else prompt
    TTA with the reward of --reward_arch or the ensemble."""
    import dataclasses

    from ..core.episode import EpisodeConfig
    from ..core.prompt import load_coop_ctx
    from ..models.convert import load_torch_file
    from ..tasks.classification import CoCoOpTTAClassifier, PromptTTAClassifier, convert_cocoop_checkpoint
    from ..utils.runtime import resolve_device

    device = resolve_device(args.device)
    params, cfg = common.load_policy(args, device)
    loss = {"KD": "kd", "DKD": "dkd", "ATKD": "atkd"}[args.kd_loss] if args.loss == "kd" else args.loss
    ecfg = EpisodeConfig(
        tta_steps=args.tta_steps, selection_p=args.selection_p, lr=args.lr, weight_decay=args.weight_decay,
        loss=loss, sample_k=args.sample_k, min_entropy_reg=bool(args.min_entropy_reg),
        min_entropy_w=args.min_entropy_w,
    )
    if args.cocoop:
        ctx0, meta_net = convert_cocoop_checkpoint(load_torch_file(args.load)) if args.load else (None, None)
        clf = CoCoOpTTAClassifier(params, cfg, dataclasses.replace(ecfg, loss="tpt"),
                                  ctx_init=args.ctx_init or "a photo of a", n_ctx=args.n_ctx, ctx0=ctx0,
                                  meta_net=meta_net)
        return clf, cfg, device
    reward = common.build_reward(args, device)
    ctx0 = load_coop_ctx(args.load).to(device) if args.load else None
    clf = PromptTTAClassifier(params, cfg, reward, ecfg, ctx_init=args.ctx_init or "a photo of a",
                              n_ctx=args.n_ctx, ctx0=ctx0)
    return clf, cfg, device


def main(argv=None):
    args = get_args(argv)
    if args.tpt and args.loss == "rlcf":
        args.loss = "tpt"
    if args.viewgen == "fused" and args.hard_aug:
        raise SystemExit("--viewgen fused does not implement --hard_aug (BYOL); the port runs --viewgen fused "
                         "or --viewgen native without it, and --hard_aug comes with ROADMAP A16")
    if args.viewgen == "fused" and (args.multiple_reward_models or args.cocoop):   # before the towers are built
        raise SystemExit(f"--viewgen fused needs a ViT policy in token mode; {NON_TOKEN_RUNS}")
    refuse_unported(args)
    if common.finish_dry_run(args):
        return None

    import torch

    from ..data import native
    from ..data.class_names import get_classnames
    from ..data.datasets import PrefetchIterator, build_dataset, iter_canonical
    from ..metrics.classification import AccuracyMeter, topk_correct
    from ..ops.augmix import fused_views
    from ..utils.config import save_hparams
    from ..utils.logging_utils import RunLogger

    clf, cfg, device = build(args)
    # token mode: prompt TTA (not CoCoOp) with a ViT policy whose patch size
    # tiles the views and a single reward, as the JAX CLI's token_ok
    token_ok = (not args.cocoop and cfg.is_vit and args.resolution % cfg.vision_patch_size == 0
                and not args.multiple_reward_models)
    if args.viewgen == "auto":
        args.viewgen = "fused" if device.type == "cuda" and token_ok else "native"
        print(f"viewgen: auto -> {args.viewgen}")
    if args.viewgen == "fused" and not token_ok:
        raise SystemExit(f"--viewgen fused needs a ViT policy in token mode; {NON_TOKEN_RUNS}")
    if args.viewgen == "native" and not native.available():
        raise SystemExit("--viewgen native: no C++ toolchain available to build the host pipeline")
    logger = RunLogger(args.output)
    save_hparams(args.output, vars(args))
    # the fused kernel also patchifies for a ViT reward at the view resolution
    rcfg = clf.reward.cfg if token_ok else None
    p_reward = rcfg.vision_patch_size if token_ok and rcfg.is_vit and rcfg.image_resolution == args.resolution else 0

    results = {}
    for set_id in args.test_sets.split("/"):
        if set_id == "bongard":   # few-shot tasks: support cross-entropy, then the queries (tasks/bongard.py)
            from ..tasks.bongard import run_bongard

            results[set_id] = run_bongard(args, clf.clip_params, cfg, logger)
            logger.text(logger.elapsed_line(f"dataset {set_id}"))
            continue
        if set_id != "synthetic":
            classnames = get_classnames(set_id)
        elif args.synthetic_classes.isdigit():
            classnames = ["class_%d" % i for i in range(int(args.synthetic_classes))]
        else:
            classnames = get_classnames(args.synthetic_classes)
        clf.setup(classnames)
        dataset = build_dataset(set_id, args.data, mode=args.dataset_mode, corruption=args.corruption,
                                level=args.level, n_classes=len(classnames))
        meter = AccuracyMeter()
        group_seconds = []
        group_imgs, group_labels = [], []
        counter = [0]

        def flush():
            if not group_imgs:
                return
            t0 = time.perf_counter()
            seed = args.seed * 100003 + counter[0]
            imgs = np.stack(group_imgs)  # canonical [N, 256, 256, 3] u8
            if args.viewgen == "fused":  # every view built on the device, one kernel launch
                planar = torch.from_numpy(imgs.transpose(0, 3, 1, 2)).to(device).contiguous()
                views = fused_views(planar, torch.Generator(device=device).manual_seed(seed),
                                    n_views=args.batch_size, resolution=args.resolution, src_size=256,
                                    augmix=bool(args.augmix), p_policy=cfg.vision_patch_size, p_reward=p_reward)
            elif token_ok:
                views = native.generate_views_native_patch_u8(
                    imgs, n_views=args.batch_size, p_policy=cfg.vision_patch_size,
                    resolution=args.resolution, augmix=bool(args.augmix), seed=seed,
                )
            else:  # NHWC u8 views from the same seeded stream, normalized on the device
                views = native.generate_views_native_u8(imgs, n_views=args.batch_size, resolution=args.resolution,
                                                        augmix=bool(args.augmix), seed=seed)
            counter[0] += 1
            if not token_ok:
                logits, _ = clf.adapt(views)
            else:
                logits, _ = clf.adapt_tokens(*views) if isinstance(views, tuple) else clf.adapt_tokens(views)
            logits = logits.float().cpu().numpy()  # synchronizes with the device
            group_seconds.append(time.perf_counter() - t0)
            counts = topk_correct(logits, np.asarray(group_labels))
            meter.update_counts(counts, len(group_labels))
            group_imgs.clear()
            group_labels.clear()

        for img, label in PrefetchIterator(iter_canonical(dataset, 256, seed=args.seed, limit=args.limit)):
            group_imgs.append(img)
            group_labels.append(label)
            if len(group_imgs) == args.episode_group:
                flush()
        flush()
        results[set_id] = dict(meter.summary(), n=meter.count, group_seconds=group_seconds)
        logger.text(
            logger.elapsed_line(f"dataset {set_id}"),
            f"=> Acc. on testset [{set_id}]: @1 {results[set_id]['top1']} / @5 {results[set_id]['top5']}",
        )
    logger.results_json(results)
    print("======== Result Summary ========", json.dumps({k: {m: v[m] for m in ("top1", "top5", "n", "n_queries")
                                                           if m in v} for k, v in results.items()}))
    return results


if __name__ == "__main__":
    main()

"""RLCF / TPT / KD prompt test-time adaptation for classification, on the card.

The port of ``rlcf_tpu/cli/tta_cls.py``: per group of ``--episode_group``
test images, ``--batch_size`` views each are built on the device by the CUDA
AugMix kernel (``--viewgen fused``, the default on the card in token mode),
on the device by the PyTorch view generator (``--viewgen device``:
``data/augment.py``, float views, the default otherwise and under
``--hard_aug``) or on the host by the C++ pipeline (``--viewgen native``), and
the classifier runs one batched episode group on the device. Token mode (a
ViT policy whose patch size tiles ``--resolution`` and a single reward) ships
patch-major u8 tokens from the kernel or the host; ``device`` views and the
native NHWC views go through the classifier's ``adapt``, as in the JAX
package. ``bongard`` in ``--test_sets`` runs Bongard-HOI's few-shot tasks
(``tasks/bongard.py``); the ten fine-grained sets (``flower102``, ...,
``cars``, ``aircraft``) read their Zhou-split and FGVC-Aircraft trees under
DIR. Each group's counts go to ``progress_<set>.jsonl`` in ``--output``, from
which ``--resume`` goes on; ``--decode native`` decodes the images with the
repo's C++ decoder. ``--tp N`` shards the classes over N ranks and the
episodes of a group over the rest (dp = ranks // N), one process a rank:
``torchrun --standalone --nproc_per_node 4 -m rlcf_torch.cli.tta_cls --tp 2
...``; rank 0 prints and writes the run's files.

Example (random weights, no data):
  python -m rlcf_torch.cli.tta_cls --test_sets synthetic --limit 8 \\
      --arch ViT-B/16 --reward_arch ViT-L/14 --tta_steps 3 --lr 7e-3 \\
      --sample_k 3 --ctx_init a_photo_of_a --loss rlcf --viewgen fused
Add ``--device cpu`` to run on the CPU; ``--viewgen device --hard_aug 1`` for
the BYOL views; ``--multiple_reward_models 1`` for the 3-CLIP reward;
``--cocoop --loss tpt`` for CoCoOp; ``DIR --test_sets bongard --learned_cls 1``
for Bongard-HOI.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
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
    p.add_argument("--resume", action="store_true",
                   help="continue from the progress journal (progress_<set>.jsonl) in --output: the samples it "
                   "scored are counted and passed over, and the groups' seeds go on from there")
    p.add_argument(
        "--bongard_split", default="unseen_obj_unseen_act",
        help="Bongard-HOI split name (used when 'bongard' is in --test_sets)",
    )
    p.add_argument(
        "--learned_cls", type=int, default=1,
        help="Bongard mode: 1 = learnable class token with ['X','X'] names "
        "(`custom_clip.py:350-355`), 0 = fixed ['True','False'] prompts",
    )
    p.add_argument("--tp", type=int, default=1,
                   help="class-axis tensor parallelism over the ranks of a torchrun launch (dp = ranks // tp)")
    p.add_argument(
        "--viewgen", default="auto", choices=["auto", "fused", "device", "native"],
        help="view generator: 'fused' = the CUDA AugMix kernel builds every view on the device (its plain version "
        "on the CPU; token mode only); 'device' = the PyTorch view generator on the device (data/augment.py; any "
        "policy, --hard_aug); 'native' = the repo's C++ host pipeline, emitting patch-major u8 tokens in token mode "
        "and NHWC u8 views otherwise; 'auto' = fused on cuda in token mode (a ViT policy whose patch size tiles "
        "--resolution, a single reward) without --hard_aug, else device",
    )
    return p.parse_args(argv)


def refuse_unported(args):
    """Exit with a message for options the port does not run."""
    common.refuse({"--download": (bool(args.download), common.DOWNLOAD_WAIT)})


def auto_viewgen(on_cuda: bool, token_ok: bool, hard_aug: bool) -> str:
    """``--viewgen auto``, the JAX CLI's rule with "the fused kernel is
    available" meaning "on cuda": fused in token mode without --hard_aug,
    else device."""
    return "fused" if on_cuda and token_ok and not hard_aug else "device"


def build(args, mesh=None):
    """(classifier, policy config, device) for parsed args: with --cocoop a
    CoCoOp classifier under the TPT loss (it takes no reward), else prompt
    TTA with the reward of --reward_arch or the ensemble, on ``mesh``."""
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
                              n_ctx=args.n_ctx, ctx0=ctx0, mesh=mesh)
    return clf, cfg, device


def main(argv=None):
    args = get_args(argv)
    if args.tpt and args.loss == "rlcf":
        args.loss = "tpt"
    if args.viewgen in ("fused", "native") and args.hard_aug:   # before the towers are built
        raise SystemExit(f"--viewgen {args.viewgen} does not implement --hard_aug (BYOL); use --viewgen device")
    if args.viewgen == "fused" and (args.multiple_reward_models or args.cocoop):
        raise SystemExit("--viewgen fused needs a ViT policy in token mode; use --viewgen device")
    refuse_unported(args)
    if common.finish_dry_run(args):
        return None
    mesh = common.run_mesh(args, tp=args.tp) if args.tp > 1 else None
    if mesh is not None and args.cocoop:
        raise SystemExit("--tp > 1 is not supported with --cocoop (prompt-TTA only)")
    common.check_decode(args)

    import torch

    from ..data import native
    from ..data.augment import make_view_generator
    from ..data.datasets import PrefetchIterator, build_dataset, iter_canonical
    from ..metrics.classification import AccuracyMeter, topk_correct
    from ..parallel.mesh import is_main_rank
    from ..utils.config import save_hparams
    from ..utils.logging_utils import RunLogger

    clf, cfg, device = build(args, mesh)
    # token mode: prompt TTA (not CoCoOp) with a ViT policy whose patch size
    # tiles the views and a single reward, as the JAX CLI's token_ok
    token_ok = (not args.cocoop and cfg.is_vit and args.resolution % cfg.vision_patch_size == 0
                and not args.multiple_reward_models)
    if args.viewgen == "auto":
        args.viewgen = auto_viewgen(device.type == "cuda", token_ok, bool(args.hard_aug))
        print(f"viewgen: auto -> {args.viewgen}")
    if args.viewgen == "fused" and not token_ok:
        raise SystemExit("--viewgen fused needs a ViT policy in token mode; use --viewgen device")
    if args.viewgen == "native" and not native.available():
        raise SystemExit("--viewgen native: no C++ toolchain available to build the host pipeline")
    gen = (make_view_generator(n_views=args.batch_size, resolution=args.resolution, augmix=bool(args.augmix),
                               hard_aug=bool(args.hard_aug)) if args.viewgen == "device" else None)
    main_rank = is_main_rank()   # rank 0 alone writes the run's files
    logger = RunLogger(args.output, enabled=main_rank)
    if main_rank:
        save_hparams(args.output, vars(args))
    # every view built on the device, one kernel launch (which also patchifies for a ViT reward at the view
    # resolution; on a mesh each dp rank builds its slice's views)
    sources = (clf.adapt_sources_fn(n_views=args.batch_size, src_size=256, resolution=args.resolution,
                                    augmix=bool(args.augmix)) if args.viewgen == "fused" else None)

    results = {}
    for set_id in args.test_sets.split("/"):
        if set_id == "bongard":   # few-shot tasks: support cross-entropy, then the queries (tasks/bongard.py)
            from ..tasks.bongard import run_bongard

            results[set_id] = run_bongard(args, clf.clip_params, cfg, logger)
            logger.text(logger.elapsed_line(f"dataset {set_id}"))
            continue
        classnames = common.class_names(set_id, args.synthetic_classes)
        clf.setup(classnames)
        dataset = build_dataset(set_id, args.data, mode=args.dataset_mode, corruption=args.corruption,
                                level=args.level, n_classes=len(classnames))
        meter = AccuracyMeter()
        group_seconds = []
        group_imgs, group_labels = [], []
        # a seeded sample order and a journal of each group's counts make a
        # resume a skip count, as in the JAX package
        journal_path = os.path.join(args.output, f"progress_{set_id.replace('/', '_')}.jsonl")
        skip = 0
        if args.resume and os.path.exists(journal_path):
            with open(journal_path) as fh:
                for line in fh:
                    rec = json.loads(line)
                    meter.update_counts({1: rec["c1"], 5: rec["c5"]}, rec["n"])
                    skip += rec["n"]
            print(f"resuming {set_id}: {skip} samples already scored")
        counter = [skip // max(args.episode_group, 1)]

        def flush():
            if not group_imgs:
                return
            t0 = time.perf_counter()
            seed = args.seed * 100003 + counter[0]
            imgs = np.stack(group_imgs)  # canonical [N, 256, 256, 3] u8
            counter[0] += 1
            if sources is not None:
                logits, _, _ = sources(torch.from_numpy(imgs.transpose(0, 3, 1, 2)), seed)
            elif gen is not None:   # float views on the classifier's device, from a generator seeded there
                views = gen(torch.from_numpy(imgs).to(device), torch.Generator(device=device).manual_seed(seed))
                logits, _ = clf.adapt(views)
            elif token_ok:
                views = native.generate_views_native_patch_u8(
                    imgs, n_views=args.batch_size, p_policy=cfg.vision_patch_size,
                    resolution=args.resolution, augmix=bool(args.augmix), seed=seed,
                )
                logits, _ = clf.adapt_tokens(*(views if isinstance(views, tuple) else (views,)))
            else:  # NHWC u8 views from the same seeded stream, normalized on the device
                views = native.generate_views_native_u8(imgs, n_views=args.batch_size, resolution=args.resolution,
                                                        augmix=bool(args.augmix), seed=seed)
                logits, _ = clf.adapt(views)
            logits = logits.float().cpu().numpy()  # synchronizes with the device
            group_seconds.append(time.perf_counter() - t0)
            counts = topk_correct(logits, np.asarray(group_labels))
            meter.update_counts(counts, len(group_labels))
            if journal is not None:
                journal.write(json.dumps({"n": len(group_labels), "c1": counts[1], "c5": counts[5]}) + "\n")
                journal.flush()
            group_imgs.clear()
            group_labels.clear()

        stream = iter_canonical(dataset, 256, seed=args.seed, limit=args.limit, workers=args.decode_workers,
                                decode=args.decode)
        with (open(journal_path, "a") if main_rank else contextlib.nullcontext()) as journal:
            for img, label in PrefetchIterator(itertools.islice(stream, skip, None)):
                group_imgs.append(img)
                group_labels.append(label)
                if len(group_imgs) == args.episode_group:
                    flush()
            flush()
        results[set_id] = dict(meter.summary(), n=meter.count, c1=meter.correct[1], c5=meter.correct[5],
                               group_seconds=group_seconds)
        logger.text(
            logger.elapsed_line(f"dataset {set_id}"),
            f"=> Acc. on testset [{set_id}]: @1 {results[set_id]['top1']} / @5 {results[set_id]['top5']}",
        )
    logger.results_json(results)
    print("======== Result Summary ========", json.dumps({k: {m: v[m] for m in ("top1", "top5", "n", "n_queries")
                                                           if m in v} for k, v in results.items()}))
    common.report_decode(args)
    return results


if __name__ == "__main__":
    main()

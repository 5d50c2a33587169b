"""RLCF / TPT / KD encoder test-time adaptation (the ``TPT/tune_cls_rl.py``
family), on the card: the port of ``rlcf_tpu/cli/tune_cls.py``.

Tunes the CLIP visual tower per test image (optionally only its
normalization affines), with momentum-EMA re-anchoring of the episodes'
starting point. A ViT or ResNet policy (``--prior_strength p >= 0``: a
ResNet's BN-prior statistics) and a single reward (ViT or ResNet; the views
resized where it takes another resolution).

Views: the PyTorch view generator (``data/augment.py::make_view_generator``,
the port of the JAX entry point's), float views on the classifier's device,
each group's drawn from a generator seeded ``--seed * 7 + group``, as the JAX
entry point seeds them; ``--hard_aug 1`` adds the BYOL recipe. Under
``--dp`` every rank builds the whole group's views from that seed and runs
its slice of the episodes.

Example (random weights, no data; the reference's ``scripts/rlcf-tune.sh``):
  python -m rlcf_torch.cli.tune_cls --test_sets synthetic --limit 8 \\
      --arch ViT-B/16 --reward_arch ViT-L/14 --tta_steps 3 --lr 1e-5 \\
      --batch_size 64 --selection_p 0.1 --sample_k 3 \\
      --momentum_update 1 --update_freq 256 --episode_group 1
``--arch ViT-L/14@336px --resolution 336`` tunes the 336 px tower (views
built at 336 px); ``--arch RN50 [--prior_strength 0.5]`` a ResNet policy.
Add ``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import common

def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="RLCF encoder TTA (PyTorch, CUDA); views from the device generator "
        "(data/augment.py::make_view_generator), each group's seeded --seed * 7 + group as in the JAX entry point")
    common.add_run_args(p)
    common.add_model_args(p)
    common.add_reward_args(p)
    common.add_tta_args(p)
    p.add_argument("--loss", default="rlcf", choices=["rlcf", "tpt", "kd", "dkd", "atkd"])
    p.add_argument("--ctx_prefix", default="a_photo_of_a", help="prompt prefix for class features")
    p.add_argument("--dp", type=int, default=1,
                   help="episode data parallelism over the ranks of a torchrun launch of exactly dp processes")
    p.add_argument(
        "--remat", default="full", choices=["full", "save_attn", "none"],
        help="visual-tower backward remat policy: full = recompute every layer (lowest memory), save_attn = keep "
        "each block's attention input and output for the backward, none = store all activations",
    )
    return p.parse_args(argv)


def refuse_unported(args):
    """Exit with a message for options the port does not run, and for the
    reward ensemble, which encoder TTA does not take in the JAX package
    either."""
    if args.multiple_reward_models:
        raise SystemExit("rlcf_torch: --multiple_reward_models: encoder TTA takes a single reward, as the JAX "
                         "package's EncoderTTAClassifier does; the reward ensemble serves prompt TTA "
                         "(rlcf_torch.cli.tta_cls)")
    common.refuse({"--download": (bool(args.download), common.DOWNLOAD_WAIT)})


def build(args, mesh=None):
    """(classifier, policy config, device) for parsed args, on ``mesh``."""
    from ..core.episode import EpisodeConfig
    from ..tasks.classification import EncoderTTAClassifier
    from ..utils.runtime import resolve_device

    device = resolve_device(args.device)
    params, cfg = common.load_policy(args, device)
    reward = common.build_reward(args, device)
    loss = {"KD": "kd", "DKD": "dkd", "ATKD": "atkd"}[args.kd_loss] if args.loss in ("kd", "dkd", "atkd") \
        else args.loss
    ecfg = EpisodeConfig(
        tta_steps=args.tta_steps, selection_p=args.selection_p, lr=args.lr, weight_decay=args.weight_decay,
        loss=loss, sample_k=args.sample_k, min_entropy_reg=bool(args.min_entropy_reg),
        min_entropy_w=args.min_entropy_w,
    )
    clf = EncoderTTAClassifier(
        params, cfg, reward, ecfg, prompt_prefix=(args.ctx_prefix or "a photo of a").replace("_", " "),
        only_norm=bool(args.tune_norm), momentum_update=bool(args.momentum_update), update_freq=args.update_freq,
        update_w=args.update_w, momentum=args.tta_momentum,
        bn_prior=None if args.prior_strength < 0 else args.prior_strength,
        remat={"full": True, "save_attn": "save_attn", "none": False}[args.remat], mesh=mesh,
    )
    return clf, cfg, device


def main(argv=None):
    args = get_args(argv)
    refuse_unported(args)
    if common.finish_dry_run(args):
        return None
    mesh = common.run_mesh(args, n_devices=args.dp, dp=args.dp) if args.dp > 1 else None
    common.check_decode(args)

    import torch

    from ..data.augment import make_view_generator
    from ..data.datasets import PrefetchIterator, build_dataset, iter_canonical
    from ..metrics.classification import AccuracyMeter, topk_correct
    from ..parallel.mesh import is_main_rank
    from ..utils.config import save_hparams
    from ..utils.logging_utils import RunLogger

    clf, cfg, device = build(args, mesh)
    gen = make_view_generator(n_views=args.batch_size, resolution=args.resolution, augmix=bool(args.augmix),
                              hard_aug=bool(args.hard_aug))
    logger = RunLogger(args.output, enabled=is_main_rank())   # rank 0 alone writes the run's files
    if logger.enabled:
        save_hparams(args.output, vars(args))

    results = {}
    for set_id in args.test_sets.split("/"):
        classnames = common.class_names(set_id, args.synthetic_classes)
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
            seed = args.seed * 7 + counter[0]   # the JAX entry point's per-group seeds
            counter[0] += 1
            images = torch.from_numpy(np.stack(group_imgs)).to(device)
            views = gen(images, torch.Generator(device=device).manual_seed(seed))
            logits, _ = clf.adapt(views)   # on a mesh, this rank's slice of the group's episodes
            logits = logits.float().cpu().numpy()  # synchronizes with the device
            group_seconds.append(time.perf_counter() - t0)
            meter.update_counts(topk_correct(logits, np.asarray(group_labels)), len(group_labels))
            group_imgs.clear()
            group_labels.clear()

        for img, label in PrefetchIterator(iter_canonical(dataset, 256, seed=args.seed, limit=args.limit,
                                                          workers=args.decode_workers, decode=args.decode)):
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
    print("======== Result Summary ========", json.dumps({k: {m: v[m] for m in ("top1", "top5", "n")}
                                                       for k, v in results.items()}))
    common.report_decode(args)
    return results


if __name__ == "__main__":
    main()

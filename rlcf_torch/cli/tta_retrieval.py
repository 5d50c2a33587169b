"""Retrieval test-time adaptation (`retrieval/clip_ret_policy.py`), on the card.

The port of ``rlcf_tpu/cli/tta_retrieval.py``: runs one or both directions
over a karpathy-format annotation file (``--annotations``, ``--vis_root``);
with ``--synthetic`` it fabricates a tiny gallery so the pipeline runs
without data. Writes ``results_retrieval.json`` and a line of
``evaluate.txt`` with the R@k metrics (both directions), or
``scores_{task}.npy`` (one direction), and ``hparams_retrieval.json``; prints
each direction's per-group seconds (``GROUP_SECONDS``).

Example (random weights, no data):
  python -m rlcf_torch.cli.tta_retrieval --synthetic \\
      --arch ViT-B/16 --reward_arch ViT-L/14 --tta_steps 2 --sample_k 5
Add ``--device cpu`` to run on the CPU (e.g. ``--arch test-small
--reward_arch test-small --resolution 64 --precision fp32``). ``--tp N``
shards the galleries over N ranks and the queries of a group over the rest
(dp = ranks // N), one process a rank: ``torchrun --standalone
--nproc_per_node 4 -m rlcf_torch.cli.tta_retrieval --tp 2 ...``; rank 0
prints and writes the run's files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from . import common


def get_args(argv=None):
    p = argparse.ArgumentParser(description="RLCF retrieval TTA (PyTorch, CUDA)")
    common.add_run_args(p, classification=False)
    common.add_model_args(p)
    common.add_reward_args(p)
    common.add_tta_args(p)
    p.add_argument("--retrieval_task", default="both", choices=["image2text", "text2image", "both"])
    p.add_argument(
        "--loss", default="rlcf", choices=["rlcf", "kd", "dkd", "atkd"],
        help="rlcf = REINFORCE (`clip_ret_policy.py`); kd/dkd/atkd distill the "
        "frozen reward sims (`clip_ret_kd.py:37-93`)",
    )
    p.add_argument(
        "--sample_k_i2t", type=int, default=None,
        help="REINFORCE samples for image->text episodes (reference default 16, "
        "`tta_coco_ret.sh`); falls back to --sample_k",
    )
    p.add_argument(
        "--sample_k_t2i", type=int, default=None,
        help="REINFORCE samples for text->image episodes (reference default 12); "
        "falls back to --sample_k",
    )
    p.add_argument("--annotations", default=None, help="karpathy-format annotation json")
    p.add_argument("--vis_root", default="", help="image root joined with annotation paths")
    p.add_argument("--synthetic", action="store_true", help="tiny fabricated gallery (no data needed)")
    p.add_argument("--group_size", type=int, default=8, help="queries whose episodes run together")
    p.add_argument("--tp", type=int, default=1,
                   help="gallery-axis tensor parallelism over the ranks of a torchrun launch (dp = ranks // tp)")
    return p.parse_args(argv)


def refuse_unported(args):
    """Exit with a message for options this slice of the port does not run."""
    common.refuse({
        "--download": (bool(args.download), common.DOWNLOAD_WAIT),
    })
    if args.multiple_reward_models:
        raise SystemExit("rlcf_torch: --multiple_reward_models 1 does not apply to retrieval: RetrievalTTA takes a "
                         "single reward CLIP, as the JAX package's does (`retrieval/clip_rewards.py`)")


def _synthetic_gallery(n_images=6, caps_per_image=2, res=224):
    """The JAX CLI's fabricated gallery: ``n_images`` normal-noise images and
    ``caps_per_image`` templated captions each."""
    from ..tasks.retrieval import RetrievalGallery

    rng = np.random.default_rng(0)
    texts, img2txt, txt2img = [], {}, {}
    tid = 0
    subjects = ["a dog", "a cat", "a car", "a tree", "a boat", "a bird", "a house", "a bike"]
    for i in range(n_images):
        img2txt[i] = []
        for c in range(caps_per_image):
            texts.append(f"{subjects[i % len(subjects)]} photographed outdoors, variant {c}")
            img2txt[i].append(tid)
            txt2img[tid] = i
            tid += 1
    images = rng.normal(size=(n_images, res, res, 3)).astype(np.float32)
    return RetrievalGallery([f"synthetic_{i}.jpg" for i in range(n_images)], texts, img2txt, txt2img), images


def main(argv=None):
    """Returns ``{"metrics": R@k (both directions) or None, "group_seconds":
    {direction: seconds per group}}``."""
    args = get_args(argv)
    refuse_unported(args)
    if common.finish_dry_run(args):
        return None
    if not args.synthetic and not args.annotations:
        raise SystemExit("tta_retrieval: pass --annotations (a karpathy-format json) or --synthetic")
    mesh = common.run_mesh(args, tp=args.tp, group_flag="group_size") if args.tp > 1 else None
    common.check_decode(args)

    from ..core.episode import EpisodeConfig
    from ..data.transforms import preprocess, preprocess_many
    from ..metrics.retrieval import retrieval_metrics
    from ..parallel.mesh import is_main_rank
    from ..tasks.retrieval import RetrievalTTA, load_karpathy_annotations
    from ..tokenizer import tokenize
    from ..utils.config import save_hparams
    from ..utils.logging_utils import RunLogger
    from ..utils.runtime import resolve_device

    device = resolve_device(args.device)
    main_rank = is_main_rank()   # rank 0 alone writes the run's files
    logger = RunLogger(args.output, enabled=main_rank)
    if main_rank:
        save_hparams(args.output, vars(args), name="hparams_retrieval.json")
    params, cfg = common.load_policy(args, device)
    reward = common.build_reward(args, device)
    # --loss selects the variant; plain "kd" honors the reference's --kd_loss {KD,DKD,ATKD} switch (`TPT/params.py`)
    loss = {"KD": "kd", "DKD": "dkd", "ATKD": "atkd"}[args.kd_loss] if args.loss == "kd" else args.loss
    ecfg = EpisodeConfig(tta_steps=args.tta_steps, lr=args.lr, weight_decay=args.weight_decay,
                         sample_k=args.sample_k, adam_eps=1e-6, loss=loss)

    if args.synthetic:
        gallery, images = _synthetic_gallery(res=args.resolution)
        image_batches = lambda: [images]
    else:
        gallery = load_karpathy_annotations(args.annotations, args.vis_root)

        def image_batches(batch=32):
            paths = gallery.image_paths
            for s0 in range(0, len(paths), batch):
                yield np.stack(preprocess_many(paths[s0 : s0 + batch], args.resolution, decode=args.decode,
                                               workers=args.decode_workers))

    n_img, n_txt = len(gallery.image_paths), len(gallery.texts)
    momentum_kw = dict(momentum_update=bool(args.momentum_update), update_freq=args.update_freq,
                       update_w=args.update_w, momentum=args.tta_momentum, mesh=mesh)
    scores_i2t = scores_t2i = None
    group_seconds = {}
    if args.retrieval_task in ("image2text", "both"):
        ecfg_i2t = dataclasses.replace(ecfg, sample_k=args.sample_k_i2t if args.sample_k_i2t is not None
                                       else args.sample_k)
        tta = RetrievalTTA(params, cfg, reward, ecfg_i2t, direction="i2t", **momentum_kw).set_text_gallery(
            gallery.texts)
        queries = iter(images) if args.synthetic else (preprocess(p, args.resolution, decode=args.decode)
                                                      for p in gallery.image_paths)
        scores_i2t = tta.run(queries, n_img, n_txt, group_size=args.group_size)
        group_seconds["i2t"] = tta.group_seconds
    if args.retrieval_task in ("text2image", "both"):
        ecfg_t2i = dataclasses.replace(ecfg, sample_k=args.sample_k_t2i if args.sample_k_t2i is not None
                                       else args.sample_k)
        tta = RetrievalTTA(params, cfg, reward, ecfg_t2i, direction="t2i", **momentum_kw)
        tta.set_image_gallery(image_batches(), image_batches())
        tokens = tokenize(gallery.texts, truncate=True)
        scores_t2i = tta.run(iter(tokens), n_txt, n_img, group_size=args.group_size)
        group_seconds["t2i"] = tta.group_seconds
    for direction, secs in group_seconds.items():
        print(f"GROUP_SECONDS {direction} " + json.dumps(secs))

    metrics = None
    if scores_i2t is not None and scores_t2i is not None:
        metrics = retrieval_metrics(scores_i2t, scores_t2i, gallery.txt2img, gallery.img2txt)
        metrics = {k: round(v, 3) for k, v in metrics.items()}
        logger.result_line(metrics)
        if main_rank:
            with open(os.path.join(args.output, "results_retrieval.json"), "w") as fh:
                json.dump(metrics, fh, indent=4)
        print(metrics)
    else:
        print("single-direction run complete; score matrix saved")
        if main_rank:
            np.save(os.path.join(args.output, f"scores_{args.retrieval_task}.npy"),
                    scores_i2t if scores_i2t is not None else scores_t2i)
    common.report_decode(args)
    return {"metrics": metrics, "group_seconds": group_seconds}


if __name__ == "__main__":
    main()

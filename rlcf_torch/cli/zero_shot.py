"""Zero-shot CLIP classification (`TPT/zero_shot.py`), on the card: the port
of ``rlcf_tpu/cli/zero_shot.py``. One architecture, or with
``--ensemble_archs`` the logit average of several, each taking the batch
resized to its own resolution (bicubic, aligned corners).

Example (random weights, no data):
  python -m rlcf_torch.cli.zero_shot --test_sets synthetic --limit 32 \\
      --ensemble_archs ViT-B/16 RN50x64 ViT-L/14@336px
Add ``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse

from . import common


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Zero-shot CLIP eval (PyTorch, CUDA)")
    common.add_run_args(p)
    common.add_model_args(p)
    p.add_argument("--ctx_init", default="a_photo_of_a")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--ensemble_archs", nargs="*", default=None, help="multi-arch logit ensemble")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    common.refuse({"--download": (bool(args.download), common.DOWNLOAD_WAIT)})
    if common.finish_dry_run(args):
        return None
    common.check_decode(args)
    from ..data.datasets import build_dataset
    from ..tasks.classification import zero_shot_eval_ensemble
    from ..utils.config import save_hparams
    from ..utils.logging_utils import RunLogger
    from ..utils.runtime import resolve_device

    device = resolve_device(args.device)
    logger = RunLogger(args.output)
    save_hparams(args.output, vars(args))
    prefix = (args.ctx_init or "a photo of a").replace("_", " ")
    models = [common.load_policy(argparse.Namespace(**{**vars(args), "arch": arch}), device)
              for arch in (args.ensemble_archs or [args.arch])]

    results = {}
    for set_id in args.test_sets.split("/"):
        classnames = common.class_names(set_id, args.synthetic_classes)
        dataset = build_dataset(set_id, args.data, mode=args.dataset_mode, corruption=args.corruption,
                                level=args.level, n_classes=len(classnames))
        results[set_id] = zero_shot_eval_ensemble(models, dataset, classnames, prompt_prefix=prefix,
                                                  batch_size=args.batch_size, resolution=args.resolution,
                                                  limit=args.limit, seed=args.seed, decode=args.decode,
                                                  decode_workers=args.decode_workers)
        logger.text(f"=> Zero-shot acc on [{set_id}]: {results[set_id]}")
    logger.results_json(results)
    print(results)
    common.report_decode(args)
    return results


if __name__ == "__main__":
    main()

"""Export the prompt-TTA episode as a serving artifact (``torch.export``):
the port of ``rlcf_tpu/cli/export_serving.py``.

The whole episode of a group (frozen towers, selection, the steps' forward,
backward and AdamW update, the final prediction) is captured into one
program with the attention kernels as ``rlcf::`` custom ops, and saved. The
artifact takes the weights as call arguments, so one export serves any
checkpoint of the same architecture and class count; a process that imports
``rlcf_torch.utils.export`` (which imports ``rlcf_torch.ops.attention``) and
no model code serves it with ``load_exported``.

Example (random weights, no data):
  python -m rlcf_torch.cli.export_serving --test_sets synthetic --synthetic_classes A \\
      --arch ViT-B/16 --reward_arch ViT-L/14 --batch_size 64 --episode_group 4 \\
      --tta_steps 3 --input tokens --out /tmp/episode.rlcfx
Add ``--device cpu`` to export on the CPU.
"""

from __future__ import annotations

import argparse
import time

from . import common


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Export the TTA episode for serving (torch.export)")
    common.add_run_args(p)
    common.add_model_args(p)
    common.add_reward_args(p)
    common.add_tta_args(p)
    p.add_argument("--out", required=True, help="output artifact path (.rlcfx)")
    p.add_argument("--platforms", default=None,
                   help="comma-separated device types the artifact may be served on, 'cuda' and/or 'cpu' "
                   "(default: --device's); the loader moves the program to one of them")
    p.add_argument("--views_dtype", default="float32", choices=["float32", "uint8"],
                   help="serving view input dtype (uint8 = raw pixels, normalized in the graph)")
    p.add_argument("--input", default="images", choices=["images", "tokens"],
                   help="'tokens' exports the patch-major hot path (u8 policy tokens in, the selected views "
                   "depatchified for the reward in the graph; ViT policies only)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns {"out", "bytes", "classes", "input", "trace_seconds",
    "classifier"}: the set-up ``PromptTTAClassifier`` that was traced, whose
    ``adapt``/``adapt_tokens`` run the same episode eagerly."""
    args = get_args(argv)
    common.refuse({"--download": (bool(args.download), common.DOWNLOAD_WAIT)})
    if common.finish_dry_run(args):
        return None
    import torch

    from ..core.episode import EpisodeConfig
    from ..tasks.classification import PromptTTAClassifier
    from ..utils.export import export_serving, save_exported
    from ..utils.runtime import resolve_device

    device = resolve_device(args.device)
    params, cfg = common.load_policy(args, device)
    if args.input == "tokens":   # before the reward is built
        if not cfg.is_vit:
            raise SystemExit("--input tokens requires a ViT policy (ResNets keep the image input)")
        if args.resolution % cfg.vision_patch_size:
            raise SystemExit(f"--input tokens needs resolution % patch == 0 ({args.resolution} vs "
                             f"{cfg.vision_patch_size})")
    reward = common.build_reward(args, device)
    ecfg = EpisodeConfig(tta_steps=args.tta_steps, selection_p=args.selection_p, lr=args.lr,
                         weight_decay=args.weight_decay, sample_k=args.sample_k)
    classnames = common.class_names(args.test_sets.split("/")[0], args.synthetic_classes)
    clf = PromptTTAClassifier(params, cfg, reward, ecfg, ctx_init=args.ctx_init or "a photo of a").setup(classnames)

    platforms = args.platforms.split(",") if args.platforms else None
    t0 = time.perf_counter()
    if args.input == "tokens":
        if args.views_dtype != "float32":
            print("NOTE: --views_dtype is ignored with --input tokens (tokens are always uint8)")
        p_sz = cfg.vision_patch_size
        shape = (args.episode_group, args.batch_size, (args.resolution // p_sz) ** 2, p_sz * p_sz * 3)
        blob = export_serving(clf.serving_fn_tokens(), clf.serving_example_args_tokens(shape), platforms=platforms)
        desc = f"policy tokens {shape} uint8"
    else:
        shape = (args.episode_group, args.batch_size, args.resolution, args.resolution, 3)
        dtype = torch.uint8 if args.views_dtype == "uint8" else torch.float32
        blob = export_serving(clf.serving_fn(), clf.serving_example_args(shape, views_dtype=dtype),
                              platforms=platforms)
        desc = f"views {shape} {args.views_dtype}"
    trace_seconds = time.perf_counter() - t0
    save_exported(args.out, blob)
    print(f"exported fused episode ({len(classnames)} classes, {desc}) "
          f"-> {args.out} ({len(blob)/1e6:.2f} MB)")
    return {"out": args.out, "bytes": len(blob), "classes": len(classnames), "input": args.input,
            "trace_seconds": trace_seconds, "classifier": clf}


if __name__ == "__main__":
    main()

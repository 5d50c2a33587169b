"""CLIPScore / RefCLIPScore CLI (`clipscore/clipscore.py:220-285`), on the card.

The port of ``rlcf_tpu/cli/clipscore_eval.py``:

  python -m rlcf_torch.cli.clipscore_eval candidates.json image_dir \\
      [--references_json refs.json] [--compute_other_ref_metrics 1]

candidates.json: {image_id: caption}; references: {image_id: [refs...]}.
Image files resolve as ``image_dir/image_id`` with common extensions. Add
``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from . import common


def get_args(argv=None):
    p = argparse.ArgumentParser(description="CLIPScore evaluation (PyTorch, CUDA)")
    p.add_argument("candidates_json")
    p.add_argument("image_dir")
    p.add_argument("--references_json", default=None)
    p.add_argument("--compute_other_ref_metrics", type=int, default=1)
    p.add_argument("--save_per_instance", default=None)
    p.add_argument("--out_json", default=None, help="write the metric summary as json")
    p.add_argument("--arch", default="ViT-B/32")
    p.add_argument("--clip_checkpoint", default=None)
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--precision", default="fp32", choices=["bf16", "fp32"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scorer runs; 'cuda' fails when there is no card")
    common.add_decode_args(p)
    common.add_dry_run_arg(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--download_nltk", type=int, default=0,
                   help="not supported by the port (refused when 1): it downloads nothing; METEOR runs with "
                   "the synonym stage where the wordnet corpus is installed, degraded otherwise")
    return p.parse_args(argv)


def refuse_unported(args):
    if args.download_nltk:
        raise SystemExit("rlcf_torch: --download_nltk 1 is refused: the port downloads nothing; install the "
                         "wordnet corpus beforehand for METEOR's synonym stage")


def main(argv=None):
    args = get_args(argv)
    refuse_unported(args)
    if common.finish_dry_run(args):
        return None
    common.check_decode(args)
    from ..data.transforms import preprocess_many
    from ..metrics.caption_metrics import get_all_metrics
    from ..metrics.clipscore import evaluate_captions
    from ..utils.runtime import resolve_device

    params, cfg = common.load_policy(args, resolve_device(args.device))

    with open(args.candidates_json) as fh:
        candidates = json.load(fh)
    image_ids = list(candidates.keys())

    def resolve(image_id):
        base = os.path.join(args.image_dir, image_id)
        for cand in (base, base + ".jpg", base + ".png", base + ".jpeg"):
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(base)

    def images_iter(batch=32):
        paths = [resolve(i) for i in image_ids]
        for s0 in range(0, len(paths), batch):
            yield np.stack(preprocess_many(paths[s0 : s0 + batch], args.resolution, decode=args.decode,
                                           workers=args.decode_workers))

    references = None
    if args.references_json:
        with open(args.references_json) as fh:
            references = json.load(fh)
        references = {i: (r if isinstance(r, list) else [r]) for i, r in references.items()}

    out = evaluate_captions(params, cfg, candidates, images_iter, image_ids, references)
    if references and args.compute_other_ref_metrics:
        other = get_all_metrics([references[i] for i in image_ids], [candidates[i] for i in image_ids])
        for b, sc in enumerate(other["bleu"]):
            print(f"BLEU-{b+1}: {sc*100:.2f}")
        for key in ("meteor", "rouge", "cider"):
            print(f"{key.upper()}: {other[key]*100:.2f}")
        if other.get("meteor_mode") != "nltk_wordnet":
            print(f"METEOR mode: {other['meteor_mode']} (degraded — not pycocoevalcap-comparable)")
        out.update(other)
    print(f"CLIPScore: {out['clipscore']*100:.2f}")
    if "ref_clipscore" in out:
        print(f"RefCLIPScore: {out['ref_clipscore']*100:.2f}")
    if args.save_per_instance:
        with open(args.save_per_instance, "w") as fh:
            json.dump(out["per_instance"], fh)
    if args.out_json:
        summary = {k: v for k, v in out.items() if k != "per_instance"}
        summary["n_images"] = len(image_ids)
        with open(args.out_json, "w") as fh:
            json.dump(summary, fh, indent=2)
    common.report_decode(args)
    return out


if __name__ == "__main__":
    main()

"""Caption test-time adaptation (`caption/capdec_tta.py`), on the card.

The port of ``rlcf_tpu/cli/tta_caption.py``: per test image, CLIP-encode it
to a prefix, run ``tta_steps`` of beam-K caption sampling + CLIPScore
REINFORCE on the mapper, emit a final beam-5 caption. Writes the COCO-format
``results_caption.json``, the {image: caption} ``results_clipscore.json``,
the sampled-caption/reward trace ``caption_trace.txt`` and
``hparams_caption.json``; prints each group's seconds (``GROUP_SECONDS``).
``--synthetic`` runs without data on a tiny OPT and a byte vocabulary.

Example (random weights, no data):
  python -m rlcf_torch.cli.tta_caption --synthetic --tta_steps 2
Add ``--device cpu`` to run on the CPU (e.g. ``--clip_model_type test-small
--reward_arch test-small --resolution 64 --precision fp32``). ``--dp D --tp
T`` runs on D * T ranks, one process a rank (``torchrun --standalone
--nproc_per_node 4 -m rlcf_torch.cli.tta_caption --dp 2 --tp 2 ...``): each
dp rank adapts its slice of a group, the decode's OPT weights split over
tp; rank 0 prints and writes the run's files.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import common


def get_args(argv=None):
    p = argparse.ArgumentParser(description="RLCF caption TTA (PyTorch, CUDA)")
    common.add_run_args(p, classification=False)
    common.add_model_args(p)
    common.add_reward_args(p)
    p.add_argument("--tta_steps", type=int, default=4)
    p.add_argument("--tta_lr", type=float, default=3e-6)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--use_nucleus_sampling", type=int, default=0,
                   help="sample the K captions by nucleus sampling (top-p 0.92) instead of beam search; the draws "
                   "come from a torch generator seeded from --seed and the group's index")
    p.add_argument("--decode_seg_len", type=int, default=16,
                   help="segment-bucketed beam cache (models/opt.py seg_len): the generated-position cache grows "
                   "this many slots at a time, so the beam reorder and its attention read the elapsed slots only; "
                   "the same captions; 0 = off")
    p.add_argument("--quantize_decode", type=int, default=0,
                   help="int8 weight-only OPT decode (generation only; the update keeps full precision; sampled "
                   "captions may differ within the quantization error)")
    p.add_argument("--prefix_length", type=int, default=40)
    p.add_argument("--clip_length", type=int, default=40)
    p.add_argument("--mapping_type", default="transformer", choices=["mlp", "transformer"])
    p.add_argument("--normalize_prefix", type=int, default=0)
    p.add_argument("--llm", default="opt-125m")
    p.add_argument("--checkpoint", default=None, help="supervised ClipCap/CapDec mapper ckpt (npz or torch)")
    p.add_argument("--opt_checkpoint", default=None, help="HF OPT torch checkpoint")
    p.add_argument("--opt_vocab", default=None, help="vocab.json for the OPT tokenizer")
    p.add_argument("--opt_merges", default=None, help="merges.txt for the OPT tokenizer")
    p.add_argument("--clip_model_type", default="ViT-B/16", help="feature-extractor CLIP arch")
    p.add_argument("--annotations", default=None)
    p.add_argument("--images_root", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--momentum_update", type=int, default=0)
    p.add_argument("--update_freq", type=int, default=256)
    p.add_argument("--update_w", type=float, default=1.0)
    p.add_argument("--tta_momentum", type=float, default=0.9999)
    p.add_argument("--out_results_file", default=None)
    p.add_argument("--out_clipscore_file", default=None)
    p.add_argument("--episode_group", type=int, default=16,
                   help="images adapted together (each decode step reads all of OPT's weights, which the "
                   "group's images share)")
    p.add_argument("--dp", type=int, default=1, help="episode data parallelism (ranks = dp * tp, under torchrun)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism of the OPT decode (ranks = dp * tp, under torchrun)")
    return p.parse_args(argv)


def refuse_unported(args):
    """Exit with a message for options this slice of the port does not run,
    before any model loads."""
    common.refuse({
        "--download": (bool(args.download), common.DOWNLOAD_WAIT),
    })
    if args.multiple_reward_models:
        raise SystemExit("rlcf_torch: --multiple_reward_models 1 does not apply to captioning: CaptionTTA scores "
                         "with the parameters of one reward CLIP (reward.cfg, reward.params), which the reward "
                         "ensemble does not have, in the JAX package too")


def _synthetic_tokenizer(tmp_dir, write: bool = True):
    """The JAX CLI's byte vocabulary for data-free runs: ``<pad>`` 1,
    ``</s>`` 2 and the 256 byte symbols at ids 4..259, no merges (written
    to ``tmp_dir`` unless ``write`` is false: the files are there)."""
    from ..tokenizer_gpt2 import Gpt2Tokenizer, _byte_to_unicode

    vocab_p, merges_p = os.path.join(tmp_dir, "vocab.json"), os.path.join(tmp_dir, "merges.txt")
    if not write:
        return Gpt2Tokenizer(vocab_p, merges_p)
    os.makedirs(tmp_dir, exist_ok=True)
    vocab = {"<pad>": 1, "</s>": 2}
    next_id = 4
    for ch in _byte_to_unicode().values():
        if ch not in vocab:
            vocab[ch] = next_id
            next_id += 1
    with open(vocab_p, "w") as fh:
        json.dump(vocab, fh)
    with open(merges_p, "w") as fh:
        fh.write("#version\n")
    return Gpt2Tokenizer(vocab_p, merges_p)


def entry_id(a, dmode: int):
    """The result's image_id per eval set (`caption/image_llm/datasets/coco_cap.py:239-289`): COCO the
    trailing number of COCO_val2014_000000xxxx.jpg, Flickr the numeric stem, NoCaps its explicit id;
    otherwise the image path."""
    img = a["image"]
    if dmode == 0:
        return int(img.split("_")[-1][:-4])
    if dmode == 1:
        return int(img.split("/")[-1][:-4])
    if dmode == 2:
        return a["image_id"]
    return img


def main(argv=None):
    """Returns ``{"results": [{image_id, caption}], "group_seconds": [...]}``."""
    args = get_args(argv)
    refuse_unported(args)
    if common.finish_dry_run(args):
        return None
    if not args.synthetic and not args.annotations:
        raise SystemExit("tta_caption: pass --annotations (and --images_root) or --synthetic")
    mesh = None
    if args.dp > 1 or args.tp > 1:
        mesh = common.run_mesh(args, n_devices=args.dp * args.tp, dp=args.dp, tp=args.tp)
    common.check_decode(args)

    import torch

    from ..models import clip as clip_model
    from ..models import mappers as M
    from ..models import opt as O
    from ..parallel.mesh import barrier, is_main_rank
    from ..tasks import caption as Cap
    from ..utils.config import save_hparams
    from ..utils.logging_utils import CaptionTraceLogger, RunLogger
    from ..utils.runtime import resolve_device

    device = resolve_device(args.device)
    main_rank = is_main_rank()   # rank 0 alone writes the run's files
    logger = RunLogger(args.output, enabled=main_rank)
    if main_rank:
        save_hparams(args.output, vars(args), name="hparams_caption.json")

    # the feature-extractor CLIP (the prefix's source) and the reward
    feat_args = argparse.Namespace(**{**vars(args), "arch": args.clip_model_type})
    clip_params, clip_cfg = common.load_policy(feat_args, device)
    reward = common.build_reward(args, device)

    if args.synthetic:
        ocfg = O.OPT_CONFIGS["test-tiny-opt"]
        mcfg = M.MapperConfig(args.mapping_type, clip_dim=clip_cfg.embed_dim, llm_dim=ocfg.embed_dim,
                              prefix_length=4, clip_length=2, num_layers=1, n_heads=2)
        if main_rank:   # the other ranks read rank 0's files
            _synthetic_tokenizer(os.path.join(args.output, "tok"))
        barrier()
        tok = _synthetic_tokenizer(os.path.join(args.output, "tok"), write=False)
        max_new = 8
    else:
        from ..tokenizer_gpt2 import load_gpt2_tokenizer

        ocfg = O.OPT_CONFIGS[args.llm]
        mcfg = M.MapperConfig(args.mapping_type, clip_dim=clip_cfg.embed_dim, llm_dim=ocfg.embed_dim,
                              prefix_length=args.prefix_length, clip_length=args.clip_length)
        tok = load_gpt2_tokenizer(args.opt_vocab, args.opt_merges)
        max_new = 50
    ccfg = Cap.CaptionModelConfig(mapper=mcfg, opt=ocfg, normalize_prefix=bool(args.normalize_prefix))
    params = Cap.init_caption_params(args.seed, ccfg, device=device)
    if args.opt_checkpoint:
        from ..models.convert import load_torch_file

        params["opt"], _ = O.convert_opt_state_dict(load_torch_file(args.opt_checkpoint), device=device)
    if args.checkpoint:
        if args.checkpoint.endswith(".npz"):
            params["mapper"], _ = Cap.load_mapper_checkpoint(args.checkpoint, params["mapper"])
        else:
            from ..models.convert import load_torch_file

            params["mapper"] = M.convert_mapper_state_dict(load_torch_file(args.checkpoint), mcfg, device=device)
    tta = Cap.CaptionTTA(
        params, ccfg, reward, tok, tta_steps=args.tta_steps, lr=args.tta_lr, weight_decay=args.weight_decay,
        sample_k=args.sample_k, max_new_tokens=max_new, use_nucleus=bool(args.use_nucleus_sampling),
        momentum_update=bool(args.momentum_update), update_freq=args.update_freq, update_w=args.update_w,
        momentum=args.tta_momentum, quantize_decode=bool(args.quantize_decode),
        decode_seg_len=args.decode_seg_len or None, seed=args.seed, mesh=mesh,
    )

    # --dataset_mode as an int selects the eval set (0=COCO 1=Flickr30k
    # 2=NoCaps, `image_llm/params.py`); the run-args default ("test") keys
    # results by the image path
    try:
        dmode = int(args.dataset_mode)
    except (TypeError, ValueError):
        dmode = -1
    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        samples = [(f"synthetic_{i}", f"synthetic_{i}",
                    rng.normal(size=(args.resolution, args.resolution, 3)).astype(np.float32))
                   for i in range(args.limit or 4)]
    else:
        from ..data.transforms import preprocess_many

        with open(args.annotations) as fh:
            ann = json.load(fh)[: args.limit]
        imgs = preprocess_many([os.path.join(args.images_root, a["image"]) for a in ann], args.resolution,
                               decode=args.decode, workers=args.decode_workers)
        samples = [(entry_id(a, dmode), os.path.basename(a["image"]) if dmode >= 0 else a["image"], im)
                   for a, im in zip(ann, imgs)]

    feat_attn = clip_model.best_attn(clip_cfg, device)   # the JAX CLI encodes it dense: the same function
    trace_log = CaptionTraceLogger(os.path.join(args.output, "caption_trace.txt")) if main_rank else None
    results, per_image, group_seconds = [], {}, []

    def run_group(group):
        t0 = time.perf_counter()
        imgs = np.stack([g[2] for g in group])
        with torch.no_grad():
            embs = clip_model.encode_image(clip_params, clip_cfg, torch.as_tensor(imgs, device=device),
                                           attn=feat_attn).float().cpu().numpy()
        if args.normalize_prefix:
            embs = embs / np.linalg.norm(embs, axis=-1, keepdims=True)
        trace: list = []
        if len(group) == 1:
            captions = [tta.adapt_image(imgs[0], embs[0], trace=trace)]
        else:
            captions = tta.adapt_batch(imgs, embs, trace=trace)
        group_seconds.append(time.perf_counter() - t0)
        for (image_id, sub, _), caption in zip(group, captions):
            results.append({"image_id": image_id, "caption": caption})
            per_image[str(sub)] = caption
        if trace_log is None:
            return
        for (_, sub, _), caption in zip(group, captions):
            trace_log.log_id(str(sub))
            trace_log.log_final(caption)
        for step_samples in trace:
            trace_log.log_samples([t for t, _ in step_samples], [r for _, r in step_samples])

    for g0 in range(0, len(samples), args.episode_group):
        run_group(samples[g0 : g0 + args.episode_group])
    print("GROUP_SECONDS " + json.dumps(group_seconds))
    out_results = args.out_results_file or os.path.join(args.output, "results_caption.json")
    if main_rank:
        trace_log.close()
        out_cs = args.out_clipscore_file or os.path.join(args.output, "results_clipscore.json")
        with open(out_results, "w") as fh:
            json.dump(results, fh)
        with open(out_cs, "w") as fh:
            json.dump(per_image, fh)
    logger.text(f"wrote {out_results} ({len(results)} captions)")
    common.report_decode(args)
    return {"results": results, "group_seconds": group_seconds}


if __name__ == "__main__":
    main()

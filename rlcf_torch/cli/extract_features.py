"""CLIP feature pre-extraction for caption training (`caption/extractor_pickle.py`), on the card.

The port of ``rlcf_tpu/cli/extract_features.py``: for each caption of a
karpathy-format annotation file, its CLIP text embedding (and, with
``--images_root``, its image's embedding) and its OPT token ids and mask
(the prefix's ``--prefix_length`` ones, then the caption's ``--token_len``),
in one npz or, with ``--shard_size``, in npz shards behind a manifest
(``data/sharded_embeddings.py``). The embeddings are float32 whatever
``--precision``: the towers' values, which ``np.load`` reads back as numbers
(the JAX package writes a bf16 tower's in bf16, which ``np.load`` reads as
raw ``|V2`` bytes and its trainer cannot take).

Usage: python -m rlcf_torch.cli.extract_features --annotations ann.json \\
          --images_root imgs/ --opt_vocab vocab.json --opt_merges merges.txt \\
          --out embeddings.npz
Add ``--device cpu`` to run on the CPU (e.g. ``--arch test-small --resolution 64``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from . import common

IMAGE_BATCH = 32
TEXT_BATCH = 256


def get_args(argv=None):
    p = argparse.ArgumentParser(description="CLIP feature extraction (PyTorch, CUDA)")
    common.add_model_args(p)
    p.add_argument("--annotations", required=True, help="karpathy-format json")
    p.add_argument("--images_root", default=None, help="if set, also extract image embeddings")
    p.add_argument("--opt_vocab", default=None, help="vocab.json (default: auto-discovered)")
    p.add_argument("--opt_merges", default=None, help="merges.txt (default: auto-discovered)")
    p.add_argument("--prefix_length", type=int, default=40)
    p.add_argument("--token_len", type=int, default=40)
    p.add_argument("--out", required=True,
                   help="output npz; its embeddings are float32 whatever --precision (the JAX package writes bf16 "
                   "ones, which np.load reads as raw |V2 bytes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    common.add_decode_args(p)
    common.add_dry_run_arg(p)
    p.add_argument("--shard_size", type=int, default=0,
                   help="captions per output shard; > 0 streams npz shards behind a manifest with bounded memory "
                   "(COCO-scale, ~600k captions: the reference's lmdb extractor, "
                   "`caption/tools/extractor_lmdb.py:20-90`); 0 = one npz")
    return p.parse_args(argv)


def _image_batches(args, rel_paths):
    from ..data.transforms import preprocess_many

    paths = [os.path.join(args.images_root, p) for p in rel_paths]
    for s in range(0, len(paths), IMAGE_BATCH):
        yield np.stack(preprocess_many(paths[s : s + IMAGE_BATCH], args.resolution, decode=args.decode,
                                       workers=args.decode_workers))


def _tokens_and_mask(tok, captions, args):
    tokens, tmask = tok.batch_encode(captions, pad_to=args.token_len)
    return tokens, np.concatenate([np.ones((tokens.shape[0], args.prefix_length), np.int32), tmask], axis=1)


def _extract_sharded(args, params, cfg, tok, captions, image_for_caption):
    """Bounded-memory streaming extraction (`caption/tools/extractor_lmdb.py:46-90`):
    each ``--shard_size`` captions are encoded (texts in batches of 256, their
    images not yet seen in the chunk in batches of 32) and appended to the
    shard writer. An image whose captions straddle a chunk boundary is encoded
    again in the next chunk, as in the JAX package. -> the number of images encoded."""
    from ..data.sharded_embeddings import ShardWriter
    from ..tasks.caption import extract_clip_features

    base = args.out[:-4] if args.out.endswith(".npz") else args.out
    n_images = 0
    with ShardWriter(base, shard_size=args.shard_size) as w:
        for s in range(0, len(captions), args.shard_size):
            caps = captions[s : s + args.shard_size]
            imgs = image_for_caption[s : s + args.shard_size]
            tokens, mask = _tokens_and_mask(tok, caps, args)
            chunk = {"text_embeddings": extract_clip_features(params, cfg, texts=caps,
                                                              batch_size=TEXT_BATCH)["text_embeddings"],
                     "tokens": tokens, "mask": mask, "captions": np.array(caps, dtype=object),
                     "images": np.array(imgs, dtype=object)}
            if args.images_root:
                unique = list(dict.fromkeys(imgs))
                feats = extract_clip_features(params, cfg, images_iter=_image_batches(args, unique))
                row = {p: i for i, p in enumerate(unique)}
                chunk["image_embeddings"] = feats["image_embeddings"][[row[p] for p in imgs]]
                n_images += len(unique)
            w.append(chunk)
            print(f"extracted {min(s + args.shard_size, len(captions))}/{len(captions)} captions")
    print(f"wrote {base}.manifest.json: {len(captions)} captions in shards of {args.shard_size}")
    return n_images


def main(argv=None):
    """Returns ``{"out": path, "captions": n, "images": images encoded}``."""
    args = get_args(argv)
    common.refuse({"--download": (bool(args.download), common.DOWNLOAD_WAIT)})
    if common.finish_dry_run(args):
        return None
    common.check_decode(args)

    from ..tasks.caption import extract_clip_features
    from ..tokenizer_gpt2 import load_gpt2_tokenizer
    from ..utils.runtime import resolve_device

    device = resolve_device(args.device)
    params, cfg = common.load_policy(args, device)
    tok = load_gpt2_tokenizer(args.opt_vocab, args.opt_merges)
    with open(args.annotations) as fh:
        ann = json.load(fh)[: args.limit]
    captions, image_for_caption = [], []
    for a in ann:
        for c in a["caption"] if isinstance(a["caption"], list) else [a["caption"]]:
            captions.append(c)
            image_for_caption.append(a["image"])

    if args.shard_size > 0:
        n_images = _extract_sharded(args, params, cfg, tok, captions, image_for_caption)
        common.report_decode(args)
        return {"out": args.out, "captions": len(captions), "images": n_images}

    feats = extract_clip_features(params, cfg, texts=captions, batch_size=TEXT_BATCH)
    n_images = 0
    if args.images_root:
        images = extract_clip_features(params, cfg, images_iter=_image_batches(args, [a["image"] for a in ann]))
        image_index = {a["image"]: i for i, a in enumerate(ann)}
        feats["image_embeddings"] = images["image_embeddings"][[image_index[p] for p in image_for_caption]]
        n_images = len(ann)
    tokens, mask = _tokens_and_mask(tok, captions, args)
    np.savez(args.out, tokens=tokens, mask=mask, captions=np.array(captions, dtype=object),
             images=np.array(image_for_caption, dtype=object), **feats)
    print(f"wrote {args.out}: {tokens.shape[0]} captions")
    common.report_decode(args)
    return {"out": args.out, "captions": len(captions), "images": n_images}


if __name__ == "__main__":
    main()

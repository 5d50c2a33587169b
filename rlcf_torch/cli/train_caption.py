"""Supervised ClipCap/CapDec mapper training (`caption/train.py`), on the card.

The port of ``rlcf_tpu/cli/train_caption.py``: trains the prefix mapper
against a frozen OPT on precomputed CLIP embeddings (the npz or the sharded
store that ``rlcf_torch.cli.extract_features`` or ``rlcf_tpu.cli.extract_features``
writes; a bf16 column of the latter, raw ``|V2`` bytes to ``np.load``, is
read as bf16), writing ``ckpt-latest.npz`` every epoch and
``ckpt-{epoch:03d}.npz`` for the last six into ``--output``; prints
``loss_per_epoch_train``. ``--synthetic`` fabricates a tiny set.

As in the JAX package, ``--resume`` restores the mapper and the epoch but not
the optimizer: the AdamW moments start at zero and the schedule at step 0.
CapDec's noise comes from a torch generator seeded from ``--seed``: the JAX
package's recipe, not its draws.

Example: python -m rlcf_torch.cli.train_caption --synthetic --epochs 2 --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from . import common


def get_args(argv=None):
    p = argparse.ArgumentParser(description="ClipCap/CapDec supervised training (PyTorch, CUDA)")
    common.add_run_args(p, classification=False)
    common.add_model_args(p)
    p.add_argument("--embeddings", default=None, help="npz (or sharded store) with text/image embeddings + tokens + mask")
    p.add_argument("--cap_model", default="CapDec", choices=["CapDec", "ClipCap"])
    p.add_argument("--noise_variance", type=float, default=0.016)
    p.add_argument("--normalize_prefix", type=int, default=0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--train_batch_size", type=int, default=40)
    p.add_argument("--train_lr", type=float, default=2e-5)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--prefix_length", type=int, default=40)
    p.add_argument("--clip_length", type=int, default=40)
    p.add_argument("--mapping_type", default="transformer", choices=["mlp", "transformer"])
    p.add_argument("--llm", default="opt-125m")
    p.add_argument("--opt_checkpoint", default=None)
    p.add_argument("--resume", default=None,
                   help="ckpt-latest.npz to resume from: the mapper and the epoch (the optimizer and the schedule "
                   "start afresh, as in the JAX package)")
    p.add_argument("--synthetic", action="store_true")
    return p.parse_args(argv)


def as_float32(column):
    """An embedding column as float32. A bf16 array that ``np.savez`` wrote
    (the JAX package's bf16 extraction) loads as the void dtype ``|V2``:
    its bytes are bf16, the high half of a float32, so the cast is exact."""
    column = np.asarray(column)
    if column.dtype.kind == "V" and column.dtype.itemsize == 2:
        return (column.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return column.astype(np.float32)


def _synthetic(args, ocfg):
    """The JAX CLI's tiny set: 64 random embeddings of 16 dims, token rows of 8 from BOS."""
    from ..models import mappers as M

    mcfg = M.MapperConfig(args.mapping_type, clip_dim=16, llm_dim=ocfg.embed_dim, prefix_length=4, clip_length=2,
                          num_layers=1, n_heads=2)
    rng = np.random.default_rng(0)
    n = 64
    prefix = rng.normal(size=(n, 16)).astype(np.float32)
    tokens = rng.integers(4, ocfg.vocab_size - 4, size=(n, 8)).astype(np.int32)
    tokens[:, 0] = ocfg.bos_token_id
    return mcfg, prefix, tokens, np.ones((n, mcfg.prefix_length + 8), np.int32)


def main(argv=None):
    """Returns the mean loss of each epoch trained."""
    args = get_args(argv)
    common.refuse({"--download": (bool(args.download), common.DOWNLOAD_WAIT)})
    if common.finish_dry_run(args):
        return None
    if not args.synthetic and not args.embeddings:
        raise SystemExit("train_caption: pass --embeddings or --synthetic")

    import torch

    from ..data.sharded_embeddings import ShardedEmbeddings, is_sharded
    from ..models import mappers as M
    from ..models import opt as O
    from ..tasks import caption as Cap
    from ..utils.config import save_hparams
    from ..utils.runtime import resolve_device

    device = resolve_device(args.device)
    save_hparams(args.output, vars(args), name="hparams_caption_train.json")
    sharded = None
    if args.synthetic:
        ocfg = O.OPT_CONFIGS["test-tiny-opt"]
        mcfg, prefix, tokens, mask = _synthetic(args, ocfg)
    else:
        ocfg = O.OPT_CONFIGS[args.llm]
        emb_key = "text_embeddings" if args.cap_model == "CapDec" else "image_embeddings"
        if is_sharded(args.embeddings):   # COCO-scale: one shard resident at a time
            sharded = ShardedEmbeddings(args.embeddings)
            clip_dim = sharded.load_shard(0)[emb_key].shape[1]
        else:
            data = np.load(args.embeddings)
            prefix = as_float32(data[emb_key])
            tokens, mask = data["tokens"].astype(np.int32), data["mask"].astype(np.int32)
            clip_dim = prefix.shape[1]
        mcfg = M.MapperConfig(args.mapping_type, clip_dim=clip_dim, llm_dim=ocfg.embed_dim,
                              prefix_length=args.prefix_length, clip_length=args.clip_length)

    ccfg = Cap.CaptionModelConfig(mapper=mcfg, opt=ocfg, normalize_prefix=bool(args.normalize_prefix))
    params = Cap.init_caption_params(args.seed, ccfg, device=device)
    if args.opt_checkpoint:
        from ..models.convert import load_torch_file

        params["opt"], _ = O.convert_opt_state_dict(load_torch_file(args.opt_checkpoint), device=device)
    start_epoch = 0
    if args.resume and os.path.exists(args.resume):
        params["mapper"], start_epoch = Cap.load_mapper_checkpoint(args.resume, params["mapper"])
        start_epoch += 1

    n = len(sharded) if sharded is not None else prefix.shape[0]
    B = args.train_batch_size
    steps_per_epoch = max(n // B, 1)
    tcfg = Cap.TrainConfig(lr=args.train_lr, warmup_steps=args.warmup_steps, total_steps=steps_per_epoch * args.epochs,
                           epochs=args.epochs, batch_size=B, cap_model=args.cap_model,
                           noise_variance=args.noise_variance, normalize_prefix=bool(args.normalize_prefix))
    # the epoch shuffle: one numpy generator that advances across epochs, as in the JAX package
    shuffle_rng = np.random.default_rng(args.seed)
    if sharded is not None:
        def data_iter():
            for emb, toks, msk in sharded.batches(B, (emb_key, "tokens", "mask"), rng=shuffle_rng):
                yield as_float32(emb), toks, msk
    else:
        def data_iter():
            order = shuffle_rng.permutation(n)
            for s in range(0, n - B + 1, B):
                idx = order[s : s + B]
                yield prefix[idx], tokens[idx], mask[idx]

    generator = torch.Generator(device=device).manual_seed(args.seed)
    _, losses = Cap.train_caption_model(params, ccfg, tcfg, data_iter, generator=generator,
                                        checkpoint_dir=args.output, start_epoch=start_epoch)
    print("loss_per_epoch_train:", [round(loss, 4) for loss in losses])
    return losses


if __name__ == "__main__":
    main()

#!/bin/bash
# CapDec supervised training (reference: caption/scripts/train_capdec_coco.sh)
emb=${1:?embeddings npz from extract_features}
python -m rlcf_torch.cli.train_caption --embeddings "$emb" --cap_model CapDec \
    --noise_variance 0.016 --epochs 10 --train_lr 2e-5 --train_batch_size 40 \
    --mapping_type transformer --prefix_length 40 --clip_length 40 \
    --opt_checkpoint "${OPT_125M:-}" --output exp/torch/capdec_coco

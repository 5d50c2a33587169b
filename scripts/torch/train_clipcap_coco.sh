#!/bin/bash
# ClipCap supervised training on pre-extracted COCO image embeddings
# (reference: caption/scripts/train_clipcap_coco.sh; --use_image_embedding, no noise)
emb=${1:?embeddings npz from extract_features}
python -m rlcf_torch.cli.train_caption --embeddings "$emb" --cap_model ClipCap \
    --epochs 10 --train_lr 2e-5 --train_batch_size 40 \
    --mapping_type transformer --prefix_length 40 --clip_length 40 \
    --normalize_prefix 1 \
    --opt_checkpoint "${OPT_125M:-}" --output exp/torch/clipcap_coco

#!/bin/bash
# Pre-extract COCO train-set CLIP text(+image) embeddings for supervised
# caption training (reference: caption/scripts/extract_coco.sh -> tools/extract_coco_text_features.py)
ann=${1:?coco_karpathy_train.json}
imgs=${2:-}
out=${3:-exp/torch/COCO_train_set_image_text_vitb16.npz}
python -m rlcf_torch.cli.extract_features --annotations "$ann" \
    ${imgs:+--images_root "$imgs"} \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    ${OPT_VOCAB:+--opt_vocab "$OPT_VOCAB"} ${OPT_MERGES:+--opt_merges "$OPT_MERGES"} \
    --prefix_length 40 --token_len 40 --out "$out"

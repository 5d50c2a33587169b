#!/bin/bash
# CapDec caption TTA COCO->Flickr30k (reference: caption/scripts/tta_capdec_c2f.sh)
ann=${1:?flickr30k_test.json}
imgs=${2:?image root}
ckpt=${3:?supervised mapper checkpoint}
python -m rlcf_torch.cli.tta_caption --annotations "$ann" --images_root "$imgs" \
    --checkpoint "$ckpt" --opt_checkpoint "${OPT_125M:-}" \
    ${OPT_VOCAB:+--opt_vocab "$OPT_VOCAB"} ${OPT_MERGES:+--opt_merges "$OPT_MERGES"} \
    --clip_model_type ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --normalize_prefix 1 \
    --tta_steps 4 --tta_lr 5e-6 --weight_decay 0.0 --sample_k 6 \
    --output exp/torch/capdec_c2f
python -m rlcf_torch.cli.clipscore_eval exp/torch/capdec_c2f/results_clipscore.json "$imgs" \
    --clip_checkpoint "${CLIP_VIT_B32:-}"

#!/bin/bash
# TTA-free caption eval on COCO karpathy-test + CLIPScore
# (reference: caption/scripts/eval_coco.sh -> image_llm/predict_coco.py)
ann=${1:?coco_karpathy_test.json}
imgs=${2:?image root}
ckpt=${3:?supervised mapper checkpoint}
gt=${4:-}
python -m rlcf_torch.cli.tta_caption --annotations "$ann" --images_root "$imgs" \
    --checkpoint "$ckpt" --opt_checkpoint "${OPT_125M:-}" \
    ${OPT_VOCAB:+--opt_vocab "$OPT_VOCAB"} ${OPT_MERGES:+--opt_merges "$OPT_MERGES"} \
    --clip_model_type ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-B/16 --reward_checkpoint "${CLIP_VIT_B16:-}" \
    --normalize_prefix 1 --tta_steps 0 \
    --output exp/torch/eval_coco
python -m rlcf_torch.cli.clipscore_eval exp/torch/eval_coco/results_clipscore.json "$imgs" \
    ${gt:+--references_json "$gt"} --clip_checkpoint "${CLIP_VIT_B32:-}"

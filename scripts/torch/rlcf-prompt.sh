#!/bin/bash
# RLCF prompt TTA, the flagship config (reference: TPT/scripts/rlcf-prompt.sh)
# usage: bash scripts/rlcf-prompt.sh <data_root> <test_sets e.g. A/V/R/K/I>
root=${1:-/data}
testsets=${2:-A}
python -m rlcf_torch.cli.tta_cls "$root" --test_sets "$testsets" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --loss rlcf --tta_steps 3 --lr 7e-3 --batch_size 64 --selection_p 0.1 \
    --sample_k 3 --ctx_init a_photo_of_a --output "exp/torch/rlcf_prompt_${testsets//\//_}"

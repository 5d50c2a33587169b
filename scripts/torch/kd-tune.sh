#!/bin/bash
# KD TTA variants (reference: TPT/scripts/kd-tune.sh)
root=${1:-/data}
testsets=${2:-A}
kd=${3:-KD}   # KD | DKD | ATKD
python -m rlcf_torch.cli.tta_cls "$root" --test_sets "$testsets" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --loss kd --kd_loss "$kd" --tta_steps 3 --lr 7e-3 --batch_size 64 \
    --ctx_init a_photo_of_a --output "exp/torch/kd_${kd}_${testsets//\//_}"

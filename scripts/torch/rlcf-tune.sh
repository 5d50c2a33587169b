#!/bin/bash
# RLCF encoder TTA (reference: TPT/scripts/rlcf-tune.sh)
root=${1:-/data}
testsets=${2:-A}
python -m rlcf_torch.cli.tune_cls "$root" --test_sets "$testsets" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --tta_steps 3 --lr 1e-5 --batch_size 64 --selection_p 0.1 --sample_k 3 \
    --momentum_update 1 --update_freq 256 --episode_group 1 \
    --output "exp/torch/rlcf_tune_${testsets//\//_}"

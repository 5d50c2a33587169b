#!/bin/bash
# TPT-loss backbone tuning (reference: TPT/scripts/tpt-tune.sh -> tune_cls_tpt.py)
root=${1:-/data}
testsets=${2:-A/V/R/I/K}
python -m rlcf_torch.cli.tune_cls "$root" --test_sets "$testsets" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --loss tpt --tta_steps 3 --lr 1e-5 --weight_decay 5e-4 \
    --batch_size 64 --selection_p 0.1 --sample_k 3 \
    --momentum_update 0 --update_freq 256 --episode_group 1 \
    --output "exp/torch/tpt_tune_${testsets//\//_}"

#!/bin/bash
# Zero-shot eval (reference: TPT/scripts/zero-shot.sh)
root=${1:-/data}
testsets=${2:-A}
python -m rlcf_torch.cli.zero_shot "$root" --test_sets "$testsets" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --ctx_init a_photo_of_a --output "exp/torch/zero_shot_${testsets//\//_}"

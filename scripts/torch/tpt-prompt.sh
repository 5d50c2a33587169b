#!/bin/bash
# TPT entropy-minimization baseline (reference: TPT/scripts/tpt-prompt.sh)
root=${1:-/data}
testsets=${2:-A}
python -m rlcf_torch.cli.tta_cls "$root" --test_sets "$testsets" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --loss tpt --tta_steps 1 --lr 5e-3 --batch_size 64 --selection_p 0.1 \
    --ctx_init a_photo_of_a --output "exp/torch/tpt_prompt_${testsets//\//_}"

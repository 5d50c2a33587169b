#!/bin/bash
# RLCF prompt TTA on the 10 fine-grained sets (reference: rlcf-prompt-fine.sh)
root=${1:-/data}
python -m rlcf_torch.cli.tta_cls "$root" \
    --test_sets flower102/dtd/pets/cars/ucf101/caltech101/food101/sun397/aircraft/eurosat \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --loss rlcf --tta_steps 5 --lr 7e-3 --batch_size 64 --selection_p 0.1 \
    --sample_k 3 --ctx_init a_photo_of_a --output exp/torch/rlcf_prompt_fine

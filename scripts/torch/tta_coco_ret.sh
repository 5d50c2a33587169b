#!/bin/bash
# Retrieval TTA on COCO karpathy-test (reference: retrieval/scripts/tta_coco_ret.sh)
ann=${1:?annotation json}
imgs=${2:?image root}
python -m rlcf_torch.cli.tta_retrieval --annotations "$ann" --vis_root "$imgs" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --retrieval_task both --tta_steps 8 --lr 1e-6 --sample_k 12 \
    --output exp/torch/ret_coco

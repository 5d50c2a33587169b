#!/bin/bash
# Retrieval KD-TTA on COCO: distill the frozen reward CLIP row
# (reference: retrieval/scripts/tta_coco_ret_kd.sh -> clip_ret_kd.py)
ann=${1:?annotation json}
imgs=${2:?image root}
python -m rlcf_torch.cli.tta_retrieval --annotations "$ann" --vis_root "$imgs" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --retrieval_task both --loss kd --tta_steps 3 --lr 1e-6 --weight_decay 5e-4 \
    --sample_k_t2i 12 --sample_k_i2t 20 \
    --output exp/torch/ret_coco_kd

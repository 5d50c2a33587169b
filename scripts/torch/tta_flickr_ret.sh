#!/bin/bash
# Retrieval TTA on Flickr30k karpathy-test (reference: retrieval/scripts/tta_flickr_ret.sh)
ann=${1:?annotation json}
imgs=${2:?image root}
python -m rlcf_torch.cli.tta_retrieval --annotations "$ann" --vis_root "$imgs" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
    --retrieval_task both --tta_steps 8 --lr 1e-6 --weight_decay 5e-4 \
    --sample_k_t2i 12 --sample_k_i2t 16 \
    --momentum_update 0 --update_freq 32 --tta_momentum 0.9998 \
    --output exp/torch/ret_flickr

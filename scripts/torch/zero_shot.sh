#!/bin/bash
# Zero-shot retrieval eval on Flickr30k + COCO (reference: retrieval/scripts/zero_shot.sh)
# TTA-free: the same episode path with --tta_steps 0.
flickr_ann=${1:?flickr annotation json}
flickr_imgs=${2:?flickr image root}
coco_ann=${3:?coco annotation json}
coco_imgs=${4:?coco image root}
python -m rlcf_torch.cli.tta_retrieval --annotations "$flickr_ann" --vis_root "$flickr_imgs" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-B/16 --reward_checkpoint "${CLIP_VIT_B16:-}" \
    --retrieval_task both --tta_steps 0 --output exp/torch/zeroshot_flickr_ret
python -m rlcf_torch.cli.tta_retrieval --annotations "$coco_ann" --vis_root "$coco_imgs" \
    --arch ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
    --reward_arch ViT-B/16 --reward_checkpoint "${CLIP_VIT_B16:-}" \
    --retrieval_task both --tta_steps 0 --output exp/torch/zeroshot_coco_ret

#!/bin/bash
# CapDec caption TTA COCO->NoCaps, per-domain splits + merged report
# (reference: caption/scripts/tta_capdec_c2n.sh; splits from
#  tools/convert_caption_gt.py nocaps-splits)
ann_root=${1:?dir with nocaps_val_\{417_in,2670_near,1413_out\}-domain.json}
imgs=${2:?nocaps image root}
ckpt=${3:?supervised mapper checkpoint}
metrics=""
for split in val_417_in-domain val_2670_near-domain val_1413_out-domain; do
  out="exp/torch/capdec_c2n_${split}"
  python -m rlcf_torch.cli.tta_caption --annotations "$ann_root/nocaps_${split}.json" \
      --images_root "$imgs" \
      --checkpoint "$ckpt" --opt_checkpoint "${OPT_125M:-}" \
      ${OPT_VOCAB:+--opt_vocab "$OPT_VOCAB"} ${OPT_MERGES:+--opt_merges "$OPT_MERGES"} \
      --clip_model_type ViT-B/16 --clip_checkpoint "${CLIP_VIT_B16:-}" \
      --reward_arch ViT-L/14 --reward_checkpoint "${CLIP_VIT_L14:-}" \
      --dataset_mode 2 \
      --tta_steps 4 --tta_lr 3e-6 --sample_k 6 --output "$out"
  python -m rlcf_torch.cli.clipscore_eval "$out/results_clipscore.json" "$imgs" \
      --references_json "$ann_root/nocaps_${split}_clipscore.json" \
      --clip_checkpoint "${CLIP_VIT_B32:-}" --out_json "$out/metrics.json"
  metrics="$metrics $out/metrics.json"
done
python tools/nocaps_domain_report.py $metrics --out exp/torch/capdec_c2n_results_nocaps.json

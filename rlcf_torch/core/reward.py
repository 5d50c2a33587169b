"""Frozen CLIP reward models (CLIPScore) for TTA episodes (the counterpart
of ``rlcf_tpu/core/reward.py``): a frozen CLIP scores sampled classes with
``w * max(cos, 0)``, and the rewards are baseline-subtracted. A reward tower
at another resolution than the views gets them resized first; several towers
form a confidence-weighted ensemble (``CLIPRewardsMultiple``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models import clip as clip_model
from ..ops.image_ops import resize_bicubic_align_corners
from .losses import clipscore, rewards_post_process

# Ensemble confidence weights (`TPT/clip_reward.py:21-26`), normalized and
# rounded as the reference does (`:206`).
CONFIDENCE_WEIGHTS = {"ViT-L/14@336px": 10, "ViT-L/14": 5, "RN50x64": 3, "ViT-B/16": 1}


@dataclasses.dataclass
class RewardConfig:
    sample_k: int = 5
    clipscore_weight: float = 2.5
    reward_process: bool = True
    process_batch: bool = False
    amplify: bool = False
    default_resolution: int = 224


def reward_image_features(params, cfg: clip_model.ClipConfig, images, attn: str = "dense"):
    """Normalized image features [B, E] of normalized NHWC images, resized
    first (bicubic, aligned corners) where the tower takes another
    resolution (`TPT/clip_reward.py:130-137`)."""
    if images.shape[1] != cfg.image_resolution:
        images = resize_bicubic_align_corners(images, cfg.image_resolution)
    return clip_model.normalize(clip_model.encode_image(params, cfg, images, attn=attn).float())


def image_sim(params, cfg: clip_model.ClipConfig, class_features, images, attn: str = "dense"):
    """Cosine similarities [B, C] of normalized NHWC images against class
    features [C, E] (``reward_image_features``)."""
    return reward_image_features(params, cfg, images, attn) @ class_features.T


def _score(sims, sampled_idx, rcfg: RewardConfig, weights):
    """The weighted sum of the members' CLIPScores of sampled classes, then
    the shared post-processing; ``sims`` one [..., S, C] similarity a member."""
    combined = sum(w * clipscore(torch.gather(sim, -1, sampled_idx), rcfg.clipscore_weight)
                   for sim, w in zip(sims, weights))
    lead = combined.dim() - 2
    if rcfg.process_batch:
        combined = combined.reshape(combined.shape[:lead] + (-1,))
    return rewards_post_process(combined, rcfg.reward_process, rcfg.amplify, batch_dims=lead)


class ClipReward:
    """Single frozen CLIP reward model with cached class text features."""

    def __init__(self, params, cfg: clip_model.ClipConfig, rcfg: RewardConfig):
        self.params = params
        self.cfg = cfg
        self.rcfg = rcfg
        self.class_features: Optional[torch.Tensor] = None
        # the text tower's attention: the kernel on the card whatever the vision
        # tower is; a reward without weights only scores
        self.text_attn = clip_model.text_attn(self.device) if params is not None else "dense"

    @property
    def device(self) -> torch.device:
        return self.params["logit_scale"].device

    def set_class_features(self, tokenized, batch_size: int = 512):
        """Encode and cache normalized class (or caption gallery) text
        features [C, E] from token ids [C, 77] (the dead padded tail is dropped
        first; exact), and return them. A precomputed gallery (retrieval's
        image features) is set by assigning ``class_features``."""
        self.class_features = clip_model.encode_token_batches(
            self.params, self.cfg, clip_model.truncate_tokens(np.asarray(tokenized)), batch_size, self.text_attn)
        return self.class_features

    def text_features(self, tokens):
        """Normalized text features [..., E] of token ids [..., T]."""
        lead = tokens.shape[:-1]
        feats = clip_model.encode_text(self.params, self.cfg, tokens.reshape(-1, tokens.shape[-1]),
                                       attn=self.text_attn)
        return clip_model.normalize(feats.float()).reshape(*lead, -1)

    def image_sim(self, images, attn: str = "dense"):
        """Cosine similarities [B, C] of normalized NHWC images against the
        cached class features."""
        return image_sim(self.params, self.cfg, self.class_features, images, attn)

    def score_samples(self, sim, sampled_idx):
        """CLIPScore of sampled classes: sim [..., S, C], sampled_idx
        [..., S, K] -> rewards [..., S*K], post-processed per sample (or
        across the S*K batch with ``process_batch``)."""
        return _score([sim], sampled_idx, self.rcfg, [1.0])


class ClipRewardEnsemble:
    """Confidence-weighted multi-CLIP reward (`CLIPRewardsMultiple`,
    `TPT/clip_reward.py:180-307`): each member scores with its own tower at
    its own resolution, the weighted CLIPScores are summed, then
    post-processed once."""

    def __init__(self, members: List[ClipReward], rcfg: RewardConfig, weighted: bool = True):
        self.members = members
        self.rcfg = rcfg
        raw = [CONFIDENCE_WEIGHTS.get(m.cfg.name, 1) for m in members]
        total = sum(raw)
        self.weights = [round(w / total, 2) for w in raw] if weighted else [1.0 / len(members)] * len(members)

    def set_class_features(self, tokenized):
        for m in self.members:
            m.set_class_features(tokenized)

    def score_samples(self, sims, sampled_idx):
        """``sims``: a list of the members' [..., S, C] similarities, or
        them stacked on the axis before S ([..., M, S, C]); sampled_idx
        [..., S, K] -> rewards [..., S*K] (`TPT/clip_reward.py:227-257`)."""
        if not isinstance(sims, (list, tuple)):
            sims = sims.unbind(dim=-3)
        return _score(sims, sampled_idx, self.rcfg, self.weights)


def build_reward_model(arch: str = "ViT-L/14", rcfg: Optional[RewardConfig] = None, checkpoint: Optional[str] = None,
                       rng_seed: int = 0, dtype=torch.float32, device="cpu") -> ClipReward:
    """A reward model (ViT or ResNet) from an OpenAI checkpoint, or random
    weights from ``rng_seed``."""
    rcfg = rcfg or RewardConfig()
    if checkpoint:
        from ..models.convert import load_clip_checkpoint

        params, cfg = load_clip_checkpoint(checkpoint, dtype=dtype, device=device)
    else:
        cfg = clip_model.get_config(arch)
        params = clip_model.init_clip_params(cfg, seed=rng_seed, dtype=dtype, device=device)
    return ClipReward(params, cfg, rcfg)

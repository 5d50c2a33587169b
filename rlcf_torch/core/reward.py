"""Frozen CLIP reward model (CLIPScore) for TTA episodes (the counterpart
of ``rlcf_tpu/core/reward.py``; the multi-model ensemble is not ported
yet). A frozen CLIP scores sampled classes with ``w * max(cos, 0)``, and
the rewards are baseline-subtracted.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import clip as clip_model
from .losses import clipscore, rewards_post_process


@dataclasses.dataclass
class RewardConfig:
    sample_k: int = 5
    clipscore_weight: float = 2.5
    reward_process: bool = True
    process_batch: bool = False
    amplify: bool = False
    default_resolution: int = 224


class ClipReward:
    """Single frozen CLIP reward model with cached class text features."""

    def __init__(self, params, cfg: clip_model.ClipConfig, rcfg: RewardConfig):
        self.params = params
        self.cfg = cfg
        self.rcfg = rcfg
        self.class_features: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.params["logit_scale"].device

    @torch.no_grad()
    def set_class_features(self, tokenized, batch_size: int = 512):
        """Encode and cache normalized class text features [C, E] from token
        ids [C, 77] (the dead padded tail is dropped first; exact)."""
        tokenized = np.asarray(tokenized)
        t_max = int(tokenized.argmax(axis=-1).max()) + 1
        tokenized = tokenized[:, : min(tokenized.shape[1], -(-t_max // 8) * 8)].astype(np.int64)
        chunks = []
        for start in range(0, tokenized.shape[0], batch_size):
            toks = torch.as_tensor(tokenized[start : start + batch_size], device=self.device)
            chunks.append(clip_model.encode_text(self.params, self.cfg, toks))
        self.class_features = clip_model.normalize(torch.cat(chunks).float())
        return self.class_features

    def score_samples(self, sim, sampled_idx):
        """CLIPScore of sampled classes: sim [..., S, C], sampled_idx
        [..., S, K] -> rewards [..., S*K], post-processed per sample (or
        across the S*K batch with ``process_batch``)."""
        scores = clipscore(torch.gather(sim, -1, sampled_idx), self.rcfg.clipscore_weight)
        lead = scores.dim() - 2
        if self.rcfg.process_batch:
            scores = scores.reshape(scores.shape[:lead] + (-1,))
        return rewards_post_process(scores, self.rcfg.reward_process, self.rcfg.amplify, batch_dims=lead)


def build_reward_model(arch: str = "ViT-L/14", rcfg: Optional[RewardConfig] = None, checkpoint: Optional[str] = None,
                       rng_seed: int = 0, dtype=torch.float32, device="cpu") -> ClipReward:
    """A reward model from an OpenAI checkpoint, or random weights from ``rng_seed``."""
    rcfg = rcfg or RewardConfig()
    if checkpoint:
        from ..models.convert import load_clip_checkpoint

        params, cfg = load_clip_checkpoint(checkpoint, dtype=dtype, device=device)
    else:
        cfg = clip_model.get_config(arch)
        params = clip_model.init_clip_params(cfg, seed=rng_seed, dtype=dtype, device=device)
    return ClipReward(params, cfg, rcfg)

"""Episode pieces: configuration, optimizer and per-step loss (the
counterpart of ``rlcf_tpu/core/episode.py``).

The JAX package vmaps one episode over the test stream. Here N episodes
share one batch axis: the trainable context is one ``[N, n_ctx, D]`` tensor,
the loss is the SUM of the N per-episode losses (so each episode's slice of
the gradient is its own loss's gradient), and AdamW, being elementwise,
then takes exactly N independent ``optax.adamw`` steps. A fresh optimizer per
group of episodes is the reference's per-sample weight/optimizer reset.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import losses as Lo


@dataclasses.dataclass(frozen=True)
class EpisodeConfig:
    tta_steps: int = 3
    selection_p: float = 0.1
    lr: float = 5e-3
    weight_decay: float = 5e-4
    loss: str = "rlcf"  # rlcf | tpt | kd | dkd | atkd
    sample_k: int = 5
    min_entropy_reg: bool = False
    min_entropy_w: float = 0.1
    adam_eps: float = 1e-8


def make_optimizer(params, ecfg: EpisodeConfig) -> torch.optim.AdamW:
    """AdamW with torch defaults (betas 0.9/0.999, decoupled weight decay),
    `TPT/tpt_cls_rl.py:120`; equal to ``optax.adamw`` step for step."""
    return torch.optim.AdamW(params, lr=ecfg.lr, betas=(0.9, 0.999), eps=ecfg.adam_eps,
                             weight_decay=ecfg.weight_decay)


def step_loss(logits, reward_sim, ecfg: EpisodeConfig, score_samples: Optional[Callable], teacher_scale=None):
    """Per-episode loss on the selected views' logits [..., S, C].

    ``reward_sim`` [..., S, C]: frozen reward cosine sims of the selected
    views; ``score_samples(sim, idx)`` turns them into processed rewards.
    Returns one loss per leading index.
    """
    if ecfg.loss == "rlcf":
        idx = Lo.top_k_indices(logits.detach(), ecfg.sample_k)  # [..., S, K]
        with torch.no_grad():
            rewards = score_samples(reward_sim, idx)
        loss = Lo.reinforce_loss(logits, idx, rewards)
        if ecfg.min_entropy_reg:
            loss = loss + ecfg.min_entropy_w * Lo.avg_entropy(logits)
        return loss
    if ecfg.loss == "tpt":
        return Lo.avg_entropy(logits)
    teacher = (teacher_scale * reward_sim).detach()
    if ecfg.loss == "kd":
        # gradient-equivalent part of the KL (`TPT/utils/KD.py:19-29`)
        p_t = F.softmax(teacher, dim=-1)
        return (-(p_t * F.log_softmax(logits, dim=-1)).sum(dim=-1)).mean(dim=-1)
    if ecfg.loss == "dkd":
        return Lo.dkd_loss(logits, teacher, teacher.argmax(dim=-1))
    if ecfg.loss == "atkd":
        return Lo.atkd_loss(logits, teacher)
    raise ValueError(ecfg.loss)

"""TTA losses: CLIP-reward REINFORCE, marginal entropy (TPT) and the KD
family (the counterpart of ``rlcf_tpu/core/losses.py``).

Every function works on the trailing axes and keeps any leading batch axes
(one per episode), so N episodes run as one batched computation; on
unbatched inputs each equals its JAX counterpart.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def entropy_per_sample(logits):
    """H(softmax(logits)) per row, from log-probs. [.., C] -> [..]"""
    logp = F.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def select_confident_entropy(ent, n_keep: int):
    """Indices of the ``n_keep`` lowest entropies along the last axis, ties
    broken by ascending index (as ``lax.top_k`` does; a stable sort makes
    that explicit, where ``torch.topk`` promises no order on the card)."""
    return torch.sort(ent, dim=-1, stable=True).indices[..., :n_keep]


def top_k_indices(x, k: int):
    """Indices of the k largest along the last axis, ties by ascending index."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def avg_entropy(logits):
    """Entropy of the view-averaged distribution: [..., S, C] -> [...]."""
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    avg_logp = torch.logsumexp(logp, dim=-2) - math.log(logp.shape[-2])
    avg_logp = torch.clamp(avg_logp, min=torch.finfo(avg_logp.dtype).min)
    return -(avg_logp * avg_logp.exp()).sum(dim=-1)


def rewards_post_process(scores, reward_process: bool = True, amplify: bool = False, eps: float = 1e-5,
                         batch_dims: int = 0):
    """Baseline-subtract (optionally standardize with the Bessel-corrected
    std, as torch.std in the reference) along the last axis, then flatten
    every axis after the first ``batch_dims``."""
    if scores.shape[-1] > 1 and reward_process:
        mean = scores.mean(dim=-1, keepdim=True)
        std = scores.std(dim=-1, keepdim=True, correction=1) + eps if amplify else 1.0
        scores = (scores - mean) / std
    return scores.reshape(scores.shape[:batch_dims] + (-1,))


def clipscore(similarity, weight: float = 2.5):
    """CLIPScore = weight * max(cos, 0)."""
    return weight * torch.clamp(similarity, min=0.0)


def reinforce_loss(logits, sampled_idx, rewards):
    """mean(rewards * CE) over (row, sample) pairs: logits [..., B, C],
    sampled_idx [..., B, K], rewards [..., B*K] -> [...]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, sampled_idx)
    return (rewards.reshape(sampled_idx.shape) * ce).mean(dim=(-2, -1))


# ---------------------------------------------------------------------------
# KD family (teacher = frozen reward CLIP logits); rows on axis -2
# ---------------------------------------------------------------------------


def kd_loss(logits_student, logits_teacher, t_stu: float = 1.0, t_tea: float = 1.0):
    """Vanilla KD: KLDiv(teacher || student) * T_stu^2, batchmean."""
    logp_s = F.log_softmax(logits_student / t_stu, dim=-1)
    logp_t = F.log_softmax(logits_teacher / t_tea, dim=-1)
    kl = (logp_t.exp() * (logp_t - logp_s)).sum(dim=-1)
    return kl.mean(dim=-1) * t_stu * t_stu


def dkd_loss(logits_student, logits_teacher, target, alpha: float = 1.0, beta: float = 0.5,
             temperature: float = 1.0):
    """Decoupled KD (target/non-target split), `TPT/utils/DKD.py:13-37`."""
    B, C = logits_student.shape[-2:]
    gt_mask = F.one_hot(target, C).to(logits_student.dtype)
    p_s = F.softmax(logits_student / temperature, dim=-1)
    p_t = F.softmax(logits_teacher / temperature, dim=-1)

    def two_bin(p):
        t1 = (p * gt_mask).sum(dim=-1, keepdim=True)
        return torch.cat([t1, 1.0 - t1], dim=-1)

    b_s, b_t = two_bin(p_s), two_bin(p_t)
    tckd = (b_t * (torch.log(b_t + 1e-12) - torch.log(b_s + 1e-12))).sum(dim=(-2, -1)) * temperature**2 / B
    masked_s = F.log_softmax(logits_student / temperature - 1000.0 * gt_mask, dim=-1)
    masked_t_logp = F.log_softmax(logits_teacher / temperature - 1000.0 * gt_mask, dim=-1)
    nckd = (masked_t_logp.exp() * (masked_t_logp - masked_s)).sum(dim=(-2, -1)) * temperature**2 / B
    return alpha * tckd + beta * nckd


def atkd_loss(logits_student, logits_teacher, multiplier: float = 2.0, eps: float = 1e-5):
    """Adaptive-temperature KD v1 (`TPT/utils/ATKD.py:12-33`): per-row
    standardized logits (biased std, no gradient through the student's
    statistics), KL rescaled by the student's variance."""
    s_mu = logits_student.mean(dim=-1, keepdim=True).detach()
    s_std = logits_student.std(dim=-1, keepdim=True, correction=0).detach()
    t_mu = logits_teacher.mean(dim=-1, keepdim=True)
    t_std = logits_teacher.std(dim=-1, keepdim=True, correction=0)
    logp_s = F.log_softmax((logits_student - s_mu) / (s_std + eps) * multiplier, dim=-1)
    logp_t = F.log_softmax((logits_teacher - t_mu) / (t_std + eps) * multiplier, dim=-1)
    kl = logp_t.exp() * (logp_t - logp_s) * s_std * s_std
    return kl.sum(dim=-1).mean(dim=-1)

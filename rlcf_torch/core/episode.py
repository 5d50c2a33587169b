"""The TTA episode engine: configuration, optimizer, per-step loss and the
generic episode (the counterpart of ``rlcf_tpu/core/episode.py``).

The JAX package vmaps one episode over the test stream. Here N episodes
share one batch axis: each trainable tensor carries a leading episode axis
(the prompt context ``[N, n_ctx, D]``, a tower's weights ``[N, ...]``), the
loss is the SUM of the N per-episode losses (so each episode's slice of the
gradient is its own loss's gradient), and AdamW, being elementwise, then
takes exactly N independent ``optax.adamw`` steps. A fresh optimizer per
group of episodes is the reference's per-sample weight/optimizer reset.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import group, span
from . import losses as Lo
from .policy import tree_leaves, tree_map


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
    `TPT/tpt_cls_rl.py:120`; equal to ``optax.adamw`` step for step within
    float32 roundings. The episodes that step a tower or a mapper (encoder
    TTA, retrieval, caption TTA: one to a few hundred tensors) take it for
    its foreach path, a handful of launches a step where ``adamw_step`` takes
    16 a tensor on host-bound paths; the episodes of one or two tensors, which a
    graph capture must trace, take ``adamw_step``."""
    return torch.optim.AdamW(params, lr=ecfg.lr, betas=(0.9, 0.999), eps=ecfg.adam_eps,
                             weight_decay=ecfg.weight_decay)


def adamw_init(params):
    """A fresh functional AdamW state for ``params``: (first, second) moments."""
    return [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]


def adamw_step(params, grads, state, count: int, lr: float, weight_decay: float = 0.0, eps: float = 1e-8,
               betas=(0.9, 0.999)):
    """One AdamW step out of place, as ``optax.adamw`` takes it op for op in
    float32: the moments, the bias corrections ``1 - b**count`` in float32
    (``torch.optim.AdamW`` takes them in float64, which moves a step by up to
    ~1e-5 relative at small counts), eps outside the square root, the decay
    added after the normalisation, then the rate. ``count`` >= 1 counts the
    steps with this one. Plain tensor ops, which a graph capture traces (the
    foreach path of ``torch.optim.AdamW`` does not). The prompt episodes,
    Bongard's and ``core/runner.py`` take it. Returns (params, state)."""
    (b1, b2), f32 = betas, np.float32
    bc1, bc2 = (float(f32(1) - f32(b) ** f32(count)) for b in betas)
    out, mus, nus = [], [], []
    for p, g, mu, nu in zip(params, grads, *state):
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * (g * g)
        update = (mu / bc1) / ((nu / bc2).sqrt() + eps)
        if weight_decay:
            update = update + weight_decay * p
        out.append(p + update * -lr)
        mus.append(mu)
        nus.append(nu)
    return out, (mus, nus)


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


def take_rows(x, idx):
    """Rows ``idx [N, k]`` of ``x [N, B, ...]`` per episode -> ``[N, k, ...]``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def make_tta_episode(
    policy_logits: Callable,
    reward_image_sim: Callable,
    score_samples: Callable,
    ecfg: EpisodeConfig,
    predict_batched: bool = False,
    teacher_scale=None,
    return_adapted: bool = False,
    step0_reuse: Optional[bool] = None,
):
    """Build the generic episode function for N episodes at once.

    Args:
      policy_logits(trainable, cache, idx) -> [N, k, C] logits of the views
        ``idx [N, k]``; ``trainable`` is a nested dict of per-episode tensors
        ``[N, ...]`` (None leaves allowed), differentiable; computing on the
        selected views only keeps encoder-TTA steps to S-view forwards.
      reward_image_sim(views_selected [N, S, ...]) -> [N, S, C] frozen reward
        similarities.
      score_samples(sim, idx) -> processed rewards.
      predict_batched: if True the final prediction covers every view;
        otherwise view 0 only (`tpt_cls_rl.py:260-262`).

    Returns ``episode(trainable0, cache, views [N, B, ...], per_episode=False)
    -> (final_logits [N, 1 or B, C], aux)``; every episode starts from the
    same ``trainable0`` (one episode's tensors, no episode axis) or, with
    ``per_episode``, from its own (leaves ``[N, ...]``: CoCoOp's
    instance-conditioned contexts), and a fresh AdamW state. ``aux``:
    ``losses [N, steps]``, ``selected [N, S]`` and, with ``return_adapted``,
    ``adapted`` (the N adapted tensors, detached).

    Step 0, as in the JAX package: when the selection keeps every view (or
    ``step0_reuse``) the selection forward is differentiated and its graph
    serves the first gradient (the masked-cotangent VJP: only the selected
    rows' logits get a cotangent); otherwise the B-view selection forward
    runs under ``torch.no_grad()`` (no activations kept) and every step
    recomputes the forward on the S selected views (3 fwd(S) against 2
    fwd(B) of masked backward whenever S < 2B/3: encoder TTA).
    """

    def episode(trainable0, cache, views, per_episode=False):
        with group():
            return run(trainable0, cache, views, per_episode)

    def run(trainable0, cache, views, per_episode):
        N, B = views.shape[:2]
        n_keep = max(1, int(B * ecfg.selection_p))
        all_idx = torch.arange(B, device=views.device).expand(N, B)
        reuse = n_keep >= B if step0_reuse is None else step0_reuse
        start = (lambda v: v.detach()) if per_episode else (lambda v: v.detach()[None].expand(N, *v.shape))
        t = tree_map(lambda v: start(v).clone().requires_grad_(True), trainable0)
        with span("select"):
            with torch.set_grad_enabled(reuse):
                logits_all = policy_logits(t, cache, all_idx)
            sel = Lo.select_confident_entropy(Lo.entropy_per_sample(logits_all.detach()), n_keep)  # [N, S]
        with torch.no_grad(), span("reward_fwd"):
            reward_sim = reward_image_sim(take_rows(views, sel))  # [N, S, C], frozen
        pred_idx = all_idx if predict_batched else all_idx[:, :1]
        aux = {"selected": sel}
        losses = []
        if ecfg.tta_steps > 0:
            opt = make_optimizer(tree_leaves(t), ecfg)
            for step in range(ecfg.tta_steps):
                with span("step", step + 1):
                    opt.zero_grad(set_to_none=True)
                    with span("policy_fwd"):
                        logits = take_rows(logits_all, sel) if reuse and step == 0 else policy_logits(t, cache, sel)
                        loss = step_loss(logits, reward_sim, ecfg, score_samples, teacher_scale)  # [N]
                    with span("bwd"):
                        loss.sum().backward()
                    with span("adamw"):
                        opt.step()
                losses.append(loss.detach())
        del logits_all
        with torch.no_grad(), span("final"):
            final = policy_logits(t, cache, pred_idx)
        aux["losses"] = torch.stack(losses, dim=1) if losses else torch.zeros((N, 0), device=final.device)
        if return_adapted:
            aux["adapted"] = tree_map(lambda v: v.detach(), t)
        return final, aux

    return episode

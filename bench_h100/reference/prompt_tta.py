"""Plain RLCF prompt TTA (the reference's ``TPT/tpt_cls_rl.py`` with its
CoOp prompt learner and ``clip_reward.py``), on OpenAI-format state dicts.

Per test image: the frozen policy encodes every view; the ``selection_p``
lowest-entropy views (against the initial prompt's class features) are kept;
the frozen reward CLIP (or the confidence-weighted ensemble) scores the
policy's top ``sample_k`` classes of each kept view with CLIPScore
(``2.5 * max(cos, 0)``), minus their mean; ``tta_steps`` steps of AdamW move
the prompt's context vectors by REINFORCE; the adapted prompt then classifies
view 0. Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import clip
from .tokenizer import tokenize

CLIPSCORE_WEIGHT = 2.5


def class_prompts(classnames, prefix: str):
    prefix = prefix.replace("_", " ")
    return [f"{prefix} {name.replace('_', ' ')}." for name in classnames]


def confidence_weights(members):
    """The ensemble's weights: each member's confidence over their sum,
    rounded to two decimals (``clip_reward.py``'s ``CLIPRewardsMultiple``)."""
    total = sum(m["confidence"] for m in members)
    return [round(m["confidence"] / total, 2) for m in members]


class PromptTTAReference:
    """The reference of one configuration on one seed's weights.

    ``towers``: ``[(state_dict, tower_config), ...]``, the policy first, then
    the reward members; ``traffic``: the traffic file's ``episode`` and
    ``classes``; ``prec``: ``clip.Prec``."""

    def __init__(self, towers, traffic, prec, state_dtype=torch.float32):
        self.prec, self.state_dtype = prec, state_dtype
        self.diag = {}
        (self.psd, self.pcfg), self.reward_towers = towers[0], towers[1:]
        ep = traffic["episode"]
        self.ep = ep
        self.weights = confidence_weights([c for _, c in self.reward_towers]) if len(self.reward_towers) > 1 else [1.0]
        prompts = class_prompts(traffic["classes"], ep["ctx_init"])
        tokens = torch.as_tensor(tokenize(prompts), dtype=torch.long)
        self.eot = tokens.argmax(dim=-1)
        T = int(self.eot.max()) + 1
        dev = self.psd["logit_scale"].device
        self.tokens = tokens[:, :T].to(dev)
        self.eot = self.eot.to(dev)
        self.n_ctx = int((torch.as_tensor(tokenize(ep["ctx_init"].replace("_", " "))[0]) > 0).sum()) - 2
        self.embeds = self.psd["token_embedding.weight"][self.tokens].float()      # [C, T, D]
        self.ctx0 = self.embeds[0, 1:1 + self.n_ctx].clone()                      # the words of ctx_init
        self.scale = float(self.psd["logit_scale"].float().exp())
        with torch.no_grad():
            self.tf0 = self.text_features(self.ctx0[None])[0]                      # [C, E]
            self.reward_feats = [clip.normalize(clip.encode_text_embeds(
                sd, cfg, sd["token_embedding.weight"][self.tokens].float(), self.eot, prec))
                for sd, cfg in self.reward_towers]

    def text_features(self, ctx):
        """Normalized class features ``[N, C, E]`` of the prompts whose context
        words are ``ctx [N, n_ctx, D]``."""
        N = ctx.shape[0]
        C, T, D = self.embeds.shape
        emb = self.embeds[None].expand(N, C, T, D)
        emb = torch.cat([emb[:, :, :1], ctx[:, None].expand(N, C, self.n_ctx, D), emb[:, :, 1 + self.n_ctx:]], dim=2)
        feats = clip.encode_text_embeds(self.psd, self.pcfg, emb.reshape(N * C, T, D), self.eot.repeat(N), self.prec)
        return clip.normalize(feats).reshape(N, C, -1)

    @torch.no_grad()
    def policy_features(self, views_nchw):
        """Normalized policy features ``[B, E]`` of normalized NCHW views."""
        return clip.normalize(clip.encode_image(self.psd, self.pcfg, views_nchw, self.prec))

    def entropies(self, feats, class_feats=None, lowp: bool = False):
        """Entropy of each view's class distribution against the initial
        prompt's class features (``class_feats``, by default the
        reference's): ``[..., B]``, in float32, or with ``lowp`` in bfloat16."""
        tf0 = self.tf0 if class_feats is None else class_feats
        if lowp:
            logits = self.scale * feats.bfloat16() @ tf0.bfloat16().T
            logp = F.log_softmax(logits, dim=-1)
            return (-(logp.exp() * logp).sum(dim=-1)).float()
        logp = F.log_softmax(self.scale * feats @ tf0.T, dim=-1)
        return -(logp.exp() * logp).sum(dim=-1)

    def n_keep(self, n_views: int) -> int:
        return max(1, int(n_views * self.ep["selection_p"]))

    def select(self, ent):
        """The lowest-entropy views ``[N, S]``, ties by index."""
        return torch.sort(ent, dim=-1, stable=True).indices[..., :self.n_keep(ent.shape[-1])]

    @torch.no_grad()
    def reward_sims(self, sel_views_nchw):
        """Each reward tower's cosine similarities ``[M, B, C]`` of normalized
        NCHW views, each tower taking them resized (bicubic, aligned corners)
        to its own resolution."""
        out, norms = [], []
        for (sd, cfg), feats in zip(self.reward_towers, self.reward_feats):
            x = sel_views_nchw
            if x.shape[-1] != cfg["image_resolution"]:
                x = F.interpolate(x, size=(cfg["image_resolution"],) * 2, mode="bicubic", align_corners=True)
            f = clip.encode_image(sd, cfg, x, self.prec)
            norms.append(float(f.norm(dim=-1).mean()))
            out.append(clip.normalize(f) @ feats.T)
        self.diag = {"norms": norms, "sim_mean": [float(o.mean()) for o in out]}
        return torch.stack(out)

    def scores(self, sims, idx):
        """Processed rewards ``[N, S, K]`` of the sampled classes ``idx``:
        ``sims [M, N, S, C]``."""
        score = sum(w * CLIPSCORE_WEIGHT * torch.clamp(torch.gather(s, -1, idx), min=0.0)
                    for w, s in zip(self.weights, sims))
        return score - score.mean(dim=-1, keepdim=True)

    def top_k(self, logits):
        """The ``sample_k`` classes of highest logit ``[..., K]``, ties by index."""
        return torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :self.ep["sample_k"]]

    def step_grad(self, ctx, sel_feats, sims, idx=None):
        """One REINFORCE step at the contexts ``ctx [N, n_ctx, D]`` on the kept
        views' policy features ``sel_feats [N, S, E]`` and reward similarities
        ``sims [M, N, S, C]``: (the gradient of the episodes' losses in the
        contexts, the logits ``[N, S, C]``, the sampled classes ``[N, S, K]``:
        ``idx`` where given, else the top ``sample_k``)."""
        ctx = ctx.detach().float().requires_grad_(True)
        with torch.enable_grad():
            logits = self.scale * torch.einsum("nse,nce->nsc", sel_feats, self.text_features(ctx))
            idx = self.top_k(logits.detach()) if idx is None else idx
            with torch.no_grad():
                r = self.scores(sims, idx)
            ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, idx)
            loss = (r * ce).mean(dim=(-2, -1))
            grad, = torch.autograd.grad(loss.sum(), ctx)
        return grad, logits.detach(), idx

    @torch.no_grad()
    def adamw(self, ctx, grad, state, step: int, lowp: bool = False):
        """AdamW's step ``step`` (from 1) of ``ctx`` on ``grad`` from ``state``
        (None at the first step), as ``optax.adamw`` takes it: the moments,
        the bias corrections ``1 - b**step`` in float32, eps outside the square
        root, the decay after the normalisation, then the rate; each operation
        in ``state_dtype``, the context's own (the prompt's words keep the
        token embedding's type). Returns (the new context, the new state) in
        float32. ``lowp`` rounds the context and the moments to float8 after
        the step (the control)."""
        b1, b2, eps, f32 = 0.9, 0.999, 1e-8, np.float32
        bc1, bc2 = (float(f32(1) - f32(b) ** f32(step)) for b in (b1, b2))
        ctx, grad = ctx.to(self.state_dtype), grad.to(self.state_dtype)
        mu, nu = ((torch.zeros_like(ctx), torch.zeros_like(ctx)) if state is None else
                  (state[0].to(self.state_dtype), state[1].to(self.state_dtype)))
        mu = b1 * mu + (1 - b1) * grad
        nu = b2 * nu + (1 - b2) * (grad * grad)
        update = (mu / bc1) / ((nu / bc2).sqrt() + eps)
        if self.ep["weight_decay"]:
            update = update + self.ep["weight_decay"] * ctx
        out = [(ctx + update * -self.ep["lr"]).float(), mu.float(), nu.float()]
        if lowp:
            out = [clip.to_fp8(t) for t in out]
        return out[0], (out[1], out[2])

    def episodes(self, img_feats, sel, sims, record=None, lowp_state: bool = False):
        """``tta_steps`` REINFORCE + AdamW steps of N episodes from the initial
        context: ``img_feats [N, B, E]``, ``sel [N, S]``, ``sims [M, N, S, C]``
        -> (final logits ``[N, C]`` of view 0, initial logits ``[N, C]``, the
        adapted prompts' class features ``[N, C, E]``). ``record``: a list that
        takes each step's ``(context, gradient, sampled classes)``;
        ``lowp_state``: the optimizer's state in float8."""
        N, _, E = img_feats.shape
        sel_feats = torch.gather(img_feats, 1, sel[..., None].expand(-1, -1, E))
        ctx, state = self.ctx0[None].repeat(N, 1, 1), None
        for step in range(1, self.ep["tta_steps"] + 1):
            grad, _, idx = self.step_grad(ctx, sel_feats, sims)
            if record is not None:
                record.append((ctx.clone(), grad, idx))
            ctx, state = self.adamw(ctx, grad, state, step, lowp=lowp_state)
        with torch.no_grad():
            tf = self.text_features(ctx)
            final = self.scale * torch.einsum("ne,nce->nc", img_feats[:, 0], tf)
            initial = self.scale * img_feats[:, 0] @ self.tf0.T
        return final, initial, tf

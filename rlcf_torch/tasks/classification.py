"""Classification: zero-shot evaluation, single and ensembled, and
test-time adaptation (RLCF / TPT / KD episodes): prompt TTA on patch-major u8
views or NHWC views, encoder TTA on NHWC views, and CoCoOp's
instance-conditioned prompt TTA on NHWC views (the counterpart of
``rlcf_tpu/tasks/classification.py``; serving and the device mesh are not
ported yet).

Prompt TTA, per group of N test images: the frozen policy encodes all
views of each image, the lowest-entropy views are selected against the
initial text features, the frozen reward CLIP (or a confidence-weighted
ensemble of them, each at its own resolution) scores only those, and N
episodes of REINFORCE + AdamW on the CoOp context run as one batch: the text
tower sees all N*C prompts at once, forward and backward. The policy may be a
ViT or, on NHWC views, a ModifiedResNet; only the text tower is
differentiated.

Encoder TTA adapts the policy's visual tower itself against frozen class
text features: the N episodes' tower weights are stacked on a leading
episode axis (``models/layers.py``), so each step is one batched forward
and backward over the N episodes' selected views.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import losses as Lo
from ..core import prompt as P
from ..core import policy as Po
from ..core.episode import make_optimizer, make_tta_episode, step_loss, take_rows
from ..data.class_names import assemble_prompts
from ..data.transforms import CLIP_MEAN, CLIP_STD
from ..metrics.classification import AccuracyMeter
from ..models import clip as clip_model
from ..ops.image_ops import resize_bicubic_align_corners
from ..tokenizer import tokenize


def maybe_normalize_u8(views):
    """CLIP-normalize raw uint8 NHWC views; float views pass through."""
    if views.dtype == torch.uint8:
        mean = torch.as_tensor(CLIP_MEAN, device=views.device)
        std = torch.as_tensor(CLIP_STD, device=views.device)
        return (views.float() / 255.0 - mean) / std
    return views


def patch_norm_constants(patch_dim: int, device="cpu"):
    """Per-column CLIP mean/std for patch-major u8 tokens [.., T, patch_dim]:
    column j is channel ``j % 3`` (patch pixels flatten (row, col, channel))."""
    reps = patch_dim // 3
    return (torch.as_tensor(np.tile(CLIP_MEAN, reps), device=device),
            torch.as_tensor(np.tile(CLIP_STD, reps), device=device))


def normalize_u8_patch_tokens(tokens):
    """u8 patch-major tokens [..., T, D] -> CLIP-normalized float32."""
    mean, std = patch_norm_constants(tokens.shape[-1], tokens.device)
    return (tokens.float() / 255.0 - mean) / std


def truncate_tokens(tokens: np.ndarray) -> np.ndarray:
    """Drop the all-padding tail: causal attention + EOT pooling make
    positions past max(eot) dead compute (exact, not approximate)."""
    t_max = int(tokens.argmax(axis=-1).max()) + 1
    t_max = min(tokens.shape[1], -(-t_max // 8) * 8)
    return tokens[:, :t_max]


@torch.no_grad()
def compute_class_features(params, cfg, classnames: Sequence[str], prompt_prefix: str = "a photo of a",
                           batch_size: int = 256, attn: str = "dense"):
    """Normalized class text features [C, E], computed in batches."""
    tokens = truncate_tokens(tokenize(assemble_prompts(classnames, prompt_prefix))).astype(np.int64)
    device = params["logit_scale"].device
    feats = [clip_model.encode_text(params, cfg, torch.as_tensor(tokens[s : s + batch_size], device=device),
                                    attn=attn)
             for s in range(0, tokens.shape[0], batch_size)]
    return clip_model.normalize(torch.cat(feats).float())


def classify_logits(params, cfg, images, class_features, attn: str = "dense"):
    """Cosine-similarity logits [B, C] of normalized NHWC images."""
    img = clip_model.normalize(clip_model.encode_image(params, cfg, images, attn=attn).float())
    return params["logit_scale"].exp().float() * (img @ class_features.T)


def resize_bicubic_batch(images, resolution: int):
    """Per-model input resizing for ensembles (`custom_clip.py:541-543`):
    bicubic with aligned corners, as torch's."""
    return resize_bicubic_align_corners(images, resolution)


@torch.no_grad()
def zero_shot_eval(params, cfg, dataset, classnames: Sequence[str], prompt_prefix: str = "a photo of a",
                   batch_size: int = 64, resolution: int = 224, limit: Optional[int] = None, seed: int = 0) -> dict:
    """Zero-shot top-1/top-5 over a dataset loader (`TPT/zero_shot.py`)."""
    return zero_shot_eval_ensemble([(params, cfg)], dataset, classnames, prompt_prefix, batch_size, resolution,
                                   limit, seed)


@torch.no_grad()
def zero_shot_eval_ensemble(models: List, dataset, classnames: Sequence[str], prompt_prefix: str = "a photo of a",
                            batch_size: int = 64, resolution: int = 224, limit: Optional[int] = None,
                            seed: int = 0) -> dict:
    """Logit-averaged multi-architecture ensemble (`custom_clip.py:555-566`)
    of ``models``, a list of (params, cfg): each model takes the batch
    resized to its own resolution. One model is ``zero_shot_eval``."""
    from ..data.datasets import iter_batches

    device = models[0][0]["logit_scale"].device
    attn = clip_model.best_attn(None, device)
    feats = [compute_class_features(p, c, classnames, prompt_prefix, attn=attn) for p, c in models]
    meter = AccuracyMeter()
    for images, labels in iter_batches(dataset, batch_size, resolution, shuffle=True, seed=seed, limit=limit):
        x = torch.as_tensor(images).to(device)
        logits = [classify_logits(p, c, x if c.image_resolution == resolution else resize_bicubic_batch(
            x, c.image_resolution), cf, attn) for (p, c), cf in zip(models, feats)]
        logits = logits[0] if len(logits) == 1 else torch.stack(logits).mean(dim=0)
        meter.update(logits.cpu().numpy(), labels)
    return meter.summary()


def prompt_text_features(clip_params, clip_cfg, pt, ctx, attn: str = "dense", cls=None):
    """Normalized class text features [N, C, E] of the prompt template ``pt``
    (``core/prompt.py::PromptState``) for contexts [N, n_ctx, D] (and, where
    ``pt`` has a learnable class token, class tokens ``cls`` [N, C, D]): the
    text tower sees all N * C prompts at once."""
    prompts = P.splice_arrays(ctx, pt.fixed_embed, pt.ctx_map, cls, pt.cls_mask if cls is not None else None)
    N, C, T, D = prompts.shape
    feats = clip_model.encode_text_embeds(clip_params, clip_cfg, prompts.reshape(N * C, T, D), pt.eot_idx.repeat(N),
                                          attn=attn)
    return clip_model.normalize(feats.float()).reshape(N, C, -1)


def is_ensemble(reward) -> bool:
    return hasattr(reward, "members")


class PromptTTAClassifier:
    """CoOp-prompt test-time adaptation with a frozen CLIP reward or reward
    ensemble (``core/reward.py``).

    ``setup`` builds the prompt template for a class set (the reference's
    ``reset_classnames``) and caches the reward's class features from the
    same tokenized prompts; ``adapt_tokens`` (patch-major u8 views: a ViT
    policy and a single reward) and ``adapt`` (NHWC views: any policy and
    reward) run N episodes at once from the shared initial context. A
    reward tower at another resolution than the views gets the selected
    views resized; an ensemble's similarities are stacked ``[N, M, S, C]``.
    """

    def __init__(self, clip_params, clip_cfg, reward, ecfg, ctx_init="a photo of a", n_ctx=4, ctx0=None):
        if is_ensemble(reward) and ecfg.loss not in ("rlcf", "tpt"):
            raise ValueError(f"loss '{ecfg.loss}' needs single-teacher logits; reward ensembles only support the "
                             "'rlcf'/'tpt' losses (the reference KD paths use one reward CLIP, "
                             "`TPT/tpt_cls_rl.py:201-219`)")
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.reward = reward
        self.ecfg = ecfg
        self.ctx_init = ctx_init
        self.n_ctx = n_ctx
        self.ctx0_override = ctx0
        self.prompt_state = None
        self.device = clip_params["logit_scale"].device
        self.attn = clip_model.best_attn(clip_cfg, self.device)
        self.reward_attn = clip_model.best_attn(getattr(reward, "cfg", None), self.device)

    def setup(self, classnames: Sequence[str]):
        self.prompt_state = P.build_prompt_state(
            self.clip_params, classnames, ctx_init=self.ctx_init, n_ctx=self.n_ctx, ctx0=self.ctx0_override,
        )
        self.reward.set_class_features(self.prompt_state.tokenized)
        with torch.no_grad():
            # initial text features: a per-dataset constant that confidence
            # selection reuses (one setup-time text forward)
            self._tf0 = self.text_features(self.prompt_state.ctx0[None])[0]
        return self

    # -- pieces ---------------------------------------------------------

    def _logit_scale(self):
        return self.clip_params["logit_scale"].exp().float()

    def text_features(self, ctx):
        """Normalized class text features [N, C, E] for contexts [N, n_ctx, D]."""
        return prompt_text_features(self.clip_params, self.clip_cfg, self.prompt_state, ctx, self.attn)

    @torch.no_grad()
    def prepare_tokens(self, ptoks, rtoks=None):
        """u8 policy tokens [N, B, Tp, p*p*3] (and optionally the same views
        as reward tokens [N, B, Tr, q*q*3]) -> (img_feats [N, B, E],
        sel [N, S], reward_sim [N, S, C])."""
        cfg, rcfg = self.clip_cfg, self.reward.cfg
        N, B, Tp, Dp = ptoks.shape
        n_keep = max(1, int(B * self.ecfg.selection_p))
        x = normalize_u8_patch_tokens(ptoks).reshape(N * B, Tp, Dp)
        img = clip_model.encode_image_tokens(self.clip_params, cfg, x, attn=self.attn)
        img_feats = clip_model.normalize(img.float()).reshape(N, B, -1)
        logits0 = self._logit_scale() * torch.einsum("nbe,ce->nbc", img_feats, self._tf0)
        sel = Lo.select_confident_entropy(Lo.entropy_per_sample(logits0), n_keep)  # [N, S]
        if rtoks is not None:
            # the reward's own tokens of the selected views (ViT reward at the
            # view resolution)
            Tr, Dr = rtoks.shape[2], rtoks.shape[3]
            sel_r = torch.gather(rtoks, 1, sel[:, :, None, None].expand(N, n_keep, Tr, Dr))
            rx = normalize_u8_patch_tokens(sel_r).reshape(N * n_keep, Tr, Dr)
            feats = clip_model.normalize(
                clip_model.encode_image_tokens(self.reward.params, rcfg, rx, attn=self.reward_attn).float())
            r_sim = feats @ self.reward.class_features.T
        else:
            # depatchify ONLY the selected views back to NHWC for the reward tower
            sel_p = torch.gather(ptoks, 1, sel[:, :, None, None].expand(N, n_keep, Tp, Dp))
            sel_views = clip_model.images_from_patch_tokens(
                normalize_u8_patch_tokens(sel_p).reshape(N * n_keep, Tp, Dp), cfg.vision_patch_size)
            r_sim = self._reward_sim(sel_views, N, n_keep)
        return img_feats, sel, r_sim.reshape(N, n_keep, -1)

    def _reward_sim(self, sel_views, N: int, n_keep: int):
        """Frozen reward similarities of the N * n_keep selected views
        (normalized NHWC), each tower taking them resized to its own
        resolution: [N, S, C] for one reward, [N, M, S, C] for an ensemble
        of M."""
        if is_ensemble(self.reward):
            sims = [m.image_sim(sel_views, self.reward_attn).reshape(N, n_keep, -1) for m in self.reward.members]
            return torch.stack(sims, dim=1)
        return self.reward.image_sim(sel_views, self.reward_attn).reshape(N, n_keep, -1)

    @torch.no_grad()
    def prepare(self, views):
        """NHWC views [N, B, H, W, 3], u8 (CLIP-normalized here) or float
        (normalized) -> (img_feats [N, B, E], sel [N, S], reward_sim [N, S, C])."""
        views = maybe_normalize_u8(views)
        N, B = views.shape[:2]
        n_keep = max(1, int(B * self.ecfg.selection_p))
        img = clip_model.encode_image(self.clip_params, self.clip_cfg, views.reshape((N * B,) + views.shape[2:]),
                                      attn=self.attn)
        img_feats = clip_model.normalize(img.float()).reshape(N, B, -1)
        logits0 = self._logit_scale() * torch.einsum("nbe,ce->nbc", img_feats, self._tf0)
        sel = Lo.select_confident_entropy(Lo.entropy_per_sample(logits0), n_keep)  # [N, S]
        r_sim = self._reward_sim(take_rows(views, sel).reshape((N * n_keep,) + views.shape[2:]), N, n_keep)
        return img_feats, sel, r_sim

    def episodes(self, img_feats, sel, reward_sim):
        """N batched episodes -> (final logits [N, C], per-step losses [N, steps])."""
        ecfg = self.ecfg
        N, _, E = img_feats.shape
        scale = self._logit_scale()
        teacher_scale = None if is_ensemble(self.reward) else self.reward.params["logit_scale"].exp().float()
        sel_feats = torch.gather(img_feats, 1, sel[:, :, None].expand(-1, -1, E))  # [N, S, E]
        ctx0 = self.prompt_state.ctx0
        ctx = ctx0.detach()[None].expand(N, *ctx0.shape).clone().requires_grad_(True)
        opt = make_optimizer([ctx], ecfg)  # fresh state per group: the per-sample reset
        losses = []
        for _ in range(ecfg.tta_steps):
            opt.zero_grad(set_to_none=True)
            logits = scale * torch.einsum("nse,nce->nsc", sel_feats, self.text_features(ctx))
            loss = step_loss(logits, reward_sim, ecfg, self.reward.score_samples, teacher_scale)  # [N]
            loss.sum().backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            tf = self.text_features(ctx) if ecfg.tta_steps > 0 else self._tf0.expand(N, -1, -1)
            final = scale * torch.einsum("ne,nce->nc", img_feats[:, 0], tf)
        stacked = torch.stack(losses, dim=1) if losses else torch.zeros((N, 0), device=final.device)
        return final, stacked

    # -- entry points ---------------------------------------------------

    def _check_token_mode(self, what: str):
        if not self.clip_cfg.is_vit or is_ensemble(self.reward):
            raise ValueError(f"{what} needs token mode: a ViT policy and a single reward model (ResNet policies "
                             "and reward ensembles take the NHWC adapt() path)")

    def adapt(self, views_batch):
        """TTA from NHWC views [N, B, H, W, 3] (numpy or tensor; u8 pixels or
        normalized floats) -> (final logits [N, C], {"losses", "selected"}):
        any policy (ViT or ResNet), any reward or ensemble."""
        img_feats, sel, r_sim = self.prepare(torch.as_tensor(views_batch).to(self.device))
        logits, losses = self.episodes(img_feats, sel, r_sim)
        return logits, {"losses": losses, "selected": sel}

    def adapt_tokens(self, policy_tokens, reward_tokens=None):
        """TTA from pre-patchified u8 views [N, B, (res/p)^2, p*p*3] (numpy
        or tensor) -> (final logits [N, C], {"losses", "selected"}). With
        ``reward_tokens`` (the same views at the reward's patch size) the
        reward tower consumes tokens too; that needs a ViT reward at the view
        resolution; without them a reward at another resolution gets the
        selected views depatchified and resized. Token mode takes a ViT
        policy and a single reward, as the JAX package's does."""
        self._check_token_mode("adapt_tokens")
        pd = self.clip_cfg.vision_patch_size ** 2 * 3
        if policy_tokens.shape[-1] != pd:
            raise ValueError(f"policy patch dim {policy_tokens.shape[-1]} doesn't match the tower (expect {pd})")
        rtoks = None
        if reward_tokens is not None:
            rcfg = self.reward.cfg
            if not rcfg.is_vit:
                raise ValueError("reward_tokens require a ViT reward; omit them to use depatchify")
            rd = rcfg.vision_patch_size ** 2 * 3
            if reward_tokens.shape[-1] != rd:
                raise ValueError(f"reward patch dim {reward_tokens.shape[-1]} doesn't match the tower (expect {rd})")
            n_tok_r = (rcfg.image_resolution // rcfg.vision_patch_size) ** 2
            if reward_tokens.shape[2] != n_tok_r:
                raise ValueError(
                    f"reward tokens carry {reward_tokens.shape[2]} patches but the reward tower "
                    f"expects {n_tok_r}: views must be generated at the reward resolution "
                    f"({rcfg.image_resolution}px)"
                )
            rtoks = torch.as_tensor(reward_tokens).to(self.device)
        ptoks = torch.as_tensor(policy_tokens).to(self.device)
        img_feats, sel, r_sim = self.prepare_tokens(ptoks, rtoks)
        logits, losses = self.episodes(img_feats, sel, r_sim)
        return logits, {"losses": losses, "selected": sel}

    def adapt_sources_fn(self, *, n_views: int, src_size: int = 256, resolution: int = 224, augmix: bool = True):
        """The flagship from u8 sources: ``adapt(images_planar_u8 [N, 3, S, S],
        seed) -> (logits [N, C], losses [N, steps], next_seed)``. All views of
        the group are built on the classifier's device by one AugMix kernel
        launch (``ops.augmix.fused_views``), from a ``torch.Generator`` there
        seeded with ``seed``; the reward takes its own tokens when it is a ViT
        at the view resolution, else the selected views depatchified."""
        from ..ops.augmix import fused_views

        self._check_token_mode("adapt_sources_fn")
        pcfg, rcfg = self.clip_cfg, self.reward.cfg
        reward_same = rcfg.is_vit and rcfg.image_resolution == resolution
        fkw = dict(n_views=n_views, resolution=resolution, src_size=src_size, augmix=augmix,
                   p_policy=pcfg.vision_patch_size, p_reward=rcfg.vision_patch_size if reward_same else 0)

        def adapt(images_planar, seed):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
            toks = fused_views(torch.as_tensor(images_planar).to(self.device), gen, **fkw)
            logits, aux = self.adapt_tokens(*toks) if isinstance(toks, tuple) else self.adapt_tokens(toks)
            return logits, aux["losses"], int(seed) + 1

        return adapt

    def adapt_sources_scan_fn(self, *, n_views: int, src_size: int = 256, resolution: int = 224,
                              augmix: bool = True):
        """``adapt(images_planar_u8 [G, N, 3, S, S], seed) -> (logits [G, N, C],
        losses [G, N, steps], next_seed)``: the body of ``adapt_sources_fn``
        over G groups, group g with ``seed + g``, so that it equals G chained
        calls; ``next_seed = seed + G``. A Python loop over the groups."""
        one = self.adapt_sources_fn(n_views=n_views, src_size=src_size, resolution=resolution, augmix=augmix)

        def adapt(images_planar, seed):
            logits, losses = [], []
            for group in images_planar:
                lg, ls, seed = one(group, seed)
                logits.append(lg)
                losses.append(ls)
            return torch.stack(logits), torch.stack(losses), seed

        return adapt


# ---------------------------------------------------------------------------
# Encoder TTA: `TPT/tune_cls_rl.py` (CLIPCLS_TTA): tune the visual tower
# ---------------------------------------------------------------------------


class EncoderTTAClassifier:
    """Visual-encoder test-time adaptation with frozen class text features
    (``rlcf_tpu/tasks/classification.py::EncoderTTAClassifier``).

    Class features are computed once per class set from plain prompts;
    episodes adapt the visual tower (or only its normalization affines with
    ``only_norm``) under the REINFORCE/TPT/KD loss, with the recompute step-0
    strategy of ``core/episode.py``; an optional momentum EMA re-anchors the
    episodes' starting point every ``update_freq`` samples. ``remat`` is the
    visual tower's checkpointing in the steps (``layers.transformer``; a
    ResNet ignores it). A ViT or ResNet policy and a single reward (ViT or
    ResNet, at any resolution). ``bn_prior`` (a ResNet policy's BN-prior
    statistics, `tune_cls_rl.py:35-44`) mixes each episode's batch statistics
    into the running ones in every forward of the episode, with the JAX
    package's step-0 strategy: the selection forward's batch is the B views,
    each step's the S selected ones (``core/episode.py``).
    """

    def __init__(self, clip_params, clip_cfg, reward, ecfg, prompt_prefix: str = "a photo of a",
                 only_norm: bool = False, momentum_update: bool = False, update_freq: int = 256,
                 update_w: float = 1.0, momentum: float = 0.9999, bn_prior=None, remat=True):
        if not hasattr(reward, "params"):
            raise ValueError(
                "EncoderTTAClassifier requires a single ClipReward; reward "
                "ensembles are only supported by PromptTTAClassifier (matching "
                "the reference encoder path, `TPT/tune_cls_rl.py`)"
            )
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.reward = reward
        self.ecfg = ecfg
        self.prompt_prefix = prompt_prefix
        self.only_norm = only_norm
        self.momentum_cfg = dict(momentum=momentum, update_freq=update_freq, update_w=update_w)
        self.momentum_update = momentum_update
        self.bn_prior = bn_prior
        self.remat = remat
        self.device = clip_params["logit_scale"].device
        self.attn = clip_model.best_attn(clip_cfg, self.device)
        self.reward_attn = clip_model.best_attn(reward.cfg, self.device)
        if only_norm:
            self.trainable0, self.frozen_visual = Po.partition(clip_params["visual"], Po.norm_only_filter)
        else:
            self.trainable0, self.frozen_visual = clip_params["visual"], None
        self.momentum_state = Po.MomentumState.create(self.trainable0) if momentum_update else None
        self.class_features = None
        self._episode = None

    def setup(self, classnames: Sequence[str]):
        self.class_features = compute_class_features(self.clip_params, self.clip_cfg, classnames,
                                                     self.prompt_prefix, attn=self.attn)
        self.reward.set_class_features(tokenize(assemble_prompts(classnames, self.prompt_prefix)))
        self._episode = make_tta_episode(self.policy_logits, self.reward_image_sim, self.reward.score_samples,
                                         self.ecfg, teacher_scale=self.reward.params["logit_scale"].exp().float(),
                                         return_adapted=True)
        return self

    def policy_logits(self, trainable, cache, idx):
        """Logits [N, k, C] of the views ``idx [N, k]`` of ``cache["views"]``
        (normalized NHWC [N, B, H, W, 3]) under per-episode visual weights
        (``trainable``, every leaf ``[N, ...]``). A ViT's patch embedding is
        the token matmul of ``encode_image_tokens``; a ResNet takes the NHWC
        views, with ``bn_prior``'s statistics over each episode's k views."""
        N, k = idx.shape
        visual = trainable
        if self.only_norm:
            visual = Po.merge(trainable, Po.tree_map(lambda v: v.expand(N, *v.shape), self.frozen_visual))
        views = take_rows(cache["views"], idx)
        if self.clip_cfg.is_vit:
            toks = clip_model.patch_tokens_from_images(views.reshape((N * k,) + views.shape[2:]),
                                                       self.clip_cfg.vision_patch_size)
            feats = clip_model.encode_image_tokens({"visual": visual}, self.clip_cfg,
                                                   toks.reshape((N, k) + toks.shape[1:]), attn=self.attn,
                                                   remat=self.remat)
        else:
            feats = clip_model.encode_image({"visual": visual}, self.clip_cfg, views, bn_prior=self.bn_prior)
        scale = self.clip_params["logit_scale"].exp().float()
        return scale * torch.einsum("nke,ce->nkc", clip_model.normalize(feats.float()), self.class_features)

    def reward_image_sim(self, views):
        """Frozen reward similarities [N, S, C] of normalized NHWC views [N, S, H, W, 3]."""
        N, S = views.shape[:2]
        return self.reward.image_sim(views.reshape((N * S,) + views.shape[2:]), self.reward_attn).reshape(N, S, -1)

    def adapt(self, views_batch, return_adapted: bool = False):
        """views_batch: NHWC [N, B, H, W, 3] (numpy or tensor; u8 pixels or
        normalized floats) -> (final logits [N, C], {"losses", "selected"}).

        All N episodes start from the same anchor, as the JAX package's vmap
        does; with momentum_update their adapted weights fold into the EMA
        in episode order afterwards, so a re-anchor that falls inside a group
        takes effect from the next group (N=1 is the sequential reference).
        ``return_adapted`` adds the N adapted visual weights (``[N, ...]``)
        under ``"adapted"``."""
        views = maybe_normalize_u8(torch.as_tensor(views_batch).to(self.device))
        start = self.momentum_state.reset_params if self.momentum_update else self.trainable0
        logits, aux = self._episode(start, {"views": views}, views)
        adapted = aux.pop("adapted")
        if self.momentum_update:
            self.momentum_state = Po.momentum_update_batch(self.momentum_state, adapted, **self.momentum_cfg)
        if return_adapted:
            aux["adapted"] = adapted
        return logits[:, 0], aux


# ---------------------------------------------------------------------------
# CoCoOp: image-conditioned prompt TTA (`TPT/clip/cocoop.py`, `tpt_cls.py`)
# ---------------------------------------------------------------------------


def init_meta_net(embed_dim: int, ctx_dim: int, device="cpu"):
    """CoCoOp's meta-net, Linear(E, E // 16) -> ReLU -> Linear(E // 16, D)
    (`cocoop.py:53-57`), fp32 weights ``[in, out]`` of std in ** -0.5 and
    zero biases, drawn on the CPU from a torch generator seeded 0 (the same
    weights on every device). These are not the JAX package's draws, which a
    torch generator cannot make: to hold the two packages to each other,
    carry JAX's weights across."""
    g = torch.Generator().manual_seed(0)
    hidden = embed_dim // 16
    w1 = torch.randn(embed_dim, hidden, generator=g) * embed_dim ** -0.5
    w2 = torch.randn(hidden, ctx_dim, generator=g) * hidden ** -0.5
    return {"w1": w1.to(device), "b1": torch.zeros(hidden, device=device),
            "w2": w2.to(device), "b2": torch.zeros(ctx_dim, device=device)}


def meta_net_forward(params, im_features):
    h = torch.relu(im_features @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def convert_cocoop_checkpoint(sd):
    """A torch CoCoOp state dict -> (ctx [n_ctx, D], meta-net params), fp32.
    Keys with or without a ``prompt_generator.`` / ``prompt_learner.`` prefix
    (`load_model_weight`, `TPT/utils/tools.py:101-131`): the first key that
    ends with each name."""

    def find(suffix):
        for k, v in sd.items():
            if k.endswith(suffix):
                return torch.as_tensor(v).float()
        raise KeyError(suffix)

    meta = {"w1": find("meta_net.linear1.weight").T.contiguous(), "b1": find("meta_net.linear1.bias"),
            "w2": find("meta_net.linear2.weight").T.contiguous(), "b2": find("meta_net.linear2.bias")}
    return find("ctx"), meta


class CoCoOpTTAClassifier:
    """TPT-style TTA over a CoCoOp instance-conditioned context
    (``rlcf_tpu/tasks/classification.py::CoCoOpTTAClassifier``).

    Per image: the frozen policy encodes its views, the frozen meta-net turns
    view 0's features into a bias, and ``ctx + bias`` (`cocoop.py:173-182`)
    is the episode's starting context, which ``tta_steps`` entropy steps tune
    (`tpt_cls.py:50-53,100-114`); the prediction takes the adapted context.
    The N images of a group run as N episodes on one batch axis, each from
    its own context, so the text tower sees N * C prompts every step. The
    selection forward's graph serves step 0 (``step0_reuse``): the text tower
    costs the same whichever views are selected.
    """

    def __init__(self, clip_params, clip_cfg, ecfg, ctx_init="a photo of a", n_ctx=4, ctx0=None, meta_net=None):
        self.clip_params = clip_params
        self.clip_cfg = clip_cfg
        self.ecfg = ecfg
        self.ctx_init = ctx_init
        self.n_ctx = n_ctx
        self.device = clip_params["logit_scale"].device
        self.attn = clip_model.best_attn(clip_cfg, self.device)
        self.meta_net = ({k: torch.as_tensor(v).to(self.device) for k, v in meta_net.items()} if meta_net else
                         init_meta_net(clip_cfg.embed_dim, clip_cfg.text_width, self.device))
        self.ctx0_override = ctx0
        self.prompt_state = None
        self._episode = make_tta_episode(self.policy_logits, self.reward_image_sim, None, ecfg, step0_reuse=True)

    def setup(self, classnames: Sequence[str]):
        ctx0 = None if self.ctx0_override is None else torch.as_tensor(self.ctx0_override).to(self.device)
        self.prompt_state = P.build_prompt_state(self.clip_params, classnames, ctx_init=self.ctx_init,
                                                 n_ctx=self.n_ctx, ctx0=ctx0)
        return self

    def policy_logits(self, ctx, cache, idx):
        """Logits [N, k, C] of the views ``idx [N, k]`` under per-episode contexts ``ctx [N, n_ctx, D]``."""
        tf = prompt_text_features(self.clip_params, self.clip_cfg, self.prompt_state, ctx, self.attn)
        feats = take_rows(cache["img_feats"], idx)
        return self.clip_params["logit_scale"].exp().float() * torch.einsum("nke,nce->nkc", feats, tf)

    def reward_image_sim(self, views):
        """The TPT loss takes no reward: zeros [N, S, C]."""
        return torch.zeros(views.shape[:2] + (self.prompt_state.n_cls,), device=views.device)

    def adapt(self, views_batch):
        """NHWC views [N, B, H, W, 3] (numpy or tensor; u8 pixels or
        normalized floats) -> (final logits [N, C], {"losses", "selected"})."""
        views = maybe_normalize_u8(torch.as_tensor(views_batch).to(self.device))
        N, B = views.shape[:2]
        ctx0 = self.prompt_state.ctx0
        with torch.no_grad():
            img = clip_model.encode_image(self.clip_params, self.clip_cfg, views.reshape((N * B,) + views.shape[2:]),
                                          attn=self.attn)
            img_feats = clip_model.normalize(img.float()).reshape(N, B, -1)
            bias = meta_net_forward(self.meta_net, img_feats[:, 0])   # [N, D], fp32
            start = ctx0[None] + bias[:, None, :].to(ctx0.dtype)
        logits, aux = self._episode(start, {"img_feats": img_feats}, views, per_episode=True)
        return logits[:, 0], aux

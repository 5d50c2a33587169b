"""Classification: zero-shot evaluation, single and ensembled, and
test-time adaptation (RLCF / TPT / KD episodes): prompt TTA on patch-major u8
views or NHWC views, encoder TTA on NHWC views, and CoCoOp's
instance-conditioned prompt TTA on NHWC views (the counterpart of
``rlcf_tpu/tasks/classification.py``, with its serving hooks and the
process mesh of ``parallel/``: episodes split over dp, classes over tp).

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

import types
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import losses as Lo
from ..core import prompt as P
from ..core import policy as Po
from ..core.reward import image_sim
from ..core.episode import adamw_init, adamw_step, make_tta_episode, step_loss, take_rows
from ..data.class_names import assemble_prompts
from ..data.transforms import CLIP_MEAN, CLIP_STD
from ..metrics.classification import AccuracyMeter
from ..models import clip as clip_model
from ..ops.image_ops import resize_bicubic_align_corners
from ..parallel.collectives import all_reduce_grads, gather_replicated
from ..parallel.mesh import dp_gather, dp_slice, shard_range
from ..tokenizer import tokenize
from ..utils.profiling import group, span


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


def compute_class_features(params, cfg, classnames: Sequence[str], prompt_prefix: str = "a photo of a",
                           batch_size: int = 256, attn: str = "dense"):
    """Normalized class text features [C, E], computed in batches."""
    tokens = clip_model.truncate_tokens(tokenize(assemble_prompts(classnames, prompt_prefix)))
    return clip_model.encode_token_batches(params, cfg, tokens, batch_size, attn)


def logit_scale(params):
    """A CLIP's logit scale, ``exp(logit_scale)`` in float32."""
    return params["logit_scale"].exp().float()


def classify_logits(params, cfg, images, class_features, attn: str = "dense"):
    """Cosine-similarity logits [B, C] of normalized NHWC images."""
    img = clip_model.normalize(clip_model.encode_image(params, cfg, images, attn=attn).float())
    return logit_scale(params) * (img @ class_features.T)


def resize_bicubic_batch(images, resolution: int):
    """Per-model input resizing for ensembles (`custom_clip.py:541-543`):
    bicubic with aligned corners, as torch's."""
    return resize_bicubic_align_corners(images, resolution)


@torch.no_grad()
def zero_shot_eval(params, cfg, dataset, classnames: Sequence[str], prompt_prefix: str = "a photo of a",
                   batch_size: int = 64, resolution: int = 224, limit: Optional[int] = None, seed: int = 0,
                   decode: str = "pil", decode_workers: int = 0) -> dict:
    """Zero-shot top-1/top-5 over a dataset loader (`TPT/zero_shot.py`)."""
    return zero_shot_eval_ensemble([(params, cfg)], dataset, classnames, prompt_prefix, batch_size, resolution,
                                   limit, seed, decode, decode_workers)


@torch.no_grad()
def zero_shot_eval_ensemble(models: List, dataset, classnames: Sequence[str], prompt_prefix: str = "a photo of a",
                            batch_size: int = 64, resolution: int = 224, limit: Optional[int] = None,
                            seed: int = 0, decode: str = "pil", decode_workers: int = 0) -> dict:
    """Logit-averaged multi-architecture ensemble (`custom_clip.py:555-566`)
    of ``models``, a list of (params, cfg): each model takes the batch
    resized to its own resolution. One model is ``zero_shot_eval``. The
    images come through ``iter_batches`` (``decode``: "pil" or "native")."""
    from ..data.datasets import iter_batches

    device = models[0][0]["logit_scale"].device
    attn = clip_model.best_attn(None, device)
    feats = [compute_class_features(p, c, classnames, prompt_prefix, attn=attn) for p, c in models]
    meter = AccuracyMeter()
    for images, labels in iter_batches(dataset, batch_size, resolution, shuffle=True, seed=seed, limit=limit,
                                       decode=decode, workers=decode_workers):
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


def group_views(mesh, images_planar_u8, seed: int, **fkw):
    """(views, local): the AugMix views of a group of u8 sources
    ``[N, 3, S, S]``, built on their device by one kernel launch
    (``ops.augmix.fused_views``) from a ``torch.Generator`` there seeded
    with ``seed``. On a mesh whose dp tiles the group each rank builds only
    its slice's views (``local``), drawing the whole group's parameters;
    otherwise the views are the whole group's."""
    from ..ops.augmix import fused_views

    gen = torch.Generator(device=images_planar_u8.device).manual_seed(int(seed))
    local = mesh is not None and mesh.dp > 1 and mesh.tiles_dp(images_planar_u8.shape[0])
    return fused_views(images_planar_u8, gen, mesh=mesh if local else None, **fkw), local


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

    ``mesh`` (``parallel/mesh.py``): each dp rank runs the episodes of its
    slice of a group and the outputs are gathered in episode order; each tp
    rank encodes its shard of the classes (and a single reward its shard of
    the class features), gathered to the whole class axis for selection,
    top-k and the rewards, and the context's gradient is summed over tp.
    """

    def __init__(self, clip_params, clip_cfg, reward, ecfg, ctx_init="a photo of a", n_ctx=4, ctx0=None,
                 mesh=None):
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
        self.mesh = mesh
        self._tp_group = self._reward_tp_group = None    # set by setup when the classes tile tp
        self.device = clip_params["logit_scale"].device
        self.attn = clip_model.best_attn(clip_cfg, self.device)
        self.text_attn = clip_model.text_attn(self.device)
        self.reward_attn = clip_model.best_attn(getattr(reward, "cfg", None), self.device)

    def setup(self, classnames: Sequence[str]):
        from ..parallel.tp_prompt import shard_prompt_state

        self.prompt_state = pt = P.build_prompt_state(
            self.clip_params, classnames, ctx_init=self.ctx_init, n_ctx=self.n_ctx, ctx0=self.ctx0_override,
        )
        self._pt_shard, self._tp_group, self._reward_tp_group, tokenized = pt, None, None, pt.tokenized
        mesh = self.mesh
        if mesh is not None and mesh.tp > 1:
            if pt.n_cls % mesh.tp == 0:
                self._pt_shard, self._tp_group = shard_prompt_state(mesh, pt), mesh.tp_group
                if not is_ensemble(self.reward):   # a single reward's class features shard too
                    lo, hi = shard_range(pt.n_cls, mesh.tp, mesh.tp_rank)
                    tokenized, self._reward_tp_group = tokenized[lo:hi], mesh.tp_group
            else:
                print(f"NOTE: {pt.n_cls} classes not divisible by tp={mesh.tp}; class axis replicated")
        self.reward.set_class_features(tokenized)
        with torch.no_grad():
            # initial text features: a per-dataset constant that confidence
            # selection reuses (one setup-time text forward)
            self._tf0 = self.text_features(self.prompt_state.ctx0[None])[0]
        return self

    # -- pieces ---------------------------------------------------------
    # Each piece is a function of its weights (the ``*_fn`` methods): every
    # weight-derived value (params, prompt init, template embeddings, logit
    # scale, text and class features) is an argument, never a closure, so the
    # eager entry points and the exported serving functions run the same code
    # and one artifact serves any checkpoint of the architecture.

    def weights(self):
        """The weight arguments of the ``*_fn`` pieces for the set-up class
        set: ``(cparams, rparams, trainable0, pt_args, tf0, r_feats)``, an
        ensemble's ``rparams`` and ``r_feats`` one entry a member."""
        reward = self.reward
        if is_ensemble(reward):
            rparams = tuple(m.params for m in reward.members)
            r_feats = tuple(m.class_features for m in reward.members)
        else:
            rparams, r_feats = reward.params, reward.class_features
        return self.clip_params, rparams, self.prompt_state.ctx0, self._pt_args(), self._tf0, r_feats

    def _pt_args(self):
        pt = self._pt_shard   # this tp rank's classes
        return {"fixed_embed": pt.fixed_embed, "ctx_map": pt.ctx_map, "eot_idx": pt.eot_idx}

    def text_features_fn(self, cparams, ctx, pt_args):
        """Normalized class text features [N, C, E] for contexts [N, n_ctx, D]
        (under tp: this rank's classes encoded, the whole class axis gathered)."""
        feats = prompt_text_features(cparams, self.clip_cfg, types.SimpleNamespace(**pt_args), ctx, self.text_attn)
        return self._gather_classes(feats, dim=1)

    def _gather_classes(self, x, dim=-1):
        """The whole class axis of this tp rank's shard ``x``."""
        return x if self._tp_group is None else gather_replicated(x, self._tp_group, dim)

    def _gather_reward_classes(self, sim):
        """The whole class axis of reward similarities ``sim`` [..., C]: a
        single reward's class features are sharded over tp, an ensemble's
        members' are whole."""
        return sim if self._reward_tp_group is None else gather_replicated(sim, self._reward_tp_group, -1)

    def text_features(self, ctx):
        """``text_features_fn`` on the classifier's own weights."""
        return self.text_features_fn(self.clip_params, ctx, self._pt_args())

    def _select(self, cparams, tf0, img, N: int, B: int):
        """(img_feats [N, B, E], sel [N, S]): the lowest-entropy views of each
        episode against the initial text features."""
        with span("select"):
            n_keep = max(1, int(B * self.ecfg.selection_p))
            img_feats = clip_model.normalize(img.float()).reshape(N, B, -1)
            logits0 = logit_scale(cparams) * torch.einsum("nbe,ce->nbc", img_feats, tf0)
            return img_feats, Lo.select_confident_entropy(Lo.entropy_per_sample(logits0), n_keep)  # [N, S]

    def prepare_tokens_fn(self, cparams, rparams, tf0, r_feats, ptoks, rtoks=None):
        """u8 policy tokens [N, B, Tp, p*p*3] (and optionally the same views
        as reward tokens [N, B, Tr, q*q*3]) -> (img_feats [N, B, E],
        sel [N, S], reward_sim [N, S, C])."""
        cfg, rcfg = self.clip_cfg, self.reward.cfg
        N, B, Tp, Dp = ptoks.shape
        with span("prepare"):
            with span("policy_fwd"):
                x = normalize_u8_patch_tokens(ptoks).reshape(N * B, Tp, Dp)
                img = clip_model.encode_image_tokens(cparams, cfg, x, attn=self.attn)
            img_feats, sel = self._select(cparams, tf0, img, N, B)
            n_keep = sel.shape[1]
            with span("reward_fwd"):
                if rtoks is not None:
                    # the reward's own tokens of the selected views (ViT reward at the
                    # view resolution)
                    Tr, Dr = rtoks.shape[2], rtoks.shape[3]
                    sel_r = torch.gather(rtoks, 1, sel[:, :, None, None].expand(N, n_keep, Tr, Dr))
                    rx = normalize_u8_patch_tokens(sel_r).reshape(N * n_keep, Tr, Dr)
                    feats = clip_model.normalize(
                        clip_model.encode_image_tokens(rparams, rcfg, rx, attn=self.reward_attn).float())
                    r_sim = self._gather_reward_classes(feats @ r_feats.T)
                else:
                    # depatchify ONLY the selected views back to NHWC for the reward tower
                    sel_p = torch.gather(ptoks, 1, sel[:, :, None, None].expand(N, n_keep, Tp, Dp))
                    sel_views = clip_model.images_from_patch_tokens(
                        normalize_u8_patch_tokens(sel_p).reshape(N * n_keep, Tp, Dp), cfg.vision_patch_size)
                    r_sim = self._reward_sim_fn(rparams, r_feats, sel_views, N, n_keep)
            return img_feats, sel, r_sim.reshape(N, n_keep, -1)

    @torch.no_grad()
    def prepare_tokens(self, ptoks, rtoks=None):
        """``prepare_tokens_fn`` on the classifier's own weights."""
        cparams, rparams, _, _, tf0, r_feats = self.weights()
        return self.prepare_tokens_fn(cparams, rparams, tf0, r_feats, ptoks, rtoks)

    def _reward_sim_fn(self, rparams, r_feats, sel_views, N: int, n_keep: int):
        """Frozen reward similarities of the N * n_keep selected views
        (normalized NHWC), each tower taking them resized to its own
        resolution: [N, S, C] for one reward, [N, M, S, C] for an ensemble
        of M."""
        sim = lambda params, cfg, feats: self._gather_reward_classes(
            image_sim(params, cfg, feats, sel_views, self.reward_attn)).reshape(N, n_keep, -1)
        if is_ensemble(self.reward):
            return torch.stack([sim(p, m.cfg, f) for p, m, f in zip(rparams, self.reward.members, r_feats)], dim=1)
        return sim(rparams, self.reward.cfg, r_feats)

    def prepare_fn(self, cparams, rparams, tf0, r_feats, views):
        """NHWC views [N, B, H, W, 3], u8 (CLIP-normalized here) or float
        (normalized) -> (img_feats [N, B, E], sel [N, S], reward_sim [N, S, C])."""
        with span("prepare"):
            with span("policy_fwd"):
                views = maybe_normalize_u8(views)
                N, B = views.shape[:2]
                img = clip_model.encode_image(cparams, self.clip_cfg, views.reshape((N * B,) + views.shape[2:]),
                                              attn=self.attn)
            img_feats, sel = self._select(cparams, tf0, img, N, B)
            n_keep = sel.shape[1]
            with span("reward_fwd"):
                r_sim = self._reward_sim_fn(rparams, r_feats,
                                            take_rows(views, sel).reshape((N * n_keep,) + views.shape[2:]), N, n_keep)
            return img_feats, sel, r_sim

    @torch.no_grad()
    def prepare(self, views):
        """``prepare_fn`` on the classifier's own weights."""
        cparams, rparams, _, _, tf0, r_feats = self.weights()
        return self.prepare_fn(cparams, rparams, tf0, r_feats, views)

    def episodes_fn(self, cparams, trainable0, pt_args, tf0, img_feats, sel, reward_sim):
        """N batched episodes from the context ``trainable0`` [n_ctx, D] ->
        (final logits [N, C], per-step losses [N, steps]). The step is the
        functional AdamW of ``core/episode.py`` (``adamw_step``), which a
        graph capture traces; a fresh state per group is the per-sample reset.
        KD losses take the reward's logit scale from the classifier (bound at
        export time, as in the JAX package)."""
        ecfg = self.ecfg
        N, _, E = img_feats.shape
        with span("episodes"):
            sel_feats = torch.gather(img_feats, 1, sel[:, :, None].expand(-1, -1, E))  # [N, S, E]
            ctx = trainable0.detach()[None].expand(N, *trainable0.shape).clone()
            state = adamw_init([ctx])
            losses = []
            for step in range(1, ecfg.tta_steps + 1):
                with span("step", step):
                    loss, grad = self.step_grad_fn(cparams, ctx, pt_args, sel_feats, reward_sim)
                    with span("adamw"):
                        (ctx,), state = adamw_step([ctx.detach()], [grad], state, step, ecfg.lr, ecfg.weight_decay,
                                                   ecfg.adam_eps)
                losses.append(loss)
            with torch.no_grad(), span("final"):
                tf = self.text_features_fn(cparams, ctx, pt_args) if ecfg.tta_steps > 0 else tf0.expand(N, -1, -1)
                final = logit_scale(cparams) * torch.einsum("ne,nce->nc", img_feats[:, 0], tf)
            stacked = torch.stack(losses, dim=1) if losses else torch.zeros((N, 0), device=final.device)
            return final, stacked

    def step_grad_fn(self, cparams, ctx, pt_args, sel_feats, reward_sim):
        """One step's losses [N] and the gradient [N, n_ctx, D] of their sum
        in the contexts ``ctx`` [N, n_ctx, D], on the selected views'
        features ``sel_feats`` [N, S, E]. Under tp each rank's gradient is
        its classes' share until the psum over tp, which makes it the whole."""
        teacher_scale = None if is_ensemble(self.reward) else logit_scale(self.reward.params)
        with torch.enable_grad():
            ctx = ctx.detach().requires_grad_(True)
            with span("text_fwd"):
                logits = logit_scale(cparams) * torch.einsum("nse,nce->nsc", sel_feats,
                                                             self.text_features_fn(cparams, ctx, pt_args))
            with span("loss"):
                loss = step_loss(logits, reward_sim, self.ecfg, self.reward.score_samples, teacher_scale)  # [N]
            with span("text_bwd"):
                grad, = torch.autograd.grad(loss.sum(), ctx)
                if self._tp_group is not None:
                    all_reduce_grads(grad, self._tp_group)
        return loss.detach(), grad

    def episodes(self, img_feats, sel, reward_sim):
        """``episodes_fn`` on the classifier's own weights."""
        cparams, _, trainable0, pt_args, tf0, _ = self.weights()
        return self.episodes_fn(cparams, trainable0, pt_args, tf0, img_feats, sel, reward_sim)

    # -- entry points ---------------------------------------------------

    def _check_token_mode(self, what: str):
        if not self.clip_cfg.is_vit or is_ensemble(self.reward):
            raise ValueError(f"{what} needs token mode: a ViT policy and a single reward model (ResNet policies "
                             "and reward ensembles take the NHWC adapt() path)")

    def _run_group(self, n: int, prepare, *inputs):
        """``episodes(prepare(*inputs))`` on this dp rank's inputs, the
        outputs of the group's ``n`` episodes gathered in episode order."""
        img_feats, sel, r_sim = prepare(*inputs)
        logits, losses = self.episodes(img_feats, sel, r_sim)
        gather = lambda x: dp_gather(self.mesh, x, n)
        return gather(logits), {"losses": gather(losses), "selected": gather(sel)}

    def adapt(self, views_batch):
        """TTA from NHWC views [N, B, H, W, 3] (numpy or tensor; u8 pixels or
        normalized floats) -> (final logits [N, C], {"losses", "selected"}):
        any policy (ViT or ResNet), any reward or ensemble."""
        with group():
            views = torch.as_tensor(views_batch).to(self.device)
            return self._run_group(views.shape[0], self.prepare, dp_slice(self.mesh, views))

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
        with group():
            rtoks = None if reward_tokens is None else dp_slice(self.mesh, torch.as_tensor(reward_tokens).to(self.device))
            ptoks = torch.as_tensor(policy_tokens).to(self.device)
            return self._run_group(ptoks.shape[0], self.prepare_tokens, dp_slice(self.mesh, ptoks), rtoks)

    def adapt_sources_fn(self, *, n_views: int, src_size: int = 256, resolution: int = 224, augmix: bool = True):
        """The flagship from u8 sources: ``adapt(images_planar_u8 [N, 3, S, S],
        seed) -> (logits [N, C], losses [N, steps], next_seed)``. All views of
        the group are built on the classifier's device by one AugMix kernel
        launch (``ops.augmix.fused_views``), from a ``torch.Generator`` there
        seeded with ``seed``; the reward takes its own tokens when it is a ViT
        at the view resolution, else the selected views depatchified. On a
        mesh whose dp tiles the group, each rank builds its slice's views
        (``group_views``) and runs their episodes."""
        self._check_token_mode("adapt_sources_fn")
        pcfg, rcfg = self.clip_cfg, self.reward.cfg
        reward_same = rcfg.is_vit and rcfg.image_resolution == resolution
        fkw = dict(n_views=n_views, resolution=resolution, src_size=src_size, augmix=augmix,
                   p_policy=pcfg.vision_patch_size, p_reward=rcfg.vision_patch_size if reward_same else 0)

        def adapt(images_planar, seed):
            with group():
                with span("views"):
                    images = torch.as_tensor(images_planar).to(self.device)
                    toks, local = group_views(self.mesh, images, seed, **fkw)
                toks = toks if isinstance(toks, tuple) else (toks,)
                if local:   # this rank's slice of the views: straight to its episodes
                    logits, aux = self._run_group(images.shape[0], self.prepare_tokens, *toks)
                else:
                    logits, aux = self.adapt_tokens(*toks)
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

    # -- serving export -------------------------------------------------

    def serving_fn(self):
        """The episode as a pure function for export (``utils/export.py``):
        ``(cparams, rparams, trainable0, pt_args, tf0, r_feats, views) ->
        logits [N, C]``, NHWC views as ``adapt`` takes them. Every weight-derived
        value is an argument, so one artifact serves any checkpoint of this
        architecture and class count; KD losses bind the reward's logit scale
        at export time."""
        def serve(cparams, rparams, trainable0, pt_args, tf0, r_feats, views):
            img_feats, sel, r_sim = self.prepare_fn(cparams, rparams, tf0, r_feats, views)
            return self.episodes_fn(cparams, trainable0, pt_args, tf0, img_feats, sel, r_sim)[0]

        return serve

    def serving_example_args(self, views_shape, views_dtype=torch.float32):
        """Example arguments of ``serving_fn``: the classifier's weights and
        zero views of the served shape and dtype on its device."""
        return (*self.weights(), torch.zeros(tuple(views_shape), dtype=views_dtype, device=self.device))

    def serving_fn_tokens(self):
        """Token-input serving (the hot path): ``(cparams, rparams, trainable0,
        pt_args, tf0, r_feats, policy_tokens u8 [N, B, T, p*p*3]) -> logits
        [N, C]``; the reward takes the selected views depatchified in the
        graph, so any single reward works."""
        self._check_token_mode("serving_fn_tokens")

        def serve(cparams, rparams, trainable0, pt_args, tf0, r_feats, policy_tokens):
            img_feats, sel, r_sim = self.prepare_tokens_fn(cparams, rparams, tf0, r_feats, policy_tokens)
            return self.episodes_fn(cparams, trainable0, pt_args, tf0, img_feats, sel, r_sim)[0]

        return serve

    def serving_example_args_tokens(self, tokens_shape, tokens_dtype=torch.uint8):
        """Example arguments of ``serving_fn_tokens``."""
        return self.serving_example_args(tokens_shape, tokens_dtype)


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

    ``mesh``: episode-DP; each dp rank runs the episodes of its slice of a
    group, and every rank folds the whole group's gathered adapted weights
    into the momentum EMA in episode order, so every rank holds one state.
    """

    def __init__(self, clip_params, clip_cfg, reward, ecfg, prompt_prefix: str = "a photo of a",
                 only_norm: bool = False, momentum_update: bool = False, update_freq: int = 256,
                 update_w: float = 1.0, momentum: float = 0.9999, bn_prior=None, remat=True, mesh=None):
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
        self.mesh = mesh
        self.device = clip_params["logit_scale"].device
        self.attn = clip_model.best_attn(clip_cfg, self.device)
        self.text_attn = clip_model.text_attn(self.device)
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
                                                     self.prompt_prefix, attn=self.text_attn)
        self.reward.set_class_features(tokenize(assemble_prompts(classnames, self.prompt_prefix)))
        self._episode = make_tta_episode(self.policy_logits, self.reward_image_sim, self.reward.score_samples,
                                         self.ecfg, teacher_scale=logit_scale(self.reward.params),
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
        scale = logit_scale(self.clip_params)
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
        views = torch.as_tensor(views_batch).to(self.device)
        return self._run_group(views.shape[0], dp_slice(self.mesh, views), return_adapted)

    def _run_group(self, n: int, views, return_adapted: bool = False):
        """``adapt`` on this dp rank's views of a group of ``n``, the outputs
        gathered in episode order."""
        views = maybe_normalize_u8(views)
        start = self.momentum_state.reset_params if self.momentum_update else self.trainable0
        logits, aux = self._episode(start, {"views": views}, views)
        gather = lambda x: dp_gather(self.mesh, x, n)
        adapted = aux.pop("adapted")
        logits, aux = gather(logits), {k: gather(v) for k, v in aux.items()}
        if self.momentum_update or return_adapted:   # the whole group's, in episode order
            adapted = Po.tree_map(gather, adapted)
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
        self.text_attn = clip_model.text_attn(self.device)
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
        tf = prompt_text_features(self.clip_params, self.clip_cfg, self.prompt_state, ctx, self.text_attn)
        feats = take_rows(cache["img_feats"], idx)
        return logit_scale(self.clip_params) * torch.einsum("nke,nce->nkc", feats, tf)

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
